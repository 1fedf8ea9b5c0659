"""Serving engine: fused packed prefill + continuous batching
(DESIGN.md §8).

The port of ``repro.serve.engine`` for the ``layout="serve"`` archs.
Prompts are packed cu_seqlens-style into fixed-size chunks (pieces
128-aligned per request) and each chunk is ONE ``serve_chunk_step`` call:
the context-independent layers run over the packed token stream, k/v are
written into the serving cache in place, and attention is a single ragged
cache-attention call per layer, the CUDA kernel on the card.  The
per-token loop survives as ``prefill="loop"``, the baseline.

``Engine.serve`` runs continuous batching on top: the host-side
``ContinuousScheduler`` admits and evicts requests between steps under a
token budget, while the device sees two shapes, the prefill chunk and the
decode batch.

Recurrent archs (mamba2's ``ssd``, recurrentgemma's ``rglru`` with its
local attention layers) and MoE archs use the same cache layout but
prefill a token a request per step (decode-mode chunks): their mixers
are sequential or their routing batch-global, so ``fused_ok`` is false
for them and ``prefill(mode="fused")`` raises.

Archs that read a memory (cross-attention layers, an encoder), and any
engine given a ``memory``, take the legacy branch instead (reference
``engine.py:74-91``): a dense ``layout="decode"`` cache holding the
memory's projected ``xk``/``xv``, prompts prefilled a token a step
through ``decode_step`` and greedy decode through the same step, its
attention in plain torch ops (``decode_attention``), as the reference's;
no ragged kernel runs there.  Fused prefill, ``return_logits``,
``serve()`` and ``make_scheduler`` raise on that branch.

The reference's ``decode_impl`` switch does not carry over: on the card
attention always runs the kernel, on the CPU its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.packed_flash import ops as pf_ops
from repro_torch.models.model import (check_arch, fused_prefill_ok,
                                      needs_memory, resolve_device)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.scheduler import (DECODE, DONE, ContinuousScheduler,
                                         Request, SchedulerConfig)
from repro_torch.train.step import make_serve_chunk_step, make_serve_step


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 1024
    max_new_tokens: int = 32
    chunk_tokens: int = 512          # fused prefill chunk (128 multiple)
    prefill: str = "fused"           # "fused" | "loop"
    token_budget: Optional[int] = None   # continuous-batching kv budget
    admission: str = "fcfs"          # "fcfs" | "cost"
    step_cost_budget: float = 0.0    # predicted CA seconds per decode step
    eos_id: Optional[int] = None
    # live admission pricing: a () -> CalibrationSnapshot callable; when
    # set, cost admission re-prices every round from the calibrator
    snapshot_provider: Optional[Callable] = None


def check_kernel_head_dim(cfg) -> None:
    """Raise unless the ragged cache-attention kernel, which serves every
    attention layer on the card, takes ``cfg.head_dim``."""
    if cfg.head_dim not in pf_ops.RAGGED_HEAD_DIMS:
        raise NotImplementedError(
            f"{cfg.arch_id}: head_dim {cfg.head_dim} is not covered by the "
            f"ragged cache-attention kernel ({pf_ops.RAGGED_HEAD_DIMS})")


class Engine:
    """Serves one ``model.Transformer`` (and its config) from
    ``batch_size`` cache slots.  The model's weights must already live on
    ``device``.  ``memory`` [batch_size, M, D] is what a cross-attention
    arch's cross layers attend to (stub audio frames, encoded first, or
    patch embeddings); with one, or for such an arch, the engine serves
    from the legacy dense decode cache."""

    def __init__(self, model, serve_cfg: ServeConfig,
                 batch_size: int = 1, device="cuda", memory=None):
        cfg = model.cfg
        check_arch(cfg)
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model weights are on {model.device}, the "
                             f"engine runs on {self.device}")
        self.cfg, self.model = cfg, model
        # the serving layout hosts every arch but the cross-attention and
        # encoder ones; fused chunked prefill needs an attention-only
        # pattern (recurrent and MoE archs prefill through decode-mode
        # chunks)
        self.serve_layout = memory is None and not needs_memory(cfg)
        self.fused_ok = self.serve_layout and fused_prefill_ok(cfg)
        if self.serve_layout and self.device.type == "cuda" \
                and cfg.has_attention():
            check_kernel_head_dim(cfg)
        self.scfg = serve_cfg
        self.batch_size = batch_size
        if memory is not None:
            memory = torch.as_tensor(memory, device=self.device)
        if self.serve_layout:
            self.cache = model.init_cache(batch_size, serve_cfg.max_seq,
                                          layout="serve")
            self._chunk = make_serve_chunk_step(model)
        else:
            self.cache = model.init_cache(batch_size, serve_cfg.max_seq,
                                          layout="decode", memory=memory)
            self._step = make_serve_step(model)
        #: device calls: serve-layout chunks (prefill chunks and decode
        #: steps alike) or legacy decode steps
        self.n_chunk_calls = 0

    def _tensor(self, x) -> torch.Tensor:
        return torch.tensor(np.asarray(x, np.int32), device=self.device)

    # ----------------------------------------------------- chunk dispatch
    def _chunk_call(self, tokens, pos, block_req, kv_len_next):
        """All device calls go through here.  Returns logits [T, V] f32.
        The reference pads single-row calls of attention-only archs with a
        dead row to keep XLA's CPU gemv out of its bit-parity contract;
        the port makes no bitwise promise across batch shapes and sends
        rows as they are (a recurrent arch's rows are its cache slots, so
        they could not be padded anyway)."""
        self.n_chunk_calls += 1
        return self._chunk(self.cache, self._tensor(tokens),
                           self._tensor(pos), self._tensor(block_req),
                           self._tensor(kv_len_next))

    def _reset(self, mask: np.ndarray) -> None:
        self.model.reset_serve_slots(
            self.cache, torch.as_tensor(mask, device=self.device))

    # ------------------------------------------------- static-batch prefill
    def prefill(self, tokens, mode: Optional[str] = None,
                return_logits: bool = False):
        """Prefill a dense [B, P] prompt batch into the cache.

        mode "fused" (the default where ``fused_ok``): chunked packed
        prefill, one ``serve_chunk_step`` per ``chunk_tokens`` over the
        ragged batch.  mode "loop" (the default of recurrent archs): the
        per-token steps.  Returns the last-position logits [B, V] (and,
        with ``return_logits``, the full teacher-forced [B, P, V])."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.shape[1] > self.scfg.max_seq:
            raise ValueError(
                f"prompt length {tokens.shape[1]} exceeds max_seq "
                f"{self.scfg.max_seq}")
        mode = mode or (self.scfg.prefill if self.fused_ok else "loop")
        if not self.serve_layout:
            if mode == "fused":
                raise ValueError(
                    f"fused prefill unsupported for {self.cfg.arch_id}: "
                    f"cross-attention/encoder archs use the legacy path")
            if return_logits:
                raise ValueError("return_logits requires the serving "
                                 "cache layout")
            return self._prefill_legacy(tokens)
        # a prefill starts a fresh generation for every slot: kv visibility
        # drops and recurrent states are zeroed
        self._reset(np.ones(self.batch_size, bool))
        if mode == "fused":
            if not self.fused_ok:
                raise ValueError(
                    f"fused prefill unsupported for {self.cfg.arch_id} "
                    f"(pattern {self.cfg.layer_pattern})")
            return self._prefill_fused(tokens, return_logits)
        if mode == "loop":
            return self._prefill_loop(tokens, return_logits)
        raise ValueError(f"unknown prefill mode {mode!r}")

    def _prefill_fused(self, tokens: np.ndarray, return_logits=False):
        b, p = tokens.shape
        if b != self.batch_size:
            raise ValueError(f"{b} prompts for {self.batch_size} slots")
        sched = ContinuousScheduler(SchedulerConfig(
            n_slots=b, max_seq=self.scfg.max_seq,
            chunk_tokens=self.scfg.chunk_tokens))
        for i in range(b):
            # max_new_tokens=0: prefill-only, so a full-max_seq prompt
            # passes submit()'s prompt+new capacity check
            sched.submit(Request(rid=i, prompt=tokens[i], max_new_tokens=0))
        sched.admit()
        v = self.cfg.vocab_size
        full = torch.zeros((b, p, v), device=self.device) \
            if return_logits else None
        last = torch.zeros((b, v), device=self.device)
        while True:
            chunk = sched.next_prefill_chunk(fused=True)
            if chunk is None:
                break
            lg = self._chunk_call(chunk.tokens, chunk.pos, chunk.block_req,
                                  chunk.kv_len_next)
            if return_logits:
                live = np.flatnonzero(chunk.pos >= 0)
                tok_req = np.repeat(chunk.block_req,
                                    len(chunk.tokens) // len(chunk.block_req))
                full[self._tensor(tok_req[live]).long(),
                     self._tensor(chunk.pos[live]).long()] = \
                    lg[self._tensor(live).long()]
            for slot, row in chunk.last_rows:
                last[slot] = lg[row]
        return (last, full) if return_logits else last

    def _prefill_loop(self, tokens: np.ndarray, return_logits=False):
        b, p = tokens.shape
        if b != self.batch_size:
            raise ValueError(f"{b} prompts for {self.batch_size} slots")
        block_req = np.arange(b, dtype=np.int32)
        rows = []
        lg = None
        for t in range(p):
            lg = self._chunk_call(tokens[:, t], np.full(b, t, np.int32),
                                  block_req, np.full(b, t + 1, np.int32))
            if return_logits:
                rows.append(lg)
        if return_logits:
            return lg, torch.stack(rows, dim=1)
        return lg

    def _legacy_step(self, tokens: torch.Tensor, t: int):
        """One legacy decode step of every row at position ``t``; returns
        (next tokens [B] int32, logits [B, V] f32)."""
        self.n_chunk_calls += 1
        pos = torch.full((self.batch_size,), t, dtype=torch.int32,
                         device=self.device)
        nxt, logits = self._step(self.cache, tokens[:, None], pos)
        return nxt, logits[:, -1]

    def _prefill_legacy(self, tokens: np.ndarray):
        """The legacy branch's prefill (reference ``engine.py:214``): a
        token a step through ``decode_step``.  Starts a fresh generation:
        every slot's positions are emptied and recurrent states zeroed
        (the memory's ``xk``/``xv`` stay).  Returns the last logits
        [B, V]."""
        b, p = tokens.shape
        if b != self.batch_size:
            raise ValueError(f"{b} prompts for {self.batch_size} slots")
        for slot in self.cache["slots"]:
            for name, x in slot.items():
                if name == "kv_pos":
                    x.fill_(-1)
                elif name in ("conv", "state", "h"):
                    x.zero_()
        toks = torch.as_tensor(np.ascontiguousarray(tokens),
                               device=self.device)
        last = None
        for t in range(p):
            _, last = self._legacy_step(toks[:, t], t)
        return last

    def _generate_legacy(self, prompt: np.ndarray) -> torch.Tensor:
        """Greedy decode on the legacy branch (reference
        ``engine.py:246``)."""
        p = prompt.shape[1]
        nxt = self._prefill_legacy(prompt).argmax(-1).to(torch.int32)
        out = [nxt]
        for i in range(self.scfg.max_new_tokens - 1):
            nxt, _ = self._legacy_step(nxt, p + i)
            out.append(nxt)
        return torch.stack(out, dim=1)

    # ------------------------------------------------- static-batch decode
    def generate(self, prompt) -> torch.Tensor:
        """Greedy decode of a dense [B, P] batch; returns [B, max_new]."""
        prompt = np.asarray(prompt, np.int32)
        b, p = prompt.shape
        # tokens are cached at positions 0 .. p + max_new - 2
        if p + self.scfg.max_new_tokens - 1 > self.scfg.max_seq:
            raise ValueError(
                f"prompt {p} + max_new_tokens {self.scfg.max_new_tokens} "
                f"does not fit max_seq {self.scfg.max_seq}")
        if not self.serve_layout:
            return self._generate_legacy(prompt)
        lg = self.prefill(prompt)
        nxt = lg.argmax(-1).to(torch.int32)
        out = [nxt]
        block_req = np.arange(b, dtype=np.int32)
        for i in range(self.scfg.max_new_tokens - 1):
            lg = self._chunk_call(nxt.cpu().numpy(),
                                  np.full(b, p + i, np.int32), block_req,
                                  np.full(b, p + i + 1, np.int32))
            nxt = lg.argmax(-1).to(torch.int32)
            out.append(nxt)
        return torch.stack(out, dim=1)

    # --------------------------------------------------- continuous batching
    def make_scheduler(self, *, snapshot_provider=None) \
            -> ContinuousScheduler:
        """A ContinuousScheduler configured from this engine's
        ServeConfig: the state machine ``serve_round`` steps.  With a
        ``snapshot_provider`` (argument or ``ServeConfig`` field), cost
        admission prices from one live calibration snapshot per round;
        otherwise from the static analytic model."""
        if not self.serve_layout:
            raise ValueError("continuous batching needs the serving cache "
                             "layout (no cross-attention/encoder archs)")
        scfg = self.scfg
        provider = snapshot_provider or scfg.snapshot_provider
        need_cost = scfg.admission == "cost" or scfg.step_cost_budget
        return ContinuousScheduler(SchedulerConfig(
            n_slots=self.batch_size, max_seq=scfg.max_seq,
            chunk_tokens=scfg.chunk_tokens,
            token_budget=scfg.token_budget,
            admission=scfg.admission,
            cost_model=self._cost_model()
            if (need_cost and provider is None) else None,
            snapshot_provider=provider if need_cost else None,
            step_cost_budget=scfg.step_cost_budget,
            eos_id=scfg.eos_id))

    def serve_round(self, sched: ContinuousScheduler, *,
                    on_token=None) -> bool:
        """One continuous-batching round: admit -> (prefill chunk |
        evict + decode step).  Returns False when the scheduler had no
        work.  ``on_token(rid, token, done)`` streams every newly sampled
        token (the launch/serve.py daemon's hook)."""
        if not sched.has_work():
            return False
        obs_metrics.get_registry().counter(
            "serve_rounds_total", "continuous-batching rounds").inc()
        with obs_trace.get_recorder().span(
                "serve.round", "serve",
                args={"active": len(sched.active),
                      "waiting": len(sched.waiting)}):
            return self._serve_round_inner(sched, on_token)

    def _serve_round_inner(self, sched: ContinuousScheduler,
                           on_token) -> bool:
        newly = sched.admit()
        if newly:
            mask = np.zeros(self.batch_size, bool)
            for r in newly:
                mask[r.slot] = True
            self._reset(mask)
        fused = self.fused_ok and self.scfg.prefill == "fused"
        if sched.has_prefill():
            chunk = sched.next_prefill_chunk(fused=fused)
            lg = self._chunk_call(chunk.tokens, chunk.pos, chunk.block_req,
                                  chunk.kv_len_next)
            if chunk.last_rows:
                reqs = {slot: sched.active[slot]
                        for slot, _row in chunk.last_rows}
                nxt = lg.argmax(-1).cpu().numpy()
                sched.commit_prefill(
                    chunk, {slot: nxt[row]
                            for slot, row in chunk.last_rows})
                if on_token is not None:
                    for slot, req in sorted(reqs.items()):
                        if req.out_tokens:
                            on_token(req.rid, req.out_tokens[-1],
                                     req.state == DONE)
                        elif req.state == DONE:     # prefill-only
                            on_token(req.rid, None, True)
            return True
        sched.evict_for_budget()
        batch = sched.decode_batch()
        if batch is None:
            return True
        tokens, pos, block_req, kv_next = batch
        decoding = {slot: r for slot, r in sched.active.items()
                    if r.state == DECODE}
        lg = self._chunk_call(tokens, pos, block_req, kv_next)
        sched.commit_decode(lg.argmax(-1).cpu().numpy())
        if on_token is not None:
            for _slot, req in sorted(decoding.items()):
                on_token(req.rid, req.out_tokens[-1], req.state == DONE)
        return True

    def serve(self, prompts: List[np.ndarray],
              max_new_tokens: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Continuous batching: stream an arbitrary number of ragged
        requests through ``batch_size`` cache slots.  Returns
        {rid: generated tokens} with rid = submission index."""
        sched = self.make_scheduler()
        mn = self.scfg.max_new_tokens if max_new_tokens is None \
            else max_new_tokens
        for i, pr in enumerate(prompts):
            sched.submit(Request(rid=i, prompt=np.asarray(pr, np.int32),
                                 max_new_tokens=mn))
        while self.serve_round(sched):
            pass
        out = {r.rid: np.asarray(r.out_tokens, np.int32)
               for r in sched.done}
        self.last_trace = sched.trace
        return out

    def _cost_model(self):
        from repro_torch.core.cost_model import CostModel
        return CostModel.analytic(self.cfg.n_heads, self.cfg.head_dim)
