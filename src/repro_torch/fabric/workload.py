"""Serve-tenant workload: seeded inference traffic as real CA tasks.

The port of ``repro.fabric.workload``.  Each :class:`ServeRequest` owns
deterministic q/k/v content: drawn once, on the CPU, from a
``torch.Generator`` seeded with ``(seed, rid)`` (the reference draws
them with ``jax.random``; the two packages' draws differ), or taken as
given (``contents``), so that the same arrays can go through both
packages.  A task's output is then a pure function of ``(rid, task
index)``, *wherever and whenever it runs*: the paper's statelessness
property made testable (per-request output digests must match between a
shared-pool run, a statically partitioned run, and a run that loses a
server mid-decode).

The request lifecycle mirrors the serving engine: prefill chunks of up
to one 128-token block (the q-block purity the kernels require), then
one decode task per round.  ``build_batch`` packs the tasks admitted
onto one server into the exact fused layout
``core.dispatch.serve_task_batch`` consumes, as tensors on the caller's
device: q tasks padded to one block with dead (-1) rows, a dense
kv-block buffer, and a ``task_kv_start``/``task_kv_len`` plan, so
serve-tenant execution runs through the *same* server kernels as
training CA tasks.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.fabric.tenancy import ServeTaskReq


def _digest(x) -> str:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:          # numpy holds its bits
            x = x.view(torch.int16)
        x = x.numpy()
    return hashlib.sha1(np.ascontiguousarray(np.asarray(x))
                        .tobytes()).hexdigest()


def request_seed(seed: int, rid: int) -> int:
    """The seed of request ``rid``'s generator: a function of
    ``(seed, rid)`` alone, so a request's content does not depend on the
    other requests."""
    return (int(seed) * 1_000_003 + int(rid)) % (2 ** 63)


@dataclasses.dataclass
class ServeRequest:
    """One inference request plus its workload-owned runtime state."""
    rid: int
    prompt_len: int
    max_new_tokens: int
    arrival_step: int
    # deterministic content, generated once at construction
    qc: np.ndarray = dataclasses.field(repr=False, default=None)
    kc: np.ndarray = dataclasses.field(repr=False, default=None)
    vc: np.ndarray = dataclasses.field(repr=False, default=None)
    # runtime
    n_prefilled: int = 0
    n_decoded: int = 0
    digests: List[str] = dataclasses.field(default_factory=list)
    done_step: int = -1

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens

    @property
    def done(self) -> bool:
        return self.n_prefilled >= self.prompt_len \
            and self.n_decoded >= self.max_new_tokens

    def next_task(self, blk: int = 128) -> Optional[Tuple[int, int, int]]:
        """(seq, q_tokens, kv_tokens) of the next CA task, or None.
        The task sequence is fixed per request — prefill chunks of up
        to ``blk`` tokens, then one task per decoded token — so task
        ``seq``'s content (hence output) never depends on *when* or
        *where* earlier tasks ran."""
        if self.n_prefilled < self.prompt_len:
            seq = self.n_prefilled // blk
            qt = min(blk, self.prompt_len - self.n_prefilled)
            return seq, qt, self.n_prefilled + qt
        if self.n_decoded < self.max_new_tokens:
            nchunks = -(-self.prompt_len // blk)
            p = self.prompt_len + self.n_decoded
            return nchunks + self.n_decoded, 1, p + 1
        return None


class ServeWorkload:
    """A set of seeded requests + the fused-batch builder.

    ``arrivals`` is ``[(arrival_step, prompt_len, max_new_tokens), ...]``
    (rid = list index).  ``slots`` bounds tasks per fused server batch
    (longer placements execute in slot-sized groups); the kv buffer
    holds ``slots * ceil(max_total / blk)`` blocks, and ``jmax`` (for
    the server kernel's scan bound) is the per-request block count.
    ``contents`` gives each request's ``(qc, kc, vc)`` arrays
    (``[pad, H(kv), dh]``, pad = total length rounded up to ``blk``)
    instead of drawing them.  ``dtype`` is the batches' dtype (the
    reference's is f32)."""

    def __init__(self, arrivals: Sequence[Tuple[int, int, int]], *,
                 n_heads: int = 2, head_dim: int = 16,
                 n_kv_heads: Optional[int] = None, blk: int = 128,
                 slots: int = 8, seed: int = 0,
                 contents: Optional[Sequence[Tuple[np.ndarray, ...]]] = None,
                 dtype=torch.float32):
        self.blk = int(blk)
        self.h, self.dh = int(n_heads), int(head_dim)
        self.hkv = int(n_kv_heads or n_heads)
        self.slots = int(slots)
        self.seed = int(seed)
        self.dtype = dtype
        self.requests: List[ServeRequest] = []
        if contents is not None and len(contents) != len(arrivals):
            raise ValueError(f"{len(contents)} request contents for "
                             f"{len(arrivals)} arrivals")
        max_total = 0
        for rid, (arr, plen, mnew) in enumerate(arrivals):
            if plen < 1:
                raise ValueError(f"request {rid}: empty prompt")
            total = plen + mnew
            max_total = max(max_total, total)
            pad = -(-total // self.blk) * self.blk
            shapes = ((pad, self.h, self.dh), (pad, self.hkv, self.dh),
                      (pad, self.hkv, self.dh))
            if contents is None:
                gen = torch.Generator().manual_seed(request_seed(seed, rid))
                qc, kc, vc = (torch.randn(s, generator=gen).numpy()
                              for s in shapes)
            else:
                qc, kc, vc = (np.array(a, np.float32, copy=True)
                              for a in contents[rid])
                if (qc.shape, kc.shape, vc.shape) != shapes:
                    raise ValueError(f"request {rid}: contents of shapes "
                                     f"{(qc.shape, kc.shape, vc.shape)}, "
                                     f"want {shapes}")
            self.requests.append(ServeRequest(
                rid=rid, prompt_len=int(plen), max_new_tokens=int(mnew),
                arrival_step=int(arr), qc=qc, kc=kc, vc=vc))
        self.req_blocks = max(1, -(-max_total // self.blk))
        self.kv_blocks = self.slots * self.req_blocks
        self.jmax = self.req_blocks
        self.waits: Dict[int, int] = {}       # rid -> deferred rounds
        self.tokens_executed = 0

    # ------------------------------------------------------------ queries
    def pending(self, step: int) -> List[ServeTaskReq]:
        """One ready task per arrived, unfinished request, FCFS order
        (arrival step, then rid) — the admission round's input."""
        out = []
        for r in self.requests:
            if r.arrival_step > step or r.done:
                continue
            seq, qt, kvt = r.next_task(self.blk)
            out.append(ServeTaskReq(rid=r.rid, seq=seq, q_tokens=qt,
                                    kv_tokens=kvt,
                                    arrival_step=r.arrival_step))
        out.sort(key=lambda t: (t.arrival_step, t.rid))
        return out

    def all_done(self) -> bool:
        return all(r.done for r in self.requests)

    def record_waits(self, deferred: Sequence[ServeTaskReq]) -> None:
        for t in deferred:
            self.waits[t.rid] = self.waits.get(t.rid, 0) + 1

    # ---------------------------------------------------------- execution
    def build_arrays(self, tasks: Sequence[ServeTaskReq]):
        """The fused batch of up to ``slots`` tasks as host arrays:
        ``((q_tasks, qpos, k_buf, v_buf, kpos), plan)`` in
        ``serve_task_batch``'s layout.  Dead q rows carry position -1
        (masked by the kernel), kv padding rows likewise."""
        if len(tasks) > self.slots:
            raise ValueError(f"{len(tasks)} tasks > {self.slots} slots")
        blk, h, dh, hkv = self.blk, self.h, self.dh, self.hkv
        q_tasks = np.zeros((self.slots, blk, h, dh), np.float32)
        qpos = -np.ones((self.slots, blk), np.int32)
        k_buf = np.zeros((self.kv_blocks, blk, hkv, dh), np.float32)
        v_buf = np.zeros((self.kv_blocks, blk, hkv, dh), np.float32)
        kpos = -np.ones((self.kv_blocks, blk), np.int32)
        kv_start = np.zeros(self.slots, np.int32)
        kv_len = np.zeros(self.slots, np.int32)
        cur = 0
        for i, t in enumerate(tasks):
            r = self.requests[t.rid]
            qt, kvt = t.q_tokens, t.kv_tokens
            lo = kvt - qt                      # q rows' absolute positions
            q_tasks[i, :qt] = r.qc[lo:lo + qt]
            qpos[i, :qt] = np.arange(lo, lo + qt, dtype=np.int32)
            nbk = -(-kvt // blk)
            k_buf[cur:cur + nbk] = r.kc[:nbk * blk].reshape(
                nbk, blk, hkv, dh)
            v_buf[cur:cur + nbk] = r.vc[:nbk * blk].reshape(
                nbk, blk, hkv, dh)
            p = np.arange(nbk * blk, dtype=np.int32)
            kpos[cur:cur + nbk] = np.where(p < kvt, p, -1).reshape(
                nbk, blk)
            kv_start[i], kv_len[i] = cur, nbk
            cur += nbk
        return ((q_tasks, qpos, k_buf, v_buf, kpos),
                {"task_kv_start": kv_start, "task_kv_len": kv_len})

    def build_batch(self, tasks: Sequence[ServeTaskReq], device="cuda"):
        """:meth:`build_arrays` as tensors on ``device`` (the card unless
        the caller asks for the CPU): q, k and v in the workload's
        ``dtype``, positions and the plan int32."""
        (q, qpos, k, v, kpos), plan = self.build_arrays(tasks)
        dev = torch.device(device)

        def t(a):
            x = torch.as_tensor(a, device=dev)
            return x.to(self.dtype) if a.dtype == np.float32 else x
        inputs = tuple(t(a) for a in (q, qpos, k, v, kpos))
        return inputs, {key: t(val) for key, val in plan.items()}

    def commit(self, task: ServeTaskReq, out_rows, step: int) -> None:
        """Record one executed task's output digest and advance the
        request.  The digest covers exactly the live q rows, so it is
        independent of batch-mates and placement."""
        r = self.requests[task.rid]
        r.digests.append(_digest(out_rows[:task.q_tokens]))
        if r.n_prefilled < r.prompt_len:
            r.n_prefilled += task.q_tokens
        else:
            r.n_decoded += 1
        if r.done:
            r.done_step = step
        self.waits.pop(task.rid, None)
        self.tokens_executed += task.q_tokens

    # ------------------------------------------------------------ reports
    def digest_map(self) -> Dict[int, Tuple[str, ...]]:
        return {r.rid: tuple(r.digests) for r in self.requests}

    def completion(self) -> Dict[int, int]:
        return {r.rid: r.done_step for r in self.requests}
