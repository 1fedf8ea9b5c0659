"""CAD runtime: dispatch CA-tasks to the attention-server pool.

The port of ``repro.core.dispatch``'s single-process path.  Dataflow per
transformer layer (paper §4.1, Figure 2):

  local q/k/v blocks --gather--> per-destination send buffers
      --exchange--> attention servers
      --fused CA kernel over each server's task batch--> outputs
      --exchange (transposed)--> home ranks --scatter--> local layout

Two execution paths with the same arithmetic (shared helpers):

* ``_rank_fn``, the port of the reference's ``shard_map`` body: one
  process per rank in a ``torch.distributed`` group (``ctx.group``, one
  rank per attention server; NCCL on the card, gloo on the CPU).  Each
  rank gathers its sends from its own rows and plan row, exchanges them
  with ``all_to_all_single`` (``_Exchange``: its backward is the same
  exchange of the gradient, the transpose JAX derives), serves its fused
  batch and brings the outputs home with a second exchange.
* ``_global_sim``: every rank in one process.  The reference's ``vmap``
  over ranks is a leading ``[D]`` axis written out, and the exchange is a
  transpose of ``[D_src, D_dst, ...]`` buffers.

Each server's batch is one ``ca_server_attention`` call (the CUDA
kernels on CUDA tensors, their plain versions on CPU tensors), given the
same inputs on both paths, so their outputs are bitwise equal.
Everything around the kernels is gather, concatenation, exchange and
scatter, so autograd mirrors the communication in the backward (the
paper's "backward reuses the schedule").

Ping-pong (paper §4.1, Figure 7) splits each rank's rows into two
nano-batches with their own plans.  Under a group the exchanges are
issued asynchronously in the order of ``_pingpong_ranks``, so nano-batch
1's exchange is in flight while nano-batch 0 is served; in one process
the two halves run one after the other.

Windowed and non-causal layers, and calls without a plan, go to
``xla_flash_attention`` as in the reference.

The decomposed dispatch (DESIGN.md §9, §11, §13): ``build_server_inputs``
materializes each server's batch on its own, ``serve_task_batch`` serves
one (streamed through ``stream_task_batch`` when ``stream_chunk`` is
set), ``assemble_step_outputs`` scatters the outputs home (missing
servers give zeros; ``merge_recovered`` selects recovered blocks in).
``probe_plan_times`` times each server's batch for the runtime
calibrator; under a group each rank times its own server's batch
(``server_inputs``), the ranks in turn.  The ring baseline
(DISTFLASHATTN) runs each server's batch one ring pass at a time
(``ring_attention``; ``ring_global_sim`` is the same schedule through
the stacked orchestration).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.attention import xla_flash_attention
from repro_torch.core.mask import live_block_mask, live_kv_len, mask_params
from repro_torch.core.plan import CADConfig, PingPongPlan
from repro_torch.kernels.packed_flash.ops import (ca_partial_attention,
                                                  ca_server_attention,
                                                  ca_server_fwd_chunked,
                                                  merge_softmax_partials)
from repro_torch.obs import server_track
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.regions import marked


@dataclasses.dataclass(frozen=True)
class CADContext:
    """Static CAD pool description + the plan for this step.

    ``plan`` is a :class:`repro_torch.core.plan.StepPlan` (or
    :class:`PingPongPlan` when ping-pong is on) whose fields are int32
    tensors on the compute device (``plan.to(device)``).  There is no
    server-kernel choice: CUDA tensors run the kernels, CPU tensors the
    plain versions."""
    cfg: CADConfig
    plan: Any = None          # StepPlan | PingPongPlan
    jmax: int = 0             # max kv blocks any task touches (0 -> nkv)
    pingpong: bool = False
    mask: Any = None          # Optional[MaskSpec] — the step's task shape
                              # (DESIGN.md §12); None = dense causal

    def bind_plan(self, ctx, plan):
        new_cad = dataclasses.replace(self, plan=plan)
        return dataclasses.replace(ctx, cad=new_cad)


# ------------------------------------------------------------ helpers
# Every helper takes the leading rank / server axis [D] explicitly.
def _to_blocks(x, blk):
    """[D, Bl, S, ...] -> [D, NB, blk, ...] (row-major token stream)."""
    d, bl, s = x.shape[:3]
    return x.reshape((d, bl * s // blk, blk) + tuple(x.shape[3:]))


class _GatherRows(torch.autograd.Function):
    """``x[idx]`` over dim 0 whose backward sums repeated rows in a fixed
    order: ``index_add`` (serial over the index) on the CPU, where the
    backward of ``x[idx]`` adds with atomics once torch has several
    threads; ``index_put(accumulate=True)`` (sorted, deterministic) on
    CUDA, where ``index_add`` adds with atomics."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        gx = g.new_zeros(ctx.shape)
        if g.is_cuda:
            gx.index_put_((idx,), g, accumulate=True)
        else:
            gx.index_add_(0, idx, g)
        return gx, None


def _gather_blocks(xb, idx, fill=0.0):
    """xb [D, NB, ...]; idx [D, ...] with -1 padding -> [D, ..., ...],
    each rank gathering from its own blocks; pad rows = ``fill``."""
    d, nb = xb.shape[:2]
    tail = tuple(xb.shape[2:])
    base = torch.arange(d, device=xb.device).reshape(
        (d,) + (1,) * (idx.dim() - 1)) * nb
    rows = (idx.long().clamp(min=0) + base).reshape(-1)
    out = _GatherRows.apply(xb.reshape((d * nb,) + tail), rows)
    out = out.reshape(tuple(idx.shape) + tail)
    mask = (idx >= 0).reshape(tuple(idx.shape) + (1,) * len(tail))
    return torch.where(mask, out, fill)


def _make_sends(qb, kb, vb, posb, plan):
    """Per-rank send buffers [D_src, D_dst, C, ...]."""
    q_send = _gather_blocks(qb, plan["q_send_idx"])   # [D, D, CQ, blk, H, dh]
    qpos_send = _gather_blocks(posb, plan["q_send_idx"], fill=-1)
    k_send = _gather_blocks(kb, plan["kv_send_idx"])  # [D, D, CKV, ...]
    v_send = _gather_blocks(vb, plan["kv_send_idx"])
    kpos_send = _gather_blocks(posb, plan["kv_send_idx"], fill=-1)
    return q_send, qpos_send, k_send, v_send, kpos_send


def _server_tasks(qb, kb, vb, posb, recv, plan, cfg: CADConfig):
    """Assemble every server's fused CA-task batch: home tasks then
    received tasks, and the dense kv buffer gathered from
    concat(local blocks, received slots)."""
    q_recv, qpos_recv, k_recv, v_recv, kpos_recv = recv
    d, cq, ckv = cfg.n_servers, cfg.cq, cfg.ckv

    def flat(x, c):            # [D, D_src, C, ...] -> [D, D_src * C, ...]
        return x.reshape((x.shape[0], d * c) + tuple(x.shape[3:]))

    q_home = _gather_blocks(qb, plan["q_home_idx"])
    qpos_home = _gather_blocks(posb, plan["q_home_idx"], fill=-1)
    q_tasks = torch.cat([q_home, flat(q_recv, cq)], dim=1)
    qpos_tasks = torch.cat([qpos_home, flat(qpos_recv, cq)], dim=1)
    k_all = torch.cat([kb, flat(k_recv, ckv)], dim=1)
    v_all = torch.cat([vb, flat(v_recv, ckv)], dim=1)
    kpos_all = torch.cat([posb, flat(kpos_recv, ckv)], dim=1)
    k_buf = _gather_blocks(k_all, plan["kv_gather"])
    v_buf = _gather_blocks(v_all, plan["kv_gather"])
    kpos_buf = _gather_blocks(kpos_all, plan["kv_gather"], fill=-1)
    return q_tasks, qpos_tasks, k_buf, v_buf, kpos_buf


def _server_kwargs(cad, inputs_s, plan_s, window=0):
    """One server's fused batch ``(q_tasks, qpos_tasks, k_buf, v_buf,
    kpos_buf)`` and its plan rows as ``ca_server_attention`` keyword
    arguments, without ``softcap`` and ``scale``."""
    q_tasks, qpos_tasks, k_buf, v_buf, kpos_buf = inputs_s
    window, sink, rate = mask_params(cad.mask, window)
    return dict(q_tasks=q_tasks.contiguous(), k_buf=k_buf.contiguous(),
                v_buf=v_buf.contiguous(),
                kv_start=plan_s["task_kv_start"].contiguous(),
                kv_len=plan_s["task_kv_len"].contiguous(),
                q_pos=qpos_tasks.contiguous(), kv_pos=kpos_buf.contiguous(),
                jmax=cad.jmax or cad.cfg.nkv, window=window, sink=sink,
                rate=rate)


def _server_calls(q_tasks, qpos_tasks, k_buf, v_buf, kpos_buf, plan, cad,
                  window=0):
    """Each server's fused batch (inputs with the leading [D] axis) as
    ``ca_server_attention`` keyword arguments, one dict per server,
    without ``softcap`` and ``scale``."""
    tasks = (q_tasks, qpos_tasks, k_buf, v_buf, kpos_buf)
    return [_server_kwargs(cad, tuple(x[s] for x in tasks),
                           {k: plan[k][s] for k in ("task_kv_start",
                                                    "task_kv_len")}, window)
            for s in range(q_tasks.shape[0])]


def _serve(q_tasks, qpos_tasks, k_buf, v_buf, kpos_buf, plan, cad,
           softcap, window, scale):
    """Run each server's fused batch: one ``ca_server_attention`` per
    server (inputs with the leading [D] axis; returns [D, T, ...])."""
    calls = _server_calls(q_tasks, qpos_tasks, k_buf, v_buf, kpos_buf, plan,
                          cad, window)
    return torch.stack([ca_server_attention(**kw, softcap=softcap,
                                            scale=scale) for kw in calls])


def _scatter_outputs(out_tasks, ret_recv, plan, cfg: CADConfig, nb, blk,
                     hq, dh, dtype):
    """Home-rank reassembly: home task slots + returned remote outputs,
    added into f32 zeros in that order (every live block gets exactly one
    output; padding slots add exact zeros).  Returns [D, NB, blk, H, dh]."""
    d = out_tasks.shape[0]
    dev = out_tasks.device
    base = (torch.arange(d, device=dev) * nb)
    out = torch.zeros((d * nb, blk, hq, dh), dtype=torch.float32,
                      device=dev)
    # home tasks: slot i corresponds to local block q_home_idx[i]
    idx_home = plan["q_home_idx"].long()                    # [D, NB]
    contrib = torch.where((idx_home >= 0)[..., None, None, None],
                          out_tasks[:, :nb].float(), 0.0)
    out = out.index_add(0, (idx_home.clamp(min=0) + base[:, None])
                        .reshape(-1), contrib.reshape((-1, blk, hq, dh)))
    # remote returns: ret_recv [D, D, CQ, blk, H, dh]; slot (s, c) is the
    # output of local block q_send_idx[s, c] (this rank's row as src)
    idx_rem = plan["q_send_idx"].long()                     # [D, D, CQ]
    contrib_r = torch.where((idx_rem >= 0)[..., None, None, None],
                            ret_recv.float(), 0.0)
    out = out.index_add(0, (idx_rem.clamp(min=0) + base[:, None, None])
                        .reshape(-1), contrib_r.reshape((-1, blk, hq, dh)))
    return out.to(dtype).reshape((d, nb, blk, hq, dh))


class _Exchange(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` with even splits on dim 0:
    ``x [D_dst, C, ...]`` (this rank's sends) -> ``[D_src, C, ...]`` (what
    every rank sent here).  The backward exchanges the gradient the same
    way, which is its transpose.  With ``works`` (a list) the forward is
    issued asynchronously and its work handle appended: the output must
    not be read before ``work.wait()``.  The backward's exchange is
    synchronous.  (Not ``torch.distributed.nn.functional``'s, which warns
    on import of its symbols in recent torch.)"""

    @staticmethod
    def forward(ctx, x, group, works):
        import torch.distributed as dist
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=group,
                                      async_op=works is not None)
        if works is not None:
            works.append(work)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None, None


def _exchange(x, group, works=None):
    return _Exchange.apply(x, group, works)


def _wait(works) -> None:
    for w in works:
        w.wait()


def _sim_exchange(x):
    """Single-process all_to_all: [D_src, D_dst, C, ...] ->
    [D_dst, D_src, C, ...]."""
    return x.transpose(0, 1)


def _task_batches(q, k, v, pos, plan, cfg: CADConfig):
    """Blocks, sends and the exchange of every rank: returns (NB, the
    servers' fused task batches ``(q_tasks, qpos_tasks, k_buf, v_buf,
    kpos_buf)`` with the leading [D] axis)."""
    d, blk = cfg.n_servers, cfg.blk

    def stack_ranks(x):
        return x.reshape((d, x.shape[0] // d) + tuple(x.shape[1:]))

    qb, kb, vb, posb = (_to_blocks(stack_ranks(x), blk)
                        for x in (q, k, v, pos))
    recv = tuple(_sim_exchange(s)
                 for s in _make_sends(qb, kb, vb, posb, plan))
    return qb.shape[1], _server_tasks(qb, kb, vb, posb, recv, plan, cfg)


def _global_sim(q, k, v, pos, plan, cad, softcap, scale):
    """Every rank and server in one process.  q [D*Bl, S, H, dh] with
    rank-major rows; pos [D*Bl, S] (-1 = padding)."""
    cfg = cad.cfg
    nb, tasks = _task_batches(q, k, v, pos, plan, cfg)
    out_tasks = _serve(*tasks, plan, cad, softcap, 0, scale)
    ret_send = out_tasks[:, nb:].reshape((cfg.n_servers, cfg.n_servers,
                                          cfg.cq)
                                         + tuple(out_tasks.shape[2:]))
    out = _scatter_outputs(out_tasks, _sim_exchange(ret_send), plan, cfg,
                           nb, cfg.blk, q.shape[2], q.shape[3], q.dtype)
    return out.reshape(q.shape)


def _plan_row(plan, rank: int, device) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s row of every plan field, keeping a leading axis of
    1 (the helpers' ``[D]`` axis with one rank)."""
    return {k: v[rank:rank + 1] for k, v in _plan_tensors(plan,
                                                          device).items()}


def _rank_sends(q, k, v, pos, plan_r, cfg: CADConfig, group, works=None):
    """This rank's blocks and the five exchanges of its sends: returns
    ((qb, kb, vb, posb), recv), the received buffers ``[1, D_src, C, ...]``
    (valid once ``works`` are waited on, when given)."""
    blocks = tuple(_to_blocks(x[None], cfg.blk) for x in (q, k, v, pos))
    recv = tuple(_exchange(x[0], group, works)[None]
                 for x in _make_sends(*blocks, plan_r))
    return blocks, recv


def _rank_serve(blocks, recv, plan_r, cad, softcap, scale, group,
                works=None):
    """Serve this rank's fused batch and exchange the remote outputs
    home: returns (out_tasks [1, T, ...], ret_recv [1, D_src, CQ, ...])."""
    cfg = cad.cfg
    out_tasks = _serve(*_server_tasks(*blocks, recv, plan_r, cfg), plan_r,
                       cad, softcap, 0, scale)
    nb = blocks[0].shape[1]
    ret_send = out_tasks[0, nb:].reshape((cfg.n_servers, cfg.cq)
                                         + tuple(out_tasks.shape[2:]))
    return out_tasks, _exchange(ret_send, group, works)[None]


def _rank_scatter(out_tasks, ret_recv, plan_r, cfg: CADConfig, q):
    nb = q.shape[0] * q.shape[1] // cfg.blk
    out = _scatter_outputs(out_tasks, ret_recv, plan_r, cfg, nb, cfg.blk,
                           q.shape[2], q.shape[3], q.dtype)
    return out.reshape(q.shape)


def _rank_fn(q, k, v, pos, plan_r, cad, softcap, scale, group):
    """One rank of the group (the reference's ``shard_map`` body,
    ``src/repro/core/dispatch.py:338-361``).  q/k/v ``[Bl, S, H(kv),
    dh]`` are this rank's rows, ``pos`` ``[Bl, S]``, ``plan_r`` its plan
    row (``_plan_row``)."""
    blocks, recv = _rank_sends(q, k, v, pos, plan_r, cad.cfg, group)
    out_tasks, ret_recv = _rank_serve(blocks, recv, plan_r, cad, softcap,
                                      scale, group)
    return _rank_scatter(out_tasks, ret_recv, plan_r, cad.cfg, q)


def _pingpong_ranks(nanos, plans_r, cad, softcap, scale, group):
    """Two nano-batches of one rank, their exchanges overlapping the other
    half's serve.  Issue order: 0's sends, then 1's (both asynchronous);
    wait on 0, serve 0 and start its return; wait on 1, serve 1 and start
    its return; then scatter 0 and 1.  On NCCL an asynchronous collective
    runs on the communicator's stream and ``wait`` only makes the compute
    stream wait for it, so 1's exchange is in flight while 0's CA forward
    runs.  The backward's exchanges are synchronous (``_Exchange``): it
    overlaps nothing."""
    cfg = cad.cfg
    sent = []
    for (q, k, v, pos), plan_r in zip(nanos, plans_r):
        works = []
        sent.append((_rank_sends(q, k, v, pos, plan_r, cfg, group, works),
                     works))
    served = []
    for ((blocks, recv), works), plan_r in zip(sent, plans_r):
        _wait(works)
        ret_works = []
        served.append((_rank_serve(blocks, recv, plan_r, cad, softcap,
                                   scale, group, ret_works), ret_works))
    outs = []
    for ((out_tasks, ret_recv), ret_works), plan_r, nano in zip(
            served, plans_r, nanos):
        _wait(ret_works)
        outs.append(_rank_scatter(out_tasks, ret_recv, plan_r, cfg,
                                  nano[0]))
    return outs


def check_cad_group(cad: "CADContext", group) -> int:
    """This process's rank in ``group``; raises unless the group has one
    rank per attention server of ``cad.cfg``."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n != cad.cfg.n_servers:
        raise ValueError(f"the CAD group has {n} ranks, the plan "
                         f"{cad.cfg.n_servers} attention servers")
    return dist.get_rank(group)


def server_batches(q, k, v, pos, plan, cad):
    """The per-server fused CA-task batches ``_global_sim`` hands the
    kernels, as ``ca_server_attention`` keyword arguments (one dict per
    server): what a test or ``chip_smoke.py`` holds the kernels against
    at the main path's shapes."""
    _, tasks = _task_batches(q, k, v, pos, plan, cad.cfg)
    return _server_calls(*tasks, plan, cad)


# ------------------------------------------------- decomposed dispatch
def _plan_tensors(plan, device) -> Dict[str, torch.Tensor]:
    """A plan's fields (host arrays or tensors) as int32 tensors on
    ``device``."""
    return {k: v.to(device=device, dtype=torch.int32) if torch.is_tensor(v)
            else torch.as_tensor(np.asarray(v, np.int32), device=device)
            for k, v in plan.items()}


def _plan_numpy(plan) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in plan.items()}


def build_server_inputs(cad: CADContext, plan, q, k, v, pos):
    """Decomposed dispatch: every server's fused CA-task inputs for one
    plan, each materialized on its own (the port of
    ``dispatch.build_server_inputs``).  ``q``/``k``/``v`` are the stacked
    rank-major layout ``[D*Bl, S, H(kv), dh]``, ``pos`` ``[D*Bl, S]``
    (-1 = padding).  Returns ``(inputs, plans_r)``: ``inputs[s]`` is the
    ``(q_tasks, qpos_tasks, k_buf, v_buf, kpos_buf)`` batch of server s,
    ``plans_r[s]`` its plan rows (int32 tensors on q's device).  Each
    server's serve can then fail, be retried or be re-served alone
    (DESIGN.md §9), or stream its kv buffer in chunks (§11)."""
    plan_t = _plan_tensors(plan, q.device)
    _, tasks = _task_batches(q, k, v, pos, plan_t, cad.cfg)
    d = cad.cfg.n_servers
    return ([tuple(x[s] for x in tasks) for s in range(d)],
            [{key: val[s] for key, val in plan_t.items()}
             for s in range(d)])


def server_inputs(cad: CADContext, plan, q, k, v, pos, server: int):
    """One server's fused CA-task inputs and plan row, gathered as the
    rank path gathers them (its own blocks, and the blocks every rank
    sends it) with no exchange: ``q``/``k``/``v``/``pos`` hold every
    rank's rows, as for :func:`build_server_inputs`, whose
    ``inputs[server]`` and ``plans_r[server]`` these equal bitwise.  The
    probe's rank half: rank ``server`` builds its own batch alone."""
    cfg = cad.cfg
    d = cfg.n_servers
    plan_t = _plan_tensors(plan, q.device)
    blocks = tuple(_to_blocks(x.reshape((d, x.shape[0] // d)
                                        + tuple(x.shape[1:])), cfg.blk)
                   for x in (q, k, v, pos))
    # what every rank sends to ``server``: its column of the send indices
    to_server = {f: plan_t[f][:, server]
                 for f in ("q_send_idx", "kv_send_idx")}
    recv = tuple(x[None] for x in _make_sends(*blocks, to_server))
    own = tuple(b[server:server + 1] for b in blocks)
    row = _plan_row(plan_t, server, q.device)
    tasks = _server_tasks(*own, recv, row, cfg)
    return tuple(x[0] for x in tasks), {f: a[0] for f, a in row.items()}


def _serve_one(cad, inputs_s, plan_s, softcap, scale):
    return ca_server_attention(**_server_kwargs(cad, inputs_s, plan_s),
                               softcap=softcap, scale=scale)


def stream_task_batch(cad: CADContext, inputs_s, plan_s, *,
                      chunk_blocks: Optional[int] = None,
                      softcap: float = 0.0, scale=None):
    """Chunked KV streaming serve of ONE server (DESIGN.md §11): the
    batch walks its kv range ``chunk_blocks`` kv blocks at a time,
    carrying the online-softmax state across chunks, and normalizes once
    (``ca_server_fwd_range``: the CA forward kernels with a carry on CUDA
    tensors, the plain version's split on CPU tensors).  The output is
    bitwise equal to the unstreamed serve for every chunk size.  Forward
    only, as every caller of the reference uses it: inputs that require
    grad raise."""
    chunk = int(chunk_blocks if chunk_blocks is not None
                else cad.cfg.stream_chunk)
    if chunk <= 0:
        raise ValueError(
            f"stream_task_batch needs chunk_blocks > 0 kv blocks "
            f"(or CADConfig.stream_chunk set), got {chunk}")
    return ca_server_fwd_chunked(**_server_kwargs(cad, inputs_s, plan_s),
                                 chunk_blocks=chunk, softcap=softcap,
                                 scale=scale)[0]


def serve_task_batch(cad: CADContext, inputs_s, plan_s, *,
                     softcap: float = 0.0, scale=None,
                     stream_chunk: Optional[int] = None):
    """Run ONE server's fused CA-task batch: the unit of work the elastic
    runtime dispatches, retries and re-serves.  With chunked KV streaming
    on (``cfg.stream_chunk`` > 0, or ``stream_chunk``) and a kv range of
    more than one chunk, it goes through :func:`stream_task_batch`."""
    chunk = cad.cfg.stream_chunk if stream_chunk is None \
        else int(stream_chunk)
    if 0 < chunk < (cad.jmax or cad.cfg.nkv):
        return stream_task_batch(cad, inputs_s, plan_s, chunk_blocks=chunk,
                                 softcap=softcap, scale=scale)
    return _serve_one(cad, inputs_s, plan_s, softcap, scale)


def assemble_step_outputs(cfg: CADConfig, plan, out_tasks, q_shape, dtype):
    """Home-rank reassembly of per-server outputs: the return exchange and
    ``_scatter_outputs``, as ``_global_sim`` runs them.  ``out_tasks``
    maps server -> its ``[T, blk, H, dh]`` output; a server missing from
    it (failed, killed) contributes zeros, so its blocks can be recovered
    and merged in with :func:`merge_recovered`."""
    d, blk = cfg.n_servers, cfg.blk
    dev = next(iter(out_tasks.values())).device
    plan_t = _plan_tensors(plan, dev)
    nb = plan_t["q_home_idx"].shape[1]
    cq = plan_t["q_send_idx"].shape[2]
    n_tasks = plan_t["task_kv_len"].shape[1]
    hq, dh = q_shape[-2], q_shape[-1]
    zeros = torch.zeros((n_tasks, blk, hq, dh), dtype=dtype, device=dev)
    stacked = torch.stack([out_tasks.get(s, zeros) for s in range(d)])
    ret_send = stacked[:, nb:].reshape((d, d, cq) + tuple(stacked.shape[2:]))
    out = _scatter_outputs(stacked, _sim_exchange(ret_send), plan_t, cfg,
                           nb, blk, hq, dh, dtype)
    return out.reshape(q_shape)


def merge_recovered(cfg: CADConfig, base, recovered, lost_blocks):
    """Exactly-once merge of a recovery's outputs into a step's base
    outputs: every q block's output is selected (bitwise) from one
    execution, the blocks of ``lost_blocks`` (boolean ``[D, NB]`` or
    ``[D*NB]``) from ``recovered``, the rest from ``base``."""
    d, blk = cfg.n_servers, cfg.blk
    lost = np.asarray(lost_blocks, bool).reshape(d, -1)
    tok = np.repeat(lost, blk, axis=1).reshape(base.shape[0], base.shape[1])
    mask = torch.as_tensor(tok, device=base.device)
    return torch.where(mask[..., None, None], recovered, base)


def probe_plan_times(cad: CADContext, plan, *, n_heads: int = 1,
                     head_dim: int = 8, n_kv_heads: Optional[int] = None,
                     dtype=torch.float32, seed: int = 0, repeats: int = 1,
                     trace_label: str = "probe", device="cuda",
                     group=None) \
        -> List[Tuple[int, List[Tuple[int, int]], float]]:
    """Time each server's fused CA-task batch for one plan with seeded
    q/k/v: the runtime calibrator's measurement (DESIGN.md §3).  Kernel
    time depends on shapes, not values.  One warm-up serve first takes in
    the library build and the first launch; each server's ``repeats``
    serves are then timed between two ``torch.cuda.synchronize`` calls,
    inside a span on the server's own trace track.  Returns one
    ``(server, [(q_tokens, kv_tokens), ...], seconds)`` per server, ready
    for ``GridCalibrator.observe_tasks``.  ``device`` defaults to the
    card; the serve is the one training runs (the CA kernels there, the
    plain versions on the CPU).

    Under ``group`` (the CAD group, one rank per server) rank r builds
    its own server's batch alone (:func:`server_inputs`, bitwise the
    one-process probe's ``inputs[r]``), serves its warm-up, and times its
    ``repeats`` serves in its turn: the ranks take turns in rank order
    with a barrier between turns, as the reference's loop takes the
    servers one after another, so no rank's probe overlaps another's on
    a shared card.  It returns ``[(r, tasks, seconds)]``; the session
    gathers the ranks' triples (``CADSession.observe_probe``)."""
    cfg = cad.cfg
    d, nb, blk = cfg.n_servers, cfg.nb, cfg.blk
    s_len = nb * blk
    hkv = n_kv_heads or n_heads
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(h):
        return torch.randn((d, s_len, h, head_dim), generator=gen,
                           device=dev).to(dtype)

    q, k, v = rnd(n_heads), rnd(hkv), rnd(hkv)
    pos = torch.arange(s_len, dtype=torch.int32, device=dev) \
        .expand(d, s_len).contiguous()
    if group is None:
        mine = range(d)
        inputs, plans_r = build_server_inputs(cad, plan, q, k, v, pos)
    else:
        rank = check_cad_group(cad, group)
        mine = (rank,)
        got, row = server_inputs(cad, plan, q, k, v, pos, rank)
        inputs, plans_r = {rank: got}, {rank: row}
    by_server: Dict[int, List[Tuple[int, int]]] = {s: [] for s in range(d)}
    for s, _slot, qt, kvt in iter_plan_tasks(cfg, plan, mask=cad.mask):
        by_server[s].append((qt, kvt))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    reps = max(1, repeats)
    rec = obs_trace.get_recorder()
    results = []

    def timed(s):
        # the span lands on the server's own track (``trace_label``
        # tells ping-pong halves apart)
        with rec.span(trace_label, server_track(s),
                      args={"repeats": reps, "n_tasks": len(by_server[s])}):
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                _serve_one(cad, inputs[s], plans_r[s], 0.0, None)
            sync()
            seconds = (time.perf_counter() - t0) / reps
        results.append((s, by_server[s], seconds))

    with torch.no_grad():
        first = mine[0]
        _serve_one(cad, inputs[first], plans_r[first], 0.0, None)  # warm-up
        if group is None:
            for s in mine:
                timed(s)
            return results
        import torch.distributed as dist
        sync()
        for turn in range(d):
            dist.barrier(group=group)
            if turn == rank:
                timed(rank)
        dist.barrier(group=group)
    return results


# -------------------------------------------- ring baseline (DESIGN.md §13)
def _plan_task_q_block(cfg: CADConfig, plan_np, server: int,
                       slot: int) -> Optional[int]:
    """Global q-block index of task ``slot`` on ``server`` (None for a
    dead slot): the plan-array inverse ``iter_plan_tasks`` walks."""
    nb, cq = cfg.nb, cfg.cq
    if slot < nb:
        idx = int(plan_np["q_home_idx"][server, slot])
        return server * nb + idx if idx >= 0 else None
    src, c = divmod(slot - nb, cq)
    idx = int(plan_np["q_send_idx"][src, server, c])
    return src * nb + idx if idx >= 0 else None


def ring_pass_geometry(cfg: CADConfig, segment_ids: np.ndarray, plan, *,
                       n_passes: Optional[int] = None, mask=None) \
        -> List[Dict[str, Any]]:
    """Host-side ring pass construction (DESIGN.md §13): each task's kv
    prefix split into the P contiguous document shards of the
    DISTFLASHATTN schedule, one pseudo-plan per pass.  At pass ``t`` a
    task whose q block sits in shard ``i`` reads kv shard ``(i - t) % P``
    clipped to its causal prefix; causal-dead and mask-dead windows get
    ``kv_len`` 0.  Returns per pass the ``task_kv_start`` /
    ``task_kv_len`` ``[D, T]`` int32 arrays and ``jmax`` (0 marks a pass
    dead on every server)."""
    from repro_torch.core.scheduler import (layout_from_segments,
                                            ring_shard_size)
    docs, doc_of, bi_of = layout_from_segments(
        np.asarray(segment_ids).reshape(cfg.n_servers, -1), cfg.blk,
        cfg.n_servers)
    plan_np = _plan_numpy(plan)
    kv_start = plan_np["task_kv_start"]
    kv_len = plan_np["task_kv_len"]
    d, n_tasks = kv_len.shape
    P = int(n_passes) if n_passes else cfg.n_servers
    trivial = mask is None or mask.trivial
    lbm_cache: Dict[int, np.ndarray] = {}

    def lbm(n):
        if n not in lbm_cache:
            lbm_cache[n] = live_block_mask(mask, n, n, cfg.blk)
        return lbm_cache[n]

    starts = [kv_start.copy() for _ in range(P)]
    lens = [np.zeros_like(kv_len) for _ in range(P)]
    for s in range(d):
        for slot in range(n_tasks):
            if kv_len[s, slot] <= 0:
                continue
            g = _plan_task_q_block(cfg, plan_np, s, slot)
            bi = int(bi_of[g])
            n = docs[int(doc_of[g])].n_blocks
            L = ring_shard_size(n, P)
            i = bi // L
            row = None if trivial else lbm(n)[bi]
            for t in range(P):
                j = (i - t) % P
                lo, hi = j * L, min((j + 1) * L, bi + 1)
                if hi <= lo:
                    continue                      # causal-dead ring step
                if row is not None:
                    live = np.nonzero(row[lo:hi])[0]
                    if live.size == 0:
                        continue                  # mask-dead ring step
                    lo, hi = lo + int(live[0]), lo + int(live[-1]) + 1
                starts[t][s, slot] = kv_start[s, slot] + lo
                lens[t][s, slot] = hi - lo
    return [{"task_kv_start": starts[t], "task_kv_len": lens[t],
             "jmax": int(lens[t].max(initial=0))} for t in range(P)]


def _ring_serve_merge(cad: CADContext, inputs_s, pass_plans, server: int,
                      *, softcap: float = 0.0, scale=None):
    """ONE server's ring execution: each live pass's kv window served as a
    finalized ``(out, lse)`` partial (``ca_partial_attention``), folded
    in pass order with ``merge_softmax_partials``; dead windows merge as
    bitwise no-ops, passes dead on every server are not served."""
    q_tasks, qpos, k_buf, v_buf, kpos = (x.contiguous() for x in inputs_s)
    window, sink, rate = mask_params(cad.mask, 0)
    dev = q_tasks.device
    merged = None
    for t, pp in enumerate(pass_plans):
        if t > 0 and pp["jmax"] <= 0:
            continue                        # dead ring pass: skipped exactly
        o, lse = ca_partial_attention(
            q_tasks, k_buf, v_buf,
            torch.as_tensor(pp["task_kv_start"][server], dtype=torch.int32,
                            device=dev),
            torch.as_tensor(pp["task_kv_len"][server], dtype=torch.int32,
                            device=dev), qpos, kpos,
            jmax=max(pp["jmax"], 1), window=window, softcap=softcap,
            scale=scale, sink=sink, rate=rate)
        merged = (o, lse) if merged is None \
            else merge_softmax_partials(merged[0], merged[1], o, lse)
    return merged[0]


def ring_attention(cad: CADContext, plan, segment_ids: np.ndarray,
                   q, k, v, pos, *, n_passes: Optional[int] = None,
                   softcap: float = 0.0, scale=None, pass_plans=None):
    """Decomposed ring-attention execution of one step (DESIGN.md §13):
    the DISTFLASHATTN baseline through CAD's own dispatch.  Each server
    serves its batch one ring pass at a time, merging the per-pass
    ``(out, lse)`` partials, and the outputs are reassembled as the
    standard serve's.  Bitwise equal, forward and backward, to
    :func:`ring_global_sim`.  Arguments as ``build_server_inputs``;
    ``segment_ids`` the rank-major ``[D, T]`` layout the plan was built
    from."""
    cfg = cad.cfg
    if pass_plans is None:
        pass_plans = ring_pass_geometry(cfg, segment_ids, plan,
                                        n_passes=n_passes, mask=cad.mask)
    inputs, _ = build_server_inputs(cad, plan, q, k, v, pos)
    outs = {s: _ring_serve_merge(cad, inputs[s], pass_plans, s,
                                 softcap=softcap, scale=scale)
            for s in range(cfg.n_servers)}
    return assemble_step_outputs(cfg, plan, outs, q.shape, q.dtype)


def ring_global_sim(q, k, v, pos, plan, cad: CADContext,
                    segment_ids: np.ndarray, *,
                    n_passes: Optional[int] = None,
                    softcap: float = 0.0, scale=None, pass_plans=None):
    """Single-pool oracle of the ring schedule: the per-pass partial
    serves of :func:`ring_attention`, merged on the stacked ``[D, T,
    ...]`` partials of every server and scattered as :func:`_global_sim`
    scatters: the same operations in the same order, another
    orchestration."""
    cfg = cad.cfg
    d = cfg.n_servers
    if pass_plans is None:
        pass_plans = ring_pass_geometry(cfg, segment_ids, plan,
                                        n_passes=n_passes, mask=cad.mask)
    plan_t = _plan_tensors(plan, q.device)
    nb, tasks = _task_batches(q, k, v, pos, plan_t, cfg)
    servers = [tuple(x[s].contiguous() for x in tasks) for s in range(d)]
    window, sink, rate = mask_params(cad.mask, 0)
    merged = None
    for t, pp in enumerate(pass_plans):
        if t > 0 and pp["jmax"] <= 0:
            continue                        # dead ring pass: skipped exactly
        st = torch.as_tensor(pp["task_kv_start"], dtype=torch.int32,
                             device=q.device)
        ln = torch.as_tensor(pp["task_kv_len"], dtype=torch.int32,
                             device=q.device)
        parts = [ca_partial_attention(
            qt, kb, vb, st[s], ln[s], qp, kp, jmax=max(pp["jmax"], 1),
            window=window, softcap=softcap, scale=scale, sink=sink,
            rate=rate) for s, (qt, qp, kb, vb, kp) in enumerate(servers)]
        o = torch.stack([p[0] for p in parts])
        lse = torch.stack([p[1] for p in parts])
        merged = (o, lse) if merged is None \
            else merge_softmax_partials(merged[0], merged[1], o, lse)
    out_tasks = merged[0]
    ret_send = out_tasks[:, nb:].reshape((d, d, cfg.cq)
                                         + tuple(out_tasks.shape[2:]))
    out = _scatter_outputs(out_tasks, _sim_exchange(ret_send), plan_t, cfg,
                           nb, cfg.blk, q.shape[2], q.shape[3], q.dtype)
    return out.reshape(q.shape)


# ----------------------------------------------------- plan inspection
def iter_plan_tasks(cfg: CADConfig, plan, mask=None) \
        -> List[Tuple[int, int, int, int]]:
    """Host-side: the (server, task_slot, q_tokens, kv_tokens) list of
    every live CA task in a :class:`StepPlan`.  Every task is one q block
    against a (kv_len · blk)-token context.  With a non-trivial ``mask``
    ``kv_tokens`` is the task's *live* kv length (DESIGN.md §12)."""
    kv_len = plan["task_kv_len"]
    kv_len = kv_len.cpu().numpy() if torch.is_tensor(kv_len) \
        else np.asarray(kv_len)
    d, n_tasks = kv_len.shape
    out = []
    for s in range(d):
        for slot in range(n_tasks):
            kvl = int(kv_len[s, slot])
            if kvl > 0:
                out.append((s, slot, cfg.blk,
                            live_kv_len(mask, kvl, cfg.blk)))
    return out


# --------------------------------------------------------------- frontend
@marked("dispatch")
def cad_attention(q, k, v, seg_q, pos_q, seg_kv, pos_kv, *, ctx,
                  causal=True, window=0, softcap=0.0, scale=None,
                  mask=None):
    """Core-attention disaggregation entry point.

    Applies to causal full-attention layers (the quadratic-imbalance
    source).  Windowed and non-causal layers, and calls without a plan,
    fall back to ``xla_flash_attention``: their compute is linear in
    tokens, so they do not create the imbalance CAD exists to fix
    (DESIGN.md §5).  A non-trivial ``mask`` (sliding+sink or dilated
    :class:`~repro_torch.core.mask.MaskSpec`) is served through the plan
    path; it must match the spec the plan was built with (``cad.mask``,
    set by the session, when the call site passes none)."""
    cad: Optional[CADContext] = getattr(ctx, "cad", None)
    if cad is not None and mask is not None and cad.mask != mask:
        cad = dataclasses.replace(cad, mask=mask)
    spec = cad.mask if cad is not None else mask
    if cad is None or cad.plan is None or not causal or window:
        w, sink, rate = mask_params(spec, window)
        return xla_flash_attention(q, k, v, seg_q, pos_q, seg_kv, pos_kv,
                                   causal=causal, window=w, sink=sink,
                                   rate=rate,
                                   blk=cad.cfg.blk if cad else 128,
                                   softcap=softcap, scale=scale)
    # padding tokens -> position -1 so the server kernels mask them
    pos = torch.where(seg_q > 0, pos_q, -1).to(torch.int32)
    pingpong = cad.pingpong and isinstance(cad.plan, (tuple, list,
                                                      PingPongPlan))
    group = getattr(ctx, "group", None)
    if group is not None:
        # this rank's rows and plan row (the reference's P(bspec) inputs
        # and plan_[0]); never the single-process simulation
        rank = check_cad_group(cad, group)
        if pingpong:
            h = q.shape[0] // 2
            nanos = [tuple(x[:h] for x in (q, k, v, pos)),
                     tuple(x[h:] for x in (q, k, v, pos))]
            plans_r = [_plan_row(p, rank, q.device) for p in cad.plan]
            return torch.cat(_pingpong_ranks(nanos, plans_r, cad, softcap,
                                             scale, group), dim=0)
        plan = cad.plan[0] if isinstance(cad.plan, (tuple, list,
                                                    PingPongPlan)) \
            else cad.plan
        return _rank_fn(q, k, v, pos, _plan_row(plan, rank, q.device), cad,
                        softcap, scale, group)

    def run(qq, kk, vv, pp, plan):
        return _global_sim(qq, kk, vv, pp, plan, cad, softcap, scale)

    if pingpong:
        # nano-batch split within each rank's rows (rank-major layout);
        # in one process the two halves run one after the other
        d = cad.cfg.n_servers
        b = q.shape[0]
        rpr = b // d
        h = rpr // 2

        def nano(x, i):
            xs = x.reshape((d, rpr) + tuple(x.shape[1:]))
            sel = xs[:, :h] if i == 0 else xs[:, h:]
            return sel.reshape((d * h,) + tuple(x.shape[1:]))

        out0 = run(nano(q, 0), nano(k, 0), nano(v, 0), nano(pos, 0),
                   cad.plan[0])
        out1 = run(nano(q, 1), nano(k, 1), nano(v, 1), nano(pos, 1),
                   cad.plan[1])
        o = torch.stack([out0.reshape((d, h) + tuple(q.shape[1:])),
                         out1.reshape((d, h) + tuple(q.shape[1:]))], dim=1)
        return o.reshape(q.shape)
    plan = cad.plan[0] if isinstance(cad.plan, (tuple, list, PingPongPlan)) \
        else cad.plan
    return run(q, k, v, pos, plan)
