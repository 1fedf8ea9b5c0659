"""CAD runtime: dispatch CA-tasks to the attention-server pool.

The port of ``repro.core.dispatch``'s single-process path.  Dataflow per
transformer layer (paper §4.1, Figure 2):

  local q/k/v blocks --gather--> per-destination send buffers
      --exchange--> attention servers
      --fused CA kernel over each server's task batch--> outputs
      --exchange (transposed)--> home ranks --scatter--> local layout

``_global_sim`` runs every rank in one process: the reference's ``vmap``
over ranks is a leading ``[D]`` axis written out, and the exchange is a
transpose of ``[D_src, D_dst, ...]`` buffers.  Each server's batch is one
``ca_server_attention`` call (the CUDA kernels on CUDA tensors, their
plain versions on CPU tensors).  Everything around the kernels is
gather, concatenation and scatter, so autograd mirrors the communication
in the backward (the paper's "backward reuses the schedule").

The reference's ``shard_map`` path over a device mesh (``_rank_fn``) waits
for NCCL ranks (ROADMAP queue 1 item 4); windowed and non-causal layers,
which the reference sends to ``xla_flash_attention``, wait for queue 1
item 3.  Both raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.mask import live_kv_len, mask_params
from repro_torch.core.plan import CADConfig, PingPongPlan
from repro_torch.kernels.packed_flash.ops import ca_server_attention


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


def _gather_blocks(xb, idx, fill=0.0):
    """xb [D, NB, ...]; idx [D, ...] with -1 padding -> [D, ..., ...],
    each rank gathering from its own blocks; pad rows = ``fill``."""
    d = xb.shape[0]
    safe = idx.long().clamp(min=0)
    ranks = torch.arange(d, device=xb.device).reshape(
        (d,) + (1,) * (idx.dim() - 1))
    out = xb[ranks, safe]
    mask = (idx >= 0).reshape(tuple(idx.shape) + (1,) * (xb.dim() - 2))
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


def _server_calls(q_tasks, qpos_tasks, k_buf, v_buf, kpos_buf, plan, cad,
                  window=0):
    """Each server's fused batch (inputs with the leading [D] axis) as
    ``ca_server_attention`` keyword arguments, one dict per server,
    without ``softcap`` and ``scale``."""
    jmax = cad.jmax or cad.cfg.nkv
    window, sink, rate = mask_params(cad.mask, window)
    return [dict(q_tasks=q_tasks[s].contiguous(),
                 k_buf=k_buf[s].contiguous(), v_buf=v_buf[s].contiguous(),
                 kv_start=plan["task_kv_start"][s].contiguous(),
                 kv_len=plan["task_kv_len"][s].contiguous(),
                 q_pos=qpos_tasks[s].contiguous(),
                 kv_pos=kpos_buf[s].contiguous(), jmax=jmax, window=window,
                 sink=sink, rate=rate)
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


def server_batches(q, k, v, pos, plan, cad):
    """The per-server fused CA-task batches ``_global_sim`` hands the
    kernels, as ``ca_server_attention`` keyword arguments (one dict per
    server): what a test or ``chip_smoke.py`` holds the kernels against
    at the main path's shapes."""
    _, tasks = _task_batches(q, k, v, pos, plan, cad.cfg)
    return _server_calls(*tasks, plan, cad)


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
def cad_attention(q, k, v, seg_q, pos_q, seg_kv, pos_kv, *, ctx,
                  causal=True, window=0, softcap=0.0, scale=None,
                  mask=None):
    """Core-attention disaggregation entry point, for causal full-attention
    layers (the quadratic-imbalance source).  A non-trivial ``mask``
    (sliding+sink or dilated :class:`~repro_torch.core.mask.MaskSpec`) is
    served through the plan path; it must match the spec the plan was
    built with (``cad.mask``, set by the session, when the call site
    passes none).  Windowed and non-causal layers, and calls without a
    plan, go to ``xla_flash_attention`` in the reference: not ported yet
    (ROADMAP queue 1 item 3)."""
    cad: Optional[CADContext] = getattr(ctx, "cad", None)
    if cad is not None and mask is not None and cad.mask != mask:
        cad = dataclasses.replace(cad, mask=mask)
    if cad is None or cad.plan is None or not causal or window:
        raise NotImplementedError(
            "cad_attention without a plan, or for a windowed / non-causal "
            "layer, falls back to xla_flash_attention, which comes with "
            "ROADMAP queue 1 item 3")
    # padding tokens -> position -1 so the server kernels mask them
    pos = torch.where(seg_q > 0, pos_q, -1).to(torch.int32)

    def run(qq, kk, vv, pp, plan):
        return _global_sim(qq, kk, vv, pp, plan, cad, softcap, scale)

    if cad.pingpong and isinstance(cad.plan, (tuple, list, PingPongPlan)):
        # nano-batch split within each rank's rows (rank-major layout);
        # on one card the two halves run one after the other — overlapping
        # one half's exchange with the other's serve needs NCCL ranks and
        # streams (ROADMAP queue 1 item 4)
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
