"""`CADSession` — the single entry point for core-attention
disaggregation.

The port of ``repro.cad.session``.  A session owns the pool geometry
(:class:`CADConfig`), the ping-pong flag, the scheduler tolerance and the
plan policy.  From one session you derive:

  session.context()              the ParallelContext the model runs with
  session.plan(segs)             one step's StepPlan (or PingPongPlan)
  session.attach_plans(batches)  a batch stream with plans attached,
                                 planned asynchronously one step ahead
                                 (the paper's scheduler prefetch)

Construction::

  session = CADSession.for_pipeline(model_cfg, pipe_cfg,
                                    plan_policy="balanced",
                                    server_speeds=(1.0, 0.5))
  ctx = session.context()
  for batch in session.attach_plans(raw_batches(pipe_cfg)):
      opt_state, metrics = step(opt_state, batch)

``for_pipeline`` never mutates the pipeline config.  Runtime calibration
(``calibrate=True``, ``observe_probe``) needs ``probe_plan_times`` and
chunked KV streaming (``stream_chunk > 0``) needs the streamed dispatch,
both ROADMAP queue 1 item 7; an elastic pool (``with_pool``) needs the
runtime, queue 1 item 8.  Each raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np

from repro_torch.cad.planner import get_planner
from repro_torch.cad.prefetch import PlanPrefetcher
from repro_torch.core.cost_model import CommModel
from repro_torch.core.dispatch import CADContext
from repro_torch.core.mask import MaskSpec, parse_mask, validate_mask_layout
from repro_torch.core.plan import CADConfig, PingPongPlan, StepPlan
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel import ParallelContext

Plan = Union[StepPlan, PingPongPlan]

CALIBRATION = "runtime calibration (probe_plan_times) comes with ROADMAP " \
    "queue 1 item 7"
STREAMING = "chunked KV streaming (stream_task_batch) comes with ROADMAP " \
    "queue 1 item 7"
ELASTIC = "the elastic server pool (runtime/) comes with ROADMAP queue 1 " \
    "item 8"


@dataclasses.dataclass(frozen=True)
class CADSession:
    """Immutable description of the attention service for one run."""
    cfg: CADConfig
    pingpong: bool = False
    tolerance: float = 0.1
    plan_policy: str = "balanced"  # registry name: identity | per_doc_cp
                                   # | balanced | ring (DESIGN.md §13)
    jmax: int = 0                  # max kv blocks per task (0 -> cfg.nkv)
    comm: Optional[CommModel] = None
    prefetch: int = 2              # plan look-ahead depth; 0 = synchronous
    mask: Optional[MaskSpec] = None   # task shape beyond dense causal
                                      # (DESIGN.md §12); None = causal

    # ------------------------------------------------------- constructors
    @classmethod
    def for_pipeline(cls, model_cfg, pipe_cfg, *, pingpong: bool = False,
                     tolerance: float = 0.1, plan_policy: str = "balanced",
                     prefetch: int = 2, server_speeds=None,
                     server_hbm=None, stream_chunk: int = 0,
                     calibrate: bool = False,
                     mask: Union[MaskSpec, str, None] = None) \
            -> "CADSession":
        """Size the attention-server pool for a training pipeline.

        ``pipe_cfg`` needs ``n_ranks``, ``global_batch``, ``seq_len`` and
        ``max_doc_len``; it is read, never mutated.  ``server_speeds``
        declares known pool heterogeneity (a 0.5 entry = half-speed
        server); ``server_hbm`` per-endpoint HBM budgets in bytes
        (DESIGN.md §11); ``mask`` the step's task shape beyond dense
        causal (a :class:`~repro_torch.core.mask.MaskSpec` or a
        ``--mask`` flag string, DESIGN.md §12)."""
        if calibrate:
            raise NotImplementedError(CALIBRATION)
        if stream_chunk:
            raise NotImplementedError(STREAMING)
        n = pipe_cfg.n_ranks
        rows_per_rank = pipe_cfg.global_batch // n
        tokens_per_rank = rows_per_rank * pipe_cfg.seq_len
        if pingpong:
            if rows_per_rank % 2:
                raise ValueError("ping-pong needs an even number of rows "
                                 f"per rank, got {rows_per_rank}")
            tokens_per_rank //= 2          # pool sized per nano-batch
        cadcfg = CADConfig.default(n, tokens_per_rank,
                                   max_doc_tokens=pipe_cfg.max_doc_len,
                                   server_speeds=server_speeds,
                                   server_hbm=server_hbm)
        comm = CommModel(n_heads=getattr(model_cfg, "n_heads", 1) or 1,
                         head_dim=getattr(model_cfg, "head_dim", 1) or 1,
                         n_kv_heads=getattr(model_cfg, "n_kv_heads", 1)
                         or 1)
        jmax = max(1, pipe_cfg.max_doc_len // cadcfg.blk)
        if isinstance(mask, str):
            mask = parse_mask(mask)
        if mask is not None and mask.trivial:
            mask = None
        return cls(cfg=cadcfg, pingpong=pingpong, tolerance=tolerance,
                   plan_policy=plan_policy, jmax=jmax, comm=comm,
                   prefetch=prefetch, mask=mask)

    # ------------------------------------------------------------ context
    def context(self, *, remat: bool = True) -> ParallelContext:
        """The ParallelContext the model runs with.  Plans are bound per
        step by the train step (``CADContext.bind_plan``)."""
        cad = CADContext(cfg=self.cfg, jmax=self.jmax,
                         pingpong=self.pingpong, mask=self.mask)
        return ParallelContext(attn_impl="cad", cad=cad, remat=remat,
                               pingpong=self.pingpong)

    def with_pool(self, pool) -> "CADSession":
        raise NotImplementedError(ELASTIC)

    def observe_probe(self, plan, *, repeats: int = 1,
                      seed: int = 0) -> None:
        raise NotImplementedError(CALIBRATION)

    # ----------------------------------------------------------- planning
    def plan(self, segment_ids: np.ndarray) \
            -> Tuple[Plan, Dict[str, float]]:
        """Plan one step.  ``segment_ids`` is the rank-major [D, T] packed
        layout (T = tokens per rank; 2·nb·blk when ping-pong is on).
        Narrated to the observability layer (DESIGN.md §14): a
        ``plan.build`` span on the ``planner`` track and the plan-quality
        gauge — both no-ops unless tracing is enabled / read."""
        with obs_trace.get_recorder().span("plan.build", "planner",
                                           args={"policy":
                                                 self.plan_policy}):
            plan, stats = self._plan_impl(segment_ids)
        obs_metrics.get_registry().gauge(
            "cad_plan_load_max_over_mean",
            "planned per-server load max/mean").set(
            stats.get("load_max_over_mean", 0.0))
        return plan, stats

    def _plan_impl(self, segment_ids: np.ndarray) \
            -> Tuple[Plan, Dict[str, float]]:
        segs = np.asarray(segment_ids)
        planner = get_planner(self.plan_policy)
        kw: Dict[str, Any] = {}
        if self.mask is not None:
            # fail at planning time with the offending segment/task
            # named (MaskSpecError), not as a shape error in a kernel
            validate_mask_layout(self.mask, segs, self.cfg.blk)
            kw["mask"] = self.mask
        if not self.pingpong:
            res = planner(self.cfg, segs, comm=self.comm,
                          tolerance=self.tolerance, **kw)
            return res.plan, dict(res.stats)
        half = segs.shape[1] // 2
        if half % self.cfg.blk:
            raise ValueError(
                f"ping-pong nano-batch of {half} tokens is not a "
                f"multiple of blk={self.cfg.blk}")
        # a cfg sized for the full step is re-sized to the nano-batch
        cfg = self.cfg if half == self.cfg.nb * self.cfg.blk \
            else dataclasses.replace(self.cfg, nb=half // self.cfg.blk)
        halves = []
        stats: Dict[str, float] = {"comm_bytes": 0.0, "n_moves": 0,
                                   "load_max_over_mean": 0.0}
        for i in range(2):
            res = planner(cfg, segs[:, i * half:(i + 1) * half],
                          comm=self.comm, tolerance=self.tolerance, **kw)
            halves.append(res.plan)
            stats["comm_bytes"] += res.stats["comm_bytes"]
            stats["n_moves"] += res.stats["n_moves"]
            stats["load_max_over_mean"] = max(
                stats["load_max_over_mean"],
                res.stats["load_max_over_mean"])
        return PingPongPlan(*halves), stats

    def plan_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Attach ``plan`` + ``schedule_stats`` to one pipeline batch
        (rows are rank-major: rank r owns rows [r·rpr, (r+1)·rpr))."""
        segs = np.asarray(batch["segment_ids"])
        if self.pingpong:
            rpr = segs.shape[0] // self.cfg.n_servers
            if rpr % 2:
                raise ValueError("ping-pong needs an even number of rows "
                                 f"per rank, got {rpr}")
        plan, stats = self.plan(segs.reshape(self.cfg.n_servers, -1))
        out = dict(batch)
        out["plan"] = plan
        out["schedule_stats"] = stats
        return out

    def attach_plans(self, batch_iter: Iterable[Dict[str, Any]], *,
                     prefetch: Optional[int] = None) \
            -> Iterator[Dict[str, Any]]:
        """Yield batches with plans attached.  With ``prefetch >= 1`` a
        background worker plans batch *i+1* while the caller's device
        computes batch *i* (bounded queue, order-preserving); with
        ``prefetch=0`` planning happens inline."""
        depth = self.prefetch if prefetch is None else prefetch
        if depth <= 0:
            for batch in batch_iter:
                yield self.plan_batch(batch)
            return
        pf = PlanPrefetcher(batch_iter, self.plan_batch, depth=depth)
        try:
            yield from pf
        finally:
            pf.close()
