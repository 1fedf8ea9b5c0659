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
  session.observe*(...)          measured CA-task timings fed back into
                                 the runtime calibrator, so batch i+1
                                 is planned from batch i's costs

Construction::

  session = CADSession.for_pipeline(model_cfg, pipe_cfg,
                                    plan_policy="balanced",
                                    server_speeds=(1.0, 0.5),
                                    calibrate=True)
  ctx = session.context()
  for batch in session.attach_plans(raw_batches(pipe_cfg)):
      opt_state, metrics = step(opt_state, batch)
      session.observe_probe(batch["plan"], dtype=torch.bfloat16)

``for_pipeline`` never mutates the pipeline config.  ``with_pool``
attaches an elastic :class:`~repro_torch.runtime.ServerPool`
(DESIGN.md §9).

Across ranks (``for_pipeline(..., group=g)``, one rank per attention
server): every rank reads the same seeded global batch and runs the same
host planner on its global segment ids; ``plan_batch`` returns this
rank's rows with the global plan, and ``attach_plans`` holds the ranks
to one plan (a digest of its arrays, gathered across the group, at every
plan).  So every rank must plan from the same calibration snapshot and
pool epoch: each rank probes its own server and the triples are gathered
(``observe_probe``), so every rank's calibrator takes the same
observations in the same order; the trainer applies the fault schedule's
membership events on every rank at the same step; and a prefetched plan
whose calibration version is not the current one is re-planned at pull
(``_plan_stale``).

On a ``("data", "model")`` grid (``for_pipeline(..., grid=g)``) the CAD
group is the model index's data ranks, and every model index plans the
same steps: the model index 0 ranks time their servers and gather the
timings over their data group, and the gathered list is broadcast over
each data index's model group (``_gathered``), so all ``data x model``
calibrators take the same observations in the same order.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np

import torch
import torch.distributed as dist

from repro_torch.cad.planner import get_planner
from repro_torch.cad.prefetch import PlanPrefetcher
from repro_torch.data.pipeline import global_token_count, rank_rows
from repro_torch.core.cost_model import (CalibrationSnapshot, CommModel,
                                         CostModel, GridCalibrator)
from repro_torch.core.dispatch import (CADContext, iter_plan_tasks,
                                       probe_plan_times)
from repro_torch.core.mask import MaskSpec, parse_mask, validate_mask_layout
from repro_torch.core.plan import CADConfig, PingPongPlan, StepPlan
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel import ParallelContext

Plan = Union[StepPlan, PingPongPlan]


@dataclasses.dataclass(frozen=True)
class CADSession:
    """Immutable description of the attention service for one run.

    ``calibrator`` (optional) owns the runtime measure → fit → replan
    loop: every ``plan()`` call consumes one calibration snapshot (cost
    model + per-server speeds) and records its version in the schedule
    stats; ``observe*`` feeds measured timings back.  The calibrator is
    mutable shared state, the one exception to the session's
    immutability."""
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
    calibrator: Optional[GridCalibrator] = None
    recalib_threshold: float = 0.05   # speed drift that re-plans a
                                      # prefetched (stale) plan at pull
    pool: Any = None               # ServerPool: elastic membership; like
                                   # the calibrator, mutable shared state
    group: Any = None              # the CAD process group (one rank per
                                   # server), None = one process
    grid: Any = None               # launch.mesh.GridInfo: group is its
                                   # "data" sub-group
    rules: Any = None              # the grid's ShardingRules

    # ------------------------------------------------------- constructors
    @classmethod
    def for_pipeline(cls, model_cfg, pipe_cfg, *, pingpong: bool = False,
                     tolerance: float = 0.1, plan_policy: str = "balanced",
                     prefetch: int = 2, server_speeds=None,
                     server_hbm=None, stream_chunk: int = 0,
                     calibrate: bool = False, calib_ema: float = 0.5,
                     mask: Union[MaskSpec, str, None] = None,
                     group=None, grid=None) -> "CADSession":
        """Size the attention-server pool for a training pipeline.

        ``pipe_cfg`` needs ``n_ranks``, ``global_batch``, ``seq_len`` and
        ``max_doc_len``; it is read, never mutated.  ``server_speeds``
        declares known pool heterogeneity (a 0.5 entry = half-speed
        server); ``calibrate=True`` attaches a :class:`GridCalibrator`
        (the analytic model and the declared speeds as its prior) that
        measured timings refine.  ``server_hbm`` declares per-endpoint
        HBM budgets in bytes (DESIGN.md §11), and ``stream_chunk`` (kv
        blocks) lets the dispatch serve a task whose kv prefix exceeds
        every budget by streaming it.  ``mask`` is the step's task shape
        beyond dense causal (a :class:`~repro_torch.core.mask.MaskSpec`
        or a ``--mask`` flag string, DESIGN.md §12).  ``group`` (a
        ``torch.distributed`` process group) runs the servers as the
        group's ranks: its size must be ``pipe_cfg.n_ranks``.  ``grid`` (a
        :class:`~repro_torch.launch.mesh.GridInfo`) runs them as its
        ``"data"`` sub-group, the CAD axis, and gives the context the
        ``"model"`` sub-group and the sharding rules; every rank of the
        grid plans the same global batch and the plans are held equal
        over all of them."""
        n = pipe_cfg.n_ranks
        rules = None
        if grid is not None:
            from repro_torch.parallel import make_rules
            group = grid.data_group
            rules = make_rules(grid.sizes, model_cfg)
        if group is not None:
            if dist.get_world_size(group) != n:
                raise ValueError(f"the CAD group has "
                                 f"{dist.get_world_size(group)} ranks, "
                                 f"the pipeline {n}")
            # streaming shapes the plans alone here: the rank path serves
            # every task unstreamed, as the reference's shard_map body
            # (``_rank_fn``) and the port's ``_global_sim`` do
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
                                   server_hbm=server_hbm,
                                   stream_chunk=stream_chunk)
        n_heads = getattr(model_cfg, "n_heads", 1) or 1
        head_dim = getattr(model_cfg, "head_dim", 1) or 1
        comm = CommModel(n_heads=n_heads, head_dim=head_dim,
                         n_kv_heads=getattr(model_cfg, "n_kv_heads", 1)
                         or 1)
        calibrator = None
        if calibrate:
            calibrator = GridCalibrator(
                CostModel.analytic(n_heads, head_dim), n, ema=calib_ema,
                prior_speeds=cadcfg.speeds())
        jmax = max(1, pipe_cfg.max_doc_len // cadcfg.blk)
        if isinstance(mask, str):
            mask = parse_mask(mask)
        if mask is not None and mask.trivial:
            mask = None
        return cls(cfg=cadcfg, pingpong=pingpong, tolerance=tolerance,
                   plan_policy=plan_policy, jmax=jmax, comm=comm,
                   prefetch=prefetch, mask=mask, calibrator=calibrator,
                   group=group, grid=grid, rules=rules)

    # ------------------------------------------------------------ context
    def context(self, *, remat: bool = True) -> ParallelContext:
        """The ParallelContext the model runs with.  Plans are bound per
        step by the train step (``CADContext.bind_plan``)."""
        cad = CADContext(cfg=self.cfg, jmax=self.jmax,
                         pingpong=self.pingpong, mask=self.mask)
        if self.grid is not None:
            return ParallelContext(
                attn_impl="cad", cad=cad, remat=remat, group=self.group,
                model_group=self.grid.model_group, rules=self.rules)
        return ParallelContext(attn_impl="cad", cad=cad, remat=remat,
                               group=self.group)

    # --------------------------------------------------------- elasticity
    def with_pool(self, pool) -> "CADSession":
        """Attach a :class:`repro_torch.runtime.ServerPool`: planning then
        runs against the pool's surviving members only, every plan's
        stats record the membership epoch it was built from, and
        prefetched plans from a superseded epoch are re-planned at pull
        (DESIGN.md §9)."""
        if pool is not None and pool.n_slots != self.cfg.n_servers:
            raise ValueError(
                f"pool has {pool.n_slots} slots, session pool geometry "
                f"is {self.cfg.n_servers} servers")
        return dataclasses.replace(self, pool=pool)

    def _pool_view(self):
        return None if self.pool is None else self.pool.view()

    # ------------------------------------------------------- calibration
    def _snapshot(self) -> Optional[CalibrationSnapshot]:
        return None if self.calibrator is None \
            else self.calibrator.snapshot()

    def admission_view(self) -> Tuple[CalibrationSnapshot, Optional[Any]]:
        """One (calibration snapshot, pool view) pair: the pricing basis
        of one admission round.  Without a calibrator the snapshot wraps
        the analytic model and the declared speeds at version -1; without
        a pool the view is None."""
        snap = self._snapshot()
        if snap is None:
            comm = self.comm
            cm = CostModel.analytic(comm.n_heads if comm else 1,
                                    comm.head_dim if comm else 8)
            snap = CalibrationSnapshot(
                version=-1, cost_model=cm,
                speeds=tuple(float(s) for s in self.cfg.speeds()))
        return snap, self._pool_view()

    def snapshot_provider(self):
        """A ``() -> CalibrationSnapshot`` callable (the serve scheduler's
        ``SchedulerConfig.snapshot_provider``): admission then prices
        from the snapshot the planner plans from."""
        return lambda: self.admission_view()[0]

    def _planner_kwargs(self, snap: Optional[CalibrationSnapshot]) \
            -> Dict[str, Any]:
        if snap is None:
            return {}
        return {"cost_model": snap.cost_model,
                "speeds": snap.speeds_array()}

    def _annotate(self, stats: Dict[str, float],
                  snap: Optional[CalibrationSnapshot],
                  view=None) -> Dict[str, float]:
        if snap is not None:
            stats["calib_version"] = float(snap.version)
            for s, sp in enumerate(snap.speeds):
                stats[f"calib_speed_{s}"] = float(sp)
        if view is not None:
            stats["pool_epoch"] = float(view.epoch)
            stats["pool_active"] = float(len(view.active))
        return stats

    def _plan_stale(self, batch: Dict[str, Any]) -> bool:
        """True when a prefetched batch's plan was built from a superseded
        pool epoch, or from speeds that have since drifted beyond
        ``recalib_threshold``: checked (and re-planned) on the consumer
        thread at pull time.  Under a group any other calibration version
        is stale: which snapshot the worker read depends on thread timing,
        which differs between ranks, while the version at pull is the same
        on every rank (each made the same ``observe`` calls), so a pulled
        plan is the one ``prefetch=0`` builds."""
        st = batch.get("schedule_stats") or {}
        view = self._pool_view()
        if view is not None \
                and int(st.get("pool_epoch", -1)) != view.epoch:
            return True
        snap = self._snapshot()
        if snap is None or "calib_version" not in st:
            return False
        if int(st["calib_version"]) == snap.version:
            return False
        if self.group is not None:
            return True
        drift = max(abs(st.get(f"calib_speed_{s}", 1.0) - snap.speeds[s])
                    for s in range(self.cfg.n_servers))
        return drift > self.recalib_threshold

    def _gathered(self, mine: list) -> list:
        """Under a group: every rank's ``mine`` concatenated in rank
        order (a collective, on the thread that runs the step).  On a
        grid, the model index 0 data group's list on every rank: theirs
        gathered, then broadcast over each model group (the other model
        indices' ``mine`` is not read)."""
        if self.group is None:
            return mine
        got = [None] * dist.get_world_size(self.group)
        if self._probing():
            dist.all_gather_object(got, mine, group=self.group)
        if self.grid is not None:
            mg = self.grid.model_group
            dist.broadcast_object_list(got, dist.get_global_rank(mg, 0),
                                       group=mg)
        return [x for part in got for x in part]

    def _probing(self) -> bool:
        """Whether this rank times probes: all but a grid's model index
        above 0, whose data index's model index 0 rank times its
        server."""
        return self.grid is None or self.grid.model_index == 0

    def observe(self, q_tokens: int, kv_tokens: int, seconds: float,
                server: Optional[int] = None) -> None:
        """Feed one measured CA-task timing into the calibrator.  Under a
        group it raises: one rank's timing of one task reaches no other
        rank's calibrator (``observe_server``, ``observe_plan`` and
        ``observe_probe`` gather)."""
        if self.group is not None and self.calibrator is not None:
            raise RuntimeError(
                "CADSession.observe under a CAD group would feed one "
                "rank's calibrator alone; use observe_server, "
                "observe_plan or observe_probe, which gather the ranks' "
                "timings")
        if self.calibrator is not None:
            self.calibrator.observe(q_tokens, kv_tokens, seconds,
                                    server=server)

    def observe_server(self, server: int, tasks, seconds: float) -> None:
        """Feed one per-server fused-batch timing (``tasks`` is the
        server's [(q_tokens, kv_tokens), ...] composition).  Under a group
        it is a collective: each rank passes the timing it measured, and
        every rank feeds all of them in rank order."""
        if self.calibrator is None:
            return
        for s, t, sec in self._gathered([(server, list(tasks),
                                          float(seconds))]):
            self.calibrator.observe_tasks(t, sec, server=s)

    def observe_plan(self, plan, per_server_seconds) -> None:
        """Feed measured per-server serve times for one executed plan;
        task shapes come from the plan's arrays.  A ping-pong step's
        timing covers both halves, so a :class:`PingPongPlan` contributes
        the tasks of both.  Under a group it is a collective: each rank
        passes the per-server times it measured (its own server's, as a
        dict), and every rank feeds all of them in rank order."""
        if self.calibrator is None:
            return
        halves = list(plan) if isinstance(plan, (tuple, list,
                                                 PingPongPlan)) \
            else [plan]
        by_server: Dict[int, list] = {}
        for p in halves:
            # masked tasks key the calibrator by live kv tokens, the unit
            # the planners price them in (DESIGN.md §12)
            for s, _slot, qt, kvt in iter_plan_tasks(self.cfg, p,
                                                     mask=self.mask):
                by_server.setdefault(s, []).append((qt, kvt))
        if not isinstance(per_server_seconds, dict):
            per_server_seconds = dict(enumerate(per_server_seconds))
        for s, seconds in self._gathered(
                [(int(s), float(t)) for s, t in per_server_seconds.items()]):
            if s in by_server:
                self.calibrator.observe_tasks(by_server[s], float(seconds),
                                              server=s)

    def observe_probe(self, plan, *, repeats: int = 1, seed: int = 0,
                      dtype=torch.float32, device="cuda") -> None:
        """Measure each server's serve time for ``plan`` with the seeded
        probe (``core.dispatch.probe_plan_times``) on ``device`` in
        ``dtype`` and feed the timings back: the trainer's
        ``calibrate_every`` hook, which passes the model's compute dtype
        and device (the card's bf16 and f32 kernels differ several-fold
        in speed, so the probe times the one training runs).
        Ping-pong plans probe both nano-batch halves.  Under a group it is
        a collective: each rank times its own server's batch in its turn,
        the ranks' triples are gathered (on this thread, never the
        prefetch worker), and every rank feeds all of them in server
        order, so every rank's calibrator holds the same state.  On a
        grid the probe keeps the reference's shape (the ``CommModel``'s
        full heads) and the model index 0 ranks alone run it
        (``_gathered`` hands every rank their triples)."""
        if self.calibrator is None:
            return
        comm = self.comm or CommModel(1, 1, 1)
        plans = list(plan) if isinstance(plan, (tuple, list, PingPongPlan)) \
            else [plan]
        for i, p in enumerate(plans):
            # ping-pong halves may have been planned with a nano-batch
            # re-sized config; recover the geometry from the arrays
            nb = int(p["q_home_idx"].shape[1])
            cfg = self.cfg if nb == self.cfg.nb \
                else dataclasses.replace(self.cfg, nb=nb)
            cad = CADContext(cfg=cfg, jmax=self.jmax, mask=self.mask)
            label = "probe" if len(plans) == 1 else f"probe/half{i}"
            mine = probe_plan_times(
                cad, p, n_heads=comm.n_heads, head_dim=comm.head_dim,
                n_kv_heads=comm.n_kv_heads, dtype=dtype, seed=seed,
                repeats=repeats, trace_label=label, device=device,
                group=self.group) if self._probing() else []
            for s, tasks, seconds in self._gathered(mine):
                self.calibrator.observe_tasks(tasks, seconds, server=s)

    # ----------------------------------------------------------- planning
    def plan(self, segment_ids: np.ndarray, *,
             step: Optional[int] = None) -> Tuple[Plan, Dict[str, float]]:
        """Plan one step.  ``segment_ids`` is the rank-major [D, T] packed
        layout (T = tokens per rank; 2·nb·blk when ping-pong is on).
        With a calibrator attached, the whole step (both ping-pong
        halves) plans from ONE calibration snapshot, recorded in the
        stats as ``calib_version`` with the per-server speeds used.
        Narrated to the observability layer (DESIGN.md §14): a
        ``plan.build`` span on the ``planner`` track (``step``: the
        batch's index in the stream), whose args carry the plan's
        ``load_max_over_mean`` and the scheduler's ``imbalance``,
        ``n_moves`` and ``comm_bytes``, and the plan-quality gauges —
        no-ops unless tracing is enabled / read."""
        args = {"policy": self.plan_policy}
        with obs_trace.get_recorder().span("plan.build", "planner",
                                           step=step, args=args):
            plan, stats = self._plan_impl(segment_ids)
            args.update(
                load_max_over_mean=stats["load_max_over_mean"],
                imbalance=stats["load_max_over_mean"] - 1.0,
                n_moves=stats["n_moves"], comm_bytes=stats["comm_bytes"])
        reg = obs_metrics.get_registry()
        reg.gauge("cad_plan_load_max_over_mean",
                  "planned per-server load max/mean").set(
            stats.get("load_max_over_mean", 0.0))
        if "calib_version" in stats:
            reg.gauge("cad_calib_version",
                      "calibration snapshot version planned from").set(
                stats["calib_version"])
        if "pool_epoch" in stats:
            reg.gauge("cad_pool_epoch", "pool membership epoch").set(
                stats["pool_epoch"])
        return plan, stats

    def _plan_impl(self, segment_ids: np.ndarray) \
            -> Tuple[Plan, Dict[str, float]]:
        segs = np.asarray(segment_ids)
        planner = get_planner(self.plan_policy)
        if self.mask is not None:
            # fail at planning time with the offending segment/task
            # named (MaskSpecError), not as a shape error in a kernel
            validate_mask_layout(self.mask, segs, self.cfg.blk)
        snap = self._snapshot()
        view = self._pool_view()
        kw = self._planner_kwargs(snap)
        if self.mask is not None:
            kw["mask"] = self.mask
        if view is not None:
            # ONE membership view per step: both ping-pong halves plan
            # against the same surviving-endpoint set, and the epoch is
            # recorded so prefetched plans invalidate on change
            kw["exclude"] = view.excluded
        if not self.pingpong:
            res = planner(self.cfg, segs, comm=self.comm,
                          tolerance=self.tolerance, **kw)
            return res.plan, self._annotate(dict(res.stats), snap, view)
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
        return PingPongPlan(*halves), self._annotate(stats, snap, view)

    def plan_batch(self, batch: Dict[str, Any], *,
                   step: Optional[int] = None) -> Dict[str, Any]:
        """Attach ``plan`` + ``schedule_stats`` to one pipeline batch
        (rows are rank-major: rank r owns rows [r·rpr, (r+1)·rpr));
        ``step`` is the batch's index in the stream, for the trace.
        Under a group the global batch is planned and this rank's rows
        are returned with the global plan, the batch's global count of
        loss tokens (``n_tokens_global``) and the plan's digest
        (``plan_digest``; ``check_plan_agreement`` compares it across
        the group).  Host work only: it may run on the prefetch worker."""
        segs = np.asarray(batch["segment_ids"])
        if self.pingpong:
            rpr = segs.shape[0] // self.cfg.n_servers
            if rpr % 2:
                raise ValueError("ping-pong needs an even number of rows "
                                 f"per rank, got {rpr}")
        plan, stats = self.plan(segs.reshape(self.cfg.n_servers, -1),
                                step=step)
        out = dict(batch)
        if self.group is not None:
            out = rank_rows(batch, dist.get_rank(self.group),
                            self.cfg.n_servers)
            out["n_tokens_global"] = global_token_count(batch)
            out["plan_digest"] = plan_digest(plan)
        out["plan"] = plan
        out["schedule_stats"] = stats
        return out

    def check_plan_agreement(self, batch: Dict[str, Any]) -> None:
        """Under a group: gather every rank's ``plan_digest`` and raise
        unless all are equal (the ranks planned different batches, and
        their exchanges would not match); on a grid over all of its ranks,
        each model index's data ranks being a CAD group of its own.  A
        collective: call it on the thread that runs the step, never on the
        prefetch worker."""
        if self.group is None:
            return
        group = None if self.grid is not None else self.group
        got = [None] * dist.get_world_size(group)
        dist.all_gather_object(got, batch["plan_digest"], group=group)
        if len(set(got)) != 1:
            raise RuntimeError(
                f"CAD ranks disagree on the step's plan (digests by rank: "
                f"{got}): every rank must read the same global batch")

    def attach_plans(self, batch_iter: Iterable[Dict[str, Any]], *,
                     prefetch: Optional[int] = None) \
            -> Iterator[Dict[str, Any]]:
        """Yield batches with plans attached.  With ``prefetch >= 1`` a
        background worker plans batch *i+1* while the caller's device
        computes batch *i* (bounded queue, order-preserving); with
        ``prefetch=0`` planning happens inline.  With a calibrator
        attached, a prefetched plan whose speeds have drifted past
        ``recalib_threshold`` (under a group: any plan of another
        calibration version) is re-planned at pull time (on the
        consumer thread); with a pool attached, a plan prefetched under a
        superseded membership epoch always is: a plan that routes tasks
        to a dead server must never reach the dispatch."""
        depth = self.prefetch if prefetch is None else prefetch
        pulled = _pulled(batch_iter)
        if depth <= 0:
            for i, batch in pulled:
                out = self.plan_batch(batch, step=i)
                self.check_plan_agreement(out)
                yield out
            return
        stale = None
        if self.calibrator is not None or self.pool is not None:
            def stale(item):
                return self._plan_stale(item[1])

        def plan(item):
            # the raw batch rides along: under a group the planned batch
            # holds this rank's rows alone, and a re-plan needs them all
            i, raw = item
            return item, self.plan_batch(raw, step=i)
        pf = PlanPrefetcher(pulled, plan, depth=depth, is_stale=stale,
                            refresh=lambda item: plan(item[0]))
        try:
            for _, out in pf:
                self.check_plan_agreement(out)
                yield out
        finally:
            pf.close()


def _pulled(batches: Iterable[Dict[str, Any]]) \
        -> Iterator[Tuple[int, Dict[str, Any]]]:
    """(index in the stream, batch) of ``batches``, each pull traced as a
    ``data.next`` span on the ``prefetch`` track (on the thread that
    pulls: the prefetch worker, or the caller without prefetch)."""
    it = iter(batches)
    for i in itertools.count():
        with obs_trace.get_recorder().span("data.next", "prefetch",
                                           step=i):
            batch = next(it, None)
        if batch is None:
            return
        yield i, batch


def plan_digest(plan) -> str:
    """SHA-1 over every field of a StepPlan (both halves of a
    PingPongPlan), in field order: equal plans give equal digests."""
    h = hashlib.sha1()
    halves = list(plan) if isinstance(plan, (tuple, list, PingPongPlan)) \
        else [plan]
    for p in halves:
        for key in p.keys():
            a = p[key]
            a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
            h.update(key.encode())
            h.update(str(a.shape).encode())
            h.update(np.ascontiguousarray(a, np.int32).tobytes())
    return h.hexdigest()

