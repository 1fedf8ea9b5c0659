"""Elastic step executor: fault-tolerant dispatch over a mutable pool.

The port of ``repro.runtime.executor``.  ``ElasticExecutor`` is the
runtime layer between :class:`CADSession` (planning, calibration) and
``core.dispatch`` (per-server serve + scatter).  Each ``run_step``:

  1. applies the step's scheduled membership events (rejoins, drains)
     to the :class:`~repro_torch.runtime.pool.ServerPool`, then plans the
     batch against the surviving endpoints (one epoch view per step);
  2. executes every active server's fused CA-task batch independently
     (``core.dispatch.build_server_inputs`` / ``serve_task_batch``: the
     CA kernels on CUDA tensors, their plain versions on CPU tensors) —
     the decomposition that makes task-level fault handling possible;
  3. on a mid-step failure (an injected kill/flap, or a serve raising
     :class:`~repro_torch.runtime.pool.ServerLostError`) builds a
     **recovery sub-plan** re-dispatching exactly the lost tasks onto
     survivors, and **speculatively re-executes** straggler servers
     whose time exceeds the ``speculate_pct`` percentile deadline from
     the calibrated cost model (when the backup is modeled to finish
     earlier);
  4. merges outputs exactly-once: every q block's output is *selected*
     bitwise from exactly one execution, so the step output is
     bit-identical to a fault-free run of the same batch
     (DESIGN.md §9);
  5. feeds measured per-server timings back to the session calibrator
     and applies end-of-step membership consequences (kill -> remove,
     flap -> remove + scheduled rejoin).

Timing runs under one of two timers: ``"model"`` — per-server seconds
are predicted by the (calibrated) cost model, scaled by the fault
schedule's slow factors; fully deterministic, the replay default — or
``"wall"`` — real serve times (slow factors still multiply), each read
between two synchronizes of the serve's device, so a CUDA serve is timed
to its end and not to its launch.  Outputs are bit-identical under
either timer; only the reported seconds differ.  Wall reads go through
an injectable :class:`~repro_torch.obs.clock.Clock`, so tests script
time instead of sleeping.

Unlike the reference, which demotes any exception of a serve to a server
failure, only :class:`ServerLostError` is recovered: a kernel that does
not build, a CUDA error or a shape a kernel refuses propagates, so a
kernel failing on one server's batch is never "recovered" on another.

Every step is additionally narrated to the observability layer
(DESIGN.md §14): per-server serve/recovery spans on a cumulative
step timeline (the Perfetto gantt, one track per server), kill /
speculate / merge events, predicted-vs-measured calibration residual
gauges, and step/failure/recovery counters.  Recording is a strict
no-op when the global recorder is disabled and never touches outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cost_model import CommModel, CostModel, MemoryModel
from repro_torch.core.dispatch import (CADContext, assemble_step_outputs,
                                       build_server_inputs, iter_plan_tasks,
                                       merge_recovered, serve_task_batch)
from repro_torch.core.scheduler import (assignment_resident_bytes,
                                        layout_from_segments,
                                        streamed_doc_ids)
from repro_torch.models.model import resolve_device
from repro_torch.obs import MONOTONIC, server_track
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.faults import FaultSchedule
from repro_torch.runtime.pool import (PoolExhaustedError, ServerLostError,
                                      ServerPool)
from repro_torch.runtime.recovery import (assignment_of_plan,
                                          build_recovery_plan)

TIMERS = ("model", "wall")


def _sync(x: torch.Tensor) -> None:
    """Wait for the work queued on ``x``'s device (a no-op on the CPU)."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


@dataclasses.dataclass(frozen=True)
class StepReport:
    """What happened during one elastic step — everything a replay must
    reproduce (and a dashboard would chart)."""
    step: int
    epoch: int
    failed: Tuple[int, ...]            # servers that lost tasks mid-step
    speculated: Tuple[int, ...]        # stragglers re-executed on backups
    recovered_blocks: int
    server_seconds: Dict[int, float]   # primary serve time per server
    recovery_seconds: Dict[int, float]  # added backup time per survivor
    step_seconds: float                # modeled/measured step completion
    deadline: float                    # straggler deadline (0 = off)
    plan_stats: Dict[str, float]
    events: Tuple[str, ...]            # membership log entries this step

    def summary(self) -> str:
        bits = [f"step {self.step} epoch {self.epoch} "
                f"t={self.step_seconds * 1e3:.2f}ms"]
        if self.failed:
            bits.append(f"failed={list(self.failed)} "
                        f"recovered={self.recovered_blocks} blocks")
        if self.speculated:
            bits.append(f"speculated={list(self.speculated)}")
        return " | ".join(bits)


@dataclasses.dataclass
class StepState:
    """Everything ``begin_step`` established before execution: the
    membership events applied, the plan and the cost view it was priced
    with, and the per-server task composition/predictions.  A caller may
    read it between planning and execution (and may zero
    ``speculate_pct`` for one step — mutating the state, never
    ``self``)."""
    step: int
    q: Any
    k: Any
    v: Any
    pos: Any
    segs: np.ndarray
    events: list
    plan: Any
    stats: Dict[str, float]
    view: Any                          # PoolView for this step
    injected: set                      # servers killed mid-step (sched.)
    tasks_by: Dict[int, list]          # server -> [(q_tok, kv_tok), ...]
    preds: Dict[int, float]            # predicted primary seconds
    cm: CostModel
    speeds: Any
    speculate_pct: float


class ElasticExecutor:
    """Drives elastic steps for one :class:`CADSession` with an
    attached :class:`ServerPool` (``session.with_pool(pool)``).  It
    serves every server in this one process, as the reference's does: a
    session over a CAD process group raises ``ValueError``.

    ``speculate_pct`` in (0, 1] arms straggler speculation: a server
    whose serve time exceeds ``quantile(predicted, pct) * slack`` is
    re-executed on the least-loaded survivors when the backup is
    modeled to finish earlier.  ``0`` disables speculation (failures
    are still recovered).

    ``run_step`` is ``begin_step`` (membership events, planning, cost
    predictions) followed by ``finish_step`` (execution, speculation,
    recovery, merge, calibration feedback).  The serves run without
    autograd: the elastic runtime executes forward CA-task batches."""

    def __init__(self, session, *, faults: Optional[FaultSchedule] = None,
                 speculate_pct: float = 0.0,
                 speculate_slack: float = 1.5,
                 timer: str = "model",
                 feed_calibrator: bool = True,
                 recorder=None, metrics=None, clock=None):
        if session.group is not None:
            raise ValueError(
                f"{type(self).__name__} serves every server's batch in one "
                "process, as the reference's does; its session must not "
                "carry a CAD process group (train under a group with "
                "trainer.train, whose fused step applies the fault "
                "schedule's membership events on every rank)")
        if session.pool is None:
            raise ValueError("session has no ServerPool; use "
                             "session.with_pool(ServerPool(...))")
        if session.pingpong:
            raise NotImplementedError(
                "the elastic executor drives single-phase plans; "
                "ping-pong interleaving stays on the fused path")
        if timer not in TIMERS:
            raise ValueError(f"timer must be one of {TIMERS}, got "
                             f"{timer!r}")
        if not 0.0 <= speculate_pct <= 1.0:
            raise ValueError(f"speculate_pct in [0, 1], got "
                             f"{speculate_pct}")
        self.session = session
        self.pool: ServerPool = session.pool
        self.faults = faults or FaultSchedule()
        self.speculate_pct = float(speculate_pct)
        self.speculate_slack = float(speculate_slack)
        self.timer = timer
        self.feed_calibrator = feed_calibrator
        # observability hooks: explicit instances pin the executor to a
        # recorder/registry; None defers to the process-global ones at
        # use time (so launch-flag enabling applies retroactively)
        self._recorder = recorder
        self._metrics = metrics
        self.clock = clock if clock is not None else MONOTONIC
        self._trace_t = 0.0        # cumulative step-timeline origin (s)
        self._cad = CADContext(cfg=session.cfg, jmax=session.jmax,
                               mask=session.mask)

    @property
    def recorder(self) -> obs_trace.TraceRecorder:
        return self._recorder if self._recorder is not None \
            else obs_trace.get_recorder()

    @property
    def metrics(self) -> obs_metrics.MetricsRegistry:
        return self._metrics if self._metrics is not None \
            else obs_metrics.get_registry()

    # ------------------------------------------------------------ helpers
    def _cost_view(self):
        """(cost model, speeds) the step's predictions come from: the
        calibrator's current snapshot when attached, else the analytic
        base for the session's head geometry."""
        if self.session.calibrator is not None:
            snap = self.session.calibrator.snapshot()
            return snap.cost_model, snap.speeds_array()
        comm = self.session.comm
        cm = CostModel.analytic(comm.n_heads if comm else 1,
                                comm.head_dim if comm else 8)
        return cm, self.session.cfg.speeds()

    def _predict_server(self, cm: CostModel, speeds, tasks,
                        server: int) -> float:
        if not tasks:
            return 0.0
        t = float(sum(float(cm.predict(qt, kvt)) for qt, kvt in tasks))
        return t / float(speeds[server])

    def _recovery_memory(self, cfg, segs, plan, backups):
        """(MemoryModel, survivor resident bytes) for budget-aware
        recovery destination choice, or (None, None) when the session
        declares no HBM budgets.  The survivors' *primary* resident
        bytes are recovered from the executed plan's dispatch arrays so
        recovery lands on the survivors with genuine headroom
        (DESIGN.md §11)."""
        budgets = cfg.budgets()
        if budgets is None:
            return None, None
        comm = self.session.comm or CommModel(1, 1, 1)
        mem = MemoryModel(comm)
        docs, doc_of, bi_of = layout_from_segments(segs, cfg.blk,
                                                   cfg.n_servers)
        mask = self.session.mask
        streamed = streamed_doc_ids(docs, cfg.blk, mem, budgets,
                                    stream_chunk=cfg.stream_chunk,
                                    allowed=backups, mask=mask)
        res = assignment_resident_bytes(
            assignment_of_plan(cfg, plan), doc_of, bi_of, cfg.blk,
            cfg.n_servers, mem, streamed=streamed,
            stream_chunk=cfg.stream_chunk, mask=mask)
        return mem, {s: float(res[s]) for s in backups}

    def _serve(self, inputs_s, plan_s, slow: float, predicted: float):
        """One server's serve and its seconds: the model's prediction, or
        the wall clock between two synchronizes of the serve's device
        (the first waits out work queued before the serve), times the
        server's slow factor."""
        if self.timer == "wall":
            _sync(inputs_s[0])
            t0 = self.clock.monotonic()
            out = serve_task_batch(self._cad, inputs_s, plan_s)
            _sync(out)
            return out, (self.clock.monotonic() - t0) * slow
        return serve_task_batch(self._cad, inputs_s, plan_s), \
            predicted * slow

    # ----------------------------------------------------------- stepping
    def run_step(self, step: int, q, k, v, pos, segment_ids: np.ndarray):
        """Execute one elastic step.  ``q``/``k``/``v`` are the stacked
        rank-major global layout ``[D*Bl, S, H(kv), dh]`` (tensors on one
        device), ``pos`` is ``[D*Bl, S]`` with -1 on padding,
        ``segment_ids`` the packed [D*Bl, S] (or [D, T]) layout.  Returns
        ``(out, StepReport)``; never raises on an injected fault or a
        lost server — lost tasks are recovered (only an exhausted pool
        aborts)."""
        return self.finish_step(self.begin_step(step, q, k, v, pos,
                                                segment_ids))

    def begin_step(self, step: int, q, k, v, pos,
                   segment_ids: np.ndarray) -> StepState:
        """Membership events + planning + cost predictions — everything
        known *before* any server executes."""
        cfg = self.session.cfg

        # 1. scheduled membership: rejoins/drains land before planning
        # (shared semantics with the fused trainer path)
        events = list(self.faults.apply_pre_step(self.pool, step))

        segs = np.asarray(segment_ids).reshape(cfg.n_servers, -1)
        span_args = {"policy": self.session.plan_policy}
        with self.recorder.span("step.plan", "planner", step=step,
                                args=span_args):
            plan, stats = self.session.plan(segs)
            span_args["imbalance"] = stats.get("load_max_over_mean")
        view = self.pool.view()

        injected = {e.server for e in self.faults.failures_at(step)} \
            & set(view.active)
        tasks_by = {s: [] for s in range(cfg.n_servers)}
        # live kv tokens under the session mask: the calibrator keys its
        # grid on live tokens, so rectangle lengths would both mis-price
        # the straggler deadline and feed the wrong cells (DESIGN.md §12)
        for s, _slot, qt, kvt in iter_plan_tasks(cfg, plan,
                                                 self.session.mask):
            tasks_by[s].append((qt, kvt))
        cm, speeds = self._cost_view()
        preds = {s: self._predict_server(cm, speeds, tasks_by[s], s)
                 for s in view.active}
        if preds:
            vals = np.array([preds[s] for s in view.active])
            self.metrics.gauge(
                "cad_predicted_imbalance",
                "predicted per-server serve time max/mean at "
                "schedule time").set(
                float(vals.max() / max(vals.mean(), 1e-30)))
        return StepState(step=step, q=q, k=k, v=v, pos=pos, segs=segs,
                         events=events, plan=plan, stats=stats,
                         view=view, injected=injected, tasks_by=tasks_by,
                         preds=preds, cm=cm, speeds=speeds,
                         speculate_pct=self.speculate_pct)

    @torch.no_grad()
    def finish_step(self, st: StepState):
        """Execute, speculate, recover and merge the step prepared by
        ``begin_step``.  Returns ``(out, StepReport)``."""
        cfg = self.session.cfg
        step, q, k, v, pos = st.step, st.q, st.k, st.v, st.pos
        events, plan, stats = st.events, st.plan, st.stats
        view, injected = st.view, st.injected
        tasks_by, preds = st.tasks_by, st.preds
        cm, speeds = st.cm, st.speeds
        segs = st.segs

        # 2. primary execution, one fused task batch per active server;
        # injected kills lose their tasks up front, a server lost during
        # its serve is demoted to a failure the same way (recover, then
        # remove)
        failures = set(injected)
        inputs, plans_r = build_server_inputs(self._cad, plan, q, k, v,
                                              pos)

        outs: Dict[int, Any] = {}
        seconds: Dict[int, float] = {}
        for s in view.active:
            if s in failures:
                continue                      # tasks lost mid-serve
            try:
                outs[s], seconds[s] = self._serve(
                    inputs[s], plans_r[s], self.faults.slow_factor(step, s),
                    preds[s])
            except ServerLostError as exc:    # the endpoint died
                failures.add(s)
                events.append(f"serve-error {s}: {type(exc).__name__}")

        failures = tuple(sorted(failures))
        healthy = [s for s in view.active if s not in failures]
        if not healthy:
            raise PoolExhaustedError(
                f"step {step}: every active server failed {failures}")

        # 3. straggler detection against the cost-model deadline
        # (st.speculate_pct, not self: a caller may zero it per step)
        deadline = 0.0
        speculated: list = []
        if st.speculate_pct > 0 and len(healthy) > 1:
            deadline = float(np.quantile(
                [preds[s] for s in view.active], st.speculate_pct)) \
                * self.speculate_slack
            for s in healthy:
                if seconds[s] <= deadline or not tasks_by[s]:
                    continue
                backups = [x for x in healthy
                           if x != s and seconds[x] <= deadline]
                if not backups:
                    continue
                # speculate only when the backup is modeled to win
                spread = sum(float(cm.predict(qt, kvt))
                             for qt, kvt in tasks_by[s]) \
                    / float(sum(speeds[b] for b in backups))
                if deadline + spread < seconds[s]:
                    speculated.append(s)

        # 4. recovery sub-plan for lost + speculated tasks
        to_recover = tuple(failures) + tuple(speculated)
        rec = None
        rec_secs: Dict[int, float] = {}
        if to_recover:
            backups = [s for s in healthy if s not in speculated]
            if not backups:                    # nobody left to back up
                speculated = []
                to_recover = tuple(failures)
                backups = list(healthy)
            mem, base_res = self._recovery_memory(cfg, segs, plan,
                                                  backups)
            rec = build_recovery_plan(
                cfg, segs, plan, to_recover, allowed=backups,
                base_loads={s: seconds[s] for s in backups},
                cost_model=cm, speeds=speeds, mem_model=mem,
                base_resident=base_res,
                mask=self.session.mask) if to_recover else None
        base = assemble_step_outputs(cfg, plan, outs, q.shape, q.dtype)
        if rec is not None:
            rec_inputs, rec_plans = build_server_inputs(
                self._cad, rec.plan, q, k, v, pos)
            rec_outs = {}
            for s, added in rec.added_time.items():
                rec_outs[s], rec_secs[s] = self._serve(
                    rec_inputs[s], rec_plans[s],
                    self.faults.slow_factor(step, s), added)
            recovered = assemble_step_outputs(cfg, rec.plan, rec_outs,
                                              q.shape, q.dtype)
            out = merge_recovered(cfg, base, recovered, rec.lost)
        else:
            out = base

        # 5. completion accounting + calibration feedback
        detect = deadline if deadline > 0 else \
            max((seconds[s] for s in seconds), default=0.0)
        done = []
        for s in healthy:
            if s in speculated:
                continue
            t = seconds[s]
            if s in rec_secs:
                t = max(t, detect) + rec_secs[s]
            done.append(t)
        step_seconds = max(done, default=0.0)
        if self.feed_calibrator:
            for s in healthy:
                if tasks_by[s]:
                    self.session.observe_server(s, tasks_by[s],
                                                seconds[s])

        # 6. end-of-step membership consequences (shared semantics with
        # the fused trainer path; also fells draining servers so their
        # flap rejoins can fire later)
        events.extend(self.faults.apply_failures(self.pool, step))
        for s in failures:
            if s not in injected:             # lost during its serve
                self.pool.remove(s)
                events.append(f"remove {s} (serve error)")

        report = StepReport(
            step=step, epoch=view.epoch, failed=failures,
            speculated=tuple(speculated),
            recovered_blocks=0 if rec is None else rec.n_blocks,
            server_seconds=dict(seconds), recovery_seconds=rec_secs,
            step_seconds=float(step_seconds), deadline=float(deadline),
            plan_stats=dict(stats), events=tuple(events))
        self._record_step(st, report, detect)
        return out, report

    def _record_step(self, st: StepState, report: StepReport,
                     detect: float) -> None:
        """Narrate one finished step: per-server spans on the cumulative
        step timeline (Perfetto gantt), fault/speculation instants, and
        the step's counters/gauges.  Strictly write-only — outputs are
        already merged by the time this runs (DESIGN.md §14)."""
        rec, mx = self.recorder, self.metrics
        t0, dur = self._trace_t, report.step_seconds
        self._trace_t = t0 + dur
        step = report.step
        if rec.enabled:
            rec.add_span("step", "step", t0, dur, step=step,
                         args={"epoch": report.epoch,
                               "failed": list(report.failed),
                               "speculated": list(report.speculated),
                               "recovered_blocks": report.recovered_blocks})
            for s, sec in sorted(report.server_seconds.items()):
                rec.add_span("serve", server_track(s), t0, sec, step=step,
                             args={"predicted": st.preds.get(s, 0.0),
                                   "n_tasks": len(st.tasks_by.get(s, ()))})
            for s in report.failed:
                name = "kill" if s in st.injected else "serve-error"
                rec.instant(name, server_track(s), ts=t0, step=step)
            for s in report.speculated:
                rec.instant("speculate", server_track(s),
                            ts=t0 + report.deadline, step=step,
                            args={"deadline": report.deadline})
            for s, rs in sorted(report.recovery_seconds.items()):
                start = t0 + max(report.server_seconds.get(s, 0.0),
                                 detect)
                rec.add_span("recover", server_track(s), start, rs,
                             step=step,
                             args={"recovered_from":
                                   list(report.failed)
                                   + list(report.speculated)})
            rec.instant("merge", "step", ts=t0 + dur, step=step,
                        args={"blocks": report.recovered_blocks})
        mx.counter("cad_steps_total", "elastic steps completed").inc()
        mx.counter("cad_failures_total",
                   "servers that lost tasks mid-step").inc(
            len(report.failed))
        mx.counter("cad_speculations_total",
                   "straggler speculative re-executions").inc(
            len(report.speculated))
        mx.counter("cad_recovered_blocks_total",
                   "q blocks re-dispatched by recovery").inc(
            report.recovered_blocks)
        mx.histogram("cad_step_seconds",
                     "modeled/measured step completion seconds").observe(
            report.step_seconds)
        mx.gauge("cad_pool_epoch", "pool membership epoch").set(
            report.epoch)
        resid = mx.gauge(
            "cad_calib_residual",
            "|predicted - measured| / measured serve seconds",
            labels=("server",))
        for s, sec in report.server_seconds.items():
            if st.tasks_by.get(s):
                resid.set(abs(st.preds.get(s, 0.0) - sec)
                          / max(sec, 1e-12), server=s)

    # ------------------------------------------------------ conveniences
    def synth_inputs(self, segment_ids: np.ndarray,
                     positions: np.ndarray, *, seed: int = 0,
                     dtype=torch.float32, device="cuda"):
        """Seeded q/k/v (+ masked positions) matching the session's head
        geometry for a packed batch, drawn from a ``torch.Generator`` on
        ``device`` (the card unless the caller asks for the CPU; the two
        devices' generators draw different values)."""
        comm = self.session.comm
        nh = comm.n_heads if comm else 1
        dh = comm.head_dim if comm else 8
        hkv = comm.n_kv_heads if comm else nh
        dev = resolve_device(device)
        segs = np.asarray(segment_ids)
        rows, s_len = segs.shape
        gen = torch.Generator(device=dev).manual_seed(seed)

        def rnd(h):
            return torch.randn((rows, s_len, h, dh), generator=gen,
                               device=dev).to(dtype)

        q, k, v = rnd(nh), rnd(hkv), rnd(hkv)
        pos = torch.as_tensor(np.where(segs > 0, positions, -1)
                              .astype(np.int32), device=dev)
        return q, k, v, pos
