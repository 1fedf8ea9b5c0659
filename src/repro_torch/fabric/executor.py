"""FabricExecutor: mixed train + serve steps on one elastic pool.

The port of ``repro.fabric.executor``.  Extends
:class:`~repro_torch.runtime.executor.ElasticExecutor` — the training
path is *literally* the elastic executor's (``begin_step`` /
``finish_step``), so train outputs are bit-identical to a dedicated-pool
run by construction: admission reads the step state (predicted
per-server loads, the membership view, the pricing snapshot) but never
touches training tensors.

Per ``run_mixed_step`` (DESIGN.md §10):

  1. ``begin_step`` — membership events, the train plan, per-server
     primary predictions, one cost view;
  2. serve admission — one :func:`~repro.fabric.tenancy.admit_serve`
     round against the *same* snapshot and pool view the plan used,
     placing pending serve tasks into ``interval - busy`` idle budgets.
     Pending serve traffic preempts *speculation* (the straggler
     backups are redundant work) by zeroing the step's
     ``speculate_pct`` — never a primary task;
  3. ``finish_step`` — primary execution, failure recovery via
     ``build_recovery_plan``, exactly-once merge;
  4. serve execution — each server's placed tasks run through the same
     ``serve_task_batch`` kernels as training CA tasks (on the device of
     the step's q/k/v).  Tasks placed
     on a server that was killed mid-step are lost with its train
     tasks and **re-admitted onto the least-loaded survivors in the
     same round** — the serve-side mirror of the recovery sub-plan's
     placement rule (and priced from the same epoch-stamped snapshot);
  5. accounting: the fabric step completes at
     ``max(interval, busiest server)`` — backfill never stretches the
     training cadence unless a forced admission or recovery does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.core.cost_model import CalibrationSnapshot
from repro_torch.core.dispatch import CADContext, serve_task_batch
from repro_torch.fabric.tenancy import (SERVE, TRAIN, AdmissionPolicy,
                                        AdmissionRound, ServeTaskReq,
                                        admit_serve)
from repro_torch.fabric.workload import ServeWorkload
from repro_torch.obs import server_track
from repro_torch.runtime.executor import ElasticExecutor, StepReport, _sync


@dataclasses.dataclass(frozen=True)
class FabricStepReport:
    """One mixed step: the train tenant's StepReport plus the serve
    tenant's admission/execution/recovery accounting."""
    train: StepReport
    pool_epoch: int
    calib_version: int
    interval: float
    admitted: int
    executed: int
    deferred: int
    forced: Tuple[int, ...]
    lost_serve: int                    # tasks lost to a mid-step kill
    readmitted: int
    slo_misses: int
    spec_preempted: bool               # serve claimed speculation slack
    serve_seconds: Dict[int, float]
    serve_tokens: int
    step_seconds: float                # fabric completion (>= interval)

    def summary(self) -> str:
        bits = [f"step {self.train.step} epoch {self.pool_epoch} "
                f"serve {self.executed}/{self.executed + self.deferred} "
                f"tok={self.serve_tokens}"]
        if self.lost_serve:
            bits.append(f"lost={self.lost_serve} "
                        f"readmitted={self.readmitted}")
        if self.spec_preempted:
            bits.append("spec-preempted")
        return self.train.summary() + " | " + " | ".join(bits)


class FabricExecutor(ElasticExecutor):
    """One pool, two tenants.  ``workload`` is the serve tenant
    (:class:`ServeWorkload`); ``policy`` its admission knobs — set
    ``policy.allowed`` to a slot subset (with those slots drained in
    the pool) to express a static partition in the same machinery."""

    def __init__(self, session, workload: ServeWorkload, *,
                 faults=None, policy: AdmissionPolicy = AdmissionPolicy(),
                 speculate_pct: float = 0.0, speculate_slack: float = 1.5,
                 timer: str = "model", feed_calibrator: bool = False,
                 recorder=None, metrics=None, clock=None):
        super().__init__(session, faults=faults,
                         speculate_pct=speculate_pct,
                         speculate_slack=speculate_slack, timer=timer,
                         feed_calibrator=feed_calibrator,
                         recorder=recorder, metrics=metrics, clock=clock)
        if workload.blk != session.cfg.blk:
            raise ValueError(
                f"workload blk {workload.blk} != pool blk "
                f"{session.cfg.blk}")
        self.workload = workload
        self.policy = policy
        self.tenants = (TRAIN, SERVE)
        # serve tasks share the pool's kernels but their own (smaller)
        # fused shapes; jmax bounds each task's kv-block scan
        self._serve_cad = CADContext(cfg=session.cfg, jmax=workload.jmax)
        self._device = None              # the step's device, per step

    # ---------------------------------------------------------- stepping
    def run_mixed_step(self, step: int, q, k, v, pos, segment_ids, *,
                       interval: float):
        """One fabric step at cadence ``interval`` (seconds): the train
        step plus serve backfill.  Returns
        ``(train_out, FabricStepReport)``."""
        st = self.begin_step(step, q, k, v, pos, segment_ids)
        self._device = q.device
        # ONE pricing basis per admission round: the same cost view the
        # plan was built from, stamped with the step's pool epoch
        snap = CalibrationSnapshot(
            version=int(st.stats.get("calib_version", -1)),
            cost_model=st.cm, speeds=tuple(float(x) for x in st.speeds))
        tasks = self.workload.pending(step)

        spec_preempted = False
        if tasks and st.speculate_pct > 0 and SERVE.preempts_speculation:
            # latency class reclaims the speculation slack: backup
            # re-executions of straggler blocks are redundant work, so
            # serve takes that capacity; primary tasks are untouchable
            st.speculate_pct = 0.0
            spec_preempted = True

        candidates = tuple(sorted(st.view.active + st.view.draining))
        if self.policy.allowed is not None:
            candidates = tuple(s for s in candidates
                               if s in self.policy.allowed)
        busy = {s: float(st.preds.get(s, 0.0)) for s in candidates}
        rnd = admit_serve(tasks, busy, interval, snap, st.view,
                          policy=self.policy, candidates=candidates,
                          waits=self.workload.waits)
        t_base = self._trace_t           # this step's timeline origin
        self.recorder.instant(
            "admission", "fabric", ts=t_base, step=step,
            args={"admitted": rnd.n_admitted,
                  "deferred": len(rnd.deferred),
                  "forced": list(rnd.forced),
                  "slo_misses": rnd.slo_misses,
                  "spec_preempted": spec_preempted,
                  "pool_epoch": rnd.pool_epoch,
                  "calib_version": rnd.calib_version})

        train_out, trep = self.finish_step(st)

        # serve execution; a mid-step kill loses the victim's serve
        # tasks along with its train tasks
        serve_secs: Dict[int, float] = {}
        lost: List[ServeTaskReq] = []
        executed, tokens = 0, 0
        for s in sorted(rnd.placements):
            placed = rnd.placements[s]
            if s in trep.failed:
                lost.extend(placed)
                continue
            secs = self._run_serve(s, placed, snap, step)
            serve_secs[s] = serve_secs.get(s, 0.0) + secs
            executed += len(placed)
            tokens += sum(t.q_tokens for t in placed)

        # same-round recovery: lost serve tasks re-place onto the
        # least-loaded survivors (the recovery sub-plan's rule), priced
        # from the same snapshot — then execute
        readmitted = 0
        if lost:
            survivors = [s for s in candidates if s not in trep.failed]
            if survivors:
                load = {s: busy.get(s, 0.0) + serve_secs.get(s, 0.0)
                        + trep.recovery_seconds.get(s, 0.0)
                        for s in survivors}
                regroup: Dict[int, List[ServeTaskReq]] = {}
                for t in lost:
                    cost = float(snap.cost_model.predict(
                        t.q_tokens, t.kv_tokens))
                    tgt = min(survivors,
                              key=lambda x: (load[x]
                                             + cost / snap.speeds[x], x))
                    load[tgt] += cost / snap.speeds[tgt]
                    regroup.setdefault(tgt, []).append(t)
                for s in sorted(regroup):
                    secs = self._run_serve(s, regroup[s], snap, step)
                    serve_secs[s] = serve_secs.get(s, 0.0) + secs
                    executed += len(regroup[s])
                    tokens += sum(t.q_tokens for t in regroup[s])
                    readmitted += len(regroup[s])

        self.workload.record_waits(rnd.deferred)

        totals = [trep.server_seconds.get(s, 0.0)
                  + trep.recovery_seconds.get(s, 0.0)
                  + serve_secs.get(s, 0.0)
                  for s in set(candidates) | set(trep.server_seconds)]
        step_seconds = max([float(interval)] + totals)
        self._record_mixed(step, t_base, float(step_seconds), rnd,
                           trep, serve_secs, len(lost), readmitted,
                           spec_preempted)
        rep = FabricStepReport(
            train=trep, pool_epoch=rnd.pool_epoch,
            calib_version=rnd.calib_version, interval=float(interval),
            admitted=rnd.n_admitted, executed=executed,
            deferred=len(rnd.deferred), forced=rnd.forced,
            lost_serve=len(lost), readmitted=readmitted,
            slo_misses=rnd.slo_misses, spec_preempted=spec_preempted,
            serve_seconds=dict(serve_secs), serve_tokens=tokens,
            step_seconds=float(step_seconds))
        return train_out, rep

    # ----------------------------------------------------- observability
    def _record_mixed(self, step: int, t_base: float,
                      step_seconds: float, rnd: AdmissionRound,
                      trep: StepReport, serve_secs: Dict[int, float],
                      n_lost: int, readmitted: int,
                      spec_preempted: bool) -> None:
        """Narrate the serve tenant's half of the step (DESIGN.md §14).
        ``finish_step`` already advanced the timeline by the train
        completion; the fabric completes at ``max(interval, busiest)``,
        so re-anchor the cumulative origin to the fabric's end."""
        rec, mx = self.recorder, self.metrics
        self._trace_t = t_base + step_seconds
        if rec.enabled:
            for s, secs in sorted(serve_secs.items()):
                # backfill runs after the server's train tasks (and any
                # recovery it absorbed) — same order as execution
                start = t_base + trep.server_seconds.get(s, 0.0) \
                    + trep.recovery_seconds.get(s, 0.0)
                rec.add_span("serve.backfill", server_track(s), start,
                             secs, step=step)
        mx.counter("cad_serve_admitted_total",
                   "serve tasks admitted").inc(rnd.n_admitted)
        mx.counter("cad_serve_deferred_total",
                   "serve tasks deferred to a later round").inc(
            len(rnd.deferred))
        mx.counter("cad_serve_forced_total",
                   "starvation-forced admissions").inc(len(rnd.forced))
        mx.counter("cad_serve_slo_misses_total",
                   "admissions past their SLO").inc(rnd.slo_misses)
        mx.counter("cad_serve_lost_total",
                   "serve tasks lost to a mid-step kill").inc(n_lost)
        mx.counter("cad_serve_readmitted_total",
                   "lost serve tasks re-placed same round").inc(
            readmitted)
        mx.counter("cad_spec_preempted_total",
                   "steps where serve reclaimed speculation slack").inc(
            1 if spec_preempted else 0)
        wait_h = mx.histogram(
            "cad_serve_queue_wait_rounds",
            "rounds a deferred serve task has waited",
            buckets=(1, 2, 4, 8, 16, 32))
        for t in rnd.deferred:
            wait_h.observe(self.workload.waits.get(t.rid, 0))

    # ----------------------------------------------------------- serving
    @torch.no_grad()
    def _run_serve(self, server: int, placed, snap, step: int) -> float:
        """Execute one server's placed serve tasks (slot-sized fused
        groups) and commit their outputs.  Returns the server's serve
        seconds under the executor's timer: the wall clock between two
        synchronizes of the serve's device under ``"wall"``."""
        slow = self.faults.slow_factor(step, server)
        secs = 0.0
        w = self.workload
        for i in range(0, len(placed), w.slots):
            group = placed[i:i + w.slots]
            inputs, plan = w.build_batch(group, device=self._device)
            if self.timer == "wall":
                _sync(inputs[0])
                t0 = self.clock.monotonic()
                out = serve_task_batch(self._serve_cad, inputs, plan)
                _sync(out)
                secs += (self.clock.monotonic() - t0) * slow
            else:
                out = serve_task_batch(self._serve_cad, inputs, plan)
                secs += sum(float(snap.cost_model.predict(
                    t.q_tokens, t.kv_tokens)) for t in group) \
                    / float(snap.speeds[server]) * slow
            for j, t in enumerate(group):
                w.commit(t, out[j], step)
        if self.feed_calibrator and placed:
            self.session.observe_server(
                server, [(t.q_tokens, t.kv_tokens) for t in placed],
                secs)
        return secs
