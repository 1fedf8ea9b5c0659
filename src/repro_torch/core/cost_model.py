"""Cost model for CA-tasks and communication (paper §4.2 "Profiler" +
Appendix A/B).

The port's copy of ``repro.core.cost_model``: ``CostModel``,
``CalibrationSnapshot``, ``GridCalibrator``, ``ca_flops``,
``causal_doc_flops``, ``linear_flops_per_token``, ``CommModel`` and
``MemoryModel``.  The hardware constants describe one NVIDIA H100 SXM
instead of a TPU v5e.

On real hardware the paper benchmarks a (q_len, kv_len) latency grid and
bilinearly interpolates.  We keep exactly that interface (``from_grid``)
and default to an analytic roofline-calibrated model; at runtime
:class:`GridCalibrator` populates the grid from *measured* per-task
timings (EMA per cell, unobserved cells fall back to the analytic
prediction) and estimates per-server speed factors, so the planners
replan batch *i+1* from batch *i*'s measured costs (DESIGN.md §3).
Everything downstream (scheduler, benchmarks, e2e simulator) consumes
only the ``CostModel`` interface, so a measured grid drops in.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

# NVIDIA H100 SXM data-sheet values (per card, dense, no sparsity).  These
# are published peaks, not measurements: a calibrated grid replaces them.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12                  # B/s
NVLINK_BW = 450e9                 # B/s each way
BYTES_PER_EL = 2                  # bf16


def ca_flops(q_tokens: int | np.ndarray, kv_tokens: int | np.ndarray,
             n_heads: int, head_dim: int) -> np.ndarray:
    """FLOPs of core attention for q tokens against kv context:
    2·q·kv·H·dh (QK^T) + 2·q·kv·H·dh (PV)."""
    return 4.0 * np.asarray(q_tokens, np.float64) * kv_tokens \
        * n_heads * head_dim


def causal_doc_flops(doc_len: int | np.ndarray, n_heads: int,
                     head_dim: int) -> np.ndarray:
    """Total CA FLOPs of a causal document: sum_t 4·t·H·dh ≈ 2·l²·H·dh."""
    l = np.asarray(doc_len, np.float64)
    return 2.0 * l * (l + 1) * n_heads * head_dim


def linear_flops_per_token(cfg) -> float:
    """FLOPs per token of the context-independent layers (App. A formula:
    2·h·(2h + h_kv + 3i) per layer, adapted per arch)."""
    d = cfg.d_model
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim
    total = 0.0
    for t in cfg.layer_pattern:
        if t in ("global", "local", "cross", "enc"):
            attn = 2 * (d * hq * 2 + d * hkv * 2)
            if t == "cross":
                attn *= 2
            total += attn + 2 * cfg._ffn_active_flops_per_token()
        elif t == "rglru":
            w = cfg.rglru.lru_width or d
            total += 2 * (2 * d * w + 2 * w * w + w * d) \
                + 2 * cfg._ffn_active_flops_per_token()
        elif t == "ssd":
            s = cfg.ssm
            d_in = s.expand * d
            total += 2 * d * (2 * d_in + 2 * s.n_groups * s.d_state
                              + d_in // s.head_dim) + 2 * d_in * d
    return total * cfg.n_layers / len(cfg.layer_pattern)


@dataclasses.dataclass(frozen=True)
class CommModel:
    """Bytes of moving CA-task inputs/outputs (App. B)."""
    n_heads: int
    head_dim: int
    n_kv_heads: int
    bytes_per_el: int = BYTES_PER_EL

    @property
    def size_q(self) -> int:          # bytes per q token (q + returned o)
        return 2 * self.n_heads * self.head_dim * self.bytes_per_el

    @property
    def size_kv(self) -> int:         # bytes per kv token (k and v)
        return 2 * self.n_kv_heads * self.head_dim * self.bytes_per_el

    def migration_bytes(self, n_q_tokens: int, n_kv_tokens: int) -> float:
        return n_q_tokens * self.size_q + n_kv_tokens * self.size_kv


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """HBM bytes a CA task pins on its attention server while resident
    (DESIGN.md §11).

    A task is one q block against a causal kv prefix; its working set
    is the q shard plus the returned o (``CommModel.size_q``), the k/v
    context (``CommModel.size_kv``) and the f32 per-(q token, head)
    lse residual the flash backward saves.  Reusing the CommModel byte
    accessors keeps the planner's resident-bytes and comm-bytes ledgers
    on one byte accounting that cannot drift apart.
    """
    comm: CommModel
    lse_bytes: int = 4                # f32 per (q token, head)

    def q_bytes(self, q_tokens) -> float:
        """q shard + returned o resident for the task's q side."""
        return float(q_tokens) * self.comm.size_q

    def kv_bytes(self, kv_tokens) -> float:
        """k and v context bytes for a ``kv_tokens``-token prefix."""
        return float(kv_tokens) * self.comm.size_kv

    def residual_bytes(self, q_tokens) -> float:
        """Backward-saved softmax statistics (lse) for the q shard."""
        return float(q_tokens) * self.comm.n_heads * self.lse_bytes

    def live_kv_bytes(self, kv_tokens, mask=None, blk: int = 128) -> float:
        """kv bytes a task actually *touches* under ``mask`` — the
        live-block pricing of DESIGN.md §12.  The dense prefix
        (:meth:`kv_bytes`) remains the residency ledger's unit because
        the kv gather buffer realizes the contiguous range; live pricing
        is the compute/bandwidth view planners and benchmarks weigh
        masked tasks by."""
        if mask is None or getattr(mask, "trivial", True):
            return self.kv_bytes(kv_tokens)
        from repro_torch.core.mask import live_kv_len  # local: avoid cycle
        nb = -(-int(kv_tokens) // blk)
        return self.kv_bytes(min(int(kv_tokens),
                                 live_kv_len(mask, nb, blk)))

    def task_bytes(self, q_len, kv_len, mask=None, blk: int = 128) -> float:
        """Full resident footprint of one (q_len, kv_len) CA task.  With
        a non-trivial ``mask`` the kv term is priced at the task's live
        kv tokens (:meth:`live_kv_bytes`) — rectangle area otherwise."""
        return self.q_bytes(q_len) + self.residual_bytes(q_len) \
            + self.live_kv_bytes(kv_len, mask, blk)


class CostModel:
    """Predicts CA-task execution time.  Bilinear interpolation over a
    (q_len, kv_len) grid — the paper's profiler — with an analytic default
    grid derived from the roofline constants."""

    def __init__(self, q_grid: np.ndarray, kv_grid: np.ndarray,
                 time_grid: np.ndarray, n_heads: int, head_dim: int,
                 peak_flops: float = PEAK_FLOPS_BF16):
        self.q_grid = np.asarray(q_grid, np.float64)
        self.kv_grid = np.asarray(kv_grid, np.float64)
        self.time_grid = np.asarray(time_grid, np.float64)
        self.n_heads, self.head_dim = n_heads, head_dim
        self.peak_flops = peak_flops

    # -------------------------------------------------------- constructors
    @classmethod
    def analytic(cls, n_heads: int, head_dim: int,
                 peak_flops: float = PEAK_FLOPS_BF16,
                 mfu_saturated: float = 0.4, tile: int = 128):
        """Latency = flops / (mfu(q)·peak); small shards (< tile) waste
        their thread block — the Fig. 5 throughput cliff.

        mfu_saturated defaults to 0.4: masked varlen flash attention runs
        well below GEMM efficiency (FA2-class kernels reach ~35-45% of
        peak on packed variable-length batches; cf. the paper's Fig. 5 and
        our benchmarks/kernel_throughput.py reproduction).  GEMM-dominated
        linear layers use MFU_LINEAR=0.5 in the simulators."""
        q_grid = np.array([16, 32, 64, 128, 256, 512, 1024, 4096, 32768])
        kv_grid = np.array([128, 512, 2048, 8192, 32768, 131072, 524288])
        tg = np.zeros((len(q_grid), len(kv_grid)))
        for i, q in enumerate(q_grid):
            # sub-tile shards are padded to the tile -> mfu ∝ q/tile
            eff = mfu_saturated * min(1.0, q / tile)
            for j, kv in enumerate(kv_grid):
                f = ca_flops(q, kv, n_heads, head_dim)
                tg[i, j] = f / (eff * peak_flops)
        return cls(q_grid, kv_grid, tg, n_heads, head_dim, peak_flops)

    @classmethod
    def from_grid(cls, q_grid, kv_grid, time_grid, n_heads, head_dim,
                  peak_flops: float = PEAK_FLOPS_BF16):
        """Drop-in for a measured profiler grid."""
        return cls(q_grid, kv_grid, time_grid, n_heads, head_dim,
                   peak_flops)

    # -------------------------------------------------------- serialization
    def to_dict(self) -> Dict:
        """JSON-serializable state (measured grids survive restarts)."""
        return {
            "q_grid": self.q_grid.tolist(),
            "kv_grid": self.kv_grid.tolist(),
            "time_grid": self.time_grid.tolist(),
            "n_heads": int(self.n_heads),
            "head_dim": int(self.head_dim),
            "peak_flops": float(self.peak_flops),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "CostModel":
        return cls(np.asarray(d["q_grid"]), np.asarray(d["kv_grid"]),
                   np.asarray(d["time_grid"]), int(d["n_heads"]),
                   int(d["head_dim"]), float(d["peak_flops"]))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "CostModel":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def scaled(self, factor: float) -> "CostModel":
        """A model whose predictions are ``factor``x slower — e.g. the
        per-server view of a 1/factor-speed server."""
        return CostModel(self.q_grid, self.kv_grid,
                         self.time_grid * float(factor), self.n_heads,
                         self.head_dim, self.peak_flops / float(factor))

    # ------------------------------------------------------------- predict
    def predict(self, q_len, kv_len) -> np.ndarray:
        """Bilinear interpolation; saturation region falls back to peak
        throughput (paper §4.2)."""
        q = np.clip(np.asarray(q_len, np.float64), self.q_grid[0],
                    self.q_grid[-1])
        kv = np.clip(np.asarray(kv_len, np.float64), self.kv_grid[0],
                     self.kv_grid[-1])
        qi = np.clip(np.searchsorted(self.q_grid, q) - 1, 0,
                     len(self.q_grid) - 2)
        ki = np.clip(np.searchsorted(self.kv_grid, kv) - 1, 0,
                     len(self.kv_grid) - 2)
        q0, q1 = self.q_grid[qi], self.q_grid[qi + 1]
        k0, k1 = self.kv_grid[ki], self.kv_grid[ki + 1]
        tq = (q - q0) / (q1 - q0)
        tk = (kv - k0) / (k1 - k0)
        t00 = self.time_grid[qi, ki]
        t01 = self.time_grid[qi, ki + 1]
        t10 = self.time_grid[qi + 1, ki]
        t11 = self.time_grid[qi + 1, ki + 1]
        interp = (t00 * (1 - tq) * (1 - tk) + t01 * (1 - tq) * tk
                  + t10 * tq * (1 - tk) + t11 * tq * tk)
        # saturation: never below peak-throughput time
        floor = ca_flops(q, kv, self.n_heads, self.head_dim) \
            / self.peak_flops
        return np.maximum(interp, floor)


# ===================================================================
# Runtime calibration (paper §4.2 "Profiler", online)
# ===================================================================

@dataclasses.dataclass(frozen=True)
class CalibrationSnapshot:
    """An immutable view of the calibrator at one version: the cost
    model every planner call in flight uses, plus normalized per-server
    speed factors (fastest server == 1.0).  Plans record the version
    they were built from (``stats["calib_version"]``), which is what
    keeps async-prefetched planning deterministic for replay: planning
    is a pure function of (batch, snapshot)."""
    version: int
    cost_model: CostModel
    speeds: Tuple[float, ...]

    def speeds_array(self) -> np.ndarray:
        return np.asarray(self.speeds, np.float64)


class GridCalibrator:
    """Online (q_len, kv_len) latency-grid profiler with per-server
    speed estimation.

    ``observe(q_len, kv_len, seconds, server=...)`` feeds one measured
    CA-task timing.  Under a non-trivial mask the caller keys the
    observation by the task's *live* kv tokens —
    ``repro.core.dispatch.iter_plan_tasks`` emits exactly that — so a
    sliding-window or dilated task calibrates the grid cell of the
    context it actually iterated, and predictions stay consistent with
    the live-block pricing the planners use (DESIGN.md §12).  Each
    sample updates

    * the EMA of its (log-nearest) grid cell, normalized to the current
      fastest-server reference, and
    * the server's speed ratio EMA — *base*-model prediction over
      measured time.  The fixed base is the yardstick on purpose: a
      0.5x server measures 2x the base prediction of a 1x server for
      the same shape, so ratios converge to (base/hardware scale)·speed
      and their normalization to relative speeds — without coupling to
      the moving calibrated cells (which would let cell drift and speed
      drift chase each other).

    ``snapshot()`` returns an immutable :class:`CalibrationSnapshot`
    whose grid falls back to the ``base`` model for unobserved cells and
    whose speeds are normalized so the fastest server is 1.0.  All
    methods are thread-safe: the plan-prefetch worker snapshots while
    the train loop observes (DESIGN.md §3).
    """

    def __init__(self, base: CostModel, n_servers: int, *,
                 ema: float = 0.5,
                 prior_speeds: Optional[Iterable[float]] = None,
                 q_grid: Optional[np.ndarray] = None,
                 kv_grid: Optional[np.ndarray] = None):
        if not 0.0 < ema <= 1.0:
            raise ValueError(f"ema must be in (0, 1], got {ema}")
        self.base = base
        self.n_servers = int(n_servers)
        self.ema = float(ema)
        self.q_grid = np.asarray(base.q_grid if q_grid is None else q_grid,
                                 np.float64)
        if kv_grid is None:
            # denser than the analytic default: samples snap to their
            # log-nearest cell, and mixing octaves into one cell leaves
            # an interpolation bias the planner then balances against
            kv0, kv1 = float(base.kv_grid[0]), float(base.kv_grid[-1])
            n_oct = int(np.ceil(np.log2(kv1 / kv0))) + 1
            kv_grid = kv0 * 2.0 ** np.arange(n_oct)
        self.kv_grid = np.asarray(kv_grid, np.float64)
        self._cells = np.full((len(self.q_grid), len(self.kv_grid)),
                              np.nan)
        if prior_speeds is None:
            self._prior = np.ones(self.n_servers)
        else:
            self._prior = np.asarray(list(prior_speeds), np.float64)
            if self._prior.shape != (self.n_servers,):
                raise ValueError(
                    f"prior_speeds needs {self.n_servers} entries, got "
                    f"{self._prior.shape}")
        self._ratio = np.full(self.n_servers, np.nan)
        self._n_obs = 0
        self._version = 0
        self._lock = threading.Lock()
        self._snap: Optional[CalibrationSnapshot] = None

    # ------------------------------------------------------------ internals
    def _cell_idx(self, q_len: float, kv_len: float) -> Tuple[int, int]:
        """Log-nearest grid cell for one measured task shape."""
        lq = np.log(max(float(q_len), 1.0))
        lk = np.log(max(float(kv_len), 1.0))
        qi = int(np.argmin(np.abs(np.log(self.q_grid) - lq)))
        ki = int(np.argmin(np.abs(np.log(self.kv_grid) - lk)))
        return qi, ki

    def _speeds_locked(self) -> np.ndarray:
        """Normalized speeds under the held lock, fastest == 1.

        Observed ratios carry the base-model/hardware scale; priors are
        *relative* speeds on scale 1.  Mixing them raw would make any
        not-yet-observed server look arbitrarily fast or slow whenever
        the hardware differs from the analytic model, so unobserved
        servers get their prior anchored to the mean observed
        ratio-per-prior — i.e. "assume it behaves like the servers we
        have measured, at its declared relative speed"."""
        obs = ~np.isnan(self._ratio)
        if not obs.any():
            s = self._prior.copy()
        else:
            scale = float((self._ratio[obs] / self._prior[obs]).mean())
            s = np.where(obs, self._ratio, self._prior * scale)
        top = s.max()
        return s / top if top > 0 else np.ones_like(s)

    def _predict_ref_locked(self, q_len: float, kv_len: float) -> float:
        """Reference (fastest-server) prediction from the current cells,
        falling back to the base model for unobserved cells."""
        qi, ki = self._cell_idx(q_len, kv_len)
        c = self._cells[qi, ki]
        if np.isnan(c):
            return float(self.base.predict(q_len, kv_len))
        return float(c)

    # -------------------------------------------------------------- observe
    def observe(self, q_len: int, kv_len: int, seconds: float,
                server: Optional[int] = None) -> None:
        """Record one measured CA-task timing.  ``server=None`` means
        the measurement came from a reference (speed-1) server."""
        if seconds <= 0 or kv_len <= 0 or q_len <= 0:
            return
        with self._lock:
            if server is not None:
                pred = float(self.base.predict(q_len, kv_len))
                ratio = pred / float(seconds)
                old = self._ratio[server]
                self._ratio[server] = ratio if np.isnan(old) \
                    else (1 - self.ema) * old + self.ema * ratio
                speed = self._speeds_locked()[server]
            else:
                speed = 1.0
            ref = float(seconds) * speed     # time on the fastest server
            qi, ki = self._cell_idx(q_len, kv_len)
            old = self._cells[qi, ki]
            self._cells[qi, ki] = ref if np.isnan(old) \
                else (1 - self.ema) * old + self.ema * ref
            self._n_obs += 1
            self._version += 1

    def observe_tasks(self, tasks: Iterable[Tuple[int, int]],
                      seconds: float,
                      server: Optional[int] = None) -> None:
        """Record one measured timing for a *fused batch* of tasks
        (what a per-server timer sees): ``seconds`` is split across the
        tasks proportionally to the current snapshot's predictions —
        the per-server total drives the scale and speed estimates, the
        model keeps the relative cell structure."""
        tasks = [(int(q), int(kv)) for q, kv in tasks if q > 0 and kv > 0]
        if not tasks or seconds <= 0:
            return
        with self._lock:
            preds = np.array([self._predict_ref_locked(q, kv)
                              for q, kv in tasks])
        total = preds.sum()
        if total <= 0:
            return
        for (q, kv), p in zip(tasks, preds):
            self.observe(q, kv, float(seconds) * float(p / total),
                         server=server)

    # ------------------------------------------------------------ snapshots
    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def n_observations(self) -> int:
        with self._lock:
            return self._n_obs

    def speeds(self) -> np.ndarray:
        with self._lock:
            return self._speeds_locked()

    def snapshot(self) -> CalibrationSnapshot:
        """Immutable (version, cost model, speeds) triple; cached per
        version so prefetch-thread planning is cheap."""
        with self._lock:
            if self._snap is not None \
                    and self._snap.version == self._version:
                return self._snap
            tg = np.empty_like(self._cells)
            for i, q in enumerate(self.q_grid):
                for j, kv in enumerate(self.kv_grid):
                    c = self._cells[i, j]
                    tg[i, j] = self.base.predict(q, kv) if np.isnan(c) \
                        else c
            cm = CostModel.from_grid(self.q_grid, self.kv_grid, tg,
                                     self.base.n_heads,
                                     self.base.head_dim,
                                     peak_flops=self.base.peak_flops)
            self._snap = CalibrationSnapshot(
                version=self._version, cost_model=cm,
                speeds=tuple(float(s) for s in self._speeds_locked()))
            return self._snap

    # ------------------------------------------------------- pool elasticity
    def reset_server(self, server: int,
                     prior_speed: Optional[float] = None) -> None:
        """Forget one server's measured speed ratio — the elastic-pool
        carryover hook (DESIGN.md §9): when a *new* endpoint joins at a
        dispatch slot, its predecessor's speed estimate must not leak
        onto it, so the slot restarts from the base model (and
        ``prior_speed`` if declared).  Surviving servers keep their
        state untouched; a same-endpoint rejoin (flap) should NOT call
        this — its calibration is still valid."""
        with self._lock:
            if not 0 <= server < self.n_servers:
                raise ValueError(f"server {server} outside pool of "
                                 f"{self.n_servers}")
            self._ratio[server] = np.nan
            if prior_speed is not None:
                if prior_speed <= 0:
                    raise ValueError(
                        f"prior_speed must be > 0, got {prior_speed}")
                self._prior[server] = float(prior_speed)
            self._version += 1
            self._snap = None

    # -------------------------------------------------------- serialization
    def state_dict(self) -> Dict:
        with self._lock:
            return {
                "q_grid": self.q_grid.tolist(),
                "kv_grid": self.kv_grid.tolist(),
                "cells": self._cells.tolist(),
                "ratio": self._ratio.tolist(),
                "prior": self._prior.tolist(),
                "ema": self.ema,
                "n_obs": self._n_obs,
                "version": self._version,
            }

    def load_state_dict(self, d: Dict) -> None:
        """Restore saved calibration.  The state must describe the same
        pool size this calibrator was built for — silently adopting a
        differently-sized ``ratio``/``prior`` would hand the planners a
        wrong-length speeds array (or mis-index servers)."""
        ratio = np.asarray(d["ratio"], np.float64)
        prior = np.asarray(d["prior"], np.float64)
        if ratio.shape != (self.n_servers,) \
                or prior.shape != (self.n_servers,):
            raise ValueError(
                f"calibration state is for a {ratio.shape[0]}-server "
                f"pool, this calibrator has {self.n_servers} servers")
        cells = np.asarray(d["cells"], np.float64)
        q_grid = np.asarray(d["q_grid"], np.float64)
        kv_grid = np.asarray(d["kv_grid"], np.float64)
        if cells.shape != (len(q_grid), len(kv_grid)):
            raise ValueError(
                f"calibration grid {cells.shape} does not match its "
                f"axes ({len(q_grid)}, {len(kv_grid)})")
        with self._lock:
            self.q_grid = q_grid
            self.kv_grid = kv_grid
            self._cells = cells
            self._ratio = ratio
            self._prior = prior
            self.ema = float(d["ema"])
            self._n_obs = int(d["n_obs"])
            self._version = int(d["version"])
            self._snap = None
