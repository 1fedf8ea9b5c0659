"""Labeled metrics registry: counters, gauges, histograms

A copy of ``repro.obs.metrics``; the port keeps its own so it never imports
the JAX package.
(DESIGN.md §14).

The quantitative half of the flight recorder: where the
:class:`~repro_torch.obs.trace.TraceRecorder` answers "what happened when",
the registry answers "how much, how often, how big" — cumulative
counters (steps, failures, recovered blocks, admissions), point-in-time
gauges (pool epoch, calibration version, predicted imbalance, per-server
calibration residuals) and bucketed histograms (step seconds, queue
waits).

Design mirrors the Prometheus client model, stdlib-only:

  * a metric *family* has a name, a kind, help text and a fixed label
    name tuple; each distinct label-value combination is one series;
  * ``inc``/``set``/``observe`` take the label values as keyword args
    (``reg.counter("cad_failures_total", labels=("server",))
    .inc(server="2")``);
  * export is Prometheus text exposition (``to_text`` — what the serve
    daemon's ``GET /metrics`` returns) and a JSON-able dict
    (``to_dict``/``from_dict`` round-trip exactly — artifact files).

All mutation is lock-protected; reads snapshot under the same lock.
Metric updates never feed back into planning or execution — the
registry is write-only from the runtime's point of view, so recording
can never perturb outputs.

A process-global default registry (``get_registry``) is always live:
single float/dict updates are cheap enough to leave on
unconditionally, unlike tracing.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, Optional, Tuple

COUNTER, GAUGE, HISTOGRAM = "counter", "gauge", "histogram"

#: Default histogram buckets (seconds-flavored, powers of ~4).
DEFAULT_BUCKETS = (1e-4, 4e-4, 1.6e-3, 6.4e-3, 2.56e-2, 0.1024,
                   0.4096, 1.6384, 6.5536)


class _Hist:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets       # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0


class MetricFamily:
    """One named metric and all its labeled series."""

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 help: str, labelnames: Tuple[str, ...],
                 buckets: Tuple[float, ...] = ()):
        self.registry = registry
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self.buckets = buckets
        self._series: Dict[Tuple[str, ...], Any] = {}

    # ------------------------------------------------------------ series
    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if self.kind != COUNTER:
            raise TypeError(f"{self.name} is a {self.kind}, not a counter")
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up "
                             f"(got {amount})")
        key = self._key(labels)
        with self.registry._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def set(self, value: float, **labels: Any) -> None:
        if self.kind != GAUGE:
            raise TypeError(f"{self.name} is a {self.kind}, not a gauge")
        key = self._key(labels)
        with self.registry._lock:
            self._series[key] = float(value)

    def observe(self, value: float, **labels: Any) -> None:
        if self.kind != HISTOGRAM:
            raise TypeError(f"{self.name} is a {self.kind}, not a "
                            f"histogram")
        key = self._key(labels)
        v = float(value)
        with self.registry._lock:
            h = self._series.get(key)
            if h is None:
                h = self._series[key] = _Hist(len(self.buckets) + 1)
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            h.counts[i] += 1
            h.sum += v
            h.count += 1

    # ------------------------------------------------------------- reads
    def value(self, **labels: Any) -> Optional[float]:
        """Current value of one series (histograms: the sum)."""
        key = self._key(labels)
        with self.registry._lock:
            v = self._series.get(key)
        if isinstance(v, _Hist):
            return v.sum
        return v

    def series(self) -> Dict[Tuple[str, ...], Any]:
        with self.registry._lock:
            return dict(self._series)


class MetricsRegistry:
    """All metric families for one process (or one test)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    # ------------------------------------------------------- registration
    def _family(self, name: str, kind: str, help: str,
                labels: Iterable[str],
                buckets: Tuple[float, ...] = ()) -> MetricFamily:
        labelnames = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name} re-registered as {kind}"
                        f"{labelnames}, was {fam.kind}{fam.labelnames}")
                return fam
            fam = MetricFamily(self, name, kind, help, labelnames,
                               buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> MetricFamily:
        return self._family(name, COUNTER, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> MetricFamily:
        return self._family(name, GAUGE, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) \
            -> MetricFamily:
        return self._family(name, HISTOGRAM, help, labels,
                            tuple(float(b) for b in buckets))

    def families(self) -> Tuple[MetricFamily, ...]:
        with self._lock:
            return tuple(self._families[k]
                         for k in sorted(self._families))

    # ------------------------------------------------------------- export
    def to_text(self) -> str:
        """Prometheus text exposition format (``GET /metrics``)."""
        lines = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, val in sorted(fam.series().items()):
                lbl = ",".join(f'{n}="{v}"'
                               for n, v in zip(fam.labelnames, key))
                if fam.kind != HISTOGRAM:
                    lines.append(f"{fam.name}{{{lbl}}} {val:g}" if lbl
                                 else f"{fam.name} {val:g}")
                    continue
                cum = 0
                edges = [f"{b:g}" for b in fam.buckets] + ["+Inf"]
                for i, le in enumerate(edges):
                    cum += val.counts[i]
                    sep = "," if lbl else ""
                    lines.append(
                        f'{fam.name}_bucket{{{lbl}{sep}le="{le}"}} {cum}')
                base = f"{{{lbl}}}" if lbl else ""
                lines.append(f"{fam.name}_sum{base} {val.sum:g}")
                lines.append(f"{fam.name}_count{base} {val.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_dict(self) -> Dict[str, Any]:
        """JSON-able snapshot; ``from_dict`` round-trips it exactly."""
        out: Dict[str, Any] = {}
        for fam in self.families():
            samples = []
            for key, val in sorted(fam.series().items()):
                labels = dict(zip(fam.labelnames, key))
                if fam.kind == HISTOGRAM:
                    samples.append({"labels": labels,
                                    "buckets": list(val.counts),
                                    "sum": val.sum, "count": val.count})
                else:
                    samples.append({"labels": labels, "value": val})
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "labels": list(fam.labelnames),
                             "buckets": list(fam.buckets),
                             "samples": samples}
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MetricsRegistry":
        reg = cls()
        for name, fd in d.items():
            fam = reg._family(name, fd["kind"], fd.get("help", ""),
                              fd.get("labels", ()),
                              tuple(fd.get("buckets", ())))
            for s in fd.get("samples", ()):
                key = fam._key(s.get("labels", {}))
                if fam.kind == HISTOGRAM:
                    h = _Hist(len(fam.buckets) + 1)
                    h.counts = list(s["buckets"])
                    h.sum, h.count = float(s["sum"]), int(s["count"])
                    fam._series[key] = h
                else:
                    fam._series[key] = float(s["value"])
        return reg


# ------------------------------------------------------------ global hook
_default = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global registry the runtime records into."""
    return _default


def set_registry(reg: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Install ``reg`` (None installs a fresh empty registry)."""
    global _default
    with _default_lock:
        _default = reg if reg is not None else MetricsRegistry()
        return _default
