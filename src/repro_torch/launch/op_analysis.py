"""Op-level cost analysis of one run of a torch program: the port's
counterpart of ``repro.launch.hlo_analysis``
(``src/repro/launch/hlo_analysis.py``).

The reference parses the text of a compiled XLA module, walks its call
graph and infers each while loop's trip count, because XLA's own
``cost_analysis`` counts a loop body once.  A torch program has no
compiled module: it is the sequence of ops that runs.  :class:`OpCounter`
is a ``TorchDispatchMode`` that sees each of them as it runs (forward,
backward, a remat recompute, the optimizer), so a Python loop over
layers is counted once an iteration and there is no trip count to
infer.  It works on meta tensors (the dry run: shapes, no memory), CPU
tensors and CUDA tensors alike, and counts:

* ``flops``: 2 x the multiply-adds of every product, by the formulas
  ``torch.utils.flop_counter`` registers (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, the convolutions and their backward);
* ``hbm_bytes``: the reference's approximation of memory traffic, the
  operand plus output bytes of each op that computes.  View and
  metadata ops count nothing.  Eager torch runs every op on its own, so
  this counts what XLA's fusions would keep on chip as well;
* ``collective_bytes``: the output bytes of every ``c10d`` collective
  (the tensors its first argument holds: ``all_reduce``'s in place,
  ``all_gather``'s outputs, ``all_to_all_single``'s output), by the
  reference's names in ``collective_breakdown`` and
  ``collective_counts``;
* live bytes: each storage an op creates, from its creation until it is
  freed (a weak reference to the storage).  ``temp_bytes`` is the
  peak of those that the run does not return, ``output_bytes`` the
  bytes of the storages it returns.

Every op's flops and bytes also go to a bucket, the reference's seven
(``launch.breakdown``): an op inside a region (``obs.regions``: attention,
moe_experts, unembed, dispatch; the innermost one) takes the region's
name, also when a remat recompute runs it inside the backward; any other
op of the backward takes the region of the autograd node it runs for
(each node is tagged with the region the forward op that made it ran
in), as ``attention_bwd`` for attention, the region's own name for the
other three and ``bwd_other`` for none; the rest is ``fwd_other``.  A
custom autograd Function's node is tagged where a region marks its
function's results (the attention kernels' and routes' nodes); one made
inside a region but not returned from it (the dispatch's row gathers and
exchanges) keeps no region, and its backward counts as ``bwd_other``.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import sys
import weakref
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.obs import regions

BUCKETS = ("attention", "attention_bwd", "moe_experts", "unembed",
           "dispatch", "bwd_other", "fwd_other")
# the bucket of a backward op, by its node's forward region
_BWD_BUCKET = {"attention": "attention_bwd", "moe_experts": "moe_experts",
               "unembed": "unembed", "dispatch": "dispatch"}

# c10d ops by the reference's collective names (all-gather, all-reduce,
# reduce-scatter, all-to-all, collective-permute; broadcast has none there)
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_coalesced_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
         "send": "collective-permute", "recv_": "collective-permute",
         "broadcast_": "broadcast"}
# ops that move no bytes: allocation without a fill, and metadata
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_local_scalar_dense", "set_", "resize_",
               "record_stream", "_record_function_enter_new",
               "_record_function_exit"}


@dataclasses.dataclass
class OpCost:
    """What one run did: the reference's ``HloCost`` fields (per rank),
    and by bucket; the live-bytes figures; the number of ops."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    flops_by_bucket: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    bytes_by_bucket: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # collective bytes by "<name> | <bucket> | <function>@<file>"
    collective_by_site: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    temp_bytes: float = 0.0
    output_bytes: float = 0.0
    n_ops: int = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out=None) -> List[torch.Tensor]:
    """The tensors in ``x`` (nested lists, tuples and dicts)."""
    if out is None:
        out = []
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _storage_key(t: torch.Tensor):
    try:
        st = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None, None
    return st._cdata, st


def _call_site() -> str:
    """``<function>@<file>`` of the innermost frame of the port outside
    this module and the region marks: the code that asked for a
    collective."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and not name.endswith(
                ("op_analysis.py", "regions.py")):
            short = name[name.rindex("repro_torch") + len("repro_torch/"):]
            return f"{f.f_code.co_name}@{short}"
        f = f.f_back
    return "?"


class OpCounter(TorchDispatchMode):
    """Counts every op run while it is entered (see the module
    docstring); ``cost(result)`` gives the :class:`OpCost`, with the
    output bytes of ``result``."""

    def __init__(self):
        super().__init__()
        self._c = OpCost()
        self._flops = collections.defaultdict(float)
        self._bytes = collections.defaultdict(float)
        self._sites = collections.defaultdict(float)
        self._live: Dict[int, Any] = {}    # storage key -> (uid, bytes, ref)
        self._events: List[tuple] = []     # (uid, +-bytes) in order
        self._uids = itertools.count()
        self._pending: list = []           # last op's outputs to tag
        self._ops: Dict[Any, tuple] = {}    # func -> _op_info

    # ------------------------------------------------------ enter / exit
    def __enter__(self):
        regions.tracking[0] += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            self._tag_pending()
        finally:
            regions.tracking[0] -= 1
        return super().__exit__(*exc)

    # ------------------------------------------------------------ buckets
    @staticmethod
    def bucket() -> str:
        """The bucket of the op about to run (module docstring)."""
        r = regions.current()
        if r is not None:
            return r
        node = torch._C._current_autograd_node()
        if node is not None:
            return _BWD_BUCKET.get(node.metadata.get("region"), "bwd_other")
        return "fwd_other"

    def _tag_pending(self) -> None:
        """Tag the nodes the previous op made (its outputs' ``grad_fn``,
        attached once the op returned through autograd) with the region
        it ran in."""
        for ref, region in self._pending:
            t = ref()
            fn = None if t is None else t.grad_fn
            if fn is not None and "region" not in fn.metadata:
                fn.metadata["region"] = region
        self._pending = []

    # ------------------------------------------------------------- memory
    def _freed(self, key, uid, nbytes):
        def cb(_ref):
            if self._live.get(key, (None,))[0] == uid:
                del self._live[key]
                self._events.append((uid, -nbytes))
        return cb

    def _track(self, outs, in_keys) -> None:
        for t in outs:
            key, st = _storage_key(t)
            if key is None or key in in_keys or key in self._live:
                continue
            n = st.nbytes()
            uid = next(self._uids)
            self._live[key] = (uid, n, weakref.ref(st, self._freed(key, uid,
                                                                    n)))
            self._events.append((uid, n))

    # ----------------------------------------------------------- dispatch
    def _op_info(self, func):
        """(collective name or None, flop formula or None, moves bytes)
        of ``func``, worked out once."""
        info = self._ops.get(func)
        if info is None:
            packet = func._overloadpacket
            name = packet.__name__
            kind = _C10D.get(name) if func.namespace == "c10d" else None
            info = (kind, flop_registry.get(packet),
                    func.namespace != "c10d" and not func.is_view
                    and name not in _NO_TRAFFIC)
            self._ops[func] = info
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._pending:
            self._tag_pending()
        region = regions.current()
        bucket = self.bucket()
        ins = _tensors(kwargs, _tensors(args))
        out = func(*args, **kwargs)
        c = self._c
        c.n_ops += 1
        kind, flop_fn, traffic = self._op_info(func)
        if kind is not None:
            b = float(sum(_nbytes(t) for t in _tensors(args[0])))
            c.collective_bytes += b
            c.collective_breakdown[kind] = \
                c.collective_breakdown.get(kind, 0.0) + b
            c.collective_counts[kind] = \
                c.collective_counts.get(kind, 0.0) + 1
            self._sites[f"{kind} | {bucket} | {_call_site()}"] += b
            c.hbm_bytes += b
            self._bytes[bucket] += b
            return out
        outs = _tensors(out)
        if flop_fn is not None:
            f = float(flop_fn(*args, **kwargs, out_val=out))
            c.flops += f
            self._flops[bucket] += f
        if traffic:
            b = float(sum(_nbytes(t) for t in ins)
                      + sum(_nbytes(t) for t in outs))
            c.hbm_bytes += b
            self._bytes[bucket] += b
        if outs:
            self._track(outs, {_storage_key(t)[0] for t in ins})
            if torch.is_grad_enabled():
                self._pending = [(weakref.ref(t), region) for t in outs]
        return out

    # -------------------------------------------------------------- result
    def cost(self, result=None) -> OpCost:
        """The counts so far; ``result`` (what the run returned) gives
        ``output_bytes`` (the storages of it that the run created) and
        takes them out of ``temp_bytes``."""
        c = dataclasses.replace(self._c)
        c.flops_by_bucket = dict(self._flops)
        c.bytes_by_bucket = dict(self._bytes)
        c.collective_by_site = dict(self._sites)
        out_uids = {}
        for t in _tensors(result):
            key, _ = _storage_key(t)
            if key in self._live:
                uid, n, _ = self._live[key]
                out_uids[uid] = n
        c.output_bytes = float(sum(out_uids.values()))
        live = peak = 0
        for uid, delta in self._events:
            if uid not in out_uids:
                live += delta
                peak = max(peak, live)
        c.temp_bytes = float(peak)
        return c


def analyze(fn, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter` and
    return its :class:`OpCost` (the reference's ``analyze(hlo_text)``)."""
    counter = OpCounter()
    with counter:
        result = fn(*args, **kwargs)
    return counter.cost(result)
