"""Named regions of the model's step: the parts the launch tooling's
breakdown buckets time and work by (``launch.breakdown``).

The reference buckets a compiled module's products by the JAX op name of
each one (``src/repro/launch/breakdown.py:19-34``: the einsum strings of
attention, the experts and the unembedding, the all-to-alls of the
dispatch).  A torch program has no op names, so its counterparts mark
where these parts run:

* :func:`region` enters a ``torch.profiler.record_function`` range of
  the region's name (what a profiler trace shows around the kernels the
  region launches) and pushes the name on a stack that a dispatch mode
  reads (``launch.op_analysis``: the op counter buckets each op by the
  innermost region);
* :func:`marked` is the same as a decorator, and also tags the
  ``grad_fn`` of the tensors a marked function returns with its region
  while an op counter runs (``tracking``), so that a custom autograd
  Function's backward (the attention kernels') finds its forward's
  region through ``torch._C._current_autograd_node()``.

The regions: ``attention`` (every attention route and kernel wrapper),
``moe_experts`` (the routed experts' products), ``unembed`` (the logits'
product) and ``dispatch`` (the CAD dispatch's gathers, exchanges and
scatter, around its servers' ``attention``).
"""
from __future__ import annotations

import contextlib
import functools

import torch

REGIONS = ("attention", "moe_experts", "unembed", "dispatch")

#: the regions entered and not yet left, innermost last (one list for
#: every thread: the autograd engine's threads re-run a layer's forward
#: for remat while the caller's thread waits in ``backward``)
_stack: list = []
#: while an op counter runs, ``marked`` tags its results' ``grad_fn``
tracking = [0]


def current():
    """The innermost region entered, or None."""
    return _stack[-1] if _stack else None


def active() -> bool:
    """Whether anything reads the regions: an op counter or a profiler."""
    return bool(tracking[0]) or torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def region(name: str):
    """Run the body inside region ``name`` (one of :data:`REGIONS`); a
    no-op unless an op counter or a profiler runs (:func:`active`)."""
    if not active():
        yield
        return
    with torch.profiler.record_function(name):
        _stack.append(name)
        try:
            yield
        finally:
            _stack.pop()


def tag(out, name: str):
    """Give the ``grad_fn`` of every tensor in ``out`` (a tensor or a
    tuple or list of them) region ``name``, unless it has one."""
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        fn = getattr(t, "grad_fn", None)
        if fn is not None and "region" not in fn.metadata:
            fn.metadata["region"] = name
    return out


def marked(name: str):
    """Decorate a function to run inside region ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with region(name):
                out = fn(*args, **kwargs)
            return tag(out, name) if tracking[0] else out
        return run
    return wrap
