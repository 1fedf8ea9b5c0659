"""What decides ``correct``: the program's first steps against the plain
reference's on the same weights and batches.

The numbers (each compared where the cell's ``limits`` in its workload
file give it a limit, set from the readings ``PERF.md`` gives):

* ``loss_gap``: over the compared steps, the largest
  |loss - reference loss| / reference loss;
* ``grad_gap``: over the tensors, the largest gap between the norm of
  the program's first gradient (each parameter's, summed by a tensor
  hook over the first step's backward) and the reference's, over the
  larger of the reference tensor's norm and the median tensor's;
* ``grad_diff``: over the tensors, the largest norm of the difference
  between the program's first gradient and the reference's, over the
  same denominator: the gap of norms averages rounding away, this does
  not, and it is the number that an fp8 control fails;
* ``change_gap``: as ``grad_gap`` for the norm of each tensor's change
  over the compared steps, as the stored dtype keeps it; tensors whose
  reference gradient is under a thousandth of the median tensor's are
  left out (round-off alone moves them under Adam).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

ZERO_GRAD = 1e-3


def _worst(prog: Dict[str, float], ref: Dict[str, float], keep) -> Tuple:
    names = [n for n in ref if keep(n)]
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, None
    for n in names:
        g = abs(prog.get(n, float("nan")) - ref[n]) / max(ref[n], med)
        if math.isnan(g):
            return g, n
        if g > worst:
            worst, at = g, n
    return worst, at


def gaps(prog, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """(gap, where) of each number; ``prog`` has ``losses``,
    ``grad_norms`` and ``change_norms`` like the reference's result, and
    ``grad_diff_norms``, each tensor's norm of its first gradient less
    the reference's (``grad_diff_norms``)."""
    n = len(ref["losses"])
    lg, at = 0.0, None
    for k in range(n):
        lp = prog["losses"][k] if k < len(prog["losses"]) else float("nan")
        g = abs(lp - ref["losses"][k]) / abs(ref["losses"][k])
        if math.isnan(g):
            lg, at = g, f"step {k}"
            break
        if g > lg:
            lg, at = g, f"step {k}"
    med = statistics.median(ref["grad_norms"].values())
    moved = lambda name: ref["grad_norms"][name] >= ZERO_GRAD * med  # noqa
    dg, dat = 0.0, None
    for name, d in prog.get("grad_diff_norms", {}).items():
        g = d / max(ref["grad_norms"][name], med)
        if math.isnan(g) or g > dg:
            dg, dat = g, name
            if math.isnan(g):
                break
    if not prog.get("grad_diff_norms"):
        dg, dat = float("nan"), "no gradient"
    return {"loss_gap": (lg, at), "grad_diff": (dg, dat),
            "grad_gap": _worst(prog["grad_norms"], ref["grad_norms"],
                               lambda name: True),
            "change_gap": _worst(prog["change_norms"], ref["change_norms"],
                                 moved)}


def grad_diff_norms(against, store=None):
    """A reference's ``on_first_grad`` callback: each tensor's norm of the
    difference between ``against`` (name -> tensor, any device) and the
    reference's first gradient, into ``store``; returns (callback,
    store)."""
    store = {} if store is None else store

    def fn(grads):
        for n, g in grads.items():
            store[n] = float((g - against[n].to(g.device, g.dtype)).norm())
    return fn, store


def against_reference(cell: Dict, obs, expected, seed: int, device,
                      **kw) -> Tuple[Dict, Dict]:
    """The plain reference over the cell's compared steps from the seed's
    weights and the ``expected`` batches, against what the program's drive
    ``obs`` observed: (the reference's result, ``gaps``).  Frees
    ``obs.grad``; ``kw`` goes to ``train_steps`` (a control's precision or
    rows)."""
    from cadbench.reference.model import train_steps
    n_cmp = cell["compare_steps"]
    diff, diffs = grad_diff_norms(obs.grad)
    ref = train_steps(cell["config_file"]["shape"], seed, expected[:n_cmp],
                      cell["train"], device, on_first_grad=diff, **kw)
    obs.grad = None
    prog = {"losses": obs.losses[:n_cmp], "grad_norms": obs.grad_norms,
            "change_norms": obs.change_norms, "grad_diff_norms": diffs}
    return ref, gaps(prog, ref)


def judge(found: Dict[str, Tuple[float, str]], limits: Dict[str, float]):
    """(correct, {name: [value, limit]}) over the numbers that have a
    limit; a NaN fails."""
    checks = {k: [found[k][0], limits[k]] for k in limits}
    ok = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return ok, checks
