"""The reference's ``test_dispatch_equivalence_property``
(``tests/test_cad.py``) for the port: on random layouts and scheduler
tolerances, the port's ``_global_sim`` within f32 atol 2e-5 of the
reference's on the same scheduled plan and numpy q/k/v; and in the same
examples the port's ``ElasticExecutor``, fault-free and with one random
server killed mid-step, bitwise equal to the port's ``_global_sim`` of
the plan the executor ran."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("hypothesis")  # dev extra; property tests only
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import dispatch as JD  # noqa: E402
from repro.core.cost_model import CommModel as JComm  # noqa: E402
from repro.core.plan import CADConfig as JCfg  # noqa: E402
from repro.core.plan import plan_from_schedule  # noqa: E402
from repro.core.scheduler import schedule  # noqa: E402
from repro_torch.cad import CADSession  # noqa: E402
from repro_torch.core import dispatch as D  # noqa: E402
from repro_torch.core.cost_model import CommModel  # noqa: E402
from repro_torch.core.plan import CADConfig, StepPlan  # noqa: E402
from repro_torch.runtime import (ElasticExecutor, FaultSchedule,  # noqa
                                 ServerPool)
from test_torch_dispatch import random_layout  # noqa: E402
from test_torch_helpers import to_numpy, to_torch  # noqa: E402

BLK = 64
JMAX = 4          # kv blocks per task: random_layout's longest document
D_SERVERS, S = 4, 8 * BLK
GEO = dict(n_servers=D_SERVERS, blk=BLK, nb=S // BLK, cq=S // BLK,
           ckv=2 * S // BLK, nkv=4 * S // BLK)
# one geometry for every example, so the reference compiles once
_jax_sim = jax.jit(lambda q, k, v, pos, plan: JD._global_sim(
    q, k, v, pos, plan, JD.CADContext(cfg=JCfg(**GEO), kernel="xla",
                                      jmax=JMAX), 0.0, None))


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10 ** 6), tol=st.sampled_from([0.05, 0.2]))
def test_dispatch_equivalence_property(seed, tol):
    rng = np.random.default_rng(seed)
    d, s, hq, hkv, dh = D_SERVERS, S, 4, 2, 32
    segs, poss = random_layout(rng, d, s)
    jcfg, cfg = JCfg(**GEO), CADConfig(**GEO)
    sch = schedule(segs, blk=BLK, n_servers=d, comm=JComm(hq, dh, hkv),
                   caps=jcfg.caps(), tolerance=tol)
    jplan = plan_from_schedule(jcfg, sch)
    q, k, v = (rng.standard_normal((d, s, h, dh)).astype(np.float32)
               for h in (hq, hkv, hkv))
    posm = np.where(segs > 0, poss, -1).astype(np.int32)
    want = _jax_sim(*(jnp.asarray(x) for x in (q, k, v, posm)),
                    jax.tree.map(jnp.asarray, jplan))
    tq, tk, tv, tpos = (to_torch(x) for x in (q, k, v, posm))
    cad = D.CADContext(cfg=cfg, jmax=JMAX)
    got = D._global_sim(tq, tk, tv, tpos,
                        StepPlan.from_dict(jplan.to_dict()).to("cpu"), cad,
                        0.0, None)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-5)

    sess = CADSession(cfg=cfg, comm=CommModel(hq, dh, hkv), tolerance=tol,
                      jmax=JMAX, prefetch=0)
    plan, _ = sess.plan(segs)
    oracle = to_numpy(D._global_sim(tq, tk, tv, tpos, plan.to("cpu"), cad,
                                    0.0, None)).tobytes()
    victim = int(rng.integers(0, d))
    for spec in ("", f"kill:{victim}@0"):
        ex = ElasticExecutor(sess.with_pool(ServerPool(d)),
                             faults=FaultSchedule.parse(spec))
        out, rep = ex.run_step(0, tq, tk, tv, tpos, segs)
        assert rep.failed == ((victim,) if spec else ())
        assert to_numpy(out).tobytes() == oracle, spec
