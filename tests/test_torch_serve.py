"""The port's serving stack against the JAX package: the continuous-batching
scheduler (exact), ``Engine.prefill`` and ``Engine.serve`` (f32 tolerance,
greedy tokens equal), and the HTTP daemon on the CPU."""
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core.cost_model import CostModel as JaxCostModel
from repro.models import model as JM
from repro.parallel import ParallelContext
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SchedulerConfig as JaxSchedulerConfig
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.core.cost_model import CostModel
from repro_torch.launch import serve as launch
from repro_torch.serve import (ContinuousScheduler, Engine, Request,
                               SchedulerConfig, ServeConfig)
from test_torch_helpers import MODEL_TOL, load_jax_params, to_numpy

CTX = ParallelContext(attn_impl="ref", remat=False)
PEAK = 989e12     # one explicit peak for both cost models


# ---------------------------------------------------------------- scheduler
def _drive(sched_cls, cfg_cls, req_cls, cm, *, admission, budget, lens,
           max_new, seed):
    """Run a scheduler without a model; log every decision."""
    rng = np.random.default_rng(seed)
    sched = sched_cls(cfg_cls(n_slots=3, max_seq=512, chunk_tokens=256,
                              token_budget=budget, admission=admission,
                              cost_model=cm if admission == "cost" else None))
    for i, n in enumerate(lens):
        sched.submit(req_cls(rid=i, prompt=rng.integers(1, 100, n)
                             .astype(np.int32), max_new_tokens=max_new[i]))
    log = []
    for _ in range(1000):
        if not sched.has_work():
            break
        log.append(("admit", [r.rid for r in sched.admit()]))
        chunk = sched.next_prefill_chunk(fused=True)
        if chunk is not None:
            log.append(("chunk", chunk.tokens.tolist(), chunk.pos.tolist(),
                        chunk.block_req.tolist(), chunk.kv_len_next.tolist(),
                        list(chunk.last_rows)))
            done = sched.commit_prefill(
                chunk, {s: 7 + s for s, _ in chunk.last_rows})
            log.append(("finished", [r.rid for r in done]))
            continue
        log.append(("evict", [r.rid for r in sched.evict_for_budget()]))
        batch = sched.decode_batch()
        if batch is None:
            continue
        log.append(("decode", *(a.tolist() for a in batch)))
        nxt = (np.arange(sched.cfg.n_slots) * 13 + len(log)) % 100
        log.append(("finished", [r.rid for r in sched.commit_decode(nxt)]))
    assert not sched.has_work()
    return log, sched.trace


@pytest.mark.parametrize("admission", ["fcfs", "cost"])
@pytest.mark.parametrize("budget", [None, 700])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_matches_reference(admission, budget, seed):
    rng = np.random.default_rng(100 + seed)
    lens = rng.integers(1, 300, 7).tolist()
    max_new = rng.integers(1, 12, 7).tolist()
    kw = dict(admission=admission, budget=budget, lens=lens,
              max_new=max_new, seed=seed)
    want = _drive(JaxScheduler, JaxSchedulerConfig, JaxRequest,
                  JaxCostModel.analytic(4, 64, peak_flops=PEAK), **kw)
    got = _drive(ContinuousScheduler, SchedulerConfig, Request,
                 CostModel.analytic(4, 64, peak_flops=PEAK), **kw)
    assert got == want


# ------------------------------------------------------------------ engine
VARIANTS = [("llama3-8b", None), ("llama3-8b", 2), ("gemma2-2b", None)]


def _pair(arch, n_kv, scfg_kw, batch_size):
    over = {"n_kv_heads": n_kv} if n_kv else {}
    cfg_j = dataclasses.replace(jax_config(arch).reduced(), **over)
    cfg_t = dataclasses.replace(torch_config(arch).reduced(), **over)
    params = JM.init(jax.random.PRNGKey(0), cfg_j)
    ref = JaxEngine(cfg_j, params, CTX,
                    JaxServeConfig(decode_impl="xla", **scfg_kw),
                    batch_size=batch_size)
    port = Engine(load_jax_params(cfg_t, params),
                  ServeConfig(**scfg_kw), batch_size=batch_size,
                  device="cpu")
    return ref, port, cfg_j.vocab_size


@pytest.mark.parametrize("mode", ["fused", "loop"])
@pytest.mark.parametrize("arch,n_kv", VARIANTS)
def test_prefill_logits_match_reference(arch, n_kv, mode, record_property):
    ref, port, vocab = _pair(arch, n_kv, dict(max_seq=96, chunk_tokens=128),
                             batch_size=3)
    # 70 > 64: gemma2's reduced window cuts the local layers
    prompt = np.random.default_rng(1).integers(1, vocab, (3, 70))
    last_j, full_j = ref.prefill(jax.numpy.asarray(prompt), mode=mode,
                                 return_logits=True)
    last_t, full_t = port.prefill(prompt, mode=mode, return_logits=True)
    np.testing.assert_allclose(to_numpy(full_t), np.asarray(full_j),
                               **MODEL_TOL)
    np.testing.assert_allclose(to_numpy(last_t), np.asarray(last_j),
                               **MODEL_TOL)
    if mode == "fused":
        # fused against the per-token loop inside the port: within the
        # tolerance; whether it is bitwise is recorded, not asserted
        _, loop_t = port.prefill(prompt, mode="loop", return_logits=True)
        np.testing.assert_allclose(to_numpy(full_t), to_numpy(loop_t),
                                   **MODEL_TOL)
        record_property("fused_equals_loop_bitwise",
                        bool((full_t == loop_t).all()))


@pytest.mark.parametrize("arch,n_kv", [("llama3-8b", 2), ("gemma2-2b", None)])
def test_serve_tokens_match_reference(arch, n_kv):
    """Continuous batching through 2 slots: 5 ragged requests, greedy."""
    ref, port, vocab = _pair(arch, n_kv,
                             dict(max_seq=256, max_new_tokens=4,
                                  chunk_tokens=128), batch_size=2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, vocab, n).astype(np.int32)
               for n in (10, 140, 33, 70, 5)]
    want = ref.serve(prompts)
    got = port.serve(prompts)
    assert sorted(got) == sorted(want) == list(range(5))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert port.last_trace == ref.last_trace


# ------------------------------------------------------------------ daemon
def _http(url, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=timeout) as r:
        return r.read().decode()


def test_daemon_http_round_trip():
    args = launch.parse_args(["--arch", "smollm-360m", "--device", "cpu",
                              "--max-seq", "256", "--max-new", "4",
                              "--chunk-tokens", "128", "--slots", "2"])
    daemon = launch.EngineDaemon(launch.build_engine(args))
    srv = launch.make_server(daemon, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 500, n).tolist() for n in (20, 150)]
    try:
        plain = json.loads(_http(url + "/generate", {"prompt": prompts[0]}))
        lines = [json.loads(x) for x in _http(
            url + "/generate", {"prompt": prompts[1], "stream": True,
                                "max_new_tokens": 3}).splitlines()]
        health = json.loads(_http(url + "/health"))
        metrics = _http(url + "/metrics")
        _http(url + "/drain", {})
        for _ in range(100):
            if json.loads(_http(url + "/health"))["status"] == "drained":
                break
            time.sleep(0.05)
        drained = json.loads(_http(url + "/health"))["status"]
        with pytest.raises(urllib.error.HTTPError) as late:
            _http(url + "/generate", {"prompt": [1, 2, 3]})
        # the error holds the response's socket; left open, it is closed
        # whenever the garbage collector gets to it, in whichever later
        # test of this worker that is, and its ResourceWarning (an error
        # under this suite's filterwarnings) fails that test
        late.value.close()
    finally:
        srv.shutdown()
        srv.server_close()
        daemon.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert len(plain["tokens"]) == 4
    # streamed tokens, then a closing line carrying all three
    assert [x["done"] for x in lines] == [False, False, True]
    assert lines[-1]["tokens"][:2] == [x["token"] for x in lines[:-1]]
    assert len(lines[-1]["tokens"]) == 3
    assert health["status"] == "ok" and "serve_rounds_total" in metrics
    assert drained == "drained" and late.value.code == 503
    # the daemon's tokens are the engine's: a fresh engine of the same
    # seed serving each prompt alone gives the same greedy tokens
    solo = launch.build_engine(args)
    assert solo.serve([np.asarray(prompts[0])])[0].tolist() \
        == plain["tokens"]
    assert solo.serve([np.asarray(prompts[1])], max_new_tokens=3)[0] \
        .tolist() == lines[-1]["tokens"]


def test_parse_args_full_width_and_device():
    args = launch.parse_args(["--no-reduced"])
    assert args.reduced is False and args.device == "cuda"
    assert args.arch == "llama3-8b"
    assert launch.parse_args([]).reduced is True
