"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card, ``nvcc`` and the repository's ``src/repro_torch``; without a card it
exits non-zero and prints no result.

Phases, each of which fails the run:

1. the card's name and power limit, the torch and CUDA versions, and the
   build of every kernel source in the checkout (one nvcc per source, all
   started together; timed);
2. every kernel against its plain PyTorch version on the card: the
   serving kernel over the cases the serving path can give it, the
   CA-server forward (out, lse) and backward (dq, dk, dv) over f32/bf16,
   head_dim 64/128, blocks 64/128, GQA factors 1/3/4, ragged and
   overlapping kv ranges, a zero-length task, padded rows, jmax < N, and
   causal / sliding-window+sink / dilated / softcap masks;
3. the serving slice at full width: llama3-8b in bf16 from a seeded
   generator, behind ``launch/serve.py``'s HTTP daemon, answering eight
   requests, with the launch counts read around that run, the kernel held
   against its plain version on captured q and cache tensors, and fused
   prefill against the per-token loop (checked on an f32 copy of the
   weights, reported in bf16);
4. times at the serving path's shapes: the kernel, its plain version, one
   PyTorch library call for the same work and the least time the card
   could take; prefill tokens per second, decode time per step, peak memory;
5. the CAD training step at full width: llama3-8b (depth cut to 8 layers)
   in bf16 through ``trainer.train`` with a ``CADSession`` (4 simulated
   attention servers, 4 x 4096 tokens of ``prolong`` documents, policy
   ``balanced``, prefetch 2), 3 steps with the loss, step time, tokens per
   second, peak memory and the CA-server launch counts of each step,
   checked against servers x layers x forwards per layer; the step-0 loss
   under ``identity`` bitwise equal to ``balanced``'s; the kernels held
   against their plain versions on the server batches captured at layers
   0 and 7; the dispatch's backward repeated bitwise;
6. the CA-server kernels timed at the captured shapes against their
   bound, their plain versions and ``scaled_dot_product_attention`` with
   the equivalent mask (fwd and fwd+bwd).

The line before the card line lists every ported kernel as JSON; the last
line is ``{"ok": true, "device": {...}}``.  ``--only kernels`` stops after
phase 2: the short first call for a new kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): the bounds below divide by these
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# every phase runs on the card; the constant names the device once
DEVICE = "cuda"

F32_ATOL = 1e-5
# bf16 outputs are rounded to 8 significant bits: one rounding step of a
# value near 1 is 2**-8 ~ 4e-3, and the two versions may round a
# different f32 sum
BF16_ATOL = BF16_RTOL = 2e-2
# fused and per-token prefill of one prompt through the 32 layers, on an
# f32 copy of the weights: the two paths sum in other orders (512-row vs
# 4-row matmuls, blk_q 128 vs 1 kernel launches), each f32 rounding
# ~1e-7 relative; bound on max |logit difference| / std(logits).  In bf16
# each matmul output may round one bf16 step apart (2**-8), which 32
# layers carry to ~0.1 of std: reported, not checked.
PREFILL_REL_BOUND = 1e-3


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Median of per-launch CUDA-event times, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# ------------------------------------------------------------ phase 2
def _decode_case(torch, gen, *, dtype, dh, rep, blk_q, window, softcap,
                 hkv=2, R=4, S=1024):
    """Kernel inputs with a dead block, a request at kv_len 0, padded rows
    and ragged lengths, on the card."""
    dev = "cuda"
    hq = hkv * rep
    k = torch.randn(R, S, hkv, dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(R, S, hkv, dh, generator=gen, device=dev).to(dtype)
    kv_len = torch.tensor([1000, 300, 0, 777], dtype=torch.int32,
                          device=dev)
    if blk_q == 1:
        block_req = torch.tensor([0, 1, -1, 2, 3], dtype=torch.int32,
                                 device=dev)
        pos = torch.tensor([999, 299, -1, 0, 776], dtype=torch.int32,
                           device=dev)
    else:
        block_req = torch.tensor([0, 1, -1, 2, 3], dtype=torch.int32,
                                 device=dev)
        rows = [torch.arange(872, 1000), torch.arange(172, 300),
                -torch.ones(128, dtype=torch.long), torch.arange(0, 128),
                torch.arange(649, 777)]
        rows[1][100:] = -1                     # padded rows inside a block
        pos = torch.cat(rows).to(device=dev, dtype=torch.int32)
    t = block_req.shape[0] * blk_q
    q = torch.randn(t, hq, dh, generator=gen, device=dev).to(dtype)
    return dict(q=q, k_cache=k, v_cache=v, block_req=block_req, q_pos=pos,
                kv_len=kv_len, window=window, softcap=softcap)


def _max_err(torch, out, ref, dtype):
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        ok = bool((err <= F32_ATOL).all())
    else:
        ok = bool((err <= BF16_ATOL + BF16_RTOL * ref.float().abs()).all())
    return float(err.max()), ok


def check_ragged_decode_cases(torch, ops):
    """Phase 2: the kernel against ragged_decode_reference on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (64, 128):
            for rep in (1, 4):
                for blk_q in (128, 1):
                    for window, softcap in ((0, 0.0), (256, 0.0),
                                            (0, 50.0), (256, 50.0)):
                        case = _decode_case(torch, gen, dtype=dtype, dh=dh,
                                            rep=rep, blk_q=blk_q,
                                            window=window, softcap=softcap)
                        out = ops.ragged_decode_attention(**case)
                        torch.cuda.synchronize()
                        ref = ops.ragged_decode_reference(**case)
                        torch.cuda.synchronize()
                        err, ok = _max_err(torch, out, ref, dtype)
                        dead = out.reshape(5, blk_q, -1)[2]
                        if not ok or bool(dead.ne(0).any()):
                            raise SystemExit(
                                f"ragged_decode disagrees: dtype={dtype} "
                                f"dh={dh} rep={rep} blk_q={blk_q} "
                                f"window={window} softcap={softcap} "
                                f"max_err={err}")
                        if dtype == torch.float32:
                            worst = max(worst, err)
                        n += 1
    log(f"phase 2: ragged_decode kernel == plain version in {n} cases "
        f"(f32 max |err| {worst:.3e} <= {F32_ATOL}; bf16 within "
        f"atol=rtol={BF16_ATOL})")
    return worst


# ------------------------------------------------------------ phase 3
def _post(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode()


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def fused_vs_loop(torch, engine, prompt):
    """max |dlogit| / std(logit), argmax agreement and bitwise equality of
    the teacher-forced logits of fused and per-token prefill."""
    _, fused = engine.prefill(prompt, mode="fused", return_logits=True)
    _, loop = engine.prefill(prompt, mode="loop", return_logits=True)
    rel = float((fused - loop).abs().max() / fused.std())
    agree = float((fused.argmax(-1) == loop.argmax(-1)).float().mean())
    return rel, agree, bool(torch.equal(fused, loop))


def serve_full_width(torch, np, ops, launch):
    """Phase 3: llama3-8b at full width behind the HTTP daemon."""
    from repro_torch.models.model import Transformer
    from repro_torch.serve import Engine, ServeConfig
    args = launch.parse_args([
        "--arch", "llama3-8b", "--no-reduced", "--device", "cuda",
        "--slots", "4", "--max-seq", "2048", "--chunk-tokens", "512",
        "--max-new", "16", "--seed", "0"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = launch.build_engine(args)
    torch.cuda.synchronize()
    cfg = engine.cfg
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"phase 3: built {cfg.arch_id} ({n_params / 1e9:.3f} B params, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}, "
        f"{engine.model.embed.dtype}) in {time.perf_counter() - t0:.1f} s")

    last = cfg.n_layers - 1
    captured = {}

    def capture(layer, inputs):
        if layer not in (0, last):
            return
        blk_q = inputs["q"].shape[0] // inputs["block_req"].shape[0]
        key = ("prefill" if blk_q > 1 else "decode", layer)
        if key not in captured:
            captured[key] = {k: v.clone() if torch.is_tensor(v) else v
                             for k, v in inputs.items()}

    engine.model.attn_hook = capture
    daemon = launch.EngineDaemon(engine)
    srv = launch.make_server(daemon, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1901, 8)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    results = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            body = {"prompt": prompts[i], "max_new_tokens": 16}
            if i == 0:
                body["stream"] = True
                lines = [json.loads(x) for x in
                         _post(url + "/generate", body).splitlines()]
                if not lines[-1].get("done"):
                    raise RuntimeError(f"stream did not close: {lines[-1]}")
                results[i] = lines[-1]["tokens"]
            else:
                results[i] = json.loads(_post(url + "/generate",
                                              body))["tokens"]
        except Exception as e:         # reported below; fails the run
            errors.append(f"request {i}: {e!r}")

    try:
        ops.reset_launches()
        engine.n_chunk_calls = 0
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launches["ragged_decode"]
        calls = engine.n_chunk_calls
        _post(url + "/drain", {})
        health = _get(url + "/health")
    finally:
        srv.shutdown()
        srv.server_close()
        daemon.stop()
        engine.model.attn_hook = None
    if errors or any(c.is_alive() for c in clients):
        raise SystemExit(f"phase 3: requests failed: {errors}")
    for i, toks in enumerate(results):
        if len(toks) != 16 or not all(0 <= t < cfg.vocab_size
                                      for t in toks):
            raise SystemExit(f"phase 3: request {i} returned {toks}")
    if health["status"] != "drained":
        raise SystemExit(f"phase 3: /health after /drain: {health}")
    if launches != cfg.n_layers * calls or calls == 0:
        raise SystemExit(f"phase 3: {launches} kernel launches for {calls} "
                         f"device calls of {cfg.n_layers} layers")
    n_prompt = int(lens.sum())
    log(f"phase 3: served {len(prompts)} HTTP requests (prompts "
        f"{sorted(int(n) for n in lens)}, {n_prompt} prompt tokens, 16 new "
        f"each, one streamed) in {wall:.2f} s; {calls} device calls, "
        f"ragged_decode launches {launches} = {cfg.n_layers} x {calls}; "
        f"/health after /drain: {health['status']}")

    # the kernel against its plain version on the captured real tensors
    worst = 0.0
    for key in sorted(captured):
        inputs = captured[key]
        out = ops.ragged_decode_attention(**inputs)
        ref = ops.ragged_decode_reference(**inputs)
        torch.cuda.synchronize()
        err, ok = _max_err(torch, out, ref, out.dtype)
        log(f"  captured {key[0]} layer {key[1]}: q {tuple(inputs['q'].shape)}"
            f" cache {tuple(inputs['k_cache'].shape)} max |err| {err:.3e}")
        if not ok:
            raise SystemExit(f"phase 3: kernel disagrees on captured {key}")
        worst = max(worst, err)
    if len(captured) != 4:
        raise SystemExit(f"phase 3: captured {sorted(captured)}")

    # fused prefill against the per-token loop on one short prompt, in
    # bf16 (reported) and on an f32 copy of the same weights (checked)
    prompt = rng.integers(1, cfg.vocab_size, (engine.batch_size, 40))
    rel, agree, bitwise = fused_vs_loop(torch, engine, prompt)
    log(f"  fused vs loop prefill, bf16 (40 tokens x {engine.batch_size}): "
        f"max |dlogit| / std(logit) = {rel:.4f}; argmax agreement "
        f"{agree:.4f}; bitwise {bitwise}")
    model32 = Transformer(dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"), device="meta")
    model32.to_empty(device=engine.device)
    model32.load_state_dict(engine.model.state_dict())
    engine32 = Engine(model32,
                      ServeConfig(max_seq=128, chunk_tokens=512),
                      batch_size=engine.batch_size, device=engine.device)
    rel32, agree32, bitwise32 = fused_vs_loop(torch, engine32, prompt)
    log(f"  fused vs loop prefill, f32 copy: max |dlogit| / std(logit) = "
        f"{rel32:.3e} (bound {PREFILL_REL_BOUND}); argmax agreement "
        f"{agree32:.4f}; bitwise {bitwise32}")
    del engine32, model32
    torch.cuda.empty_cache()
    if not rel32 <= PREFILL_REL_BOUND:
        raise SystemExit("phase 3: fused and loop prefill disagree")
    return engine, launches, worst


# ------------------------------------------------------------ phase 4
def _attn_work(torch, q, kv_len, block_req, pos, hkv, dtype_bytes):
    """Bytes and FLOPs this call's data needs: q read and out written once,
    each referenced request's live K/V rows read once; 4 FLOPs per
    (row, visible slot, q head, dh)."""
    t, hq, dh = q.shape
    blk_q = t // block_req.shape[0]
    req = block_req.long().repeat_interleave(blk_q)
    rows = (pos >= 0) & (req >= 0)
    lens = kv_len.long()[req.clamp(min=0)]
    visible = torch.minimum(pos.long() + 1, lens).clamp(min=0)[rows]
    used = torch.unique(block_req[block_req >= 0].long())
    kv_rows = int(kv_len.long()[used].sum())
    nbytes = 2 * t * hq * dh * dtype_bytes + 2 * kv_rows * hkv * dh \
        * dtype_bytes
    flops = 4.0 * float(visible.sum()) * hq * dh
    return nbytes, flops


def kernel_times(torch, ops, card):
    """Phase 4a: the kernel at the main path's shapes, with its bound, the
    plain version and scaled_dot_product_attention as a yardstick."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev, dt = "cuda", torch.bfloat16
    R, S, hq, hkv, dh = 4, 2048, 32, 8, 128
    k = torch.randn(R, S, hkv, dh, generator=gen, device=dev).to(dt)
    v = torch.randn(R, S, hkv, dh, generator=gen, device=dev).to(dt)
    shapes = {
        # one 512-token prefill chunk: 4 q blocks, request b's positions
        # 1920..2047 against its kv 0..2047
        "prefill": (torch.arange(4, dtype=torch.int32),
                    torch.arange(1920, 2048).repeat(4),
                    torch.full((R,), 2048)),
        # a 4-request decode step at kv 2000
        "decode": (torch.arange(4, dtype=torch.int32),
                   torch.full((4,), 1999), torch.full((R,), 2000)),
    }
    out = {}
    for name, (block_req, pos, kv_len) in shapes.items():
        block_req = block_req.to(dev)
        pos = pos.to(dev, torch.int32)
        kv_len = kv_len.to(dev, torch.int32)
        q = torch.randn(pos.shape[0], hq, dh, generator=gen,
                        device=dev).to(dt)
        args = dict(q=q, k_cache=k, v_cache=v, block_req=block_req,
                    q_pos=pos, kv_len=kv_len)
        nbytes, flops = _attn_work(torch, q, kv_len, block_req, pos, hkv, 2)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        bound_ms = 1e3 * max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        # the yardstick's inputs in its own layout, made before timing
        nq, blk_q = block_req.shape[0], q.shape[0] // block_req.shape[0]
        kl = int(kv_len[0])
        qs = q.reshape(nq, blk_q, hq, dh).transpose(1, 2).contiguous()
        ks = k[:, :kl].transpose(1, 2).contiguous()
        vs = v[:, :kl].transpose(1, 2).contiguous()
        qpos = pos.reshape(nq, blk_q)[0]
        mask = (torch.arange(kl, device=dev)[None, :] <= qpos[:, None])
        mask = mask[None, None]
        ms = cuda_ms(lambda: ops.ragged_decode_attention(**args))
        plain_ms = cuda_ms(lambda: ops.ragged_decode_reference(**args),
                           iters=10)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True))
        ms2 = cuda_ms(lambda: ops.ragged_decode_attention(**args))
        out[name] = dict(ms=min(ms, ms2), plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=lib_ms, bytes=nbytes, flops=flops)
        log(f"phase 4: ragged_decode {name} (q {tuple(q.shape)}, cache "
            f"{tuple(k.shape)} bf16, kv {kl}): kernel {ms:.4f} / "
            f"{ms2:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP) [{card}]")
    return out


def engine_times(torch, np, engine, card):
    """Phase 4b: prefill tokens/s, decode ms per step, peak memory."""
    cfg = engine.cfg
    b = engine.batch_size
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(2)
    prompt = rng.integers(1, cfg.vocab_size, (b, 1900))
    engine.prefill(prompt)                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill(prompt)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    short = prompt[:, :1900 - 16]
    t0 = time.perf_counter()
    engine.prefill(short)
    torch.cuda.synchronize()
    t_short = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.generate(short)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    steps = engine.scfg.max_new_tokens - 1
    decode_ms = 1e3 * (t_gen - t_short) / steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"phase 4: prefill {b} x 1900 tokens in {t_prefill:.3f} s = "
        f"{b * 1900 / t_prefill:.0f} tokens/s; decode {decode_ms:.2f} ms "
        f"per step at batch {b}, kv ~1900 ({steps} steps); peak memory "
        f"{peak:.2f} GiB [{card}]")


# ------------------------------------------------------------ phase 2 (CA)
# CA-server gradients: max |err| over the tensor's largest magnitude
CA_GRAD_RTOL = 1e-4
CA_MASKS = {"causal": dict(),
            "sliding+sink": dict(window="1.5blk", sink=8),
            "dilated": dict(rate=2),
            "softcap": dict(softcap=30.0)}
CA_JMAX = 4            # below N, and below some tasks' kv_len


def _ca_case(torch, np, seed, *, dtype, dh, blk, rep, mask, hkv=2, T=7,
             N=10):
    """CA-server inputs on the card: ragged, overlapping kv ranges, a
    zero-length task, padded q rows and kv slots, jmax < N."""
    rng = np.random.default_rng(seed)
    hq = hkv * rep
    kv_start = np.zeros(T, np.int32)
    kv_len = np.zeros(T, np.int32)
    q_pos = np.zeros((T, blk), np.int32)
    kv_pos = np.tile(np.arange(blk, dtype=np.int32), (N, 1))
    for t in range(T):
        ln = int(rng.integers(1, 6))
        st = int(rng.integers(0, N - ln + 1))
        kv_start[t], kv_len[t] = st, ln
        q_pos[t] = np.arange((ln - 1) * blk, ln * blk)
        for jj in range(ln):
            kv_pos[st + jj] = np.arange(jj * blk, (jj + 1) * blk)
    kv_len[-1] = 0                      # zero-length task
    q_pos[-1] = -1
    q_pos[0, blk // 2:] = -1            # padded rows of a live task
    kv_pos[int(kv_start[1]), blk - 5:] = -1   # padded kv slots
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = DEVICE

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    opts = {"window": 0, "sink": 0, "rate": 1, "softcap": 0.0,
            **CA_MASKS[mask]}
    if opts["window"] == "1.5blk":
        opts["window"] = blk + blk // 2
    args = dict(q_tasks=rnd(T, blk, hq, dh), k_buf=rnd(N, blk, hkv, dh),
                v_buf=rnd(N, blk, hkv, dh),
                kv_start=torch.tensor(kv_start, device=dev),
                kv_len=torch.tensor(kv_len, device=dev),
                q_pos=torch.tensor(q_pos, device=dev),
                kv_pos=torch.tensor(kv_pos, device=dev))
    return args, dict(jmax=CA_JMAX, **opts), rnd(T, blk, hq, dh)


def _grad_err(torch, got, ref, dtype):
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        scale = max(1.0, float(ref.float().abs().max()))
        return float(err.max()), bool(err.max() <= CA_GRAD_RTOL * scale)
    return float(err.max()), bool(
        (err <= BF16_ATOL + BF16_RTOL * ref.float().abs()).all())


def check_ca_pair(torch, ops, args, opts, do):
    """Kernel fwd (out, lse) and bwd (dq, dk, dv) against the plain
    versions on the same inputs; the backward of both starts from the
    plain version's (out, lse).  Returns (fwd err, grad err, ok)."""
    dtype = args["q_tasks"].dtype
    out, lse = ops.ca_server_fwd(**args, **opts)
    ref_out, ref_lse = ops.ca_server_fwd_reference(**args, **opts)
    torch.cuda.synchronize()
    e_out, ok_out = _max_err(torch, out, ref_out, dtype)
    e_lse, ok_lse = _max_err(torch, lse, ref_lse.float(), dtype)
    bwd_in = (args["q_tasks"], args["k_buf"], args["v_buf"], ref_out,
              ref_lse.float().contiguous(), do, args["kv_start"],
              args["kv_len"], args["q_pos"], args["kv_pos"])
    got = ops.ca_server_bwd(*bwd_in, **opts)
    want = ops.ca_server_bwd_reference(*bwd_in, **opts)
    torch.cuda.synchronize()
    g_errs = [_grad_err(torch, a, b, dtype) for a, b in zip(got, want)]
    dead = args["kv_len"] == 0
    dead_ok = bool((out[dead] == 0).all()) and bool(
        (lse[dead] == ops.LSE_DEAD).all())
    ok = ok_out and ok_lse and dead_ok and all(o for _, o in g_errs)
    return max(e_out, e_lse), max(e for e, _ in g_errs), ok


def check_ca_server_cases(torch, np, ops):
    """Phase 2: the CA-server kernels against their plain versions."""
    worst_fwd = worst_bwd = 0.0
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (64, 128):
            for blk in (64, 128):
                for rep in (1, 3, 4):
                    for mask in CA_MASKS:
                        args, opts, do = _ca_case(torch, np, n, dtype=dtype,
                                                  dh=dh, blk=blk, rep=rep,
                                                  mask=mask)
                        e_f, e_b, ok = check_ca_pair(torch, ops, args, opts,
                                                     do)
                        if not ok:
                            raise SystemExit(
                                f"ca_server disagrees: dtype={dtype} dh={dh}"
                                f" blk={blk} rep={rep} mask={mask} fwd err "
                                f"{e_f} grad err {e_b}")
                        if dtype == torch.float32:
                            worst_fwd = max(worst_fwd, e_f)
                            worst_bwd = max(worst_bwd, e_b)
                        n += 1
    log(f"phase 2: ca_server fwd + bwd kernels == plain versions in {n} "
        f"cases (f32 max |err| out/lse {worst_fwd:.3e} <= {F32_ATOL}, "
        f"grads {worst_bwd:.3e} <= {CA_GRAD_RTOL} x max(1, max |grad|); "
        f"bf16 within atol=rtol={BF16_ATOL})")
    return worst_fwd, worst_bwd


# ------------------------------------------------------------ phase 5
TRAIN_LAYERS = 8          # of llama3-8b's 32: what one card's memory holds
TRAIN_STEPS = 3


def _train_setup():
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig
    from repro_torch.train.trainer import TrainConfig
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=TRAIN_LAYERS)
    pipe = PipelineConfig(distribution="prolong", max_doc_len=4096,
                          seq_len=4096, global_batch=4, n_ranks=4,
                          vocab_size=cfg.vocab_size, seed=0)
    tc = TrainConfig(steps=TRAIN_STEPS, peak_lr=3e-4, warmup=1,
                     log_every=1, seed=0)

    def session(policy):
        return CADSession.for_pipeline(cfg, pipe, plan_policy=policy,
                                       prefetch=2)
    return cfg, pipe, tc, session


def train_full_width(torch, ops, card):
    """Phase 5: the CAD training step at llama3-8b width on the card."""
    from repro_torch.models.model import Transformer
    from repro_torch.train.trainer import train
    cfg, pipe, tc, session = _train_setup()
    n_servers = pipe.n_ranks
    tokens = pipe.global_batch * pipe.seq_len

    # the step-0 loss under the identity plan (a fresh model, same seed)
    res = train(cfg, pipe, dataclasses.replace(tc, steps=1),
                session=session("identity"), device=DEVICE)
    loss_identity = res["history"][0]["loss"]
    del res
    gc.collect()
    torch.cuda.empty_cache()

    model = Transformer(cfg, device=DEVICE, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    captured = {}

    def capture(layer, inputs):
        if layer in (0, cfg.n_layers - 1) and layer not in captured:
            captured[layer] = {k: v.detach().clone() if torch.is_tensor(v)
                               else v for k, v in inputs.items()}

    expect = {"ca_server_fwd": n_servers * cfg.n_layers * 2,   # + remat
              "ca_server_bwd_dq": n_servers * cfg.n_layers,
              "ca_server_bwd_dkv": n_servers * cfg.n_layers}
    steps = []

    def on_step(step, m):
        counts = {k: ops.launches[k] for k in expect}
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        model.attn_hook = None              # capture step 0 only
        steps.append(dict(m, counts=counts, peak_gib=mem))
        log(f"phase 5: step {step} loss {m['loss']:.6f} gnorm "
            f"{m['grad_norm']:.4f} step {1e3 * m['step_s']:.1f} ms "
            f"{tokens / m['step_s']:.0f} tokens/s peak "
            f"{mem:.2f} GiB launches {counts} plan max/mean "
            f"{m.get('sched_load_max_over_mean', float('nan')):.3f} "
            f"[{card}]")

    log(f"phase 5: llama3-8b width, {cfg.n_layers} of 32 layers "
        f"({n_params / 1e9:.3f} B params, bf16), {n_servers} attention "
        f"servers, {pipe.global_batch} x {pipe.seq_len} tokens "
        f"({pipe.distribution}), step-0 identity loss {loss_identity!r}")
    model.attn_hook = capture
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = train(cfg, pipe, tc, model=model, session=session("balanced"),
                device=DEVICE, on_step=on_step)
    del res, model
    gc.collect()
    torch.cuda.empty_cache()
    for s in steps:
        if s["counts"] != expect:
            raise SystemExit(f"phase 5: step {s['step']} launches "
                             f"{s['counts']} != {expect}")
        if not math.isfinite(s["loss"]):
            raise SystemExit(f"phase 5: step {s['step']} loss {s['loss']}")
    if steps[0]["loss"] != loss_identity:
        raise SystemExit(f"phase 5: step-0 loss {steps[0]['loss']!r} under "
                         f"balanced != {loss_identity!r} under identity")
    if sorted(captured) != [0, cfg.n_layers - 1]:
        raise SystemExit(f"phase 5: captured layers {sorted(captured)}")
    log(f"phase 5: launches per step = {expect} (servers x layers x "
        f"{{2 forwards with remat, 1 backward}}); step-0 loss bitwise equal "
        f"under identity and balanced")
    total = {k: sum(s["counts"][k] for s in steps) for k in expect}
    return steps, captured, total


def captured_batches(torch, captured):
    """The per-server kernel inputs of each captured layer."""
    from repro_torch.core import dispatch
    out = {}
    for layer, inp in sorted(captured.items()):
        pos = torch.where(inp["segment_ids"] > 0, inp["positions"], -1) \
            .to(torch.int32)
        cad = inp["ctx"].cad
        out[layer] = dispatch.server_batches(inp["q"], inp["k"], inp["v"],
                                             pos, cad.plan, cad)
    return out


def check_captured(torch, ops, captured, batches):
    """Phase 5: the kernels against the plain versions on the captured
    server batches (bf16), and the dispatch's backward repeated bitwise."""
    from repro_torch.core import dispatch
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    worst = 0.0
    for layer, per_server in batches.items():
        for s, b in enumerate(per_server):
            args = {k: b[k] for k in ("q_tasks", "k_buf", "v_buf",
                                      "kv_start", "kv_len", "q_pos",
                                      "kv_pos")}
            opts = {k: b[k] for k in ("jmax", "window", "sink", "rate")}
            do = torch.randn(b["q_tasks"].shape, generator=gen,
                             device=DEVICE).to(b["q_tasks"].dtype)
            e_f, e_b, ok = check_ca_pair(torch, ops, args, opts, do)
            log(f"  captured layer {layer} server {s}: q_tasks "
                f"{tuple(b['q_tasks'].shape)} k_buf "
                f"{tuple(b['k_buf'].shape)} jmax {b['jmax']}: fwd max "
                f"|err| {e_f:.3e}, grads {e_b:.3e}")
            if not ok:
                raise SystemExit(f"phase 5: kernels disagree on captured "
                                 f"layer {layer} server {s}")
            worst = max(worst, e_f)
    # the gather/scatter around the kernels: autograd's backward of the
    # index gathers is index_put(accumulate=True); repeated runs must
    # give the same bits
    inp = captured[0]
    cad = inp["ctx"].cad
    pos = torch.where(inp["segment_ids"] > 0, inp["positions"], -1) \
        .to(torch.int32)
    g = torch.randn(inp["q"].shape, generator=gen, device=DEVICE) \
        .to(inp["q"].dtype)
    runs = []
    for _ in range(2):
        q, k, v = (inp[n].clone().requires_grad_() for n in "qkv")
        out = dispatch._global_sim(q, k, v, pos, cad.plan, cad, 0.0, None)
        runs.append((out, *torch.autograd.grad(out, (q, k, v), g)))
    bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
    log(f"phase 5: dispatch fwd+bwd on layer 0's q/k/v repeated: bitwise "
        f"{bitwise} (deterministic algorithms "
        f"{torch.are_deterministic_algorithms_enabled()})")
    if not bitwise:
        raise SystemExit("phase 5: the dispatch backward is not "
                         "deterministic")
    return worst


# ------------------------------------------------------------ phase 6
def _ca_work(torch, b):
    """The live (q, kv) pairs of one server batch as a boolean
    [T*blk, N*blk] mask, and the bytes each function must move: the
    inputs only on the q rows and kv slots that some live pair reads
    (empty task slots, padded rows and kv blocks no task covers need none
    of theirs), the outputs whole, since the function returns them whole
    (out 0 and lse LSE_DEAD on dead rows, zero gradients where no pair
    reaches).  Returns (vis, pairs, (fwd bytes, fwd FLOPs), (bwd bytes,
    bwd FLOPs), bytes breakdown)."""
    q, k = b["q_tasks"], b["k_buf"]
    T, blk, hq, dh = q.shape
    N, _, hkv, _ = k.shape
    dev = q.device
    n_blk = torch.clamp(b["kv_len"].long(), max=b["jmax"])
    start = b["kv_start"].long()
    row_task = torch.arange(T * blk, device=dev) // blk
    col_blk = torch.arange(N * blk, device=dev) // blk
    in_range = (col_blk[None] >= start[row_task][:, None]) \
        & (col_blk[None] < (start + n_blk)[row_task][:, None])
    pq = b["q_pos"].reshape(-1).long()[:, None]
    pk = b["kv_pos"].reshape(-1).long()[None]
    vis = in_range & (pq >= pk) & (pq >= 0) & (pk >= 0)
    del in_range
    pairs = int(vis.sum())
    q_rows = int(vis.any(1).sum())          # q rows some pair reads
    kv_rows = int(vis.any(0).sum())         # kv slots some pair reads
    el = q.element_size()
    q_row, kv_row = hq * dh * el, hkv * dh * el      # one row, one tensor
    lse_row = hq * 4
    meta = sum(b[n].numel() * 4 for n in ("kv_start", "kv_len", "q_pos",
                                          "kv_pos"))
    # fwd reads q, k, v and writes out, lse
    fwd_in = q_rows * q_row + kv_rows * 2 * kv_row + meta
    fwd_out = T * blk * (q_row + lse_row)
    # bwd reads q, k, v, out, lse, do and writes dq, dk, dv
    bwd_in = q_rows * (3 * q_row + lse_row) + kv_rows * 2 * kv_row + meta
    bwd_out = q.numel() * el + 2 * k.numel() * el
    info = dict(live_tasks=int((b["kv_len"] > 0).sum()), q_rows=q_rows,
                kv_rows=kv_rows, fwd_in=fwd_in,
                fwd_out=fwd_out, bwd_in=bwd_in, bwd_out=bwd_out)
    return vis, pairs, (fwd_in + fwd_out, 4.0 * pairs * hq * dh), \
        (bwd_in + bwd_out, 10.0 * pairs * hq * dh), info


def _bound(nbytes, flops):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def ca_kernel_times(torch, ops, batches, card):
    """Phase 6: the CA-server kernels at layer 0's captured shapes (the 4
    servers' batches of one layer, summed): kernel, plain version,
    scaled_dot_product_attention with the equivalent boolean mask (the
    memory-efficient backend; the port never calls it) and the bound."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    tot = {k: 0.0 for k in ("fwd", "bwd", "plain_fwd", "plain_bwd",
                            "sdpa_fwd", "sdpa_fwd_bwd", "fwd_bytes",
                            "fwd_flops", "bwd_bytes", "bwd_flops",
                            "pairs", "live_tasks", "q_rows", "kv_rows",
                            "fwd_in", "fwd_out", "bwd_in", "bwd_out")}
    for s, b in enumerate(batches[0]):
        args = {k: b[k] for k in ("q_tasks", "k_buf", "v_buf", "kv_start",
                                  "kv_len", "q_pos", "kv_pos")}
        opts = {k: b[k] for k in ("jmax", "window", "sink", "rate")}
        q, k, v = args["q_tasks"], args["k_buf"], args["v_buf"]
        T, blk, hq, dh = q.shape
        N, _, hkv, _ = k.shape
        do = torch.randn(q.shape, generator=gen, device=DEVICE).to(q.dtype)
        out, lse = ops.ca_server_fwd(**args, **opts)
        bwd_in = (q, k, v, out, lse, do, args["kv_start"], args["kv_len"],
                  args["q_pos"], args["kv_pos"])
        vis, pairs, fwd_w, bwd_w, info = _ca_work(torch, b)
        t = {"fwd": cuda_ms(lambda: ops.ca_server_fwd(**args, **opts),
                            iters=10),
             "bwd": cuda_ms(lambda: ops.ca_server_bwd(*bwd_in, **opts),
                            iters=10),
             "plain_fwd": cuda_ms(lambda: ops.ca_server_fwd_reference(
                 **args, **opts), iters=2, warmup=1),
             "plain_bwd": cuda_ms(lambda: ops.ca_server_bwd_reference(
                 *bwd_in, **opts), iters=2, warmup=1)}
        # the yardstick's inputs in its own layout, made before timing
        qs = q.reshape(T * blk, hq, dh).transpose(0, 1)[None].contiguous()
        ks, vs = (x.reshape(N * blk, hkv, dh).repeat_interleave(
            hq // hkv, dim=1).transpose(0, 1)[None].contiguous()
            for x in (k, v))
        dos = do.reshape(T * blk, hq, dh).transpose(0, 1)[None] \
            .contiguous()
        mask = vis[None, None]
        qg, kg, vg = (x.clone().requires_grad_() for x in (qs, ks, vs))

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
            return torch.autograd.grad(o, (qg, kg, vg), dos)

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            t["sdpa_fwd"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask), iters=5)
            t["sdpa_fwd_bwd"] = cuda_ms(sdpa_fwd_bwd, iters=5)
        t["fwd"] = min(t["fwd"], cuda_ms(
            lambda: ops.ca_server_fwd(**args, **opts), iters=10))
        del vis, mask, qs, ks, vs, dos, qg, kg, vg
        torch.cuda.empty_cache()
        f_bound = _bound(*fwd_w)
        b_bound = _bound(*bwd_w)
        log(f"phase 6: layer 0 server {s}: T {T} x blk {blk} "
            f"({info['live_tasks']} live tasks, {info['q_rows']} q rows "
            f"read), kv buffer {N} blocks ({info['kv_rows']} slots read), "
            f"{pairs} live pairs; "
            f"fwd reads {info['fwd_in'] / 1e6:.1f} MB, writes "
            f"{info['fwd_out'] / 1e6:.1f} MB; bwd reads "
            f"{info['bwd_in'] / 1e6:.1f} MB, writes "
            f"{info['bwd_out'] / 1e6:.1f} MB; fwd kernel {t['fwd']:.3f} ms "
            f"(bound {f_bound[0]:.4f} {f_bound[1]}), plain "
            f"{t['plain_fwd']:.3f}, sdpa {t['sdpa_fwd']:.3f}; bwd kernel "
            f"{t['bwd']:.3f} ms (bound {b_bound[0]:.4f} {b_bound[1]}), "
            f"plain {t['plain_bwd']:.3f}, sdpa fwd+bwd "
            f"{t['sdpa_fwd_bwd']:.3f} [{card}]")
        for key, val in t.items():
            tot[key] += val
        tot["fwd_bytes"] += fwd_w[0]
        tot["fwd_flops"] += fwd_w[1]
        tot["bwd_bytes"] += bwd_w[0]
        tot["bwd_flops"] += bwd_w[1]
        tot["pairs"] += pairs
        for key, val in info.items():
            tot[key] += val
    f_bound = _bound(tot["fwd_bytes"], tot["fwd_flops"])
    b_bound = _bound(tot["bwd_bytes"], tot["bwd_flops"])
    log(f"phase 6: one layer's CA work (4 servers, {int(tot['live_tasks'])} "
        f"live tasks, {int(tot['q_rows'])} q rows and {int(tot['kv_rows'])} "
        f"kv slots read, {int(tot['pairs'])} live pairs): fwd "
        f"{tot['fwd']:.3f} ms = "
        f"{tot['fwd_flops'] / tot['fwd'] / 1e9:.2f} TFLOP/s (bound "
        f"{f_bound[0]:.4f} ms, {f_bound[1]}: {tot['fwd_bytes'] / 1e6:.1f} "
        f"MB, {tot['fwd_flops'] / 1e9:.1f} GFLOP), bwd {tot['bwd']:.3f} ms "
        f"= {tot['bwd_flops'] / tot['bwd'] / 1e9:.2f} TFLOP/s (bound "
        f"{b_bound[0]:.4f} ms, {b_bound[1]}: {tot['bwd_bytes'] / 1e6:.1f} "
        f"MB, {tot['bwd_flops'] / 1e9:.1f} GFLOP) [{card}]")
    return tot, f_bound, b_bound


# ---------------------------------------------------------------- main
def build_kernels(build, ops):
    """Phase 1: build every kernel source, one nvcc each, all at once."""
    loaders = {"ragged_decode": ops.load_library,
               "ca_server": ops.load_ca_server_library}
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:          # reported below; fails the run
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(fn,))
               for fn in loaders.values()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise SystemExit("phase 1: kernel build failed: " + "; ".join(errors))
    log(f"phase 1: built {len(loaders)} kernel sources in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in loaders:
        seconds, report = build.build_info[name]
        log(f"  {name}.cu: nvcc {seconds:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas: " + line.strip())


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", choices=("kernels",), default=None,
                   help="stop after the kernel checks (phases 1-2)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.packed_flash import ops
    from repro_torch.launch import serve as launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    build_kernels(build, ops)

    f32_err = check_ragged_decode_cases(torch, ops)
    ca_fwd_err, ca_bwd_err = check_ca_server_cases(torch, np, ops)
    src = "src/repro_torch/kernels/packed_flash/csrc/"
    kernel = {"name": "ragged_decode", "route": "cuda",
              "source": src + "ragged_decode.cu",
              "replaces": "src/repro/kernels/packed_flash/kernel.py:457",
              "max_abs_err": f32_err}
    ca_fwd = {"name": "ca_server_fwd", "route": "cuda",
              "source": src + "ca_server.cu",
              "replaces": "src/repro/kernels/packed_flash/kernel.py:610",
              "max_abs_err": ca_fwd_err}
    ca_bwd = {"name": "ca_server_bwd", "route": "cuda",
              "source": src + "ca_server.cu",
              "replaces": "src/repro/kernels/packed_flash/kernel.py:763",
              "max_abs_err": ca_bwd_err}
    if args.only != "kernels":
        engine, launches, captured_err = serve_full_width(torch, np, ops,
                                                          launch)
        times = kernel_times(torch, ops, card)
        engine_times(torch, np, engine, card)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        prefill = times["prefill"]
        kernel.update(launches=launches, ms=prefill["ms"],
                      plain_ms=prefill["plain_ms"],
                      bound_ms=prefill["bound_ms"],
                      bound_by=prefill["bound_by"],
                      library_ms=prefill["library_ms"],
                      captured_max_abs_err=captured_err,
                      decode={k: times["decode"][k] for k in
                              ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")})

        steps, captured, ca_launches = train_full_width(torch, ops, card)
        batches = captured_batches(torch, captured)
        ca_captured_err = check_captured(torch, ops, captured, batches)
        tot, f_bound, b_bound = ca_kernel_times(torch, ops, batches, card)
        ca_fwd.update(launches=ca_launches["ca_server_fwd"], ms=tot["fwd"],
                      plain_ms=tot["plain_fwd"], bound_ms=f_bound[0],
                      bound_by=f_bound[1], library_ms=tot["sdpa_fwd"],
                      captured_max_abs_err=ca_captured_err,
                      shape="layer 0 of step 0, 4 server batches summed")
        ca_bwd.update(launches=ca_launches["ca_server_bwd_dq"],
                      launches_dkv=ca_launches["ca_server_bwd_dkv"],
                      ms=tot["bwd"], plain_ms=tot["plain_bwd"],
                      bound_ms=b_bound[0], bound_by=b_bound[1],
                      library_ms=tot["sdpa_fwd_bwd"],
                      library_call="sdpa fwd+bwd, efficient attention, "
                                   "boolean mask",
                      train={k: [s[k] for s in steps] for k in
                             ("loss", "step_s", "peak_gib")})
    log(json.dumps({"kernels": [kernel, ca_fwd, ca_bwd]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
