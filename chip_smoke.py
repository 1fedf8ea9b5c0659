"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card, ``nvcc`` and the repository's ``src/repro_torch``; without a card it
exits non-zero and prints no result.

Phases, each of which fails the run:

1. the card's name and power limit, the torch and CUDA versions, and the
   build of every kernel from the sources in the checkout (timed);
2. every kernel against its plain PyTorch version on the card, over the
   cases the serving path can give it;
3. the serving slice at full width: llama3-8b in bf16 from a seeded
   generator, behind ``launch/serve.py``'s HTTP daemon, answering eight
   requests, with the launch counts read around that run, the kernel held
   against its plain version on captured q and cache tensors, and fused
   prefill against the per-token loop (checked on an f32 copy of the
   weights, reported in bf16);
4. times at the main path's shapes: the kernel, its plain version, one
   PyTorch library call for the same work and the least time the card
   could take; prefill tokens per second, decode time per step, peak memory.

The line before the card line lists every ported kernel as JSON; the last
line is ``{"ok": true, "device": {...}}``.  ``--only kernels`` stops after
phase 2: the short first call for a new kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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


# ---------------------------------------------------------------- main
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
    t0 = time.perf_counter()
    ops.load_library()
    seconds, report = build.build_info["ragged_decode"]
    log(f"phase 1: built ragged_decode.cu in {time.perf_counter() - t0:.2f} s"
        f" (nvcc {seconds:.2f} s)")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    f32_err = check_ragged_decode_cases(torch, ops)
    kernel = {"name": "ragged_decode", "route": "cuda",
              "source": "src/repro_torch/kernels/packed_flash/csrc/"
                        "ragged_decode.cu",
              "replaces": "src/repro/kernels/packed_flash/kernel.py:457",
              "max_abs_err": f32_err}
    if args.only != "kernels":
        engine, launches, captured_err = serve_full_width(torch, np, ops,
                                                          launch)
        times = kernel_times(torch, ops, card)
        engine_times(torch, np, engine, card)
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
    log(json.dumps({"kernels": [kernel]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
