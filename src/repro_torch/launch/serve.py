"""Thin HTTP front-end over the continuous-batching serve engine.

One daemon thread owns the engine and steps ``Engine.serve_round`` —
the exact state machine ``Engine.serve`` loops over, so daemon-driven
and batch serving share one code path.  HTTP handler threads only
submit requests and read per-request token queues; the scheduler and
kv cache are touched under a single lock.

Endpoints:

  * ``POST /generate`` — body ``{"prompt": [int, ...],
    "max_new_tokens": N?, "stream": true?}``.  Non-streaming waits for
    completion and returns ``{"rid", "tokens"}``; streaming responds
    with NDJSON lines ``{"token": t, "done": false}`` as tokens are
    sampled, closing with ``{"rid", "tokens", "done": true}``.
  * ``GET /health`` — ``{"status": "ok"|"draining"|"drained",
    "active", "waiting", "done", "rounds", "pool_epoch",
    "calib_version", "queue_depth"}`` (the last three read from the
    same metrics registry ``GET /metrics`` exports).
  * ``GET /metrics`` — Prometheus text exposition of the process
    metrics registry (DESIGN.md §14).
  * ``POST /drain`` — stop admitting new work; in-flight requests run
    to completion (503 for later ``/generate`` calls).

``--admission cost`` prices admission with the analytic CAD cost
model; adding ``--calibrate`` re-prices it live from measured decode
round latencies (a ``GridCalibrator`` fed by the daemon, exposed to
the scheduler as a snapshot provider — the same one-snapshot-per-round
discipline the training planner follows).

The port of ``repro.launch.serve``.  ``--device`` (default ``cuda``)
picks the card or, when asked, the CPU; ``--reduced/--no-reduced`` picks
the smoke-test widths or the architecture's own (the reference's flag
cannot be turned off).

Run: PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
         --no-reduced --port 8080
(``--arch`` takes every arch of ``configs.SERVE_ARCHS``: the dense ones,
mamba2-370m and recurrentgemma-9b, and the MoE archs qwen2-moe-a2.7b and
llama4-maverick-400b-a17b, which prefill a token a step.)
Try: curl -d '{"prompt": [3, 14, 15, 92]}' localhost:8080/generate
"""
from __future__ import annotations

import argparse
import itertools
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from repro_torch.configs import SERVE_ARCHS, get_config
from repro_torch.core.cost_model import GridCalibrator
from repro_torch.models.model import Transformer, needs_memory
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.scheduler import DECODE, Request


class EngineDaemon:
    """Owns the engine + one ContinuousScheduler; a background thread
    steps serve rounds while handler threads submit and stream."""

    def __init__(self, engine: Engine, *, calibrate: bool = False):
        self.engine = engine
        self.calibrator = GridCalibrator(engine._cost_model(), 1) \
            if calibrate else None
        self.sched = engine.make_scheduler(
            snapshot_provider=self.calibrator.snapshot
            if self.calibrator else None)
        self.cond = threading.Condition()
        self.draining = False
        self.stopped = False
        self.rounds = 0
        self._rids = itertools.count()
        self._out = {}       # rid -> [token, ...] (grows as sampled)
        self._done = {}      # rid -> threading.Event
        self._streams = {}   # rid -> queue.Queue[(token|None, done)]
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ client API
    def submit(self, prompt, max_new_tokens=None, stream=False) -> int:
        """Enqueue one request; raises RuntimeError when draining."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError("prompt must be a non-empty int list")
        if prompt.size > self.engine.scfg.max_seq:
            raise ValueError(f"prompt length {prompt.size} exceeds "
                             f"max_seq {self.engine.scfg.max_seq}")
        mn = self.engine.scfg.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        with self.cond:
            if self.draining or self.stopped:
                raise RuntimeError("daemon is draining")
            rid = next(self._rids)
            self._out[rid] = []
            self._done[rid] = threading.Event()
            if stream:
                self._streams[rid] = queue.Queue()
            self.sched.submit(Request(rid=rid, prompt=prompt,
                                      max_new_tokens=mn))
            self.cond.notify_all()
        return rid

    def wait(self, rid: int, timeout=None):
        """Block until ``rid`` finishes; returns its token list."""
        if not self._done[rid].wait(timeout):
            raise TimeoutError(f"request {rid} still running")
        return list(self._out[rid])

    def stream(self, rid: int):
        """Yield ``(token, done)`` as request ``rid`` produces them."""
        q = self._streams[rid]
        while True:
            tok, done = q.get()
            yield tok, done
            if done:
                return

    def drain(self):
        with self.cond:
            self.draining = True
            in_flight = len(self.sched.active) + len(self.sched.waiting)
            self.cond.notify_all()
        return in_flight

    def stop(self):
        with self.cond:
            self.stopped = True
            self.cond.notify_all()
        self._thread.join(timeout=5)

    def stats(self):
        with self.cond:
            active = len(self.sched.active)
            waiting = len(self.sched.waiting)
            done = len(self.sched.done)
            if not self.draining:
                status = "ok"
            else:
                status = "drained" if active + waiting == 0 else "draining"
            # pool_epoch / calib_version / queue_depth come from the
            # same metrics registry GET /metrics serves, so the two
            # endpoints can never disagree (DESIGN.md §14)
            reg = obs_metrics.get_registry()

            def gval(name, default):
                v = reg.gauge(name).value()
                return default if v is None else v
            return {"status": status, "active": active, "waiting": waiting,
                    "done": done, "rounds": self.rounds,
                    "pool_epoch": int(gval("cad_pool_epoch", 0)),
                    "calib_version": int(gval("serve_calib_version", -1)),
                    "queue_depth": int(gval("serve_queue_depth",
                                            waiting))}

    # ------------------------------------------------------------ the worker
    def _on_token(self, rid, token, done):
        if token is not None:
            self._out[rid].append(int(token))
        q = self._streams.get(rid)
        if q is not None:
            q.put((None if token is None else int(token), done))
        if done:
            self._done[rid].set()

    def _loop(self):
        while True:
            with self.cond:
                while not self.stopped and not self.sched.has_work():
                    self.cond.wait(0.1)
                if self.stopped:
                    return
                decode_shapes = None
                if self.calibrator is not None \
                        and not self.sched.has_prefill():
                    decode_shapes = [
                        (1, int(self.sched.kv_len[s]) + 1)
                        for s, r in self.sched.active.items()
                        if r.state == DECODE]
                t0 = time.perf_counter()
                progressed = self.engine.serve_round(
                    self.sched, on_token=self._on_token)
                if progressed:
                    self.rounds += 1
                    if decode_shapes:
                        self.calibrator.observe_tasks(
                            decode_shapes, time.perf_counter() - t0,
                            server=0)


# ------------------------------------------------------------------- HTTP
def make_handler(daemon: EngineDaemon):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.0: streaming responses end at connection close, no
        # chunked framing needed
        protocol_version = "HTTP/1.0"

        def log_message(self, fmt, *args):     # quiet by default
            pass

        def _json(self, code, obj):
            body = (json.dumps(obj) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                body = obs_metrics.get_registry().to_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path != "/health":
                return self._json(404, {"error": "unknown path"})
            self._json(200, daemon.stats())

        def do_POST(self):
            if self.path == "/drain":
                return self._json(200, {"draining": True,
                                        "in_flight": daemon.drain()})
            if self.path != "/generate":
                return self._json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt = req["prompt"]
                stream = bool(req.get("stream", False))
                rid = daemon.submit(prompt, req.get("max_new_tokens"),
                                    stream=stream)
            except RuntimeError as e:
                return self._json(503, {"error": str(e)})
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            if not stream:
                return self._json(200, {"rid": rid,
                                        "tokens": daemon.wait(rid)})
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            for tok, done in daemon.stream(rid):
                if done:
                    line = {"rid": rid, "tokens": list(daemon._out[rid]),
                            "done": True}
                else:
                    line = {"token": tok, "done": False}
                self.wfile.write((json.dumps(line) + "\n").encode())
                self.wfile.flush()

    return Handler


def make_server(daemon: EngineDaemon, host: str, port: int) \
        -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(daemon))


# ------------------------------------------------------------------ launch
def build_engine(args, cfg=None) -> Engine:
    """The engine ``args`` describe, serving ``cfg`` if given (a config cut
    in depth, say) and else ``--arch``'s (reduced unless ``--no-reduced``)."""
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    if needs_memory(cfg):
        # the reference's launcher reaches an assert in init_cache here
        raise ValueError(f"{cfg.arch_id} cross-attends to a memory the "
                         f"launcher cannot give it; build "
                         f"Engine(model, serve_cfg, memory=...) instead")
    model = Transformer(cfg, device=args.device, seed=args.seed)
    scfg = ServeConfig(max_seq=args.max_seq,
                       max_new_tokens=args.max_new,
                       chunk_tokens=args.chunk_tokens,
                       prefill=args.prefill,
                       admission=args.admission,
                       token_budget=args.token_budget,
                       step_cost_budget=args.step_cost_budget)
    return Engine(model, scfg, batch_size=args.slots,
                  device=args.device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="llama3-8b", choices=SERVE_ARCHS)
    p.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="use the reduced config (default); --no-reduced "
                        "runs the architecture's own widths (random init)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--slots", type=int, default=4,
                   help="cache slots = max concurrent requests on device")
    p.add_argument("--max-seq", type=int, default=256)
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--chunk-tokens", type=int, default=128)
    p.add_argument("--prefill", choices=("fused", "loop"), default="fused")
    p.add_argument("--admission", choices=("fcfs", "cost"), default="fcfs")
    p.add_argument("--token-budget", type=int, default=None,
                   help="continuous-batching kv budget (tokens)")
    p.add_argument("--step-cost-budget", type=float, default=0.0,
                   help="predicted CA seconds per decode step (0 = off)")
    p.add_argument("--calibrate", action="store_true",
                   help="re-price cost admission from measured decode "
                        "round latencies")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    daemon = EngineDaemon(build_engine(args), calibrate=args.calibrate)
    srv = make_server(daemon, args.host, args.port)
    print(f"serving {args.arch} on http://{args.host}:{srv.server_port} "
          f"({args.slots} slots, admission={args.admission}"
          f"{', calibrated' if args.calibrate else ''})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        daemon.stop()
        srv.server_close()


if __name__ == "__main__":
    main()
