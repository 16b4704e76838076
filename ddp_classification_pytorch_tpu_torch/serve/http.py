"""Stdlib HTTP front-end — a thin layer over the engine, the port's copy of
the JAX package's `serve/http.py` (same routes, status codes, headers and
JSON keys). The engine is the product (fully exercisable in-process, no
sockets); this module only maps HTTP onto it with `http.server`:

    POST /predict   body = an image file (JPEG, PNG, anything PIL opens);
                    optional X-Tenant header routes the request through the
                    admission controller's per-tenant weighted queues
                    → 200 {"topk": [[class, score], ...], "latency_ms": N,
                           "digest": <params sha256>, "generation": N}
                    → 503 {"state": "busy", "queue_depth": N,
                           "shed_tenant": <tenant>} + Retry-After: 1
                      (backpressure — queue full or admission shed) or
                      {"state": "draining", "queue_depth": N} +
                      Retry-After: 5 (replica going away — pick another)
                    → 400 on undecodable bodies
    GET  /healthz   → 200 {"ok": ..., "digest": ..., "generation": ...,
                           "watcher_alive": ..., "fleet_role": ...,
                           "wave_state": ..., "lease_generation": ...,
                           ...metrics snapshot}
    GET  /metrics   → 200 Prometheus text exposition of the engine's
                      registry (serve_*, engine_*, watcher_*, fleet_*,
                      admission_* families; text/plain; version=0.0.4)
    GET  /metrics.json → 200 the metrics snapshot JSON (the dict /healthz
                      embeds)

The decoder is PIL, as in the JAX front end: `decode_image` opens the
body, converts it to RGB (grayscale replicated, alpha dropped, palettes
expanded: `Image.convert("RGB")`) and hands the (H, W, 3) uint8 array to
`ServingEngine.submit_image`, whose val `Transform` resizes and crops it
in numpy, bitwise what the JAX route's PIL ops give on the same array.
PIL is imported there, at request time, and nowhere else in the port:
the rest of the package imports without it, and `cli/serve.py --port`
refuses to start (rc 2) where `decoder_available()` says it is missing.
Decoding runs on the handler threads (one per connection), in parallel,
never on the device thread.

`ThreadingHTTPServer` gives one handler thread per connection; every
handler just blocks on its request future, so concurrency is bounded by
the engine's queue, not by HTTP plumbing.
"""

from __future__ import annotations

import importlib.util
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np

from .engine import EngineClosed, QueueFull
from .fleet import AdmissionShed


def decoder_available() -> bool:
    """Whether PIL, the request decoder, can be imported here."""
    return importlib.util.find_spec("PIL") is not None


def decode_image(body: bytes) -> np.ndarray:
    """An encoded image (JPEG, PNG, ...) → (H, W, 3) uint8 RGB. Raises on
    bytes PIL cannot decode."""
    from PIL import Image

    img = Image.open(io.BytesIO(body))
    img.load()
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


class ServeHandler(BaseHTTPRequestHandler):
    # set by make_server on the handler class
    engine: Any = None
    watcher: Any = None  # CheckpointWatcher when serving with --watch
    fleet: Any = None  # FleetMember when serving with --fleet_dir
    admission: Any = None  # AdmissionController when admission is on
    request_timeout_s: float = 30.0

    def _json(self, code: int, payload: dict,
              headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _text(self, code: int, body: str, content_type: str) -> None:
        raw = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        if self.path == "/metrics":
            # Prometheus scrape endpoint: every instrument registered
            # against this engine's registry (the watcher, fleet member and
            # admission controller share it)
            self._text(200, self.engine.metrics.registry.expose(),
                       "text/plain; version=0.0.4")
            return
        if self.path in ("/healthz", "/metrics.json"):
            snap = self.engine.metrics.snapshot(self.engine.queue_depth)
            if self.path == "/healthz":
                snap = {
                    "ok": not self.engine.closed,
                    "digest": self.engine.params_digest,
                    "generation": self.engine.params_generation,
                    # None = no watcher configured (--ckpt pins the
                    # weights); False = the reload thread died
                    "watcher_alive": (self.watcher.alive
                                      if self.watcher is not None else None),
                    # fleet placement: None = lone replica (no --fleet_dir)
                    "fleet_role": (self.fleet.role()
                                   if self.fleet is not None else None),
                    "wave_state": (self.fleet.state
                                   if self.fleet is not None else None),
                    "lease_generation": (self.fleet.generation
                                         if self.fleet is not None else None),
                    **snap,
                }
            self._json(200, snap)
            return
        self._json(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self):  # noqa: N802
        if self.path != "/predict":
            self._json(404, {"error": f"unknown path {self.path!r}"})
            return
        tenant = self.headers.get("X-Tenant", "default") or "default"
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        try:
            img = decode_image(body)
        except Exception as e:
            self._json(400, {"error": f"cannot decode image: {e}"})
            return
        try:
            if self.admission is not None:
                future = self.admission.submit_image(img, tenant=tenant)
            else:
                future = self.engine.submit_image(img)
            pred = future.result(timeout=self.request_timeout_s)
        except AdmissionShed as e:
            # admission policy shed: measured wait exceeded the deadline;
            # the body carries the depth at decision time and the tenant
            self._json(503, {"error": str(e), "state": "busy",
                             "queue_depth": e.queue_depth,
                             "shed_tenant": e.tenant,
                             "est_wait_ms": round(e.est_wait_ms, 1)},
                       headers={"Retry-After": "1"})
            return
        except QueueFull as e:
            # backpressure: the queue turns over within a batch or two —
            # retry against the SAME replica shortly
            self._json(503, {"error": str(e), "state": "busy",
                             "queue_depth": self.engine.queue_depth,
                             "shed_tenant": tenant},
                       headers={"Retry-After": "1"})
            return
        except EngineClosed as e:
            # draining: this replica is going away — go to another one
            self._json(503, {"error": str(e), "state": "draining",
                             "queue_depth": self.engine.queue_depth},
                       headers={"Retry-After": "5"})
            return
        except Exception as e:
            self._json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._json(200, {
            "topk": [[int(c), float(s)]
                     for c, s in zip(pred.indices, pred.scores)],
            "latency_ms": round(pred.latency_ms, 3),
            "digest": pred.digest,
            "generation": pred.generation,
        })

    def log_message(self, fmt, *args):  # no per-request stderr lines
        pass


def make_server(engine: Any, port: int, request_timeout_s: float = 30.0,
                watcher: Any = None, fleet: Any = None,
                admission: Any = None) -> ThreadingHTTPServer:
    """Bind a ThreadingHTTPServer over `engine` (not yet serving); port 0
    binds an ephemeral port (`server.server_address[1]`)."""
    handler = type("BoundServeHandler", (ServeHandler,), {
        "engine": engine, "watcher": watcher, "fleet": fleet,
        "admission": admission, "request_timeout_s": request_timeout_s})
    return ThreadingHTTPServer(("0.0.0.0", port), handler)


def start_server(engine: Any, port: int, watcher: Any = None,
                 fleet: Any = None, admission: Any = None
                 ) -> ThreadingHTTPServer:
    """Serve on a daemon thread; the caller owns shutdown
    (`server.shutdown()` before `engine.drain()` so no handler blocks on a
    draining engine)."""
    server = make_server(engine, port, watcher=watcher, fleet=fleet,
                         admission=admission)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="serve-http").start()
    return server
