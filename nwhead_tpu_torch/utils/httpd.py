"""JSON-over-HTTP serving front end (standard library only).

Port of ``nwhead_tpu/utils/httpd.py``: a ``ThreadingHTTPServer`` over the
serving stack ``NWNet.make_serving_fn`` -> ``MicroBatcher``, with live
support-bank edits.

Endpoints (request and response bodies are JSON unless noted):

  GET  /healthz          liveness, bank rows, classes, head precision
  GET  /stats            request counters, batch occupancy, latency
                         percentiles (measured in the handler, end to end)
  POST /predict          {"inputs": [[...], ...], "topk": K}
                         | {"images_b64": ["<base64 jpeg>", ...], "topk": K}
                         | a raw body with Content-Type: image/...
  POST /add_support      {"inputs" | "images_b64": ..., "labels": [...]}
  POST /remove_support   {"rows": [...]}

Predictions go through the shared ``MicroBatcher``: concurrent requests
of one item coalesce into the device's batch shape. JSON ``inputs`` arrive
as float32 arrays (the JAX server's ``jnp.asarray`` makes them float32
too). Support edits run one at a time behind a lock on the request's
thread, through ``NWNet.add_support`` / ``remove_support``, while the
batcher's thread keeps serving: the net builds the edited bank aside and
installs it in one assignment (``NWNet._build_serving_banks``), so a
prediction in flight reads the old bank or the new one, and the serving
callable reads the edited bank at its next call.

Images are decoded per request by the caller's ``decode_query`` /
``decode_support`` (the serve CLI's use PIL).
"""

from __future__ import annotations

import base64
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = ["NWHttpServer", "ServingStats"]


class ServingStats:
    """Thread-safe request and latency counters for ``/stats``."""

    def __init__(self, window: int = 4096) -> None:
        self._lock = threading.Lock()
        self._lat = deque(maxlen=window)  # seconds, per request
        self.requests = 0
        self.items = 0
        self.errors = 0
        self.edits = 0
        self.started = time.time()

    def record(self, n_items: int, seconds: float) -> None:
        with self._lock:
            self.requests += 1
            self.items += n_items
            self._lat.append(seconds)

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_edit(self) -> None:
        with self._lock:
            self.edits += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            out = {
                "requests": self.requests,
                "items": self.items,
                "errors": self.errors,
                "support_edits": self.edits,
                "uptime_s": round(time.time() - self.started, 1),
            }
            if lat:
                out["latency_ms"] = {
                    "p50": round(1e3 * lat[len(lat) // 2], 2),
                    "p95": round(1e3 * lat[int(len(lat) * 0.95)], 2),
                    "p99": round(1e3 * lat[int(len(lat) * 0.99)], 2),
                }
            return out


def _decode_b64_list(payload: Sequence[str], decode: Callable) -> list:
    return [decode(base64.b64decode(b)) for b in payload]


class NWHttpServer:
    """HTTP front end of a batched serving callable and a live ``NWNet``.

    :param net: the ``NWNet`` the bank edits go to (it holds its weights);
        ``None`` for a server that only predicts.
    :param batcher: a ``MicroBatcher`` over the serving callable (its
        counters feed ``/stats``); may be assigned after construction.
    :param input_shape: each ``inputs`` item's shape (a wrong one is a 400,
        not a device error).
    :param decode_query: ``bytes -> array`` for predicted images (what the
        serving callable takes).
    :param decode_support: ``bytes -> array`` for added images (normalized
        floats, what ``NWNet.add_support`` featurizes).
    :param temperature: divisor of the log-probs (``ops/calibrate.py``'s
        ``apply_temperature``; fit offline with the eval CLI's
        ``--fit_temperature``).
    """

    def __init__(
        self,
        net,
        batcher,
        *,
        input_shape: Optional[Sequence[int]] = None,
        decode_query: Optional[Callable] = None,
        decode_support: Optional[Callable] = None,
        topk: int = 5,
        temperature: float = 1.0,
        host: str = "127.0.0.1",
        port: int = 0,
    ) -> None:
        self.net = net
        self.batcher = batcher
        self.input_shape = tuple(input_shape) if input_shape else None
        self.decode_query = decode_query
        self.decode_support = decode_support
        self.topk = topk
        self.temperature = float(temperature)
        self.stats = ServingStats()
        self._edit_lock = threading.Lock()
        self.httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "NWHttpServer":
        """Serve on a daemon thread (tests, embedding); returns self."""
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def stats_snapshot(self) -> dict:
        """The request counters and the batcher's occupancy (items a batch
        before padding)."""
        out = self.stats.snapshot()
        b = self.batcher
        if b is not None and getattr(b, "dispatches", 0):
            out["device_batches"] = b.dispatches
            out["mean_batch_occupancy"] = round(b.dispatched_items / b.dispatches, 2)
        return out

    # -- request logic (independent of the handler) ----------------------------

    def _parse_predict_items(self, content_type: str, body: bytes):
        if content_type.startswith("image/"):
            if self.decode_query is None:
                raise ValueError("this server was built without an image decoder")
            return [self.decode_query(body)], {}
        payload = json.loads(body or b"{}")
        if "images_b64" in payload:
            if self.decode_query is None:
                raise ValueError("this server was built without an image decoder")
            return _decode_b64_list(payload["images_b64"], self.decode_query), payload
        if "inputs" in payload:
            items = [np.asarray(x, dtype=np.float32) for x in payload["inputs"]]
            for it in items:
                if self.input_shape and it.shape != self.input_shape:
                    raise ValueError(f"input shape {it.shape} != expected {self.input_shape}")
            return items, payload
        raise ValueError("predict body needs 'inputs' or 'images_b64'")

    def predict(self, content_type: str, body: bytes) -> dict:
        items, payload = self._parse_predict_items(content_type, body)
        if not items:
            return {"predictions": []}
        k = int(payload.get("topk", self.topk))
        futures = [self.batcher.submit(it) for it in items]
        preds = []
        for f in futures:
            lp = np.asarray(f.result())
            if self.temperature != 1.0:
                from nwhead_tpu_torch.ops.calibrate import apply_temperature

                lp = apply_temperature(lp[None], self.temperature)[0].numpy()
            top = np.argsort(-lp)[:k]
            preds.append({
                "label": int(top[0]),
                "topk": [{"class": int(c), "prob": round(float(np.exp(lp[c])), 6)}
                         for c in top],
            })
        return {"predictions": preds}

    def add_support(self, body: bytes) -> dict:
        if self.net is None:
            raise ValueError("this server is frozen (no NWNet attached)")
        payload = json.loads(body or b"{}")
        if "labels" not in payload:
            raise ValueError("add_support body needs 'labels'")
        labels = np.asarray(payload["labels"], dtype=np.int64)
        if "images_b64" in payload:
            if self.decode_support is None:
                raise ValueError("this server was built without an image decoder")
            imgs = np.stack(_decode_b64_list(payload["images_b64"], self.decode_support))
        elif "inputs" in payload:
            imgs = np.stack([np.asarray(x, dtype=np.float32) for x in payload["inputs"]])
        else:
            raise ValueError("add_support body needs 'inputs' or 'images_b64'")
        if len(imgs) != len(labels):
            raise ValueError(f"{len(imgs)} items vs {len(labels)} labels")
        with self._edit_lock:
            self.net.add_support(imgs, labels)
            self.stats.record_edit()
            return {"ok": True, "bank_rows": int(len(self.net.full_y))}

    def remove_support(self, body: bytes) -> dict:
        if self.net is None:
            raise ValueError("this server is frozen (no NWNet attached)")
        payload = json.loads(body or b"{}")
        if "rows" not in payload:
            raise ValueError("remove_support body needs 'rows'")
        with self._edit_lock:
            self.net.remove_support(payload["rows"])
            self.stats.record_edit()
            return {"ok": True, "bank_rows": int(len(self.net.full_y))}

    def healthz(self) -> dict:
        out = {"ok": True}
        if self.net is not None:
            out["bank_rows"] = int(len(self.net.full_y))
            out["n_classes"] = int(self.net.n_classes)
            out["head_precision"] = self.net.model.head.precision
        return out

    # -- the handler ----------------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # A serving daemon keeps counters, not a stderr line a request.
            def log_message(self, fmt, *args):  # noqa: N802
                pass

            def _reply(self, code: int, obj: dict) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    self._reply(200, server.healthz())
                elif self.path == "/stats":
                    self._reply(200, server.stats_snapshot())
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                ctype = self.headers.get("Content-Type", "")
                t0 = time.monotonic()
                try:
                    if self.path == "/predict":
                        out = server.predict(ctype, body)
                        server.stats.record(len(out["predictions"]), time.monotonic() - t0)
                        self._reply(200, out)
                    elif self.path == "/add_support":
                        self._reply(200, server.add_support(body))
                    elif self.path == "/remove_support":
                        self._reply(200, server.remove_support(body))
                    else:
                        self._reply(404, {"error": f"unknown path {self.path}"})
                except (ValueError, KeyError, json.JSONDecodeError) as e:
                    server.stats.record_error()
                    self._reply(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — a 500 for the caller, the thread lives
                    server.stats.record_error()
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        return Handler
