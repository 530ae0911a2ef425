"""Minimal stdlib HTTP front end for the serving engine (counterpart of
``pcdms_tpu/serve/http.py``, the same wire format and endpoints).

The wire format is npz (``np.savez``) rather than JSON + base64: requests
POST an npz body whose entries are the service's submit() inputs; responses
are an npz of the outputs. Stdlib only (``http.server``), so the serving
stack adds no dependency; the batching and latency behaviour lives in
``engine.py``, not here.

``ThreadingHTTPServer`` gives each connection its own thread, so
concurrent client requests block in ``future.result()`` together and the
engine batches them onto the device.

Endpoints:
  POST /v1/generate   npz in -> npz out (single request)
  GET  /healthz       {"ok": true}
  GET  /stats         engine counters as JSON
"""

from __future__ import annotations

import io
import json
import logging
import queue
import threading
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from pcdms_tpu_torch.serve.engine import EngineClosed

logger = logging.getLogger("pcdms_tpu_torch.serve.http")


def _npz_bytes(tree: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in tree.items()})
    return buf.getvalue()


def make_handler(service, request_timeout_s: float = 600.0,
                 max_body_bytes: int = 512 * 1024 * 1024):
    """Build a request-handler class bound to ``service``.

    ``service`` must expose ``submit(**inputs) -> Future`` and
    ``stats() -> dict``. Future results may be a single array (returned
    as npz key ``"image"``) or a dict of arrays. Bodies larger than
    ``max_body_bytes`` are rejected with 413 before being read.
    """

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # route to logging, not stderr
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _reply(self, code: int, body: bytes,
                   ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj):
            self._reply(code, json.dumps(obj).encode())

        def do_GET(self):
            if self.path == "/healthz":
                self._reply_json(200, {"ok": True})
            elif self.path == "/stats":
                self._reply_json(200, service.stats())
            else:
                self._reply_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/v1/generate":
                # body not read: the connection must close, or the
                # keep-alive parser would read the body as a request line
                self.close_connection = True
                self._reply_json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > max_body_bytes:
                    self.close_connection = True
                    self._reply_json(413, {"error": f"body {length} bytes "
                                           f"exceeds {max_body_bytes} "
                                           "limit"})
                    return
                with np.load(io.BytesIO(self.rfile.read(length))) as z:
                    inputs = {k: z[k] for k in z.files}
                # scalars (e.g. seed) arrive as 0-d arrays
                kwargs = {k: (v.item() if v.ndim == 0 else v)
                          for k, v in inputs.items()}
            except Exception as e:  # noqa: BLE001 — malformed body
                # the body may be unread or partially read (missing
                # Content-Length, chunked transfer, truncated npz) —
                # the keep-alive connection is unusable, close it
                self.close_connection = True
                self._reply_json(400, {"error": f"bad request body: {e}"})
                return
            try:
                # submit() raises ValueError/TypeError only for invalid
                # request inputs — a genuine 400 (body was fully read,
                # keep-alive stays usable). The bounded enqueue timeout
                # turns sustained overload into 503s instead of an
                # unbounded pile-up of blocked handler threads.
                fut = service.submit(timeout=60.0, **kwargs)
            except (ValueError, TypeError) as e:
                self._reply_json(400, {"error": str(e)})
                return
            except queue.Full:
                self._reply_json(503, {"error": "request queue full — "
                                       "retry later"})
                return
            except EngineClosed:
                self._reply_json(503, {"error": "server shutting down"})
                return
            try:
                result = fut.result(request_timeout_s)
            except FuturesTimeout:
                # still queued or mid-batch: cancel if it never started
                # (frees the engine slot); if it is already running the
                # result is simply discarded when it lands
                fut.cancel()
                self._reply_json(504, {"error": "request timed out after "
                                       f"{request_timeout_s}s"})
                return
            except Exception as e:  # noqa: BLE001 — surface, don't crash
                # failures inside the model batch are server errors even
                # when they carry ValueError types
                logger.exception("request failed")
                self._reply_json(500, {"error": str(e)})
                return
            tree = result if isinstance(result, dict) else {"image": result}
            self._reply(200, _npz_bytes(tree), "application/octet-stream")

    return Handler


class ServingServer:
    """ThreadingHTTPServer wrapper with background start/stop."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 8000,
                 request_timeout_s: float = 600.0,
                 max_body_bytes: int = 512 * 1024 * 1024):
        self.service = service
        self.httpd = ThreadingHTTPServer(
            (host, port), make_handler(service, request_timeout_s,
                                       max_body_bytes))
        self.port = self.httpd.server_address[1]   # resolved when port=0
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True,
                                        name="pcdms-serve-http")

    def start(self):
        self._thread.start()
        logger.info("serving on http://%s:%d", *self.httpd.server_address)
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def post_npz(host: str, port: int, inputs: dict, path: str = "/v1/generate",
             timeout: float = 600.0) -> dict:
    """Tiny stdlib client for tests/demos: POST inputs, return outputs."""
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = _npz_bytes(inputs)
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/octet-stream",
                              "Content-Length": str(len(body))})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {data[:500]!r}")
        with np.load(io.BytesIO(data)) as z:
            return {k: z[k] for k in z.files}
    finally:
        conn.close()
