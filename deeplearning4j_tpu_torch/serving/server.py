"""JsonModelServer: minimal HTTP JSON inference endpoint.

Port of ``JsonModelServer`` from ``deeplearning4j_tpu/serving/server.py``:
POST JSON -> model -> JSON, fronted by :class:`ParallelInference` so
concurrent requests batch onto the device. stdlib ``http.server`` only: a
minimal inference server, not a production gateway.

Routes: ``POST /predict`` ``{"data": [...]}`` -> ``{"output": [...]}``;
``GET /health`` -> ``{"status": "ok"}``; ``GET /stats`` -> the front's
counters. A bad request answers 400, a request caught by shutdown 503.

With ``generate=`` (a dict of :class:`ContinuousBatcher` keyword
arguments) the server also runs a generative front, as the JAX server's
``generate=`` does (:59-66): ``POST /generate`` ``{"prompt": [[...]] |
"tokens": [ids], "max_new_tokens": n, "deadline_ms": t, "stream": bool}``
(``_generate``, :226). ``stream=true`` writes one NDJSON line per token as
it is produced, then ``{"done": true, "tokens": [...]}``; a failure after
the headers went out becomes an ``{"error": ...}`` line. Without
``stream`` the answer is one ``{"tokens": [...]}`` body. ``QueueFull``
answers 429, ``DeadlineExceeded`` 504, ``ShutdownError`` 503. ``GET
/stats`` carries the generative front's stats under ``"generate"``.

The readiness, metrics and trace routes and the fleet mode come with
later slices.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .batcher import (DeadlineExceeded, ParallelInference, QueueFull,
                      ShutdownError)


class JsonModelServer:
    """``JsonModelServer(net, device=...)``: ``device`` follows the port's
    rule (``cuda`` unless the caller asks for ``cpu``); the other keyword
    arguments go to :class:`ParallelInference`; ``generate`` is a dict of
    :class:`ContinuousBatcher` keyword arguments (the generative front on
    the same device)."""

    def __init__(self, model, port: int = 0, host: str = "127.0.0.1",
                 device=None, request_timeout_s: float = 300.0,
                 generate: Optional[dict] = None, **inference_kwargs):
        self.inference = ParallelInference(model, device=device,
                                           **inference_kwargs)
        self.generator = None
        if generate is not None:
            from .batcher import ContinuousBatcher
            self.generator = ContinuousBatcher(model, device=device,
                                               **dict(generate))
        self.request_timeout_s = float(request_timeout_s)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.host = host
        self.port = port

    def start(self) -> int:
        """Start serving in a background thread; returns the bound port."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"status": "ok"})
                elif self.path == "/stats":
                    st = server.inference.stats()
                    if server.generator is not None:
                        st["generate"] = server.generator.stats()
                    self._send(200, st)
                else:
                    self._send(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path == "/generate":
                    self._generate()
                    return
                if self.path != "/predict":
                    self._send(404, {"error": "unknown path"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    x = np.asarray(req["data"], dtype=np.float32)
                    pi = server.inference
                    out = pi.wait(pi.submit(x),
                                  timeout=server.request_timeout_s)
                    self._send(200, {"output":
                                     [np.asarray(o).tolist() for o in out]
                                     if isinstance(out, list)
                                     else np.asarray(out).tolist()})
                except ShutdownError as e:
                    self._send(503, {"error": f"{type(e).__name__}: {e}"})
                except Exception as e:  # the server keeps answering
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})

            def _generate(self):
                if server.generator is None:
                    self._send(404, {"error": "server was built without "
                                     "generate= support"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    kw = {}
                    if req.get("max_new_tokens") is not None:
                        kw["max_new_tokens"] = int(req["max_new_tokens"])
                    if req.get("deadline_ms") is not None:
                        kw["deadline_ms"] = float(req["deadline_ms"])
                    if "tokens" in req:
                        kw["tokens"] = [int(t) for t in req["tokens"]]
                    else:
                        kw["prompt"] = np.asarray(req["prompt"], np.float32)
                    handle = server.generator.submit(**kw)
                    if not req.get("stream"):
                        res = handle.result(timeout=server.request_timeout_s)
                        self._send(200, {"tokens": res["tokens"]})
                        return
                    # one NDJSON line per token; HTTP/1.0, close-delimited
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.end_headers()
                    try:  # the headers are out: a failure is an error line
                        for i, tok in enumerate(handle.tokens(
                                timeout=server.request_timeout_s)):
                            self.wfile.write(json.dumps(
                                {"index": i, "token": int(tok)}
                            ).encode() + b"\n")
                            self.wfile.flush()
                        res = handle.result(timeout=server.request_timeout_s)
                        self.wfile.write(json.dumps(
                            {"done": True, "tokens": res["tokens"]}
                        ).encode() + b"\n")
                    except Exception as e:
                        self.wfile.write(json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}
                        ).encode() + b"\n")
                except QueueFull as e:
                    self._send(429, {"error": f"{type(e).__name__}: {e}"})
                except DeadlineExceeded as e:
                    self._send(504, {"error": f"{type(e).__name__}: {e}"})
                except ShutdownError as e:
                    self._send(503, {"error": f"{type(e).__name__}: {e}"})
                except Exception as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="JsonModelServer")
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=30)
        self.inference.shutdown()
        if self.generator is not None:
            self.generator.shutdown()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
