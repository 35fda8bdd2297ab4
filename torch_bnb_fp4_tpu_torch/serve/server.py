"""HTTP serving front-end over the continuous-batching Engine.

Counterpart of ``torch_bnb_fp4_tpu/serve/server.py``, on the standard library
alone (no web framework).

Threading model: the Engine is single-threaded by design.  HTTP handler
threads never touch it; they enqueue a submission and block on its future
(or drain its token stream queue), while one engine thread owns
``submit()``/``step()``/``abort()`` and every device call, and fans finished
completions back out.  Torch's grad mode is per thread; the engine's device
methods run under ``torch.no_grad`` themselves.

Endpoints
---------
  POST /v1/completions   {"prompt": [token ids], "max_tokens": N,
                          "temperature"?: f, "top_p"?: f, "eos_id"?: id,
                          "stop_ids"?: [ids], "stream"?: bool,
                          "adapter"?: name}
      Sampling overrides and adapters the greedy engine cannot honour are
      rejected with 400 and the server keeps serving.
      -> {"uid", "tokens", "finish_reason", "prompt_len", "ttft_s", "total_s"}
      or, with "stream": true, chunked server-sent-event lines: first
      ``data: {"uid": N}``, then ``data: {"token": t}`` per generated token
      and a final ``data: {"done": {...completion...}}``.
  POST /v1/abort          {"uid": N} -> {"uid": N, "aborted": bool}; the
      request completes with finish_reason "abort"
  GET  /v1/stats          engine.stats() as JSON, plus "launches": the
      process's CUDA kernel launch counts (ops.kernels.LAUNCHES)
  GET  /health            200 {"status": "ok"}

Prompts are token-id lists; with ``tokenizer=`` (anything with
``encode(str) -> [ids]`` / ``decode([ids]) -> str``, e.g. an HF
``AutoTokenizer``) ``{"text": "..."}`` prompts and a decoded ``"text"`` field
are enabled and ``eos_id`` defaults to ``tokenizer.eos_token_id``.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..ops import kernels as K
from .engine import Engine, Request

log = logging.getLogger("torch_bnb_fp4_tpu_torch.serve.http")


class _Pending:
    """A submitted request's rendezvous between the engine thread (producer)
    and its handler thread (consumer)."""

    def __init__(self, stream: bool):
        self.done = threading.Event()
        self.completion = None
        self.error: str | None = None
        self.stream_q: queue.Queue | None = queue.Queue() if stream else None


class EngineServer:
    """Threaded HTTP front-end owning the engine loop.

    ``port=0`` binds an ephemeral port (read ``self.port`` after
    construction).  ``start()`` launches the engine and HTTP threads;
    ``stop()`` shuts both down."""

    def __init__(self, engine: Engine, host: str = "127.0.0.1", port: int = 8000, tokenizer=None):
        self.engine = engine
        self.tokenizer = tokenizer
        self._subq: queue.Queue = queue.Queue()
        self._abortq: queue.Queue = queue.Queue()  # (uid, holder); the engine thread drains it
        self._pending: dict[int, _Pending] = {}
        self._plock = threading.Lock()  # guards _pending and _uid only
        self._uid = 0
        self._consumed = 0  # engine.completions consumed so far
        self._stop = threading.Event()
        engine.on_token = self._on_token
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self.host, self.port = self._httpd.server_address[:2]
        self._engine_thread = threading.Thread(target=self._engine_loop, name="engine-loop", daemon=True)
        self._http_thread = threading.Thread(target=self._httpd.serve_forever, name="http-accept", daemon=True)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "EngineServer":
        self._engine_thread.start()
        self._http_thread.start()
        log.info("serving on http://%s:%d", self.host, self.port)
        return self

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._engine_thread.join(timeout=30)

    # -- engine thread -----------------------------------------------------

    def _submit(self, body: dict, stream: bool) -> tuple[int, _Pending]:
        """Handler-thread side: validate, register a pending slot, enqueue."""
        prompt = body.get("prompt")
        if prompt is None and "text" in body:
            if self.tokenizer is None:
                raise ValueError('"text" prompts need a server-side tokenizer (start with --tokenizer); '
                                 "send token ids instead")
            if not isinstance(body["text"], str):
                raise ValueError("text must be a string")
            prompt = [int(t) for t in self.tokenizer.encode(body["text"])]
        if not isinstance(prompt, list) or not all(isinstance(t, int) for t in prompt):
            raise ValueError("prompt must be a list of token ids")
        stop_ids = body.get("stop_ids")
        if stop_ids is not None and (not isinstance(stop_ids, list) or not all(isinstance(t, int) for t in stop_ids)):
            raise ValueError("stop_ids must be a list of token ids")
        with self._plock:
            self._uid += 1
            uid = self._uid
            p = _Pending(stream)
            self._pending[uid] = p
        eos_id = body.get("eos_id")
        if eos_id is None and self.tokenizer is not None:
            eos_id = getattr(self.tokenizer, "eos_token_id", None)
        req = Request(uid=uid, prompt=prompt, max_new_tokens=int(body.get("max_tokens", 64)), eos_id=eos_id,
                      stop_ids=stop_ids, temperature=body.get("temperature"), top_p=body.get("top_p"),
                      adapter=body.get("adapter"))
        self._subq.put(req)
        return uid, p

    def _on_token(self, uid: int, tok: int) -> None:
        # engine thread; queue handoff to the (possibly streaming) handler
        p = self._pending.get(uid)
        if p is not None and p.stream_q is not None:
            p.stream_q.put(tok)

    def _busy(self) -> bool:
        e = self.engine
        return bool(e.pending or any(r is not None for r in e.slot_req) or e._pf is not None)

    def _engine_loop(self) -> None:
        if self.engine.device.type == "cuda":
            # launches go to the current device of this thread
            torch.cuda.set_device(self.engine.device)
        while not self._stop.is_set():
            try:
                self._engine_tick()
            except Exception as e:  # noqa: BLE001 - a dead loop hangs every client
                log.exception("engine tick failed; failing in-flight requests")
                with self._plock:
                    pending, self._pending = self._pending, {}
                for p in pending.values():
                    p.error = f"internal engine error: {e}"
                    if p.stream_q is not None:
                        p.stream_q.put(None)
                    p.done.set()

    def _engine_tick(self) -> None:
        # drain new submissions (non-blocking while busy; park when idle)
        try:
            req = self._subq.get(timeout=0.0 if self._busy() else 0.2)
            while True:
                try:
                    self.engine.submit(req)
                except ValueError as e:  # bad request: fail its future only
                    p = self._pending.pop(req.uid, None)
                    if p is not None:
                        p.error = str(e)
                        if p.stream_q is not None:
                            p.stream_q.put(None)
                        p.done.set()
                req = self._subq.get_nowait()
        except queue.Empty:
            pass
        while not self._abortq.empty():
            try:
                uid, holder = self._abortq.get_nowait()
            except queue.Empty:
                break
            holder["aborted"] = self.engine.abort(uid)
            holder["done"].set()
        if self._busy():
            self.engine.step()
        # fan out finished completions
        comps = self.engine.completions
        while self._consumed < len(comps):
            c = comps[self._consumed]
            self._consumed += 1
            # pop: the handler thread holds its own reference; the map must
            # not grow without bound over a long-lived server
            p = self._pending.pop(c.uid, None)
            if p is not None:
                p.completion = c
                if p.stream_q is not None:
                    p.stream_q.put(None)  # end-of-stream sentinel
                p.done.set()
        # trim the consumed prefix (the engine thread owns both the list and
        # _consumed) so completions do not grow for the life of the server
        if self._consumed >= 256:
            del comps[: self._consumed]
            self._consumed = 0

    # -- HTTP --------------------------------------------------------------

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route to logging, not stderr
                log.debug("%s " + fmt, self.client_address[0], *args)

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._json(200, {"status": "ok"})
                elif self.path == "/v1/stats":
                    # a snapshot of host-side counters; the engine thread may be
                    # mid-tick but every field is a scalar read
                    self._json(200, dict(server.engine.stats(), launches=K.launch_counts()))
                else:
                    self._json(404, {"error": f"no such path: {self.path}"})

            def do_POST(self):
                if self.path == "/v1/abort":
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        uid = int(json.loads(self.rfile.read(n) or b"{}")["uid"])
                    except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                        self._json(400, {"error": f"need an integer uid: {e}"})
                        return
                    holder = {"done": threading.Event(), "aborted": False}
                    server._abortq.put((uid, holder))
                    holder["done"].wait(timeout=60)
                    self._json(200, {"uid": uid, "aborted": holder["aborted"]})
                    return
                if self.path != "/v1/completions":
                    self._json(404, {"error": f"no such path: {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("the request body must be a JSON object")
                    stream = bool(body.get("stream", False))
                    uid, p = server._submit(body, stream)
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                if stream:
                    self._stream(uid, p)
                    return
                p.done.wait()
                if p.error is not None:
                    self._json(400, {"error": p.error, "uid": uid})
                else:
                    self._json(200, server._completion_json(uid, p.completion))

            def _stream(self, uid: int, p: _Pending) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj) -> None:
                    data = b"data: " + json.dumps(obj).encode() + b"\n\n"
                    self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
                    self.wfile.flush()

                chunk({"uid": uid})  # first event: the abort handle
                while True:
                    tok = p.stream_q.get()
                    if tok is None:
                        break
                    chunk({"token": tok})
                p.done.wait()
                if p.error is not None:
                    chunk({"error": p.error, "uid": uid})
                else:
                    chunk({"done": server._completion_json(uid, p.completion)})
                self.wfile.write(b"0\r\n\r\n")  # final chunk

        return Handler

    def _completion_json(self, uid: int, c) -> dict:
        out = {"uid": uid, "tokens": c.tokens, "finish_reason": c.finish_reason, "prompt_len": c.prompt_len,
               "ttft_s": round(c.ttft_s, 6), "total_s": round(c.total_s, 6)}
        if c.logprobs is not None:
            out["logprobs"] = [round(v, 6) for v in c.logprobs]
        if self.tokenizer is not None:
            out["text"] = self.tokenizer.decode(c.tokens)
        return out
