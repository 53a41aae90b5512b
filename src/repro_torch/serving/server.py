"""OpenAI-compatible streaming HTTP front end for the serving engine, the
counterpart of ``repro/serving/server.py`` on the standard library.

The engine is single-threaded by construction (one dispatch per step,
host-side scheduler state), so the server keeps it that way: an *engine
thread* owns the ``ServingEngine`` and runs the admit/step loop, while an
asyncio server (``asyncio.start_server`` with the HTTP/1.1 framing of
``serving/wire.py``) accepts requests on an event loop of its own.  The
two sides meet at two points:

* a thread-safe **submission queue** — each ``POST /v1/completions``
  enqueues ``(prompt, params, stream)``; the engine thread drains it
  before every step and maps the uid the engine gives back to the stream;
* the engine's **stream hook** — tokens are pushed to the request's
  asyncio queue (``loop.call_soon_threadsafe``) the moment they leave the
  device, and the finish edge carries the request's engine-side stamps
  and attributed joules.

A lock is held across ``step()`` and ``latency_summary()``.  On a GPU the
engine thread runs under ``torch.cuda.device(engine.device)``: the
kernels launch on the calling thread's current device.  Capture every
CUDA graph (the engine does so in its constructor) and warm the engine up
before ``start_http_server``: a capture in one thread fails while another
thread touches CUDA.

If a step raises, the engine thread keeps the exception and ends every
open stream with an error: HTTP 500 before the first chunk, the
connection closed without ``data: [DONE]`` after it.  Later requests get
a 500, and ``ServerHandle.close()`` and ``summary()`` re-raise it.

Endpoints (the OpenAI completions shape without a tokenizer: prompts are
token-id lists, or strings byte-encoded into the vocabulary):

* ``POST /v1/completions`` — ``stream=true`` for server-sent events,
  ``data: {...}`` chunks ended by ``data: [DONE]``; ``stream=false`` for
  one JSON body.  Each chunk's ``elana`` extension carries the token ids,
  their index in the stream and their emit time; the final chunk's, the
  engine's submit/first-token/finish stamps (``time.perf_counter``, one
  clock per machine, so a client on the same host can compute client
  minus engine latencies).
* ``GET /v1/models`` — the one served model.
* ``GET /metrics`` — ``engine.latency_summary()`` and the server's
  counters, as JSON.

A bad body or bad parameters get a 400 with ``{"error": {"message": ...}}``.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import json
import queue
import threading
import time
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.serving import wire
from repro_torch.serving.sampling import SamplingParams

_JSON = "application/json; charset=utf-8"


def encode_prompt(prompt, vocab_size: int) -> np.ndarray:
    """A token-id list passed through (validated), or a string byte-encoded
    into the vocabulary (there is no tokenizer: the id stream is the
    text)."""
    if isinstance(prompt, str):
        ids = [ord(c) % vocab_size for c in prompt]
    else:
        ids = [int(t) for t in prompt]
        bad = [t for t in ids if not 0 <= t < vocab_size]
        if bad:
            raise ValueError(f"prompt token(s) out of range [0, {vocab_size}): {bad[:5]}")
    if not ids:
        raise ValueError("prompt must contain at least one token")
    return np.asarray(ids, np.int32)


class _Stream:
    """Engine thread -> event loop bridge for one request's events:
    ("begin", uid, t), ("tokens", ids, t), ("end", payload, t) or
    ("error", message)."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self.q: asyncio.Queue = asyncio.Queue()
        self.uid: Optional[int] = None
        self.queued_s = 0.0                      # the handler queued the request
        self.first_hook_s: Optional[float] = None  # its first tokens reached the hook

    def push(self, item) -> None:
        try:
            self._loop.call_soon_threadsafe(self.q.put_nowait, item)
        except RuntimeError:  # the event loop shut down mid-request
            pass


@dataclasses.dataclass
class _Submission:
    prompt: np.ndarray
    params: SamplingParams
    stream: _Stream
    queued_s: float = dataclasses.field(default_factory=time.perf_counter)


class EngineServer:
    """The HTTP handlers and the engine thread that feeds them."""

    def __init__(self, engine, *, model_name: str = "elana", idle_wait_s: float = 0.01):
        self.engine = engine
        self.model_name = model_name
        self.idle_wait_s = idle_wait_s
        self._subq: "queue.Queue[_Submission]" = queue.Queue()
        self._streams: Dict[int, _Stream] = {}
        self._reqs: Dict[int, object] = {}
        # engine exclusivity: the engine thread holds it across step();
        # metrics scrapes hold it across latency_summary()
        self._lock = threading.Lock()
        # the engine's failure against new submissions: a request is either
        # queued before the failure drains the queue, or refused after it
        self._sub_lock = threading.Lock()
        self._admitting: Optional[_Submission] = None
        self.error: Optional[BaseException] = None
        self._run = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t_started = time.perf_counter()
        self.requests_received = 0
        self.chunks_streamed = 0
        # each finished request's (engine submit, queued, first tokens at the
        # hook) stamps, the newest 65536: with the client's send and first
        # chunk they split the client-minus-engine TTFT into its parts
        self.front_stamps: Deque[Tuple[float, float, float]] = collections.deque(maxlen=65536)
        engine.stream_hook = self._on_tokens

    # -- engine thread ---------------------------------------------------------
    def _on_tokens(self, uid: int, tokens: List[int], finished: bool) -> None:
        """``engine.stream_hook``: runs on the engine thread mid-step."""
        h = self._streams.get(uid)
        if h is None:
            return
        now = time.perf_counter()
        if tokens:
            if h.first_hook_s is None:
                h.first_hook_s = now
            h.push(("tokens", list(tokens), now))
        if finished:
            req = self._reqs.pop(uid, None)
            self._streams.pop(uid, None)
            if req is not None:
                self.front_stamps.append((req.submit_time, h.queued_s, h.first_hook_s))
            h.push(("end", self._final_payload(req), now))

    @staticmethod
    def _final_payload(req) -> Dict:
        if req is None:  # pragma: no cover - submit/finish race guard
            return {}
        return {
            "engine_submit_s": req.submit_time,
            "engine_first_token_s": req.first_token_time,
            "engine_finish_s": req.finish_time,
            "engine_ttft_s": req.ttft_s,
            "engine_tpot_s": req.tpot_s,
            "prompt_tokens": len(req.prompt),
            "completion_tokens": len(req.output_tokens),
            "joules": req.joules,
            "truncated": req.truncated,
            "preemptions": req.preemptions,
        }

    def _admit(self, sub: _Submission) -> None:
        self._admitting = sub
        with self._lock:
            uid = self.engine.submit(sub.prompt, sub.params)
            req = self.engine.queue[-1]
        sub.stream.uid = uid
        sub.stream.queued_s = sub.queued_s
        self._reqs[uid] = req
        self._streams[uid] = sub.stream
        self._admitting = None
        sub.stream.push(("begin", uid, req.submit_time))

    def _engine_loop(self) -> None:
        eng = self.engine
        try:
            on_device = (torch.cuda.device(eng.device) if eng.device.type == "cuda"
                         else contextlib.nullcontext())
            with on_device:
                while self._run.is_set():
                    while True:  # drain every pending submission before the step
                        try:
                            self._admit(self._subq.get_nowait())
                        except queue.Empty:
                            break
                    if eng.busy:
                        with self._lock:
                            eng.step()
                    else:
                        try:  # idle: block on the queue instead of spinning
                            sub = self._subq.get(timeout=self.idle_wait_s)
                        except queue.Empty:
                            continue
                        self._admit(sub)
                with self._lock:
                    eng.flush()
        except Exception as exc:  # the thread's boundary: keep it, end every stream
            self._fail(exc)

    def _fail(self, exc: BaseException) -> None:
        with self._sub_lock:
            self.error = exc
            pending = [] if self._admitting is None else [self._admitting]
            while True:
                try:
                    pending.append(self._subq.get_nowait())
                except queue.Empty:
                    break
        message = _failed(exc)
        for h in list(self._streams.values()) + [s.stream for s in pending]:
            h.push(("error", message))
        self._streams.clear()
        self._reqs.clear()

    def start_engine(self) -> None:
        self._run.set()
        self._thread = threading.Thread(target=self._engine_loop, daemon=True,
                                        name="elana-engine")
        self._thread.start()

    def stop_engine(self) -> None:
        self._run.clear()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def raise_if_failed(self) -> None:
        if self.error is not None:
            raise self.error

    def summary(self) -> Dict:
        """Engine ``latency_summary()`` and the server's counters; re-raises
        the engine thread's exception where it failed."""
        self.raise_if_failed()
        with self._lock:
            out = dict(self.engine.latency_summary())
        out.update({
            "server_requests_received": self.requests_received,
            "server_chunks_streamed": self.chunks_streamed,
            "server_in_flight": len(self._streams),
            "server_uptime_s": time.perf_counter() - self._t_started,
        })
        return out

    # -- HTTP ------------------------------------------------------------------
    async def handle_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        """Serve one connection's requests in turn (HTTP/1.1 keep-alive)
        until the peer closes it or asks to."""
        try:
            keep_alive = True
            while keep_alive:
                try:
                    msg = await wire.read_head(reader)
                    if msg is None:
                        break
                    start, headers = msg
                    method, target, version = (start.split(" ") + ["", ""])[:3]
                    body = await wire.read_body(reader, headers)
                except wire.HttpError as e:
                    await self._send_json(writer, e.status, _error(e.message), False)
                    break
                keep_alive = (version == "HTTP/1.1"
                              and headers.get("connection", "").lower() != "close")
                keep_alive = await self._route(method, target.split("?")[0], body, writer,
                                               keep_alive)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the peer went away mid-message
        finally:
            writer.close()
            with contextlib.suppress(ConnectionError):
                await writer.wait_closed()

    async def _route(self, method: str, path: str, body: bytes, writer, keep_alive: bool) -> bool:
        routes = {"/v1/completions": ("POST", self._completions),
                  "/v1/models": ("GET", self._models),
                  "/metrics": ("GET", self._metrics)}
        if path not in routes:
            return await self._send_json(writer, 404, _error(f"no route {path}"), keep_alive)
        want, handler = routes[path]
        if method != want:
            return await self._send_json(writer, 405, _error(f"{path} takes {want}"),
                                         keep_alive)
        return await handler(body, writer, keep_alive)

    @staticmethod
    async def _send_json(writer, status: int, obj, keep_alive: bool) -> bool:
        data = json.dumps(obj, default=float).encode()
        writer.write(wire.head(status, {
            "Content-Type": _JSON, "Content-Length": str(len(data)),
            "Connection": "keep-alive" if keep_alive else "close"}) + data)
        await writer.drain()
        return keep_alive

    async def _models(self, body: bytes, writer, keep_alive: bool) -> bool:
        return await self._send_json(writer, 200, {
            "object": "list",
            "data": [{"id": self.model_name, "object": "model", "owned_by": "elana"}],
        }, keep_alive)

    async def _metrics(self, body: bytes, writer, keep_alive: bool) -> bool:
        if self.error is not None:
            return await self._send_json(writer, 500, _error(_failed(self.error)), keep_alive)
        return await self._send_json(writer, 200, self.summary(), keep_alive)

    async def _completions(self, raw: bytes, writer, keep_alive: bool) -> bool:
        try:
            body = json.loads(raw)
        except ValueError:
            return await self._send_json(writer, 400, _error("body must be JSON"), keep_alive)
        if not isinstance(body, dict):
            return await self._send_json(writer, 400, _error("body must be a JSON object"),
                                         keep_alive)
        try:
            prompt = encode_prompt(body.get("prompt", ""), self.engine.cfg.vocab_size)
            params = SamplingParams(
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0)),
                eos_token=int(body.get("eos_token", -1)),
                max_new_tokens=int(body.get("max_tokens", 16)))
            if params.max_new_tokens < 1:
                raise ValueError("max_tokens must be >= 1")
        except (TypeError, ValueError) as e:
            return await self._send_json(writer, 400, _error(str(e)), keep_alive)

        handle = _Stream(asyncio.get_running_loop())
        with self._sub_lock:
            failed = self.error
            if failed is None:
                self.requests_received += 1
                self._subq.put(_Submission(prompt, params, handle))
        if failed is not None:
            return await self._send_json(writer, 500, _error(_failed(failed)), keep_alive)
        item = await handle.q.get()  # ("begin", uid, t) or ("error", message)
        if item[0] == "error":
            return await self._send_json(writer, 500, _error(item[1]), keep_alive)
        uid = item[1]
        cid = f"cmpl-{uid}"
        created = int(time.time())
        if bool(body.get("stream", False)):
            return await self._stream_response(writer, handle, cid, created,
                                               params.max_new_tokens, keep_alive)
        tokens: List[int] = []
        while True:
            item = await handle.q.get()
            if item[0] == "tokens":
                tokens.extend(item[1])
            elif item[0] == "error":
                return await self._send_json(writer, 500, _error(item[1]), keep_alive)
            else:
                payload = item[1]
                break
        return await self._send_json(writer, 200, {
            "id": cid, "object": "text_completion", "created": created,
            "model": self.model_name,
            "choices": [{"index": 0, "text": "".join(f" {t}" for t in tokens),
                         "finish_reason": _finish_reason(payload, params.max_new_tokens)}],
            "usage": _usage(payload),
            "elana": {**payload, "tokens": tokens},
        }, keep_alive)

    async def _stream_response(self, writer, handle: _Stream, cid: str, created: int,
                               max_tokens: int, keep_alive: bool) -> bool:
        writer.write(wire.head(200, {
            "Content-Type": "text/event-stream", "Cache-Control": "no-cache",
            "Connection": "keep-alive" if keep_alive else "close",
            "Transfer-Encoding": "chunked"}))
        index = 0
        alive = True  # keep draining after a disconnect: the engine runs the
        # request to its end either way, and the end event unregisters it

        async def send(data: bytes) -> None:
            nonlocal alive
            if not alive:
                return
            try:
                writer.write(wire.chunk(data))
                await writer.drain()
            except ConnectionError:
                alive = False

        while True:
            item = await handle.q.get()
            if item[0] == "tokens":
                _, toks, t_emit = item
                chunk = {
                    "id": cid, "object": "text_completion", "created": created,
                    "model": self.model_name,
                    "choices": [{"index": 0, "text": "".join(f" {t}" for t in toks),
                                 "finish_reason": None}],
                    "elana": {"tokens": toks, "first_index": index, "emit_s": t_emit},
                }
                index += len(toks)
                await send(b"data: " + json.dumps(chunk).encode() + b"\n\n")
                self.chunks_streamed += 1
            elif item[0] == "error":
                return False  # closed without [DONE] or the last chunk
            else:  # ("end", payload, t)
                payload = item[1]
                final = {
                    "id": cid, "object": "text_completion", "created": created,
                    "model": self.model_name,
                    "choices": [{"index": 0, "text": "",
                                 "finish_reason": _finish_reason(payload, max_tokens)}],
                    "usage": _usage(payload),
                    "elana": payload,
                }
                await send(b"data: " + json.dumps(final).encode() + b"\n\n")
                await send(b"data: [DONE]\n\n")
                if alive:
                    writer.write(wire.LAST_CHUNK)
                    await writer.drain()
                return alive and keep_alive


def _error(message: str) -> Dict:
    return {"error": {"message": message}}


def _failed(exc: BaseException) -> str:
    return f"the engine failed: {type(exc).__name__}: {exc}"


def _finish_reason(payload: Dict, max_tokens: int) -> str:
    return "length" if payload.get("completion_tokens", 0) >= max_tokens else "stop"


def _usage(payload: Dict) -> Dict:
    prompt, completion = payload.get("prompt_tokens", 0), payload.get("completion_tokens", 0)
    return {"prompt_tokens": prompt, "completion_tokens": completion,
            "total_tokens": prompt + completion}


class ServerHandle:
    """A running server: the engine thread, and the asyncio server on an
    event-loop thread of its own."""

    def __init__(self, url: str, server: EngineServer, loop: asyncio.AbstractEventLoop,
                 aserver: asyncio.AbstractServer, connections: Set[asyncio.Task],
                 thread: threading.Thread):
        self.url, self.server = url, server
        self._loop, self._aserver, self._connections = loop, aserver, connections
        self._thread = thread
        self._closed = False

    def close(self) -> None:
        """Stop the engine loop (it flushes the engine), stop accepting,
        cancel the open connections, stop and join the event-loop thread;
        then re-raise the engine thread's exception where it failed."""
        if not self._closed:
            self._closed = True
            self.server.stop_engine()

            async def shutdown():
                self._aserver.close()
                tasks = list(self._connections)
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)

            asyncio.run_coroutine_threadsafe(shutdown(), self._loop).result(timeout=10.0)
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=10.0)
            self._loop.close()
        self.server.raise_if_failed()

    def __enter__(self) -> "ServerHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_http_server(engine, *, host: str = "127.0.0.1", port: int = 0,
                      model_name: str = "elana") -> ServerHandle:
    """Serve ``engine`` over HTTP; ``port=0`` picks a free port.  Starts one
    event-loop thread for the HTTP side and one engine thread for the
    admit/step loop, and returns once both accept work."""
    srv = EngineServer(engine, model_name=model_name)
    loop = asyncio.new_event_loop()
    connections: Set[asyncio.Task] = set()
    started = threading.Event()
    box: Dict[str, object] = {}

    async def connection(reader, writer):
        task = asyncio.current_task()
        connections.add(task)
        try:
            await srv.handle_connection(reader, writer)
        finally:
            connections.discard(task)

    def run() -> None:
        asyncio.set_event_loop(loop)
        try:
            aserver = loop.run_until_complete(asyncio.start_server(connection, host, port))
        except OSError as e:  # the address is taken or not ours
            box["error"] = e
            started.set()
            return
        box["server"] = aserver
        box["port"] = aserver.sockets[0].getsockname()[1]
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True, name="elana-http")
    thread.start()
    if not started.wait(timeout=10.0):  # pragma: no cover
        raise RuntimeError("the HTTP server did not start within 10 s")
    if "error" in box:
        thread.join()
        loop.close()
        raise box["error"]
    srv.start_engine()
    return ServerHandle(f"http://{host}:{box['port']}", srv, loop, box["server"],
                        connections, thread)
