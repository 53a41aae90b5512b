"""Streaming client for the OpenAI-compatible server, the counterpart of
``repro/serving/client.py`` on the standard library (``asyncio`` streams
and the HTTP/1.1 framing of ``serving/wire.py``).

``stream_completion`` drives one ``POST /v1/completions`` with
``stream=true`` and records the client's view of the request:

* ``send_time``        — just before the request is written;
* ``first_chunk_time`` — arrival of the first chunk that carries tokens
  (the client's TTFT edge);
* ``last_chunk_time``  — arrival of the last chunk that carries tokens
  (the client's TTLT edge; the final summary chunk and ``[DONE]`` come
  after it and are left out on purpose).

The final chunk's ``elana`` extension carries the engine's own
``perf_counter`` stamps for the same request.  ``perf_counter`` is one
clock per machine, so with client and server on one host the deltas mean
what they say: ``client_ttft >= engine_ttft``, and the gap is the HTTP
and queueing time the server adds to the engine's.

The reference's functions take an ``aiohttp.ClientSession`` first; these
open one connection per call and take ``base_url`` first.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import time
import urllib.parse
from typing import AsyncIterator, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.serving import wire


@dataclasses.dataclass
class ClientRecord:
    """One streamed request as the client saw it."""
    send_time: float = 0.0
    first_chunk_time: float = 0.0
    last_chunk_time: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    chunks: int = 0
    finish_reason: str = ""
    usage: Dict = dataclasses.field(default_factory=dict)
    engine: Dict = dataclasses.field(default_factory=dict)  # the ``elana`` payload
    joules: float = 0.0       # the client-side attributed share (loadgen)
    error: str = ""

    # -- client-side latencies -------------------------------------------------
    @property
    def client_ttft_s(self) -> float:
        return self.first_chunk_time - self.send_time

    @property
    def client_ttlt_s(self) -> float:
        return self.last_chunk_time - self.send_time

    @property
    def client_tpot_s(self) -> float:
        n = len(self.tokens)
        if n < 2:
            return 0.0
        return (self.last_chunk_time - self.first_chunk_time) / (n - 1)

    # -- engine-side latencies (from the final chunk's elana payload) ----------
    @property
    def engine_ttft_s(self) -> float:
        return float(self.engine.get("engine_ttft_s") or 0.0)

    @property
    def engine_tpot_s(self) -> float:
        return float(self.engine.get("engine_tpot_s") or 0.0)


async def _request(base_url: str, method: str, path: str, payload: Optional[Dict] = None
                   ) -> Tuple[asyncio.StreamReader, asyncio.StreamWriter, int, Dict[str, str]]:
    """Open a connection, send one request and read the response's head.
    Returns (reader, writer, status, headers); the caller closes writer."""
    url = urllib.parse.urlsplit(base_url)
    host, port = url.hostname or "127.0.0.1", url.port or 80
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = b"" if payload is None else json.dumps(payload).encode()
        writer.write((f"{method} {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
                      f"Content-Type: application/json\r\nContent-Length: {len(body)}\r\n"
                      f"Accept: */*\r\nConnection: close\r\n\r\n").encode("latin-1") + body)
        await writer.drain()
        msg = await wire.read_head(reader)
        if msg is None:
            raise ConnectionError("the server closed the connection without a response")
        start, headers = msg
        parts = start.split(" ", 2)
        if len(parts) < 2 or not parts[0].startswith("HTTP/"):
            raise wire.HttpError(502, f"bad status line {start!r}")
        return reader, writer, int(parts[1]), headers
    except BaseException:
        writer.close()
        raise


async def _read_all(reader: asyncio.StreamReader, headers: Dict[str, str]) -> bytes:
    return b"".join([b async for b in wire.body_blocks(reader, headers, until_eof=True)])


async def _closed(writer: asyncio.StreamWriter) -> None:
    writer.close()
    with contextlib.suppress(ConnectionError):
        await writer.wait_closed()


async def sse_data(blocks: AsyncIterator[bytes]) -> AsyncIterator[str]:
    """The payload of each ``data:`` line of a server-sent event stream
    arriving as byte blocks."""
    buf = b""
    async for block in blocks:
        buf += block
        *lines, buf = buf.split(b"\n")
        for raw in lines:
            line = raw.strip()
            if line.startswith(b"data:"):
                yield line[5:].strip().decode()


async def stream_completion(
    base_url: str, prompt: Union[str, Sequence[int]], *, max_tokens: int = 16,
    temperature: float = 0.0, top_k: int = 0, eos_token: int = -1,
    model: str = "elana", timeout_s: float = 300.0,
) -> ClientRecord:
    """One streaming completion; never raises: errors land in ``.error``,
    a stream that ends without ``data: [DONE]`` among them."""
    rec = ClientRecord()
    payload = {
        "model": model,
        "prompt": list(prompt) if not isinstance(prompt, str) else prompt,
        "max_tokens": max_tokens,
        "temperature": temperature,
        "top_k": top_k,
        "eos_token": eos_token,
        "stream": True,
    }
    writer = None
    rec.send_time = time.perf_counter()
    try:
        async with asyncio.timeout(timeout_s):
            reader, writer, status, headers = await _request(
                base_url, "POST", "/v1/completions", payload)
            if status != 200:
                text = (await _read_all(reader, headers)).decode(errors="replace")
                rec.error = f"HTTP {status}: {text}"
                return rec
            done = False
            async for data in sse_data(wire.body_blocks(reader, headers, until_eof=True)):
                if data == "[DONE]":
                    done = True
                    break
                now = time.perf_counter()
                obj = json.loads(data)
                ext = obj.get("elana", {})
                if "tokens" in ext and obj["choices"][0]["finish_reason"] is None:
                    if not rec.tokens:
                        rec.first_chunk_time = now
                    rec.last_chunk_time = now
                    rec.tokens.extend(ext["tokens"])
                    rec.chunks += 1
                else:  # the final chunk: usage and the engine's stamps
                    rec.finish_reason = obj["choices"][0]["finish_reason"] or ""
                    rec.usage = obj.get("usage", {})
                    rec.engine = ext
            if not done:
                rec.error = "the stream ended without data: [DONE]"
    except Exception as e:  # connection reset, timeout, bad JSON ...
        rec.error = f"{type(e).__name__}: {e}"
    finally:
        if writer is not None:
            await _closed(writer)
    return rec


async def fetch_metrics(base_url: str) -> Dict:
    """``GET /metrics`` as a dict; raises on a status other than 200."""
    reader, writer, status, headers = await _request(base_url, "GET", "/metrics")
    try:
        body = await _read_all(reader, headers)
    finally:
        await _closed(writer)
    if status != 200:
        raise RuntimeError(f"GET /metrics: HTTP {status}: {body.decode(errors='replace')}")
    return json.loads(body)
