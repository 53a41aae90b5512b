"""HTTP/1.1 framing on asyncio streams, standard library only: what the
OpenAI-compatible server (``serving/server.py``) and its client
(``serving/client.py``) need of the protocol, and no more.

* ``read_head`` — a message's start line and headers;
* ``body_blocks`` — its body as it arrives: chunked, by Content-Length,
  or (a response with neither) up to the end of the connection;
* ``head``, ``chunk``, ``LAST_CHUNK`` — the bytes of a response head and
  of the chunked transfer coding a streamed response is written in.

A peer speaking HTTP/1.1 (aiohttp's client and server, curl) reads and
writes these messages as it would its own.
"""

from __future__ import annotations

import asyncio
import http
from typing import AsyncIterator, Dict, Optional, Tuple

MAX_BODY = 16 * 2**20  # a request body larger than this is refused
LAST_CHUNK = b"0\r\n\r\n"


class HttpError(Exception):
    """A malformed or refused message; ``status`` is the response's."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


async def read_head(reader: asyncio.StreamReader
                    ) -> Optional[Tuple[str, Dict[str, str]]]:
    """(start line, headers with lower-cased names) of the next message;
    None where the peer closed before sending a byte of it."""
    try:
        raw = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial.strip():
            return None
        raise HttpError(400, "the message head ended early") from None
    except asyncio.LimitOverrunError:
        raise HttpError(431, "the message head is too large") from None
    lines = raw[:-4].decode("latin-1").split("\r\n")
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        name, sep, value = line.partition(":")
        if not sep:
            raise HttpError(400, f"bad header line {line!r}")
        headers[name.strip().lower()] = value.strip()
    return lines[0], headers


async def body_blocks(reader: asyncio.StreamReader, headers: Dict[str, str],
                      *, until_eof: bool = False) -> AsyncIterator[bytes]:
    """The body's bytes, block by block as they arrive.  A body that
    stops short raises ``asyncio.IncompleteReadError``; so does a chunked
    one whose connection closes before its last chunk."""
    if "chunked" in headers.get("transfer-encoding", "").lower():
        while True:
            size_line = await reader.readuntil(b"\r\n")
            try:
                size = int(size_line.split(b";")[0].strip(), 16)
            except ValueError:
                raise HttpError(400, f"bad chunk size line {size_line!r}") from None
            if size == 0:
                while await reader.readuntil(b"\r\n") != b"\r\n":  # trailers
                    pass
                return
            data = await reader.readexactly(size)
            await reader.readexactly(2)
            yield data
    elif "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise HttpError(400, "bad Content-Length") from None
        if n:
            yield await reader.readexactly(n)
    elif until_eof:
        while True:
            data = await reader.read(65536)
            if not data:
                return
            yield data


async def read_body(reader: asyncio.StreamReader, headers: Dict[str, str]) -> bytes:
    """A request's whole body (none without Content-Length or chunks)."""
    if int(headers.get("content-length", "0") or 0) > MAX_BODY:
        raise HttpError(413, f"the body is larger than {MAX_BODY} bytes")
    parts, size = [], 0
    async for block in body_blocks(reader, headers):
        size += len(block)
        if size > MAX_BODY:
            raise HttpError(413, f"the body is larger than {MAX_BODY} bytes")
        parts.append(block)
    return b"".join(parts)


def head(status: int, headers: Dict[str, str]) -> bytes:
    """A response's status line and headers, with the blank line."""
    lines = [f"HTTP/1.1 {status} {http.HTTPStatus(status).phrase}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def chunk(data: bytes) -> bytes:
    """``data`` as one chunk of the chunked transfer coding."""
    return b"%X\r\n%s\r\n" % (len(data), data)
