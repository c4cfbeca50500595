"""Minimal HTTP/1.1: framing, async client, two transports.

The analog of fdbrpc/HTTP.actor.cpp (doRequest framing over a
connection) in the shape this codebase needs: Content-Length framing
only (no chunked encoding — the blob tier controls both ends), an async
client whose transport is pluggable:

- ``SimHttpTransport``: the whole HTTP byte stream round-trips through a
  simulated process endpoint, so blob traffic gets the simulator's
  latency/partition/kill model for free while the framing code is the
  REAL one under test.
- ``RealHttpTransport``: one non-blocking TCP connection per request on
  the RealLoop (connect → write → read-to-completion), for talking to an
  actual blob server over the wire.
"""

from __future__ import annotations

from typing import Optional

from ..runtime.futures import Future


class HttpError(Exception):
    pass


def encode_request(
    method: str, path: str, body: bytes = b"", headers: dict = None
) -> bytes:
    h = {"Content-Length": str(len(body)), "Connection": "close"}
    h.update(headers or {})
    lines = [f"{method} {path} HTTP/1.1"]
    lines += [f"{k}: {v}" for k, v in h.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + body


def encode_response(status: int, body: bytes = b"", headers: dict = None) -> bytes:
    reason = {200: "OK", 204: "No Content", 404: "Not Found",
              400: "Bad Request", 500: "Internal Server Error"}.get(status, "?")
    h = {"Content-Length": str(len(body))}
    h.update(headers or {})
    lines = [f"HTTP/1.1 {status} {reason}"]
    lines += [f"{k}: {v}" for k, v in h.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + body


def parse_message(raw: bytes):
    """(start_line, headers dict, body) — or None if incomplete."""
    split = raw.find(b"\r\n\r\n")
    if split < 0:
        return None
    head = raw[:split].decode("latin-1").split("\r\n")
    headers = {}
    for line in head[1:]:
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", "0"))
    body = raw[split + 4 : split + 4 + n]
    if len(body) < n:
        return None
    return head[0], headers, body


def parse_request(raw: bytes):
    """(method, path, headers, body) or None if incomplete."""
    msg = parse_message(raw)
    if msg is None:
        return None
    start, headers, body = msg
    parts = start.split(" ")
    if len(parts) < 3:
        raise HttpError(f"bad request line {start!r}")
    return parts[0], parts[1], headers, body


def parse_response(raw: bytes):
    """(status, headers, body) or None if incomplete."""
    msg = parse_message(raw)
    if msg is None:
        return None
    start, headers, body = msg
    parts = start.split(" ")
    if len(parts) < 2 or not parts[0].startswith("HTTP/"):
        raise HttpError(f"bad status line {start!r}")
    return int(parts[1]), headers, body


class SimHttpTransport:
    """Requests ride the simulator's network as one message each; the
    server side (blobstore.mount_sim) parses and answers the same bytes
    a real socket would carry."""

    def __init__(self, process, server_addr: str):
        from .sim import Endpoint

        self.process = process
        self.ep = Endpoint(server_addr, "http.request")

    async def round_trip(self, raw_request: bytes) -> bytes:
        return await self.process.request(self.ep, raw_request)


class RealHttpTransport:
    """One short-lived TCP connection per request, driven by the
    RealLoop's readiness callbacks (no threads, no blocking)."""

    def __init__(self, loop, host: str, port: int):
        self.loop = loop
        self.host = host
        self.port = port

    async def round_trip(self, raw_request: bytes) -> bytes:
        import socket

        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        fut: Future = Future()
        state = {"out": bytearray(raw_request), "in": bytearray()}

        def fail(e):
            cleanup()
            if not fut.is_ready():
                fut._set_error(e)

        def cleanup():
            try:
                self.loop.remove_reader(sock)
            except Exception:
                pass
            try:
                self.loop.remove_writer(sock)
            except Exception:
                pass

        def on_writable():
            try:
                while state["out"]:
                    n = sock.send(state["out"])
                    if n <= 0:
                        break
                    del state["out"][:n]
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                fail(e)
                return
            if not state["out"]:
                self.loop.remove_writer(sock)

        def on_readable():
            try:
                data = sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                fail(e)
                return
            if data:
                state["in"] += data
                # connection-close framing finishes on EOF; but finish
                # early once Content-Length is satisfied
                parsed = None
                try:
                    parsed = parse_response(bytes(state["in"]))
                except HttpError as e:
                    fail(e)
                    return
                if parsed is None:
                    return
            cleanup()
            if not fut.is_ready():
                try:
                    parsed = parse_response(bytes(state["in"]))
                except HttpError as e:
                    fut._set_error(e)
                    return
                if parsed is None:
                    fut._set_error(HttpError("connection closed mid-response"))
                else:
                    fut._set(bytes(state["in"]))

        try:
            sock.connect((self.host, self.port))
        except BlockingIOError:
            pass
        except OSError as e:
            fail(e)
        self.loop.add_writer(sock, on_writable)
        self.loop.add_reader(sock, on_readable)
        try:
            raw = await fut
        finally:
            cleanup()
            try:
                sock.close()
            except OSError:
                pass
        return raw


class HttpClient:
    """Method helpers over a transport; raises HttpError on non-2xx
    unless the status is in ``ok`` (404 is a normal answer for GETs)."""

    def __init__(self, transport):
        self.transport = transport

    async def request(
        self,
        method: str,
        path: str,
        body: bytes = b"",
        ok: tuple = (200, 204),
    ):
        raw = await self.transport.round_trip(
            encode_request(method, path, body)
        )
        parsed = parse_response(raw if isinstance(raw, bytes) else bytes(raw))
        if parsed is None:
            raise HttpError("truncated response")
        status, headers, rbody = parsed
        if status not in ok:
            raise HttpError(f"{method} {path} -> {status}: {rbody[:200]!r}")
        return status, rbody
