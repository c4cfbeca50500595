"""S3-style blob store: server core, client, and the backup container.

The analog of fdbrpc/BlobStore.actor.cpp (the `blobstore://` backup
target) + the URL scheme of fdbclient/BackupContainer.actor.cpp:1. The
server core is transport-independent (an object map with bucket/key
paths); it mounts either on a simulated process (blob traffic through
the sim's fault model) or behind a real socket (tools/blobserver). The
API is S3-shaped path-style without auth/XML — documented simplification;
the mechanism (HTTP object PUT/GET/DELETE/LIST behind the container
interface) is what the reference's blob tier provides:

    PUT    /b/<bucket>/<key>          store object
    GET    /b/<bucket>/<key>          fetch object (404 when absent)
    DELETE /b/<bucket>/<key>          delete object
    GET    /b/<bucket>?prefix=<p>     list keys (JSON array)

URL scheme: blobstore://host:port/bucket/name
"""

from __future__ import annotations

import json
import threading
from urllib.parse import quote, unquote, urlparse

from ..net import http
from ..runtime.serialize import BinaryReader, BinaryWriter


class BlobStoreServer:
    """The object map + request handler (transport-independent)."""

    def __init__(self):
        self.objects: dict[tuple[str, str], bytes] = {}
        self._lock = threading.Lock()  # the real server is threaded

    def handle(self, method: str, path: str, body: bytes):
        """(status, body) for one request."""
        path, _, query = path.partition("?")
        parts = [unquote(p) for p in path.split("/") if p]
        if not parts or parts[0] != "b":
            return 400, b"bad path"
        if len(parts) == 2 and method == "GET":
            # list bucket
            prefix = ""
            for kv in query.split("&"):
                k, _, v = kv.partition("=")
                if k == "prefix":
                    prefix = unquote(v)
            bucket = parts[1]
            with self._lock:
                keys = sorted(
                    k
                    for (b, k) in self.objects
                    if b == bucket and k.startswith(prefix)
                )
            return 200, json.dumps(keys).encode()
        if len(parts) < 3:
            return 400, b"bucket/key required"
        bucket, key = parts[1], "/".join(parts[2:])
        with self._lock:
            if method == "PUT":
                self.objects[(bucket, key)] = body
                return 200, b""
            if method == "GET":
                blob = self.objects.get((bucket, key))
                return (200, blob) if blob is not None else (404, b"")
            if method == "DELETE":
                self.objects.pop((bucket, key), None)
                return 200, b""
        return 400, b"bad method"

    def handle_raw(self, raw: bytes) -> bytes:
        parsed = http.parse_request(bytes(raw))
        if parsed is None:
            return http.encode_response(400, b"truncated")
        method, path, _headers, body = parsed
        try:
            status, rbody = self.handle(method, path, body)
        except Exception as e:  # a bad request must not kill the server
            return http.encode_response(500, repr(e).encode())
        return http.encode_response(status, rbody)

    def mount_sim(self, process) -> None:
        """Serve over the simulator's network (http.request endpoint)."""

        async def handler(raw):
            return self.handle_raw(raw)

        process.register("http.request", handler)


class BlobStoreClient:
    def __init__(self, transport, bucket: str):
        self.http = http.HttpClient(transport)
        self.bucket = bucket

    def _path(self, key: str) -> str:
        return f"/b/{quote(self.bucket, safe='')}/{quote(key, safe='/')}"

    async def put(self, key: str, blob: bytes) -> None:
        await self.http.request("PUT", self._path(key), blob)

    async def get(self, key: str):
        status, body = await self.http.request(
            "GET", self._path(key), ok=(200, 404)
        )
        return body if status == 200 else None

    async def delete(self, key: str) -> None:
        await self.http.request("DELETE", self._path(key))

    async def list(self, prefix: str = "") -> list[str]:
        status, body = await self.http.request(
            "GET",
            f"/b/{quote(self.bucket, safe='')}?prefix={quote(prefix, safe='')}",
        )
        return json.loads(body.decode())


def parse_blobstore_url(url: str):
    """blobstore://host:port/bucket/name → (host, port, bucket, name)."""
    u = urlparse(url)
    assert u.scheme == "blobstore", url
    parts = [p for p in u.path.split("/") if p]
    if len(parts) < 2:
        raise ValueError(f"blobstore url needs /bucket/name: {url}")
    return u.hostname, u.port or 80, parts[0], "/".join(parts[1:])


class BlobStoreContainer:
    """BackupContainer surface over a blob store (the `blobstore://`
    personality of fdbclient/BackupContainer.actor.cpp)."""

    def __init__(self, client: BlobStoreClient, name: str):
        self.client = client
        self.name = name
        self._log_seq = None  # discovered lazily (needs an await)

    @classmethod
    def from_url(cls, url: str, transport_factory) -> "BlobStoreContainer":
        host, port, bucket, name = parse_blobstore_url(url)
        transport = transport_factory(host, port)
        return cls(BlobStoreClient(transport, bucket), name)

    async def _next_log_seq(self) -> int:
        if self._log_seq is None:
            seqs = [
                int(k.rsplit("/", 1)[1])
                for k in await self.client.list(f"{self.name}/log/")
            ]
            self._log_seq = max(seqs) + 1 if seqs else 0
        seq = self._log_seq
        self._log_seq += 1
        return seq

    async def reset(self) -> None:
        for k in await self.client.list(f"{self.name}/"):
            await self.client.delete(k)
        self._log_seq = 0

    async def write_meta(self, meta: dict) -> None:
        await self.client.put(
            f"{self.name}/meta.json", json.dumps(meta).encode()
        )

    async def read_meta(self) -> dict:
        blob = await self.client.get(f"{self.name}/meta.json")
        return json.loads(blob.decode()) if blob else {}

    async def write_snapshot_chunk(self, index: int, rows: list) -> None:
        w = BinaryWriter()
        w.u32(len(rows))
        for k, v in rows:
            w.bytes_(k).bytes_(v)
        await self.client.put(f"{self.name}/snap/{index:06d}", w.data())

    async def read_snapshot(self) -> list:
        rows = []
        for key in sorted(await self.client.list(f"{self.name}/snap/")):
            r = BinaryReader(await self.client.get(key))
            n = r.u32()
            for _ in range(n):
                rows.append((r.bytes_(), r.bytes_()))
        return rows

    async def append_log_chunk(self, entries: list) -> None:
        w = BinaryWriter()
        w.u32(len(entries))
        for k, v in entries:
            w.bytes_(k).bytes_(v)
        seq = await self._next_log_seq()
        await self.client.put(f"{self.name}/log/{seq:06d}", w.data())

    async def read_log(self) -> list:
        entries = []
        for key in sorted(await self.client.list(f"{self.name}/log/")):
            r = BinaryReader(await self.client.get(key))
            n = r.u32()
            for _ in range(n):
                entries.append((r.bytes_(), r.bytes_()))
        entries.sort()  # log keys embed the version: commit order
        return entries


def open_container(url_or_name: str, sim=None, process=None, loop=None):
    """Container factory over the URL scheme
    (fdbclient/BackupContainer.actor.cpp:1 openContainer):

      blobstore://host:port/bucket/name  → BlobStoreContainer
        (sim + process → sim transport to the process at `host`;
         loop → real sockets)
      file://dir/name | bare name        → directory-backed container
        (requires sim for the disk)
    """
    if url_or_name.startswith("blobstore://"):
        host, port, bucket, name = parse_blobstore_url(url_or_name)
        if loop is not None:
            transport = http.RealHttpTransport(loop, host, port)
        else:
            assert process is not None, "sim blobstore needs a process"
            transport = http.SimHttpTransport(process, host)
        return BlobStoreContainer(BlobStoreClient(transport, bucket), name)
    from .container import BackupContainer

    name = url_or_name
    if name.startswith("file://"):
        name = name[len("file://"):]
    assert sim is not None, "file container needs the sim's disk"
    disk_name, _, base = name.rpartition("/")
    return BackupContainer(sim.disk(disk_name or "backup-store"), base or name)
