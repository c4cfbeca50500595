"""blobserver: the local S3-style stub server over real sockets.

The test/dev target for `blobstore://` backups (the role a MinIO or S3
endpoint plays for the reference's fdbbackup). Thread-per-connection
blocking sockets — it is a stub, not a production store; the object map
+ HTTP handling live in backup/blobstore.py (shared with the simulated
mount).

  python -m foundationdb_tpu_torch.tools.blobserver --port 8333

The port's copy of ``foundationdb_tpu/tools/blobserver.py``, over the
port's ``backup/blobstore.py``.
"""

from __future__ import annotations

import socket
import threading

from ..backup.blobstore import BlobStoreServer
from ..net import http


class RealBlobServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.core = BlobStoreServer()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(64)
        self.port = self.sock.getsockname()[1]
        self._stop = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)

    def start(self) -> "RealBlobServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop = True
        try:
            self.sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _addr = self.sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        buf = bytearray()
        try:
            conn.settimeout(30)
            while True:
                parsed = http.parse_request(bytes(buf))
                if parsed is not None:
                    break
                data = conn.recv(1 << 16)
                if not data:
                    return
                buf += data
            conn.sendall(self.core.handle_raw(bytes(buf)))
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="blobserver")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8333)
    args = ap.parse_args(argv)
    srv = RealBlobServer(args.host, args.port).start()
    print(f"blobserver listening on {args.host}:{srv.port}", flush=True)
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
