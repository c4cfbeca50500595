"""Serializability: concurrent read-modify-write transactions whose commit
history must replay exactly against a model.

The analog of fdbserver/workloads/Serializability.actor.cpp, strengthened
into a total-order replay check: N clients race transactions over ONE
shared keyspace. Each transaction reads a random key set, then writes
values derived from everything it read, and records itself under a
versionstamped log key (the versionstamp IS the commit order). The check
phase replays the committed log in versionstamp order against a
ModelStore: at each step, every value the transaction claims to have read
must equal the model's current value — any snapshot that wasn't
serializable at its commit point (lost update, stale read admitted by the
resolver, write visible early) breaks the replay.
"""

from __future__ import annotations

import json
import struct
import zlib

from . import Workload
from ..errors import CommitUnknownResult, NotCommitted, TransactionTooOld
from ._model import ModelStore


class SerializabilityWorkload(Workload):
    PREFIX = b"ser/kv/"
    LOG = b"ser/log/"

    def __init__(self, db, rng, transactions=30, keys=12, **kw):
        super().__init__(db, rng, **kw)
        self.transactions = transactions
        self.keys = keys
        self._seq = 0

    def _key(self) -> bytes:
        return self.PREFIX + b"k%03d" % self.rng.random_int(0, self.keys)

    async def setup(self):
        if self.client_id != 0:
            return

        async def init(tr):
            for i in range(self.keys):
                tr.set(self.PREFIX + b"k%03d" % i, b"0")

        await self.db.run(init)

    async def _one_txn(self) -> None:
        n_reads = 1 + self.rng.random_int(0, 3)
        n_writes = 1 + self.rng.random_int(0, 2)
        read_keys = sorted({self._key() for _ in range(n_reads)})
        write_keys = sorted({self._key() for _ in range(n_writes)})
        while True:
            self._seq += 1
            seq = self._seq
            tr = self.db.transaction()
            try:
                reads = {}
                for k in read_keys:
                    v = await tr.get(k)
                    reads[k] = v.decode() if v is not None else None
                # crc32, not hash(): PYTHONHASHSEED would break seeded
                # reproducibility of the simulation
                digest = "%08x" % zlib.crc32(
                    repr(sorted(reads.items())).encode()
                )
                record = {
                    "client": self.client_id,
                    "seq": seq,
                    "reads": {k.decode(): v for k, v in reads.items()},
                    "writes": {},
                }
                for k in write_keys:
                    val = b"%s/%d/%d" % (digest.encode(), self.client_id, seq)
                    tr.set(k, val)
                    record["writes"][k.decode()] = val.decode()
                # versionstamped log key: commit order made durable
                placeholder = b"\x00" * 10
                log_key = (
                    self.LOG + placeholder + struct.pack("<I", len(self.LOG))
                )
                tr.set_versionstamped_key(
                    log_key, json.dumps(record).encode()
                )
                await tr.commit()
                return
            except (NotCommitted, TransactionTooOld) as e:
                await tr.on_error(e)
            except CommitUnknownResult:
                # the log record carries client+seq: if it landed, the
                # replay sees it exactly once; if not, we retry with a NEW
                # seq, so a duplicate can never masquerade as the same txn
                from ..runtime.futures import delay

                await delay(0.05)

    async def start(self):
        for _ in range(self.transactions):
            await self._one_txn()

    async def check(self) -> bool:
        if self.client_id != 0:
            return True  # one replayer sees every client's log

        async def read_log(tr):
            return await tr.get_range(self.LOG, self.LOG + b"\xff")

        rows = await self.db.run(read_log)
        model = ModelStore()
        for i in range(self.keys):
            model.set(self.PREFIX + b"k%03d" % i, b"0")
        seen = set()
        for log_key, blob in rows:  # key order == versionstamp order
            rec = json.loads(blob)
            ident = (rec["client"], rec["seq"])
            if ident in seen:
                print("Serializability: duplicate txn record", ident)
                return False
            seen.add(ident)
            for k, v in rec["reads"].items():
                got = model.get(k.encode())
                want = v.encode() if v is not None else None
                if got != want:
                    print(
                        f"Serializability: txn {ident} read {k}={v!r} but "
                        f"serial replay has {got!r}"
                    )
                    return False
            for k, v in rec["writes"].items():
                model.set(k.encode(), v.encode())
        return True
