"""Watch/feed semantics workloads — the notification oracles.

``WatchSemanticsWorkload`` is the exactness oracle for the notification
subsystem: each actor owns a DISJOINT key partition and mutates it
strictly sequentially, so the actor itself is a perfect model of its
partition — any watch that fires with a value the actor never wrote is a
phantom trigger, any committed change whose watch never fires is a lost
trigger, and replaying the partition's change feed must reproduce the
partition byte-for-byte against a transactional range read. (Disjoint
partitions + sequential ops make the within-version canonical order
unambiguous; overlapping writers would leave the byte-match oracle
underdetermined.) Runs under the full chaos soak: restart, rollback and
failover seeds must keep all three properties.

``WatchStormWorkload`` is the fan-out shape: many watches parked on few
keys, released by single commits — the storage fires whole versions as
one fan-out batch, and with frame batching the replies to one client
share super-frames. The 100K-watch storm run drives this class
directly (tools/soak.py ``watch_storm``)."""

from __future__ import annotations

from . import Workload
from ..runtime.futures import delay, spawn, timeout, wait_for_all


class WatchSemanticsWorkload(Workload):
    def __init__(
        self,
        db,
        rng,
        actors: int = 3,
        changes: int = 8,
        keys_per_actor: int = 4,
        feed_check: bool = True,
        **kw,
    ):
        super().__init__(db, rng, **kw)
        self.actors = actors
        self.changes = changes
        self.keys_per_actor = keys_per_actor
        self.feed_check = feed_check
        self.lost = 0
        self.phantom = 0
        self.fired = 0
        self.feed_mismatches: list = []

    def _prefix(self, actor: int) -> bytes:
        return b"wsem/%d/%d/" % (self.client_id, actor)

    def _key(self, actor: int, j: int) -> bytes:
        return self._prefix(actor) + b"k%02d" % j

    async def _actor(self, i: int) -> None:
        rng = self.rng.fork()
        # every value this actor ever ATTEMPTED to commit, per key: the
        # sole-writer discipline makes this a superset of the committed
        # values (unknown-result retries re-commit the same value), so a
        # fired value outside it is a phantom by construction
        legal: dict = {}
        for seq in range(self.changes):
            key = self._key(i, seq % self.keys_per_actor)
            # register the watch with the CURRENT value as baseline
            watch_fut = [None]

            async def register(tr):
                cur = await tr.get(key)
                watch_fut[0] = tr.watch(key)
                return cur

            baseline = await self.db.run(register)
            # commit a change guaranteed to differ from the baseline
            if rng.coinflip(0.25) and baseline is not None:
                newv = None  # clear

                async def change(tr):
                    tr.clear(key)
            else:
                newv = b"%s#%06d" % (key, seq)
                if newv == baseline:  # same seq re-landed: perturb
                    newv += b"'"

                async def change(tr):
                    tr.set(key, newv)

            legal.setdefault(key, {baseline}).add(newv)
            await self.db.run(change)
            # the committed change MUST fire the watch (generous bound:
            # chaos recoveries re-register client-side, but never lose it)
            sentinel = object()
            fired = await timeout(watch_fut[0], 60.0, default=sentinel)
            if fired is sentinel:
                self.lost += 1
                continue
            self.fired += 1
            # spurious fires re-report a legal value; a value this actor
            # never wrote is phantom data
            if fired not in legal[key]:
                self.phantom += 1
            await delay(rng.random01() * 0.05)

    async def _check_feed(self, actor: int) -> None:
        """Replay the partition's change feed from version 0 and compare
        against a transactional range read — byte-for-byte."""
        from ..errors import TransactionTooOld

        begin = self._prefix(actor)
        end = begin + b"\xff"
        feed = self.db.change_feed(begin, end, from_version=0)
        replayed: dict = {}
        last_version = 0
        try:
            while True:
                batches = await timeout(
                    spawn(feed.next_batches()), 5.0, default=None
                )
                if batches is None:
                    break  # caught up: long-poll outlived the quiesce
                for b in batches:
                    if b.version <= last_version:
                        self.feed_mismatches.append(
                            f"feed versions not increasing: {b.version} "
                            f"after {last_version}"
                        )
                    last_version = b.version
                    for cb, ce in b.clears:
                        for k in [k for k in replayed if cb <= k < ce]:
                            del replayed[k]
                    for k, v in b.sets:
                        replayed[k] = v
        except TransactionTooOld:
            # retention floor passed version 0 (legal on long chaos runs):
            # the byte-match oracle needs the full log — skip, don't fail
            return
        async def read(tr):
            return await tr.get_range(begin, end)

        actual = {k: v for k, v in await self.db.run(read)}
        if replayed != actual:
            self.feed_mismatches.append(
                f"actor {actor}: replay {sorted(replayed.items())!r} != "
                f"range read {sorted(actual.items())!r}"
            )

    async def start(self):
        await wait_for_all(
            [spawn(self._actor(i)) for i in range(self.actors)]
        )

    async def check(self) -> bool:
        if self.feed_check:
            for i in range(self.actors):
                await self._check_feed(i)
        ok = True
        if self.lost:
            print(f"WatchSemantics: {self.lost} LOST triggers")
            ok = False
        if self.phantom:
            print(f"WatchSemantics: {self.phantom} PHANTOM triggers")
            ok = False
        for m in self.feed_mismatches:
            print(f"WatchSemantics: feed mismatch — {m}")
            ok = False
        if self.fired < 1:
            print("WatchSemantics: nothing ever fired")
            ok = False
        return ok


class WatchStormWorkload(Workload):
    """Park ``watchers`` watches across ``keys`` keys from one client,
    release each key with a single commit, and require every watch to
    fire with the released value — the whole-version fan-out path."""

    def __init__(self, db, rng, watchers: int = 64, keys: int = 8, **kw):
        super().__init__(db, rng, **kw)
        self.watchers = watchers
        self.keys = keys
        self.unfired = -1
        self.wrong: list = []

    def _key(self, j: int) -> bytes:
        return b"wstorm/%d/k%04d" % (self.client_id, j % self.keys)

    async def start(self):
        async def park(tr):
            # baseline: absent (fresh namespace) — one registration RPC
            # per watcher, all parked until the release commit
            return [tr.watch(self._key(j)) for j in range(self.watchers)]

        futs = await self.db.run(park)

        async def release(tr):
            for j in range(self.keys):
                tr.set(self._key(j), b"released")

        await self.db.run(release)
        sentinel = object()
        self.unfired = 0
        # ONE shared deadline for the whole fan-out, not 60s per future:
        # the futures resolve concurrently, so waiting is O(slowest), and
        # a mass-loss pathology fails the check instead of outliving the
        # soak battery's sim-time budget
        from ..runtime.loop import now

        deadline = now() + 60.0
        for j, f in enumerate(futs):
            v = await timeout(f, max(0.1, deadline - now()), default=sentinel)
            if v is sentinel:
                self.unfired += 1
            elif v != b"released":
                self.wrong.append((self._key(j), v))

    async def check(self) -> bool:
        if self.unfired:
            print(f"WatchStorm: {self.unfired}/{self.watchers} never fired")
            return False
        if self.wrong:
            print(f"WatchStorm: wrong fire values {self.wrong[:5]!r}")
            return False
        return True
