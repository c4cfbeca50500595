"""Stack machine interpreting bindingtester instruction streams.

The analog of the per-binding tester programs driven by
bindings/bindingtester/bindingtester.py, implementing the spec in
bindings/bindingtester/spec/bindingApiTester.txt: instructions are
tuple-packed values stored IN the database under a prefix; the machine
maintains a data stack (items tagged with their instruction number), a
global named-transaction map, and a last-seen version; errors surface as
packed ("ERROR", code) tuples on the stack.

Key-selector ops are implemented per the spec: GET_KEY resolves a
selector and clamps the result to the caller's prefix window;
GET_RANGE_SELECTOR reads between two selectors and filters to the
prefix; GET_RANGE_STARTS_WITH routes through selector endpoints
(firstGreaterOrEqual of the prefix and of strinc(prefix)), exercising
the same resolution machinery.

Deviations from the spec, all down to client-surface gaps or scope:
START_THREAD / WAIT_EMPTY are not implemented (no multi-thread tester
harness); STREAMING_MODE parameters are accepted and ignored (reads
return full results).

The same machine runs against the real client Database AND the
ModelDatabase oracle (bindings/model.py) — diffing the two stacks and
final states instruction-for-instruction IS the conformance check.

The port's copy of ``foundationdb_tpu/bindings/stack_machine.py``: the
same instructions, stack items and error tuples, over the port's client
and errors, so one stream logs the same bytes in either package.
"""

from __future__ import annotations

from ..errors import FdbError
from ..kv.mutations import MutationType
from ..kv.selector import KeySelector
from ..layers import tuple as T
from ..net.sim import BrokenPromise
from ..client.transaction import strinc as _strinc
from ..runtime.loop import Cancelled

ERROR_CODES = {
    "NotCommitted": b"1020",
    "TransactionTooOld": b"1007",
    "CommitUnknownResult": b"1021",
    "FutureVersion": b"1009",
    "AccessedUnreadable": b"1036",
}

ATOMIC_OPS = {
    "ADD": MutationType.ADD,
    "AND": MutationType.AND,
    "OR": MutationType.OR,
    "XOR": MutationType.XOR,
    "MAX": MutationType.MAX,
    "MIN": MutationType.MIN,
    "BYTE_MIN": MutationType.BYTE_MIN,
    "BYTE_MAX": MutationType.BYTE_MAX,
    "APPEND_IF_FITS": MutationType.APPEND_IF_FITS,
}

RESULT_NOT_PRESENT = b"RESULT_NOT_PRESENT"


def _error_tuple(e: Exception) -> bytes:
    code = ERROR_CODES.get(type(e).__name__, b"4000")
    return T.pack((b"ERROR", code))


class StackMachine:
    def __init__(self, db, prefix: bytes):
        self.db = db
        self.prefix = prefix
        self.stack: list[tuple[int, object]] = []  # (instruction#, item)
        self.trs: dict[bytes, object] = {}  # global transaction map
        self.tr_name = prefix
        self.last_version = 0

    # -- plumbing --------------------------------------------------------------

    def _tr(self):
        tr = self.trs.get(self.tr_name)
        if tr is None:
            tr = self.trs[self.tr_name] = self.db.transaction()
        return tr

    def push(self, inum: int, item) -> None:
        self.stack.append((inum, item))

    def pop(self, n: int = None):
        if n is None:
            return self.stack.pop()[1]
        return [self.stack.pop()[1] for _ in range(n)]

    async def run_stream(self, instructions) -> None:
        """Execute a list of unpacked instruction tuples."""
        for inum, ins in enumerate(instructions):
            await self.step(inum, ins)

    async def run_from_db(self) -> None:
        """Spec behavior: read the instruction range from the database."""
        b, e = T.range_of((self.prefix,))

        async def read(tr):
            return await tr.get_range(b, e)

        rows = await self.db.run(read)
        instructions = [T.unpack(v) for _k, v in rows]
        await self.run_stream(instructions)

    # -- interpreter -----------------------------------------------------------

    async def step(self, inum: int, ins: tuple) -> None:
        op = ins[0]
        if isinstance(op, bytes):
            op = op.decode()
        snapshot = op.endswith("_SNAPSHOT")
        database = op.endswith("_DATABASE")
        base = op.removesuffix("_SNAPSHOT").removesuffix("_DATABASE")
        handler = getattr(self, "op_" + base, None)
        if handler is None:
            raise NotImplementedError(f"instruction {op!r}")
        try:
            await handler(inum, ins, snapshot=snapshot, database=database)
        except (FdbError, BrokenPromise) as e:
            # the spec: ANY error bubbling out of an operation is caught
            # and pushed as the packed error tuple — including transport
            # breakage under chaos (BrokenPromise), which maps to the
            # generic code
            self.push(inum, _error_tuple(e))

    # -- data ops --------------------------------------------------------------

    async def op_PUSH(self, inum, ins, **_kw):
        self.push(inum, ins[1])

    async def op_DUP(self, inum, ins, **_kw):
        self.stack.append(self.stack[-1])

    async def op_EMPTY_STACK(self, inum, ins, **_kw):
        self.stack.clear()

    async def op_SWAP(self, inum, ins, **_kw):
        idx = self.pop()
        d0 = len(self.stack) - 1
        di = d0 - idx
        self.stack[d0], self.stack[di] = self.stack[di], self.stack[d0]

    async def op_POP(self, inum, ins, **_kw):
        self.pop()

    async def op_SUB(self, inum, ins, **_kw):
        a, b = self.pop(2)
        self.push(inum, a - b)

    async def op_CONCAT(self, inum, ins, **_kw):
        a, b = self.pop(2)
        self.push(inum, a + b)

    async def op_LOG_STACK(self, inum, ins, **_kw):
        prefix = self.pop()
        items = list(self.stack)  # oldest first = stackIndex 0
        self.stack.clear()
        for lo in range(0, len(items), 100):
            chunk = items[lo : lo + 100]

            async def body(tr, lo=lo, chunk=chunk):
                for off, (item_inum, item) in enumerate(chunk):
                    k = prefix + T.pack((lo + off, item_inum))
                    v = T.pack((item,))[:40000]
                    tr.set(k, v)

            await self.db.run(body)

    # -- transaction management ------------------------------------------------

    async def op_NEW_TRANSACTION(self, inum, ins, **_kw):
        self.trs[self.tr_name] = self.db.transaction()

    async def op_USE_TRANSACTION(self, inum, ins, **_kw):
        self.tr_name = self.pop()
        if self.tr_name not in self.trs:
            self.trs[self.tr_name] = self.db.transaction()

    async def op_ON_ERROR(self, inum, ins, **_kw):
        code = self.pop()
        err_by_code = {v: k for k, v in ERROR_CODES.items()}
        name = err_by_code.get(b"%d" % code if isinstance(code, int) else code)
        from .. import errors as E

        err = getattr(E, name)() if name else E.FdbError()
        try:
            await self._tr().on_error(err)
            self.push(inum, RESULT_NOT_PRESENT)
        except Cancelled:
            raise  # actor-cancelled-swallow
        except Exception as e:
            self.push(inum, _error_tuple(e))

    async def op_RESET(self, inum, ins, **_kw):
        self._tr().reset()

    async def op_CANCEL(self, inum, ins, **_kw):
        # no cancel surface on the client transaction: reset is the
        # closest observable behavior for serial streams
        self._tr().reset()

    # -- reads -----------------------------------------------------------------

    async def op_GET(self, inum, ins, snapshot=False, database=False):
        key = self.pop()
        if database:
            async def body(tr):
                return await tr.get(key)

            v = await self.db.run(body)
        else:
            v = await self._tr().get(key, snapshot=snapshot)
        self.push(inum, v if v is not None else RESULT_NOT_PRESENT)

    async def op_GET_RANGE(self, inum, ins, snapshot=False, database=False):
        begin, end, limit, reverse, _mode = self.pop(5)
        await self._push_range(
            inum, begin, end, limit, reverse, snapshot, database
        )

    async def op_GET_KEY(self, inum, ins, snapshot=False, database=False):
        """Spec: pop KEY, OR_EQUAL, OFFSET, PREFIX; resolve the selector;
        push the result clamped to the prefix window (a result below the
        prefix pushes the prefix, one above pushes strinc(prefix)) —
        which also makes streams deterministic when resolution walks out
        of the tester's keyspace."""
        key, or_equal, offset, prefix = self.pop(4)
        sel = KeySelector(key, bool(or_equal), int(offset))
        if database:
            async def body(tr):
                return await tr.get_key(sel)

            result = await self.db.run(body)
        else:
            result = await self._tr().get_key(sel, snapshot=snapshot)
        if result.startswith(prefix):
            self.push(inum, result)
        elif result < prefix:
            self.push(inum, prefix)
        else:
            self.push(inum, _strinc(prefix))

    async def op_GET_RANGE_SELECTOR(
        self, inum, ins, snapshot=False, database=False
    ):
        """Spec: pop BEGIN_KEY, BEGIN_OR_EQUAL, BEGIN_OFFSET, END_KEY,
        END_OR_EQUAL, END_OFFSET, LIMIT, REVERSE, STREAMING_MODE, PREFIX;
        range-read between the selectors, filter rows to the prefix, push
        the packed flat tuple."""
        bk, boe, boff, ek, eoe, eoff, limit, reverse, _mode, prefix = self.pop(10)
        begin = KeySelector(bk, bool(boe), int(boff))
        end = KeySelector(ek, bool(eoe), int(eoff))
        limit = limit or (1 << 29)
        if database:
            async def body(tr):
                return await tr.get_range(
                    begin, end, limit=limit, reverse=bool(reverse)
                )

            rows = await self.db.run(body)
        else:
            rows = await self._tr().get_range(
                begin, end, limit=limit, reverse=bool(reverse),
                snapshot=snapshot,
            )
        flat = []
        for k, v in rows:
            if k.startswith(prefix):
                flat.extend([k, v])
        self.push(inum, T.pack(tuple(flat)))

    async def op_GET_RANGE_STARTS_WITH(
        self, inum, ins, snapshot=False, database=False
    ):
        # routed through selector endpoints (the spec's equivalence:
        # [fGoE(prefix), fGoE(strinc(prefix))) is exactly the prefix range)
        prefix, limit, reverse, _mode = self.pop(4)
        await self._push_range(
            inum,
            KeySelector.first_greater_or_equal(prefix),
            KeySelector.first_greater_or_equal(_strinc(prefix)),
            limit,
            reverse,
            snapshot,
            database,
        )

    async def _push_range(
        self, inum, begin, end, limit, reverse, snapshot, database
    ):
        limit = limit or (1 << 29)
        if database:
            async def body(tr):
                return await tr.get_range(
                    begin, end, limit=limit, reverse=bool(reverse)
                )

            rows = await self.db.run(body)
        else:
            rows = await self._tr().get_range(
                begin, end, limit=limit, reverse=bool(reverse),
                snapshot=snapshot,
            )
        flat = []
        for k, v in rows:
            flat.extend([k, v])
        self.push(inum, T.pack(tuple(flat)))

    async def op_GET_READ_VERSION(self, inum, ins, snapshot=False, **_kw):
        self.last_version = await self._tr().get_read_version()
        self.push(inum, b"GOT_READ_VERSION")

    async def op_SET_READ_VERSION(self, inum, ins, **_kw):
        self._tr().set_read_version(self.last_version)

    # -- writes ----------------------------------------------------------------

    async def op_SET(self, inum, ins, database=False, **_kw):
        key, value = self.pop(2)
        if database:
            async def body(tr):
                tr.set(key, value)

            await self.db.run(body)
            self.push(inum, RESULT_NOT_PRESENT)
        else:
            self._tr().set(key, value)

    async def op_CLEAR(self, inum, ins, database=False, **_kw):
        key = self.pop()
        if database:
            async def body(tr):
                tr.clear(key)

            await self.db.run(body)
            self.push(inum, RESULT_NOT_PRESENT)
        else:
            self._tr().clear(key)

    async def op_CLEAR_RANGE(self, inum, ins, database=False, **_kw):
        begin, end = self.pop(2)
        await self._clear_range(inum, begin, end, database)

    async def op_CLEAR_RANGE_STARTS_WITH(self, inum, ins, database=False, **_kw):
        prefix = self.pop()
        await self._clear_range(inum, prefix, _strinc(prefix), database)

    async def _clear_range(self, inum, begin, end, database):
        if database:
            async def body(tr):
                tr.clear_range(begin, end)

            await self.db.run(body)
            self.push(inum, RESULT_NOT_PRESENT)
        else:
            self._tr().clear_range(begin, end)

    async def op_ATOMIC_OP(self, inum, ins, database=False, **_kw):
        optype, key, value = self.pop(3)
        if isinstance(optype, bytes):
            optype = optype.decode()
        mt = ATOMIC_OPS[optype]
        if database:
            async def body(tr):
                tr.atomic_op(mt, key, value)

            await self.db.run(body)
            self.push(inum, RESULT_NOT_PRESENT)
        else:
            self._tr().atomic_op(mt, key, value)

    async def op_READ_CONFLICT_RANGE(self, inum, ins, **_kw):
        begin, end = self.pop(2)
        self._tr().add_read_conflict_range(begin, end)
        self.push(inum, b"SET_CONFLICT_RANGE")

    async def op_WRITE_CONFLICT_RANGE(self, inum, ins, **_kw):
        begin, end = self.pop(2)
        self._tr().add_write_conflict_range(begin, end)
        self.push(inum, b"SET_CONFLICT_RANGE")

    async def op_READ_CONFLICT_KEY(self, inum, ins, **_kw):
        key = self.pop()
        self._tr().add_read_conflict_range(key, key + b"\x00")
        self.push(inum, b"SET_CONFLICT_KEY")

    async def op_WRITE_CONFLICT_KEY(self, inum, ins, **_kw):
        key = self.pop()
        self._tr().add_write_conflict_range(key, key + b"\x00")
        self.push(inum, b"SET_CONFLICT_KEY")

    async def op_COMMIT(self, inum, ins, **_kw):
        await self._tr().commit()
        self.push(inum, RESULT_NOT_PRESENT)

    async def op_GET_COMMITTED_VERSION(self, inum, ins, **_kw):
        self.last_version = self._tr().committed_version
        self.push(inum, b"GOT_COMMITTED_VERSION")

    async def op_WAIT_FUTURE(self, inum, ins, **_kw):
        item_inum, item = self.stack.pop()
        self.stack.append((item_inum, item))  # futures are pre-awaited here

    # -- tuple ops -------------------------------------------------------------

    async def op_TUPLE_PACK(self, inum, ins, **_kw):
        n = self.pop()
        items = self.pop(n)
        self.push(inum, T.pack(tuple(items)))

    async def op_TUPLE_UNPACK(self, inum, ins, **_kw):
        packed = self.pop()
        for item in T.unpack(packed):
            self.push(inum, T.pack((item,)))

    async def op_TUPLE_RANGE(self, inum, ins, **_kw):
        n = self.pop()
        items = self.pop(n)
        b, e = T.range_of(tuple(items))
        self.push(inum, b)
        self.push(inum, e)

    async def op_TUPLE_SORT(self, inum, ins, **_kw):
        n = self.pop()
        packed = self.pop(n)
        for p in sorted(packed):
            self.push(inum, p)
