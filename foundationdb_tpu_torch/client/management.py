"""ManagementAPI: operator actions as ordinary transactions + CC calls.

The analog of fdbclient/ManagementAPI.actor.cpp: configuration lives under
``\\xff/conf/`` and is changed transactionally; exclusions are conf keys
DataDistribution honors by draining shards off the excluded servers;
``configure`` triggers a recovery so shape changes (proxy/resolver/tlog
counts) take effect in the next generation, exactly like the reference's
recovery-on-configuration-change.

The port's copy of ``foundationdb_tpu/client/management.py``."""

from __future__ import annotations

from ..net.sim import Endpoint
from ..runtime.futures import delay
from ..server.interfaces import Tokens
from ..server.systemdata import CONF_PREFIX
from ..runtime.loop import Cancelled

EXCLUDED_PREFIX = CONF_PREFIX + b"excluded/"


def _excluded_key(address: str) -> bytes:
    return EXCLUDED_PREFIX + address.encode()


async def exclude_servers(db, addresses: list[str]) -> None:
    """Mark servers excluded (fdbcli `exclude`); DD drains them."""

    async def body(tr):
        for a in addresses:
            tr.set(_excluded_key(a), b"1")

    await db.run(body)


async def include_servers(db, addresses: list[str] = None) -> None:
    """Re-include servers (fdbcli `include`); None = include all."""

    async def body(tr):
        if addresses is None:
            tr.clear_range(EXCLUDED_PREFIX, EXCLUDED_PREFIX + b"\xff")
        else:
            for a in addresses:
                tr.clear(_excluded_key(a))

    await db.run(body)


async def get_excluded(db) -> list[str]:
    async def body(tr):
        rows = await tr.get_range(EXCLUDED_PREFIX, EXCLUDED_PREFIX + b"\xff")
        return [k[len(EXCLUDED_PREFIX) :].decode() for k, _v in rows]

    return await db.run(body)


async def wait_for_excluded(db, addresses: list[str], timeout_s: float = 120.0):
    """Block until no shard lists an excluded server (exclude's wait —
    ManagementAPI waitForExcludedServers)."""
    from ..server.interfaces import GetKeyServersRequest

    waited = 0.0
    while True:
        clear = True
        key = b""
        while True:
            r = await db._proxy_request(
                Tokens.GET_KEY_SERVERS, GetKeyServersRequest(key=key)
            )
            if any(a in addresses for a in r.team):
                clear = False
                break
            if r.end is None:
                break
            key = r.end
        if clear:
            return
        await delay(1.0)
        waited += 1.0
        if waited > timeout_s:
            raise TimeoutError("excluded servers still own shards")


async def configure(db, coordinators: list[str], client, **changes) -> None:
    """Write configuration keys and force a recovery so the new shape is
    recruited (n_proxies / n_resolvers / n_tlogs / tlog_replication /
    conflict_backend...)."""

    async def body(tr):
        for k, v in changes.items():
            tr.set(CONF_PREFIX + k.encode(), str(v).encode())

    await db.run(body)
    await force_recovery(coordinators, client)


_TIMED_OUT = object()


async def _leader_request(
    coordinators: list[str],
    client,
    token: str,
    payload,
    per_try_timeout: float = 10.0,
    attempts: int = 1,
    accept=lambda r: True,
):
    """Find the current cluster controller and send it one request,
    re-discovering and retrying up to ``attempts`` times (the CC may be
    mid-(re)election). Raises TimeoutError when no CC ever accepts."""
    from ..server.coordination import monitor_leader
    from ..runtime.futures import AsyncVar, timeout as _timeout

    leader = AsyncVar(None)
    mon = client.spawn(monitor_leader(client, coordinators, leader))
    try:
        for _ in range(attempts):
            if leader.get() is None:
                # bounded: no leader may EVER appear (lost coordinator
                # majority) — the attempt budget must still apply
                await _timeout(leader.on_change(), 1.0)
                if leader.get() is None:
                    continue
            cc = leader.get()
            try:
                reply = await _timeout(
                    client.request(Endpoint(cc.address, token), payload),
                    per_try_timeout,
                    default=_TIMED_OUT,
                )
                # a timed-out try is a FAILED try, not an accepted None —
                # the stale-leader case must fall through to rediscovery
                if reply is not _TIMED_OUT and accept(reply):
                    return reply
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                pass
            await delay(0.5)
        raise TimeoutError(f"no cluster controller answered {token}")
    finally:
        mon.cancel()


async def force_failover(coordinators: list[str], client, dc: str) -> None:
    """Promote region ``dc`` to primary after losing the current primary
    (fdbcli force_recovery_with_data_loss): the next recovery determines
    the epoch end from the surviving LogRouters and promotes the storage
    mirror. Commits acked but never relayed to the remote are lost — the
    operation's contract (as are metadata changes committed after the
    last recovery; configure() forces a recovery immediately, so that
    window is the balancer/DD traffic since the current epoch began)."""
    await _leader_request(
        coordinators,
        client,
        Tokens.CC_FORCE_FAILOVER,
        dc,
        attempts=60,
        accept=bool,
    )


async def force_recovery(coordinators: list[str], client) -> None:
    """Ask the cluster controller to replace the master (a recovery)."""
    await _leader_request(
        coordinators,
        client,
        Tokens.CC_FORCE_RECOVERY,
        None,
        per_try_timeout=5.0,
        attempts=10,
    )


async def get_status(coordinators: list[str], client) -> dict:
    """Fetch the cluster status JSON document from the CC
    (StatusClient / fdbcli `status json`)."""
    status = await _leader_request(
        coordinators, client, Tokens.CC_GET_STATUS, None, attempts=10
    )
    return status or {}
