"""``RemoteReplica``: the fleet-side client for one serve worker process.

Implements the surface :class:`~..serve.fleet.ReplicaFleet` and
:class:`~..serve.router.ReplicaRouter` consume from an in-process
``Batcher`` — submit with absolute deadline, drain, close, health probe,
per-tenant counts, stats — over one multiplexed async-socket connection
(``transport/wire.py``), so the fleet and router cannot tell a worker
process from an in-process replica (counterpart of the reference's
``transport/client.py``), plus the rollout plane's calls
(``rollout_start`` / ``rollout_pull`` / ``rollout_ack`` /
``rollout_policy_version``, ``reward_score``) and :class:`RewardClient`, the
synchronous ``reward_score`` caller of a rollout worker's actor.

The three liveness layers, cheapest first:

1. **process exit**: a reaped worker (``poll()`` returns) fails the probe
   immediately with its exit code — a SIGKILL is ``-9`` the same tick;
2. **heartbeat lease**: the worker beats ``heartbeat.json`` into its sandbox
   (``resilience/heartbeat.py``); a process that is alive but wedged (stuck
   event loop, hung runtime) goes stale past ``3×`` the beat cadence and
   fails the probe — the fleet then KILLS it, the LeaseChecker pattern;
3. **probe RPC**: the decode-progress snapshot that feeds the fleet's
   stalled-decode check — a worker whose loop answers but whose engine stops
   stepping while holding lanes is caught exactly like an in-process stall.

Any transport failure on the generate path surfaces as
:class:`~..serve.batcher.ReplicaUnavailable` — the
router's failover re-enqueues on a survivor, and exactly-once holds because
a dead worker never delivered a result for the request (and the worker-side
completed-LRU replays, never re-decodes, if the same id lands on it again).

All waits are a real async socket or ``asyncio.to_thread``; sync
properties the router reads between awaits come from the last probe
snapshot.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import signal
import subprocess
import time
from typing import Any

from ..resilience.heartbeat import read_heartbeat_file
from ..serve.adapters import AdapterError, UnknownAdapter
from ..serve.batcher import DeadlineExceeded, QueueFull, ReplicaUnavailable
from ..serve.engine import GenRequest, GenResult, PromptTooLong
from . import RemoteError, TransportError, incr
from .wire import FrameError, read_msg, write_msg

logger = logging.getLogger(__name__)

#: remote exception types re-raised as their local counterparts (everything
#: else becomes :class:`RemoteError` with the remote type in the message)
_ERROR_TYPES: dict[str, type[BaseException]] = {
    "QueueFull": QueueFull,
    "DeadlineExceeded": DeadlineExceeded,
    "ReplicaUnavailable": ReplicaUnavailable,
    "PromptTooLong": PromptTooLong,
    "UnknownAdapter": UnknownAdapter,
    "AdapterError": AdapterError,
    "ValueError": ValueError,
}


def _raise_remote(error: dict[str, Any]) -> None:
    etype = str(error.get("type", "RuntimeError"))
    message = str(error.get("message", ""))
    cls = _ERROR_TYPES.get(etype)
    if cls is QueueFull:
        raise QueueFull(message, retry_after_s=error.get("retry_after_s"))
    if cls is not None:
        raise cls(message)
    raise RemoteError(etype, message)


class _Connection:
    """One multiplexed request/response connection to a worker."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer
        self._ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._write_lock = asyncio.Lock()
        self._dead: BaseException | None = None
        self._reader_task = asyncio.get_running_loop().create_task(
            self._read_loop()
        )

    @classmethod
    async def open(cls, host: str, port: int,
                   timeout_s: float = 10.0) -> "_Connection":
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout_s
        )
        return cls(reader, writer)

    @property
    def alive(self) -> bool:
        return self._dead is None

    async def _read_loop(self) -> None:
        exc: BaseException
        try:
            while True:
                msg = await read_msg(self._reader)
                future = self._pending.pop(msg.get("id"), None)
                if future is None or future.done():
                    continue
                if msg.get("ok"):
                    future.set_result(msg.get("payload"))
                else:
                    try:
                        _raise_remote(msg.get("error") or {})
                    # not swallowed: delivered to the awaiting RPC caller
                    except BaseException as e:
                        future.set_exception(e)
        except (asyncio.IncompleteReadError, ConnectionError, FrameError,
                asyncio.CancelledError) as e:
            exc = e if not isinstance(e, asyncio.CancelledError) \
                else TransportError("connection closed")
        # converted below: every pending caller receives the failure
        except Exception as e:
            exc = e
        else:  # pragma: no cover - while True only leaves via exception
            exc = TransportError("connection closed")
        self.fail_pending(TransportError(f"worker connection lost: {exc!r}"))

    def fail_pending(self, exc: BaseException) -> None:
        if self._dead is None:
            self._dead = exc
        for future in list(self._pending.values()):
            if not future.done():
                future.set_exception(exc)
        self._pending.clear()

    async def call(self, op: str, payload: dict[str, Any],
                   timeout_s: float | None = None) -> Any:
        if self._dead is not None:
            incr("rpc_errors_total")
            raise TransportError(f"connection is down: {self._dead}")
        msg_id = next(self._ids)
        future = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = future
        incr("rpcs_total")
        try:
            async with self._write_lock:
                await write_msg(
                    self._writer, {"op": op, "id": msg_id, "payload": payload}
                )
            if timeout_s is None:
                return await future
            return await asyncio.wait_for(asyncio.shield(future), timeout_s)
        except asyncio.TimeoutError:
            incr("rpc_errors_total")
            self._pending.pop(msg_id, None)
            raise TransportError(
                f"rpc {op!r} timed out after {timeout_s:.1f}s"
            ) from None
        except (ConnectionError, TransportError, FrameError) as e:
            incr("rpc_errors_total")
            self._pending.pop(msg_id, None)
            raise TransportError(f"rpc {op!r} failed: {e}") from e
        finally:
            self._pending.pop(msg_id, None)

    async def close(self) -> None:
        self._reader_task.cancel()
        try:
            await self._reader_task
        except asyncio.CancelledError:
            pass
        self._writer.close()
        try:
            await self._writer.wait_closed()
        # best-effort close of an already-dead socket
        except Exception:
            pass


class _RemoteEngineView:
    """The tiny engine-shaped slice the router/fleet read between awaits —
    decode progress and paged-pool slack from the last probe, admission page
    math recomputed locally from the worker's hello config."""

    def __init__(self, replica: "RemoteReplica"):
        self._replica = replica

    @property
    def steps_total(self) -> int:
        return int(self._replica.probe_snapshot.get("steps_total", 0))

    def kv_slack_pages(self) -> int | None:
        return self._replica.probe_snapshot.get("kv_slack_pages")

    def admission_pages(self, req: GenRequest) -> int:
        page_tokens = int(self._replica.engine_info.get("page_tokens") or 0)
        if page_tokens <= 0:
            return 0
        span = len(req.tokens) + max(0, req.max_new_tokens - 1)
        return -(-span // page_tokens)


class RemoteReplica:
    """Batcher-shaped client for one worker process."""

    def __init__(
        self,
        replica_id: str,
        conn: _Connection,
        hello: dict[str, Any],
        *,
        proc: subprocess.Popen | None = None,
        sandbox: str | None = None,
        heartbeat_interval_s: float = 2.0,
        probe_timeout_s: float = 10.0,
    ):
        self.replica_id = replica_id
        self._conn = conn
        self._proc = proc
        self.sandbox = sandbox
        self.pid = int(hello.get("pid") or (proc.pid if proc else 0))
        self.port: int | None = None
        self.engine_info: dict[str, Any] = dict(hello.get("engine") or {})
        self.heartbeat_interval_s = heartbeat_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.engine = _RemoteEngineView(self)
        self._draining = False
        self._closed = False
        #: last probe snapshot — the sync-property source for the router's
        #: between-awaits reads (load, queue depth, retry-after)
        self.probe_snapshot: dict[str, Any] = {}
        self._stats: dict[str, Any] = {}
        #: generate calls this client has sent and not had answered: the
        #: routing weight between probes (a burst that lands between two
        #: probes would otherwise see every worker idle and pile onto one)
        self._outstanding = 0

    # ---- liveness ----------------------------------------------------------

    def _proc_exit(self) -> int | None:
        if self._proc is None:
            return None
        return self._proc.poll()

    @property
    def lease_s(self) -> float:
        """Heartbeat staleness budget: 3 beats, floored — mirrors the
        trainer-side LeaseChecker floor so one slow write never kills a
        healthy worker."""
        return max(3.0 * self.heartbeat_interval_s, 5.0)

    async def _check_heartbeat(self) -> None:
        if self.sandbox is None:
            return
        hb = await asyncio.to_thread(
            read_heartbeat_file, os.path.join(self.sandbox, "heartbeat.json")
        )
        if hb is None:
            return  # never beat / unreadable: the lease does not bind
        age = time.time() - float(hb["ts"])
        if age > self.lease_s:
            raise TransportError(
                f"worker {self.replica_id} heartbeat is {age:.1f}s stale "
                f"(lease {self.lease_s:.1f}s) — wedged process"
            )

    async def health_probe(self) -> dict[str, Any]:
        """The fleet's liveness + decode-progress check (one per tick)."""
        code = self._proc_exit()
        if code is not None:
            raise TransportError(
                f"worker {self.replica_id} process exited with code {code}"
                + (" (SIGKILL)" if code == -int(signal.SIGKILL) else "")
            )
        await self._check_heartbeat()
        probe = await self._conn.call("probe", {},
                                      timeout_s=self.probe_timeout_s)
        self.probe_snapshot = probe
        self._stats = probe.get("stats") or self._stats
        return probe

    # ---- generate path -----------------------------------------------------

    async def submit(
        self,
        req: GenRequest,
        *,
        timeout_s: float | None = None,
        deadline: float | None = None,
    ) -> GenResult:
        if self._draining:
            raise ReplicaUnavailable(
                f"worker {self.replica_id} is draining"
            )
        if self._closed or not self._conn.alive:
            raise ReplicaUnavailable(
                f"worker {self.replica_id} connection is down"
            )
        payload: dict[str, Any] = {
            "request_id": req.request_id,
            "tokens": [int(t) for t in req.tokens],
            "max_new_tokens": req.max_new_tokens,
            "temperature": req.temperature,
            "top_k": req.top_k,
            "eos_id": req.eos_id,
            "seed": req.seed,
            "adapter_id": req.adapter_id,
            "timeout_s": timeout_s,
        }
        rpc_timeout = None
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise DeadlineExceeded(
                    f"request {req.request_id} arrived past its deadline"
                )
            # ship the REMAINING budget: monotonic clocks are per-process
            payload["deadline_in_s"] = remaining
            # the worker enforces the deadline itself; the rpc timeout is a
            # backstop for a worker that dies without dropping the socket
            rpc_timeout = remaining + 30.0
        self._outstanding += 1
        try:
            doc = await self._conn.call("generate", payload,
                                        timeout_s=rpc_timeout)
        except TransportError as e:
            # the worker died (or the socket did) with the request on it: it
            # never delivered a result, so the router may re-enqueue safely
            raise ReplicaUnavailable(
                f"worker {self.replica_id} lost mid-request: {e}"
            ) from e
        finally:
            self._outstanding -= 1
        return GenResult(
            request_id=doc["request_id"],
            prompt_tokens=list(doc["prompt_tokens"]),
            generated=list(doc["generated"]),
            finish_reason=doc["finish_reason"],
            steps=int(doc["steps"]),
            admitted_at=float(doc.get("admitted_at", 0.0)),
            finished_at=float(doc.get("finished_at", 0.0)),
            replica_id=self.replica_id,
        )

    # ---- drain / close -----------------------------------------------------

    async def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful removal: the worker bounces queued requests, finishes
        in-flight lanes, exits 0; then the process is reaped (killed if it
        lingers)."""
        self._draining = True
        clean = False
        try:
            out = await self._conn.call(
                "drain", {"timeout_s": timeout_s}, timeout_s=timeout_s + 30.0
            )
            clean = bool(out.get("clean"))
            # the worker's FINAL totals: everything completed since the
            # last probe (the drain window included) must survive into the
            # fleet's retired-counter fold
            self._stats = out.get("stats") or self._stats
        except TransportError as e:
            logger.warning("drain rpc to worker %s failed: %s",
                           self.replica_id, e)
        proc = self._proc
        if proc is not None:
            # a cleanly drained worker exits 0 by itself right after the
            # reply; wait for that before close() escalates to SIGTERM
            def wait_exit() -> None:
                try:
                    proc.wait(timeout=10.0)
                except (subprocess.TimeoutExpired, OSError):
                    logger.debug("worker %s lingered past drain",
                                 self.replica_id)

            await asyncio.to_thread(wait_exit)
        await self.close(ReplicaUnavailable(
            f"worker {self.replica_id} drained away"
        ), grace_s=5.0)
        return clean

    async def _reap(self, grace_s: float) -> None:
        proc = self._proc
        if proc is None or proc.poll() is not None:
            return

        def stop() -> None:
            try:
                proc.terminate()
                try:
                    proc.wait(timeout=grace_s)
                    return
                except subprocess.TimeoutExpired:
                    pass
                proc.kill()
                proc.wait(timeout=5.0)
            except (ProcessLookupError, subprocess.TimeoutExpired, OSError):
                logger.debug("worker %s reap raced its exit",
                             self.replica_id, exc_info=True)

        await asyncio.to_thread(stop)

    async def close(self, exc: BaseException | None = None,
                    *, grace_s: float = 2.0) -> None:
        """Tear down: outstanding RPCs fail with ``exc`` (fleet teardown
        passes :class:`ReplicaUnavailable` so the router fails them over),
        the connection closes, the process is terminated and reaped."""
        if self._closed:
            return
        self._closed = True
        self._conn.fail_pending(
            exc if exc is not None
            else ReplicaUnavailable(f"worker {self.replica_id} closed")
        )
        await self._conn.close()
        await self._reap(grace_s)

    # ---- adapter sync (registry-sync RPCs) ---------------------------------

    async def adapter_register(self, entry_wire: dict[str, Any],
                               *, refresh: bool = False) -> int:
        out = await self._conn.call(
            "adapter_register", {**entry_wire, "refresh": refresh},
            timeout_s=120.0,
        )
        return int(out["slot"])

    async def adapter_unregister(self, adapter_id: str) -> None:
        await self._conn.call(
            "adapter_unregister", {"adapter_id": adapter_id}, timeout_s=60.0
        )

    async def stack_sync(self, entries: list[dict[str, Any]]) -> None:
        """Install the registry's entries on the worker, one entry per
        frame: a full-width adapter is a sizeable share of ``MAX_FRAME``, so
        a whole stack in one frame could exceed it."""
        for entry in entries:
            await self._conn.call(
                "stack_sync", {"entries": [entry]}, timeout_s=300.0
            )

    async def tenant_busy(self, adapter_id: str) -> int:
        out = await self._conn.call(
            "tenant_busy", {"adapter_id": adapter_id},
            timeout_s=self.probe_timeout_s,
        )
        return int(out.get("busy", 0))

    # ---- the rollout plane's calls (prefs/rollout_plane.py) ----------------

    async def rollout_start(self, pairs_per_round: int) -> dict[str, Any]:
        """Start (idempotently) the worker's pair producer."""
        return await self._conn.call("rollout_start",
                                     {"pairs_per_round": int(pairs_per_round)}, timeout_s=120.0)

    async def rollout_pull(self, after_seq: int, max_rounds: int = 8) -> dict[str, Any]:
        """Rounds with ``seq > after_seq``: an idempotent cursor read."""
        return await self._conn.call(
            "rollout_pull", {"after_seq": int(after_seq), "max_rounds": int(max_rounds)},
            timeout_s=self.probe_timeout_s + 60.0)

    async def rollout_ack(self, up_to_seq: int) -> dict[str, Any]:
        """Trim the worker's outbox through ``up_to_seq``."""
        return await self._conn.call("rollout_ack", {"up_to_seq": int(up_to_seq)},
                                     timeout_s=60.0)

    async def rollout_policy_version(self, version: int,
                                     tree_blob: bytes | None) -> dict[str, Any]:
        """Ship an adapter (flax-msgpack blob) as the new policy; idempotent
        and monotonic on the worker."""
        return await self._conn.call("rollout_policy_version",
                                     {"version": int(version), "tree": tree_blob},
                                     timeout_s=300.0)

    async def reward_score(self, items: list[dict[str, Any]]) -> list[float]:
        """Batched scalar scoring of ``{"prompt", "completion"}`` items."""
        out = await self._conn.call("reward_score", {"items": items}, timeout_s=300.0)
        return [float(s) for s in out.get("scores") or []]

    # ---- batcher-shaped sync surface (last-probe snapshots) ----------------

    @property
    def queue_depth(self) -> int:
        """The last probe's queue, or this client's requests in flight that
        the last probe's busy slots cannot hold, whichever is more: the
        router's ``queue_depth + slots_busy`` is then at least the
        outstanding count (the reference reads the probe alone)."""
        snapshot = int(self.probe_snapshot.get("queue_depth", 0))
        return max(snapshot, self._outstanding - self.slots_busy)

    @property
    def slots_busy(self) -> int:
        return int(self.probe_snapshot.get("slots_busy", 0))

    @property
    def step_errors_total(self) -> int:
        return int(self.probe_snapshot.get("step_errors_total", 0))

    @property
    def last_step_error(self) -> str | None:
        return self.probe_snapshot.get("last_step_error")

    @property
    def draining(self) -> bool:
        return self._draining

    def retry_after_s(self, extra_requests: int = 1) -> float:
        return float(self.probe_snapshot.get("retry_after_s", 1.0))

    def queue_depth_by_tenant(self) -> dict[str, int]:
        return dict(self._stats.get("queue_depth_by_tenant") or {})

    def inflight_by_tenant(self) -> dict[str, int]:
        return dict(self.probe_snapshot.get("inflight_by_tenant") or {})

    def stats(self) -> dict[str, Any]:
        out = dict(self._stats)
        out.setdefault("queue_depth", self.queue_depth)
        out.setdefault("slots_busy", self.slots_busy)
        out["transport"] = "process"
        out["pid"] = self.pid
        return out



class RewardClient:
    """A synchronous ``reward_score`` caller for a plain thread (a rollout
    worker's producer scores each round from its generate path): a private
    event loop on a daemon thread and one :class:`_Connection`; each
    :meth:`score` is a round trip onto that loop.  The connection is retried
    for up to ``connect_timeout_s`` while the reward worker is still
    starting (it may be spawned beside its callers)."""

    def __init__(self, host: str, port: int, *, timeout_s: float = 300.0,
                 connect_timeout_s: float = 120.0):
        import threading

        self._timeout_s = timeout_s
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="ftc-reward-client", daemon=True)
        self._thread.start()

        async def connect() -> _Connection:
            deadline = time.monotonic() + connect_timeout_s
            while True:
                try:
                    return await _Connection.open(host, int(port))
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    await asyncio.sleep(0.2)

        try:
            self._conn: _Connection = self._run(connect())
        except BaseException:
            self._stop_loop()
            raise
        #: calls, items scored and seconds spent in the RPC (the rollout
        #: worker's stats)
        self.calls_total = 0
        self.items_total = 0
        self.seconds_total = 0.0

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(
            self._timeout_s + 30.0)

    def score(self, items: list[dict[str, Any]]) -> list[float]:
        """Scores of ``{"prompt": [...], "completion": [...]}`` items."""

        async def call() -> list[float]:
            out = await self._conn.call("reward_score", {"items": items},
                                        timeout_s=self._timeout_s)
            return [float(s) for s in out.get("scores") or []]

        t0 = time.perf_counter()
        scores = self._run(call())
        self.seconds_total += time.perf_counter() - t0
        self.calls_total += 1
        self.items_total += len(items)
        return scores

    def batch_reward_fn(self):
        """:class:`~..prefs.actor.RolloutActor`'s ``batch_reward_fn``: a list
        of (prompt, completion) pairs in, their scores out."""

        def fn(pairs: list[tuple[list[int], list[int]]]) -> list[float]:
            return self.score([{"prompt": [int(t) for t in p],
                                "completion": [int(t) for t in c]} for p, c in pairs])

        return fn

    def _stop_loop(self) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5.0)

    def close(self) -> None:
        try:
            self._run(self._conn.close())
        # best-effort teardown of a socket that may be dead already
        except Exception:
            logger.debug("reward client close raced its peer", exc_info=True)
        self._stop_loop()
