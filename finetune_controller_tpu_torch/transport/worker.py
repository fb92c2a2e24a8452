"""Serve worker process: one engine + batcher, its own CUDA context, one
socket.

Entrypoint::

    python -m finetune_controller_tpu_torch.transport.worker --spec <spec.json>

The spec (written by :class:`~.process.ProcessTransport` into the worker's
sandbox) names the payload builder, the engine, batcher and adapter
configuration and the socket to bind.  Startup order is part of the
contract:

1. build the payload (``transport/builders.py``) and a WARM engine: one
   prefill per prompt bucket and decode steps on the card
   (``serve/engine.py::warm_engine``), which loads the paged kernel's
   library and grows the allocator before traffic; a worker that cannot
   load a kernel library or reach the card exits here, and its spawn fails
   with this log's tail;
2. arm the seeded chaos hand (``FTC_FAULT_SERVE_*``, forwarded into the
   spawn env) with ``hard_kill=True``: a ``kill`` fault SIGKILLs the real
   process, so the fleet's detection runs against a genuine process death;
3. bind ``127.0.0.1:<port>`` (port 0 = ephemeral) and atomically write
   ``transport.json`` (bound port + pid), which the parent's spawn
   handshake polls for;
4. start the heartbeat (``resilience/heartbeat.py::HeartbeatWriter``):
   ``engine.steps_total`` beats into the sandbox, so a SIGKILLed or wedged
   worker stops beating and the client's lease catches it.

RPCs (one length-prefixed frame per message, concurrent requests
multiplexed by id over one connection): ``hello``, ``probe`` (health,
decode progress, the batcher's stats, the paged kernel's launch count since
warm-up, the flash kernels' launches in the process and its peak card
memory), ``generate``
(remaining-deadline budget, idempotent request id: a duplicate attaches to
the attempt in flight, or replays from a bounded LRU after), ``drain`` (bounce the queue, finish lanes in flight,
then exit 0), ``tenant_busy``, ``adapter_register`` / ``adapter_unregister``
/ ``stack_sync`` (the registry-sync RPCs: flax-msgpack adapter deltas,
never base weights; a re-register with ``refresh`` drops the tenant's prefix
namespace), and the rollout plane's ops (``prefs/rollout_plane.py``):
``rollout_start`` / ``rollout_pull`` / ``rollout_ack`` /
``rollout_policy_version`` on a worker whose spec has a ``rollout`` section
(the actor's engine in place of the request batcher), ``reward_score`` on
one whose spec has a ``reward`` section (a reward job's head over the
served trunk).

Engine work (prefill, decode steps, adapter installs) runs in worker
threads, so a probe is answered during a prefill.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import dataclasses
import json
import logging
import os
import sys
import time
from typing import Any

logger = logging.getLogger("ftc.transport.worker")

TRANSPORT_FILENAME = "transport.json"

#: completed-result replay cache: the wire-level half of exactly-once — a
#: duplicate generate for a completed id replays without touching the engine
COMPLETED_CACHE = 512


@dataclasses.dataclass
class WorkerSpec:
    """The parsed ``--spec`` document."""

    job_id: str
    replica_id: str
    sandbox: str
    builder: str
    builder_kwargs: dict[str, Any]
    engine: dict[str, Any]
    batcher: dict[str, Any]
    adapters: dict[str, Any] | None = None
    #: a rollout worker's actor settings (``prefs/rollout_plane.py``)
    rollout: dict[str, Any] | None = None
    #: a reward worker's ``{"artifacts_dir": ...}``: the head to score with
    #: (``RewardScorer.from_artifacts``)
    reward: dict[str, Any] | None = None
    host: str = "127.0.0.1"
    port: int = 0
    heartbeat_interval_s: float = 2.0
    warm_start: bool = True

    @classmethod
    def load(cls, path: str) -> "WorkerSpec":
        with open(path) as f:
            doc = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in fields})


def _error_doc(exc: BaseException) -> dict[str, Any]:
    doc: dict[str, Any] = {"type": type(exc).__name__, "message": str(exc)}
    retry_after = getattr(exc, "retry_after_s", None)
    if retry_after is not None:
        doc["retry_after_s"] = float(retry_after)
    return doc


def _result_doc(result) -> dict[str, Any]:
    return {
        "request_id": result.request_id,
        "prompt_tokens": [int(t) for t in result.prompt_tokens],
        "generated": [int(t) for t in result.generated],
        "finish_reason": result.finish_reason,
        "steps": int(result.steps),
        "admitted_at": float(result.admitted_at),
        "finished_at": float(result.finished_at),
    }


def _paged_launches() -> int:
    from ..ops.kernels import paged_attention

    return int(paged_attention.paged_attention.launches)


_FLASH_KERNELS = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")


def _flash_launches() -> dict[str, int]:
    """The flash kernels' launches since warm-up (a reward worker's scoring
    forward runs the forward kernel)."""
    from ..ops.kernels import flash_attention as fa

    return {name: int(getattr(fa, name).launches) for name in _FLASH_KERNELS}


def zero_launches() -> None:
    """Start the probe's kernel counts after the warm-up: they then count
    the work the worker does for its callers."""
    from ..ops.kernels import flash_attention as fa
    from ..ops.kernels import paged_attention

    paged_attention.paged_attention.launches = 0
    for name in _FLASH_KERNELS:
        getattr(fa, name).launches = 0


def _cuda_peak_bytes() -> int:
    """This process's peak of allocated card memory (0 off the card)."""
    import torch

    return int(torch.cuda.max_memory_allocated()) if torch.cuda.is_initialized() else 0


class WorkerServer:
    """The RPC surface over one ``(engine, batcher)`` pair.

    Built by :func:`main` (a worker process) or directly by tests, which run
    it in-process against a loopback socket to exercise the protocol
    without a process spawn.
    """

    def __init__(self, spec: WorkerSpec, engine, batcher, registry=None,
                 *, exit_on_drain: bool = True):
        self.spec = spec
        self.engine = engine
        self.batcher = batcher
        self.registry = registry
        self.exit_on_drain = exit_on_drain
        self._server: asyncio.base_events.Server | None = None
        self.port: int | None = None
        self._exit_requested = asyncio.Event()
        self.exit_code = 0
        #: request_id -> future of the in-flight attempt (duplicates attach)
        self._inflight: dict[str, asyncio.Future] = {}
        #: request_id -> result doc (bounded LRU replay)
        self._completed: collections.OrderedDict[str, dict] = collections.OrderedDict()
        #: server-side writers of open connections: closed before
        #: ``wait_closed()``, which since Python 3.12 waits for every
        #: connection — a client that never hangs up would block it forever
        self._writers: set[asyncio.StreamWriter] = set()
        self._hb_task: asyncio.Task | None = None
        self._hb_writer = None
        self.rpcs_total = 0
        #: the rollout worker's service, the reward worker's scorer
        self.rollout = None
        self.reward_scorer = None

    # ---- lifecycle ---------------------------------------------------------

    async def start(self) -> int:
        """Bind the socket; returns the bound port."""
        self._server = await asyncio.start_server(
            self._handle_conn, self.spec.host, self.spec.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    def start_heartbeat(self) -> None:
        from ..resilience.heartbeat import HeartbeatWriter

        # the cadence is this loop's, not the writer's throttle
        self._hb_writer = HeartbeatWriter(self.spec.sandbox, interval_s=0.0)
        self._hb_writer.beat(self.engine.steps_total, force=True)

        async def beat_loop():
            while not self._exit_requested.is_set():
                await asyncio.sleep(max(0.1, self.spec.heartbeat_interval_s))
                await asyncio.to_thread(
                    self._hb_writer.beat, self.engine.steps_total, force=True
                )

        self._hb_task = asyncio.get_running_loop().create_task(beat_loop())

    async def serve_until_exit(self) -> int:
        await self._exit_requested.wait()
        await self.stop()
        return self.exit_code

    async def stop(self) -> None:
        """Tear down socket, heartbeat and batcher (tests drive this
        directly; the worker process goes through :meth:`serve_until_exit`)."""
        if self._hb_task is not None:
            self._hb_task.cancel()
            self._hb_task = None
        if self._server is not None:
            self._server.close()
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()
            self._server = None
        await self.batcher.close()

    def request_exit(self, code: int = 0) -> None:
        self.exit_code = code
        self._exit_requested.set()

    # ---- connection loop ---------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        from .wire import FrameError, read_msg, write_msg

        self._writers.add(writer)
        lock = asyncio.Lock()  # one response frame at a time per connection
        tasks: set[asyncio.Task] = set()

        async def respond(doc: dict) -> None:
            async with lock:
                try:
                    await write_msg(writer, doc)
                except (ConnectionError, RuntimeError):
                    logger.debug("response write failed (client gone)")

        async def run_one(msg: dict) -> None:
            msg_id = msg.get("id")
            try:
                payload = await self._dispatch(
                    str(msg.get("op", "")), msg.get("payload") or {}
                )
                await respond({"id": msg_id, "ok": True, "payload": payload})
            # not swallowed: marshalled to the caller as a typed wire error
            except BaseException as exc:
                await respond({"id": msg_id, "ok": False, "error": _error_doc(exc)})

        try:
            while True:
                try:
                    msg = await read_msg(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                except FrameError:
                    logger.warning("torn frame; dropping connection")
                    break
                task = asyncio.get_running_loop().create_task(run_one(msg))
                tasks.add(task)
                task.add_done_callback(tasks.discard)
        finally:
            for t in tasks:
                t.cancel()
            self._writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            # best-effort close of a connection already torn down
            except Exception:
                logger.debug("connection close raced its teardown", exc_info=True)

    # ---- dispatch ----------------------------------------------------------

    async def _dispatch(self, op: str, payload: dict[str, Any]) -> Any:
        self.rpcs_total += 1
        handler = getattr(self, f"_op_{op}", None)
        if handler is None:
            raise ValueError(f"unknown transport op {op!r}")
        return await handler(payload)

    def _stats(self) -> dict[str, Any]:
        stats = self.batcher.stats()
        stats["paged_launches"] = _paged_launches()
        stats["flash_launches"] = _flash_launches()
        if self.reward_scorer is not None:
            stats["reward_scored_total"] = self.reward_scorer.scored_total
        stats["cuda_peak_bytes"] = _cuda_peak_bytes()
        return stats

    async def _op_hello(self, payload: dict) -> dict:
        cfg = self.engine.config
        return {
            "job_id": self.spec.job_id,
            "replica_id": self.spec.replica_id,
            "pid": os.getpid(),
            "engine": {
                "slots": cfg.slots,
                "prompt_buckets": list(cfg.prompt_buckets),
                "max_new_tokens": cfg.max_new_tokens,
                "page_tokens": cfg.page_tokens,
                "paged": cfg.paged,
            },
            "adapters": (
                [e.adapter_id for e in self.registry.entries()]
                if self.registry is not None else []
            ),
        }

    async def _op_probe(self, payload: dict) -> dict:
        probe = await self.batcher.health_probe()
        probe.update({
            "pid": os.getpid(),
            "retry_after_s": self.batcher.retry_after_s(),
            "kv_slack_pages": self.engine.kv_slack_pages(),
            "rpcs_total": self.rpcs_total,
            "stats": self._stats(),
            "ts": time.time(),
        })
        return probe

    async def _op_generate(self, payload: dict) -> dict:
        from ..serve.engine import GenRequest

        request_id = str(payload["request_id"])
        done = self._completed.get(request_id)
        if done is not None:
            self._completed.move_to_end(request_id)
            return done  # idempotent replay: never decode an id twice
        racing = self._inflight.get(request_id)
        if racing is not None:
            return await asyncio.shield(racing)  # attach to the live attempt
        req = GenRequest(
            request_id=request_id,
            tokens=[int(t) for t in payload["tokens"]],
            max_new_tokens=int(payload.get("max_new_tokens", 32)),
            temperature=float(payload.get("temperature", 0.0)),
            top_k=int(payload.get("top_k", 0)),
            eos_id=payload.get("eos_id"),
            seed=int(payload.get("seed", 0)),
            adapter_id=str(payload.get("adapter_id") or ""),
        )
        deadline_in = payload.get("deadline_in_s")
        # the parent ships a REMAINING budget: monotonic clocks are
        # per-process, so the absolute deadline is re-anchored here
        deadline = (
            time.monotonic() + float(deadline_in) if deadline_in is not None else None
        )
        timeout_s = payload.get("timeout_s")
        future = asyncio.get_running_loop().create_future()
        self._inflight[request_id] = future
        try:
            result = await self.batcher.submit(
                req, deadline=deadline,
                timeout_s=None if timeout_s is None else float(timeout_s),
            )
            doc = _result_doc(result)
            self._completed[doc["request_id"]] = doc
            while len(self._completed) > COMPLETED_CACHE:
                self._completed.popitem(last=False)
            if not future.done():
                future.set_result(doc)
            return doc
        except BaseException as exc:
            if not future.done():
                future.set_exception(exc)
                future.exception()  # attached duplicates or nobody: mark seen
            raise
        finally:
            self._inflight.pop(request_id, None)

    async def _op_drain(self, payload: dict) -> dict:
        clean = await self.batcher.drain(float(payload.get("timeout_s", 30.0)))
        if self.exit_on_drain:
            # reply first, then leave: the exit path closes the server (and
            # this connection's writer) after the response frame flushed
            asyncio.get_running_loop().call_later(0.05, self.request_exit, 0)
        # the final stats ride the reply: the fleet retires this replica's
        # counters from them (a probe-cadence snapshot would lose the drain
        # window's completions)
        stats = self._stats()
        logger.info("worker %s drained (clean=%s); paged kernel launches since "
                    "warm-up: %d", self.spec.replica_id, clean, stats["paged_launches"])
        return {"clean": clean, "stats": stats}

    async def _op_tenant_busy(self, payload: dict) -> dict:
        busy = await self.batcher.tenant_busy(str(payload.get("adapter_id") or ""))
        return {"busy": busy}

    def _require_registry(self):
        if self.registry is None:
            raise ValueError("worker has no adapter registry (serve_max_adapters=0)")
        return self.registry

    async def _op_adapter_register(self, payload: dict) -> dict:
        from ..serve.adapters import entry_from_wire

        registry = self._require_registry()
        adapter_id, tree, alpha, rank, meta = entry_from_wire(payload)
        refresh = bool(payload.get("refresh")) and registry.get(adapter_id) is not None
        entry = registry.register(adapter_id, tree, alpha, rank, meta=meta)
        await asyncio.to_thread(self.engine.install_adapter, adapter_id)
        if refresh:
            # tenant rollover: drop the namespace AFTER the install, as the
            # in-process fleet does
            await asyncio.to_thread(self.engine.drop_prefix_namespace, adapter_id)
        return {"slot": entry.slot}

    async def _op_adapter_unregister(self, payload: dict) -> dict:
        registry = self._require_registry()
        entry = registry.unregister(str(payload["adapter_id"]))
        await asyncio.to_thread(self.engine.remove_adapter, entry.adapter_id, entry.slot)
        return {"slot": entry.slot}

    async def _op_stack_sync(self, payload: dict) -> dict:
        """Registry sync (spawn, rollover): install every entry given, so a
        worker that arrives mid-churn joins consistent."""
        installed = []
        for doc in payload.get("entries") or []:
            out = await self._op_adapter_register(doc)
            installed.append({"adapter_id": doc["adapter_id"], **out})
        return {"installed": installed}

    # ---- rollout worker ----------------------------------------------------

    def _require_rollout(self):
        if self.rollout is None:
            raise ValueError("worker is not a rollout tenant (spec has no rollout section)")
        return self.rollout

    async def _op_rollout_start(self, payload: dict) -> dict:
        """Start (or idempotently re-confirm) the producer loop."""
        svc = self._require_rollout()
        return await asyncio.to_thread(svc.start, int(payload["pairs_per_round"]))

    async def _op_rollout_pull(self, payload: dict) -> dict:
        """Rounds with ``seq > after_seq``: an idempotent cursor read, so a
        re-delivered pull replays the same rounds under the same ids."""
        svc = self._require_rollout()
        return await asyncio.to_thread(svc.pull, int(payload["after_seq"]),
                                       int(payload.get("max_rounds", 8)))

    async def _op_rollout_ack(self, payload: dict) -> dict:
        """Trim the outbox through ``up_to_seq`` (monotonic; stale acks are
        no-ops)."""
        svc = self._require_rollout()
        return await asyncio.to_thread(svc.ack, int(payload["up_to_seq"]))

    async def _op_rollout_policy_version(self, payload: dict) -> dict:
        """Install a learner-shipped adapter (idempotent, monotonic): the
        rollover push, megabytes of LoRA, never a model load."""
        svc = self._require_rollout()
        return await asyncio.to_thread(svc.push_policy, int(payload["version"]),
                                       payload.get("tree"))

    # ---- reward worker -----------------------------------------------------

    def _require_reward(self):
        if self.reward_scorer is None:
            raise ValueError("worker is not a reward tenant (spec has no reward section)")
        return self.reward_scorer

    async def _op_reward_score(self, payload: dict) -> dict:
        """Batched scalar scoring: one forward for a whole rollout round."""
        scorer = self._require_reward()
        scores = await asyncio.to_thread(scorer.score, payload["items"] or [])
        return {"scores": [float(s) for s in scores]}


def _write_transport_file(spec: WorkerSpec, port: int) -> str:
    path = os.path.join(spec.sandbox, TRANSPORT_FILENAME)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump({"host": spec.host, "port": port, "pid": os.getpid()}, f)
    os.replace(tmp, path)
    return path


def build_worker(spec: WorkerSpec, *, exit_on_drain: bool = True) -> WorkerServer:
    """Construct the (warm) engine + batcher + registry from a spec — the
    heavy half of worker startup, shared with in-process protocol tests."""
    from ..resilience.faults import ServeFaultInjector
    from ..serve.adapters import AdapterRegistry
    from ..serve.batcher import Batcher
    from ..serve.engine import BatchEngine, EngineConfig, warm_engine
    from .builders import resolve_builder

    if spec.rollout:
        # a rollout worker: the actor's engine replaces the request batcher
        from ..prefs.rollout_plane import build_rollout_worker

        return build_rollout_worker(spec, exit_on_drain=exit_on_drain)
    model = resolve_builder(spec.builder)(**(spec.builder_kwargs or {}))
    registry = None
    if spec.adapters:
        registry = AdapterRegistry(int(spec.adapters["capacity"]),
                                   int(spec.adapters["max_rank"]))
    engine_cfg = EngineConfig(**{
        **spec.engine, "prompt_buckets": tuple(spec.engine["prompt_buckets"]),
    })
    engine = BatchEngine(model, engine_cfg, adapters=registry)
    if spec.warm_start:
        warm_engine(engine)
    # the probe's counts cover the requests this worker serves, not its
    # warm-up
    zero_launches()
    fault = ServeFaultInjector.from_env()
    if fault is not None and fault.arm(spec.replica_id, engine, hard_kill=True):
        logger.warning("worker %s armed with a serve fault (hard kill)", spec.replica_id)
    batcher = Batcher(engine, **(spec.batcher or {}))
    server = WorkerServer(spec, engine, batcher, registry, exit_on_drain=exit_on_drain)
    if spec.reward:
        # a reward worker: the scorer shares the engine's (merged) weights;
        # the head comes from the reward job's artifacts
        from ..prefs.rollout_plane import RewardScorer

        server.reward_scorer = RewardScorer.from_artifacts(
            str(spec.reward["artifacts_dir"]), model)
    return server


async def _amain(spec: WorkerSpec) -> int:
    # the startup path: the model build runs once, before the loop serves
    server = build_worker(spec)
    port = await server.start()
    server.start_heartbeat()
    # off the loop: a slow sandbox disk must not stall the RPC loop the
    # parent's handshake is about to dial
    await asyncio.to_thread(_write_transport_file, spec, port)
    logger.info("serve worker %s (job=%s) listening on %s:%d pid=%d",
                spec.replica_id, spec.job_id, spec.host, port, os.getpid())
    return await server.serve_until_exit()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="finetune-controller serve worker (one replica process)")
    parser.add_argument("--spec", required=True, help="path to the worker spec JSON")
    ns = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [worker] %(name)s: %(message)s",
    )
    spec = WorkerSpec.load(ns.spec)
    os.makedirs(spec.sandbox, exist_ok=True)
    return asyncio.run(_amain(spec))


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
