"""Disaggregated RLHF data plane (counterpart of ``prefs/rollout_plane.py``).

The rollout actor moves out of the learner's process into a serve worker
(``transport/worker.py`` with a ``rollout`` spec section), and scored
preference pairs stream back over four idempotent RPCs::

    learner (DPOTrainer.fit)                 rollout worker (own process)
    ────────────────────────                 ───────────────────────────
    RolloutPlane.push_policy  ──policy_version──▶  RolloutService (actor)
    puller thread             ──rollout_pull────▶    outbox of ROUND docs
       dedup → RolloutBuffer  ◀─rounds+spans────
                              ──rollout_ack─────▶    trim outbox

Exactly-once without a transaction log:

* the worker's outbox is a monotonically sequenced list of round documents;
  ``pull(after_seq)`` is a pure cursor read and ``ack(up_to_seq)`` a
  monotonic trim, so a re-delivered pull replays identical documents;
* every pair carries the reference's id ``v{version}:r{round}:p{i}``.
  Generation is deterministic per (actor seed, version, round), so a
  SIGKILLed worker that respawns (same seed) regenerates the same round at
  the same version as byte-identical pairs under the same ids, and the
  learner's bounded seen-set drops them as duplicates.

**The one divergence from the reference:** the seen-set is keyed by
``(worker id, pair id)``.  The reference keys it by the pair id alone, and
its workers are seeded ``seed + index``, so two workers emit DIFFERENT pairs
under the SAME ids and the second worker's are dropped as "duplicates"
(two workers, 24 distinct pairs, 12 ingested).  ``worker_id`` is
``rollout-{i}``, stable across respawns as the seed is, so a replay from
the same worker still collides with its original and pairs of different
workers never do.  The wire documents are the reference's, field for field.

Policy rollover is a PUSH of the adapter (``transport/wire.py::
tree_to_blob`` of the checkpoint's flat LoRA tensors: megabytes, never base
weights): the plane ships each committed checkpoint over
``rollout_policy_version`` and the worker installs it BETWEEN rounds
(:meth:`~.actor.RolloutActor.install_policy`), so a reload never stalls a
round.  The frozen base crosses once, at spawn, through the ``rollout_base``
artifact on disk (:func:`write_rollout_base`, read back by
``transport/builders.py::rollout_base``).

The second half is the learned reward model: a ``task: reward`` job's
export is served by a worker with a ``reward`` spec section, and
:class:`RewardScorer` answers the batched ``reward_score`` RPC that the
actor's ``batch_reward_fn`` calls once per round (on a card its forward
runs the flash kernel).

Each round document carries a host-clock span (``time.time_ns`` at the
round's start and end); the learner records it into the job's trace
(``rollout.round``, service ``rollout``), so the trace shows generation
overlapping learner steps.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..resilience.policy import RetryPolicy
from .actor import _LORA_LEAVES, RolloutActor, increment_prompts, increment_reward
from .learner import RolloutConfig
from .reward_trainer import HEAD_PREFIX, REWARD_HEAD_FILENAME, read_reward_head
from .rollout_buffer import PreferencePair, RolloutBuffer

logger = logging.getLogger(__name__)


def pair_id(version: int, round_no: int, index: int) -> str:
    """The idempotency key within one worker: deterministic generation makes
    a regenerated (version, round, index) byte-identical."""
    return f"v{int(version)}:r{int(round_no)}:p{int(index)}"


def _pair_doc(pair: PreferencePair, pid: str) -> dict[str, Any]:
    return {
        "id": pid,
        "prompt": [int(t) for t in pair.prompt],
        "chosen": [int(t) for t in pair.chosen],
        "rejected": [int(t) for t in pair.rejected],
        "version": int(pair.version),
        "reward_chosen": float(pair.reward_chosen),
        "reward_rejected": float(pair.reward_rejected),
    }


def _pair_from_doc(doc: dict[str, Any]) -> PreferencePair:
    return PreferencePair(
        prompt=tuple(int(t) for t in doc["prompt"]),
        chosen=tuple(int(t) for t in doc["chosen"]),
        rejected=tuple(int(t) for t in doc["rejected"]),
        version=int(doc.get("version", 0)),
        reward_chosen=float(doc.get("reward_chosen", 0.0)),
        reward_rejected=float(doc.get("reward_rejected", 0.0)),
    )


def _policy_tensors(tree: dict) -> dict[str, torch.Tensor]:
    """A pushed policy's leaves as tensors (the blob decodes to numpy
    arrays, bf16 leaves to tensors)."""
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# worker side: the streaming pair service
# ---------------------------------------------------------------------------


class RolloutService:
    """Producer loop and outbox behind the ``rollout_*`` RPCs.

    One daemon thread runs the actor: install a pending policy push,
    generate a round, append its document to the bounded outbox.  The RPC
    handlers touch only the outbox and the pending slot under the lock, so
    a policy push never waits for a round in flight (it installs between
    rounds)."""

    def __init__(self, actor: RolloutActor, *, reward_client=None,
                 max_outbox_rounds: int = 64):
        self.actor = actor
        self._reward_client = reward_client
        #: backpressure: a learner that stops acking stops the actor from
        #: spending the card on pairs nobody trains on
        self._max_outbox = max(1, max_outbox_rounds)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._outbox: collections.deque[dict] = collections.deque()
        self._seq = 0
        self._pairs_per_round = 0
        self._pending_policy: tuple[int, dict | None] | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._error: str | None = None
        self.rounds_total = 0
        self.policy_installs_total = 0

    # ---- RPC surface (sync; the worker runs these in threads) -------------

    def start(self, pairs_per_round: int) -> dict[str, Any]:
        """Idempotent: a re-delivered start re-confirms the running
        producer instead of starting a second one."""
        with self._lock:
            self._pairs_per_round = max(1, int(pairs_per_round))
            running = self._thread is not None and self._thread.is_alive()
            if not running and not self._stop.is_set():
                self._thread = threading.Thread(target=self._produce,
                                                name="ftc-rollout-producer", daemon=True)
                self._thread.start()
                running = True
            seq = self._seq
        return {"started": running, "seq": seq, "version": self.actor.version}

    def pull(self, after_seq: int, max_rounds: int = 8) -> dict[str, Any]:
        """Rounds with ``seq > after_seq``; a dead producer raises here."""
        if self._error is not None:
            raise RuntimeError(f"rollout producer died: {self._error}")
        with self._lock:
            rounds = [d for d in self._outbox if d["seq"] > int(after_seq)
                      ][: max(1, int(max_rounds))]
            seq = self._seq
        return {"rounds": rounds, "seq": seq, "version": self.actor.version,
                "stats": self.stats()}

    def ack(self, up_to_seq: int) -> dict[str, Any]:
        dropped = 0
        with self._lock:
            while self._outbox and self._outbox[0]["seq"] <= int(up_to_seq):
                self._outbox.popleft()
                dropped += 1
            depth = len(self._outbox)
        self._wake.set()  # a backpressured producer may resume
        return {"acked": dropped, "outbox_depth": depth}

    def push_policy(self, version: int, tree_blob: bytes | None) -> dict[str, Any]:
        """Stage a learner-shipped adapter; the producer installs it between
        rounds.  Idempotent and monotonic (stale versions are no-ops), so the
        plane may re-push its cached policy after every respawn."""
        from ..transport.wire import tree_from_blob

        version = int(version)
        tree = _policy_tensors(tree_from_blob(tree_blob)) if tree_blob else None
        with self._lock:
            pending_v = self._pending_policy[0] if self._pending_policy else 0
            accepted = version > max(self.actor.version, pending_v)
            if accepted:
                self._pending_policy = (version, tree)
            running = self._thread is not None and self._thread.is_alive()
        if accepted and not running:
            # pushed before start(): install now, so the first round
            # already decodes with the shipped policy
            self._install_pending()
        with self._lock:
            pending = self._pending_policy is not None
        return {"accepted": accepted, "version": self.actor.version, "pending": pending}

    # ---- producer ---------------------------------------------------------

    def _install_pending(self) -> None:
        with self._lock:
            pending = self._pending_policy
            self._pending_policy = None
        if pending is not None and self.actor.install_policy(*pending):
            with self._lock:
                self.policy_installs_total += 1

    def _produce(self) -> None:
        try:
            while not self._stop.is_set():
                self._install_pending()
                with self._lock:
                    n = self._pairs_per_round
                    backpressure = len(self._outbox) >= self._max_outbox
                if backpressure:
                    self._wake.wait(0.05)
                    self._wake.clear()
                    continue
                t0 = time.time_ns()
                pairs = self.actor.generate_pairs(n)
                t1 = time.time_ns()
                round_no, version = self.actor.rounds, self.actor.version
                docs = [_pair_doc(p, pair_id(version, round_no, i))
                        for i, p in enumerate(pairs)]
                with self._lock:
                    self._seq += 1
                    self._outbox.append({
                        "seq": self._seq, "round": round_no, "version": version,
                        "pairs": docs,
                        # host-clock span for the learner's trace
                        "span": {"start_ns": t0, "end_ns": t1, "pairs": len(docs),
                                 "tokens": self.actor.tokens_generated},
                    })
                    self.rounds_total += 1
        # not swallowed: re-raised to the learner on its next pull
        except BaseException as exc:
            self._error = f"{type(exc).__name__}: {exc}"
            logger.exception("rollout producer died")

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        with self._lock:
            thread = self._thread
        if thread is not None:
            thread.join(timeout=10.0)
        if self._reward_client is not None:
            self._reward_client.close()

    def stats(self) -> dict[str, Any]:
        with self._lock:
            counters = {
                "rollout_rounds_total": self.rounds_total,
                "rollout_outbox_depth": len(self._outbox),
                "rollout_seq": self._seq,
                "rollout_policy_installs_total": self.policy_installs_total,
            }
        if self._reward_client is not None:
            counters.update(reward_score_calls=self._reward_client.calls_total,
                            reward_score_items=self._reward_client.items_total,
                            reward_score_seconds=round(self._reward_client.seconds_total, 6))
        return {
            **counters,
            "actor_tokens_per_sec": round(self.actor.tokens_per_sec, 1),
            "actor_version": self.actor.version,
            "actor_pairs_generated": self.actor.pairs_generated,
            "actor_rounds": self.actor.rounds,
            "actor_bootstrap_pairs": self.actor.bootstrap_pairs,
            # cumulative decode counters: deltas give the decode rate over
            # any interval
            "actor_tokens_generated": self.actor.tokens_generated,
            "actor_generate_seconds": round(self.actor.generate_seconds, 6),
        }


class _RolloutBatcherShim:
    """The batcher-shaped surface :class:`~..transport.worker.WorkerServer`'s
    probe, heartbeat and drain paths read, over a :class:`RolloutService`
    (not a ``Batcher``: one would step the actor's engine a second time)."""

    def __init__(self, service: RolloutService):
        self.service = service
        self.engine = service.actor.engine

    async def health_probe(self) -> dict[str, Any]:
        return {
            "steps_total": self.engine.steps_total,
            "slots_busy": 0,
            "queue_depth": len(self.service._outbox),
            "step_errors_total": 1 if self.service._error else 0,
            "last_step_error": self.service._error,
        }

    def retry_after_s(self, extra_requests: int = 1) -> float:
        return 1.0

    def stats(self) -> dict[str, Any]:
        return self.service.stats()

    async def tenant_busy(self, adapter_id: str) -> int:
        return 0

    async def drain(self, timeout_s: float = 30.0) -> bool:
        await asyncio.to_thread(self.service.stop)
        return True

    async def close(self, exc: BaseException | None = None) -> None:
        await asyncio.to_thread(self.service.stop)


def _policy_lora(spec, model):
    """The adapter config of the policies a rollout worker is pushed: the
    learner's, from ``rollout_base/model.json`` (the ``rollout_base``
    builder builds the base alone), else the built model's."""
    if spec.builder == "rollout_base":
        from ..train.cli import build_model_config

        path = os.path.join(spec.builder_kwargs["dir"], "rollout_base", "model.json")
        with open(path) as f:
            return build_model_config({"model": json.load(f)}).lora
    return model.cfg.lora


def build_rollout_worker(spec, *, exit_on_drain: bool = True):
    """A rollout worker from its spec (the ``spec.rollout`` branch of
    ``transport/worker.py::build_worker``): the actor's paged engine takes
    the request batcher's place."""
    from ..serve.engine import warm_engine
    from ..transport.builders import resolve_builder
    from ..transport.worker import WorkerServer, zero_launches

    rcfg = dict(spec.rollout or {})
    t0 = time.perf_counter()
    model = resolve_builder(spec.builder)(**(spec.builder_kwargs or {}))
    t1 = time.perf_counter()
    vocab = int(model.cfg.vocab_size)
    seq_len = int(rcfg.get("seq_len") or model.cfg.max_seq_len)
    prompt_fraction = float(rcfg.get("prompt_fraction", 0.5))
    prompt_len = max(2, int(seq_len * prompt_fraction))
    seed = int(rcfg.get("seed", 0))
    reward_client = None
    batch_reward_fn = None
    if int(rcfg.get("reward_port") or 0):
        from ..transport.client import RewardClient

        reward_client = RewardClient(str(rcfg.get("reward_host") or "127.0.0.1"),
                                     int(rcfg["reward_port"]))
        batch_reward_fn = reward_client.batch_reward_fn()
    oracle_fn = None
    if batch_reward_fn is None and bool(rcfg.get("oracle_bootstrap", True)):
        # programmatic rewards keep the cold-start bootstrap; a learned
        # reward model's scores are continuous (ties have measure zero)
        oracle_fn = lambda p, n: [(p[-1] + 1 + i) % vocab for i in range(n)]  # noqa: E731
    actor = RolloutActor(
        model, None,  # push mode: no checkpoint directory
        lora=_policy_lora(spec, model),
        reward_fn=lambda p, c: increment_reward(p, c, vocab),
        batch_reward_fn=batch_reward_fn,
        prompts=increment_prompts(seq_len, vocab, seed + 7919, prompt_fraction),
        oracle_fn=oracle_fn,
        prompt_bucket=prompt_len,
        max_new_tokens=min(int(rcfg.get("max_new_tokens", 16)), seq_len - prompt_len),
        temperature=float(rcfg.get("temperature", 0.8)),
        top_k=int(rcfg.get("top_k", 0)),
        slots=int(rcfg.get("slots", 4)),
        seed=seed,
    )
    del model  # the actor's engine holds the same base tensors
    t2 = time.perf_counter()
    if spec.warm_start:
        warm_engine(actor.engine)
    logger.info("rollout worker %s: model built in %.1f s, actor in %.1f s, warm-up in %.1f s",
                spec.replica_id, t1 - t0, t2 - t1, time.perf_counter() - t2)
    # the probe's counts cover the rounds, not the warm-up
    zero_launches()
    service = RolloutService(actor, reward_client=reward_client,
                             max_outbox_rounds=int(rcfg.get("max_outbox_rounds", 64)))
    server = WorkerServer(spec, actor.engine, _RolloutBatcherShim(service), None,
                          exit_on_drain=exit_on_drain)
    server.rollout = service
    return server


# ---------------------------------------------------------------------------
# reward serving: the batched pair scorer behind ``reward_score``
# ---------------------------------------------------------------------------


class RewardScorer:
    """Scalar scores of (prompt, completion) items over a served trunk and
    a reward job's head (``prefs/losses.py::reward_scores`` over the trunk's
    logits).  Rows and length are padded to powers of two, as the
    reference's compiled shapes are.  The reference scores the padded batch
    in one compiled call; here the (rows, length, vocabulary) f32 logits of
    one forward are held under ``MAX_LOGITS_BYTES`` by scoring the rows in
    chunks (rows are independent): a round of 32 items x 512 at a 128256
    vocabulary is 8.4 GB of f32 logits, and the card is shared with the
    learner and the rollout workers."""

    #: the bound on one forward's f32 logits
    MAX_LOGITS_BYTES = 2 << 30

    def __init__(self, model, head: dict):
        self._model = model
        device = next(model.parameters()).device
        self._head = {k: torch.as_tensor(v).to(device, torch.float32)
                      for k, v in head.items()}
        self.device = device
        #: (rows, length) of every batch scored so far
        self.shapes: set[tuple[int, int]] = set()
        self.scored_total = 0

    @classmethod
    def from_artifacts(cls, artifacts_dir: str, model) -> "RewardScorer":
        """The head of a reward job's artifacts: the exported
        ``reward_head.msgpack`` when present, else the newest committed
        checkpoint's ``head.*`` leaves (a staged serve prefix carries the
        spec and checkpoints only, and every checkpoint carries the head)."""
        if os.path.exists(os.path.join(artifacts_dir, REWARD_HEAD_FILENAME)):
            return cls(model, read_reward_head(artifacts_dir))
        from ..train.checkpoint import CheckpointManager

        ckpt_dir = os.path.join(artifacts_dir, "checkpoints")
        latest = None
        if os.path.isdir(ckpt_dir):
            ckpt = CheckpointManager(ckpt_dir, keep=10**9, sweep=False)
            latest = ckpt.latest_step()
        if latest is None:
            raise FileNotFoundError(
                f"no {REWARD_HEAD_FILENAME} and no committed checkpoint "
                f"under {artifacts_dir} — is this a task: reward job's "
                "artifact/deploy prefix?"
            )
        trainable = ckpt.restore(latest).get("trainable") or {}
        head = {k[len(HEAD_PREFIX):]: v for k, v in trainable.items()
                if k.startswith(HEAD_PREFIX)}
        if not head:
            raise ValueError(
                f"checkpoint step {latest} under {artifacts_dir} carries no "
                "reward head — was this job trained with task: reward?"
            )
        return cls(model, head)

    @torch.no_grad()
    def score(self, items: list[dict[str, Any]]) -> list[float]:
        from ..data.preference import _pad_pair
        from .losses import reward_scores

        if not items:
            return []
        n = len(items)
        longest = max(len(it["prompt"]) + len(it["completion"]) for it in items)
        s = 8
        while s < longest:
            s <<= 1
        s = min(s, int(self._model.cfg.max_seq_len))
        b = 1
        while b < n:
            b <<= 1
        tokens = np.zeros((b, s), np.int32)
        mask = np.zeros((b, s), np.float32)
        for i, it in enumerate(items):
            tokens[i], mask[i] = _pad_pair([int(x) for x in it["prompt"]],
                                           [int(x) for x in it["completion"]], s)
        t = torch.from_numpy(tokens).long().to(self.device)
        m = torch.from_numpy(mask).to(self.device)
        rows = max(1, self.MAX_LOGITS_BYTES // (s * int(self._model.cfg.vocab_size) * 4))
        out = torch.cat([reward_scores(self._model(t[i:i + rows]), t[i:i + rows],
                                       m[i:i + rows], self._head)
                         for i in range(0, b, rows)])
        self.shapes.add((b, s))
        self.scored_total += n
        return [float(x) for x in out[:n].cpu()]


# ---------------------------------------------------------------------------
# learner side: the plane
# ---------------------------------------------------------------------------


def _host_leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu")


def write_rollout_base(artifacts_dir: str, model_spec: dict,
                       base_state: dict[str, torch.Tensor], cfg=None) -> str:
    """Stage the frozen base for remote actors
    (``transport/builders.py::rollout_base`` reads it back): the model spec
    as JSON and the base (the port's state dict without adapters) as the
    reference's flax ``params`` tree in flax-msgpack (laid out for ``cfg``,
    by default the spec's config), each written to a temporary name and
    renamed.  Base weights cross here, on disk, once; the wire carries only
    adapters."""
    from ..models.convert import to_flax
    from ..train.cli import build_model_config
    from ..utils import flax_msgpack

    cfg = cfg or build_model_config({"model": model_spec})
    base = os.path.join(artifacts_dir, "rollout_base")
    os.makedirs(base, exist_ok=True)
    params = to_flax(base_state, cfg, leaf=_host_leaf)["params"]
    tmp = os.path.join(base, "model.json.tmp")
    with open(tmp, "w") as f:
        json.dump(model_spec, f, indent=2)
    os.replace(tmp, os.path.join(base, "model.json"))
    tmp = os.path.join(base, "params.msgpack.tmp")
    with open(tmp, "wb") as f:
        flax_msgpack.dump(params, f)
    os.replace(tmp, os.path.join(base, "params.msgpack"))
    return base


@dataclasses.dataclass
class _WorkerState:
    worker_id: str
    handle: Any = None
    generation: int = 0
    #: highest seq ingested from the CURRENT incarnation (reset on respawn:
    #: a new outbox restarts at seq 1, and the dedup keeps the reset from
    #: ingesting twice)
    cursor: int = 0
    alive: bool = False
    last_stats: dict = dataclasses.field(default_factory=dict)


class RolloutPlane:
    """The learner's side of the remote actors: spawns the workers, pulls
    rounds into the :class:`~.rollout_buffer.RolloutBuffer` (one puller
    thread per worker), dedups by (worker, pair id), pushes policy
    rollovers, and respawns dead workers with seeded backoff
    (``resilience/policy.py``).

    ``spawn_fn`` is an async ``(worker_id, generation) -> handle`` whose
    handle speaks :class:`~..transport.client.RemoteReplica`'s rollout calls:
    :class:`~..transport.process.ProcessTransport` spawns in production,
    in-memory fakes in tests.  The workers are brought up together."""

    def __init__(
        self,
        buffer: RolloutBuffer,
        *,
        num_workers: int,
        spawn_fn: Callable[..., Any],
        pairs_per_round: int,
        span_recorder=None,
        retry: RetryPolicy | None = None,
        dedup_capacity: int = 8192,
        pull_max_rounds: int = 8,
        idle_sleep_s: float = 0.02,
        rpc_timeout_s: float = 300.0,
    ):
        self.buffer = buffer
        self._spawn_fn = spawn_fn
        self.pairs_per_round = int(pairs_per_round)
        self._spans = span_recorder
        # effectively unbounded attempts: a rollout worker is cattle, and
        # the learner keeps stepping on buffered pairs while it comes back
        self._retry = retry or RetryPolicy(max_attempts=10**9, base_delay_s=0.2,
                                           max_delay_s=10.0, seed=0)
        self._pull_max_rounds = int(pull_max_rounds)
        self._idle_sleep_s = idle_sleep_s
        self._rpc_timeout_s = rpc_timeout_s
        #: guards the buffer, the seen-set and the ingest counters (pullers
        #: push from their threads, the learner samples from its own)
        self._lock = threading.Lock()
        #: (worker id, pair id) of the pairs ingested, oldest first
        self._seen: collections.OrderedDict[tuple[str, str], None] = collections.OrderedDict()
        self._dedup_capacity = int(dedup_capacity)
        self._workers = [_WorkerState(f"rollout-{i}") for i in range(max(1, num_workers))]
        self._policy: tuple[int, bytes] | None = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.respawns_total = 0
        self.dup_pairs_total = 0
        self.policy_pushes_total = 0
        self.rounds_received_total = 0
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(target=self._loop.run_forever,
                                             name="ftc-rollout-plane", daemon=True)
        self._loop_thread.start()

    # ---- plumbing ---------------------------------------------------------

    def _run(self, coro, timeout: float | None = None):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(
            timeout or self._rpc_timeout_s)

    def start(self) -> "RolloutPlane":
        """Spawn every worker (together), then start a puller for each."""
        async def spawn_all():
            return await asyncio.gather(
                *(self._spawn(ws) for ws in self._workers), return_exceptions=True)

        spawned = self._run(spawn_all())
        failed = [r for r in spawned if isinstance(r, BaseException)]
        if failed:
            for ws in self._workers:
                if ws.handle is not None:
                    self._close_handle(ws)
            self._shutdown_loop()
            raise failed[0]
        for ws in self._workers:
            self._begin(ws)
            t = threading.Thread(target=self._pull_loop, args=(ws,),
                                 name=f"ftc-pull-{ws.worker_id}", daemon=True)
            with self._lock:
                self._threads.append(t)
            t.start()
        return self

    async def _spawn(self, ws: _WorkerState) -> None:
        ws.generation += 1
        ws.handle = await self._spawn_fn(ws.worker_id, ws.generation)
        ws.cursor = 0  # a fresh incarnation has a fresh outbox sequence

    def _begin(self, ws: _WorkerState) -> None:
        """The cached policy first, then the stream: a respawned worker's
        first round already decodes with the newest pushed policy."""
        if self._policy is not None:
            version, blob = self._policy
            self._run(ws.handle.rollout_policy_version(version, blob))
        self._run(ws.handle.rollout_start(self.pairs_per_round))
        ws.alive = True

    def _bring_up(self, ws: _WorkerState) -> None:
        self._run(self._spawn(ws))
        self._begin(ws)

    def _close_handle(self, ws: _WorkerState) -> None:
        try:
            self._run(ws.handle.close(), timeout=30.0)
        # best-effort teardown of a worker that may already be dead
        except Exception:
            logger.debug("close of %s raced its exit", ws.worker_id, exc_info=True)

    # ---- the pull loop (one thread per worker) ----------------------------

    def _pull_loop(self, ws: _WorkerState) -> None:
        delay: float | None = None
        while not self._stop.is_set():
            try:
                out = self._run(ws.handle.rollout_pull(ws.cursor, self._pull_max_rounds))
            # every failure funnels into the respawn below
            except Exception as exc:
                if self._stop.is_set():
                    return
                ws.alive = False
                delay = self._retry.next_delay(delay)
                logger.warning("rollout worker %s lost (%s: %s); respawning in %.2fs",
                               ws.worker_id, type(exc).__name__, exc, delay)
                if self._stop.wait(delay):
                    return
                if ws.handle is not None:
                    self._close_handle(ws)  # reap the corpse
                try:
                    self._bring_up(ws)
                    with self._lock:
                        self.respawns_total += 1
                # a failed respawn loops back into the backoff above
                except Exception as exc2:
                    logger.warning("respawn of %s failed: %s", ws.worker_id, exc2)
                continue
            delay = None
            ws.last_stats = out.get("stats") or ws.last_stats
            rounds = out.get("rounds") or []
            if not rounds:
                self._stop.wait(self._idle_sleep_s)
                continue
            acked = ws.cursor
            for doc in rounds:
                self._ingest(ws, doc)
                acked = max(acked, int(doc["seq"]))
            ws.cursor = acked
            try:
                self._run(ws.handle.rollout_ack(acked))
            # a lost ack only re-delivers rounds the dedup already holds
            except Exception:
                logger.debug("ack to %s failed", ws.worker_id, exc_info=True)

    def _ingest(self, ws: _WorkerState, doc: dict) -> None:
        fresh = 0
        with self._lock:
            for pd in doc.get("pairs") or []:
                key = (ws.worker_id, str(pd["id"]))
                if key in self._seen:
                    self.dup_pairs_total += 1
                    continue
                self._seen[key] = None
                while len(self._seen) > self._dedup_capacity:
                    self._seen.popitem(last=False)
                self.buffer.push(_pair_from_doc(pd))
                fresh += 1
            self.rounds_received_total += 1
        span = doc.get("span") or {}
        if self._spans is not None and span.get("start_ns"):
            # stamped by the worker, recorded here: both processes read the
            # same host clock, so the intervals compare with the learner's
            self._spans.record("rollout.round", start_ns=span["start_ns"],
                               end_ns=span["end_ns"], worker=ws.worker_id,
                               seq=int(doc.get("seq", 0)),
                               policy_version=int(doc.get("version", 0)), pairs=fresh)

    # ---- learner-facing surface ------------------------------------------

    def push_policy(self, version: int, lora_tree: dict) -> None:
        """Ship the committed adapter to every live worker; cached, so a
        respawn gets the newest policy before its stream starts."""
        from ..transport.wire import tree_to_blob

        blob = tree_to_blob(lora_tree)
        self._policy = (int(version), blob)
        for ws in self._workers:
            if not ws.alive:
                continue
            try:
                self._run(ws.handle.rollout_policy_version(int(version), blob))
                with self._lock:
                    self.policy_pushes_total += 1
            # the puller sees the death, and the respawn re-pushes the cache
            except Exception as exc:
                logger.warning("policy push v%d to %s failed: %s", version, ws.worker_id, exc)

    def depth(self) -> int:
        with self._lock:
            return self.buffer.depth

    def evict_below(self, min_version: int, *, watermark: int) -> int:
        with self._lock:
            return self.buffer.evict_below(min_version, watermark=watermark)

    def sample_batch(self, batch_size: int, seq_len: int) -> dict:
        with self._lock:
            return self.buffer.sample_batch(batch_size, seq_len)

    def workers_alive(self) -> int:
        return sum(1 for ws in self._workers if ws.alive)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            out: dict[str, Any] = dict(self.buffer.stats())
            counters = {
                "rollout_respawns_total": self.respawns_total,
                "rollout_dup_pairs_total": self.dup_pairs_total,
                "rollout_policy_pushes_total": self.policy_pushes_total,
                "rollout_rounds_received_total": self.rounds_received_total,
            }
        stats = [ws.last_stats for ws in self._workers]
        out.update({
            "actor_tokens_per_sec": max(
                (float(s.get("actor_tokens_per_sec", 0.0)) for s in stats), default=0.0),
            "actor_version": max((int(s.get("actor_version", 0)) for s in stats), default=0),
            "rollout_workers_alive": self.workers_alive(),
            "rollout_actor_tokens_generated": sum(
                int(s.get("actor_tokens_generated", 0)) for s in stats),
            "rollout_actor_generate_seconds": sum(
                float(s.get("actor_generate_seconds", 0.0)) for s in stats),
            **counters,
        })
        return out

    def _shutdown_loop(self) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._loop_thread.join(timeout=5.0)

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=15.0)
        for ws in self._workers:
            ws.alive = False
            if ws.handle is not None:
                self._close_handle(ws)
        self._shutdown_loop()


def remote_rollout_batch_stream(
    plane: RolloutPlane,
    ckpt_reader,
    state_template: dict,
    *,
    batch_size: int,
    seq_len: int,
    checkpoint_every: int,
    rollout: RolloutConfig,
    fill_timeout_s: float = 180.0,
) -> Iterator[dict]:
    """The learner's batch source in remote mode.  ``next()`` never runs an
    actor (the workers generate continuously), so learner steps and rollout
    rounds overlap in time.  Each ``next()``:

    1. ships a newly COMMITTED checkpoint's adapter to the fleet
       (``latest_step`` reports durable steps only, so asynchronous commits
       are safe);
    2. enforces the staleness watermark on the buffer;
    3. waits (bounded) for ``min_fill`` pairs, then samples a batch."""
    pushed = 0
    while True:
        latest = ckpt_reader.latest_step()
        if latest is not None and latest > pushed:
            host = ckpt_reader.restore(latest, like=state_template)
            plane.push_policy(latest, {k: v for k, v in host["trainable"].items()
                                       if k.endswith(_LORA_LEAVES)})
            pushed = latest
        min_version = pushed - rollout.staleness_checkpoints * checkpoint_every
        plane.evict_below(min_version, watermark=pushed)
        deadline = time.monotonic() + fill_timeout_s
        while plane.depth() < rollout.min_fill:
            if time.monotonic() > deadline:
                if plane.depth() > 0:
                    break  # train on what the buffer holds; workers are behind
                raise RuntimeError(
                    f"no rollout pairs arrived within {fill_timeout_s:.0f}s "
                    f"({plane.workers_alive()} workers alive) — remote "
                    "actors wedged or respawn-looping"
                )
            time.sleep(0.01)
        yield plane.sample_batch(batch_size, seq_len)


def build_remote_rlhf_loop(
    trainer,
    artifacts_dir: str,
    *,
    rollout: RolloutConfig | None = None,
    pretrained_dir: str | None = None,
    prompt_fraction: float = 0.5,
    model_spec: dict | None = None,
    spawn_fn=None,
) -> tuple[Iterator[dict], RolloutPlane, RolloutBuffer]:
    """Remote actors, the plane and the buffer on a DPO learner: the
    disaggregated twin of :func:`~.learner.build_rlhf_loop`.

    ``pretrained_dir`` is loaded into the learner's base here, before the
    base is written for the workers (``fit`` need not load it again).
    ``model_spec`` is the job spec's ``model`` section; workers rebuild the
    policy's architecture from it, so it is required unless ``spawn_fn`` is
    given.  Workers run on the learner's device."""
    from ..obs.trace import SpanRecorder, new_trace_id
    from ..train.checkpoint import CheckpointManager

    rollout = (rollout or RolloutConfig()).apply_env_overrides()
    cfg = trainer.cfg
    num_workers = max(1, int(cfg.rollout_workers))
    if pretrained_dir:
        trainer.load_pretrained(pretrained_dir)
    if spawn_fn is None and model_spec is None:
        raise ValueError(
            "build_remote_rlhf_loop needs the job's model spec (preset/"
            "overrides/lora) so workers can rebuild the policy architecture"
        )
    base = {k: v for k, v in trainer.model.state_dict().items()
            if not k.endswith(_LORA_LEAVES)}
    t0 = time.perf_counter()
    path = write_rollout_base(artifacts_dir, model_spec or {}, base, trainer.model_cfg)
    logger.info("rollout base written in %.1f s (%.2f GB)", time.perf_counter() - t0,
                os.path.getsize(os.path.join(path, "params.msgpack")) / 1e9)
    del base
    # a reader (no sweep), made before fit's first save as the reference
    # requires of its own reader
    reader = CheckpointManager(f"{artifacts_dir}/checkpoints", keep=10**9, sweep=False)
    state_template = trainer._state_tree()
    buffer = RolloutBuffer(rollout.buffer_capacity, seed=cfg.seed,
                           version_granularity=max(1, cfg.checkpoint_every))
    prompt_len = max(2, int(cfg.seq_len * prompt_fraction))
    if spawn_fn is None:
        from ..serve.engine import EngineConfig
        from ..transport.process import ProcessTransport

        transport = ProcessTransport(
            job_id=os.path.basename(os.path.normpath(artifacts_dir)) or "rlhf",
            root=Path(artifacts_dir) / "rollout_workers",
            payload={"builder": "rollout_base",
                     "kwargs": {"dir": artifacts_dir, "device": str(trainer.device)}},
        )
        bucket = 8
        while bucket < prompt_len:
            bucket <<= 1
        engine_cfg = EngineConfig(
            slots=rollout.slots, prompt_buckets=(bucket,),
            max_new_tokens=min(rollout.max_new_tokens, cfg.seq_len - prompt_len),
            prefix_cache_bytes=0,
        )

        async def spawn_fn(worker_id: str, generation: int):
            index = int(worker_id.rsplit("-", 1)[-1])
            rdoc: dict[str, Any] = {
                "seq_len": cfg.seq_len,
                "prompt_fraction": prompt_fraction,
                "max_new_tokens": rollout.max_new_tokens,
                "temperature": rollout.temperature,
                "top_k": rollout.top_k,
                "slots": rollout.slots,
                # stable across respawns (never generation-dependent): a
                # replay regenerates its original and dedups against it
                "seed": cfg.seed + index,
            }
            if rollout.reward_port:
                rdoc["reward_host"] = rollout.reward_host or "127.0.0.1"
                rdoc["reward_port"] = rollout.reward_port
            return await transport.spawn(worker_id, generation, engine_config=engine_cfg,
                                         batcher_kwargs={}, warm_start=True, rollout=rdoc)

    obs_on = cfg.trace and os.environ.get("FTC_TRACE", "1").strip().lower() not in (
        "0", "false", "no", "off")
    spans = SpanRecorder(artifacts_dir, os.environ.get("FTC_TRACE_ID", "") or new_trace_id(),
                         service="rollout",
                         attempt=int(os.environ.get("FTC_ATTEMPT", "1") or 1), enabled=obs_on)
    plane = RolloutPlane(
        buffer, num_workers=num_workers, spawn_fn=spawn_fn,
        pairs_per_round=rollout.pairs_per_round, span_recorder=spans,
        retry=RetryPolicy(max_attempts=10**9, base_delay_s=0.2, max_delay_s=10.0,
                          seed=cfg.seed),
    )
    plane.start()
    stream = remote_rollout_batch_stream(
        plane, reader, state_template, batch_size=cfg.batch_size, seq_len=cfg.seq_len,
        checkpoint_every=cfg.checkpoint_every, rollout=rollout)
    trainer.rollout_stats_fn = plane.stats
    return stream, plane, buffer
