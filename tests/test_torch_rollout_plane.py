"""The port's disaggregated rollout plane against the JAX package's, on the
CPU at the ``tiny-test`` preset.

* pair documents: the port's JSON bytes are the reference's, and a round
  document crosses either package's wire into the other unchanged;
* ``RolloutService`` at ``temperature=0`` against the JAX service on the same
  f32 weights: the same round documents (ids, tokens, rewards, versions)
  before and after a policy push built from the same LoRA arrays (the push
  lands while both producers are parked on a full outbox, so both install it
  before round 3); the protocol's idempotence, backpressure and a dead
  producer, on a fake actor as in the reference's tests;
* ``RewardScorer`` within rel 1e-5 (f32, max |diff| over max |score|) of
  the JAX scorer on the same trunk and head; ``from_artifacts`` on a
  JAX-written ``reward_head.msgpack`` (equal head) and on a reward job's
  checkpoint (the exported head, bit for bit);
* ``write_rollout_base``: the file is flax's bytes for the same tree, also
  with chunked arrays (flax's and the coder's 1 GiB limit lowered for the
  test), and both packages' ``rollout_base`` readers give back the base
  bit for bit;
* the plane on fake worker handles: respawn with deduplicated replays, the
  cached policy re-pushed before a respawned worker starts, and two
  workers whose pair ids coincide: the reference drops 12 of their 24
  pairs, the port none (its seen-set is keyed by worker);
* ``remote_rollout_batch_stream``: a committed checkpoint's adapter is
  pushed and the staleness watermark evicts older pairs;
* the worker's rollout and reward ops over a loopback socket, in process;
* the DPO trainer keeps prefetch and asynchronous commits in remote mode;
* a promoted reward job served with ``serve_transport=process`` gets reward
  workers that answer ``reward_score`` with the in-process scorer's scores;
* one real run: ``train.cli.main`` with ``rollout_workers: 1`` scoring with
  a reward worker process; the rollout worker is SIGKILLed after its first
  round, respawns, and no (worker, pair id) enters the buffer twice.

Every wait has a deadline, every spawned process is killed in a
``finally``, and every server closes its writers before ``wait_closed()``.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import signal
import threading
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from finetune_controller_tpu.models.llama import PRESETS as JAX_PRESETS
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
from finetune_controller_tpu.prefs import actor as jax_actor
from finetune_controller_tpu.prefs import rollout_plane as jax_rp
from finetune_controller_tpu.prefs.dpo_trainer import DPOTrainer as JaxDPOTrainer
from finetune_controller_tpu.prefs.rollout_buffer import PreferencePair as JaxPair
from finetune_controller_tpu.prefs.rollout_buffer import RolloutBuffer as JaxBuffer
from finetune_controller_tpu.resilience.policy import RetryPolicy as JaxRetryPolicy
from finetune_controller_tpu.train.trainer import TrainConfig as JaxTrainConfig
from finetune_controller_tpu.transport import wire as ref_wire
from finetune_controller_tpu.transport.builders import rollout_base as jax_rollout_base
from finetune_controller_tpu_torch.models.convert import from_flax, to_flax
from finetune_controller_tpu_torch.models.llama import PRESETS
from finetune_controller_tpu_torch.models.lora import LoRAConfig
from finetune_controller_tpu_torch.prefs import actor
from finetune_controller_tpu_torch.prefs import rollout_plane as rp
from finetune_controller_tpu_torch.prefs.dpo_trainer import DPOTrainer
from finetune_controller_tpu_torch.prefs.learner import RolloutConfig
from finetune_controller_tpu_torch.prefs.reward_trainer import read_reward_head
from finetune_controller_tpu_torch.prefs.rollout_buffer import PreferencePair, RolloutBuffer
from finetune_controller_tpu_torch.resilience.policy import RetryPolicy
from finetune_controller_tpu_torch.serve.engine import EngineConfig
from finetune_controller_tpu_torch.serve.fleet import ReplicaFleet
from finetune_controller_tpu_torch.train import cli
from finetune_controller_tpu_torch.train.checkpoint import CheckpointManager
from finetune_controller_tpu_torch.train.trainer import TrainConfig
from finetune_controller_tpu_torch.transport import wire
from finetune_controller_tpu_torch.transport.builders import rollout_base, tiny_test
from finetune_controller_tpu_torch.transport.client import RemoteReplica, _Connection
from finetune_controller_tpu_torch.transport.process import ProcessTransport
from finetune_controller_tpu_torch.transport.worker import WorkerSpec, build_worker
from finetune_controller_tpu_torch.utils import flax_msgpack

torch.set_num_threads(1)

SEQ, VOCAB = 16, 256
#: the scorer's parity bound: max |port - JAX| over max |JAX| in f32
SCORE_REL_TOL = 1e-5
#: the bound on each socket or process await (a spawn is ~5 s here)
AWAIT_S = 120.0
TINY = {"device": "cpu", "dtype": "float32", "seed": 0}
TINY_SPEC = {"preset": "tiny-test", "lora": {"rank": 4, "alpha": 8.0},
             "overrides": {"dtype": "float32"}}


def _wait(cond, timeout=30.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def run(coro, timeout_s: float = 300.0):
    return asyncio.run(asyncio.wait_for(coro, timeout_s))


def bounded(aw, timeout_s: float = AWAIT_S):
    return asyncio.wait_for(aw, timeout_s)


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(0.1 + 0.3 * rng.standard_normal(x.shape), np.float32), tree)


def _oracle(p, n):
    return [(p[-1] + 1 + i) % VOCAB for i in range(n)]


# ---------------------------------------------------------------------------
# pair documents
# ---------------------------------------------------------------------------


def test_pair_docs_equal_the_reference():
    kw = dict(prompt=(1, 2), chosen=(1, 2, 3), rejected=(1, 2, 4), version=5,
              reward_chosen=1.5, reward_rejected=-0.25)
    assert rp.pair_id(5, 2, 0) == jax_rp.pair_id(5, 2, 0) == "v5:r2:p0"
    got = rp._pair_doc(PreferencePair(**kw), rp.pair_id(5, 2, 0))
    want = jax_rp._pair_doc(JaxPair(**kw), jax_rp.pair_id(5, 2, 0))
    assert json.dumps(got).encode() == json.dumps(want).encode()
    assert rp._pair_from_doc(want) == PreferencePair(**kw)
    assert jax_rp._pair_from_doc(got) == JaxPair(**kw)
    doc = {"seq": 3, "round": 3, "version": 5, "pairs": [got],
           "span": {"start_ns": 10**18, "end_ns": 10**18 + 5, "pairs": 1, "tokens": 9}}
    assert ref_wire.loads(wire.dumps(doc)) == doc
    assert wire.loads(ref_wire.dumps(doc)) == doc


# ---------------------------------------------------------------------------
# RolloutService against the JAX service (temperature 0, same weights)
# ---------------------------------------------------------------------------


def _harvest(service, blob, version=5):
    """Rounds 1-2 at the start policy, a push while the producer is parked
    on its full outbox (max 2 rounds), then rounds 3-4."""
    try:
        assert service.start(4)["started"]
        assert _wait(lambda: len(service.pull(0)["rounds"]) == 2)
        first = service.pull(0)["rounds"]
        out = service.push_policy(version, blob)
        assert out["accepted"]
        assert _wait(lambda: service.actor.version == version)
        assert not service.push_policy(version, blob)["accepted"]  # idempotent
        assert not service.push_policy(version - 1, blob)["accepted"]  # monotonic
        service.ack(2)
        assert _wait(lambda: len(service.pull(2)["rounds"]) == 2)
        return first + service.pull(2)["rounds"], service.stats()
    finally:
        service.stop()


@pytest.fixture(scope="module")
def services():
    kw = dict(task="rlhf", batch_size=2, seq_len=SEQ, total_steps=2, prefetch=0)
    jcfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32, lora=JaxLoRAConfig(rank=4))
    jtrainer = JaxDPOTrainer(jcfg, JaxTrainConfig(**kw))
    state = jtrainer.init_state()
    frozen = _noisy(jax.device_get(state.frozen), 31)
    lora = _noisy(jax.device_get(state.trainable), 32)
    settings = dict(prompt_bucket=8, max_new_tokens=6, temperature=0.0, slots=2, seed=3)
    jact = jax_actor.RolloutActor(
        jtrainer.model, frozen["params"], None,
        reward_fn=lambda p, c: jax_actor.increment_reward(p, c, VOCAB),
        prompts=jax_actor.increment_prompts(SEQ, VOCAB, 7919), oracle_fn=_oracle, **settings)
    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32, lora=LoRAConfig(rank=4))
    trainer = DPOTrainer(cfg, TrainConfig(**kw), device="cpu")
    zero = jax.tree_util.tree_map(np.zeros_like, lora)
    trainer.model.load_state_dict(from_flax({**frozen, "lora": zero}, cfg))
    pact = actor.RolloutActor(
        trainer.model, None,
        reward_fn=lambda p, c: actor.increment_reward(p, c, VOCAB),
        prompts=actor.increment_prompts(SEQ, VOCAB, 7919), oracle_fn=_oracle, **settings)
    adapter = {k: v for k, v in from_flax({**frozen, "lora": lora}, cfg).items()
               if k.endswith((".lora_a", ".lora_b"))}
    want, _ = _harvest(jax_rp.RolloutService(jact, max_outbox_rounds=2),
                       ref_wire.tree_to_blob(lora))
    got, stats = _harvest(rp.RolloutService(pact, max_outbox_rounds=2),
                          wire.tree_to_blob(adapter))
    return {"jax": want, "port": got, "stats": stats}


def test_service_rounds_equal_the_reference_across_a_push(services):
    got, want = services["port"], services["jax"]
    assert [r["seq"] for r in got] == [r["seq"] for r in want] == [1, 2, 3, 4]
    assert [r["version"] for r in got] == [r["version"] for r in want] == [0, 0, 5, 5]
    for g, w in zip(got, want):
        assert g["round"] == w["round"]
        assert g["pairs"] == w["pairs"]  # ids, tokens, versions, rewards
    # the push changed the policy's tokens
    assert [p["rejected"] for p in got[1]["pairs"]] != [p["rejected"] for p in got[2]["pairs"]]
    stats = services["stats"]
    assert stats["rollout_policy_installs_total"] == 1 and stats["actor_version"] == 5
    assert stats["rollout_rounds_total"] >= 4


class _FakeActor:
    """Deterministic per (seed, version, round), without an engine (the
    reference test's fake)."""

    def __init__(self, seed=0, fail_after=None):
        self.seed, self.version, self.rounds = seed, 0, 0
        self.pairs_generated = self.tokens_generated = self.bootstrap_pairs = 0
        self.generate_seconds = 0.0
        self.installs: list = []
        self._fail_after = fail_after

    @property
    def tokens_per_sec(self):
        return self.tokens_generated / max(self.generate_seconds, 1e-9)

    def install_policy(self, version, tree):
        if int(version) <= self.version:
            return False
        self.version = int(version)
        self.installs.append((self.version, tree))
        return True

    def generate_pairs(self, n):
        if self._fail_after is not None and self.rounds >= self._fail_after:
            raise RuntimeError("synthetic actor fault")
        self.rounds += 1
        out = []
        for i in range(n):
            base = (self.seed * 811 + self.version * 97 + self.rounds * 13 + i) % 23
            prompt = (base % 7 + 1, (base + 1) % 7 + 1)
            out.append(PreferencePair(prompt=prompt, chosen=prompt + ((base + 2) % 7 + 1,),
                                      rejected=prompt + ((base + 3) % 7 + 1,),
                                      version=self.version, reward_chosen=1.0,
                                      reward_rejected=0.0))
        self.pairs_generated += n
        self.tokens_generated += 2 * n
        self.generate_seconds += 1e-4
        return out


def test_service_start_is_idempotent_and_pull_replays_identically():
    svc = rp.RolloutService(_FakeActor(seed=1), max_outbox_rounds=4)
    try:
        assert svc.start(2)["started"] and svc.start(2)["started"]
        assert _wait(lambda: len(svc.pull(0)["rounds"]) >= 2)
        first, again = svc.pull(0, max_rounds=2), svc.pull(0, max_rounds=2)
        assert first["rounds"] == again["rounds"]
        ids = [p["id"] for r in first["rounds"] for p in r["pairs"]]
        assert len(ids) == len(set(ids))
        assert all(r["span"]["end_ns"] >= r["span"]["start_ns"] for r in first["rounds"])
    finally:
        svc.stop()


def test_service_ack_trims_and_backpressures_the_producer():
    svc = rp.RolloutService(_FakeActor(), max_outbox_rounds=3)
    try:
        svc.start(1)
        assert _wait(lambda: len(svc.pull(0)["rounds"]) == 3)
        time.sleep(0.05)
        out = svc.pull(0)
        assert len(out["rounds"]) == 3  # bounded: no 4th round
        top = out["rounds"][-1]["seq"]
        acked = svc.ack(out["rounds"][0]["seq"])
        assert acked == {"acked": 1, "outbox_depth": 2}
        assert svc.ack(0)["acked"] == 0  # a stale ack is a no-op
        assert _wait(lambda: svc.pull(top)["rounds"])  # the ack woke the producer
    finally:
        svc.stop()


def test_service_producer_death_surfaces_on_pull():
    svc = rp.RolloutService(_FakeActor(fail_after=2), max_outbox_rounds=64)
    try:
        svc.start(1)

        def died():
            try:
                svc.pull(0)
                return False
            except RuntimeError:
                return True

        assert _wait(died)
        with pytest.raises(RuntimeError, match="synthetic actor fault"):
            svc.pull(0)
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# RewardScorer
# ---------------------------------------------------------------------------

ITEMS = [{"prompt": [1, 2, 3], "completion": [4, 5]},
         {"prompt": [2, 2], "completion": [6, 1, 3]},
         {"prompt": [5], "completion": [7]}]


@pytest.fixture(scope="module")
def trunks():
    """The JAX ``tiny-test`` (f32, seeded noise) and the port's model on
    the same weights, and a seeded head."""
    from finetune_controller_tpu.models.llama import LlamaForCausalLM as JaxLlama

    jcfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32)
    shapes = jax.eval_shape(JaxLlama(jcfg).init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 4), jnp.int32))
    params = _noisy(shapes, 17)["params"]
    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32)
    model = tiny_test(**TINY)
    model.load_state_dict(from_flax({"params": params}, cfg))
    rng = np.random.default_rng(5)
    head = {"a": np.float32(0.7), "w": (0.05 * rng.standard_normal(VOCAB)).astype(np.float32),
            "b": np.float32(-0.3)}
    return JaxLlama(jcfg), params, model, head


def test_reward_scorer_matches_the_jax_scorer(trunks, monkeypatch):
    jmodel, params, model, head = trunks
    want = np.asarray(jax_rp.RewardScorer(jmodel, {"params": params}, head).score(ITEMS))
    scorer = rp.RewardScorer(model, head)
    got = np.asarray(scorer.score(ITEMS))
    assert np.abs(got - want).max() / np.abs(want).max() <= SCORE_REL_TOL
    assert scorer.scored_total == 3 and scorer.shapes == {(4, 8)}
    scorer.score(ITEMS[:1])
    assert scorer.shapes == {(4, 8), (1, 8)}  # rows and length in powers of two
    assert scorer.score([]) == []
    # under a logits budget of one row the rows are scored one at a time
    monkeypatch.setattr(rp.RewardScorer, "MAX_LOGITS_BYTES", 8 * VOCAB * 4)
    chunked = np.asarray(rp.RewardScorer(model, head).score(ITEMS))
    assert np.abs(chunked - want).max() / np.abs(want).max() <= SCORE_REL_TOL


@pytest.fixture(scope="module")
def reward_job(tmp_path_factory):
    """A tiny reward job through the port's CLI (2 steps, one checkpoint)."""
    art = tmp_path_factory.mktemp("reward") / "artifacts"
    spec = {"job_id": "rw", "artifacts_dir": str(art), "model": TINY_SPEC,
            "training": {"task": "reward", "total_steps": 2, "batch_size": 4, "seq_len": SEQ,
                         "log_every": 1, "checkpoint_every": 2, "learning_rate": 5e-3,
                         "warmup_steps": 1, "heartbeat_interval_s": 0},
            "dataset": {"synthetic": {"task": "preference"}}}
    cli.run_job(spec, "cpu")
    return art


def test_reward_scorer_from_artifacts(trunks, reward_job, tmp_path):
    _, _, model, head = trunks
    with open(tmp_path / "reward_head.msgpack", "wb") as f:
        f.write(serialization.msgpack_serialize(head))  # the JAX package's writer
    scorer = rp.RewardScorer.from_artifacts(str(tmp_path), model)
    for k, v in head.items():
        assert torch.equal(scorer._head[k], torch.as_tensor(v))
    # a staged prefix holds no exported head: the checkpoint's is read
    staged = tmp_path / "staged"
    shutil.copytree(reward_job / "checkpoints", staged / "checkpoints")
    exported = read_reward_head(str(reward_job))
    from_ckpt = rp.RewardScorer.from_artifacts(str(staged), model)
    assert set(from_ckpt._head) == {"a", "w", "b"}
    for k, v in exported.items():
        assert torch.equal(from_ckpt._head[k], v)
    with pytest.raises(FileNotFoundError, match="task: reward"):
        rp.RewardScorer.from_artifacts(str(tmp_path / "nope"), model)
    assert not (tmp_path / "nope").exists()
    plain = tmp_path / "sft" / "checkpoints"
    CheckpointManager(plain).save(2, {"step": 2, "trainable": {"x.lora_a": torch.zeros(2, 2)},
                                      "opt_state": {}}, blocking=True)
    with pytest.raises(ValueError, match="carries no reward head"):
        rp.RewardScorer.from_artifacts(str(tmp_path / "sft"), model)


# ---------------------------------------------------------------------------
# write_rollout_base
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,chunked", [("float32", False), ("bfloat16", True)])
def test_write_rollout_base_reads_back_in_both_packages(dtype, chunked, tmp_path, monkeypatch):
    model = tiny_test(device="cpu", dtype=dtype, seed=4)
    base = model.state_dict()
    spec = {"preset": "tiny-test", "lora": {"rank": 4}, "overrides": {"dtype": dtype}}
    if chunked:  # arrays above 4 KiB go in chunks, in both writers
        monkeypatch.setattr(flax_msgpack, "MAX_ARRAY_BYTES", 4096)
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    path = rp.write_rollout_base(str(tmp_path), spec, base)
    cfg = cli.build_model_config({"model": spec})
    tree = to_flax(base, cfg)["params"]
    data = (Path(path) / "params.msgpack").read_bytes()
    assert data == serialization.msgpack_serialize(tree)
    assert json.loads((Path(path) / "model.json").read_text()) == spec
    _, variables = jax_rollout_base(str(tmp_path))
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    assert len(flat_got) == len(flat_want)
    for key, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[key]).view(np.uint8),
                                      np.asarray(leaf).view(np.uint8))
    rebuilt = rollout_base(str(tmp_path), device="cpu").state_dict()
    assert set(rebuilt) == set(base)
    for k, v in base.items():
        assert torch.equal(rebuilt[k], v), k


# ---------------------------------------------------------------------------
# the plane on fake worker handles
# ---------------------------------------------------------------------------


class _FakeBackend:
    """One worker's deterministic round source, shared by its incarnations:
    each incarnation regenerates the SAME rounds from seq 1."""

    def __init__(self, seed, *, pairs_per_round=2, total_rounds=6, die_on_incarnation=None,
                 die_after_pulls=2):
        self.seed, self.pairs_per_round, self.total_rounds = seed, pairs_per_round, total_rounds
        self.die_on_incarnation, self.die_after_pulls = die_on_incarnation, die_after_pulls
        self.version = 0
        self.events: list[tuple] = []

    def make_round(self, seq):
        """Round ``seq``: each pair's prompt is (seed, seq, i + 1), so pairs
        are distinct across workers, rounds and positions by construction
        (and the same for every incarnation of this worker)."""
        pairs = []
        for i in range(self.pairs_per_round):
            prompt = [self.seed, seq, i + 1]
            pairs.append({"id": rp.pair_id(self.version, seq, i), "prompt": prompt,
                          "chosen": prompt + [1], "rejected": prompt + [2],
                          "version": self.version, "reward_chosen": 1.0,
                          "reward_rejected": 0.0})
        return {"seq": seq, "round": seq, "version": self.version, "pairs": pairs,
                "span": {"start_ns": seq * 1000, "end_ns": seq * 1000 + 500,
                         "pairs": len(pairs), "tokens": 2 * len(pairs)}}


class _FakeHandle:
    def __init__(self, backend: _FakeBackend, generation: int):
        self.backend, self.generation = backend, generation
        self.produced = self.pulls = 0
        self.closed = False

    async def rollout_start(self, pairs_per_round):
        self.backend.events.append(("start", self.generation))
        return {"started": True, "seq": 0, "version": self.backend.version}

    async def rollout_policy_version(self, version, blob):
        self.backend.events.append(("policy", self.generation, int(version)))
        accepted = int(version) > self.backend.version
        if accepted:
            self.backend.version = int(version)
        return {"accepted": accepted, "version": self.backend.version, "pending": False}

    async def rollout_pull(self, after_seq, max_rounds=8):
        if self.closed:
            raise ConnectionError("handle closed")
        self.pulls += 1
        b = self.backend
        if b.die_on_incarnation == self.generation and self.pulls > b.die_after_pulls:
            raise ConnectionError("worker killed")
        self.produced = min(b.total_rounds, self.produced + 1)
        rounds = [b.make_round(s) for s in range(int(after_seq) + 1, self.produced + 1)]
        return {"rounds": rounds[:max_rounds], "seq": self.produced, "version": b.version,
                "stats": {"actor_tokens_per_sec": 42.0, "actor_version": b.version,
                          "actor_tokens_generated": 2 * self.produced,
                          "actor_generate_seconds": 0.01 * self.produced}}

    async def rollout_ack(self, up_to_seq):
        return {"acked": 0, "outbox_depth": 0}

    async def close(self, exc=None):
        self.closed = True


def _mk_plane(plane_cls, retry_cls, buffer, backends):
    handles = []

    async def spawn_fn(worker_id, generation):
        h = _FakeHandle(backends[worker_id], generation)
        handles.append(h)
        return h

    plane = plane_cls(buffer, num_workers=len(backends), spawn_fn=spawn_fn, pairs_per_round=2,
                      retry=retry_cls(max_attempts=10**9, base_delay_s=0.01, max_delay_s=0.05,
                                      seed=0),
                      idle_sleep_s=0.005)
    return plane, handles


def test_plane_respawns_dead_worker_and_dedups_regenerated_pairs():
    backend = _FakeBackend(seed=5, total_rounds=6, die_on_incarnation=1, die_after_pulls=3)
    buffer = RolloutBuffer(256)
    plane, handles = _mk_plane(rp.RolloutPlane, RetryPolicy, buffer, {"rollout-0": backend})
    try:
        plane.start()
        assert _wait(lambda: plane.respawns_total >= 1, timeout=20)
        assert _wait(lambda: buffer.pushed_total == 12 and plane.dup_pairs_total >= 2,
                     timeout=20)
        time.sleep(0.05)
        assert buffer.pushed_total == 12  # every replay suppressed
        assert handles[0].generation == 1 and handles[-1].generation >= 2
        assert plane.workers_alive() == 1
        st = plane.stats()
        assert st["rollout_respawns_total"] >= 1
        assert st["rollout_dup_pairs_total"] == plane.dup_pairs_total
        assert st["actor_tokens_per_sec"] == 42.0
    finally:
        plane.close()
    assert all(h.closed for h in handles)


def test_plane_repushes_cached_policy_to_respawned_worker_before_start():
    backend = _FakeBackend(seed=2, total_rounds=4, die_on_incarnation=1, die_after_pulls=2)
    buffer = RolloutBuffer(256)
    plane, _ = _mk_plane(rp.RolloutPlane, RetryPolicy, buffer, {"rollout-0": backend})
    try:
        plane.start()
        assert _wait(lambda: buffer.pushed_total > 0, timeout=20)
        plane.push_policy(7, {"w.lora_a": np.ones((2,), np.float32)})
        assert _wait(lambda: plane.respawns_total >= 1, timeout=20)
        assert _wait(lambda: ("policy", 2, 7) in backend.events, timeout=20)
        gen2 = [e for e in backend.events if e[1] == 2]
        assert gen2.index(("policy", 2, 7)) < gen2.index(("start", 2))
        assert plane._policy is not None and plane._policy[0] == 7
    finally:
        plane.close()


def test_two_workers_reference_drops_half_the_port_none():
    """Two workers seeded apart emit different pairs under the same ids
    (``v0:r{seq}:p{i}``): the reference's seen-set, keyed by the id alone,
    drops the second worker's 12 of the 24; the port's, keyed by (worker,
    id), drops none.  Every pair is distinct by construction, so the buffers
    hold 12 and 24 distinct pairs, whichever worker's pair arrives first."""
    out = {}
    for name, plane_cls, retry_cls, buffer_cls in (
            ("reference", jax_rp.RolloutPlane, JaxRetryPolicy, JaxBuffer),
            ("port", rp.RolloutPlane, RetryPolicy, RolloutBuffer)):
        backends = {"rollout-0": _FakeBackend(seed=5), "rollout-1": _FakeBackend(seed=9)}
        buffer = buffer_cls(256)
        plane, _ = _mk_plane(plane_cls, retry_cls, buffer, backends)
        try:
            plane.start()
            assert _wait(lambda: plane.rounds_received_total >= 12, timeout=20)
            time.sleep(0.05)
            out[name] = (buffer.pushed_total, plane.dup_pairs_total,
                         len({(p.prompt, p.chosen, p.rejected) for p in buffer._pairs}))
        finally:
            plane.close()
    assert out["reference"][:2] == (12, 12)
    assert out["port"][:2] == (24, 0)
    assert out["reference"][2] == 12 and out["port"][2] == 24


def test_remote_stream_ships_committed_checkpoints_and_evicts_stale():
    class _FakeReader:
        step = None

        def latest_step(self):
            return self.step

        def restore(self, step, like=None):
            assert like is not None  # the shape-checked restore
            return {"trainable": {"l.lora_a": np.full((2,), float(step), np.float32),
                                  "head.w": np.zeros((3,), np.float32)}}

    backend = _FakeBackend(seed=9, total_rounds=10**9)
    buffer = RolloutBuffer(256, version_granularity=1)
    plane, _ = _mk_plane(rp.RolloutPlane, RetryPolicy, buffer, {"rollout-0": backend})
    reader = _FakeReader()
    rollout = RolloutConfig(pairs_per_round=2, min_fill=4, staleness_checkpoints=1)
    try:
        plane.start()
        stream = rp.remote_rollout_batch_stream(plane, reader, {"trainable": None},
                                                batch_size=2, seq_len=8, checkpoint_every=1,
                                                rollout=rollout, fill_timeout_s=30.0)
        assert next(stream)["chosen_tokens"].shape == (2, 8)
        assert not any(e[0] == "policy" for e in backend.events)
        reader.step = 5
        next(stream)
        assert ("policy", 1, 5) in backend.events
        tree = wire.tree_from_blob(plane._policy[1])
        assert set(tree) == {"l.lora_a"} and np.allclose(tree["l.lora_a"], 5.0)
        assert _wait(lambda: buffer.depth >= rollout.min_fill, timeout=20)
        next(stream)
        assert all(p.version >= 4 for p in buffer._pairs)
        assert buffer.evicted_stale_total > 0
    finally:
        plane.close()


# ---------------------------------------------------------------------------
# the worker's rollout and reward ops over a loopback socket
# ---------------------------------------------------------------------------


async def _served(spec):
    """(server, client) of ``spec``'s worker on a loopback socket."""
    server = build_worker(spec, exit_on_drain=False)
    port = await server.start()
    conn = await _Connection.open("127.0.0.1", port)
    hello = await bounded(conn.call("hello", {}, timeout_s=30))
    return server, RemoteReplica(spec.replica_id, conn, hello, sandbox=spec.sandbox,
                                 heartbeat_interval_s=0.5)


@pytest.fixture(scope="module")
def lora_base(tmp_path_factory):
    """A tiny LoRA policy's base as a learner writes it, and an adapter."""
    art = tmp_path_factory.mktemp("base")
    cfg = cli.build_model_config({"model": TINY_SPEC})
    trainer = DPOTrainer(cfg, TrainConfig(task="rlhf", rollout_workers=1), device="cpu")
    state = trainer.model.state_dict()
    rp.write_rollout_base(str(art), TINY_SPEC,
                          {k: v for k, v in state.items()
                           if not k.endswith((".lora_a", ".lora_b"))})
    gen = torch.Generator().manual_seed(8)
    adapter = {k: 0.3 * torch.randn(v.shape, generator=gen) for k, v in state.items()
               if k.endswith((".lora_a", ".lora_b"))}
    return art, adapter


def test_rollout_worker_loopback_protocol_and_deterministic_regen(lora_base, tmp_path):
    art, adapter = lora_base

    def spec(box):
        os.makedirs(box, exist_ok=True)
        return WorkerSpec(job_id="rl", replica_id="rollout-0", sandbox=str(box),
                          builder="rollout_base", builder_kwargs={"dir": str(art), "device": "cpu"},
                          engine={}, batcher={}, warm_start=False,
                          rollout={"seq_len": SEQ, "prompt_fraction": 0.5, "max_new_tokens": 6,
                                   "slots": 2, "seed": 11, "max_outbox_rounds": 2})

    async def harvest(box, push):
        server, rep = await _served(spec(box))
        try:
            assert (await bounded(rep.rollout_start(2)))["started"]
            assert (await bounded(rep.rollout_start(2)))["started"]  # idempotent
            deadline = time.monotonic() + AWAIT_S
            rounds = []
            while len(rounds) < 2:
                assert time.monotonic() < deadline, "no rollout rounds"
                rounds = (await bounded(rep.rollout_pull(0, 8)))["rounds"]
                await asyncio.sleep(0.02)
            replay = {r["seq"]: r for r in (await bounded(rep.rollout_pull(0, 8)))["rounds"]}
            assert all(replay[r["seq"]]["pairs"] == r["pairs"] for r in rounds)
            assert not (await bounded(rep.rollout_policy_version(0, None)))["accepted"]
            probe = await bounded(rep.health_probe())
            assert probe["stats"]["actor_rounds"] >= 2
            assert set(probe["stats"]["flash_launches"]) == {
                "flash_forward", "flash_backward_dq", "flash_backward_dkv"}
            after = []
            if push:
                out = await bounded(rep.rollout_policy_version(5, wire.tree_to_blob(adapter)))
                assert out["accepted"]
                await bounded(rep.rollout_ack(rounds[-1]["seq"]))
                while not any(r["version"] == 5 for r in after):
                    assert time.monotonic() < deadline, "the pushed policy never decoded"
                    after = (await bounded(rep.rollout_pull(rounds[-1]["seq"], 8)))["rounds"]
                    await asyncio.sleep(0.02)
                left = (await bounded(rep.rollout_pull(0, 64)))["rounds"]
                assert all(r["seq"] > rounds[-1]["seq"] for r in left)  # acked, trimmed
            return rounds[:2], after
        finally:
            await bounded(rep.close(), 30)
            await bounded(server.stop(), 30)

    first, after = run(harvest(tmp_path / "a", push=True))
    ids = [p["id"] for r in first for p in r["pairs"]]
    assert ids and len(ids) == len(set(ids))
    assert [r["version"] for r in first] == [0, 0]
    v5 = [r for r in after if r["version"] == 5][0]
    assert all(p["id"].startswith("v5:") and p["version"] == 5 for p in v5["pairs"])
    # a fresh worker with the same seed regenerates the same rounds
    second, _ = run(harvest(tmp_path / "b", push=False))
    assert [r["pairs"] for r in second] == [r["pairs"] for r in first]


def test_reward_worker_loopback_scores_and_probe(trunks, tmp_path):
    _, _, model, head = trunks
    with open(tmp_path / "reward_head.msgpack", "wb") as f:
        f.write(flax_msgpack.serialize(head))
    tiny = {**TINY, "seed": 0}
    want = rp.RewardScorer(tiny_test(**tiny), head).score(ITEMS)

    async def main():
        box = tmp_path / "w"
        box.mkdir()
        spec = WorkerSpec(job_id="rw", replica_id="r0", sandbox=str(box), builder="tiny_test",
                          builder_kwargs=tiny, engine={"slots": 2, "prompt_buckets": [8],
                                                       "max_new_tokens": 4, "page_tokens": 4},
                          batcher={}, warm_start=True,
                          reward={"artifacts_dir": str(tmp_path)})
        server, rep = await _served(spec)
        try:
            got = await bounded(rep.reward_score(ITEMS))
            probe = await bounded(rep.health_probe())
            with pytest.raises(ValueError, match="not a rollout tenant"):
                await bounded(rep.rollout_pull(0))
            return got, probe
        finally:
            await bounded(rep.close(), 30)
            await bounded(server.stop(), 30)

    got, probe = run(main())
    assert got == want
    assert probe["stats"]["reward_scored_total"] == 3
    # the CPU runs the plain attention; on a card the forward kernel counts
    assert probe["stats"]["flash_launches"]["flash_forward"] == 0


def test_reward_client_waits_for_its_worker(trunks, tmp_path):
    """A ``RewardClient`` made before its reward worker listens connects once
    it does (a reward worker may be spawned beside its callers), scores as
    the scorer does, and gives up with the connection's error after
    ``connect_timeout_s``."""
    import socket

    from finetune_controller_tpu_torch.transport.client import RewardClient

    _, _, _, head = trunks
    with open(tmp_path / "reward_head.msgpack", "wb") as f:
        f.write(flax_msgpack.serialize(head))
    want = rp.RewardScorer(tiny_test(**TINY), head).score(ITEMS)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with pytest.raises(OSError):
        RewardClient("127.0.0.1", port, connect_timeout_s=0.3)
    made: dict = {}
    early = threading.Thread(target=lambda: made.update(
        client=RewardClient("127.0.0.1", port, connect_timeout_s=60.0)), daemon=True)
    early.start()

    async def main():
        box = tmp_path / "w"
        box.mkdir()
        spec = WorkerSpec(job_id="rw", replica_id="r0", sandbox=str(box), builder="tiny_test",
                          builder_kwargs=TINY, engine={"slots": 2, "prompt_buckets": [8],
                                                       "max_new_tokens": 4, "page_tokens": 4},
                          batcher={}, warm_start=False, port=port,
                          reward={"artifacts_dir": str(tmp_path)})
        await asyncio.sleep(0.5)  # the client is already retrying
        server = build_worker(spec, exit_on_drain=False)
        await server.start()
        try:
            await asyncio.to_thread(early.join, 60)
            client = made["client"]
            try:
                return await asyncio.to_thread(client.batch_reward_fn(), [
                    (it["prompt"], it["completion"]) for it in ITEMS])
            finally:
                await asyncio.to_thread(client.close)
        finally:
            await bounded(server.stop(), 30)

    assert run(main()) == want


# ---------------------------------------------------------------------------
# the DPO trainer: in-process and remote modes
# ---------------------------------------------------------------------------


def _tiny_cfg():
    return PRESETS["tiny-test"].replace(lora=LoRAConfig(rank=4))


def test_inprocess_rlhf_forces_prefetch_zero_and_blocking_commits():
    cfg = TrainConfig(task="rlhf", batch_size=2, seq_len=SEQ, total_steps=4, prefetch=2)
    trainer = DPOTrainer(_tiny_cfg(), cfg, device="cpu")
    assert cfg.prefetch == 0 and trainer._blocking_checkpoints is True


def test_remote_rlhf_keeps_prefetch_and_async_commits():
    cfg = TrainConfig(task="rlhf", batch_size=2, seq_len=SEQ, total_steps=4, prefetch=2,
                      rollout_workers=2)
    trainer = DPOTrainer(_tiny_cfg(), cfg, device="cpu")
    assert cfg.prefetch == 2 and trainer._blocking_checkpoints is False
    trainer.rollout_stats_fn = lambda: {}
    fields = trainer._writer_extra_fields(False)
    assert {"rollout_workers_alive", "rollout_respawns_total",
            "rollout_dup_pairs_total"} <= set(fields)
    jtrainer = JaxDPOTrainer(JAX_PRESETS["tiny-test"].replace(lora=JaxLoRAConfig(rank=4)),
                             JaxTrainConfig(task="rlhf", batch_size=2, seq_len=SEQ,
                                            total_steps=4, prefetch=2, rollout_workers=2))
    jtrainer.rollout_stats_fn = lambda: {}
    assert fields == jtrainer._writer_extra_fields(False)


def test_dpo_task_never_touches_prefetch():
    cfg = TrainConfig(task="dpo", batch_size=2, seq_len=SEQ, total_steps=4, prefetch=3)
    trainer = DPOTrainer(_tiny_cfg(), cfg, device="cpu")
    assert cfg.prefetch == 3 and trainer._blocking_checkpoints is False


# ---------------------------------------------------------------------------
# serve_transport=process: a reward job's reward workers
# ---------------------------------------------------------------------------


def test_serve_manager_builds_reward_workers(reward_job, tmp_path):
    from finetune_controller_tpu_torch.controller import config as port_config
    from finetune_controller_tpu_torch.controller.objectstore import LocalObjectStore, build_uri
    from finetune_controller_tpu_torch.controller.schemas import PromotionStatus
    from finetune_controller_tpu_torch.serve.loader import load_serving_model
    from finetune_controller_tpu_torch.serve.service import ServeManager

    settings = port_config.Settings(
        state_dir=str(tmp_path / "state"), object_store_root=str(tmp_path / "objects"),
        device="cpu", serve_transport="process", serve_replicas=1,
        serve_prompt_buckets=[8, 16], serve_max_new_tokens=8, serve_kv_page_tokens=4,
        serve_worker_heartbeat_s=0.5)
    store = LocalObjectStore(tmp_path / "objects")

    class State:
        async def get_job(self, job_id):
            return types.SimpleNamespace(promotion_status=PromotionStatus.COMPLETED,
                                         promotion_uri=build_uri("deploy", "rw"))

        async def append_job_event(self, job_id, event):
            return None

    async def main():
        state = State()
        uri = (await state.get_job("rw")).promotion_uri
        for path in [reward_job / "resolved_config.json",
                     *sorted((reward_job / "checkpoints").rglob("*"))]:
            if path.is_file():
                await store.put_file(f"{uri}/{path.relative_to(reward_job)}", path)
        manager = ServeManager(state, store, settings)
        try:
            meta = await bounded(manager.load("rw"))
            session = manager.sessions["rw"]
            assert meta["task"] == "reward"
            assert session.fleet.reward_spec == {"artifacts_dir": session.worker_stage_dir}
            (replica,) = session.fleet.replicas.values()
            scores = await bounded(replica.batcher.reward_score(ITEMS))
            pids = session.fleet.stats()["worker_pids"]
        finally:
            await bounded(manager.close(), 60)
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
        return scores

    scores = run(main())
    model, _ = load_serving_model(reward_job, merge_lora=True, device="cpu")
    want = rp.RewardScorer(model, read_reward_head(str(reward_job))).score(ITEMS)
    np.testing.assert_allclose(scores, want, rtol=SCORE_REL_TOL, atol=SCORE_REL_TOL)


# ---------------------------------------------------------------------------
# one real run: train.cli.main with a rollout worker and a reward worker
# ---------------------------------------------------------------------------


def test_cli_remote_rlhf_sigkill_respawn_exactly_once(reward_job, tmp_path, monkeypatch):
    """``rollout_workers: 1`` scoring with a reward worker process: the
    rollout worker is SIGKILLed once its first round is in, the plane
    respawns it (a checkpoint only at the end, so no policy is pushed and the
    new incarnation regenerates version-0 rounds), the replays are dropped
    and equal their originals, and no (worker, pair id) enters the buffer
    twice; every worker is gone afterwards."""
    art = tmp_path / "rl" / "artifacts"
    ingested, replays, seen, kill, built = [], [], {}, {}, {}
    real_build, real_ingest, real_from_doc = (rp.build_remote_rlhf_loop,
                                              rp.RolloutPlane._ingest, rp._pair_from_doc)

    def spy_ingest(plane, ws, doc):
        for pd in doc.get("pairs") or []:
            first = seen.setdefault((ws.worker_id, pd["id"]), pd)
            if first is not pd:
                replays.append(first == pd)
        return real_ingest(plane, ws, doc)

    def spy_from_doc(doc):
        ingested.append((threading.current_thread().name, doc["id"]))
        return real_from_doc(doc)

    def killer(plane, stop):
        ws = plane._workers[0]
        while not stop.is_set():
            if ws.generation == 1 and ws.cursor >= 1 and "pid" not in kill:
                kill["pid"] = ws.handle.pid
                os.kill(kill["pid"], signal.SIGKILL)
            time.sleep(0.005)

    def capture(trainer, artifacts_dir, **kw):
        stream, plane, buffer = real_build(trainer, artifacts_dir, **kw)
        stop = threading.Event()
        threading.Thread(target=killer, args=(plane, stop), daemon=True).start()
        real_close = plane.close

        def close():
            ws = plane._workers[0]
            assert _wait(lambda: ws.generation >= 2 and plane.dup_pairs_total > 0, timeout=60)
            built.update(stats=plane.stats(), pids=[kill.get("pid"), ws.handle.pid],
                         last=dict(ws.last_stats))
            stop.set()
            real_close()

        plane.close = close
        return stream, plane, buffer

    monkeypatch.setattr(rp, "build_remote_rlhf_loop", capture)
    monkeypatch.setattr(rp.RolloutPlane, "_ingest", spy_ingest)
    monkeypatch.setattr(rp, "_pair_from_doc", spy_from_doc)

    async def serve_reward():
        fleet = ReplicaFleet(
            "rw", None, EngineConfig(slots=2, prompt_buckets=(8,), max_new_tokens=4,
                                     page_tokens=4),
            transport=ProcessTransport(job_id="rw", root=tmp_path / "reward_workers",
                                       payload={"builder": "deploy_dir",
                                                "kwargs": {"dir": str(reward_job),
                                                           "device": "cpu"}}),
            reward_spec={"artifacts_dir": str(reward_job)})
        await bounded(fleet.start())
        return fleet

    loop = asyncio.new_event_loop()
    fleet = None
    try:
        fleet = loop.run_until_complete(serve_reward())
        reward = fleet.replicas["r0"].batcher
        spec = {"job_id": "rl", "artifacts_dir": str(art), "model": TINY_SPEC,
                "training": {"task": "rlhf", "total_steps": 6, "batch_size": 4, "seq_len": SEQ,
                             "log_every": 1, "checkpoint_every": 6, "dpo_beta": 0.2,
                             "learning_rate": 5e-3, "rollout_workers": 1,
                             "heartbeat_interval_s": 0},
                "rollout": {"pairs_per_round": 4, "min_fill": 4, "max_new_tokens": 4,
                            "slots": 2, "reward_port": reward.port}}
        art.mkdir(parents=True)
        (art / "spec.json").write_text(json.dumps(spec))
        assert cli.main(["--spec", str(art / "spec.json"), "--device", "cpu"]) == 0
        scored = loop.run_until_complete(bounded(reward.health_probe()))["stats"]
    finally:
        if fleet is not None:
            loop.run_until_complete(bounded(fleet.close(), 60))
        loop.close()
    assert kill, "the rollout worker was never killed"
    stats = built["stats"]
    assert stats["rollout_respawns_total"] >= 1 and stats["rollout_dup_pairs_total"] > 0
    assert replays and all(replays)  # regenerated pairs equal their originals
    assert ingested and len(ingested) == len(set(ingested))
    assert built["pids"][0] != built["pids"][1]
    assert built["last"]["reward_score_calls"] > 0 and built["last"]["actor_bootstrap_pairs"] == 0
    assert scored["reward_scored_total"] > 0
    rows = cli_rows(art / "metrics.csv")
    assert len(rows) == 6 and all(np.isfinite(float(r["loss"])) for r in rows)
    assert {"rollout_workers_alive", "rollout_respawns_total",
            "rollout_dup_pairs_total"} <= set(rows[0])
    for pid in built["pids"]:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def cli_rows(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))
