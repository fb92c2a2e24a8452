"""The port's cross-process serve transport against the JAX package's.

Anchors, at the ``tiny-test`` preset on the CPU:

* wire frames of either package decode equal in the other, under the
  msgpack codec (the reference's ``msgpack`` package, the port's stdlib
  coder) and under ``FTC_TRANSPORT_CODEC=json``; an oversized frame is
  refused on both sides;
* an adapter's registry-sync blob (``entry_to_wire``) is byte for byte the
  reference's for the same adapter;
* the worker's RPC surface behaves like the in-process ``Batcher`` it
  wraps (generate token for token, duplicates decoded once, typed errors,
  probe, tenant_busy, drain, adapter sync with a re-register racing a
  decode), proven over a loopback socket without a process spawn;
* a wedged worker fails the probe "stale", then "timed out";
* a REAL worker process spawns, beats, serves and drains to exit 0; a
  SIGKILLed one loses no request and answers none twice;
* the slice against the JAX package: the JAX package writes a model's
  ``rollout_base/params.msgpack``, a worker process of the port rebuilds it
  (``rollout_base``) and its greedy tokens equal the JAX ``BatchEngine``'s;
  the rebuilt model's first-token logits are within the f32 tolerance of
  the serving parity test (``tests/test_torch_model.py``: rtol = atol =
  1e-5);
* ``serve_transport=process`` through the port's ``ServeManager``.

Every await that involves a socket or a process is bounded
(``asyncio.wait_for``), children are killed in ``finally``, and every
test server closes its server-side writers before ``wait_closed()``.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetune_controller_tpu.models.llama import (
    PRESETS as JAX_PRESETS,
    LlamaForCausalLM as JaxLlama,
)
from finetune_controller_tpu.prefs.rollout_plane import write_rollout_base
from finetune_controller_tpu.serve.adapters import (
    AdapterRegistry as JaxRegistry,
    entry_from_wire as jax_entry_from_wire,
    entry_to_wire as jax_entry_to_wire,
)
from finetune_controller_tpu.serve.engine import (
    BatchEngine as JaxEngine,
    EngineConfig as JaxEngineConfig,
    GenRequest as JaxRequest,
)
from finetune_controller_tpu.transport import wire as ref_wire
from finetune_controller_tpu_torch import transport
from finetune_controller_tpu_torch.resilience.faults import ServeFault
from finetune_controller_tpu_torch.resilience.policy import RetryPolicy
from finetune_controller_tpu_torch.serve.adapters import (
    AdapterRegistry,
    UnknownAdapter,
    entry_from_wire,
    entry_to_wire,
)
from finetune_controller_tpu_torch.serve.batcher import (
    Batcher,
    DeadlineExceeded,
    ReplicaUnavailable,
)
from finetune_controller_tpu_torch.serve.engine import (
    BatchEngine,
    EngineConfig,
    GenRequest,
    PromptTooLong,
    warm_engine,
)
from finetune_controller_tpu_torch.serve.fleet import ReplicaFleet
from finetune_controller_tpu_torch.serve.router import ReplicaRouter
from finetune_controller_tpu_torch.transport import TransportError, wire
from finetune_controller_tpu_torch.transport.builders import (
    resolve_builder,
    rollout_base,
    tiny_test,
)
from finetune_controller_tpu_torch.transport.client import RemoteReplica, _Connection
from finetune_controller_tpu_torch.transport.process import ProcessTransport
from finetune_controller_tpu_torch.transport.worker import WorkerServer, WorkerSpec

torch.set_num_threads(1)

ENGINE_CFG = dict(slots=2, prompt_buckets=(8, 16), max_new_tokens=24, page_tokens=4)
#: the seeded tiny model every worker process of these tests builds
TINY = {"device": "cpu", "dtype": "float32", "seed": 0}
PROMPTS = [[5, 9, 2, 7], [1, 3, 3, 8, 2, 2], [7, 7, 7], [2, 13], [11, 4, 9, 1], [3, 3, 1],
           [6, 2, 8, 8, 1], [9, 9]]
#: the bound on each socket or process await (a spawn pays a fresh
#: interpreter, ``import torch`` and the model build: ~5 s here)
AWAIT_S = 120.0
#: the f32 logits tolerance of ``tests/test_torch_model.py`` (``TOL``)
LOGITS_TOL = 1e-5


def run(coro, timeout_s: float = 300.0):
    """Run ``coro`` on a fresh loop, bounded as a whole."""
    return asyncio.run(asyncio.wait_for(coro, timeout_s))


def bounded(aw, timeout_s: float = AWAIT_S):
    return asyncio.wait_for(aw, timeout_s)


@pytest.fixture(scope="module")
def tiny_model():
    return tiny_test(**TINY)


@pytest.fixture(scope="module")
def baseline(tiny_model):
    """Greedy tokens of one request alone on one in-process engine."""
    engine = BatchEngine(tiny_model, EngineConfig(**ENGINE_CFG))
    memo: dict = {}

    def get(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = engine.run([GenRequest("b", list(prompt), n)])["b"].generated
        return memo[key]

    return get


# ---------------------------------------------------------------------------
# Wire framing and codec, both packages
# ---------------------------------------------------------------------------

DOCS = [
    {"op": "generate", "id": 7, "payload": {
        "request_id": "r-1", "tokens": [5, 9, 2, 7], "max_new_tokens": 8,
        "temperature": 0.0, "top_k": 0, "eos_id": None, "seed": 0, "adapter_id": "",
        "deadline_in_s": 12.5, "timeout_s": None}},
    {"id": 2 ** 40, "ok": False, "error": {"type": "QueueFull", "message": "full",
                                          "retry_after_s": 3.0}},
    {"id": 3, "ok": True, "payload": {
        "blob": b"\x00\xffbinary" * 40, "nested": [[1, -2, [3, None]], {"x": b"zz"}],
        "neg": -(2 ** 33), "big": 2 ** 63, "flag": True, "off": False, "s": "text é",
        "by_tenant": {"": 4, "t": 2}, "empty": {}, "none": None}},
]


@pytest.fixture(params=["msgpack", "json"])
def codec(request, monkeypatch):
    if request.param == "json":
        monkeypatch.setenv("FTC_TRANSPORT_CODEC", "json")
        monkeypatch.setattr(ref_wire, "_FORCE_JSON", True)
    else:
        monkeypatch.delenv("FTC_TRANSPORT_CODEC", raising=False)
        monkeypatch.setattr(ref_wire, "_FORCE_JSON", False)
    assert wire.codec_name() == ref_wire.codec_name() == request.param
    return request.param


def test_wire_frames_decode_equal_across_packages(codec):
    """Every document survives port -> reference and reference -> port
    under both codecs (bytes as bytes, None, nested lists, ints past 32
    bits); with msgpack, bytes ride as MessagePack bin, not base64."""
    for doc in DOCS:
        assert ref_wire.loads(wire.dumps(doc)) == doc
        assert wire.loads(ref_wire.dumps(doc)) == doc
        assert wire.loads(wire.dumps(doc)) == doc
    data = wire.dumps(DOCS[2])
    if codec == "json":
        json.loads(data.decode())  # really JSON
    else:
        assert b"\x00\xffbinary" * 40 in data  # native bytes, not base64


def test_wire_frames_cross_a_socket_and_oversize_is_refused(codec, monkeypatch):
    """One frame each way between the port's and the reference's framing
    over a loopback socket; an oversized length prefix raises on read in
    both packages, an oversized payload on write in the port."""

    async def main():
        got = []
        writers = []

        async def handle(reader, writer):
            writers.append(writer)
            got.append(await ref_wire.read_msg(reader))
            await ref_wire.write_msg(writer, DOCS[2])

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            reader, writer = await bounded(asyncio.open_connection("127.0.0.1", port))
            await bounded(wire.write_msg(writer, DOCS[0]))
            assert await bounded(wire.read_msg(reader)) == DOCS[2]
            assert got == [DOCS[0]]
            writer.close()
        finally:
            server.close()
            for w in writers:
                w.close()
            await bounded(server.wait_closed(), 10)

        class FakeReader:
            def __init__(self, data):
                self.data = data

            async def readexactly(self, n):
                out, self.data = self.data[:n], self.data[n:]
                return out

        big = (wire.MAX_FRAME + 1).to_bytes(4, "big")
        with pytest.raises(wire.FrameError, match="exceeds"):
            await wire.read_msg(FakeReader(big))
        with pytest.raises(ref_wire.FrameError, match="exceeds"):
            await ref_wire.read_msg(FakeReader(big))
        monkeypatch.setattr(wire, "MAX_FRAME", 64)
        with pytest.raises(wire.FrameError, match="exceeds MAX_FRAME"):
            await wire.write_msg(None, DOCS[2])

    run(main(), 60)


def _adapter(seed: int, rank: int, n_layers: int = 2) -> dict[str, torch.Tensor]:
    """A port adapter for ``tiny-test`` (every projection, non-zero A and B)."""
    cfg = JAX_PRESETS["tiny-test"]
    d, kv = cfg.d_model, cfg.n_kv_heads * (cfg.d_model // cfg.n_heads)
    shapes = {"attn.q_proj": (d, d), "attn.k_proj": (d, kv), "attn.v_proj": (d, kv),
              "attn.o_proj": (d, d), "mlp.gate_proj": (d, cfg.d_ff),
              "mlp.up_proj": (d, cfg.d_ff), "mlp.down_proj": (cfg.d_ff, d)}
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n_layers):
        for name, (fan_in, fan_out) in shapes.items():
            out[f"layers.{i}.{name}.lora_a"] = torch.from_numpy(
                rng.standard_normal((fan_in, rank)).astype(np.float32) * 0.3)
            out[f"layers.{i}.{name}.lora_b"] = torch.from_numpy(
                rng.standard_normal((rank, fan_out)).astype(np.float32) * 0.3)
    return out


def _as_reference_tree(adapter: dict[str, torch.Tensor]) -> dict:
    """The same adapter as the reference's scanned ``lora`` tree, built
    here by hand from the numbers (not through the port's converter)."""
    block: dict = {}
    n = 1 + max(int(k.split(".")[1]) for k in adapter)
    for key in adapter:
        _, i, module, proj, leaf = key.split(".")
        if i != "0":
            continue
        stacked = np.stack([adapter[f"layers.{j}.{module}.{proj}.{leaf}"].numpy()
                            for j in range(n)])
        block.setdefault(module, {}).setdefault(proj, {})[leaf] = stacked
    return {"blocks": {"block": block}}


def test_adapter_entry_wire_bytes_equal_reference():
    """``entry_to_wire``'s blob is the reference's bytes for the same
    adapter; each package decodes the other's document to the same
    numbers."""
    adapter = _adapter(seed=5, rank=4)
    entry = AdapterRegistry(3, 8).register("ten-a", adapter, 16.0, 4, meta={"step": 7})
    ref_entry = JaxRegistry(3, 8).register("ten-a", _as_reference_tree(adapter), 16.0, 4,
                                          meta={"step": 7})
    doc, ref_doc = entry_to_wire(entry), jax_entry_to_wire(ref_entry)
    assert isinstance(doc["tree"], bytes) and doc["tree"] == ref_doc["tree"]
    assert {k: v for k, v in doc.items() if k != "tree"} == \
        {k: v for k, v in ref_doc.items() if k != "tree"}
    aid, back, alpha, rank, meta = entry_from_wire(ref_doc)
    assert (aid, alpha, rank, meta) == ("ten-a", 16.0, 4, {"step": 7})
    assert sorted(back) == sorted(adapter)
    for key, value in adapter.items():
        assert torch.equal(back[key], value), key
    _, ref_tree, *_ = jax_entry_from_wire(doc)
    want = _as_reference_tree(adapter)["blocks"]["block"]
    for module, projs in want.items():
        for proj, leaves in projs.items():
            for leaf, value in leaves.items():
                np.testing.assert_array_equal(
                    ref_tree["blocks"]["block"][module][proj][leaf], value)


def test_builder_resolution():
    assert resolve_builder("tiny_test") is tiny_test
    assert resolve_builder("rollout_base") is rollout_base
    fn = resolve_builder("finetune_controller_tpu_torch.transport.builders:tiny_test")
    assert fn is tiny_test
    with pytest.raises(ValueError, match="unknown payload builder"):
        resolve_builder("nope")
    with pytest.raises(ValueError, match="not callable"):
        resolve_builder("finetune_controller_tpu_torch.transport.builders:_BUILTINS")


# ---------------------------------------------------------------------------
# Worker RPC protocol (loopback server, no process spawn)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared_engine(tiny_model):
    """One warm engine with a tenant registry for the loopback tests."""
    engine = BatchEngine(tiny_model, EngineConfig(**ENGINE_CFG),
                         adapters=AdapterRegistry(4, 8))
    warm_engine(engine)
    return engine


class _Loopback:
    """A worker server over the shared engine on a loopback socket, plus a
    connected ``RemoteReplica``."""

    def __init__(self, engine, sandbox, **batcher_kw):
        self.engine = engine
        self.spec = WorkerSpec(
            job_id="loop-job", replica_id="r0", sandbox=str(sandbox), builder="tiny_test",
            builder_kwargs=TINY, engine=dict(ENGINE_CFG, prompt_buckets=[8, 16]), batcher={},
        )
        self.server = WorkerServer(self.spec, engine, Batcher(engine, **batcher_kw),
                                   engine.adapters, exit_on_drain=False)
        self.replica: RemoteReplica | None = None

    async def __aenter__(self):
        port = await self.server.start()
        conn = await _Connection.open("127.0.0.1", port)
        hello = await conn.call("hello", {}, timeout_s=10)
        self.replica = RemoteReplica("r0", conn, hello, sandbox=self.spec.sandbox,
                                     heartbeat_interval_s=0.2)
        return self

    async def __aexit__(self, *exc):
        await bounded(self.replica.close(), 30)
        await bounded(self.server.stop(), 30)


def test_generate_over_wire_equals_batcher_and_dedupes(shared_engine, baseline, tmp_path):
    """Tokens over the wire equal the in-process engine's; a concurrent
    duplicate attaches to the attempt in flight and a late one replays:
    the id decodes once."""

    async def main():
        async with _Loopback(shared_engine, tmp_path) as loop:
            replica = loop.replica
            before = shared_engine.requests_finished_total
            req = GenRequest(request_id="g1", tokens=[5, 9, 2, 7], max_new_tokens=8)
            first, dup = await bounded(asyncio.gather(replica.submit(req), replica.submit(req)))
            assert first.generated == dup.generated
            assert shared_engine.requests_finished_total == before + 1
            replay = await bounded(replica.submit(req))
            assert replay.generated == first.generated
            assert shared_engine.requests_finished_total == before + 1
            assert first.replica_id == "r0"
            assert first.generated == baseline([5, 9, 2, 7], 8)
            # and a whole batch through one in-process Batcher: the same
            outs = await bounded(asyncio.gather(*(
                replica.submit(GenRequest(f"w{i}", p, 6)) for i, p in enumerate(PROMPTS))))
            local = Batcher(shared_engine)
            try:
                ref = await bounded(asyncio.gather(*(
                    local.submit(GenRequest(f"l{i}", p, 6)) for i, p in enumerate(PROMPTS))))
            finally:
                await local.close()
            assert [o.generated for o in outs] == [r.generated for r in ref]

    run(main())


def test_typed_errors_cross_the_wire(shared_engine, tmp_path):
    async def main():
        async with _Loopback(shared_engine, tmp_path, max_queue=64) as loop:
            replica = loop.replica
            with pytest.raises(PromptTooLong):
                await bounded(replica.submit(GenRequest("too-long", [1] * 99, 4)))
            with pytest.raises(UnknownAdapter):
                await bounded(replica.submit(GenRequest("who", [1, 2], 4, adapter_id="nope")))
            # a spent deadline never reaches the worker
            with pytest.raises(DeadlineExceeded):
                await replica.submit(GenRequest("late", [1, 2], 4),
                                     deadline=time.monotonic() - 1.0)
            # a deadline expiring on the worker crosses back typed
            with pytest.raises(DeadlineExceeded):
                await bounded(replica.submit(GenRequest("tight", [1, 2, 3], 24),
                                             deadline=time.monotonic() + 0.0005))
            with pytest.raises(ValueError, match="unknown transport op 'no_such_op'"):
                await bounded(replica._conn.call("no_such_op", {}, timeout_s=10))

    run(main())


def test_probe_stats_and_tenant_busy(shared_engine, tmp_path):
    async def main():
        async with _Loopback(shared_engine, tmp_path) as loop:
            replica = loop.replica
            await bounded(replica.submit(GenRequest("p1", [7, 7, 7], 4)))
            probe = await bounded(replica.health_probe())
            assert probe["steps_total"] >= 1 and probe["slots_busy"] == 0
            assert probe["stats"]["requests_completed_total"] == 1
            assert probe["stats"]["paged_launches"] == 0  # the CPU runs the plain path
            assert probe["pid"] == os.getpid()
            assert replica.queue_depth == 0
            assert replica.engine.steps_total == probe["steps_total"]
            assert replica.stats()["transport"] == "process"
            assert await bounded(replica.tenant_busy("")) == 0
            slow = asyncio.ensure_future(replica.submit(GenRequest("busy", PROMPTS[1], 24)))
            await asyncio.sleep(0)
            # between probes the router weighs the client's own requests in
            # flight (the probe snapshot still says idle)
            assert replica.queue_depth + replica.slots_busy == 1
            for _ in range(200):
                if await bounded(replica.tenant_busy("")) == 1:
                    break
                await asyncio.sleep(0.005)
            else:
                pytest.fail("tenant_busy never saw the request in flight")
            await bounded(slow)
            assert await bounded(replica.tenant_busy("")) == 0

    run(main())


def test_drain_bounces_queued_finishes_inflight(shared_engine, tmp_path):
    async def main():
        async with _Loopback(shared_engine, tmp_path) as loop:
            replica = loop.replica
            inflight = [asyncio.ensure_future(replica.submit(GenRequest(f"d{i}", p, 24)))
                        for i, p in enumerate(PROMPTS)]
            for _ in range(400):  # until lanes decode and the rest queue
                probe = await bounded(replica.health_probe())
                if probe["slots_busy"] and probe["queue_depth"]:
                    break
                await asyncio.sleep(0.001)
            assert await bounded(replica.drain(10.0)) is True
            done = await bounded(asyncio.gather(*inflight, return_exceptions=True))
            finished = [r for r in done if not isinstance(r, Exception)]
            bounced = [r for r in done if isinstance(r, Exception)]
            assert finished, "drain should let admitted lanes finish"
            assert bounced, "8 requests on 2 slots: some were queued"
            assert all(isinstance(b, ReplicaUnavailable) for b in bounced)
            with pytest.raises(ReplicaUnavailable):
                await replica.submit(GenRequest("after", [1], 2))

    run(main())


def test_adapter_sync_and_reregister_race(shared_engine, tiny_model, tmp_path, monkeypatch):
    """Register, refresh and unregister over the registry-sync RPCs; a
    re-register racing a decode of the same tenant completes both, and
    the refreshed tenant decodes as a dedicated engine holding only the
    new deltas; a stack whose adapters would not fit one frame together
    syncs one adapter a frame."""

    def dedicated(adapter, req):
        eng = BatchEngine(tiny_model, EngineConfig(**ENGINE_CFG, tenant_slots=2, tenant_rank=8))
        eng.adapters.register("ten-a", adapter, 16.0, 4)
        eng.install_adapter("ten-a")
        return eng.run([req])[req.request_id].generated

    async def main():
        async with _Loopback(shared_engine, tmp_path) as loop:
            replica = loop.replica
            registry = AdapterRegistry(4, 8)
            v1, v2 = _adapter(seed=1, rank=4), _adapter(seed=2, rank=4)
            entry = registry.register("ten-a", v1, 16.0, 4)
            assert await bounded(replica.stack_sync([entry_to_wire(entry)])) is None
            base = await bounded(replica.submit(GenRequest("a-base", [5, 9, 2, 7], 6)))
            tenant = await bounded(replica.submit(
                GenRequest("a-t1", [5, 9, 2, 7], 6, adapter_id="ten-a")))
            assert tenant.generated != base.generated, "the adapter must change the decode"
            racing = asyncio.ensure_future(replica.submit(
                GenRequest("a-race", PROMPTS[1], 12, adapter_id="ten-a")))
            await asyncio.sleep(0.01)
            entry2 = registry.register("ten-a", v2, 16.0, 4)
            slot = await bounded(replica.adapter_register(entry_to_wire(entry2), refresh=True))
            assert slot == entry.slot
            raced = await bounded(racing)
            assert raced.finish_reason in ("length", "eos")
            post = await bounded(replica.submit(
                GenRequest("a-t2", [5, 9, 2, 7], 6, adapter_id="ten-a")))
            assert post.generated == dedicated(
                v2, GenRequest("ded", [5, 9, 2, 7], 6, adapter_id="ten-a"))
            await bounded(replica.adapter_unregister("ten-a"))
            with pytest.raises(UnknownAdapter):
                await bounded(replica.submit(GenRequest("gone", [5, 9], 4, adapter_id="ten-a")))
            # stack_sync sends one adapter a frame: two whose frames would
            # not fit one MAX_FRAME together still sync
            docs = [entry_to_wire(registry.register(aid, _adapter(seed=seed, rank=4), 16.0, 4))
                    for aid, seed in (("ten-b", 3), ("ten-c", 4))]
            one = max(len(wire.dumps({"op": "stack_sync", "id": 1,
                                      "payload": {"entries": [d]}})) for d in docs)
            monkeypatch.setattr(wire, "MAX_FRAME", one + 64)
            assert len(wire.dumps({"entries": docs})) > wire.MAX_FRAME
            await bounded(replica.stack_sync(docs))
            for aid in ("ten-b", "ten-c"):
                await bounded(replica.submit(GenRequest(f"s-{aid}", [5, 9], 4, adapter_id=aid)))
                await bounded(replica.adapter_unregister(aid))

    run(main())


def test_wedged_worker_fails_probe_stale_then_timed_out(tmp_path):
    """A worker that accepts connections but never answers: with a stale
    heartbeat the probe fails "stale"; with a fresh one it fails at the
    probe timeout.  The black-hole server's writers are closed before
    ``wait_closed()``, which would otherwise wait for them forever."""

    async def main():
        writers = []

        async def black_hole(reader, writer):
            writers.append(writer)
            await asyncio.sleep(3600)

        server = await asyncio.start_server(black_hole, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        replica = None
        try:
            (tmp_path / "heartbeat.json").write_text(
                json.dumps({"step": 3, "ts": time.time() - 120.0}))
            conn = await bounded(_Connection.open("127.0.0.1", port))
            replica = RemoteReplica("rX", conn, {"pid": 1, "engine": {}}, sandbox=str(tmp_path),
                                    heartbeat_interval_s=0.5, probe_timeout_s=0.5)
            with pytest.raises(TransportError, match="stale"):
                await bounded(replica.health_probe(), 10)
            (tmp_path / "heartbeat.json").write_text(json.dumps({"step": 3, "ts": time.time()}))
            with pytest.raises(TransportError, match="timed out"):
                await bounded(replica.health_probe(), 10)
        finally:
            if replica is not None:
                await bounded(replica.close(), 10)
            server.close()
            for w in writers:
                w.close()
            await bounded(server.wait_closed(), 10)

    run(main(), 60)


# ---------------------------------------------------------------------------
# Real worker processes
# ---------------------------------------------------------------------------


def _transport(tmp_path, **kw):
    defaults = dict(job_id="proc-job", root=tmp_path / "workers",
                    payload={"builder": "tiny_test", "kwargs": TINY},
                    spawn_timeout_s=AWAIT_S, heartbeat_interval_s=0.5, probe_timeout_s=30.0)
    defaults.update(kw)
    return ProcessTransport(**defaults)


def test_process_worker_spawn_generate_heartbeat_drain(tmp_path, baseline):
    """One real worker: spawn handshake, the in-process tokens, a live
    heartbeat, probe, and a graceful drain to exit 0."""

    async def main():
        replica = await bounded(_transport(tmp_path).spawn(
            "r0", 0, engine_config=EngineConfig(**ENGINE_CFG), batcher_kwargs={},
            adapters=None))
        try:
            assert replica.pid != os.getpid()
            res = await bounded(replica.submit(GenRequest("p0", [5, 9, 2, 7], 8)))
            assert res.generated == baseline([5, 9, 2, 7], 8)
            probe = await bounded(replica.health_probe())
            assert probe["steps_total"] >= 1 and probe["pid"] == replica.pid
            hb = json.loads((tmp_path / "workers" / "r0-g0" / "heartbeat.json").read_text())
            assert hb["pid"] == replica.pid
            assert await bounded(replica.drain(10.0)) is True
            assert replica._proc.poll() == 0  # drained workers exit 0
            log = (tmp_path / "workers" / "r0-g0" / "worker.log").read_text()
            assert "drained (clean=True)" in log
        finally:
            await bounded(replica.close(), 30)
            if replica._proc.poll() is None:
                replica._proc.kill()

    run(main())


def test_spawn_failure_carries_the_log_tail(tmp_path):
    """A worker that cannot build its payload fails its spawn with the
    tail of its log; no replica is left behind.  A reward spec whose
    artifacts hold no head fails the build with the reference's words."""

    async def main():
        bad = _transport(tmp_path, payload={"builder": "tiny_test",
                                            "kwargs": {**TINY, "preset": "no-such-preset"}})
        with pytest.raises(TransportError, match=r"exited with code 1 during spawn(.|\n)*"
                                                 r"no-such-preset"):
            await bounded(bad.spawn("r0", 0, engine_config=EngineConfig(**ENGINE_CFG),
                                    batcher_kwargs={}))

    run(main())
    spec = WorkerSpec(job_id="j", replica_id="r0", sandbox=str(tmp_path), builder="tiny_test",
                      builder_kwargs=TINY, engine=dict(ENGINE_CFG), batcher={},
                      reward={"artifacts_dir": str(tmp_path)})
    from finetune_controller_tpu_torch.transport.worker import build_worker

    with pytest.raises(FileNotFoundError, match="is this a task: reward job's"):
        build_worker(spec)


def test_sigkilled_worker_answers_every_request_exactly_once(tmp_path, baseline):
    """``FTC_FAULT_SERVE_*`` forwarded into the spawn env makes worker r0
    SIGKILL itself mid-decode: every request completes exactly once with
    the unkilled tokens, the router fails over, and the fleet respawns the
    worker (``worker_respawns_total``)."""

    async def main():
        once = tmp_path / "fault-spent"
        fault_env = ServeFault(replica_id="r0", at_step=2, mode="kill",
                               once_file=str(once)).to_env()
        respawns0 = transport.METRICS["worker_respawns_total"]
        fleet = ReplicaFleet(
            "proc-job", None, EngineConfig(**ENGINE_CFG), replicas=2,
            transport=_transport(tmp_path, extra_env=fault_env),
            stall_timeout_s=30.0, drain_timeout_s=15.0,
            restart_policy=RetryPolicy(max_attempts=3, base_delay_s=0.1, max_delay_s=0.3,
                                       seed=0))
        health = None
        try:
            await bounded(fleet.start())
            assert fleet.stats()["transport"] == "process"
            assert len(set(fleet.stats()["worker_pids"]) - {os.getpid()}) == 2
            router = ReplicaRouter(fleet, default_timeout_s=120, failover_retries=2)

            async def health_loop():
                while True:
                    await fleet.health_tick()
                    await asyncio.sleep(0.1)

            health = asyncio.ensure_future(health_loop())
            reqs = [GenRequest(f"k{i}", p, 8) for i, p in enumerate(PROMPTS)]
            results = await bounded(asyncio.gather(*(router.submit(r) for r in reqs)))
            seen = {}
            for r in results:
                assert r.request_id not in seen, "request completed twice"
                seen[r.request_id] = r.generated
            assert len(seen) == len(PROMPTS)
            assert once.exists(), "the serve fault never fired"
            for req in reqs:
                assert seen[req.request_id] == baseline(req.tokens, 8), req.request_id
            assert router.failovers_total >= 1
            for _ in range(300):
                if fleet.replica_restarts_total >= 1 and len(fleet.healthy_replicas()) >= 2:
                    break
                await asyncio.sleep(0.1)
            assert fleet.replica_restarts_total >= 1 and fleet.replicas_failed_total >= 1
            assert len(fleet.healthy_replicas()) >= 2
            assert transport.METRICS["worker_respawns_total"] >= respawns0 + 1
        finally:
            if health is not None:
                health.cancel()
            await bounded(fleet.close(), 60)

    run(main())


# ---------------------------------------------------------------------------
# The slice against the JAX package: rollout_base into a worker process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_base(tmp_path_factory):
    """The JAX package's ``tiny-test`` (f32, seeded noise) written as an
    RLHF learner's ``rollout_base`` by the JAX package itself."""
    jcfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32)
    shapes = jax.eval_shape(JaxLlama(jcfg).init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(17)
    params = jax.tree.map(
        lambda s: np.asarray(0.05 + 0.3 * rng.standard_normal(s.shape), np.float32),
        shapes)["params"]
    art = tmp_path_factory.mktemp("rollout")
    write_rollout_base(str(art), {"preset": "tiny-test", "overrides": {"dtype": "float32"}},
                       params)
    return jcfg, params, art


def test_rollout_base_worker_matches_the_jax_engine(jax_base, tmp_path):
    """The JAX package's base, rebuilt by a worker process of the port,
    decodes the JAX ``BatchEngine``'s greedy tokens; the rebuilt model's
    first-token logits are within ``LOGITS_TOL`` of the JAX model's."""
    jcfg, params, art = jax_base
    jengine = JaxEngine(JaxLlama(jcfg), {"params": params}, JaxEngineConfig(**ENGINE_CFG))
    want = jengine.run([JaxRequest(request_id=f"j{i}", tokens=p, max_new_tokens=8)
                        for i, p in enumerate(PROMPTS)])

    model = rollout_base(str(art), device="cpu")
    jmodel = JaxLlama(jcfg)
    for prompt in PROMPTS[:3]:
        ids = np.asarray([prompt], np.int32)
        ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))[0, -1]
        with torch.no_grad():
            got = model(torch.from_numpy(ids).long())[0, -1].float().numpy()
        np.testing.assert_allclose(got, ref, rtol=LOGITS_TOL, atol=LOGITS_TOL)

    async def main():
        replica = await bounded(_transport(
            tmp_path, payload={"builder": "rollout_base",
                               "kwargs": {"dir": str(art), "device": "cpu"}}).spawn(
            "r0", 0, engine_config=EngineConfig(**ENGINE_CFG), batcher_kwargs={}))
        try:
            outs = await bounded(asyncio.gather(*(
                replica.submit(GenRequest(f"j{i}", p, 8)) for i, p in enumerate(PROMPTS))))
            return {o.request_id: [int(t) for t in o.generated] for o in outs}
        finally:
            await bounded(replica.close(), 30)

    got = run(main())
    assert got == {rid: [int(t) for t in r.generated] for rid, r in want.items()}


# ---------------------------------------------------------------------------
# serve_transport=process through the ServeManager
# ---------------------------------------------------------------------------


def test_serve_manager_process_mode(tmp_path):
    """A promoted ``tiny-test`` LoRA job loads into two worker processes
    (one staging), answers ``generate`` with the in-process loader's tokens,
    and its workers are gone after unload."""
    from finetune_controller_tpu_torch.controller import config as port_config
    from finetune_controller_tpu_torch.controller.objectstore import LocalObjectStore, build_uri
    from finetune_controller_tpu_torch.controller.schemas import PromotionStatus
    from finetune_controller_tpu_torch.serve.loader import load_serving_model
    from finetune_controller_tpu_torch.serve.service import ServeManager
    from finetune_controller_tpu_torch.train import cli

    art = tmp_path / "job"
    art.mkdir()
    spec = {"job_id": "pm", "artifacts_dir": str(art),
            "model": {"preset": "tiny-test", "lora": {"rank": 4, "alpha": 8.0},
                      "overrides": {"dtype": "float32"}},
            "training": {"total_steps": 2, "batch_size": 4, "seq_len": 16, "log_every": 1,
                         "checkpoint_every": 2, "warmup_steps": 1, "learning_rate": 0.05},
            "dataset": {"synthetic": {"task": "increment"}}}
    (art / "job.json").write_text(json.dumps(spec))
    assert cli.main(["--spec", str(art / "job.json"), "--device", "cpu"]) == 0
    settings = port_config.Settings(
        state_dir=str(tmp_path / "state"), object_store_root=str(tmp_path / "objects"),
        device="cpu", serve_transport="process", serve_replicas=2,
        serve_prompt_buckets=[8, 16], serve_max_new_tokens=16, serve_kv_page_tokens=4,
        serve_worker_heartbeat_s=0.5)
    store = LocalObjectStore(tmp_path / "objects")

    class State:
        async def get_job(self, job_id):
            return types.SimpleNamespace(promotion_status=PromotionStatus.COMPLETED,
                                         promotion_uri=build_uri("deploy", "pm"))

        async def append_job_event(self, job_id, event):
            return None

    async def main():
        state = State()
        promotion_uri = (await state.get_job("pm")).promotion_uri
        for path in [art / "resolved_config.json", *sorted((art / "checkpoints").rglob("*"))]:
            if path.is_file():
                await store.put_file(f"{promotion_uri}/{path.relative_to(art)}", path)
        manager = ServeManager(state, store, settings)
        try:
            meta = await bounded(manager.load("pm"))
            session = manager.sessions["pm"]
            pids = session.fleet.stats()["worker_pids"]
            assert len(pids) == 2 and os.getpid() not in pids
            assert session.fleet.stats()["transport"] == "process"
            assert meta["lora_merged"] is True
            result, _ = await bounded(manager.generate("pm", GenRequest("s0", [5, 9, 2, 7], 8)))
            stage = session.worker_stage_dir
        finally:
            await bounded(manager.close(), 60)
        assert not os.path.exists(stage)
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
        return result

    result = run(main())
    model, _ = load_serving_model(art, merge_lora=True, device="cpu")
    engine = BatchEngine(model, EngineConfig(slots=settings.serve_slots, prompt_buckets=(8, 16),
                                             max_new_tokens=16, page_tokens=4))
    assert result.generated == engine.run([GenRequest("o", [5, 9, 2, 7], 8)])["o"].generated
