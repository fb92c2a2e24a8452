"""The port's GCS object store and token chain (``controller/gcs.py`` on
``controller/httpclient.py``) against the reference's.

The reference's fake GCS JSON API (``tests/test_gcs.py``) serves the same
sequence of ``ObjectStore`` operations from the reference's store and the
port's: the answers and the buckets' bytes are equal (uploads, a chunked
``put_file`` and an async-stream upload, streamed reads, the download's
atomic rename, paginated listing, server-side copy, deletes, retries on
503, a persistent 503 raising).  The service-account JWT of a generated
RSA key, as the reference posts it to a fake token endpoint at a pinned
clock, equals the port's byte for byte (RS256 with PKCS#1 v1.5 is
deterministic); the token exchange, the metadata-server path (pointed at a
local fake) and ``DefaultTokenProvider``'s env-var, cache and refresh
behave as the reference's.  Tolerance: exact.
"""

from __future__ import annotations

import asyncio
import json

from aiohttp import web
from aiohttp.test_utils import TestServer

from conftest import run_async as run
from finetune_controller_tpu.controller import gcs as ref_gcs
from finetune_controller_tpu_torch.controller import gcs as port_gcs
from finetune_controller_tpu_torch.controller.config import Settings
from finetune_controller_tpu_torch.controller.objectstore import artifacts_prefix, build_object_store
from test_gcs import make_fake_gcs

STORES = {"ref": ref_gcs.GCSObjectStore, "port": port_gcs.GCSObjectStore}
NOW = 1_767_225_600.0


async def _sequence(kind: str, tmp) -> tuple[list, dict]:
    app, blobs = make_fake_gcs(page_size=2)
    fail = {"n": 0}

    @web.middleware
    async def flaky(request, handler):
        if fail["n"] > 0:
            fail["n"] -= 1
            return web.Response(status=503, text="transient")
        return await handler(request)

    app.middlewares.append(flaky)
    server = TestServer(app)
    await server.start_server()

    async def token():
        return "fake-token"

    store = STORES[kind](endpoint=str(server.make_url("")).rstrip("/"), token_fn=token,
                         chunk_size=1 << 18)
    store.retry_base_delay = 0.0
    out: list = []
    try:
        prefix = artifacts_prefix("artifacts", "u", "job1")
        await store.put_bytes(f"{prefix}/a.bin", b"A" * 10)
        await store.put_bytes(f"{prefix}/sub/b.bin", b"B" * 20)
        await store.put_bytes(f"{prefix}/c.csv", b"step,loss\n1,2.5\n2,2.0\n")
        out += [await store.exists(f"{prefix}/a.bin"), await store.exists(f"{prefix}/nope"),
                await store.get_bytes(f"{prefix}/sub/b.bin"), await store.size(f"{prefix}/c.csv")]
        out.append(await store.list_prefix(prefix))
        out.append(await store.copy_prefix(prefix, "obj://deploy/models/x/job1"))
        out.append(await store.copy_prefix(f"{prefix}/a.bin", "obj://deploy/one.bin"))
        out.append(await store.get_metrics_records(prefix))
        big = bytes(range(256)) * 8192 + b"tail"
        (tmp / f"{kind}_big.bin").write_bytes(big)
        fail["n"] = 1  # put_file rebuilds its chunk generator: retryable
        await store.put_file("obj://datasets/big.bin", tmp / f"{kind}_big.bin")
        out.append([len(c) async for c in store.get_chunks("obj://datasets/big.bin", 1 << 16)])
        fail["n"] = 1
        dest = tmp / f"{kind}_out" / "big.bin"
        out.append(await store.get_file("obj://datasets/big.bin", dest))
        out.append((dest.read_bytes() == big, dest.with_name("big.bin.tmp").exists()))

        async def gen():
            for i in range(4):
                yield bytes([i]) * 1000

        out.append(await store.put_stream("obj://datasets/gen.bin", gen()))
        fail["n"] = 2
        await store.put_bytes("obj://datasets/r.bin", b"r" * 64)
        fail["n"] = 10 ** 6
        try:
            await store.exists("obj://datasets/r.bin")
        except IOError as e:
            out.append(("IOError", "503" in str(e)))
        fail["n"] = 0
        out.append(await store.delete_prefix(prefix))
        out.append(await store.list_prefix(prefix))
    finally:
        await store.close()
        await server.close()
    return out, dict(blobs)


def test_every_operation_matches_the_reference_store(tmp_path):
    ref_out, ref_blobs = run(asyncio.wait_for(_sequence("ref", tmp_path), 60))
    port_out, port_blobs = run(asyncio.wait_for(_sequence("port", tmp_path), 60))
    assert port_out == ref_out
    assert port_blobs == ref_blobs
    assert ref_blobs[("datasets", "big.bin")][-4:] == b"tail"


def _service_account(tmp_path, token_uri: str):
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pem = key.private_bytes(serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
                            serialization.NoEncryption()).decode()
    info = {"type": "service_account", "client_email": "sa@proj.iam.gserviceaccount.com",
            "private_key": pem, "token_uri": token_uri}
    path = tmp_path / "sa.json"
    path.write_text(json.dumps(info))
    return info, key, path


async def _token_server():
    """A fake OAuth token endpoint and metadata server: records what each
    request carried, answers a token."""
    posted: list[dict] = []

    async def token(request):
        posted.append(dict(await request.post()))
        return web.json_response({"access_token": f"tok-{len(posted)}", "expires_in": 30})

    async def metadata(request):
        posted.append({"flavor": request.headers.get("Metadata-Flavor")})
        return web.json_response({"access_token": "meta-tok", "expires_in": 3600})

    app = web.Application()
    app.router.add_post("/token", token)
    app.router.add_get("/meta", metadata)
    server = TestServer(app)
    await server.start_server()
    return server, posted


def test_service_account_jwt_equals_the_reference(tmp_path, monkeypatch):
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    async def go():
        server, posted = await _token_server()
        info, key, path = _service_account(tmp_path, str(server.make_url("/token")))
        monkeypatch.setattr(ref_gcs.time, "time", lambda: NOW)
        ref = await ref_gcs._token_from_service_account(str(path))
        port = await port_gcs._token_from_service_account(str(path))
        await server.close()
        return info, key, ref, port, posted

    info, key, ref, port, posted = run(asyncio.wait_for(go(), 30))
    assert (ref, port) == (("tok-1", NOW + 30), ("tok-2", NOW + 30))
    assert posted[0] == posted[1]
    assert posted[0]["grant_type"] == "urn:ietf:params:oauth:grant-type:jwt-bearer"
    assertion = posted[0]["assertion"]
    assert port_gcs.service_account_assertion(info, NOW) == assertion
    # and it verifies with the key's public half
    import base64

    head, payload, sig = assertion.split(".")
    pad = lambda s: s + "=" * (-len(s) % 4)  # noqa: E731
    key.public_key().verify(base64.urlsafe_b64decode(pad(sig)), f"{head}.{payload}".encode(),
                            padding.PKCS1v15(), hashes.SHA256())
    claims = json.loads(base64.urlsafe_b64decode(pad(payload)))
    assert claims == {"iss": info["client_email"], "scope": port_gcs._SCOPE,
                      "aud": info["token_uri"], "iat": int(NOW), "exp": int(NOW) + 3600}


def test_token_provider_chain_matches_the_reference(tmp_path, monkeypatch):
    async def go():
        server, posted = await _token_server()
        meta = str(server.make_url("/meta"))
        monkeypatch.setattr(ref_gcs, "_METADATA_TOKEN_URL", meta)
        monkeypatch.setattr(port_gcs, "_METADATA_TOKEN_URL", meta)
        out = {}
        for name, mod in (("ref", ref_gcs), ("port", port_gcs)):
            monkeypatch.setenv("GOOGLE_OAUTH_ACCESS_TOKEN", "env-tok")
            monkeypatch.delenv("GOOGLE_APPLICATION_CREDENTIALS", raising=False)
            provider = mod.DefaultTokenProvider()
            got = [await provider()]
            monkeypatch.delenv("GOOGLE_OAUTH_ACCESS_TOKEN")
            got += [await provider(), await provider()]  # metadata, then cached
            _, _, path = _service_account(tmp_path / name, str(server.make_url("/token")))
            monkeypatch.setenv("GOOGLE_APPLICATION_CREDENTIALS", str(path))
            fresh = mod.DefaultTokenProvider()
            got += [await fresh(), await fresh()]  # 30 s tokens: refreshed inside 60 s
            out[name] = got
        await server.close()
        return out, posted

    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    out, posted = run(asyncio.wait_for(go(), 60))
    assert out["ref"][:3] == out["port"][:3] == ["env-tok", "meta-tok", "meta-tok"]
    # the fake numbers every request it answers: one metadata fetch, then
    # two token exchanges per package
    assert out["ref"][3:] == ["tok-2", "tok-3"] and out["port"][3:] == ["tok-5", "tok-6"]
    assert [p.get("flavor") for p in posted if "flavor" in p] == ["Google", "Google"]


def test_factory_builds_the_port_store(tmp_path):
    from finetune_controller_tpu_torch.controller.objectstore import LocalObjectStore

    assert isinstance(build_object_store(Settings(object_store_root=str(tmp_path))),
                      LocalObjectStore)
    gcs = build_object_store(Settings(object_store_backend="gcs", gcs_endpoint="http://fake:1",
                                      gcs_bucket_prefix="acme-"))
    assert isinstance(gcs, port_gcs.GCSObjectStore)
    assert (gcs.endpoint, gcs.bucket_prefix) == ("http://fake:1", "acme-")
