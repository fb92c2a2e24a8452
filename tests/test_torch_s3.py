"""The port's S3 object store (``controller/s3.py`` on ``controller/
httpclient.py``) against the reference's.

``sigv4_headers`` equals the reference's header for header, on the AWS
known-answer vector and on hypothesis-drawn requests (methods, paths with
spaces and non-ASCII, repeated query keys, session tokens, extra signed
headers).  The reference's fake S3 (``tests/test_s3.py``), which re-derives
and verifies every request's signature, serves the same sequence of
``ObjectStore`` operations from the reference's store and the port's: the
answers and the buckets' bytes are equal.  Covered: put/get/exists/size,
paginated listing, server-side copy, DeleteObjects batching, streamed
reads, download to a file with its atomic rename, a 2-part multipart upload
above the threshold, an unknown-length stream spooled through a temp file,
retries on 503, a persistent 503 raising, a wrong secret refused (403) and
the factory.  Tolerance: exact.
"""

from __future__ import annotations

import asyncio
import zipfile

from aiohttp import web
from aiohttp.test_utils import TestServer
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from conftest import run_async as run
from finetune_controller_tpu.controller import s3 as ref_s3
from finetune_controller_tpu_torch.controller import s3 as port_s3
from finetune_controller_tpu_torch.controller.config import Settings
from finetune_controller_tpu_torch.controller.objectstore import artifacts_prefix, build_object_store
from test_s3 import ACCESS, REGION, SECRET, make_fake_s3

STORES = {"ref": ref_s3.S3ObjectStore, "port": port_s3.S3ObjectStore}


def test_sigv4_known_answer_vector():
    kw = dict(payload_hash=port_s3.EMPTY_SHA256, access_key="AKIDEXAMPLE",
              secret_key="wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY", region="us-east-1",
              service="iam", amz_date="20150830T123600Z",
              extra_headers={"content-type": "application/x-www-form-urlencoded; charset=utf-8"},
              include_content_sha=False)
    args = ("GET", "iam.amazonaws.com", "/", [("Action", "ListUsers"), ("Version", "2010-05-08")])
    port = port_s3.sigv4_headers(*args, **kw)
    assert port["authorization"].endswith(
        "Signature=5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06b5924a6f2b5d7")
    assert port == ref_s3.sigv4_headers(*args, **kw)
    assert port_s3.EMPTY_SHA256 == ref_s3.EMPTY_SHA256 and port_s3.UNSIGNED == ref_s3.UNSIGNED


_text = st.text(st.characters(codec="utf-8", exclude_categories=("Cs",)), max_size=24)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(method=st.sampled_from(["GET", "PUT", "POST", "HEAD", "DELETE"]),
       host=st.sampled_from(["s3.amazonaws.com", "127.0.0.1:9000", "minio.local"]),
       path=st.lists(_text, max_size=4).map(lambda p: "/" + "/".join(p)),
       query=st.lists(st.tuples(_text, _text), max_size=4),
       payload=st.binary(max_size=64),
       secret=st.text(min_size=1, max_size=40),
       token=st.one_of(st.none(), st.text(min_size=1, max_size=30)),
       region=st.sampled_from(["us-east-1", "eu-west-7", "ap-south-2"]),
       stamp=st.datetimes().map(lambda d: d.strftime("%Y%m%dT%H%M%SZ")),
       extra=st.dictionaries(st.sampled_from(["content-md5", "x-amz-copy-source",
                                              "Content-Type", "x-amz-meta-a"]),
                             st.text(st.characters(min_codepoint=32, max_codepoint=126),
                                     max_size=20), max_size=3),
       content_sha=st.booleans())
def test_sigv4_headers_equal_the_reference(method, host, path, query, payload, secret, token,
                                           region, stamp, extra, content_sha):
    import hashlib

    kw = dict(payload_hash=hashlib.sha256(payload).hexdigest(), access_key="AKIDFAKE",
              secret_key=secret, session_token=token, region=region, amz_date=stamp,
              extra_headers=extra, include_content_sha=content_sha)
    assert port_s3.sigv4_headers(method, host, path, query, **kw) == \
        ref_s3.sigv4_headers(method, host, path, query, **kw)


async def _store(kind: str, app, **kw):
    server = TestServer(app)
    await server.start_server()

    async def creds():
        return ACCESS, SECRET, None

    store = STORES[kind](endpoint=str(server.make_url("")).rstrip("/"), region=REGION,
                         creds_fn=creds, **kw)
    store.retry_base_delay = 0.0
    return store, server


def _flaky(app):
    fail = {"n": 0}
    log: list[tuple[str, bool]] = []

    @web.middleware
    async def flaky(request, handler):
        log.append((request.method, "delete" in request.query))
        if fail["n"] > 0:
            fail["n"] -= 1
            return web.Response(status=503, text="transient")
        return await handler(request)

    app.middlewares.append(flaky)
    return fail, log


async def _sequence(kind: str, tmp) -> tuple[list, dict]:
    """Every ObjectStore operation, against a fresh fake; returns the
    answers and the fake's buckets."""
    app, blobs, seen = make_fake_s3(page_size=2)
    fail, log = _flaky(app)
    store, server = await _store(kind, app, multipart_threshold=1 << 20, part_size=1 << 20)
    out: list = []
    try:
        prefix = artifacts_prefix("artifacts", "u", "job1")
        await store.put_bytes(f"{prefix}/a.bin", b"A" * 10)
        await store.put_bytes(f"{prefix}/sub/b.bin", b"B" * 20)
        await store.put_bytes(f"{prefix}/c.csv", b"step,loss\n1,2.0\n2,1.5\n")
        out += [await store.exists(f"{prefix}/a.bin"), await store.exists(f"{prefix}/nope"),
                await store.get_bytes(f"{prefix}/sub/b.bin"), await store.size(f"{prefix}/a.bin")]
        try:
            await store.get_bytes(f"{prefix}/nope")
        except FileNotFoundError as e:
            out.append(("FileNotFoundError", str(e)))
        out.append(await store.list_prefix(prefix))  # 3 objects, pages of 2
        out.append(await store.copy_prefix(prefix, "obj://deploy/models/x/job1"))
        out.append(await store.copy_prefix(f"{prefix}/a.bin", "obj://deploy/one.bin"))
        out.append(await store.get_metrics_records(prefix))
        # multipart above the threshold: 2 MiB + 3 bytes -> 3 parts
        big = bytes(range(256)) * 8192 + b"end"
        (tmp / f"{kind}_big.bin").write_bytes(big)
        await store.put_file("obj://datasets/big.bin", tmp / f"{kind}_big.bin")
        chunks = [c async for c in store.get_chunks("obj://datasets/big.bin", 1 << 16)]
        out.append([len(c) for c in chunks])
        dest = tmp / f"{kind}_out" / "big.bin"
        out.append(await store.get_file("obj://datasets/big.bin", dest))
        out.append((dest.read_bytes() == big, dest.with_name("big.bin.tmp").exists()))

        async def gen():
            for i in range(5):
                yield bytes([i]) * 300_000

        out.append(await store.put_stream("obj://datasets/gen.bin", gen()))
        out.append(await store.zip_prefix_to_path(prefix, tmp / f"{kind}.zip"))
        out.append(sorted(zipfile.ZipFile(tmp / f"{kind}.zip").namelist()))
        # two 503s, then success; a whole-transfer retry of a download
        fail["n"] = 2
        await store.put_bytes("obj://datasets/r.bin", b"r" * 64)
        fail["n"] = 1
        out.append(await store.get_file("obj://datasets/r.bin", tmp / f"{kind}_r.bin"))
        fail["n"] = 10 ** 6
        try:
            await store.exists("obj://datasets/r.bin")
        except IOError as e:
            out.append(("IOError", "503" in str(e)))
        fail["n"] = 0
        # keys with spaces; one DeleteObjects request for the prefix
        await store.put_bytes("obj://datasets/sp aced/a b.bin", b"x")
        await store.put_bytes("obj://datasets/sp aced/c.bin", b"y")
        log.clear()
        out.append(await store.delete_prefix("obj://datasets/sp aced"))
        out.append([r for r in log if r[1]])
        out.append(await store.delete_prefix(prefix))
        out.append(await store.list_prefix(prefix))
        out.append(len(seen) > 20)
    finally:
        await store.close()
        await server.close()
    return out, dict(blobs)


def test_every_operation_matches_the_reference_store(tmp_path):
    ref_out, ref_blobs = run(asyncio.wait_for(_sequence("ref", tmp_path), 60))
    port_out, port_blobs = run(asyncio.wait_for(_sequence("port", tmp_path), 60))
    assert port_out == ref_out
    assert port_blobs == ref_blobs
    assert ref_blobs[("datasets", "big.bin")][-3:] == b"end"
    assert len(ref_blobs[("datasets", "gen.bin")]) == 1_500_000


def test_tampered_secret_is_refused():
    async def go():
        app, _, _ = make_fake_s3()
        store, server = await _store("port", app)

        async def bad_creds():
            return ACCESS, "wrong-secret", None

        store._creds_fn = bad_creds
        try:
            await store.put_bytes("obj://datasets/x", b"data")
            raise AssertionError("expected signature rejection")
        except IOError as e:
            assert "403" in str(e)
        finally:
            await store.close()
            await server.close()

    run(asyncio.wait_for(go(), 30))


def test_env_credentials_and_factory(monkeypatch):
    monkeypatch.delenv("AWS_ACCESS_KEY_ID", raising=False)
    monkeypatch.delenv("AWS_SECRET_ACCESS_KEY", raising=False)
    for mod in (ref_s3, port_s3):
        try:
            run(mod.env_credentials())
            raise AssertionError("expected a missing-credentials error")
        except RuntimeError as e:
            assert "AWS_ACCESS_KEY_ID" in str(e)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "k")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "s")
    monkeypatch.setenv("AWS_SESSION_TOKEN", "t")
    assert run(port_s3.env_credentials()) == run(ref_s3.env_credentials()) == ("k", "s", "t")
    store = build_object_store(Settings(object_store_backend="s3", s3_endpoint="http://fake:1",
                                        s3_region="eu-west-7", s3_bucket_prefix="acme-"))
    assert isinstance(store, port_s3.S3ObjectStore)
    assert (store.endpoint, store.region) == ("http://fake:1", "eu-west-7")
    assert store._path("obj://datasets/a/b") == "/acme-datasets/a/b"
