"""The port's two zstd decoders against the ``zstandard`` package.

``utils/zstd.py`` (the plain Python decoder) and ``csrc/zstd_decode.cc``
(the native one that ``train/ocdbt.py`` reads checkpoints with, built here
by the host C++ compiler through ``ops/kernels/build.py``) decode:

* a corpus compressed by ``zstandard`` at levels 1, 3 and 19, with and
  without the content checksum: text, float32 and bf16 bit patterns,
  random bytes (raw blocks), zeros (RLE blocks), low-entropy bytes, and
  a 512 KiB input of 128 KiB blocks that repeat an earlier block with
  changes (multi-block frames; RLE literals and RLE, FSE-compressed and
  repeated sequence tables); a check that the corpus reaches every block
  type, literals type and table mode of the plain decoder;
* a 2.5 MiB frame with a 4 MiB window whose matches reach 1 MiB back (long
  distance matching, no dictionary), concatenated and skippable frames,
  and hypothesis-drawn data;
* every chunk of the committed JAX-written checkpoint
  (``tests/fixtures/jax_orbax_tiny``), byte-equal between the two.

Corrupt frames (flipped bytes under a checksum, truncations, a bad magic, a
dictionary id, a reserved bit) are refused by both, naming the byte
offset, and on 150 seeded mutations of small frames the two refuse the
same ones and agree on the rest.  A native library that fails to build raises with the compiler's
output; nothing falls back to the plain decoder.  ``zstandard`` is imported
here only: the port has no dependency on it.  The native decoder's tests
skip, printing why, only where no C++ compiler exists.
"""

from __future__ import annotations

import collections
from pathlib import Path

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from finetune_controller_tpu_torch.ops.kernels import build
from finetune_controller_tpu_torch.train import ocdbt
from finetune_controller_tpu_torch.utils import zstd

FIXTURE = Path(__file__).parent / "fixtures" / "jax_orbax_tiny"
_RNG = np.random.default_rng(0)
_BLOCK = _RNG.bytes(128 * 1024)


def _revised_blocks() -> bytes:
    """Four 128 KiB blocks: random bytes, then three copies with every 40th
    byte replaced (matches 128 KiB back, the same literal run and repeat
    offsets block after block)."""
    out = bytearray(_BLOCK)
    for k in range(1, 4):
        block = bytearray(_BLOCK)
        block[::40] = bytes([k]) * len(block[::40])
        out += block
    return bytes(out)


CORPUS = {
    "text": (Path(__file__).parents[1] / "finetune_controller_tpu" / "train" / "trainer.py")
    .read_bytes()[:60000] * 2,
    "float32": _RNG.standard_normal(64 * 1024).astype(np.float32).tobytes(),
    "bf16": (_RNG.standard_normal(96 * 1024).astype(np.float32).view(np.uint32) >> 16)
    .astype(np.uint16).tobytes(),
    "random": _RNG.bytes(200_000),
    "zeros": bytes(300_000),
    "low_entropy": _RNG.integers(0, 4, 150_000, dtype=np.uint8).tobytes(),
    "revised_blocks": _revised_blocks(),
    "short": b"the quick brown fox jumps over the lazy dog, the quick brown fox again",
    "empty": b"",
}


@pytest.fixture(scope="module")
def native():
    """The native decoder, built with the host compiler; skips (with the
    reason) only where there is none."""
    try:
        build.host_compiler()
    except RuntimeError as e:
        pytest.skip(str(e))
    return ocdbt.zstd_decompress


def _decoders(native):
    return {"plain": zstd.decompress, "native": native}


def _compress(data: bytes, level: int, checksum: bool) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", list(CORPUS))
def test_both_decoders_match_zstandard(native, name, level, checksum):
    data = CORPUS[name]
    frame = _compress(data, level, checksum)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    for which, decode in _decoders(native).items():
        assert decode(frame) == data, which


def test_the_corpus_reaches_every_mode_of_the_plain_decoder(monkeypatch):
    """Each block type, literals type (Huffman with 1 and 4 streams) and
    sequence-table mode of each code is decoded at least once."""
    seen = collections.Counter()
    literals, table, frame = zstd._literals, zstd._sequence_table, zstd._frame

    def spy_literals(data, pos, end, st_, offset):
        kind, fmt = data[pos] & 3, (data[pos] >> 2) & 3
        seen[("literals", kind, 1 if kind >= 2 and fmt == 0 else 4 if kind >= 2 else 0)] += 1
        return literals(data, pos, end, st_, offset)

    def spy_table(name, mode, *args):
        seen[("table", name, mode)] += 1
        return table(name, mode, *args)

    def spy_frame(data, pos, out):
        walk = pos + 1 + (0 if data[pos] & 32 else 1) + (0, 1, 2, 4)[data[pos] & 3]
        walk += (1 if data[pos] & 32 else 0, 2, 4, 8)[data[pos] >> 6]
        while True:
            h = int.from_bytes(data[walk:walk + 3], "little")
            seen[("block", (h >> 1) & 3)] += 1
            walk += 3 + (1 if (h >> 1) & 3 == 1 else h >> 3)
            if h & 1:
                break
        return frame(data, pos, out)

    monkeypatch.setattr(zstd, "_literals", spy_literals)
    monkeypatch.setattr(zstd, "_sequence_table", spy_table)
    monkeypatch.setattr(zstd, "_frame", spy_frame)
    for data in CORPUS.values():
        for level in (1, 3, 19):
            assert zstd.decompress(_compress(data, level, False)) == data
    want = {("block", k) for k in (0, 1, 2)} | {("literals", 0, 0), ("literals", 1, 0),
                                                ("literals", 2, 1), ("literals", 2, 4),
                                                ("literals", 3, 4)}
    want |= {("table", name, mode) for name in ("ll", "of", "ml") for mode in range(4)}
    assert want <= set(seen), sorted(want - set(seen))


def test_a_long_window_without_a_dictionary(native):
    """Matches 1 MiB back, beyond any one block, in a 4 MiB window."""
    first = _RNG.bytes(1 << 20)
    data = first + bytes(1000) + first + first[:500_000]
    params = zstandard.ZstdCompressionParameters.from_level(
        19, window_log=23, enable_ldm=True, write_content_size=False)
    frame = zstandard.ZstdCompressor(compression_params=params).compress(data)
    assert len(frame) < len(first) + 100_000   # the repeats were matched
    wd = frame[5]   # a window descriptor (no single segment) of 4 MiB
    assert not frame[4] & 32 and 1 << (10 + (wd >> 3)) >= 4 << 20
    for which, decode in _decoders(native).items():
        assert decode(frame) == data, which


def test_concatenated_and_skippable_frames(native):
    parts = [CORPUS["text"][:5000], b"", CORPUS["float32"][:3000]]
    skip = (0x184D2A53).to_bytes(4, "little") + (7).to_bytes(4, "little") + b"ignored"
    stream = skip + b"".join(_compress(p, 3, i % 2 == 0) + skip for i, p in enumerate(parts))
    for which, decode in _decoders(native).items():
        assert decode(stream) == b"".join(parts), which


words = st.lists(st.sampled_from([b"alpha", b"beta", b"gamma", b"\x00\x01", b"zz"]),
                 max_size=400).map(b"".join)


@settings(max_examples=60, deadline=None)
@given(data=st.one_of(st.binary(max_size=3000), words), level=st.sampled_from([1, 3, 19]),
       checksum=st.booleans())
def test_hypothesis_data(native, data, level, checksum):
    frame = _compress(data, level, checksum)
    assert zstd.decompress(frame) == data
    assert native(frame) == data


def test_xxh64_is_the_checksum_zstandard_writes():
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 4097):
        data = CORPUS["random"][:n]
        frame = _compress(data, 3, True)
        assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:], "little"), n
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999   # XXH64's published empty-input value


def _corrupt_cases() -> dict[str, bytes]:
    good = _compress(CORPUS["text"][:20000], 3, True)
    cases = {f"flip@{i}": good[:i] + bytes([good[i] ^ 0x10]) + good[i + 1:]
             for i in range(5, len(good), max(1, len(good) // 40))}
    cases.update({
        "truncated": good[:len(good) // 2],
        "no_checksum_bytes": good[:-4],
        "bad_magic": b"\x28\xb5\x2f\xfe" + good[4:],
        "reserved_bit": good[:4] + bytes([good[4] | 8]) + good[5:],
        "dictionary": b"\x28\xb5\x2f\xfd\x01\x00\x07" + good[6:],
        "trailing_garbage": good + b"\x01\x02",
    })
    return cases


@pytest.mark.parametrize("case", list(_corrupt_cases()))
def test_corrupt_frames_are_refused_by_both(native, case):
    frame = _corrupt_cases()[case]
    with pytest.raises(zstd.ZstdError, match=r"at byte \d+"):
        zstd.decompress(frame)
    with pytest.raises(ocdbt.OcdbtError, match=r"at byte \d+"):
        native(frame)


def test_both_decoders_agree_on_mutated_frames(native):
    """150 seeded mutations (bit flips, replaced bytes, truncations) of
    small frames: both decoders refuse each, or both give the same bytes."""
    import random

    rng = random.Random(0)
    bases = [(_compress(CORPUS[name][:size], level, checksum), size)
             for name, size in (("text", 4000), ("float32", 6000), ("revised_blocks", 8000),
                                ("low_entropy", 5000))
             for level in (1, 19) for checksum in (False, True)]
    for case in range(150):
        frame, size = rng.choice(bases)
        frame = bytearray(frame)
        if case % 3 == 0:
            frame[rng.randrange(5, len(frame))] ^= 1 << rng.randrange(8)
        elif case % 3 == 1:
            frame[rng.randrange(5, len(frame))] = rng.randrange(256)
        else:
            frame = frame[:rng.randrange(5, len(frame))]
        frame = bytes(frame)
        try:
            want = zstd.decompress(frame)
        except zstd.ZstdError:
            with pytest.raises(ocdbt.OcdbtError):
                native(frame)
            continue
        assert native(frame) == want, case


def test_both_decoders_agree_on_every_chunk_of_a_jax_checkpoint(native):
    """Every zstd-compressed value of the committed JAX-written checkpoint
    (the trainer's state and the 1 MB bf16 array) decodes byte-equal."""
    n = 0
    for step in (FIXTURE / "checkpoints" / "step_2", FIXTURE / "large" / "step_0"):
        store = ocdbt.open_step(step)
        for key in store.keys():
            value = store.get(key)
            if key.endswith(".zarray") or not value.startswith(b"\x28\xb5\x2f\xfd"):
                continue
            assert zstd.decompress(value) == native(value), key
            n += 1
    assert n >= 20


def test_a_native_build_failure_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """No quiet fallback: a compiler error reaches the reader's caller."""
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'zstd_decode.cc:1: error: simulated failure'\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "HOST_FLAGS", build.HOST_FLAGS + ("-DFTC_TEST_REBUILD",))
    ocdbt._native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="simulated failure"):
            ocdbt.zstd_decompress(_compress(b"abc", 3, False))
    finally:
        ocdbt._native.cache_clear()
