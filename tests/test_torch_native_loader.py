"""The port's native JSONL packer (``csrc/packer.cc``,
``data/native_loader.py``) against the JAX package's native packer and its
Python loader.

On every row schema of ``tests/test_native.py`` (plain LM text and tokens,
escapes, raw UTF-8, nested keys, SFT prompt/completion as text and tokens,
chat messages escaped and raw) and several block lengths, the port's
packed (tokens, segments, loss flags) arrays are bit-equal to the
reference's ``pack_jsonl_native`` and to the reference's Python path
(tolerance: none).  Also pinned: the error contract, the loader's native
path and its fall-through to the Python loader with the reference's
``ValueError``, ``FTC_NATIVE=0``, and a build failure that raises with the
compiler's output instead of falling back.  The library is built with the
host ``g++`` at first use.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
from test_native import CHAT_ROWS, SFT_ROWS, TRICKY_ROWS

from finetune_controller_tpu.data import loader as ref_loader
from finetune_controller_tpu.data.native_loader import pack_jsonl_native as ref_pack_native
from finetune_controller_tpu_torch.data import loader, native_loader
from finetune_controller_tpu_torch.ops.kernels import build

NESTED_ROWS = [
    {"id": "a", "text": "hello world", "meta": {"tokens": [9, 9, 9]}},
    {"meta": {"tokens": 5}, "text": "hi"},
]


def _write_jsonl(path, rows, ascii_only=True):
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=ascii_only) + "\n")
    return str(path)


SCHEMAS = {
    "tricky": (TRICKY_ROWS, True),
    "tricky-raw": (TRICKY_ROWS, False),
    "nested": (NESTED_ROWS, True),
    "sft": (SFT_ROWS, True),
    "sft-raw": (SFT_ROWS, False),
    "chat": (CHAT_ROWS, True),
    "chat-raw": (CHAT_ROWS, False),
    "mixed": (TRICKY_ROWS + SFT_ROWS + CHAT_ROWS + NESTED_ROWS, True),
}


@pytest.mark.parametrize("seq_len", [16, 64, 1024])
@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_native_pack_bit_equal_to_the_reference(tmp_path, schema, seq_len):
    rows, ascii_only = SCHEMAS[schema]
    path = _write_jsonl(tmp_path / "d.jsonl", rows, ascii_only)
    port = native_loader.pack_jsonl_native(path, seq_len)
    ref = ref_pack_native(path, seq_len)
    py = ref_loader.pack_documents(ref_loader.load_token_documents(path), seq_len)
    assert port is not None and ref is not None
    for got, want_native, want_py in zip(port, ref, py):
        assert got.dtype == want_native.dtype == want_py.dtype
        np.testing.assert_array_equal(got, want_native)
        np.testing.assert_array_equal(got, want_py)


def test_jsonl_token_batches_take_the_native_path(tmp_path, caplog):
    path = _write_jsonl(tmp_path / "sft.jsonl", SFT_ROWS * 8)
    before = native_loader.packs_total
    with caplog.at_level("INFO"):
        port = loader.jsonl_token_batches(path, batch_size=2, seq_len=32, seed=3)
        got = [next(port) for _ in range(4)]
    assert native_loader.packs_total == before + 1
    assert any("native packer produced" in r.message for r in caplog.records)
    ref = ref_loader.jsonl_token_batches(path, batch_size=2, seq_len=32, seed=3)
    for g, w in zip(got, (next(ref) for _ in range(4))):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_native_error_contract(tmp_path):
    bad = _write_jsonl(tmp_path / "bad.jsonl", [{"neither": 1}])
    with pytest.raises(ValueError, match="native packer failed"):
        native_loader.pack_jsonl_native(bad, 16)
    with pytest.raises(ValueError, match="native packer failed"):
        native_loader.pack_jsonl_native(str(tmp_path / "nope.jsonl"), 16)
    wrong_role = _write_jsonl(tmp_path / "role.jsonl",
                              [{"messages": [{"role": "model", "content": "hi"}]}])
    with pytest.raises(ValueError):
        native_loader.pack_jsonl_native(wrong_role, 16)


@pytest.mark.parametrize("rows", [
    [{"neither": 1}],
    [{"messages": [{"role": "model", "content": "hi"}]}],
], ids=["no-schema", "all-masked-chat"])
def test_rows_the_packer_cannot_own_raise_the_reference_error(tmp_path, rows):
    path = _write_jsonl(tmp_path / "bad.jsonl", rows)
    with pytest.raises(ValueError) as want:
        ref_loader.jsonl_token_batches(path, batch_size=2, seq_len=16)
    with pytest.raises(ValueError) as got:
        loader.jsonl_token_batches(path, batch_size=2, seq_len=16)
    assert str(got.value) == str(want.value)


def test_non_string_chat_content_goes_to_the_python_loader(tmp_path):
    """A row the packer will not stringify falls through to the Python
    loader, which takes it, as in the reference."""
    rows = [{"messages": [{"role": "user", "content": 5},
                          {"role": "assistant", "content": ["x", 1]}]}] * 4
    path = _write_jsonl(tmp_path / "odd.jsonl", rows)
    with pytest.raises(ValueError):
        native_loader.pack_jsonl_native(path, 16)
    got = next(loader.jsonl_token_batches(path, batch_size=2, seq_len=16))
    want = next(ref_loader.jsonl_token_batches(path, batch_size=2, seq_len=16))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_native_disabled_by_env(tmp_path, monkeypatch):
    path = _write_jsonl(tmp_path / "d.jsonl", TRICKY_ROWS)
    monkeypatch.setenv("FTC_NATIVE", "0")
    assert native_loader.pack_jsonl_native(path, 16) is None
    before = native_loader.packs_total
    batch = next(loader.jsonl_token_batches(path, batch_size=2, seq_len=16))
    assert native_loader.packs_total == before
    want = next(ref_loader.jsonl_token_batches(path, batch_size=2, seq_len=16))
    np.testing.assert_array_equal(batch["tokens"], want["tokens"])


def test_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No quiet fallback: a packer that does not compile raises from the
    loader with the compiler's words (the reference falls back to Python)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "packer.cc").write_text("int broken( {\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    native_loader._library.cache_clear()
    path = _write_jsonl(tmp_path / "d.jsonl", TRICKY_ROWS)
    try:
        with pytest.raises(RuntimeError, match=r"failed on csrc/packer\.cc[\s\S]*error"):
            loader.jsonl_token_batches(path, batch_size=2, seq_len=16)
    finally:
        native_loader._library.cache_clear()
