"""The port's safetensors reader and writer against the ``safetensors``
package (exact: the bytes are copied, never converted).

* the port's writer gives files ``safetensors.safe_open`` reads equal, and
  the port reads the package's files equal, for F32, F16, BF16, I64 (and
  the other codes), empty tensors and ``__metadata__``, over hypothesis-drawn
  shapes and dtypes;
* a sharded directory is read through its ``model.safetensors.index.json``;
* the streaming writer refuses a tensor out of its declared order, dtype or
  shape, and a file whose declared tensors did not all come.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from safetensors import safe_open
from safetensors.torch import save_file as st_save

from finetune_controller_tpu_torch.models import safetensors_io as sio

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32,
          torch.uint8, torch.int8, torch.bool, torch.float64]


def _tensor(rng, dtype, shape) -> torch.Tensor:
    if dtype == torch.bool:
        return torch.from_numpy(np.asarray(rng.random(shape) > 0.5))
    if dtype.is_floating_point:
        return torch.from_numpy(np.asarray(rng.standard_normal(shape), np.float32)).to(dtype)
    info = torch.iinfo(dtype)
    return torch.from_numpy(np.asarray(rng.integers(info.min, info.max, shape))).to(dtype)


tensors_st = st.lists(
    st.tuples(st.sampled_from(DTYPES),
              st.lists(st.integers(0, 5), min_size=0, max_size=3)),
    min_size=1, max_size=6,
)


def _build(spec, seed):
    rng = np.random.default_rng(seed)
    return {f"t{i}.weight": _tensor(rng, dtype, tuple(shape))
            for i, (dtype, shape) in enumerate(spec)}


def _save(tensors: dict, path, metadata=None) -> None:
    """The port's streaming writer, fed ``tensors`` in order."""
    with sio.StreamWriter(path, [(k, v.dtype, v.shape) for k, v in tensors.items()],
                          metadata) as writer:
        for name, tensor in tensors.items():
            writer.write(name, tensor)


def _load(path) -> dict:
    reader = sio.SafetensorsFile(path)
    return {name: reader.get_tensor(name) for name in reader.keys()}


def _assert_same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key


SETTINGS = settings(max_examples=25, deadline=None,
                    suppress_health_check=[HealthCheck.function_scoped_fixture])


@SETTINGS
@given(spec=tensors_st, seed=st.integers(0, 2**16))
def test_port_writer_is_read_by_the_package(tmp_path, spec, seed):
    tensors = _build(spec, seed)
    path = tmp_path / "port.safetensors"
    _save(tensors, path, metadata={"format": "pt", "step": 7})
    with safe_open(str(path), "pt") as f:
        assert f.metadata() == {"format": "pt", "step": "7"}
        _assert_same({k: f.get_tensor(k) for k in f.keys()}, tensors)


@SETTINGS
@given(spec=tensors_st, seed=st.integers(0, 2**16))
def test_port_reader_reads_the_package(tmp_path, spec, seed):
    tensors = _build(spec, seed)
    path = tmp_path / "package.safetensors"
    st_save(tensors, str(path), metadata={"format": "pt"})
    reader = sio.SafetensorsFile(path)
    assert reader.metadata() == {"format": "pt"}
    assert all(reader.dtype(k) == v.dtype and reader.shape(k) == list(v.shape)
               for k, v in tensors.items())
    _assert_same(_load(path), tensors)


def test_no_metadata_and_views_outlive_the_reader(tmp_path):
    tensors = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    st_save(tensors, str(tmp_path / "x.safetensors"))
    with sio.SafetensorsFile(tmp_path / "x.safetensors") as reader:
        assert reader.metadata() is None
        view = reader.get_tensor("a")
    view.add_(1.0)  # a copy-on-write map: the file keeps its bytes
    assert torch.equal(view, tensors["a"] + 1.0)
    _assert_same(_load(tmp_path / "x.safetensors"), tensors)


def test_sharded_directory_reads_through_its_index(tmp_path):
    rng = np.random.default_rng(0)
    shards = [{"b.weight": _tensor(rng, torch.bfloat16, (4, 3))},
              {"a.weight": _tensor(rng, torch.float32, (2,)),
               "c.weight": _tensor(rng, torch.int64, (3,))}]
    names = ["model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"]
    for name, shard in zip(names, shards):
        st_save(shard, str(tmp_path / name))
    (tmp_path / "stray.safetensors").write_bytes(b"")  # not in the index: not read
    weight_map = {k: name for name, shard in zip(names, shards) for k in shard}
    (tmp_path / sio.INDEX_FILENAME).write_text(json.dumps({"weight_map": weight_map}))
    assert [p.name for p in sio.checkpoint_files(tmp_path)] == names
    got = dict(sio.iter_dir_tensors(tmp_path))
    _assert_same(got, {**shards[0], **shards[1]})
    (tmp_path / names[1]).unlink()
    with pytest.raises(FileNotFoundError, match="not there"):
        sio.checkpoint_files(tmp_path)


def test_stream_writer_refuses_what_was_not_declared(tmp_path):
    specs = [("a", torch.float32, (2,)), ("b", torch.bfloat16, (3, 1))]
    with pytest.raises(ValueError, match="expected 'a'"):
        with sio.StreamWriter(tmp_path / "x.safetensors", specs) as w:
            w.write("b", torch.zeros(3, 1, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="expected 'a' torch.float32"):
        with sio.StreamWriter(tmp_path / "x.safetensors", specs) as w:
            w.write("a", torch.zeros(2, dtype=torch.float16))
    with pytest.raises(ValueError, match="never written, first 'b'"):
        with sio.StreamWriter(tmp_path / "x.safetensors", specs) as w:
            w.write("a", torch.zeros(2))
    with sio.StreamWriter(tmp_path / "x.safetensors", specs) as w:
        w.write("a", torch.ones(2))
        w.write("b", torch.ones(6, dtype=torch.bfloat16)[::2].reshape(3, 1))  # strided
        with pytest.raises(ValueError, match="not declared"):
            w.write("c", torch.ones(1))
    assert w.nbytes == (tmp_path / "x.safetensors").stat().st_size
    with safe_open(str(tmp_path / "x.safetensors"), "pt") as f:
        assert torch.equal(f.get_tensor("b"), torch.ones(3, 1, dtype=torch.bfloat16))
