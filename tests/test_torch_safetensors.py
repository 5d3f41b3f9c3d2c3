"""The port's own safetensors reader and writer against the ``safetensors``
package (both directions, every dtype the port reads), and the checkpoint
file resolution against the JAX package's.  Exact: bytes round-trip."""

import json
import os
import struct

import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load
from safetensors.torch import save_file as st_save

from s2v_tpu.loaders import safetensors_io as jax_io
from s2v_torch.loaders.safetensors_io import (
    DTYPES,
    best_guess_lora_file,
    load_safetensors,
    load_sharded_safetensors,
    save_safetensors,
)


def _tensor(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), shape, generator=g, dtype=torch.int64).to(dtype)


def _all_dtypes(odd=False):
    """One tensor of each dtype; ``odd`` sizes leave each end off an 8-byte boundary."""
    shapes = [(3, 5, 7), (1,), (2, 3), (5,), (), (4, 1, 3), (7,), (3, 3)] if odd else [(4, 8)] * len(DTYPES)
    return {f"t_{name.lower()}": _tensor(dt, shape, i) for i, ((name, dt), shape) in enumerate(zip(DTYPES.items(), shapes))}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("odd", [False, True], ids=["aligned", "odd_sizes"])
def test_port_reads_package_files(tmp_path, odd):
    tensors = _all_dtypes(odd)
    st_save(tensors, str(tmp_path / "a.safetensors"))
    _assert_same(load_safetensors(str(tmp_path / "a.safetensors")), tensors)


@pytest.mark.parametrize("odd", [False, True], ids=["aligned", "odd_sizes"])
def test_package_reads_port_files(tmp_path, odd):
    tensors = _all_dtypes(odd)
    save_safetensors(tensors, str(tmp_path / "a.safetensors"))
    _assert_same(st_load(str(tmp_path / "a.safetensors")), tensors)
    raw = (tmp_path / "a.safetensors").read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    assert (8 + n) % 8 == 0  # the header is padded so the data starts 8-aligned


def test_non_contiguous_inputs_write_their_values(tmp_path):
    """A transposed view, a strided slice and a numpy transpose are written
    with their own values and shapes, never their buffers."""
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    tensors = {"t": base.T, "s": base[:, ::2], "n": np.arange(12, dtype=np.int32).reshape(3, 4).T}
    save_safetensors(tensors, str(tmp_path / "a.safetensors"))
    got = st_load(str(tmp_path / "a.safetensors"))
    assert torch.equal(got["t"], base.T.contiguous()) and torch.equal(got["s"], base[:, ::2].contiguous())
    assert torch.equal(got["n"], torch.from_numpy(np.ascontiguousarray(tensors["n"])))


def test_empty_dict_and_empty_tensor(tmp_path):
    save_safetensors({}, str(tmp_path / "e.safetensors"))
    assert load_safetensors(str(tmp_path / "e.safetensors")) == {}
    assert st_load(str(tmp_path / "e.safetensors")) == {}
    st_save({}, str(tmp_path / "p.safetensors"))
    assert load_safetensors(str(tmp_path / "p.safetensors")) == {}
    zero = {"z": torch.zeros((0, 3)), "x": torch.ones(2, dtype=torch.bfloat16)}
    save_safetensors(zero, str(tmp_path / "z.safetensors"))
    _assert_same(st_load(str(tmp_path / "z.safetensors")), zero)
    st_save(zero, str(tmp_path / "zp.safetensors"))
    _assert_same(load_safetensors(str(tmp_path / "zp.safetensors")), zero)


def test_metadata_is_read_past(tmp_path):
    """A file with a ``__metadata__`` entry (as ``save_pretrained`` of
    transformers writes) reads as its tensors alone."""
    t = {"w": torch.randn(3, 2), "b": torch.arange(3, dtype=torch.int32)}
    st_save(t, str(tmp_path / "p.safetensors"), metadata={"format": "pt", "note": "x"})
    _assert_same(load_safetensors(str(tmp_path / "p.safetensors")), t)


def test_write_casts_and_read_is_writable_without_touching_the_file(tmp_path):
    path = str(tmp_path / "c.safetensors")
    save_safetensors({"w": torch.randn(4, 4)}, path, dtype=torch.bfloat16)
    got = load_safetensors(path)["w"]
    assert got.dtype == torch.bfloat16
    before = open(path, "rb").read()
    got.add_(1.0)  # a private mapping: the file keeps its bytes
    assert open(path, "rb").read() == before


def test_sharded_index_layouts(tmp_path):
    parts = {"a": torch.randn(2, 3), "b": torch.randn(4), "c": torch.arange(5, dtype=torch.int64)}
    for index_name in ("diffusion_pytorch_model.safetensors.index.json", "model.safetensors.index.json"):
        d = tmp_path / index_name.split(".")[0]
        d.mkdir()
        st_save({"a": parts["a"], "b": parts["b"]}, str(d / "shard-00001.safetensors"))
        save_safetensors({"c": parts["c"]}, str(d / "shard-00002.safetensors"))
        weight_map = {"a": "shard-00001.safetensors", "b": "shard-00001.safetensors", "c": "shard-00002.safetensors"}
        (d / index_name).write_text(json.dumps({"metadata": {}, "weight_map": weight_map}))
        _assert_same(load_sharded_safetensors(str(d)), parts)
        jax_side = jax_io.load_sharded_safetensors(str(d))
        assert sorted(jax_side) == sorted(parts)
    single = tmp_path / "single"
    single.mkdir()
    save_safetensors(parts, str(single / "weights_any_name.safetensors"))
    _assert_same(load_sharded_safetensors(str(single)), parts)
    two = tmp_path / "two"
    two.mkdir()
    for name in ("x.safetensors", "y.safetensors"):
        save_safetensors(parts, str(two / name))
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        load_sharded_safetensors(str(two))


def _resolve(fn, path):
    try:
        return os.path.basename(fn(path))
    except FileNotFoundError as e:
        return ("error", str(e).split(", found")[0])


@pytest.mark.parametrize("files", [
    ["pytorch_lora_weights.safetensors", "optimizer.bin", "scheduler.bin", "random_states_0.pkl"],
    ["pytorch_lora_weights.safetensors", "ema_model.safetensors", "optimizer.safetensors"],
    ["model.safetensors", "scheduler.safetensors", "random_states_0.safetensors"],
    ["a.safetensors", "b.safetensors"],
    ["optimizer.safetensors", "notes.txt"],
], ids=["accelerate_layout", "filters_ema_and_optimizer", "filters_scheduler_random_states", "two_left", "none_left"])
def test_best_guess_lora_file_matches_jax(tmp_path, files):
    for name in files:
        (tmp_path / name).write_bytes(b"")
    want = _resolve(jax_io.best_guess_lora_file, str(tmp_path))
    assert _resolve(best_guess_lora_file, str(tmp_path)) == want
    if sum(f.endswith(".safetensors") and not any(s in f for s in ("optimizer", "scheduler", "ema", "random"))
           for f in files) != 1:
        assert want[0] == "error"
    one = str(tmp_path / files[0])
    assert best_guess_lora_file(one) == jax_io.best_guess_lora_file(one) == one
