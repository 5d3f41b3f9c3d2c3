"""The single-card train state (``s2v_torch/loaders/train_state.py``, the
port's stand-in for ``s2v_tpu/loaders/orbax_io.py``): a round trip of the
trees the trainer saves is exact (tolerance 0: raw bytes through
safetensors), and loading into a tree of another shape raises, naming the
first difference, which the trainer CLI wraps in JAX's ``_RESUME_MISMATCH``
text (``s2v_tpu/train.py:162-170``; ``tests/test_torch_train_cli.py``)."""

import os

import pytest
import torch

from s2v_torch.loaders.train_state import TENSORS_FILE, TREE_FILE, load_train_state, save_train_state
from s2v_torch.training import optim


def _lora_state(acc_steps=2, optimizer="adamw", moment_dtype="float32"):
    g = torch.Generator().manual_seed(0)
    lora = {"qkv": {"a": torch.randn(2, 8, 4, generator=g), "b": torch.randn(2, 4, 24, generator=g)},
            "text_proj": {"a": torch.randn(6, 4, generator=g), "b": torch.zeros(4, 8)}}
    leaves = [lora[n][k] for n in sorted(lora) for k in ("a", "b")]
    opt = optim.make_optimizer(optim.OptimizerSpec(optimizer=optimizer, gradient_accumulation_steps=acc_steps,
                                                   moment_dtype=moment_dtype))
    state = opt.init(leaves)
    for i in range(3):  # move the state off its zeros
        opt.step(leaves, [torch.randn(x.shape, generator=g) for x in leaves], state)
    return {"lora": lora, "opt_state": state, "step": 3}


def _equal(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("kind", ["adamw_accumulate", "adam_bf16_moments", "prodigy", "full_ema"])
def test_round_trip_is_exact(tmp_path, kind):
    if kind == "adamw_accumulate":
        state = _lora_state()
    elif kind == "adam_bf16_moments":
        state = _lora_state(acc_steps=1, optimizer="adam", moment_dtype="bfloat16")
    elif kind == "prodigy":
        state = _lora_state(acc_steps=1, optimizer="prodigy")
    else:  # full mode: the params in bf16 and the optimizer state paired with the EMA tree
        inner = _lora_state()
        params = {"blocks": [{"w": torch.randn(3, 3).bfloat16()} for _ in range(2)], "proj_out": {"b": torch.ones(3)}}
        state = {"params": params, "opt_state": (inner["opt_state"], {k: v for k, v in params.items()}), "step": 7}
    path = save_train_state(state, str(tmp_path / "train_state_3"))
    assert sorted(os.listdir(path)) == [TENSORS_FILE, TREE_FILE]
    fresh = _lora_state() if kind == "adamw_accumulate" else state
    back = load_train_state(path, fresh)
    assert _equal(back, state)
    # the loaded tensors are copies: the directory can be replaced under them
    save_train_state({"x": torch.zeros(1)}, path)
    assert _equal(back, state)


def test_save_replaces_a_state_and_leaves_no_temporary(tmp_path):
    path = str(tmp_path / "train_state_1")
    save_train_state(_lora_state(), path)
    save_train_state(_lora_state(acc_steps=1), path)
    assert sorted(os.listdir(tmp_path)) == ["train_state_1"]
    assert "acc" not in load_train_state(path, _lora_state(acc_steps=1))["opt_state"]


@pytest.mark.parametrize("change", ["accumulation", "optimizer", "rank", "step_type", "container"])
def test_mismatch_raises_naming_the_path(tmp_path, change):
    path = save_train_state(_lora_state(), str(tmp_path / "s"))
    target = {
        "accumulation": lambda: _lora_state(acc_steps=1),  # no mini_step / acc
        "optimizer": lambda: _lora_state(optimizer="prodigy"),
        "rank": lambda: {**_lora_state(), "lora": {**_lora_state()["lora"],
                                                   "qkv": {"a": torch.zeros(2, 8, 5), "b": torch.zeros(2, 5, 24)}}},
        "step_type": lambda: {**_lora_state(), "step": 3.0},
        "container": lambda: {**_lora_state(), "opt_state": (_lora_state()["opt_state"], {})},
    }[change]()
    with pytest.raises(ValueError, match="/"):
        load_train_state(path, target)
