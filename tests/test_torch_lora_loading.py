"""The subject LoRA checkpoint in the port against the JAX package: the merge
and the runtime factor tree of one checkpoint (every key spelling, the conv
patch-embed pair), and ``S2VPipeline.load_lora`` in both modes on a tiny
snapshot, held to the JAX package's merged pipeline."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_trees_equal, rand, t, write_tiny_snapshot
from s2v_tpu.loaders import lora as jlora
from s2v_tpu.loaders.safetensors_io import load_sharded_safetensors as jax_load_sharded
from s2v_tpu.pipelines.s2v import S2VPipeline as JS2VPipeline
from s2v_torch.loaders import lora
from s2v_torch.loaders.safetensors_io import best_guess_lora_file, load_safetensors, load_sharded_safetensors
from s2v_torch.models.transformer import RUNTIME_LORA_KEY
from s2v_torch.pipelines.s2v import RUNTIME_LORA_CACHE_SIZE, S2VPipeline

# fp32 through 2 steps x 2 DiT blocks (tests/test_torch_pipeline.py)
LATENT_ATOL = 2e-4
# a merged fp32 weight: W + scale * (B @ A), the product summed in another order than numpy's
MERGE_ATOL = 1e-6
SPELLINGS = {
    "diffusers": (".lora.down.weight", ".lora.up.weight"),
    "peft_default": (".lora_A.default.weight", ".lora_B.default.weight"),
    "canonical": (".lora_A.weight", ".lora_B.weight"),
}


@pytest.fixture(scope="module")
def snap_and_lora(tmp_path_factory):
    return write_tiny_snapshot(tmp_path_factory.mktemp("lora"))


def _respelled(lora_dir, spelling):
    """The checkpoint with its keys in another spelling (the ``transformer.``
    prefix dropped for the non-diffusers ones)."""
    sd = load_safetensors(best_guess_lora_file(lora_dir))
    down, up = SPELLINGS[spelling]
    out = {}
    for k, v in sd.items():
        k = k.replace(".lora.down.weight", down).replace(".lora.up.weight", up)
        out[k if spelling == "diffusers" else k[len("transformer."):]] = v
    return out


@pytest.mark.parametrize("spelling", sorted(SPELLINGS))
def test_merge_equals_jax(snap_and_lora, spelling):
    snap, lora_dir = snap_and_lora
    lsd = _respelled(lora_dir, spelling)
    base = load_sharded_safetensors(os.path.join(snap, "transformer"))
    merged, touched = lora.merge_lora_into_state_dict(base, lsd, alpha=64.0)
    jbase = {k: np.asarray(v) for k, v in jax_load_sharded(os.path.join(snap, "transformer")).items()}
    jmerged, jtouched = jlora.merge_lora_into_state_dict(jbase, {k: v.numpy() for k, v in lsd.items()}, alpha=64.0)
    assert touched == jtouched and "patch_embed.proj" in touched and len(touched) == 2 + 7 * 2
    assert sorted(merged) == sorted(jmerged)
    for k in merged:
        np.testing.assert_allclose(merged[k].numpy(), jmerged[k], atol=MERGE_ATOL, rtol=0, err_msg=k)
    changed = [k for k in merged if not torch.equal(merged[k], base[k])]
    assert sorted(changed) == sorted(m + ".weight" for m in touched)


@pytest.mark.parametrize("spelling", sorted(SPELLINGS))
def test_runtime_tree_equals_jax(snap_and_lora, spelling):
    _, lora_dir = snap_and_lora
    lsd = _respelled(lora_dir, spelling)
    got = lora.runtime_lora_tree(lsd, num_layers=2, alpha=64.0)
    want = jlora.runtime_lora_tree({k: v.numpy() for k, v in lsd.items()}, num_layers=2, alpha=64.0)
    assert_trees_equal(got, jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), want))
    assert sorted(got["top"]) == ["patch_proj", "text_proj"] and len(got["blocks"]) == 7


def test_unknown_runtime_target_and_unpaired_key_raise():
    with pytest.raises(KeyError, match="proj_out"):
        lora.runtime_lora_tree({"transformer.proj_out.lora.down.weight": torch.zeros(2, 8),
                                "transformer.proj_out.lora.up.weight": torch.zeros(4, 2)}, num_layers=2)
    with pytest.raises(KeyError, match="unpaired"):
        lora.merge_lora_into_state_dict({"x.weight": torch.zeros(4, 8)}, {"x.lora_A.weight": torch.zeros(2, 8)})


def _inputs():
    return dict(latents=rand(1, 3, 4, 4, 4, seed=10), ref_latents=rand(1, 1, 4, 4, 4, seed=11),
                prompt_embeds=rand(2, 16, 32, seed=12))


def _latents(pipe):
    common = dict(output_type="latent", height=32, width=32, num_frames=9, num_inference_steps=2, guidance_scale=6.0)
    if isinstance(pipe, JS2VPipeline):
        return np.asarray(pipe.generate(**common, **{k: jnp.asarray(v) for k, v in _inputs().items()}))
    return pipe.generate(**common, **{k: t(v) for k, v in _inputs().items()}).numpy()


@pytest.fixture(scope="module")
def jax_latents(snap_and_lora):
    snap, lora_dir = snap_and_lora
    return (_latents(JS2VPipeline.from_pretrained(snap, dtype=jnp.float32)),
            _latents(JS2VPipeline.from_pretrained(snap, lora_checkpoint=lora_dir, dtype=jnp.float32)))


def _port(snap, **kw):
    return S2VPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu", **kw)


def test_merged_and_runtime_latents_equal_jax_merged(snap_and_lora, jax_latents):
    snap, lora_dir = snap_and_lora
    jax_base, jax_merged = jax_latents
    assert np.abs(jax_merged - jax_base).max() > 1e-3  # the adapter changes the clip
    np.testing.assert_allclose(_latents(_port(snap, lora_checkpoint=lora_dir)), jax_merged, atol=LATENT_ATOL, rtol=1e-4)
    pipe = _port(snap)
    np.testing.assert_allclose(_latents(pipe), jax_base, atol=LATENT_ATOL, rtol=1e-4)
    pipe.load_lora(lora_dir, mode="runtime")
    assert RUNTIME_LORA_KEY in pipe.transformer_params
    np.testing.assert_allclose(_latents(pipe), jax_merged, atol=LATENT_ATOL, rtol=1e-4)
    pipe.load_lora(lora_dir, mode="merge")
    assert RUNTIME_LORA_KEY not in pipe.transformer_params
    np.testing.assert_allclose(_latents(pipe), jax_merged, atol=LATENT_ATOL, rtol=1e-4)


def test_merge_then_none_restores_the_base_bit_for_bit(snap_and_lora):
    snap, lora_dir = snap_and_lora
    base = _port(snap)
    pipe = _port(snap, lora_checkpoint=lora_dir)
    assert not torch.equal(pipe.transformer_params["blocks"][0]["ff"]["net_2"]["weight"],
                           base.transformer_params["blocks"][0]["ff"]["net_2"]["weight"])
    pipe.load_lora(None)
    assert_trees_equal(pipe.transformer_params, base.transformer_params)
    assert pipe._merged_lora is None and pipe._base_transformer_sd is not None
    pipe.load_lora(lora_dir)  # from the cached base: the same tree as a fresh merged load
    assert_trees_equal(pipe.transformer_params, _port(snap, lora_checkpoint=lora_dir).transformer_params)


def test_failed_runtime_load_leaves_the_merged_adapter(snap_and_lora, tmp_path):
    snap, lora_dir = snap_and_lora
    pipe = _port(snap, lora_checkpoint=lora_dir)
    before = {k: v.clone() for k, v in pipe.transformer_params["blocks"][1]["attn"]["to_out"].items()}
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "a.safetensors").write_bytes(b"")
    (bad / "b.safetensors").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="exactly one"):
        pipe.load_lora(str(bad), mode="runtime")
    assert pipe._merged_lora == (os.path.realpath(lora_dir), 64.0)
    assert RUNTIME_LORA_KEY not in pipe.transformer_params
    assert_trees_equal(pipe.transformer_params["blocks"][1]["attn"]["to_out"], before)
    with pytest.raises(ValueError, match="merged LoRA"):
        pipe.set_runtime_lora(lora.load_runtime_lora(lora_dir, 2))


def test_save_pretrained_refuses_a_runtime_adapter(snap_and_lora, tmp_path):
    snap, lora_dir = snap_and_lora
    pipe = _port(snap)
    pipe.load_lora(lora_dir, mode="runtime")
    with pytest.raises(ValueError, match="runtime LoRA attached"):
        pipe.save_pretrained(str(tmp_path / "out"))
    pipe.load_lora(None, mode="runtime")
    pipe.save_pretrained(str(tmp_path / "out"))


def test_int8_base_stays_int8_after_merge(snap_and_lora):
    snap, lora_dir = snap_and_lora
    pipe = _port(snap, quantize_int8=True)
    pipe.load_lora(lora_dir)
    leaf = pipe.transformer_params["blocks"][0]["attn"]["qkv"]
    assert leaf["q"].dtype == torch.int8 and leaf["scale"].dtype == torch.float32
    assert_trees_equal(pipe.transformer_params, _port(snap, lora_checkpoint=lora_dir, quantize_int8=True).transformer_params)


def test_runtime_cache_keeps_the_last_four(snap_and_lora, tmp_path):
    snap, lora_dir = snap_and_lora
    pipe = _port(snap)
    for alpha in (8.0, 16.0, 32.0, 64.0, 128.0):
        pipe.load_lora(lora_dir, lora_alpha=alpha, mode="runtime")
    key = os.path.realpath(lora_dir)
    assert list(pipe._runtime_lora_cache) == [(key, a) for a in (16.0, 32.0, 64.0, 128.0)]
    assert len(pipe._runtime_lora_cache) == RUNTIME_LORA_CACHE_SIZE
    pipe.load_lora(lora_dir, lora_alpha=16.0, mode="runtime")  # a hit moves to the end, no read
    assert list(pipe._runtime_lora_cache)[-1] == (key, 16.0)
    want = lora.load_runtime_lora(lora_dir, 2, alpha=16.0)
    assert_trees_equal(pipe.transformer_params[RUNTIME_LORA_KEY], want)
