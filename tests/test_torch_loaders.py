"""The port's loaders against the JAX package's on one tiny snapshot that the
JAX package wrote: configs, the three state-dict converters (bf16/fp32 and
int8), the whole ``from_pretrained``, the export back (read by the JAX
package), the real 5b key inventory on the meta device, snapshot
resolution, the parameter cache and the tokenizer.  All exact
(``torch.equal``): the conversions move and cast values, nothing else."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_trees_equal, np_tree, write_tiny_snapshot
from s2v_tpu import config as jcfg
from s2v_tpu.loaders import hf as jhf
from s2v_tpu.loaders import resolve as jresolve
from s2v_tpu.loaders.safetensors_io import load_sharded_safetensors as jax_load_sharded
from s2v_tpu.pipelines.s2v import S2VPipeline as JS2VPipeline
from s2v_tpu.utils.tokenizer import T5CLSTokenizer as JT5CLSTokenizer
from s2v_torch import config as tcfg
from s2v_torch.loaders import export_hf, hf, resolve
from s2v_torch.loaders.cache import flatten_pytree, load_params, save_params, unflatten_pytree
from s2v_torch.loaders.jax_params import t5_from_jax, transformer_from_jax, vae_from_jax
from s2v_torch.loaders.safetensors_io import load_sharded_safetensors
from s2v_torch.pipelines.s2v import S2VPipeline
from s2v_torch.utils.tokenizer import T5CLSTokenizer

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "cogvideox_5b_key_inventory.json")
F32 = dict(dtype=torch.float32)


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    return write_tiny_snapshot(tmp_path_factory.mktemp("loaders"))[0]


CONFIGS = {
    "transformer": ("transformer/config.json", "TransformerConfig"),
    "vae": ("vae/config.json", "VAEConfig"),
    "text_encoder": ("text_encoder/config.json", "T5Config"),
    "scheduler": ("scheduler/scheduler_config.json", "SchedulerConfig"),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_from_hf_config_equals_jax(snap, name):
    rel, cls = CONFIGS[name]
    path = os.path.join(snap, rel)
    port, ref = getattr(tcfg, cls).from_hf_config(path), getattr(jcfg, cls).from_hf_config(path)
    for field in port.__dataclass_fields__:
        if field != "dtype":
            assert getattr(port, field) == getattr(ref, field), field
    if name != "scheduler":
        assert getattr(tcfg, cls).from_hf_config(path, **F32).dtype == torch.float32


def _port_sd(snap, sub):
    return load_sharded_safetensors(os.path.join(snap, sub))


def _jax_sd(snap, sub):
    return {k: np.asarray(v) for k, v in jax_load_sharded(os.path.join(snap, sub)).items()}


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_transformer_converter_equals_jax_then_jax_params(snap, int8):
    path = os.path.join(snap, "transformer", "config.json")
    jc = jcfg.TransformerConfig.from_hf_config(path, dtype=jnp.float32, param_dtype=jnp.float32)
    pc = tcfg.TransformerConfig.from_hf_config(path, **F32)
    want = transformer_from_jax(
        np_tree(jhf.convert_transformer_state_dict(_jax_sd(snap, "transformer"), jc, quantize_int8=int8, device=False)),
        pc, device="cpu")
    got = hf.convert_transformer_state_dict(_port_sd(snap, "transformer"), pc, quantize_int8=int8)
    assert_trees_equal(got, want)
    if int8:
        assert got["blocks"][0]["attn"]["qkv"]["q"].dtype == torch.int8


def test_vae_and_t5_converters_equal_jax_then_jax_params(snap):
    vpath, tpath = (os.path.join(snap, s, "config.json") for s in ("vae", "text_encoder"))
    jv = jcfg.VAEConfig.from_hf_config(vpath, dtype=jnp.float32, param_dtype=jnp.float32)
    pv = tcfg.VAEConfig.from_hf_config(vpath, **F32)
    assert_trees_equal(hf.convert_vae_state_dict(_port_sd(snap, "vae"), pv),
                       vae_from_jax(np_tree(jhf.convert_vae_state_dict(_jax_sd(snap, "vae"), jv)), pv, device="cpu"))
    jt = jcfg.T5Config.from_hf_config(tpath, dtype=jnp.float32, param_dtype=jnp.float32)
    pt = tcfg.T5Config.from_hf_config(tpath, **F32)
    assert_trees_equal(hf.convert_t5_state_dict(_port_sd(snap, "text_encoder"), pt),
                       t5_from_jax(np_tree(jhf.convert_t5_state_dict(_jax_sd(snap, "text_encoder"), jt)), pt,
                                   device="cpu"))


def _jax_pipe(snap):
    return JS2VPipeline.from_pretrained(snap, dtype=jnp.float32)


def _jax_trees_in_port_layout(jpipe, pipe):
    return (transformer_from_jax(np_tree(jpipe.transformer_params), pipe.transformer_cfg, device="cpu"),
            vae_from_jax(np_tree(jpipe.vae_params), pipe.vae_cfg, device="cpu"),
            t5_from_jax(np_tree(jpipe.t5_params), pipe.t5_cfg, device="cpu"))


def test_from_pretrained_loads_the_jax_snapshot_to_jax_tensors(snap):
    pipe = S2VPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu")
    for got, want in zip((pipe.transformer_params, pipe.vae_params, pipe.t5_params),
                         _jax_trees_in_port_layout(_jax_pipe(snap), pipe)):
        assert_trees_equal(got, want)
    assert isinstance(pipe.tokenizer, T5CLSTokenizer) and pipe.model_dir == snap
    assert pipe.attention_backend == "plain" and pipe.scheduler_cfg == tcfg.SchedulerConfig.from_hf_config(
        os.path.join(snap, "scheduler", "scheduler_config.json"))


def test_save_pretrained_loads_in_jax_to_its_own_tree(snap, tmp_path):
    """Port load -> port save -> JAX load gives the JAX package's tree of
    the original snapshot, leaf for leaf."""
    pipe = S2VPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu")
    out = pipe.save_pretrained(str(tmp_path / "exported"))
    assert sorted(os.listdir(out)) == sorted(os.listdir(snap))
    again, ref = _jax_pipe(out), _jax_pipe(snap)
    for name in ("transformer_params", "vae_params", "t5_params"):
        a, b = np_tree(getattr(again, name)), np_tree(getattr(ref, name))
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    with open(os.path.join(out, "model_index.json")) as f:
        assert json.load(f)["tokenizer"] == ["transformers", "T5TokenizerFast"]


def test_save_pretrained_keeps_the_2b_config_fields(snap, tmp_path):
    """C.9: the exported configs carry the sincos path's fields, so the tiny
    snapshot's sample_width 8 comes back as 8 (not the 5b default 90), in
    the port and in the JAX package; the 2b family's config round-trips."""
    pipe = S2VPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu")
    assert pipe.transformer_cfg.sample_width == 8
    pipe.transformer_cfg = tcfg.TransformerConfig.cogvideox_2b(
        num_layers=pipe.transformer_cfg.num_layers, num_attention_heads=4, attention_head_dim=16, in_channels=4,
        out_channels=4, time_embed_dim=16, text_embed_dim=32, sample_width=8, sample_height=8, sample_frames=9,
        max_text_seq_length=16, spatial_interpolation_scale=1.5, temporal_interpolation_scale=0.5,
        use_learned_positional_embeddings=True, dtype=torch.float32)
    pipe.vae_cfg = dataclasses.replace(pipe.vae_cfg, norm_eps=1e-5, invert_scale_latents=True)
    out = pipe.save_pretrained(str(tmp_path / "exported"))
    for sub, cls in (("transformer", "TransformerConfig"), ("vae", "VAEConfig")):
        path = os.path.join(out, sub, "config.json")
        back = getattr(tcfg, cls).from_hf_config(path, **F32)
        assert back == dataclasses.replace(getattr(pipe, f"{sub}_cfg"), dtype=torch.float32)
        ref = getattr(jcfg, cls).from_hf_config(path)
        for field in back.__dataclass_fields__:
            if field != "dtype":
                assert getattr(back, field) == getattr(ref, field), field
    back = tcfg.TransformerConfig.from_hf_config(os.path.join(out, "transformer", "config.json"))
    assert (back.sample_width, back.use_rotary_positional_embeddings, back.spatial_interpolation_scale) == (8, False, 1.5)
    assert tcfg.TransformerConfig.cogvideox_2b() == dataclasses.replace(
        tcfg.TransformerConfig(), num_attention_heads=30, num_layers=30, use_rotary_positional_embeddings=False,
        dtype=torch.float16)
    j2b = jcfg.TransformerConfig.cogvideox_2b()
    for field in tcfg.TransformerConfig.__dataclass_fields__:
        if field != "dtype":
            assert getattr(tcfg.TransformerConfig.cogvideox_2b(), field) == getattr(j2b, field), field


def test_save_pretrained_bf16_and_int8_refused(snap, tmp_path):
    pipe = S2VPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu")
    pipe.save_pretrained(str(tmp_path / "bf16"), dtype="bfloat16")
    sd = load_sharded_safetensors(str(tmp_path / "bf16" / "transformer"))
    assert {v.dtype for v in sd.values()} == {torch.bfloat16}
    int8 = S2VPipeline.from_pretrained(snap, dtype=torch.float32, quantize_int8=True, device="cpu")
    with pytest.raises(ValueError, match="int8-quantized transformer"):
        int8.save_pretrained(str(tmp_path / "int8"))


class _TrackingDict(dict):
    """Records the keys a converter reads (``in`` checks do not count)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.accessed = set()

    def __getitem__(self, k):
        self.accessed.add(k)
        return super().__getitem__(k)


def _meta_sd(section):
    with open(FIXTURE) as f:
        inv = json.load(f)[section]
    return inv, _TrackingDict({k: torch.empty(shape, device="meta") for k, shape in inv.items()})


@pytest.mark.parametrize("section", ["transformer", "vae", "text_encoder"])
def test_real_5b_key_inventory_round_trips(section):
    """Every key of the real CogVideoX-5b / T5-XXL checkpoints is consumed by
    the converter, and the export writes exactly that key set back with the
    same shapes (the tied T5 embedding written once, as ``shared.weight``).
    Meta tensors: no weights are allocated."""
    inv, sd = _meta_sd(section)
    if section == "transformer":
        cfg = tcfg.TransformerConfig()
        tree = hf.convert_transformer_state_dict(sd, cfg)
        assert tree["blocks"][0]["attn"]["qkv"]["weight"].shape == (3 * cfg.inner_dim, cfg.inner_dim)
        assert tree["patch_embed"]["proj"]["weight"].shape == (cfg.inner_dim, 4 * cfg.in_channels)
        back = export_hf.transformer_state_dict(tree, cfg)
        assert hf.convert_transformer_state_dict(sd, cfg, quantize_int8=True)["blocks"][41]["ff"]["net_2"][
            "q"].dtype == torch.int8
        skip = set()
    elif section == "vae":
        cfg = tcfg.VAEConfig()
        back = export_hf.vae_state_dict(hf.convert_vae_state_dict(sd, cfg), cfg)
        skip = set()
    else:
        cfg = tcfg.T5Config()
        back = export_hf.t5_state_dict(hf.convert_t5_state_dict(sd, cfg), cfg)
        skip = {"encoder.embed_tokens.weight"}
    assert set(inv) - sd.accessed - skip == set()
    assert set(back) == set(inv) - skip
    assert all(list(back[k].shape) == inv[k] for k in back)


@pytest.mark.parametrize("layout", ["missing_vae", "no_weights", "missing_config"])
def test_validate_snapshot_layout_matches_jax(snap, tmp_path, layout):
    import shutil

    d = tmp_path / "snap"
    shutil.copytree(snap, d)
    if layout == "missing_vae":
        shutil.rmtree(d / "vae")
    elif layout == "no_weights":
        os.remove(d / "transformer" / "diffusion_pytorch_model.safetensors")
    else:
        os.remove(d / "vae" / "config.json")
    with pytest.raises(FileNotFoundError) as port_err:
        resolve.validate_snapshot_layout(str(d))
    with pytest.raises(FileNotFoundError) as jax_err:
        jresolve.validate_snapshot_layout(str(d))
    assert str(port_err.value) == str(jax_err.value)
    resolve.validate_snapshot_layout(snap)


@pytest.mark.parametrize("name", ["not/a/repo/id", "org/model"], ids=["not_a_repo", "repo_offline"])
def test_resolve_model_dir_matches_jax(monkeypatch, name):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    with pytest.raises(FileNotFoundError) as port_err:
        resolve.resolve_model_dir(name)
    with pytest.raises(FileNotFoundError) as jax_err:
        jresolve.resolve_model_dir(name)
    assert str(port_err.value) == str(jax_err.value)


def test_param_cache_round_trip(snap, tmp_path):
    """Converted trees (a list of per-layer dicts, int8 leaves, bf16) come
    back equal, on the CPU, cast when asked."""
    pipe = S2VPipeline.from_pretrained(snap, dtype=torch.float32, quantize_int8=True, device="cpu")
    tree = pipe.transformer_params
    flat = flatten_pytree(tree)
    assert "blocks::1::attn::qkv::q" in flat and flat["blocks::1::attn::qkv::q"].dtype == torch.int8
    assert_trees_equal(unflatten_pytree(flat), tree)
    save_params(tree, str(tmp_path / "t.safetensors"))
    assert_trees_equal(load_params(str(tmp_path / "t.safetensors"), device="cpu"), tree)
    save_params(pipe.vae_params, str(tmp_path / "v.safetensors"))
    back = load_params(str(tmp_path / "v.safetensors"), dtype=torch.bfloat16, device="cpu")
    assert back["decoder"]["up_blocks"][0]["resnets"][0]["conv1"]["weight"].dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_params(str(tmp_path / "v.safetensors"))


def test_tokenizer_equals_jax(snap):
    port, ref = T5CLSTokenizer.from_checkpoint_dir(snap), JT5CLSTokenizer.from_checkpoint_dir(snap)
    prompts = ["<cls> a pig walking on the grass", "", "a " * 40 + "dog"]
    for max_length in (8, 16, 226):
        np.testing.assert_array_equal(port.encode(prompts, max_length), ref.encode(prompts, max_length))
    assert (port.cls_id, port.eos_id, port.pad_id, len(port)) == (ref.cls_id, ref.eos_id, ref.pad_id, len(ref))
