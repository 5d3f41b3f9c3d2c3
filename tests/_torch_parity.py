"""Shared helpers of the tests that hold s2v_torch against s2v_tpu."""

import numpy as np
import jax
import jax.numpy as jnp
import torch


def np_tree(tree):
    """A JAX param tree as nested dicts/lists of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def perturb(tree, seed, scale=0.1):
    """Add seeded noise to every leaf, so zero biases and unit norm weights
    of the JAX inits cannot hide a layout mistake."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + scale * rng.randn(*np.shape(a))).astype(np.float32), np_tree(tree))


def quantized(tree):
    """The JAX package's ``quantize_transformer_params`` of a numpy JAX tree
    (e.g. from :func:`perturb`), jitted as in its pipelines (XLA computes
    ``amax / 127.0`` as a multiply by the fp32 reciprocal, as the port
    does), back as numpy with the int8 ``q`` leaves kept int8 and their
    ``scale`` fp32."""
    from s2v_tpu.ops.quant import quantize_transformer_params

    return np_tree(jax.jit(quantize_transformer_params)(jax.tree.map(jnp.asarray, tree)))


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# windowed-attention geometries of the banded kernels' tests: (B, H, G, tpf, F, w)
BAND_GEOMETRIES = {
    "tpf_20_clamped_w1": (1, 2, 24, 20, 5, 1),
    "span_equals_F": (1, 2, 24, 20, 3, 2),
    "w0": (1, 2, 24, 20, 4, 0),
    "small_clip_F4_w1": (1, 2, 24, 20, 4, 1),
    "batch2_heads3": (2, 3, 10, 16, 5, 1),
    "minimal": (1, 2, 1, 8, 2, 0),
    "global_longer_than_frames": (1, 2, 300, 24, 4, 1),
    "tpf_just_over_128": (1, 2, 7, 130, 3, 2),
    "clamp_both_edges": (1, 2, 129, 16, 7, 3),
    "window_wider_than_clip": (1, 2, 50, 40, 5, 9),
}


def band_inputs(b, h, g, tpf, f, seed, d=16, n=4):
    """q, k, v (and dO): seeded numpy, 0.5-scaled as the JAX tests' sweep."""
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(b, g + f * tpf, h, d) * 0.5).astype(np.float32) for _ in range(n))


def seeded_params(init_fn, cfg, seed):
    """Seeded numpy params in the tree of a JAX init function, without
    running it (its eager init of the tiny VAE takes seconds):
    ``kernel``/``embedding`` leaves normal / sqrt(fan-in), norm ``weight``s
    1 + 0.1·normal, biases and the rest 0.1·normal, so zero biases and unit
    norms hide no layout mistake."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda k: init_fn(k, cfg), jax.random.PRNGKey(0))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        x = rng.randn(*shape).astype(np.float32)
        if name in ("kernel", "embedding"):
            return x / np.sqrt(max(1, int(np.prod(shape[:-1])) if name == "kernel" else shape[-1]))
        return x * 0.1 + (1.0 if name == "weight" else 0.0)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def write_tiny_snapshot(root):
    """A tiny CogVideoX snapshot in the diffusers layout, written by the JAX
    package's ``save_pipeline_snapshot`` (fp32) from :func:`seeded_params`,
    with a ``tokenizer.json``, and a LoRA checkpoint over all 9 target
    families (``tools/make_tiny_snapshot.py::lora_checkpoint``, rank 2, the
    diffusers ``.lora.down``/``.lora.up`` keys).  Returns (snapshot, lora) dirs."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from make_tiny_snapshot import lora_checkpoint, write_tokenizer

    from s2v_tpu.config import T5Config, TransformerConfig, VAEConfig
    from s2v_tpu.loaders.export_hf import save_pipeline_snapshot
    from s2v_tpu.loaders.safetensors_io import save_safetensors
    from s2v_tpu.models.t5 import init_t5_params
    from s2v_tpu.models.transformer import init_transformer_params
    from s2v_tpu.models.vae import init_vae_params
    from s2v_tpu.pipelines.s2v import S2VPipeline
    from s2v_tpu.utils.tokenizer import T5CLSTokenizer

    tcfg = TransformerConfig.tiny()
    vcfg = VAEConfig.tiny(latent_channels=tcfg.in_channels, sample_height=64, sample_width=64)
    t5cfg = T5Config.tiny(d_model=tcfg.text_embed_dim)
    tok_json = os.path.join(str(root), "tokenizer.json")
    write_tokenizer(tok_json, t5cfg.vocab_size)
    dev = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    pipe = S2VPipeline(
        transformer_params=dev(seeded_params(init_transformer_params, tcfg, 1)), transformer_cfg=tcfg,
        vae_params=dev(seeded_params(init_vae_params, vcfg, 2)), vae_cfg=vcfg,
        t5_params=dev(seeded_params(init_t5_params, t5cfg, 3)), t5_cfg=t5cfg,
        tokenizer=T5CLSTokenizer(tok_json),
    )
    snap, lora = os.path.join(str(root), "snapshot"), os.path.join(str(root), "lora")
    save_pipeline_snapshot(pipe, snap)
    os.makedirs(lora)
    save_safetensors(lora_checkpoint(tcfg), os.path.join(lora, "pytorch_lora_weights_transformer.safetensors"))
    return snap, lora


def assert_trees_equal(got, want, path="params"):
    """Two trees of tensors: the same structure, and every leaf equal in
    dtype, shape and value (``torch.equal``)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), f"{path}: {sorted(got)} vs {sorted(want)}"
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), f"{path}: {len(got)} vs {len(want)} entries"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, f"{path}: {got.dtype} {got.shape} vs {want.dtype} {want.shape}"
        assert torch.equal(got, want), f"{path}: values differ"


# fp32 through a few steps x 2 DiT blocks, then the VAE decoder
LATENT_ATOL = 2e-4
FRAME_ATOL = 2e-4


class FakeTokenizer:
    def encode(self, prompts, max_length=226):
        out = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            ids = [(hash(w) % 100) + 2 for w in p.split()][: max_length - 1] + [1]
            out[i, : len(ids)] = ids
        return out


def tiny_pipelines(**tcfg_overrides):
    """The tiny ``S2VPipeline`` of the JAX package and the port's, on the
    same perturbed fp32 weights carried across, with one fake tokenizer.
    ``tcfg_overrides`` go to both packages' ``TransformerConfig.tiny`` (e.g.
    ``use_rotary_positional_embeddings=False`` for a sincos model,
    ``in_channels=8`` for an i2v one)."""
    from s2v_tpu.config import SchedulerConfig as JSchedulerConfig
    from s2v_tpu.config import T5Config as JT5Config
    from s2v_tpu.config import TransformerConfig as JTransformerConfig
    from s2v_tpu.config import VAEConfig as JVAEConfig
    from s2v_tpu.models.t5 import init_t5_params
    from s2v_tpu.models.transformer import init_transformer_params
    from s2v_tpu.models.vae import init_vae_params
    from s2v_tpu.pipelines.s2v import S2VPipeline as JS2VPipeline
    from s2v_torch.config import T5Config, TransformerConfig, VAEConfig
    from s2v_torch.loaders.jax_params import t5_from_jax, transformer_from_jax, vae_from_jax
    from s2v_torch.pipelines.s2v import S2VPipeline

    vae_kw = dict(latent_channels=4, sample_height=64, sample_width=64)
    tok = FakeTokenizer()
    tcfg_j = JTransformerConfig.tiny(**tcfg_overrides)
    vcfg_j = JVAEConfig.tiny(**vae_kw)
    t5cfg_j = JT5Config.tiny(d_model=tcfg_j.text_embed_dim)
    tp = perturb(init_transformer_params(jax.random.PRNGKey(0), tcfg_j), seed=1, scale=0.05)
    vp = perturb(init_vae_params(jax.random.PRNGKey(1), vcfg_j), seed=2, scale=0.05)
    t5p = perturb(init_t5_params(jax.random.PRNGKey(2), t5cfg_j), seed=3, scale=0.05)
    jax_pipe = JS2VPipeline(
        transformer_params=jax.tree.map(jnp.asarray, tp), transformer_cfg=tcfg_j,
        vae_params=jax.tree.map(jnp.asarray, vp), vae_cfg=vcfg_j,
        t5_params=jax.tree.map(jnp.asarray, t5p), t5_cfg=t5cfg_j,
        scheduler_cfg=JSchedulerConfig(), tokenizer=tok,
    )
    tcfg, vcfg, t5cfg = TransformerConfig.tiny(**tcfg_overrides), VAEConfig.tiny(**vae_kw), T5Config.tiny(d_model=32)
    port = S2VPipeline(
        transformer_params=transformer_from_jax(tp, tcfg, device="cpu"), transformer_cfg=tcfg,
        vae_params=vae_from_jax(vp, vcfg, device="cpu"), vae_cfg=vcfg,
        t5_params=t5_from_jax(t5p, t5cfg, device="cpu"), t5_cfg=t5cfg,
        tokenizer=tok, device="cpu",
    )
    return jax_pipe, port
