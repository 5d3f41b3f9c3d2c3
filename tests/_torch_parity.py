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
