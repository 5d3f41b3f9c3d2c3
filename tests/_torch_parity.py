"""Shared helpers of the tests that hold s2v_torch against s2v_tpu."""

import numpy as np
import jax
import torch


def np_tree(tree):
    """A JAX param tree as nested dicts/lists of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def perturb(tree, seed, scale=0.1):
    """Add seeded noise to every leaf, so zero biases and unit norm weights
    of the JAX inits cannot hide a layout mistake."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + scale * rng.randn(*np.shape(a))).astype(np.float32), np_tree(tree))


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))
