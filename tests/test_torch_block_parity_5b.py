"""One DiT block at CogVideoX-5b dimensions, the port against the JAX package
(ROADMAP A.10): 3,072 wide, 48 heads of 64, RoPE at the 30x45 patch grid of
a 480x720 clip, 226 text + 1,350 ref + 2 x 1,350 video tokens, fp32 on the
CPU, both on their ``chunked`` attention backend.

The tiny-config parity tests cannot see a layout or head-folding mistake
that only appears at the real widths (the 16/24/24 RoPE axis split of d =
64 at 48 heads, the 30x45 patchify, the fused qkv of a 3,072-wide block);
this one runs the same numpy inputs and the same weights (the JAX init,
carried across by ``transformer_from_jax``) through both packages.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from _torch_parity import perturb, rand, t
from s2v_tpu.config import TransformerConfig as JTransformerConfig
from s2v_tpu.models.transformer import init_transformer_params, transformer_forward as j_forward
from s2v_tpu.ops.rope import build_segmented_rope, get_3d_rotary_pos_embed
from s2v_torch.config import TransformerConfig
from s2v_torch.loaders.jax_params import transformer_from_jax
from s2v_torch.models.transformer import transformer_forward

# fp32 on both sides through one block (3,072-wide contractions, a softmax
# over 4,276 keys in 1,024-query chunks on both sides); the two differ only
# by the order of fp32 sums (measured 9.0e-7 max and 8.0e-7 L2, relative)
MAX_REL = 1e-5  # max |port - jax| against max |jax|
L2_REL = 1e-5   # ||port - jax|| / ||jax||


def test_one_block_at_5b_dims_matches_jax():
    cfg_j = JTransformerConfig.cogvideox_5b(num_layers=1, dtype=jnp.float32, param_dtype=jnp.float32)
    cfg = TransformerConfig.cogvideox_5b(num_layers=1, dtype=torch.float32)
    assert cfg.inner_dim == 3072 and cfg.num_attention_heads == 48 and cfg.attention_head_dim == 64
    params = perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1, scale=0.01)

    b, f, h, w = 1, 2, 60, 90  # latents 60x90 -> a 30x45 patch grid, 1,350 tokens a frame
    c = cfg_j.in_channels
    video = rand(b, f, h, w, c, seed=2)
    ref = rand(b, 1, h, w, c, seed=3)
    text = rand(b, cfg_j.max_text_seq_length, cfg_j.text_embed_dim, seed=4)
    ts = np.array([999], np.int32)
    gh, gw = h // cfg_j.patch_size, w // cfg_j.patch_size
    tok = gh * gw
    cos, sin = get_3d_rotary_pos_embed(cfg_j.attention_head_dim, ((0, 0), (gh, gw)), (gh, gw), f + 1)
    cs, sn = build_segmented_rope(cfg_j.max_text_seq_length, cos[:tok], sin[:tok], cos[tok:], sin[tok:])
    assert np.asarray(cs).shape[0] == 226 + 1350 + 2 * 1350

    want = np.asarray(j_forward(params, cfg_j, jnp.asarray(video), jnp.asarray(ref), jnp.asarray(text),
                                jnp.asarray(ts), cs, sn, attention_backend="chunked"))
    params_t = transformer_from_jax(params, cfg, device="cpu")
    del params
    with torch.no_grad():
        got = transformer_forward(params_t, cfg, t(video), t(ref), t(text), torch.from_numpy(ts),
                                  t(np.asarray(cs)), t(np.asarray(sn)), attention_backend="chunked").numpy()

    assert got.shape == want.shape == (b, f, h, w, cfg.out_channels)
    assert np.isfinite(got).all()
    diff = got - want
    assert np.abs(diff).max() <= MAX_REL * np.abs(want).max(), (np.abs(diff).max(), np.abs(want).max())
    assert np.linalg.norm(diff) <= L2_REL * np.linalg.norm(want), np.linalg.norm(diff) / np.linalg.norm(want)
