"""The port's ops against the JAX package's, in fp32 on the same numpy inputs:
norms, timestep, rope, patchify, adaln, dense, joint attention, causal conv
and the DDIM scheduler."""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from s2v_tpu.config import SchedulerConfig as JSchedulerConfig
from s2v_tpu.ops import adaln as j_adaln
from s2v_tpu.ops import attention as j_attention
from s2v_tpu.ops import norms as j_norms
from s2v_tpu.ops import patchify as j_patchify
from s2v_tpu.ops import quant as j_quant
from s2v_tpu.ops import rope as j_rope
from s2v_tpu.ops import timestep as j_timestep
from s2v_tpu.schedulers import ddim as j_ddim
from s2v_tpu.utils import video as j_video
from s2v_torch.config import SchedulerConfig

# the JAX packages' __init__ re-export functions under these module names
j_conv = importlib.import_module("s2v_tpu.ops.causal_conv3d")
j_denoise = importlib.import_module("s2v_tpu.pipelines.denoise")
from s2v_torch.loaders.jax_params import _convert
from s2v_torch.ops import adaln, attention, causal_conv3d, norms, patchify, quant, rope, timestep
from s2v_torch.pipelines import denoise
from s2v_torch.schedulers import ddim
from s2v_torch.utils import video

# fp32 on both sides, different reduction orders: a few ulp of O(1) values
ATOL, RTOL = 1e-5, 1e-5


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _params(tree):
    """A JAX param tree in the port's layout (linear kernels transposed)."""
    return _convert(jax.tree.map(np.asarray, tree), "cpu", torch.float32)


def test_layer_norm_and_rms_norm():
    x = _rand(2, 7, 32, seed=1) * 3 + 1
    w, b = _rand(32, seed=2), _rand(32, seed=3)
    _close(norms.layer_norm(_t(x), _t(w), _t(b), 1e-5), j_norms.layer_norm(jnp.asarray(x), w, b, 1e-5))
    _close(norms.layer_norm(_t(x)), j_norms.layer_norm(jnp.asarray(x)))
    _close(norms.rms_norm(_t(x), _t(w), 1e-6), j_norms.rms_norm(jnp.asarray(x), w, 1e-6))


def test_group_norm_channels_first():
    x = _rand(2, 3, 4, 5, 8, seed=4)  # JAX layout [B, T, H, W, C]
    w, b = _rand(8, seed=5), _rand(8, seed=6)
    want = j_norms.group_norm(jnp.asarray(x), w, b, 4, 1e-6)
    got = norms.group_norm(_t(x).permute(0, 4, 1, 2, 3), _t(w), _t(b), 4, 1e-6)
    _close(got.permute(0, 2, 3, 4, 1), want)


@pytest.mark.parametrize("dim", [16, 33])
def test_timestep_embedding_and_mlp(dim):
    ts = np.array([0, 1, 250, 999], np.int32)
    emb_j = j_timestep.get_timestep_embedding(jnp.asarray(ts), dim)
    emb_t = timestep.get_timestep_embedding(_t(ts), dim)
    # sin/cos of arguments up to ~1e3: fp32 argument rounding differs by ulps
    _close(emb_t, emb_j, atol=2e-4)
    p = j_timestep.init_timestep_mlp(jax.random.PRNGKey(0), dim, 8)
    _close(timestep.timestep_embedding_mlp(_params(p), emb_t), j_timestep.timestep_embedding_mlp(p, emb_j), atol=2e-4)


@pytest.mark.parametrize("hw", [(480, 720), (256, 256), (32, 48)])
def test_rope_tables(hw):
    height, width = hw
    got = rope.prepare_video_and_ref_rope(height, width, 3, 64)
    want = j_rope.prepare_video_and_ref_rope(height, width, 3, 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    vc, vs, rc, rs = got
    cos_t, sin_t = rope.build_segmented_rope(5, rc, rs, vc, vs)
    cos_j, sin_j = j_rope.build_segmented_rope(5, rc, rs, vc, vs)
    np.testing.assert_array_equal(cos_t.numpy(), np.asarray(cos_j))
    np.testing.assert_array_equal(sin_t.numpy(), np.asarray(sin_j))


def test_apply_rotary_emb():
    x = _rand(2, 12, 3, 16, seed=7)
    cos, sin = j_rope.get_3d_rotary_pos_embed(16, ((0, 0), (2, 3)), (2, 3), 2)
    want = j_rope.apply_rotary_emb(jnp.asarray(x), jnp.asarray(cos)[:, None], jnp.asarray(sin)[:, None])
    got = rope.apply_rotary_emb(_t(x), _t(cos)[:, None], _t(sin)[:, None])
    _close(got, want)


def test_patchify_roundtrip():
    x = _rand(2, 3, 4, 6, 5, seed=8)
    kernel, bias = _rand(20, 12, seed=9), _rand(12, seed=10)
    want = j_patchify.patchify_video(jnp.asarray(x), kernel, bias, 2)
    got = patchify.patchify_video(_t(x), _t(kernel.T.copy()), _t(bias), 2)
    _close(got, want)
    tokens = _rand(2, 27, 20, seed=11)
    _close(patchify.unpatchify_video(_t(tokens), 3, 6, 6, 2, 5),
           j_patchify.unpatchify_video(jnp.asarray(tokens), 3, 6, 6, 2, 5))


@pytest.mark.parametrize("ref_len", [4, 0], ids=["ref", "no_ref"])
def test_adaln_3stream_and_out(ref_len):
    d, td = 16, 8
    params = {
        "linear": {"kernel": _rand(td, 6 * d, seed=12), "bias": _rand(6 * d, seed=13)},
        "norm": {"weight": _rand(d, seed=14), "bias": _rand(d, seed=15)},
    }
    video, text, ref, temb = _rand(2, 6, d, seed=16), _rand(2, 3, d, seed=17), _rand(2, ref_len, d, seed=18), _rand(2, td, seed=19)
    want = j_adaln.ada_layer_norm_zero_3stream(params, *map(jnp.asarray, (video, text, ref, temb)))
    got = adaln.ada_layer_norm_zero_3stream(_params(params), *map(_t, (video, text, ref, temb)))
    for g, w in zip(got, want):
        _close(g, w)
    out_params = {"linear": {"kernel": _rand(td, 2 * d, seed=20), "bias": _rand(2 * d, seed=21)}, "norm": params["norm"]}
    _close(adaln.ada_layer_norm_out(_params(out_params), _t(video), _t(temb)),
           j_adaln.ada_layer_norm_out(out_params, jnp.asarray(video), jnp.asarray(temb)))


def test_dense():
    p = {"kernel": _rand(12, 7, seed=22), "bias": _rand(7, seed=23)}
    x = _rand(3, 5, 12, seed=24)
    _close(quant.dense(_params(p), _t(x)), j_quant.dense(p, jnp.asarray(x)))


@pytest.mark.parametrize("backend", ["plain", "flash"])
def test_joint_attention(backend):
    """Both port backends (flash on CPU tensors is B1's plain version in the
    bounded mode) against the JAX xla backend."""
    dim, heads = 32, 2
    p = j_attention.init_attention_params(jax.random.PRNGKey(1), dim, heads)
    p["norm_q"]["weight"] = jnp.asarray(_rand(16, seed=25))
    p["norm_k"]["bias"] = jnp.asarray(_rand(16, seed=26))
    x = _rand(2, 20, dim, seed=27)
    cos, sin = j_rope.get_3d_rotary_pos_embed(16, ((0, 0), (2, 2)), (2, 2), 3)
    cs, sn = j_rope.build_segmented_rope(8, cos[:4], sin[:4], cos[4:], sin[4:])
    want = j_attention.joint_attention(p, jnp.asarray(x), heads, cs, sn, backend="xla")
    got = attention.joint_attention(_params(p), _t(x), heads, _t(np.asarray(cs)), _t(np.asarray(sn)),
                                    backend=backend)
    _close(got, want, atol=2e-5, rtol=1e-4)


def test_resolve_attention_backend():
    assert attention.resolve_attention_backend("auto", torch.device("cpu")) == "plain"
    assert attention.resolve_attention_backend("auto", torch.device("cuda")) == "flash"
    assert attention.resolve_attention_backend("flash", torch.device("cpu")) == "flash"
    with pytest.raises(ValueError):
        attention.resolve_attention_backend("xla", torch.device("cpu"))


def _conv_params(kt, kh, kw, cin, cout, seed):
    return {"kernel": _rand(kt, kh, kw, cin, cout, seed=seed) * 0.2, "bias": _rand(cout, seed=seed + 1)}


def _cf(x):  # channels-last numpy [B, T, H, W, C] -> channels-first tensor
    return _t(x).permute(0, 4, 1, 2, 3)


def _cl(x):  # channels-first tensor -> channels-last numpy
    return x.permute(0, 2, 3, 4, 1).numpy()


def test_causal_conv3d_with_cache():
    p = _conv_params(3, 3, 3, 4, 6, seed=30)
    x = _rand(1, 5, 6, 7, 4, seed=31)
    y_j, c_j = j_conv.causal_conv3d(p, jnp.asarray(x[:, :3]))
    y2_j, _ = j_conv.causal_conv3d(p, jnp.asarray(x[:, 3:]), c_j)
    y_t, c_t = causal_conv3d.causal_conv3d(_params(p), _cf(x[:, :3]))
    y2_t, _ = causal_conv3d.causal_conv3d(_params(p), _cf(x[:, 3:]), c_t)
    _close(_cl(y_t), y_j, atol=2e-5)
    _close(_cl(y2_t), y2_j, atol=2e-5)
    _close(_cl(c_t), c_j)


def test_conv1x1x1_conv2d_per_frame_and_resize():
    x = _rand(2, 3, 6, 8, 4, seed=32)
    p1 = _conv_params(1, 1, 1, 4, 5, seed=33)
    _close(_cl(causal_conv3d.conv1x1x1(_params(p1), _cf(x))), j_conv.conv1x1x1(p1, jnp.asarray(x)), atol=2e-5)
    p2 = {"kernel": _rand(3, 3, 4, 5, seed=34) * 0.2, "bias": _rand(5, seed=35)}
    _close(_cl(causal_conv3d.conv2d_per_frame(_params(p2), _cf(x), stride=1, padding=1)),
           j_conv.conv2d_per_frame(p2, jnp.asarray(x)), atol=2e-5)
    _close(_cl(causal_conv3d.nearest_resize_video(_cf(x), (5, 9, 3))),
           j_conv.nearest_resize_video(jnp.asarray(x), (5, 9, 3)))


@pytest.mark.parametrize("steps", [2, 50])
@pytest.mark.parametrize("dynamic", [False, True])
def test_ddim_schedule_and_step(steps, dynamic):
    sched_t = denoise.DenoiseSchedule.create(SchedulerConfig(), steps, 6.0, dynamic)
    sched_j = j_denoise.DenoiseSchedule.create(JSchedulerConfig(), steps, 6.0, dynamic)
    for name in ("timesteps", "alpha_t", "alpha_prev", "guidance"):
        np.testing.assert_array_equal(getattr(sched_t, name), getattr(sched_j, name))
    ac = ddim.compute_alphas_cumprod(SchedulerConfig())
    np.testing.assert_array_equal(ac, j_ddim.compute_alphas_cumprod(JSchedulerConfig()))
    mo, x = _rand(2, 3, 4, 4, 2, seed=40), _rand(2, 3, 4, 4, 2, seed=41)
    i = steps // 2
    for pred in ("v_prediction", "epsilon", "sample"):
        got = ddim.ddim_step(_t(mo), _t(x), float(sched_t.alpha_t[i]), float(sched_t.alpha_prev[i]), pred)
        want = j_ddim.ddim_step(jnp.asarray(mo), jnp.asarray(x), sched_j.alpha_t[i], sched_j.alpha_prev[i], pred)
        for g, w in zip(got, want):
            _close(g, w)
    ts = np.array([999, 10])
    noise = _rand(2, 3, 4, 4, 2, seed=42)
    _close(ddim.add_noise(_t(x), _t(noise), ac, ts), j_ddim.add_noise(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(ac), jnp.asarray(ts)))
    _close(ddim.get_velocity(_t(x), _t(noise), ac, ts), j_ddim.get_velocity(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(ac), jnp.asarray(ts)))


def test_video_postprocess():
    x = _rand(1, 3, 4, 5, 3, seed=43) * 1.5
    np.testing.assert_array_equal(video.denormalize_video(x), j_video.denormalize_video(x))
    np.testing.assert_array_equal(video.to_uint8_frames(video.denormalize_video(x)),
                                  j_video.to_uint8_frames(j_video.denormalize_video(x)))
