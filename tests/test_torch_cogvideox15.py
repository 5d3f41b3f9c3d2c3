"""CogVideoX1.5 (temporal patches, ``TransformerConfig.patch_size_t``) in the
port against the plain fp32 reference ``benchmark/reference/dit_pt.py``, on
the CPU at tiny sizes: the patchify's feature order, the integer-grid RoPE,
a two-block DiT, ``generate``'s frame padding and decode, the VAE's
``invert_scale_latents``, a snapshot through the exporter and the CLI, and
every path that refuses temporal patches."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from benchmark import weights as bench_weights
from benchmark.entries.generate_pt import dit_shapes
from benchmark.reference import dit_pt
from s2v_torch import cli
from s2v_torch.config import T5Config, TransformerConfig, VAEConfig
from s2v_torch.loaders.hf import convert_transformer_state_dict
from s2v_torch.models.t5 import init_t5_params_random
from s2v_torch.models.transformer import init_transformer_params_random, transformer_forward
from s2v_torch.models.vae import init_vae_params_random
from s2v_torch.ops.patchify import patchify_video, unpatchify_video
from s2v_torch.ops.rope import build_segmented_rope, prepare_video_and_ref_rope_patches
from s2v_torch.pipelines.s2v import S2VPipeline

# the tiny model of the satellite: 2 blocks of 2 heads x 16, 2x2x2 patches, no patch bias
TCFG = TransformerConfig.tiny(num_layers=2, num_attention_heads=2, patch_size_t=2, patch_bias=False,
                              sample_height=300, sample_width=300, sample_frames=81)


def _tdict(cfg: TransformerConfig) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}


def _state_dict(seed=0):
    """Published-layout 1.5 keys (the patch embedding a Linear, no bias) drawn from a seed, fp32."""
    sd, _ = bench_weights.make_state_dict(dit_shapes(_tdict(TCFG)), seed, "transformer", torch.device("cpu"),
                                          torch.float32)
    return sd


def test_patch_size_t_round_trips_exactly_in_the_references_feature_order():
    x = torch.randn(2, 4, 8, 6, 3, generator=torch.Generator().manual_seed(0))
    feats = 3 * 2 * 2 * 2
    eye = torch.eye(feats)
    tokens = patchify_video(x, eye, None, 2, 2)  # the identity projection: the raw (c, pₜ, ph, pw) features
    ref = dit_pt.DiT({"patch_embed.proj.weight": eye}, {"patch_size": 2, "patch_size_t": 2,
                                                         "num_attention_heads": 1, "attention_head_dim": feats})
    assert torch.equal(tokens, ref.patch_embed(x))
    assert tokens.shape == (2, 2 * 4 * 3, feats)
    assert torch.equal(unpatchify_video(tokens, 4, 8, 6, 2, 3, 2), x)
    # token 0, feature (c=1, pₜ=1, ph=0, pw=1) is frame 1, row 0, column 1, channel 1
    assert tokens[0, 0, 1 * 8 + 1 * 4 + 0 * 2 + 1] == x[0, 1, 0, 1, 1]
    with pytest.raises(ValueError, match="patch_size_t"):
        patchify_video(x[:, :3], eye, None, 2, 2)


def test_integer_grid_rope_equals_the_references_tables():
    """At the cell's grid (11 temporal patches of 48 x 85).  The port works
    the angles in float32, the reference in float64: angles up to 84 rad
    carry float32 rounding of ~8e-6, so the tables agree to 2e-5."""
    vc, vs, rc, rs = prepare_video_and_ref_rope_patches(768, 1360, 22, 64, 2, 2, (150, 150))
    cos, sin = dit_pt.rope_tables(64, 11, 48, 85, (150, 150))
    np.testing.assert_allclose(np.concatenate([rc, vc]), cos.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.concatenate([rs, vs]), sin.numpy(), rtol=0, atol=2e-5)
    assert rc.shape == (4080, 32) and vc.shape == (44880, 32)
    with pytest.raises(ValueError, match="150 x 150"):
        prepare_video_and_ref_rope_patches(2432, 720, 22, 64, 2, 2, (150, 150))


def _rope(cfg, frames, h_lat, w_lat, text_len):
    vc, vs, rc, rs = prepare_video_and_ref_rope_patches(h_lat * 8, w_lat * 8, frames, cfg.attention_head_dim,
                                                        cfg.patch_size, cfg.patch_size_t, (150, 150))
    return build_segmented_rope(text_len, rc, rs, vc, vs, device="cpu")


@pytest.mark.parametrize("rows", ["ref", "cfg_rows"])
def test_tiny_dit_matches_the_reference(rows):
    """fp32 both sides, the same weights and positions: the two differ only
    by the order of fp32 sums, so 1e-5 relative L2 holds with room."""
    g = torch.Generator().manual_seed(1)
    frames, h, w = 4, 8, 8
    video = torch.randn(1, frames, h, w, 4, generator=g)
    ref = torch.randn(1, 1, h, w, 4, generator=g)
    text = torch.randn(2 if rows == "cfg_rows" else 1, 16, 32, generator=g)
    if rows == "cfg_rows":  # the batched CFG's [uncond | cond] over one clip
        video, ref = torch.cat([video, video]), torch.cat([ref, ref])
    t = torch.full((video.shape[0],), 501)
    sd = _state_dict()
    params = convert_transformer_state_dict(sd, TCFG)
    assert "bias" not in params["patch_embed"]["proj"]
    cos, sin = _rope(TCFG, frames, h, w, 16)
    got = transformer_forward(params, TCFG, video, ref, text, t, cos, sin, attention_backend="plain")
    want = dit_pt.DiT(sd, _tdict(TCFG)).forward(video, ref, text, t,
                                                 ("rope",) + dit_pt.rope_tables(16, frames // 2, h // 2, w // 2,
                                                                                (150, 150)))
    assert got.shape == video.shape
    assert float((got - want).norm() / want.norm()) <= 1e-5


def _tiny_pipe(invert=False):
    vcfg = VAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64, invert_scale_latents=invert)
    return S2VPipeline(transformer_params=init_transformer_params_random(TCFG, device="cpu"), transformer_cfg=TCFG,
                       vae_params=init_vae_params_random(vcfg, device="cpu"), vae_cfg=vcfg, device="cpu")


def test_generate_pads_21_to_22_latent_frames_and_decodes_81():
    pipe = _tiny_pipe()
    g = torch.Generator().manual_seed(2)
    kw = dict(prompt_embeds=torch.randn(2, 16, 32, generator=g), ref_latents=torch.randn(1, 1, 2, 2, 4, generator=g),
              height=16, width=16, num_frames=81, num_inference_steps=2, seed=3)
    latents = pipe.generate(output_type="latent", **kw)
    assert latents.shape == (1, 22, 2, 2, 4)
    assert {k: pipe.stats[k] for k in ("tokens_text", "tokens_ref", "tokens_video", "pad_frames")} == {
        "tokens_text": 16, "tokens_ref": 1, "tokens_video": 11, "pad_frames": 1}
    decoded = []
    real = pipe.decode_latents
    pipe.decode_latents = lambda lat: decoded.append(lat) or real(lat)
    frames = pipe.generate(output_type="np", **kw)
    assert frames.shape == (1, 81, 16, 16, 3)
    assert torch.equal(decoded[0], latents[:, 1:])  # the padding frame dropped before the decode only
    with pytest.raises(ValueError, match="22 latent frames"):
        pipe.generate(latents=torch.zeros(1, 21, 2, 2, 4), output_type="latent", **kw)


def test_invert_scale_latents_divides_the_ref_latents():
    img = np.random.RandomState(0).uniform(-1, 1, (16, 16, 3)).astype(np.float32)
    plain, inverted = _tiny_pipe(False), _tiny_pipe(True)
    inverted.vae_params = plain.vae_params
    sf = plain.vae_cfg.scaling_factor
    a, b = plain.encode_ref_image(img), inverted.encode_ref_image(img)
    torch.testing.assert_close(b, a / (sf * sf), rtol=1e-6, atol=0)  # a = mean·sf, b = mean/sf


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A tiny 1.5 snapshot written through ``loaders/export_hf.py`` (``save_pretrained``), with a tokenizer."""
    import sys

    from PIL import Image

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from make_tiny_snapshot import write_tokenizer

    from s2v_torch.utils.tokenizer import T5CLSTokenizer

    root = tmp_path_factory.mktemp("cogvideox15")
    t5cfg = T5Config.tiny(d_model=TCFG.text_embed_dim)
    write_tokenizer(str(root / "tokenizer.json"), t5cfg.vocab_size)
    pipe = _tiny_pipe()
    pipe.t5_params, pipe.t5_cfg = init_t5_params_random(t5cfg, device="cpu"), t5cfg
    pipe.tokenizer = T5CLSTokenizer(str(root / "tokenizer.json"))
    snap = pipe.save_pretrained(str(root / "snapshot"))
    ref = str(root / "ref.png")
    Image.fromarray((np.random.RandomState(0).rand(32, 32, 3) * 255).astype("uint8")).save(ref)
    return snap, ref, pipe


def test_a_snapshot_through_the_exporter_loads_and_runs_through_the_cli(snapshot, tmp_path, capsys):
    import cv2

    snap, ref, pipe = snapshot
    loaded = S2VPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu")
    assert (loaded.transformer_cfg.patch_size_t, loaded.transformer_cfg.patch_bias) == (2, False)
    assert torch.equal(loaded.transformer_params["patch_embed"]["proj"]["weight"],
                       pipe.transformer_params["patch_embed"]["proj"]["weight"])
    cli.main(["--pretrained_model_name_or_path", snap, "--ref_img_path", ref, "--prompt", "<cls> a pig walking",
              "--height", "32", "--width", "32", "--max_num_frames", "9", "--num_inference_steps", "2",
              "--output_dir", str(tmp_path / "out"), "--device", "cpu", "--dtype", "float32"])
    assert "[s2v_torch] generated (1, 9, 32, 32, 3)" in capsys.readouterr().out
    cap = cv2.VideoCapture(str(tmp_path / "out" / "output.mp4"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 9
    cap.release()


def _refusals(snapshot):
    from s2v_torch.pipelines.variants import generate_t2v
    from s2v_torch.training.full import make_full_train_step
    from s2v_torch.training.lora import LoRASpec, make_lora_train_step

    snap = snapshot[0]
    x = torch.zeros(1, 2, 4, 4, 4)
    return {
        "windowed": lambda: _tiny_pipe().set_attention("windowed", 1),
        "flash_int8": lambda: _tiny_pipe().set_attention("flash_int8"),
        "sp_allgather": lambda: transformer_forward(init_transformer_params_random(TCFG, device="cpu"), TCFG, x,
                                                   None, torch.zeros(1, 16, 32), torch.ones(1),
                                                   attention_backend="sp_allgather"),
        "mesh": lambda: _tiny_pipe().set_mesh("tp1"),
        "int8_linears": lambda: S2VPipeline.from_pretrained(snap, dtype=torch.float32, quantize_int8=True,
                                                            device="cpu"),
        "lora_trainer": lambda: make_lora_train_step(init_transformer_params_random(TCFG, device="cpu"), TCFG,
                                                     LoRASpec(rank=2, alpha=2.0)),
        "full_trainer": lambda: make_full_train_step(TCFG),
        "t2v": lambda: generate_t2v(_tiny_pipe(), "a pig", height=16, width=16, num_frames=9),
    }


REFUSALS = ["windowed", "flash_int8", "sp_allgather", "mesh", "int8_linears", "lora_trainer", "full_trainer", "t2v"]


@pytest.mark.parametrize("path", REFUSALS)
def test_every_path_without_temporal_patches_raises_by_name(snapshot, path):
    with pytest.raises(NotImplementedError, match="patch_size_t=2"):
        _refusals(snapshot)[path]()


# -- on the card: the kernels at CogVideoX1.5's 49,186 tokens, past every shape the 5b and 2b run --------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


S15 = 226 + 4080 + 44880


@pytest.mark.gpu
def test_b1_at_the_1_5_shape(cuda):
    """B1 as generate calls it (bounded, with its M0 bound and guard) at
    [2, 49186, 48, 64] bf16, against its plain version on the first and the
    last head of both rows (the far ends of the 32-bit offsets), at the card
    tests' bf16 limits (2⁻⁶·max, 1e-2 relative L2)."""
    from test_torch_gpu import _assert_close

    from s2v_torch.kernels.flash_attention import flash_attention_reference
    from s2v_torch.ops.attention import flash_attention_trainable

    g = torch.Generator(device=cuda).manual_seed(15)
    q, k, v = (torch.randn(2, S15, 48, 64, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    o = flash_attention_trainable(q, k, v)
    torch.cuda.synchronize()
    heads = [0, 47]
    _assert_close(o[:, :, heads], flash_attention_reference(q[:, :, heads], k[:, :, heads], v[:, :, heads]))


@pytest.mark.gpu
def test_qk_norm_rope_kernel_at_the_1_5_shape(cuda):
    """The q/k kernel at [2, 49186, 48, 64] bf16 with the integer-grid tables
    of an 81x768x1360 clip, held to its emulation and the plain chain."""
    from test_torch_qk_norm_rope import _kernel_case, _norms, _qk

    q, k = _qk(2, S15, 48, torch.bfloat16, cuda, seed=15)
    cos, sin = _rope(TransformerConfig.cogvideox1_5_5b(), 22, 96, 170, 226)
    _kernel_case(q, k, *_norms(torch.bfloat16, cuda), cos.to(cuda), sin.to(cuda))
