"""Text-, image-, control- and video-conditioned variants of the pipeline
(counterpart of ``s2v_tpu/pipelines/variants.py``), on the components of an
:class:`~s2v_torch.pipelines.s2v.S2VPipeline`:

  * t2v: no reference-image stream (a zero-width ref stream, the attended
    sequence ``[text | video]``), stock CogVideoX semantics;
  * i2v: the image's latents (frame 0, zeros after) concatenated to the
    noise latents on the channel axis in every step, for checkpoints with
    ``in_channels`` = 2 x the VAE's latent channels;
  * fun-control: the control video's latents concatenated at every frame;
  * v2v: the input video's latents noised to the schedule's first kept
    timestep, the schedule truncated by ``strength``.

Positions: the RoPE tables, or for a model without RoPE (the 2b family)
the sincos ``[text | video]`` table that ``generate`` builds
(:meth:`S2VPipeline.prepare_pos_embedding`), capped at ``sample_frames``.
The JAX package's t2v calls the table's function with the wrong arguments and
raises on every sincos model, and its other variants pass no table at all
(ROADMAP C.17, C.18); the port builds the table for each.

Random draws come from one replaceable source, ``pipe.variant_noise(name,
shape)`` -> a CPU fp32 tensor (the latents ``"latents"``, the condition's
posterior ``"cond"``, the ref image's posterior ``"ref"``, v2v's posterior
``"video_posterior"`` and noise ``"video_noise"``); unset, each name draws
from a CPU generator seeded by ``(seed, name)``.  The tests inject the JAX
package's draws there.  Each call leaves its stage seconds in
``pipe.timings``.
"""

from __future__ import annotations

import zlib
from typing import Optional, Union

import numpy as np
import torch

from s2v_torch.ops.attention import resolve_attention_backend
from s2v_torch.ops.rope import build_segmented_rope, prepare_video_and_ref_rope
from s2v_torch.pipelines.denoise import DenoiseSchedule, denoise
from s2v_torch.schedulers.ddim import add_noise, compute_alphas_cumprod
from s2v_torch.utils.video import load_image


class VariantNoise:
    """The variants' default draws: the draw named ``name`` comes from a CPU
    generator seeded by ``(seed, crc32(name))``."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def __call__(self, name: str, shape) -> torch.Tensor:
        state = np.random.SeedSequence([self.seed, zlib.crc32(name.encode())]).generate_state(1, np.uint64)[0]
        return torch.randn(tuple(shape), generator=torch.Generator().manual_seed(int(state)))


def _noise(pipe, seed: int):
    return pipe.variant_noise if pipe.variant_noise is not None else VariantNoise(seed)


def _draw(noise, name: str):
    return lambda shape: noise(name, shape)


def _image_latents(pipe, image, draw) -> torch.Tensor:
    """An image path or an ``[H, W, 3]`` array in [-1, 1] -> scaled latents
    ``[1, 1, h, w, C]`` (a posterior sample with ``draw``'s noise)."""
    if isinstance(image, str):
        image = load_image(image)
    return pipe.encode_pixels(torch.as_tensor(np.asarray(image, np.float32))[None, None], draw)


def _pad_channels(ref: torch.Tensor, channels: int) -> torch.Tensor:
    """I2V checkpoints patch-embed (noise | condition) channels, and the ref
    stream goes through the same conv: zero-pad its latent channels."""
    if ref.shape[-1] >= channels:
        return ref
    return torch.cat([ref, ref.new_zeros((*ref.shape[:-1], channels - ref.shape[-1]))], dim=-1)


def prepare_i2v_cond_latents(pipe, image, num_latent_frames: int, draw=None) -> torch.Tensor:
    """image -> ``[1, F_lat, h, w, C]`` scaled latents: frame 0 the image's
    (a posterior sample with ``draw(shape)``'s noise, or the mean), the rest
    zeros (``s2v_tpu/pipelines/variants.py:31``)."""
    z = _image_latents(pipe, image, draw)
    return torch.cat([z, z.new_zeros((z.shape[0], num_latent_frames - 1, *z.shape[2:]))], dim=1)


def prepare_v2v_latents(pipe, video: torch.Tensor, schedule: DenoiseSchedule, noise) -> torch.Tensor:
    """Encode the input video ``[B, T, H, W, 3]`` in [-1, 1] and noise it to
    the (truncated) schedule's first timestep; ``noise`` is the variants'
    source (``"video_posterior"``, ``"video_noise"``;
    ``s2v_tpu/pipelines/variants.py:40``)."""
    # tiled past the VAE's tile size, as the JAX package's vae_encode defaults to
    init = pipe.encode_pixels(video, _draw(noise, "video_posterior"), use_tiling=True)
    eps = noise("video_noise", tuple(init.shape)).to(init.device, init.dtype)
    alphas = torch.as_tensor(compute_alphas_cumprod(pipe.scheduler_cfg), device=init.device)
    t0 = torch.as_tensor([int(schedule.timesteps[0])], device=init.device)
    return add_noise(init, eps, alphas, t0)


def _latent_grid(pipe, height: int, width: int, num_frames: int):
    sc = pipe.vae_cfg.spatial_compression_ratio
    return (num_frames - 1) // pipe.vae_cfg.temporal_compression_ratio + 1, height // sc, width // sc


def _encode_prompt(pipe, prompt, do_cfg: bool) -> torch.Tensor:
    with pipe._timed("encode_prompt_s"):
        return pipe.encode_prompt(prompt, do_cfg=do_cfg).to(pipe.device, pipe.transformer_cfg.dtype)


def _run(pipe, schedule, latents, ref_latents, prompt_embeds, rope, pos_embedding, do_cfg, output_type,
         cond_latents=None):
    """The denoise loop (step seconds in ``pipe.timings``), then the decode."""
    timer = pipe._step_timer()
    final = denoise(
        pipe.transformer_params, pipe.transformer_cfg, schedule, latents, ref_latents, prompt_embeds, *rope,
        do_cfg=do_cfg, attention_backend=resolve_attention_backend(pipe.attention_backend, pipe.device),
        step_callback=timer, pos_embedding=pos_embedding, cond_latents=cond_latents,
    )
    timer.finish()
    return final if output_type == "latent" else pipe._decode_timed(final)


@torch.inference_mode()
def generate_t2v(
    pipe,
    prompt: str,
    height: int = 480,
    width: int = 720,
    num_frames: int = 49,
    num_inference_steps: int = 50,
    guidance_scale: float = 6.0,
    use_dynamic_cfg: bool = False,
    seed: int = 420,
    output_type: str = "np",
):
    """Text-to-video with no reference-image stream; ``[1, T, H, W, 3]`` in
    [0, 1] (``np``) or the final latents (``latent``).  A RoPE model gets
    tables with an empty ref segment, a sincos model the ``generate``
    table (``s2v_tpu/pipelines/variants.py:62``, without its C.17)."""
    cfg = pipe.transformer_cfg
    pipe.check_frames(num_frames)
    pipe.timings = {}
    noise = _noise(pipe, seed)
    do_cfg = guidance_scale > 1.0
    prompt_embeds = _encode_prompt(pipe, prompt, do_cfg)
    f_lat, h_lat, w_lat = _latent_grid(pipe, height, width, num_frames)
    latents = noise("latents", (1, f_lat, h_lat, w_lat, cfg.in_channels)).to(pipe.device, cfg.dtype)
    rope = (None, None)
    if cfg.use_rotary_positional_embeddings:
        vc, vs, rc, rs = prepare_video_and_ref_rope(height, width, f_lat, cfg.attention_head_dim, cfg.patch_size,
                                                    pipe.vae_cfg.spatial_compression_ratio)
        # a zero-width ref segment: [text (identity) | video]
        rope = build_segmented_rope(cfg.max_text_seq_length, rc[:0], rs[:0], vc, vs, device=pipe.device)
    schedule = DenoiseSchedule.create(pipe.scheduler_cfg, num_inference_steps, guidance_scale, use_dynamic_cfg)
    return _run(pipe, schedule, latents, None, prompt_embeds, rope,
                pipe.prepare_pos_embedding(height, width, num_frames), do_cfg, output_type)


@torch.inference_mode()
def generate_i2v(
    pipe,
    prompt: str,
    image: Union[str, np.ndarray],
    ref_latents: Optional[torch.Tensor] = None,
    height: int = 480,
    width: int = 720,
    num_frames: int = 49,
    num_inference_steps: int = 50,
    guidance_scale: float = 6.0,
    use_dynamic_cfg: bool = False,
    seed: int = 420,
    output_type: str = "np",
):
    """Image-conditioned generation: the image's latents concatenated on the
    channel axis each step; the subject stream is the same image unless
    ``ref_latents`` are given (``s2v_tpu/pipelines/variants.py:131``)."""
    cfg = pipe.transformer_cfg
    pipe.check_frames(num_frames)
    pipe.timings = {}
    noise = _noise(pipe, seed)
    do_cfg = guidance_scale > 1.0
    prompt_embeds = _encode_prompt(pipe, prompt, do_cfg)
    f_lat, h_lat, w_lat = _latent_grid(pipe, height, width, num_frames)
    with pipe._timed("encode_s"):
        cond = prepare_i2v_cond_latents(pipe, image, f_lat, _draw(noise, "cond")).to(cfg.dtype)
        if ref_latents is None:
            ref_latents = _image_latents(pipe, image, _draw(noise, "ref"))
    ref_latents = _pad_channels(torch.as_tensor(ref_latents).to(pipe.device, cfg.dtype), cfg.in_channels)
    noise_ch = cfg.in_channels - cond.shape[-1]
    latents = noise("latents", (1, f_lat, h_lat, w_lat, noise_ch)).to(pipe.device, cfg.dtype)
    schedule = DenoiseSchedule.create(pipe.scheduler_cfg, num_inference_steps, guidance_scale, use_dynamic_cfg)
    return _run(pipe, schedule, latents, ref_latents, prompt_embeds, pipe.prepare_rope(height, width, f_lat),
                pipe.prepare_pos_embedding(height, width, num_frames), do_cfg, output_type, cond_latents=cond)


def _as_clip(video) -> torch.Tensor:
    """``[T, H, W, 3]`` or ``[B, T, H, W, 3]`` -> a fp32 ``[B, T, H, W, 3]`` tensor."""
    video = torch.as_tensor(np.asarray(video, np.float32)) if not isinstance(video, torch.Tensor) else video.float()
    return video[None] if video.dim() == 4 else video


@torch.inference_mode()
def generate_fun_control(
    pipe,
    prompt: str,
    control_video,  # [T, H, W, 3] in [-1, 1]
    ref_image=None,
    num_inference_steps: int = 50,
    guidance_scale: float = 6.0,
    use_dynamic_cfg: bool = False,
    seed: int = 420,
    output_type: str = "np",
):
    """Control-video conditioned generation: the control video's latents
    concatenated on the channel axis at every frame; the subject stream is
    ``ref_image``, else the control video's first frame
    (``s2v_tpu/pipelines/variants.py:189``)."""
    cfg = pipe.transformer_cfg
    control_video = _as_clip(control_video)
    height, width, num_frames = int(control_video.shape[2]), int(control_video.shape[3]), int(control_video.shape[1])
    pipe.check_frames(num_frames)
    pipe.timings = {}
    noise = _noise(pipe, seed)
    do_cfg = guidance_scale > 1.0
    prompt_embeds = _encode_prompt(pipe, prompt, do_cfg)
    with pipe._timed("encode_s"):
        cond = pipe.encode_pixels(control_video, _draw(noise, "cond"), use_tiling=True).to(cfg.dtype)
        if ref_image is None:
            ref_image = control_video[0, 0].cpu().numpy()
        ref_latents = _pad_channels(_image_latents(pipe, ref_image, _draw(noise, "ref")).to(cfg.dtype),
                                    cfg.in_channels)
    f_lat = cond.shape[1]
    sc = pipe.vae_cfg.spatial_compression_ratio
    latents = noise("latents", (1, f_lat, height // sc, width // sc, cfg.in_channels - cond.shape[-1]))
    schedule = DenoiseSchedule.create(pipe.scheduler_cfg, num_inference_steps, guidance_scale, use_dynamic_cfg)
    return _run(pipe, schedule, latents.to(pipe.device, cfg.dtype), ref_latents, prompt_embeds,
                pipe.prepare_rope(height, width, f_lat), pipe.prepare_pos_embedding(height, width, num_frames),
                do_cfg, output_type, cond_latents=cond)


@torch.inference_mode()
def generate_v2v(
    pipe,
    prompt: str,
    video,  # [T, H, W, 3] or [B, T, H, W, 3] in [-1, 1]
    ref_image=None,
    ref_latents: Optional[torch.Tensor] = None,
    strength: float = 0.8,
    num_inference_steps: int = 50,
    guidance_scale: float = 6.0,
    use_dynamic_cfg: bool = False,
    seed: int = 420,
    output_type: str = "np",
):
    """Video-to-video: the input video re-noised to the last ``strength``
    of the schedule and denoised from there; the subject stream is
    ``ref_latents``, ``ref_image``, else the video's first frame
    (``s2v_tpu/pipelines/variants.py:254``)."""
    cfg = pipe.transformer_cfg
    video = _as_clip(video)
    height, width, num_frames = int(video.shape[2]), int(video.shape[3]), int(video.shape[1])
    pipe.check_frames(num_frames)
    pipe.timings = {}
    noise = _noise(pipe, seed)
    do_cfg = guidance_scale > 1.0
    prompt_embeds = _encode_prompt(pipe, prompt, do_cfg)
    schedule = DenoiseSchedule.create(pipe.scheduler_cfg, num_inference_steps, guidance_scale,
                                      use_dynamic_cfg).truncate(strength)
    with pipe._timed("encode_s"):
        latents = prepare_v2v_latents(pipe, video, schedule, noise).to(cfg.dtype)
        if ref_latents is None:
            if ref_image is None:
                ref_image = video[0, 0].cpu().numpy()
            ref_latents = _image_latents(pipe, ref_image, _draw(noise, "ref"))
    ref_latents = torch.as_tensor(ref_latents).to(pipe.device, cfg.dtype)
    return _run(pipe, schedule, latents, ref_latents, prompt_embeds,
                pipe.prepare_rope(height, width, latents.shape[1]),
                pipe.prepare_pos_embedding(height, width, num_frames), do_cfg, output_type)
