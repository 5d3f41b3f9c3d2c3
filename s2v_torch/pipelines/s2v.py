"""End-to-end subject-to-video pipeline (counterpart of
``s2v_tpu/pipelines/s2v.py::S2VPipeline``).

T5 prompt encode (cond + uncond) -> VAE encode of the subject image ->
segmented RoPE tables -> the CFG denoise loop -> VAE decode -> postprocess.
The pipeline is built from its components: parameter dicts in the port's
layouts (random, or carried across with ``s2v_torch.loaders.jax_params``)
and their configs.  Everything runs on ``device`` (CUDA unless the caller
passes ``device="cpu"``).

int8 serving: ``pipe.transformer_params =
quantize_transformer_params(pipe.transformer_params)`` (int8 linears, see
``s2v_torch/ops/quant.py``) and ``pipe.set_attention("flash_int8")`` (kernel
B3); ``generate`` runs the int8 tree unchanged.

Sequence parallel: ``pipe.set_mesh(mesh)`` with a ``DeviceMesh`` whose one
dim is named ``seq`` (every rank builds the same pipeline and calls
``generate`` with the same arguments).  On a ring above 1 ``generate`` routes
``windowed`` to ``sp_windowed`` (kernels B6/B7 per frame shard); an explicit
``set_attention("sp_windowed", w)`` runs that path on a ring of 1 too.
Outside attention every rank computes the whole model (replicated), the VAE
decode included.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field, replace
from typing import Optional, Union

import numpy as np
import torch

from s2v_torch.config import PipelineConfig, SchedulerConfig, T5Config, TransformerConfig, VAEConfig
from s2v_torch.models.t5 import t5_encode
from s2v_torch.models.vae import gaussian_sample, vae_decode, vae_encode
from s2v_torch.ops.attention import WINDOWED_BACKENDS, resolve_attention_backend, route_seq_backend
from s2v_torch.ops.rope import build_segmented_rope, prepare_video_and_ref_rope
from s2v_torch.parallel.context import default_logical_map, mesh_context
from s2v_torch.pipelines.denoise import DenoiseSchedule, denoise
from s2v_torch.utils.device import resolve_device
from s2v_torch.utils.video import denormalize_video

PROMPT_CACHE_SIZE = 32


@dataclass
class S2VPipeline:
    """Holds parameters and configs; ``generate`` is the entry point."""

    transformer_params: dict
    transformer_cfg: TransformerConfig
    vae_params: dict
    vae_cfg: VAEConfig
    t5_params: Optional[dict] = None
    t5_cfg: Optional[T5Config] = None
    scheduler_cfg: SchedulerConfig = field(default_factory=SchedulerConfig)
    # generate()'s defaults for every argument it is not given
    pipeline_cfg: PipelineConfig = field(default_factory=PipelineConfig)
    tokenizer: Optional[object] = None  # .encode(prompts, max_length) -> int ids
    device: Optional[Union[str, torch.device]] = None
    # "auto": the flash kernel on CUDA, the plain fp32 attention on the CPU;
    # set_attention selects another backend (flash_int8, a windowed one and its width)
    attention_backend: str = "auto"
    # "auto" tiles the VAE only when the frame exceeds the VAE's sample size
    # (so 480x720 decodes untiled, the exact decoder output); True / False force it
    vae_tiling: object = "auto"
    vae_slicing: bool = True
    # a DeviceMesh with one dim "seq" (set_mesh), or None: one card
    mesh: Optional[object] = None
    # host-clock seconds of the last generate()'s stages, each ended by a device sync
    timings: dict = field(default_factory=dict, repr=False)
    _prompt_embed_cache: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def set_attention(self, backend: str, window: Optional[int] = None) -> None:
        """Set the attention backend (``auto`` resolves on this device) and,
        for the windowed family, the window half-width in latent frames
        (``s2v_tpu/pipelines/s2v.py:142-158``)."""
        backend = resolve_attention_backend(backend, self.device)
        self.attention_backend = backend
        if backend in WINDOWED_BACKENDS and window is not None:
            self.transformer_cfg = replace(self.transformer_cfg, attention_window_frames=window)

    def set_mesh(self, mesh) -> None:
        """Attach a ``torch.distributed.device_mesh.DeviceMesh`` whose one
        dim is named ``seq`` (its process group already initialised), or
        None (back to one card) (``s2v_tpu/pipelines/s2v.py:78``).  The
        params stay whole on every rank.  A ``data`` or ``model`` dim raises
        ``NotImplementedError``: TP/FSDP and data parallelism are not ported
        (ROADMAP A.9)."""
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names or ())
            if names != ("seq",):
                raise NotImplementedError(
                    f"set_mesh takes a mesh with one dim named 'seq'; got dims {names} (data/model parallelism "
                    f"is not ported yet, ROADMAP A.9)")
            if mesh.device_type != self.device.type:
                raise ValueError(f"the mesh is on {mesh.device_type}, the pipeline on {self.device.type}")
        self.mesh = mesh

    def _mesh_ctx(self):
        """The mesh context the denoise loop runs under (``s2v_tpu/pipelines/s2v.py:127-134``)."""
        if self.mesh is None:
            return nullcontext()
        return mesh_context(self.mesh, default_logical_map(self.mesh))

    def _seq_ring(self) -> int:
        """Ranks of the mesh's ``seq`` dim (1 without a mesh) (``:136-140``)."""
        if self.mesh is None:
            return 1
        return self.mesh.size(list(self.mesh.mesh_dim_names).index("seq"))

    def _resolve_tiling(self, height_px: int, width_px: int) -> bool:
        if self.vae_tiling == "auto":
            return height_px > self.vae_cfg.sample_height or width_px > self.vae_cfg.sample_width
        return bool(self.vae_tiling)

    @contextmanager
    def _timed(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[name] = time.perf_counter() - t0

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    def encode_prompt(
        self,
        prompt: Union[str, list],
        negative_prompt: Union[str, list, None] = None,
        max_sequence_length: Optional[int] = None,
        do_cfg: bool = True,
    ) -> torch.Tensor:
        """-> ``[2B (uncond | cond), T, d_model]`` (``[B, ...]`` without CFG);
        the negative prompt defaults to ""."""
        if self.t5_params is None or self.tokenizer is None:
            raise ValueError("pipeline built without a text encoder/tokenizer; pass prompt_embeds")
        if max_sequence_length is None:
            max_sequence_length = self.transformer_cfg.max_text_seq_length
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        cond = self._encode_texts(prompts, max_sequence_length)
        if not do_cfg:
            return cond
        neg = negative_prompt if negative_prompt is not None else ""
        negs = [neg] * len(prompts) if isinstance(neg, str) else list(neg)
        return torch.cat([self._encode_texts(negs, max_sequence_length), cond], dim=0)

    def _encode_texts(self, texts: list, max_length: int) -> torch.Tensor:
        """T5-encode with a per-text embedding cache (FIFO, at most
        ``PROMPT_CACHE_SIZE`` entries; never evicts what this call needs)."""
        missing = list(dict.fromkeys(t for t in texts if (t, max_length) not in self._prompt_embed_cache))
        if missing:
            ids = torch.as_tensor(self.tokenizer.encode(missing, max_length), device=self.device)
            emb = t5_encode(self.t5_params, self.t5_cfg, ids)
            needed = {(t, max_length) for t in texts}
            for key in list(self._prompt_embed_cache):
                if len(self._prompt_embed_cache) + len(missing) <= PROMPT_CACHE_SIZE:
                    break
                if key not in needed:
                    self._prompt_embed_cache.pop(key)
            for t, e in zip(missing, emb):
                self._prompt_embed_cache[(t, max_length)] = e
        return torch.stack([self._prompt_embed_cache[(t, max_length)] for t in texts], dim=0)

    def encode_ref_image(self, image, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``[H, W, 3]`` image in [-1, 1] -> scaled ref latents ``[1, 1, h, w, C]``:
        a posterior sample (noise from the CPU ``generator``) or, without a
        generator, the posterior mean."""
        x = torch.as_tensor(np.asarray(image, np.float32)).to(self.device, self.vae_cfg.dtype)[None, None]
        moments = vae_encode(
            self.vae_params, self.vae_cfg, x,
            use_tiling=self._resolve_tiling(x.shape[2], x.shape[3]), use_slicing=self.vae_slicing,
        )
        noise = None
        if generator is not None:
            shape = moments.shape[:-1] + (moments.shape[-1] // 2,)
            noise = torch.randn(shape, generator=generator, dtype=torch.float32).to(self.device, moments.dtype)
        return gaussian_sample(moments, noise) * self.vae_cfg.scaling_factor

    def prepare_rope(self, height: int, width: int, num_latent_frames: int):
        cfg = self.transformer_cfg
        if not cfg.use_rotary_positional_embeddings:
            return None, None
        vc, vs, rc, rs = prepare_video_and_ref_rope(
            height, width, num_latent_frames, cfg.attention_head_dim, cfg.patch_size,
            self.vae_cfg.spatial_compression_ratio,
        )
        return build_segmented_rope(cfg.max_text_seq_length, rc, rs, vc, vs, device=self.device)

    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """Latents ``[B, F, h, w, C]`` -> frames ``[B, T, H, W, 3]`` float32 in [0, 1]."""
        z = latents.to(self.vae_cfg.dtype) / self.vae_cfg.scaling_factor
        sc = self.vae_cfg.spatial_compression_ratio
        frames = vae_decode(
            self.vae_params, self.vae_cfg, z,
            use_tiling=self._resolve_tiling(z.shape[2] * sc, z.shape[3] * sc), use_slicing=self.vae_slicing,
        )
        return denormalize_video(frames.float().cpu().numpy())

    def postprocess_video(self, video01: np.ndarray, output_type: str):
        """``np``: the float array ``[B, T, H, W, 3]`` in [0, 1]."""
        if output_type == "np":
            return video01
        raise ValueError(f"unknown output_type {output_type!r} (np | latent)")

    # ------------------------------------------------------------------
    # end to end
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def generate(
        self,
        prompt: Optional[Union[str, list]] = None,
        ref_image=None,
        negative_prompt: Optional[str] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_frames: Optional[int] = None,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        use_dynamic_cfg: Optional[bool] = None,
        num_videos_per_prompt: int = 1,
        seed: Optional[int] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        ref_latents: Optional[torch.Tensor] = None,
        output_type: str = "np",
        cfg_mode: str = "auto",  # auto: batched, except a batch > 1 -> sequential
    ):
        """Generate a clip: ``[B, T, H, W, 3]`` float in [0, 1] (``np``) or the
        final latents (``latent``).  The latents and the ref posterior noise
        are drawn from CPU ``torch.Generator``s seeded from ``seed``.  An
        argument left at None takes its value from ``self.pipeline_cfg``."""
        given = dict(height=height, width=width, num_frames=num_frames, num_inference_steps=num_inference_steps,
                     guidance_scale=guidance_scale, use_dynamic_cfg=use_dynamic_cfg, seed=seed)
        run = replace(self.pipeline_cfg, **{k: v for k, v in given.items() if v is not None})
        height, width, num_frames = run.height, run.width, run.num_frames
        num_inference_steps, guidance_scale = run.num_inference_steps, run.guidance_scale
        cfg = self.transformer_cfg
        backend, _ = route_seq_backend(resolve_attention_backend(self.attention_backend, self.device),
                                       cfg.num_attention_heads, self._seq_ring())

        if num_frames > cfg.sample_frames and not cfg.use_rotary_positional_embeddings:
            raise ValueError(f"num_frames must be <= {cfg.sample_frames} (static positional embeddings)")
        sc_total = self.vae_cfg.spatial_compression_ratio * cfg.patch_size
        if height % sc_total or width % sc_total:
            raise ValueError(f"height/width must be divisible by {sc_total}")
        if prompt is None and prompt_embeds is None:
            raise ValueError("provide prompt or prompt_embeds")
        if prompt is not None and prompt_embeds is not None:
            raise ValueError("provide only one of prompt / prompt_embeds")
        if prompt is not None and not isinstance(prompt, (str, list)):
            raise ValueError(f"prompt must be str or list, got {type(prompt)}")
        if isinstance(prompt, list) and not all(isinstance(p, str) for p in prompt):
            raise ValueError("prompt list must contain only strings")
        if prompt_embeds is not None and negative_prompt is not None:
            raise ValueError(
                "negative_prompt is ignored when prompt_embeds is provided "
                "(pass [uncond | cond] rows in prompt_embeds instead)"
            )
        if ref_image is not None and ref_latents is not None:
            raise ValueError("provide only one of ref_image / ref_latents")
        if num_inference_steps < 1:
            raise ValueError("num_inference_steps must be >= 1")
        if num_frames < 1:
            raise ValueError("num_frames must be >= 1")
        if output_type not in ("np", "latent"):
            raise ValueError(f"unknown output_type {output_type!r} (np | latent)")

        self.timings = {}
        seeds = torch.randint(2**62, (2,), generator=torch.Generator().manual_seed(run.seed))
        gen_latents = torch.Generator().manual_seed(int(seeds[0]))
        gen_ref = torch.Generator().manual_seed(int(seeds[1]))

        do_cfg = guidance_scale > 1.0
        if prompt_embeds is None:
            with self._timed("encode_prompt_s"):
                prompt_embeds = self.encode_prompt(prompt, negative_prompt, do_cfg=do_cfg)
        prompt_embeds = prompt_embeds.to(self.device, cfg.dtype)
        if num_videos_per_prompt > 1:
            prompt_embeds = prompt_embeds.repeat_interleave(num_videos_per_prompt, dim=0)
        batch = prompt_embeds.shape[0] // (2 if do_cfg else 1)

        if ref_latents is None:
            if ref_image is None:
                raise ValueError("need ref_image or ref_latents")
            with self._timed("encode_ref_s"):
                ref_latents = self.encode_ref_image(ref_image, gen_ref)
        ref_latents = ref_latents.to(self.device, cfg.dtype)
        if ref_latents.shape[0] == 1 and batch > 1:
            ref_latents = ref_latents.expand(batch, *ref_latents.shape[1:])

        f_lat = run.latent_frames(self.vae_cfg.temporal_compression_ratio)
        h_lat, w_lat = run.latent_hw(self.vae_cfg.spatial_compression_ratio)
        if latents is None:
            latents = torch.randn((batch, f_lat, h_lat, w_lat, cfg.in_channels), generator=gen_latents)
        latents = latents.to(self.device, cfg.dtype)

        rope_cos, rope_sin = self.prepare_rope(height, width, f_lat)
        schedule = DenoiseSchedule.create(self.scheduler_cfg, num_inference_steps, guidance_scale, run.use_dynamic_cfg)
        if cfg_mode == "auto":
            cfg_mode = "sequential" if batch > 1 else "batched"

        step_times = []
        t_step = [time.perf_counter()]

        def on_step(_i):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            step_times.append(now - t_step[0])
            t_step[0] = now

        with self._mesh_ctx():
            final = denoise(
                self.transformer_params, cfg, schedule, latents, ref_latents, prompt_embeds, rope_cos, rope_sin,
                do_cfg=do_cfg, attention_backend=backend, cfg_mode=cfg_mode, step_callback=on_step,
            )
        self.timings["denoise_step_s"] = step_times
        if output_type == "latent":
            return final
        with self._timed("decode_s"):
            return self.postprocess_video(self.decode_latents(final), output_type)
