"""Typed configuration of the port: the ``s2v_tpu.config`` dataclasses with
torch dtypes.  Defaults are the CogVideoX-5b / T5-XXL / CogVideoX VAE values;
``tiny()`` gives the CPU-test sizes of the JAX package's fixtures."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


def _from_hf_config(cls, path: str, overrides: dict):
    """A config from a HF ``config.json``: its keys that name a field of
    ``cls`` (lists as tuples), then ``overrides`` (e.g. ``dtype``)
    (``s2v_tpu/config.py:116``)."""
    with open(path) as f:
        raw = json.load(f)
    raw.update(overrides)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in raw.items() if k in names})


@dataclass(frozen=True)
class TransformerConfig:
    """CogVideoX 3D transformer (defaults: CogVideoX-5b; ``cogvideox_2b()``
    the 2b family: 30 heads and layers, sincos positions, fp16)."""

    num_attention_heads: int = 48
    attention_head_dim: int = 64
    in_channels: int = 16
    out_channels: int = 16
    time_embed_dim: int = 512
    text_embed_dim: int = 4096
    num_layers: int = 42
    # no port code reads it (nor JAX code); kept so configs round-trip
    attention_bias: bool = True
    # the positional table's sample size in latent pixels (the sincos path)
    sample_width: int = 90
    sample_height: int = 60
    sample_frames: int = 49
    patch_size: int = 2
    # latent frames per token (CogVideoX1.5: 2, tokens are 2x2x2 patches over
    # time, height and width); None: one latent frame per token grid
    patch_size_t: Optional[int] = None
    # the patch embedding's bias (CogVideoX1.5: False)
    patch_bias: bool = True
    temporal_compression_ratio: int = 4
    max_text_seq_length: int = 226
    norm_eps: float = 1e-5
    qk_norm_eps: float = 1e-6
    spatial_interpolation_scale: float = 1.875
    temporal_interpolation_scale: float = 1.0
    use_rotary_positional_embeddings: bool = True
    # no port code reads it (nor JAX code); kept so configs round-trip
    use_learned_positional_embeddings: bool = False
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    ff_mult: int = 4
    # the reference's intended enable_lora semantics: video and text are
    # modulated by the pre-merge adaLN linears (``base_linear`` beside each
    # block's norm1/norm2 ``linear``), the ref stream by the merged ones
    disentangled_modulation: bool = False
    # half-width in latent frames of the opt-in windowed attention backends
    # (a 2w + 1-frame window)
    attention_window_frames: int = 2
    dtype: torch.dtype = torch.bfloat16

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def ff_inner_dim(self) -> int:
        return self.inner_dim * self.ff_mult

    @classmethod
    def cogvideox_5b(cls, **overrides) -> "TransformerConfig":
        return cls(**overrides)

    @classmethod
    def cogvideox_2b(cls, **overrides) -> "TransformerConfig":
        """CogVideoX-2b (``s2v_tpu/config.py:82-92``): 30 heads of 64, 30
        layers, sincos positions, fp16."""
        base = dict(
            num_attention_heads=30,
            num_layers=30,
            attention_bias=True,
            use_rotary_positional_embeddings=False,
            dtype=torch.float16,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def cogvideox1_5_5b(cls, **overrides) -> "TransformerConfig":
        """CogVideoX1.5-5B: the 5b's widths with 2x2x2 patches (``patch_size_t``
        2, no patch bias) and the RoPE's integer grid of at most
        ``sample_height/p`` x ``sample_width/p`` = 150 x 150 patches."""
        base = dict(patch_size_t=2, patch_bias=False, sample_frames=81, sample_height=300, sample_width=300)
        base.update(overrides)
        return cls(**base)

    def require_frame_patches(self, what: str) -> None:
        """Raise, naming ``what``, for a path that has no temporal patches yet."""
        if self.patch_size_t is not None:
            raise NotImplementedError(
                f"{what} does not take temporal patches (patch_size_t={self.patch_size_t}, CogVideoX1.5) yet; "
                f"generate on one card with the flash, plain or chunked attention backend")

    @classmethod
    def tiny(cls, **overrides) -> "TransformerConfig":
        base = dict(
            num_attention_heads=4,
            attention_head_dim=16,
            in_channels=4,
            out_channels=4,
            time_embed_dim=16,
            text_embed_dim=32,
            num_layers=2,
            sample_width=8,
            sample_height=8,
            sample_frames=9,
            max_text_seq_length=16,
            dtype=torch.float32,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def from_hf_config(cls, path: str, **overrides) -> "TransformerConfig":
        return _from_hf_config(cls, path, overrides)


@dataclass(frozen=True)
class VAEConfig:
    """3D causal VAE (defaults: the CogVideoX VAE)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    # no port code reads these two (nor JAX code); kept so configs round-trip
    norm_eps: float = 1e-6
    norm_num_groups: int = 32
    temporal_compression_ratio: int = 4
    sample_height: int = 480
    sample_width: int = 720
    scaling_factor: float = 1.15258426
    invert_scale_latents: bool = False
    num_latent_frames_batch_size: int = 2
    num_sample_frames_batch_size: int = 8
    tile_overlap_factor_height: float = 1.0 / 6.0
    tile_overlap_factor_width: float = 1.0 / 5.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def spatial_compression_ratio(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @property
    def tile_sample_min_height(self) -> int:
        return self.sample_height // 2

    @property
    def tile_sample_min_width(self) -> int:
        return self.sample_width // 2

    @property
    def tile_latent_min_height(self) -> int:
        return int(self.tile_sample_min_height / self.spatial_compression_ratio)

    @property
    def tile_latent_min_width(self) -> int:
        return int(self.tile_sample_min_width / self.spatial_compression_ratio)

    @classmethod
    def tiny(cls, **overrides) -> "VAEConfig":
        base = dict(
            block_out_channels=(8, 8, 8, 8),
            latent_channels=4,
            layers_per_block=1,
            norm_num_groups=4,
            sample_height=32,
            sample_width=32,
            dtype=torch.float32,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def from_hf_config(cls, path: str, **overrides) -> "VAEConfig":
        return _from_hf_config(cls, path, overrides)


@dataclass(frozen=True)
class SchedulerConfig:
    """CogVideoX DDIM scheduler (defaults: the CogVideoX-5b hub scheduler)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.0120
    beta_schedule: str = "scaled_linear"
    set_alpha_to_one: bool = True
    steps_offset: int = 0
    prediction_type: str = "v_prediction"
    timestep_spacing: str = "trailing"
    rescale_betas_zero_snr: bool = True
    snr_shift_scale: float = 1.0

    @classmethod
    def from_hf_config(cls, path: str, **overrides) -> "SchedulerConfig":
        return _from_hf_config(cls, path, overrides)


@dataclass(frozen=True)
class T5Config:
    """T5 v1.1 encoder (defaults: t5-v1_1-xxl)."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls, **overrides) -> "T5Config":
        base = dict(
            vocab_size=128,
            d_model=32,
            d_kv=8,
            d_ff=64,
            num_layers=2,
            num_heads=4,
            dtype=torch.float32,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def from_hf_config(cls, path: str, **overrides) -> "T5Config":
        return _from_hf_config(cls, path, overrides)


@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end generation defaults (the reference CLI's)."""

    height: int = 480
    width: int = 720
    num_frames: int = 49
    num_inference_steps: int = 50
    guidance_scale: float = 6.0
    use_dynamic_cfg: bool = False
    max_sequence_length: int = 226
    fps: int = 8
    seed: int = 420

    def latent_frames(self, temporal_compression: int = 4) -> int:
        return (self.num_frames - 1) // temporal_compression + 1

    def latent_hw(self, spatial_compression: int = 8) -> Tuple[int, int]:
        return self.height // spatial_compression, self.width // spatial_compression
