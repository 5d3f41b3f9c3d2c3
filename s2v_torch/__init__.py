"""s2v_torch: the PyTorch/CUDA port of s2v_tpu for one NVIDIA H100.

Disentangled subject-to-video generation (CogVideoX-5b 3-stream DiT, T5-XXL,
3D causal VAE).  The JAX package ``s2v_tpu`` is the reference; this package
never imports it.  Entry points run on CUDA unless given ``device="cpu"``;
CUDA kernels are built from ``s2v_torch/csrc`` on first use.
"""

from s2v_torch.config import (
    PipelineConfig,
    SchedulerConfig,
    T5Config,
    TransformerConfig,
    VAEConfig,
)
from s2v_torch.pipelines.s2v import S2VPipeline

__all__ = [
    "PipelineConfig",
    "S2VPipeline",
    "SchedulerConfig",
    "T5Config",
    "TransformerConfig",
    "VAEConfig",
]
