"""CogVideoX DDIM scheduler as stateless functions
(counterpart of ``s2v_tpu/schedulers/ddim.py``).  The schedule tables are
host numpy; the per-step update runs on tensors in fp32."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from s2v_torch.config import SchedulerConfig


def _rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    a_sqrt = np.sqrt(alphas_cumprod)
    a0, aT = a_sqrt[0], a_sqrt[-1]
    a_sqrt = (a_sqrt - aT) * a0 / (a0 - aT)
    return a_sqrt**2


def compute_alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    """fp32 alpha-bar table of length ``num_train_timesteps`` (betas in float64)."""
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, n, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    else:
        raise NotImplementedError(cfg.beta_schedule)
    alphas_cumprod = np.cumprod(1.0 - betas)
    s = cfg.snr_shift_scale
    alphas_cumprod = alphas_cumprod / (s + (1.0 - s) * alphas_cumprod)
    if cfg.rescale_betas_zero_snr:
        alphas_cumprod = _rescale_zero_terminal_snr(alphas_cumprod)
    return alphas_cumprod.astype(np.float32)


def get_timesteps(cfg: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending int64 timesteps."""
    n = cfg.num_train_timesteps
    if num_inference_steps > n:
        raise ValueError(f"num_inference_steps {num_inference_steps} > {n}")
    if cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, n - 1, num_inference_steps).round()[::-1].astype(np.int64)
    elif cfg.timestep_spacing == "leading":
        step_ratio = n // num_inference_steps
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        ts = ts + cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        step_ratio = n / num_inference_steps
        ts = np.round(np.arange(n, 0, -step_ratio)).astype(np.int64) - 1
    else:
        raise ValueError(cfg.timestep_spacing)
    return ts.copy()


def _pred_x0(prediction_type: str, model_output, sample, alpha_prod_t):
    beta_prod_t = 1.0 - alpha_prod_t
    if prediction_type == "epsilon":
        return (sample - beta_prod_t**0.5 * model_output) / alpha_prod_t**0.5
    if prediction_type == "sample":
        return model_output
    if prediction_type == "v_prediction":
        return alpha_prod_t**0.5 * sample - beta_prod_t**0.5 * model_output
    raise ValueError(prediction_type)


def alpha_pair_for_step(
    alphas_cumprod: np.ndarray,
    timesteps: np.ndarray,
    num_train_timesteps: int,
    num_inference_steps: int,
    set_alpha_to_one: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-inference-step (alpha_prod_t, alpha_prod_t_prev) tables."""
    prev = timesteps - num_train_timesteps // num_inference_steps
    a_t = alphas_cumprod[timesteps]
    final = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
    a_prev = np.where(prev >= 0, alphas_cumprod[np.clip(prev, 0, None)], final)
    return a_t.astype(np.float32), a_prev.astype(np.float32)


def ddim_step(
    model_output: torch.Tensor,
    sample: torch.Tensor,
    alpha_prod_t: float,
    alpha_prod_t_prev: float,
    prediction_type: str = "v_prediction",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic DDIM update; returns (prev_sample, pred_original_sample)
    in the sample's dtype, math in fp32."""
    dt = sample.dtype
    a_t = torch.tensor(alpha_prod_t, dtype=torch.float32)
    a_prev = torch.tensor(alpha_prod_t_prev, dtype=torch.float32)
    x = sample.float()
    x0 = _pred_x0(prediction_type, model_output.float(), x, a_t)
    c_x = ((1.0 - a_prev) / (1.0 - a_t)) ** 0.5
    c_x0 = a_prev**0.5 - a_t**0.5 * c_x
    prev = c_x * x + c_x0 * x0
    return prev.to(dt), x0.to(dt)


def _alpha_at(alphas_cumprod, timesteps, like: torch.Tensor) -> torch.Tensor:
    """alpha-bar at ``timesteps``, in ``like``'s dtype, shaped to broadcast
    against it.  A timestep tensor is used where it lies: the table is
    indexed on that device, with no host sync.  Host ints and numpy arrays
    index the host table."""
    if isinstance(timesteps, torch.Tensor):
        table = torch.as_tensor(alphas_cumprod, device=timesteps.device)
        a = table[timesteps.long()]
    else:
        a = torch.as_tensor(np.asarray(alphas_cumprod)[np.asarray(timesteps)])
    a = a.to(like.device, like.dtype)
    return a.reshape(a.shape + (1,) * (like.dim() - a.dim()))


def add_noise(original: torch.Tensor, noise: torch.Tensor, alphas_cumprod, timesteps) -> torch.Tensor:
    a = _alpha_at(alphas_cumprod, timesteps, original)
    return a**0.5 * original + (1.0 - a) ** 0.5 * noise


def get_velocity(sample: torch.Tensor, noise: torch.Tensor, alphas_cumprod, timesteps) -> torch.Tensor:
    a = _alpha_at(alphas_cumprod, timesteps, sample)
    return a**0.5 * noise - (1.0 - a) ** 0.5 * sample
