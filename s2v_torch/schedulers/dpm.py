"""CogVideoX DPM-Solver++(2M)-style scheduler step (counterpart of
``s2v_tpu/schedulers/dpm.py``).

``dpm_multipliers`` builds the lambda-space per-step constants on the host
(float64, returned as float32); ``dpm_step`` is the stochastic two-sample
update on tensors.  The caller draws both gaussian samples, so the loop's
randomness stays explicit and injectable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def dpm_multipliers(
    alphas_cumprod: np.ndarray,
    timesteps: np.ndarray,
    num_train_timesteps: int,
    num_inference_steps: int,
    set_alpha_to_one: bool = True,
) -> dict:
    """Per-step constants of the DPM update, each a float32 ``[num_steps]``
    array: ``mult1``-``mult4``, ``mult_noise``, ``a_t`` (alpha_prod_t) and
    ``has_back`` (1 where a previous step's x0 exists and prev_timestep >= 0).
    Step i takes timestep_back = timesteps[i - 1]."""
    n_steps = len(timesteps)
    prev = timesteps - num_train_timesteps // num_inference_steps
    a_t = alphas_cumprod[timesteps].astype(np.float64)
    final = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
    a_prev = np.where(prev >= 0, alphas_cumprod[np.clip(prev, 0, None)], final).astype(np.float64)

    # Zero terminal SNR gives a_t == 0 (lamb = -inf) at the first step and
    # set_alpha_to_one a_prev == 1 (lamb_next = +inf) at the last; both
    # collapse to finite multipliers below, and every table is checked finite.
    with np.errstate(divide="ignore"):
        lamb = np.log(np.sqrt(a_t / (1.0 - a_t)))
        lamb_next = np.log(np.sqrt(a_prev / (1.0 - a_prev)))
    h = lamb_next - lamb

    # step 0 has no timestep_back: 0 explicitly, not lamb[0] - lamb[0]
    # (-inf - -inf = NaN under zero SNR)
    h_last = np.zeros_like(h)
    h_last[1:] = lamb[1:] - lamb[:-1]
    with np.errstate(invalid="ignore"):
        r = np.divide(h_last, h, out=np.ones_like(h), where=h != 0)
    # r = 0 (step 0) and r = NaN are masked to 1.  NaN is inf / inf: a step
    # that follows lamb = -inf and ends at lamb_next = +inf, step 1 of a
    # 2-step schedule, where has_back is 0 and r is never read.  The JAX
    # package raises on that lane; the reference takes the first-order update.
    r = np.where((r != 0) & ~np.isnan(r), r, 1.0)

    mult1 = np.sqrt((1.0 - a_prev) / (1.0 - a_t)) * np.exp(-h)
    mult2 = np.expm1(-2.0 * h) * np.sqrt(a_prev)
    mult3 = 1.0 + 1.0 / (2.0 * r)
    mult4 = 1.0 / (2.0 * r)
    mult_noise = np.sqrt(1.0 - a_prev) * np.sqrt(1.0 - np.exp(-2.0 * h))

    has_back = np.zeros(n_steps)
    has_back[1:] = 1.0
    has_back = np.where(prev >= 0, has_back, 0.0)

    out = {"mult1": mult1, "mult2": mult2, "mult3": mult3, "mult4": mult4, "mult_noise": mult_noise,
           "a_t": a_t, "has_back": has_back}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    for name, table in out.items():
        if not np.isfinite(table).all():
            raise FloatingPointError(f"dpm_multipliers: non-finite entries in {name!r} — the endpoint-infinity "
                                     f"collapse failed for this schedule")
    return out


def dpm_step(
    model_output: torch.Tensor,
    sample: torch.Tensor,
    old_pred_original_sample: torch.Tensor,
    noise: torch.Tensor,
    mults: dict,
    prediction_type: str = "v_prediction",
    noise2: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DPM step; ``mults`` holds this step's scalars (the tables of
    :func:`dpm_multipliers` at the step index).  ``noise`` and ``noise2``
    are the two independent draws of the first-order estimate and of the
    second-order correction (``noise2`` defaults to ``noise``).  Returns
    ``(prev_sample, pred_original_sample)`` in the sample's dtype."""
    if noise2 is None:
        noise2 = noise
    m = {k: np.float32(v) for k, v in mults.items()}
    a_t = m["a_t"]
    # the scalars in float32, as the JAX step computes them on the device
    sqrt_a, sqrt_beta = float(np.sqrt(a_t)), float(np.sqrt(np.float32(1.0) - a_t))
    mo = model_output.float()
    x = sample.float()
    if prediction_type == "epsilon":
        x0 = (x - sqrt_beta * mo) / sqrt_a
    elif prediction_type == "sample":
        x0 = mo
    elif prediction_type == "v_prediction":
        x0 = sqrt_a * x - sqrt_beta * mo
    else:
        raise ValueError(prediction_type)

    mult1, mult2, mult_noise = float(m["mult1"]), float(m["mult2"]), float(m["mult_noise"])
    if m["has_back"] > 0:
        denoised_d = float(m["mult3"]) * x0 - float(m["mult4"]) * old_pred_original_sample.float()
        prev = mult1 * x - mult2 * denoised_d + mult_noise * noise2.float()
    else:
        prev = mult1 * x - mult2 * x0 + mult_noise * noise.float()
    return prev.to(sample.dtype), x0.to(sample.dtype)
