"""The CFG denoising loop (counterpart of ``s2v_tpu/pipelines/denoise.py``).

The JAX package traces the loop into one ``fori_loop``; here it is a Python
loop of transformer forwards and scheduler updates (DDIM, or DPM with
``use_dpm``).  CFG duplicates the ref tokens into the uncond half.
``batched`` runs uncond | cond as one 2B forward, ``sequential`` as two B
forwards (same math).

Opt-in fast paths, as in the JAX package: cfg-skip (the uncond forward is
skipped on steps whose guidance is within a threshold of 1, decided on the
host from the guidance table) and adaptive step skipping
(:func:`denoise_adaptive`: a skipped step reuses the previous prediction;
the test reads a device scalar, one host sync per step).
:func:`make_segmented_denoise` runs any range of steps, so the host can stop
or edit the latents between segments.

DPM draws two gaussian samples per step from a noise source
``noise(i, shape, device) -> (n1, n2)``; :class:`DPMNoise` seeds step i's
draws by the step index, so a segment draws exactly what the whole loop
draws at that step.  Tests inject the JAX package's own draws.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from s2v_torch.config import SchedulerConfig, TransformerConfig
from s2v_torch.models.transformer import transformer_forward
from s2v_torch.schedulers.ddim import alpha_pair_for_step, compute_alphas_cumprod, ddim_step, get_timesteps
from s2v_torch.schedulers.dpm import dpm_multipliers, dpm_step
from s2v_torch.utils.logging import phase

CFG_MODES = ("batched", "sequential")


def guidance_schedule(guidance_scale: float, num_steps: int, use_dynamic_cfg: bool) -> np.ndarray:
    """Per-step guidance scales; the dynamic cosine schedule is indexed by
    the loop step, not the timestep value."""
    if not use_dynamic_cfg:
        return np.full(num_steps, guidance_scale, np.float32)
    i = np.arange(num_steps, dtype=np.float64)
    g = 1.0 + guidance_scale * ((1.0 - np.cos(math.pi * ((num_steps - i) / num_steps) ** 5.0)) / 2.0)
    return g.astype(np.float32)


@dataclass(frozen=True)
class DenoiseSchedule:
    """Host-precomputed per-step tables."""

    timesteps: np.ndarray
    alpha_t: np.ndarray
    alpha_prev: np.ndarray
    guidance: np.ndarray
    prediction_type: str
    use_dpm: bool = False
    dpm_mults: Optional[dict] = None  # dict of [N] float32 arrays
    guidance_scale: float = 6.0
    use_dynamic_cfg: bool = False

    @classmethod
    def create(
        cls,
        scheduler_cfg: SchedulerConfig,
        num_inference_steps: int,
        guidance_scale: float,
        use_dynamic_cfg: bool = False,
        use_dpm: bool = False,
    ) -> "DenoiseSchedule":
        ac = compute_alphas_cumprod(scheduler_cfg)
        ts = get_timesteps(scheduler_cfg, num_inference_steps)
        a_t, a_prev = alpha_pair_for_step(
            ac, ts, scheduler_cfg.num_train_timesteps, num_inference_steps, scheduler_cfg.set_alpha_to_one
        )
        mults = (dpm_multipliers(ac, ts, scheduler_cfg.num_train_timesteps, num_inference_steps,
                                 scheduler_cfg.set_alpha_to_one) if use_dpm else None)
        return cls(
            timesteps=ts,
            alpha_t=a_t,
            alpha_prev=a_prev,
            guidance=guidance_schedule(guidance_scale, num_inference_steps, use_dynamic_cfg),
            prediction_type=scheduler_cfg.prediction_type,
            use_dpm=use_dpm,
            dpm_mults=mults,
            guidance_scale=guidance_scale,
            use_dynamic_cfg=use_dynamic_cfg,
        )

    def truncate(self, strength: float) -> "DenoiseSchedule":
        """The last ``strength`` fraction of the steps, for video-to-video
        (``s2v_tpu/pipelines/denoise.py:95-110``): the dynamic guidance is
        recomputed over the kept steps, and DPM's first kept step has no
        previous x0 (``has_back`` 0)."""
        n = len(self.timesteps)
        t_start = max(n - min(int(n * strength), n), 0)
        dpm_mults = None
        if self.dpm_mults:
            dpm_mults = {k: v[t_start:].copy() for k, v in self.dpm_mults.items()}
            if len(dpm_mults["has_back"]):
                dpm_mults["has_back"][0] = 0.0
        return replace(
            self,
            timesteps=self.timesteps[t_start:],
            alpha_t=self.alpha_t[t_start:],
            alpha_prev=self.alpha_prev[t_start:],
            guidance=guidance_schedule(self.guidance_scale, n - t_start, self.use_dynamic_cfg),
            dpm_mults=dpm_mults,
        )


def cfg_skip_steps(schedule: DenoiseSchedule, threshold: float) -> np.ndarray:
    """The steps whose uncond forward cfg-skip drops: ``g - 1 < threshold``
    in float32, as the JAX loop tests it (none for a threshold of 0)."""
    if threshold <= 0.0:
        return np.zeros(len(schedule.guidance), bool)
    return (schedule.guidance - np.float32(1.0)) < np.float32(threshold)


class DPMNoise:
    """The DPM loop's draws: step i's two samples come from CPU generators
    seeded by ``(seed, 2i)`` and ``(seed, 2i + 1)``, the counterpart of
    ``fold_in(key, 2i)`` and ``fold_in(key, 2i + 1)``."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def _draw(self, stream: int, shape) -> torch.Tensor:
        state = np.random.SeedSequence([self.seed, stream]).generate_state(1, np.uint64)[0]
        return torch.randn(tuple(shape), generator=torch.Generator().manual_seed(int(state)))

    def __call__(self, i: int, shape, device) -> tuple:
        n1, n2 = self._draw(2 * i, shape), self._draw(2 * i + 1, shape)
        with phase("s2v.sync.dpm_noise"):  # two copies from the host
            return n1.to(device), n2.to(device)


NoiseSource = Callable[[int, tuple, torch.device], tuple]


def _build_eps_update_fns(
    params: dict,
    cfg: TransformerConfig,
    schedule: DenoiseSchedule,
    ref_latents: Optional[torch.Tensor],
    prompt_embeds: torch.Tensor,
    rope_cos,
    rope_sin,
    do_cfg: bool,
    dpm_noise: Optional[NoiseSource],
    attention_backend: str,
    cfg_mode: str,
    cfg_skip_threshold: float = 0.0,
    pos_embedding: Optional[torch.Tensor] = None,
    cond_latents: Optional[torch.Tensor] = None,
):
    """The step split into ``eps_fn(i, latents) -> noise_pred`` (the
    CFG-mixed transformer forward, fp32) and ``update_fn(i, latents, old_x0,
    noise_pred) -> (new_latents, x0)`` (the scheduler update), so the
    adaptive loop can skip the forward and still step.  ``cond_latents``
    (image- or control-conditioned variants) are concatenated to the
    latents on the channel axis in every forward, doubled when the forward
    is (``s2v_tpu/pipelines/denoise.py:210-214``)."""
    if cfg_mode not in CFG_MODES:
        raise ValueError(f"unknown cfg_mode {cfg_mode!r}; expected one of {CFG_MODES}")
    batched = do_cfg and cfg_mode == "batched"
    ref_in = ref_latents
    if ref_latents is not None and batched:
        ref_in = torch.cat([ref_latents, ref_latents], dim=0)
    if do_cfg:
        emb_uncond, emb_cond = prompt_embeds.chunk(2, dim=0)
    skip = cfg_skip_steps(schedule, cfg_skip_threshold if do_cfg else 0.0)
    noise = dpm_noise if dpm_noise is not None else DPMNoise(0)

    def fwd(lat_in, emb, i):
        # the ref batch follows the latents' (a cfg-skipped step in batched
        # mode is a B-sized forward with the un-doubled ref latents)
        ref = ref_in if ref_in is None or ref_in.shape[0] == lat_in.shape[0] else ref_latents
        ts = torch.full((lat_in.shape[0],), int(schedule.timesteps[i]), dtype=torch.int32, device=lat_in.device)
        if cond_latents is not None:
            cond = cond_latents
            if lat_in.shape[0] != cond.shape[0]:
                cond = torch.cat([cond, cond], dim=0)
            lat_in = torch.cat([lat_in, cond.to(lat_in.dtype)], dim=-1)
        return transformer_forward(
            params, cfg, lat_in, ref, emb, ts, rope_cos, rope_sin, attention_backend=attention_backend,
            pos_embedding=pos_embedding,
        )

    def eps_fn(i, latents):
        g = float(schedule.guidance[i])
        if skip[i]:
            # g - 1 below the threshold: the cond prediction alone, off by
            # at most (g - 1)·|cond - uncond| from the mix
            cond = fwd(latents, emb_cond, i)
            with phase("s2v.cfg_ddim"):
                return cond.float()
        if batched:
            both = fwd(torch.cat([latents, latents], dim=0), prompt_embeds, i)
            with phase("s2v.cfg_ddim"):
                uncond, cond = both.float().chunk(2, dim=0)
                return uncond + g * (cond - uncond)
        if do_cfg:
            uncond, cond = fwd(latents, emb_uncond, i), fwd(latents, emb_cond, i)
            with phase("s2v.cfg_ddim"):
                uncond = uncond.float()
                return uncond + g * (cond.float() - uncond)
        out = fwd(latents, prompt_embeds, i)
        with phase("s2v.cfg_ddim"):
            return out.float()

    def update_fn(i, latents, old_x0, noise_pred):
        if schedule.use_dpm:
            n1, n2 = noise(i, latents.shape, latents.device)
            mults = {k: v[i] for k, v in schedule.dpm_mults.items()}
            with phase("s2v.cfg_ddim"):
                new, x0 = dpm_step(noise_pred, latents, old_x0, n1, mults, schedule.prediction_type, noise2=n2)
                return new.to(latents.dtype), x0.to(latents.dtype)
        with phase("s2v.cfg_ddim"):
            new, x0 = ddim_step(noise_pred, latents, float(schedule.alpha_t[i]), float(schedule.alpha_prev[i]),
                                schedule.prediction_type)
            return new.to(latents.dtype), x0.to(latents.dtype)

    return eps_fn, update_fn


def _build_step_fn(*args, **kwargs):
    """``step(i, (latents, old_x0)) -> (latents, x0)``: one exact step."""
    eps_fn, update_fn = _build_eps_update_fns(*args, **kwargs)

    def step(i, carry):
        latents, old_x0 = carry
        return update_fn(i, latents, old_x0, eps_fn(i, latents))

    return step


def adaptive_init_carry(latents: torch.Tensor) -> tuple:
    """The adaptive loop's first carry ``(latents, old_x0, prev_eps,
    prev_lat, prev_d1, n_skipped)``, shared by the whole and the segmented
    loop (the state crosses segment boundaries)."""
    zero = torch.zeros(latents.shape, dtype=torch.float32, device=latents.device)
    return latents, torch.zeros_like(latents), zero, latents, zero, 0


def _build_adaptive_step_fn(params, cfg, schedule, ref_latents, prompt_embeds, rope_cos, rope_sin, threshold,
                            do_cfg, dpm_noise, attention_backend, cfg_mode, cfg_skip_threshold=0.0,
                            pos_embedding=None, cond_latents=None):
    """One step of the adaptive loop over the carry of
    :func:`adaptive_init_carry`.  The forward is skipped, and the previous
    prediction reused, when ``mean|Δ²x| < threshold · mean|Δx|`` over the
    latent trajectory; steps 0, 1 and the last always compute.  The test
    reads a device scalar: one host sync per tested step."""
    n = len(schedule.timesteps)
    eps_fn, update_fn = _build_eps_update_fns(
        params, cfg, schedule, ref_latents, prompt_embeds, rope_cos, rope_sin, do_cfg, dpm_noise,
        attention_backend, cfg_mode, cfg_skip_threshold, pos_embedding, cond_latents)
    thr = float(np.float32(threshold))

    def step(i, carry):
        lat, old_x0, prev_eps, prev_lat, prev_d1, skips = carry
        d1 = (lat - prev_lat).float()
        skip = False
        if 2 <= i < n - 1:
            with phase("s2v.sync.adaptive_test"):
                skip = bool((d1 - prev_d1).abs().mean() < thr * d1.abs().mean())
        eps = prev_eps if skip else eps_fn(i, lat)
        new_lat, x0 = update_fn(i, lat, old_x0, eps)
        return new_lat, x0, eps, lat, d1, skips + int(skip)

    return step


def _progress_line(i: int, n: int) -> None:
    sys.stderr.write(f"\r[s2v_torch] denoise step {i + 1}/{n}")
    if i + 1 == n:
        sys.stderr.write("\n")
    sys.stderr.flush()


def _run_steps(step, carry, i0: int, i1: int, n: int, progress: bool, step_callback):
    for i in range(i0, i1):
        with phase("s2v.step", step=i):
            carry = step(i, carry)
        if progress:
            _progress_line(i, n)
        if step_callback is not None:
            step_callback(i)
    return carry


def denoise(
    params: dict,
    cfg: TransformerConfig,
    schedule: DenoiseSchedule,
    latents: torch.Tensor,  # [B, F, h, w, C]
    ref_latents: Optional[torch.Tensor],  # [B, 1, h, w, C]; None = T2V
    prompt_embeds: torch.Tensor,  # [2B (uncond | cond), T, text_dim], or [B, ...] without CFG
    rope_cos: Optional[torch.Tensor],
    rope_sin: Optional[torch.Tensor],
    do_cfg: bool = True,
    attention_backend: str = "plain",
    cfg_mode: str = "batched",
    cfg_skip_threshold: float = 0.0,
    progress: bool = False,
    dpm_noise: Optional[NoiseSource] = None,
    step_callback=None,
    pos_embedding: Optional[torch.Tensor] = None,  # the sincos table (2b models)
    cond_latents: Optional[torch.Tensor] = None,  # channel-concatenated condition (i2v, fun-control)
) -> torch.Tensor:
    """Run the denoise loop; returns the final latents ``[B, F, h, w, C]``.
    ``progress`` writes the per-step line on stderr; ``step_callback(i)``,
    when given, is called after each step; ``dpm_noise`` is the DPM noise
    source (default :class:`DPMNoise` of seed 0)."""
    step = _build_step_fn(params, cfg, schedule, ref_latents, prompt_embeds, rope_cos, rope_sin, do_cfg, dpm_noise,
                          attention_backend, cfg_mode, cfg_skip_threshold, pos_embedding, cond_latents)
    n = len(schedule.timesteps)
    final, _ = _run_steps(step, (latents, torch.zeros_like(latents)), 0, n, n, progress, step_callback)
    return final


def denoise_adaptive(
    params: dict,
    cfg: TransformerConfig,
    schedule: DenoiseSchedule,
    latents: torch.Tensor,
    ref_latents: Optional[torch.Tensor],
    prompt_embeds: torch.Tensor,
    rope_cos: Optional[torch.Tensor],
    rope_sin: Optional[torch.Tensor],
    threshold: float,
    do_cfg: bool = True,
    attention_backend: str = "plain",
    cfg_mode: str = "batched",
    cfg_skip_threshold: float = 0.0,
    progress: bool = False,
    dpm_noise: Optional[NoiseSource] = None,
    step_callback=None,
    pos_embedding: Optional[torch.Tensor] = None,
    cond_latents: Optional[torch.Tensor] = None,
):
    """Training-free adaptive step skipping (opt-in; not the reference
    algorithm, which is :func:`denoise`): see
    :func:`_build_adaptive_step_fn`.  Returns ``(final_latents, n_skipped)``."""
    step = _build_adaptive_step_fn(params, cfg, schedule, ref_latents, prompt_embeds, rope_cos, rope_sin, threshold,
                                   do_cfg, dpm_noise, attention_backend, cfg_mode, cfg_skip_threshold, pos_embedding,
                                   cond_latents)
    n = len(schedule.timesteps)
    carry = _run_steps(step, adaptive_init_carry(latents), 0, n, n, progress, step_callback)
    return carry[0], carry[5]


def make_segmented_denoise(
    params: Optional[dict],
    cfg: TransformerConfig,
    schedule: DenoiseSchedule,
    rope_cos,
    rope_sin,
    do_cfg: bool = True,
    dpm_noise: Optional[NoiseSource] = None,
    attention_backend: str = "plain",
    cfg_mode: str = "batched",
    cfg_skip_threshold: float = 0.0,
    adaptive_threshold: float = 0.0,
    progress: bool = False,
    step_callback=None,
    pos_embedding: Optional[torch.Tensor] = None,
    cond_latents: Optional[torch.Tensor] = None,
):
    """Host-steppable denoise: returns ``run(params, carry, ref_latents,
    prompt_embeds, rng, i0, i1)``, which runs steps ``[i0, i1)`` and returns
    the carry.  The carry is ``(latents, old_x0)``, or the 6-tuple of
    :func:`adaptive_init_carry` when ``adaptive_threshold > 0``.  ``rng`` is
    a DPM noise source; ``params``/``rng`` given as None take the defaults
    given here.  Segments run exactly the steps of the whole loop."""
    default_params, default_noise = params, dpm_noise
    n = len(schedule.timesteps)

    def run(p, carry, ref_latents, prompt_embeds, rng, i0, i1):
        p = default_params if p is None else p
        rng = default_noise if rng is None else rng
        if adaptive_threshold > 0.0:
            step = _build_adaptive_step_fn(p, cfg, schedule, ref_latents, prompt_embeds, rope_cos, rope_sin,
                                           adaptive_threshold, do_cfg, rng, attention_backend, cfg_mode,
                                           cfg_skip_threshold, pos_embedding, cond_latents)
        else:
            step = _build_step_fn(p, cfg, schedule, ref_latents, prompt_embeds, rope_cos, rope_sin, do_cfg, rng,
                                  attention_backend, cfg_mode, cfg_skip_threshold, pos_embedding, cond_latents)
        return _run_steps(step, carry, i0, i1, n, progress, step_callback)

    return run
