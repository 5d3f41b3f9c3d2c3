"""The check of ``entries/generate.py`` with the reference model as an
argument, for the entries that follow another reference DiT: the program's
latents after a step against the reference's step from the same latents,
``step_rel_l1`` as ``generate.rel_l1`` computes it, the worst of the
steps ``entry.steps_to_check()`` picks; with ``control`` also the control
(the reference with ``lowp``) in the program's place."""

from __future__ import annotations

import torch

from benchmark import system
from benchmark.entries import generate
from benchmark.reference import schedule as ref_schedule


def step_rel_l1(entry, state_dict, model, positions, control: bool):
    """(program's reading, control's reading or None, failed): ``state_dict(entry)``
    makes the reference weights after the program is freed, ``model(sd, lowp)``
    the reference DiT, ``positions`` the clip's tables."""
    failed = sum(int(not torch.isfinite(x).all()) for x in entry.recorded.values())
    before = {}
    for clip, j in entry.steps_to_check():
        x = entry.inputs(clip)[2] if j == 0 else entry.recorded[(clip, j)]
        before[(clip, j)] = (x.float(), entry.recorded[(clip, j + 1)].float())
    pe, ref, _ = entry.inputs(0)
    del entry.pipe, entry.recorded
    system.release(entry.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sd = state_dict(entry)
    tr, sched = entry.traffic, entry.cfg["scheduler"]
    steps = tr["num_inference_steps"]
    ts = ref_schedule.timesteps(sched, steps)

    def step(m, x, j):
        a_t, a_prev = ref_schedule.ddim_alphas(sched, steps, j)
        tt = torch.full((2,), int(ts[j]), device=entry.device)
        v_u, v_c = m.forward(torch.cat([x, x]), torch.cat([ref, ref]), pe, tt, positions).chunk(2)
        return ref_schedule.ddim_v_step(v_u + tr["guidance_scale"] * (v_c - v_u), x, a_t, a_prev)

    def stored(y):  # the latents as the pipeline keeps them, in the model dtype
        return y.to(entry.dtype).float()

    worst, worst_ctl = float("nan") if not before else 0.0, 0.0
    with torch.no_grad():
        plain, low = model(sd, False), model(sd, True)
        for (clip, j), (x, got) in before.items():
            want = step(plain, x, j)
            worst = max(worst, generate.rel_l1(got, stored(want), want - x))
            if control:
                worst_ctl = max(worst_ctl, generate.rel_l1(stored(step(low, x, j)), stored(want), want - x))
    return worst, (worst_ctl if control else None), failed
