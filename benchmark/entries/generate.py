"""Clips generated back to back by one client (a closed loop), through
``S2VPipeline.generate`` as the CLI calls it: the batched CFG over
``[uncond | cond]`` prompt embeddings, the subject's reference latents,
the traffic's DDIM schedule.  The unit of work is one denoise step: the
window stops at a step boundary (``segment_steps=1`` and the segment
callback), and a clip that ends inside the window is followed by the next.

The check follows the program one step at a time from its own state: the
reference takes the latents before a step (the seed's initial latents for
the first step of the window's first clip, the program's latents for a
later step drawn from the seed), runs the CFG forward of the plain fp32
DiT and the DDIM update, and is compared with the program's latents after
that step, both stored in the model dtype as the pipeline stores them:
``step_rel_l1 = sum|program - reference| / sum|Δ_reference|`` over the
step's change Δ, the worst of the steps checked.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from benchmark import flops, system, weights
from benchmark.reference import dit as ref_dit
from benchmark.reference import schedule as ref_schedule


class Entry:
    unit_metric = "denoise_step_s"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.t_created = time.perf_counter()
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.dtype = system.DTYPES[cfg["dtype"]]
        t = cfg["transformer"]
        self.lat_shape = (1, (traffic["num_frames"] - 1) // t["temporal_compression_ratio"] + 1,
                          traffic["height"] // 8, traffic["width"] // 8, t["in_channels"])
        self.recorded = {}  # (clip, steps done) -> latents after them
        self.clip_starts = []  # per unit of the window: whether it is a clip's first step

    # -- inputs, all from the seed ----------------------------------------------

    def inputs(self, clip: int):
        """(prompt embeddings [uncond | cond], ref latents, initial latents) of a clip."""
        t = self.cfg["transformer"]
        pe = system.randn((2, t["max_text_seq_length"], t["text_embed_dim"]), self.seed, "prompt_embeds",
                          self.device, self.dtype)
        ref = system.randn((1, 1) + self.lat_shape[2:], self.seed, "ref_latents", self.device, self.dtype)
        lat = system.randn(self.lat_shape, self.seed, "latents", self.device, self.dtype, index=clip)
        return pe, ref, lat

    def _generate(self, clip: int, on_step):
        pe, ref, lat = self.inputs(clip)
        tr = self.traffic
        return self.pipe.generate(
            prompt_embeds=pe, ref_latents=ref, latents=lat, height=tr["height"], width=tr["width"],
            num_frames=tr["num_frames"], num_inference_steps=tr["num_inference_steps"],
            guidance_scale=tr["guidance_scale"], cfg_mode=tr["cfg_mode"], output_type="latent",
            segment_steps=1, callback_on_segment_end=on_step)

    # -- set-up, window, check ------------------------------------------------------

    def setup(self):
        self.pipe = system.build_pipeline(self.cfg, self.seed, self.device, self.traffic["attention_backend"])
        self._generate(-1, lambda i, lat: False)  # one step of a clip: every kernel and shape of the window

    def run(self, stop) -> int:
        done, clip = 0, 0
        while True:
            halt = []
            span = [record_function("bench.segment")]
            span[0].__enter__()

            def on_step(i, lat, clip=clip):
                nonlocal done
                span[0].__exit__(None, None, None)
                done += 1
                self.clip_starts.append(i == 1)
                self.recorded[(clip, i)] = lat.detach().clone()
                if stop():
                    halt.append(True)
                    return False
                span[0] = record_function("bench.segment")
                span[0].__enter__()
                return None

            with record_function("bench.generate"):
                self._generate(clip, on_step)
            if halt:
                return done
            span[0].__exit__(None, None, None)
            clip += 1

    def unit_seconds(self, durations) -> float:
        """The seconds of a step of a ``num_inference_steps``-step clip, from the window's steps."""
        n = self.traffic["num_inference_steps"]
        start = [d for d, s in zip(durations, self.clip_starts) if s]
        rest = [d for d, s in zip(durations, self.clip_starts) if not s]
        if not start or not rest or n < 2:
            return sum(durations) / len(durations)
        return (sum(start) / len(start) + (n - 1) * sum(rest) / len(rest)) / n

    def unit_flops(self) -> float:
        return flops.dit_forward_flops(self.cfg["transformer"], 2, flops.dit_tokens(self.cfg["transformer"], self.traffic))

    def b1_shape(self):
        """(B, S, H, d) of the window's B1 launches: the batched CFG."""
        tok = flops.dit_tokens(self.cfg["transformer"], self.traffic)
        t = self.cfg["transformer"]
        return 2, sum(tok.values()), t["num_attention_heads"], t["attention_head_dim"]

    def steps_to_check(self):
        """The first step of the first clip, and one later step drawn from the seed."""
        later = sorted(k for k in self.recorded if k[1] >= 1 and (k[0], k[1] + 1) in self.recorded)
        picks = [(0, 0)] if (0, 1) in self.recorded else []
        if later:
            g = torch.Generator().manual_seed(weights.derive_seed(self.seed, "check_step"))
            picks.append(later[int(torch.randint(len(later), (1,), generator=g))])
        return picks

    def check(self, control: bool = False):
        failed = sum(int(not torch.isfinite(x).all()) for x in self.recorded.values())
        picks = self.steps_to_check()
        before = {}
        for clip, j in picks:
            x = self.inputs(clip)[2] if j == 0 else self.recorded[(clip, j)]
            before[(clip, j)] = (x.float(), self.recorded[(clip, j + 1)].float())
        pe, ref, _ = self.inputs(0)
        del self.pipe, self.recorded
        system.release(self.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        sd, _ = weights.dit_state_dict(self.cfg, self.seed, self.device, self.dtype)
        tr, t = self.traffic, self.cfg["transformer"]
        pos = ref_dit.positions(t, tr["height"], tr["width"], tr["num_frames"])
        steps = tr["num_inference_steps"]
        ts = ref_schedule.timesteps(self.cfg["scheduler"], steps)

        def step(model, x, j):
            a_t, a_prev = ref_schedule.ddim_alphas(self.cfg["scheduler"], steps, j)
            tt = torch.full((2,), int(ts[j]), device=self.device)
            v = model.forward(torch.cat([x, x]), torch.cat([ref, ref]), pe, tt, pos)
            v_u, v_c = v.chunk(2)
            return ref_schedule.ddim_v_step(v_u + tr["guidance_scale"] * (v_c - v_u), x, a_t, a_prev)

        def stored(y):  # the latents as the pipeline keeps them, in the model dtype
            return y.to(self.dtype).float()

        worst, worst_ctl = float("nan") if not before else 0.0, 0.0
        with torch.no_grad():
            plain = ref_dit.DiT(sd, t)
            low = ref_dit.DiT(sd, t, lowp=True)
            for (clip, j), (x, got) in before.items():
                want = step(plain, x, j)
                worst = max(worst, rel_l1(got, stored(want), want - x))
                if control:
                    worst_ctl = max(worst_ctl, rel_l1(stored(step(low, x, j)), stored(want), want - x))
        return {"step_rel_l1": worst}, ({"step_rel_l1": worst_ctl} if control else None), failed


def rel_l1(got: torch.Tensor, want: torch.Tensor, delta: torch.Tensor) -> float:
    """sum |got - want| / sum |delta|: the mean gap of two states stored on
    one grid, over the mean change of the step (a mean absolute gap, since
    rounding both to the grid leaves it unbiased where a squared one grows
    by the grid's spacing)."""
    return float((got - want).double().abs().sum() / delta.double().abs().sum())
