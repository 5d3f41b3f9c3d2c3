"""Clips of CogVideoX1.5 generated back to back by one client, through
``S2VPipeline.generate`` as ``entries/generate.py`` drives the 5b and 2b
cells: batched CFG, the traffic's DDIM schedule, one denoise step a unit of
work.  What differs is the model's token grid: 2x2x2 patches over (time,
height, width), the latents drawn at the frame count padded to whole
temporal patches (81 frames: 21 latent frames, 22 drawn), the subject's
latent frame repeated into one temporal patch.

The weights are the published 1.5 keys (the patch embedding a Linear
``[D, C·pₜ·p²]`` with no bias, ``proj_out`` to ``C·pₜ·p²``) drawn from the
seed on the ``transformer`` stream and handed through the port's
converter.  The check follows the program one step at a time against
``reference/dit_pt.py`` as the 5b cell's follows ``reference/dit.py``
(``step_rel_l1``), and ``token_gap`` counts the program's token counters
(``S2VPipeline.stats``, and in a traced run the attributes of each clip's
``s2v.prologue`` span) that differ from the entry's, so that the roofline
reads the shape that ran.  A port whose ``TransformerConfig`` has no
``patch_size_t`` cannot run the model: set-up raises at once.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark import flops, stepcheck, system, weights
from benchmark.entries import generate
from benchmark.reference import dit_pt

COUNTERS = {"tokens_text": "text", "tokens_ref": "ref", "tokens_video": "video"}


def dit_shapes(t: dict) -> weights.Shapes:
    """The published CogVideoX1.5 transformer keys and shapes: the 5b's,
    with the patch embedding a Linear over 2x2x2 patches and no bias where
    ``patch_bias`` is false, and ``proj_out`` to the patch's features."""
    d, p, pt = t["num_attention_heads"] * t["attention_head_dim"], t["patch_size"], t["patch_size_t"]
    patch_in, patch_out = t["in_channels"] * pt * p * p, t["out_channels"] * pt * p * p
    out = []
    for name, shape in weights.dit_shapes(t):
        if name == "patch_embed.proj.weight":
            shape = (d, patch_in)
        elif name == "patch_embed.proj.bias" and not t["patch_bias"]:
            continue
        elif name == "proj_out.weight":
            shape = (patch_out, d)
        elif name == "proj_out.bias":
            shape = (patch_out,)
        out.append((name, shape))
    return out


def dit_state_dict(cfg: dict, seed: int, device, dtype):
    return weights.make_state_dict(dit_shapes(cfg["transformer"]), seed, "transformer", device, dtype,
                                   apart=weights._qkv)


class Entry(generate.Entry):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        super().__init__(cfg, traffic, seed, device)
        t = cfg["transformer"]
        frames, self.pad_frames = dit_pt.latent_frames(t, traffic["num_frames"])
        self.lat_shape = (1, frames) + self.lat_shape[2:]
        self.tokens = dit_pt.tokens(t, traffic["height"], traffic["width"], traffic["num_frames"])
        self.seen = []  # the program's counters after each generate call

    def setup(self):
        from s2v_torch.config import TransformerConfig

        if "patch_size_t" not in {f.name for f in dataclasses.fields(TransformerConfig)}:
            raise SystemExit("this port's TransformerConfig has no patch_size_t: it cannot run CogVideoX1.5")
        self.pipe = self.build_pipeline()
        self._generate(-1, lambda i, lat: False)  # one step of a clip: every kernel and shape of the window

    def build_pipeline(self):
        """``system.build_pipeline`` with the 1.5 transformer keys."""
        from s2v_torch.loaders.hf import convert_t5_state_dict, convert_transformer_state_dict, convert_vae_state_dict
        from s2v_torch.pipelines.s2v import S2VPipeline

        tcfg, vcfg, t5cfg, scfg = system.configs(self.cfg)
        with torch.no_grad():
            sd, bufs = dit_state_dict(self.cfg, self.seed, self.device, self.dtype)
            dit = convert_transformer_state_dict(sd, tcfg)
            del sd, bufs
            sd, bufs = weights.vae_state_dict(self.cfg, self.seed, self.device, self.dtype)
            vae = convert_vae_state_dict(sd, vcfg)
            del sd, bufs
            sd, bufs = weights.t5_state_dict(self.cfg, self.seed, self.device, self.dtype)
            t5 = convert_t5_state_dict(sd, t5cfg)
            del sd, bufs
        return S2VPipeline(transformer_params=dit, transformer_cfg=tcfg, vae_params=vae, vae_cfg=vcfg,
                           t5_params=t5, t5_cfg=t5cfg, scheduler_cfg=scfg, device=self.device,
                           attention_backend=self.traffic["attention_backend"])

    def _generate(self, clip: int, on_step):
        out = super()._generate(clip, on_step)
        self.seen.append(dict(self.pipe.stats))
        return out

    # -- work counts ------------------------------------------------------------

    def unit_flops(self) -> float:
        """A forward at the 1.5 shape; the patch's features counted as C·pₜ
        (``flops.dit_forward_flops`` knows one frame a patch)."""
        t = dict(self.cfg["transformer"])
        t.update(in_channels=t["in_channels"] * t["patch_size_t"], out_channels=t["out_channels"] * t["patch_size_t"])
        return flops.dit_forward_flops(t, 2, self.tokens)

    def b1_shape(self):
        t = self.cfg["transformer"]
        return 2, sum(self.tokens.values()), t["num_attention_heads"], t["attention_head_dim"]

    def token_gap(self) -> int:
        """The program's token counters that differ from the entry's (or are
        missing), over every generate call and every traced clip prologue."""
        want = {k: self.tokens[v] for k, v in COUNTERS.items()}
        want["pad_frames"] = self.pad_frames
        from s2v_torch.utils.logging import span_records

        reports = self.seen + [r.attrs for r in span_records() if r.name == "s2v.prologue"]
        return sum(r.get(k) != v for r in reports for k, v in want.items()) + (not reports)

    # -- check --------------------------------------------------------------------

    def check(self, control: bool = False):
        gap = float(self.token_gap())
        t, tr = self.cfg["transformer"], self.traffic
        worst, ctl, failed = stepcheck.step_rel_l1(
            self, lambda e: dit_state_dict(e.cfg, e.seed, e.device, e.dtype)[0],
            lambda sd, lowp: dit_pt.DiT(sd, t, lowp=lowp),
            dit_pt.positions(t, tr["height"], tr["width"], tr["num_frames"]), control)
        return ({"step_rel_l1": worst, "token_gap": gap},
                {"step_rel_l1": ctl, "token_gap": gap} if control else None, failed)
