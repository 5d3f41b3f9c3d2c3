"""LoRA micro-steps back to back on one encoded clip a step, through the
step ``training/lora.py::make_lora_train_step`` returns, built as ``python
-m s2v_torch.train`` builds it by default: rank and alpha, the seven target
families, AdamW with the trainer's defaults (global-norm clip, beta2,
weight decay), remat and exact attention from the traffic file.

Set-up builds the step, its adapters (drawn from the seed: A ~ N(0, 1/r),
B = 0) and its optimizer state, and drives that one object through the
traffic's ``setup_steps`` first steps (the first compiles and warms up);
the window continues it.  Every step has its own latents, subject latents,
prompt embeddings, noise and timestep from the seed.

The check follows the first ``reference_steps`` steps, the last of them
the window's first, in the plain fp32 reference (the same inputs; the
adapters as drawn; the reference's own forward, backward and AdamW) and
compares, each as a gap of norms against the reference's norm (or the
median leaf's, whichever is larger): ``grad_gap``, the worst leaf's first
gradient as the optimizer got it (read from its first moment after one
step); ``change_gap``, the worst leaf's change over those steps, taken
from the adapters as the window's first step left them.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
(B's factor A gets none on the first step).  Each step's loss and the
reference's are printed beside them and not compared: on random weights
the loss is about ``E|pred|² + E|target|²`` however wrong the prediction,
so it cannot tell the control from the program.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from benchmark import flops, system, weights
from benchmark.reference import dit as ref_dit
from benchmark.reference import schedule as ref_schedule
from benchmark.reference.optim import AdamW

class Entry:
    unit_metric = "train_step_s"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.t_created = time.perf_counter()
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.dtype = system.DTYPES[cfg["dtype"]]
        t = cfg["transformer"]
        self.lat_shape = (traffic["batch_size"], (traffic["num_frames"] - 1) // t["temporal_compression_ratio"] + 1,
                          traffic["height"] // 8, traffic["width"] // 8, t["in_channels"])
        self.steps = 0
        self.losses = []

    # -- inputs, all from the seed ----------------------------------------------

    def batch(self, step: int):
        t, b = self.cfg["transformer"], self.lat_shape[0]
        s, dev, dt = self.seed, self.device, self.dtype
        return {
            "video_latents": system.randn(self.lat_shape, s, "video_latents", dev, dt, step),
            "ref_latents": system.randn((b, 1) + self.lat_shape[2:], s, "ref_latents", dev, dt, step),
            "text_embeds": system.randn((b, t["max_text_seq_length"], t["text_embed_dim"]), s, "text_embeds", dev, dt,
                                        step),
            "noise": system.randn(self.lat_shape, s, "noise", dev, dt, step),
            "timesteps": torch.randint(0, self.cfg["scheduler"]["num_train_timesteps"], (b,),
                                       generator=weights.generator(dev, s, "timesteps", step), device=dev),
        }

    def adapter_shapes(self):
        """target -> (in, out, per layer) in the trainer's layout."""
        t = self.cfg["transformer"]
        d, te, p = t["num_attention_heads"] * t["attention_head_dim"], t["time_embed_dim"], t["patch_size"]
        return {"qkv": (d, 3 * d, True), "to_out": (d, d, True), "norm1.linear": (te, 6 * d, True),
                "norm2.linear": (te, 6 * d, True), "ff.net.2": (4 * d, d, True),
                "patch_proj": (p * p * t["in_channels"], d, False), "text_proj": (t["text_embed_dim"], d, False)}

    def initial_adapters(self):
        r, layers = self.traffic["rank"], self.cfg["transformer"]["num_layers"]
        out = {}
        for name, (d_in, d_out, per_layer) in self.adapter_shapes().items():
            lead = (layers,) if per_layer else ()
            g = weights.generator(self.device, self.seed, "lora_a", name)
            out[name] = {"a": torch.randn(lead + (d_in, r), generator=g, device=self.device) / r ** 0.5,
                         "b": torch.zeros(lead + (r, d_out), device=self.device)}
        return out

    @staticmethod
    def leaves(tree):
        return [(f"{n}.{k}", tree[n][k]) for n in sorted(tree) for k in ("a", "b")]

    # -- set-up, window, check ------------------------------------------------------

    def setup(self):
        from s2v_torch.training.lora import LoRASpec, make_lora_train_step
        from s2v_torch.training.optim import OptimizerSpec

        tr = self.traffic
        self.pipe = system.build_pipeline(self.cfg, self.seed, self.device, tr["attention_backend"])
        self.rope = self.pipe.prepare_rope(tr["height"], tr["width"], self.lat_shape[1])
        self.pos = self.pipe.prepare_pos_embedding(tr["height"], tr["width"], tr["num_frames"])
        opt = OptimizerSpec(optimizer="adamw", learning_rate=tr["learning_rate"], max_grad_norm=tr["max_grad_norm"],
                            weight_decay=tr["weight_decay"], beta1=tr["beta1"], beta2=tr["beta2"],
                            epsilon=tr["epsilon"])
        init_opt, self.train_step = make_lora_train_step(
            self.pipe.transformer_params, self.pipe.transformer_cfg, LoRASpec(rank=tr["rank"], alpha=tr["alpha"]),
            self.pipe.scheduler_cfg, attention_backend=tr["attention_backend"], remat=tr["remat"],
            optimizer_spec=opt)
        self.lora = self.initial_adapters()
        self.opt_state = init_opt(self.lora)
        for k in range(tr["setup_steps"]):
            self.step()
            if k == 0:  # the first gradient as the optimizer got it, from its first moment
                self.first_grads = [m.float() / (1.0 - tr["beta1"]) for m in self.opt_state["mu"]]

    def step(self):
        b = self.batch(self.steps)
        feed = {"video_latents": b["video_latents"], "ref_latents": b["ref_latents"], "text_embeds": b["text_embeds"]}
        if self.rope[0] is not None:
            feed["rope_cos"], feed["rope_sin"] = self.rope
        if self.pos is not None:
            feed["pos_embedding"] = self.pos
        self.lora, self.opt_state, loss = self.train_step(self.lora, self.opt_state, feed,
                                                          timesteps=b["timesteps"], noise=b["noise"])
        self.steps += 1
        if self.steps <= self.traffic["reference_steps"]:
            self.losses.append(loss)
        if self.steps == self.traffic["reference_steps"]:  # the adapters as the steps the reference follows left them
            self.after = [t.detach().clone() for _, t in self.leaves(self.lora)]

    def run(self, stop) -> int:
        done = 0
        while True:
            with record_function("bench.train_step"):
                self.step()
            done += 1
            if stop():
                return done

    def unit_flops(self) -> float:
        """Forward and backward: three forwards (remat's recompute not counted)."""
        t = self.cfg["transformer"]
        return 3.0 * flops.dit_forward_flops(t, self.lat_shape[0], flops.dit_tokens(t, self.traffic))

    def b1_shape(self):
        tok = flops.dit_tokens(self.cfg["transformer"], self.traffic)
        t = self.cfg["transformer"]
        return self.lat_shape[0], sum(tok.values()), t["num_attention_heads"], t["attention_head_dim"]

    def check(self, control: bool = False):
        if not hasattr(self, "after"):
            raise RuntimeError(f"the run made {self.steps} steps, fewer than the "
                               f"{self.traffic['reference_steps']} the reference follows")
        got_losses, got_first = [float(v) for v in self.losses], self.first_grads
        got_change = [a - b for a, b in zip(self.after, (t for _, t in self.leaves(self.initial_adapters())))]
        failed = sum(int(not torch.isfinite(torch.tensor(v))) for v in got_losses)
        del self.pipe, self.train_step, self.lora, self.opt_state, self.after, self.first_grads
        system.release(self.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sd, _ = weights.dit_state_dict(self.cfg, self.seed, self.device, self.dtype)
        ref = self.follow(sd, lowp=False)
        self.readings = [(int(self.batch(k)["timesteps"][0]), got, want) for k, (got, want) in
                         enumerate(zip(got_losses, ref[0]))]
        checks = compare(ref, got_losses, got_first, got_change)
        ctl = None
        if control:
            ctl = compare(ref, *self.follow(sd, lowp=True)[:3])
        return checks, ctl, failed

    def notes(self):
        return [f"step {k + 1} timestep {t} loss {got!r} reference {want!r}"
                for k, (t, got, want) in enumerate(getattr(self, "readings", ()))]

    def follow(self, sd, lowp: bool):
        """The first steps in the reference: (losses, first clipped
        gradients, changes, per-leaf gradient norms)."""
        tr, t, sc = self.traffic, self.cfg["transformer"], self.cfg["scheduler"]
        lora = self.initial_adapters()
        start = [p.clone() for _, p in self.leaves(lora)]
        params = [p.requires_grad_(True) for _, p in self.leaves(lora)]
        opt = AdamW(params, tr["learning_rate"], tr["beta1"], tr["beta2"], tr["epsilon"], tr["weight_decay"],
                    tr["max_grad_norm"])
        model = ref_dit.DiT(sd, t, lowp=lowp, lora=lora, lora_scale=tr["alpha"] / tr["rank"], checkpoint=True)
        pos = ref_dit.positions(t, tr["height"], tr["width"], tr["num_frames"])
        ac = torch.as_tensor(ref_schedule.alphas_cumprod(sc), device=self.device)
        losses, first, norms = [], None, []
        for k in range(tr["reference_steps"]):
            b = self.batch(k)
            x0, noise = b["video_latents"].float(), b["noise"].float()
            a = ac[b["timesteps"]].view(-1, 1, 1, 1, 1)
            noisy = a.sqrt() * x0 + (1 - a).sqrt() * noise
            target = a.sqrt() * noise - (1 - a).sqrt() * x0
            pred = model.forward(noisy, b["ref_latents"], b["text_embeds"], b["timesteps"], pos)
            loss = torch.mean((pred - target) ** 2)
            grads = torch.autograd.grad(loss, params)
            clipped = opt.step(list(grads))
            losses.append(float(loss.detach()))
            norms.append([float(torch.linalg.vector_norm(g)) for g in grads])
            if k == 0:
                first = [g.detach() for g in clipped]
        change = [p.detach() - s for p, s in zip(params, start)]
        return losses, first, change, norms


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def leaf_gaps(got, want, keep):
    """|‖got‖ - ‖want‖| / max(‖want‖, the median kept leaf's ‖want‖), worst over the kept leaves."""
    wn = [_norm(w) for w in want]
    kept = sorted(wn[i] for i in keep)
    median = kept[len(kept) // 2] if kept else 0.0
    return max((abs(_norm(got[i]) - wn[i]) / max(wn[i], median, 1e-30) for i in keep), default=float("nan"))


def moved(norms) -> list:
    """The leaves whose reference gradient is at least a thousandth of the median leaf's."""
    srt = sorted(norms)
    median = 0.5 * (srt[(len(srt) - 1) // 2] + srt[len(srt) // 2])
    return [i for i, n in enumerate(norms) if n >= 1e-3 * median and n > 0]


def compare(ref, losses, first, change) -> dict:
    ref_losses, ref_first, ref_change, ref_norms = ref
    grad_keep = moved(ref_norms[0])
    change_keep = moved([max(step[i] for step in ref_norms) for i in range(len(ref_norms[0]))])
    return {"grad_gap": leaf_gaps(first, ref_first, grad_keep),
            "change_gap": leaf_gaps(change, ref_change, change_keep)}
