"""Clip decodes back to back through ``S2VPipeline.decode_latents``, as
``generate`` calls it, with the whole pipeline resident (so its memory
gate sees what it sees in a user's process).  The unit of work is one
decode of one clip's latents, drawn from the seed, to ``[B, T, H, W, 3]``
frames in [0, 1] on the host.

The check decodes one of the window's clips, drawn from the seed, with the
plain fp32 decoder and compares the frames:
``frames_rel_l2 = ||program - reference|| / ||reference - 1/2||`` over the
clipped [0, 1] frames.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import flops, system, weights
from benchmark.reference.vae import Decoder


class Entry:
    unit_metric = "decode_s"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.t_created = time.perf_counter()
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.dtype = system.DTYPES[cfg["dtype"]]
        v = cfg["vae"]
        self.lat_shape = (traffic["batch_size"], (traffic["num_frames"] - 1) // v["temporal_compression_ratio"] + 1,
                          traffic["height"] // 8, traffic["width"] // 8, v["latent_channels"])
        self.outputs = []

    def latents(self, i: int) -> torch.Tensor:
        """The scaled latents of clip ``i`` (a pool of the traffic's ``clips``)."""
        return system.randn(self.lat_shape, self.seed, "latents", self.device, self.dtype,
                            i % self.traffic["clips"]) * self.cfg["vae"]["scaling_factor"]

    def setup(self):
        self.pipe = system.build_pipeline(self.cfg, self.seed, self.device)
        self.pool = [self.latents(i) for i in range(self.traffic["clips"])]
        self.pipe.decode_latents(self.pool[-1])  # every kernel and shape of the window

    def run(self, stop) -> int:
        done = 0
        while True:
            with record_function("bench.decode"):
                self.outputs.append(self.pipe.decode_latents(self.pool[done % len(self.pool)]))
            done += 1
            if stop():
                return done

    def unit_flops(self) -> float:
        _, f, h, w, _ = self.lat_shape
        return self.lat_shape[0] * flops.vae_decoder_flops(self.cfg["vae"], f, h, w)

    def check(self, control: bool = False):
        failed = sum(int(not np.isfinite(o).all()) for o in self.outputs)
        g = torch.Generator().manual_seed(weights.derive_seed(self.seed, "check_decode"))
        pick = int(torch.randint(len(self.outputs), (1,), generator=g))
        got = self.outputs[pick]
        del self.pipe, self.pool, self.outputs
        system.release(self.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sd, _ = weights.vae_state_dict(self.cfg, self.seed, self.device, self.dtype)
        z = self.latents(pick)

        def frames(lowp):
            with torch.no_grad():
                x = Decoder(sd, self.cfg["vae"], lowp=lowp).decode(z)
            return np.clip(x.cpu().numpy() / 2.0 + 0.5, 0.0, 1.0)

        want = frames(False)
        checks = {"frames_rel_l2": rel_l2(got, want)}
        ctl = {"frames_rel_l2": rel_l2(frames(True), want)} if control else None
        return checks, ctl, failed


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return float("inf")
    return float(np.linalg.norm((got - want).ravel().astype(np.float64))
                 / np.linalg.norm((want - 0.5).ravel().astype(np.float64)))
