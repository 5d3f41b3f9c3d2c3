"""The 5b clips of ``entries/generate.py`` under the windowed attention
backend: each video query attends the text and ref keys and a window of
``2·window + 1`` latent frames around its own, clamped at the clip's edges
(kernel B4); the global queries attend every key (one B1 call).  The check
is the 5b cell's, against ``reference/dit_band.py`` (the reference DiT with
the same band); the work counts are the band's (``benchmark/band.py``),
not full attention's.
"""

from __future__ import annotations

from benchmark import band, flops, stepcheck, system, weights
from benchmark.entries import generate
from benchmark.reference import dit as ref_dit
from benchmark.reference import dit_band


class Entry(generate.Entry):
    def setup(self):
        self.pipe = system.build_pipeline(self.cfg, self.seed, self.device, self.traffic["attention_backend"])
        self.pipe.set_attention(self.traffic["attention_backend"], self.traffic["window"])
        self._generate(-1, lambda i, lat: False)  # one step of a clip: every kernel and shape of the window

    # -- work counts ------------------------------------------------------------

    def geometry(self):
        """(global tokens, tokens per frame, frames, half-width) of the band."""
        tok = flops.dit_tokens(self.cfg["transformer"], self.traffic)
        return tok["text"] + tok["ref"], tok["ref"], self.lat_shape[1], self.traffic["window"]

    def unit_flops(self) -> float:
        """A forward with the band's attention work in place of full attention's."""
        t = self.cfg["transformer"]
        b, s, h, d = self.b1_shape()
        g, tpf, frames, w = self.geometry()
        windowed = sum(band.attention_flops(b, h, d, g, tpf, frames, w))
        full = flops.b1_flops(b, s, h, d)
        return flops.dit_forward_flops(t, b, flops.dit_tokens(t, self.traffic)) + t["num_layers"] * (windowed - full)

    def b4_work(self):
        """(operations, bytes) of one B4 launch at the cell's band."""
        b, _, h, d = self.b1_shape()
        g, tpf, frames, w = self.geometry()
        elem = flops.ELEMENT_BYTES[self.cfg["dtype"]]
        return band.b4_flops(b, h, d, g, tpf, frames, w), band.b4_bytes(b, h, d, g, tpf, frames, elem)

    # -- check --------------------------------------------------------------------

    def check(self, control: bool = False):
        t, tr = self.cfg["transformer"], self.traffic
        worst, ctl, failed = stepcheck.step_rel_l1(
            self, lambda e: weights.dit_state_dict(e.cfg, e.seed, e.device, e.dtype)[0],
            lambda sd, lowp: dit_band.DiT(sd, t, tr["window"], lowp=lowp),
            ref_dit.positions(t, tr["height"], tr["width"], tr["num_frames"]), control)
        return {"step_rel_l1": worst}, ({"step_rel_l1": ctl} if control else None), failed
