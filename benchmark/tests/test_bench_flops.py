"""The frozen work counts against hand counts at the main shapes and
against PyTorch's FLOP counter run over the plain reference at tiny ones."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark.reference.dit import DiT, positions
from benchmark.reference.vae import Decoder
from benchmark.tests.tiny import ROOT, TINY_5B, tiny_2b
from benchmark.weights import dit_state_dict, vae_state_dict

MAIN = {"height": 480, "width": 720, "num_frames": 49}


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_b1_and_b2_at_the_main_shapes():
    assert flops.b1_flops(2, 19126, 48, 64) == pytest.approx(8.99e12, rel=1e-3)
    assert flops.b1_flops(2, 19126, 48, 64) == 4 * 2 * 48 * 19126 ** 2 * 64
    assert flops.b2_flops(1, 19126, 48, 64) == 2.5 * flops.b1_flops(1, 19126, 48, 64)
    # B1 at the main shape is bound by its operations: 9.09 ms at 989 TFLOP/s
    assert flops.least_seconds(flops.b1_flops(2, 19126, 48, 64), flops.b1_bytes(2, 19126, 48, 64, 2),
                               "bfloat16") == pytest.approx(9.09e-3, rel=1e-3)
    assert flops.least_seconds(flops.b2_flops(1, 19126, 48, 64), flops.b2_bytes(1, 19126, 48, 64, 2),
                               "bfloat16") == pytest.approx(11.36e-3, rel=1e-3)


def test_tokens_and_dit_forward_at_the_main_shapes():
    t5b, t2b = config("cogvideox-5b")["transformer"], config("cogvideox-2b")["transformer"]
    tok = flops.dit_tokens(t5b, MAIN)
    assert tok == {"text": 226, "ref": 1350, "video": 17550}
    s, d = 19126, 3072
    by_hand = 42 * (2 * 2 * s * 12 * d * d + flops.b1_flops(2, s, 48, 64))  # the blocks' linears and attention
    assert flops.dit_forward_flops(t5b, 2, tok) == pytest.approx(by_hand, rel=2e-3)
    assert flops.dit_forward_flops(t5b, 2, tok) == pytest.approx(7.415e14, rel=1e-3)
    assert flops.dit_forward_flops(t2b, 2, tok) == pytest.approx(2.701e14, rel=1e-3)


@pytest.mark.parametrize("cfg", [TINY_5B, tiny_2b()], ids=["rope", "sincos"])
def test_dit_forward_matches_the_flop_counter(cfg):
    t = cfg["transformer"]
    clip = {"height": 64, "width": 48, "num_frames": 9}
    sd, _ = dit_state_dict(cfg, 3, "cpu", torch.float32)
    x = torch.randn(2, 3, 8, 6, 4)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        DiT(sd, t).forward(x, torch.randn(2, 1, 8, 6, 4), torch.randn(2, 8, 32), torch.tensor([999, 500]),
                           positions(t, **clip))
    assert counter.get_total_flops() == flops.dit_forward_flops(t, 2, flops.dit_tokens(t, clip))


def test_vae_decoder_matches_the_flop_counter():
    v = TINY_5B["vae"]
    sd, _ = vae_state_dict(TINY_5B, 3, "cpu", torch.float32)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        Decoder(sd, v).decode(torch.randn(1, 3, 8, 6, 4))
    assert counter.get_total_flops() == flops.vae_decoder_flops(v, 3, 8, 6)
    assert flops.vae_decoder_flops(config("cogvideox-5b")["vae"], 13, 60, 90) == pytest.approx(3.150e14, rel=1e-3)
