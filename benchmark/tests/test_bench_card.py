"""The harness on the card at a tiny size: the port's kernels under the
benchmark's own spans, read back from the trace by the per-layer readers.
Marked ``gpu``: it skips without a CUDA device (decided in the fixture)."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from benchmark.harness import Cell, run_cell
from benchmark.tests import tiny


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_traced_generate_reads_every_layer(cuda, tmp_path):
    root = tiny.make_checkout(tmp_path, limits={"tiny-5b-generate": {"step_rel_l1": 0.3}})
    cfg = copy.deepcopy(tiny.TINY_5B)
    cfg["dtype"] = "bfloat16"
    cfg["transformer"].update(attention_head_dim=64, text_embed_dim=128, max_text_seq_length=16)
    cfg["text_encoder"]["d_model"] = 128
    tiny.write(root / "benchmark" / "configs" / "tiny-5b.json", cfg)
    r = run_cell(Cell(root, "tiny-5b-generate", root / "benchmark"), 11, 0.5, True, cuda, log=lambda line: None)
    assert r["correct"], json.dumps(r["checks"])
    m = r["metrics"]
    for name in ("mfu.generate", "b1_roofline.generate", "matmul_ms.generate", "other_ms.generate",
                 "idle_share.generate"):
        assert name in m, name
    assert 0 < m["b1_roofline.generate"]["value"] <= 105 and 0 < m["mfu.generate"]["value"] <= 105
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
