"""A tiny copy of the benchmark for the CPU tests: the real files copied
into a temporary checkout, plus tiny configurations, traffic and cells
added the way a later change would add them (new files, new entries)."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_5B = {
    "name": "tiny-5b", "source": "https://huggingface.co/THUDM/CogVideoX-5b", "dtype": "float32",
    "positions": "rope",
    "transformer": {"attention_bias": True, "attention_head_dim": 16, "flip_sin_to_cos": True, "freq_shift": 0,
                    "in_channels": 4, "max_text_seq_length": 8, "norm_eps": 1e-05, "num_attention_heads": 2,
                    "num_layers": 2, "out_channels": 4, "patch_size": 2, "sample_frames": 9, "sample_height": 8,
                    "sample_width": 8, "spatial_interpolation_scale": 1.875, "temporal_compression_ratio": 4,
                    "temporal_interpolation_scale": 1.0, "text_embed_dim": 32, "time_embed_dim": 16,
                    "use_rotary_positional_embeddings": True},
    "vae": {"block_out_channels": [8, 8, 8, 8], "in_channels": 3, "latent_channels": 4, "layers_per_block": 1,
            "norm_eps": 1e-06, "norm_num_groups": 4, "out_channels": 3, "sample_height": 64, "sample_width": 64,
            "scaling_factor": 0.7, "temporal_compression_ratio": 4},
    "text_encoder": {"d_ff": 64, "d_kv": 8, "d_model": 32, "layer_norm_epsilon": 1e-06, "num_heads": 4,
                     "num_layers": 2, "relative_attention_max_distance": 128, "relative_attention_num_buckets": 32,
                     "vocab_size": 128},
    "scheduler": {"beta_end": 0.012, "beta_schedule": "scaled_linear", "beta_start": 0.00085,
                  "num_train_timesteps": 1000, "prediction_type": "v_prediction", "rescale_betas_zero_snr": True,
                  "set_alpha_to_one": True, "snr_shift_scale": 1.0, "steps_offset": 0,
                  "timestep_spacing": "trailing"},
    "resident": ["transformer", "vae", "text_encoder"], "reduced": [], "assumed": [],
}

TINY_TRAFFIC = {
    "tiny-generate": {"entry": "generate", "height": 64, "width": 48, "num_frames": 9, "num_inference_steps": 4,
                      "guidance_scale": 6.0, "cfg_mode": "batched", "attention_backend": "auto"},
    "tiny-lora": {"entry": "lora_train", "batch_size": 1, "height": 64, "width": 48, "num_frames": 9, "rank": 4,
                  "alpha": 8.0, "learning_rate": 1e-3, "beta1": 0.9, "beta2": 0.95, "epsilon": 1e-8,
                  "weight_decay": 1e-4, "max_grad_norm": 1.0, "remat": "full", "attention_backend": "auto",
                  "setup_steps": 1, "reference_steps": 2},
    "tiny-decode": {"entry": "decode", "batch_size": 1, "height": 64, "width": 48, "num_frames": 9, "clips": 2},
}

# cell -> (config, traffic, limits)
TINY_CELLS = {
    "tiny-5b-generate": ("tiny-5b", "tiny-generate", {"step_rel_l1": 1e-4}),
    "tiny-2b-generate": ("tiny-2b", "tiny-generate", {"step_rel_l1": 1e-4}),
    "tiny-5b-lora-train": ("tiny-5b", "tiny-lora", {"grad_gap": 1e-3, "change_gap": 1e-3}),
    "tiny-5b-decode": ("tiny-5b", "tiny-decode", {"frames_rel_l2": 1e-4}),
}


def tiny_2b() -> dict:
    cfg = copy.deepcopy(TINY_5B)
    cfg.update(name="tiny-2b", source="https://huggingface.co/THUDM/CogVideoX-2b", positions="sincos")
    cfg["transformer"].update(num_attention_heads=3, use_rotary_positional_embeddings=False)
    cfg["scheduler"]["snr_shift_scale"] = 3.0
    return cfg


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_checkout(tmp: Path, limits=None) -> Path:
    """A checkout holding BENCHMARK.json and a copy of benchmark/, with the
    tiny files added beside the real ones.  ``limits`` overrides a cell's."""
    root = tmp / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in (TINY_5B, tiny_2b()):
        write(root / "benchmark" / "configs" / f"{cfg['name']}.json", cfg)
        spec["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                "file": f"benchmark/configs/{cfg['name']}.json", "reduced": [], "why": "a CPU test"})
    for name, traffic in TINY_TRAFFIC.items():
        write(root / "benchmark" / "traffic" / f"{name}.json", traffic)
    for cell, (config, traffic, lim) in TINY_CELLS.items():
        write(root / "benchmark" / "limits" / f"{cell}.json", (limits or {}).get(cell, lim))
        spec["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1, "why": "a CPU test"})
    entry_of = {w["name"]: json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())["entry"]
                for w in spec["workloads"] if w["traffic"] not in TINY_TRAFFIC}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:  # a metric of the real cells of an entry is a metric of its tiny cells too
            entries = {entry_of[c] for c in m["workloads"]}
            m["workloads"] += [c for c, (_, t, _) in TINY_CELLS.items() if TINY_TRAFFIC[t]["entry"] in entries]
    write(root / "BENCHMARK.json", spec)
    return root
