"""Model-source resolution: local snapshot dirs + env-gated hub download
(counterpart of ``s2v_tpu/loaders/resolve.py``, with the same gates and
error texts).

``resolve_model_dir`` accepts either a local snapshot directory or a hub
repo id such as ``THUDM/CogVideoX-5b``; repo ids resolve through
``huggingface_hub.snapshot_download`` (imported only then) when the network
is allowed, with an offline-deterministic error otherwise.

Offline gates (any one forces local-only): ``HF_HUB_OFFLINE=1``,
``S2V_TPU_OFFLINE=1``, or ``huggingface_hub`` not importable.
"""

from __future__ import annotations

import os
from typing import Optional

# submodels a CogVideoX snapshot must carry, and the loadable files each
# needs (the second tuple lists alternatives — any one suffices)
_REQUIRED = {
    "transformer": ("config.json",),
    "vae": ("config.json",),
}
_OPTIONAL = ("text_encoder", "tokenizer", "scheduler")
_WEIGHT_MARKERS = (
    ".safetensors",
    "diffusion_pytorch_model.safetensors.index.json",
    "model.safetensors.index.json",
)


def _offline() -> bool:
    # accept the same truthy spellings huggingface_hub does
    truthy = ("1", "true", "yes", "on")
    return (
        os.environ.get("HF_HUB_OFFLINE", "").lower() in truthy
        or os.environ.get("S2V_TPU_OFFLINE", "").lower() in truthy
    )


def validate_snapshot_layout(model_dir: str) -> None:
    """Raise a precise error describing what's missing from a snapshot dir
    (instead of a KeyError deep inside the state-dict converter)."""
    problems = []
    for sub, needed in _REQUIRED.items():
        subdir = os.path.join(model_dir, sub)
        if not os.path.isdir(subdir):
            problems.append(f"missing subdir {sub}/")
            continue
        for f in needed:
            if not os.path.exists(os.path.join(subdir, f)):
                problems.append(f"missing {sub}/{f}")
        entries = os.listdir(subdir)
        if not any(e.endswith(m) or e == m for e in entries for m in _WEIGHT_MARKERS):
            problems.append(f"no .safetensors weights under {sub}/")
    if problems:
        raise FileNotFoundError(
            f"{model_dir!r} is not a usable CogVideoX snapshot: "
            + "; ".join(problems)
            + ". Expected the HF layout (transformer/ vae/ [text_encoder/ "
            "tokenizer/ scheduler/]), e.g. from: huggingface-cli download "
            "THUDM/CogVideoX-5b --local-dir <dir>"
        )


def resolve_model_dir(name_or_dir: str, cache_dir: Optional[str] = None) -> str:
    """Local dir (validated) or hub repo id (downloaded when online)."""
    expanded = os.path.expanduser(name_or_dir)
    if os.path.isdir(expanded):
        validate_snapshot_layout(expanded)
        return expanded
    looks_like_repo = (
        "/" in name_or_dir
        and not name_or_dir.startswith((".", "/", "~"))
        and name_or_dir.count("/") == 1
    )
    if not looks_like_repo:
        raise FileNotFoundError(
            f"model path {name_or_dir!r} does not exist and is not a hub "
            f"repo id (org/name)"
        )
    if _offline():
        raise FileNotFoundError(
            f"{name_or_dir!r} is a hub repo id but the hub is disabled "
            f"(HF_HUB_OFFLINE/S2V_TPU_OFFLINE). Pre-download with: "
            f"huggingface-cli download {name_or_dir} --local-dir <dir> and "
            f"pass the local path."
        )
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise FileNotFoundError(
            f"{name_or_dir!r} is a hub repo id but huggingface_hub is not "
            f"installed; pre-download the snapshot and pass a local path."
        ) from e
    local = snapshot_download(
        name_or_dir,
        cache_dir=cache_dir,
        allow_patterns=[
            "*/config.json",
            "*/*.safetensors",
            "*/*.index.json",
            "*/spiece.model",
            "*/tokenizer.json",
            "*/tokenizer_config.json",
            "*/special_tokens_map.json",
            "scheduler/*",
            "model_index.json",
        ],
    )
    validate_snapshot_layout(local)
    return local
