"""safetensors files <-> dicts of CPU tensors (counterpart of
``s2v_tpu/loaders/safetensors_io.py``), read and written by the port itself.

The format: an 8-byte little-endian header length n, then n bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__"?:
{str: str}}``), then the tensors' raw little-endian bytes, the offsets
relative to the end of the header.  The reader memory-maps the file
copy-on-write and hands out ``torch.frombuffer`` views (no read until a
tensor is used; writing to one never touches the file).  The writer pads the
header with spaces to a multiple of 8 bytes and orders the tensors by
descending element size, then name, so that every tensor starts aligned to
its element size, with no gap between tensors, as the ``safetensors``
package lays files out.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I8": torch.int8,
    "I32": torch.int32, "I64": torch.int64, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def _read_header(f, path: str) -> tuple:
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its 8-byte header length)")
    (n,) = struct.unpack("<Q", raw)
    header = json.loads(f.read(n))
    return header, 8 + n


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of a file as CPU tensors backed by a private memory map
    (the ``__metadata__`` entry is not returned)."""
    with open(path, "rb") as f:
        header, data_start = _read_header(f, path)
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > data_start else None
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which the port does not read")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        if end - begin != nbytes or data_start + end > size:
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} {info['dtype']} has offsets {begin}..{end}")
        if nbytes == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(buf, dtype=torch.uint8, count=nbytes, offset=data_start + begin)
        out[name] = flat.view(dtype).reshape(shape)
    return out


def _as_cpu_tensor(value, dtype: torch.dtype) -> torch.Tensor:
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(value))
    return value.detach().to(dtype).to("cpu").contiguous()


def save_safetensors(tensors: Mapping[str, object], path: str, dtype: Optional[torch.dtype] = None) -> None:
    """Write tensors (torch, on any device, or numpy) to ``path``, each cast
    to ``dtype`` if given.  Each is written from a contiguous copy: a
    transposed view is written with its values in its own shape, never its
    underlying buffer (``s2v_tpu/loaders/safetensors_io.py:29-33``).
    Tensors are cast and moved to the host one at a time."""
    meta = {}
    for name, value in tensors.items():
        if dtype is not None:
            tdtype = dtype
        elif isinstance(value, torch.Tensor):
            tdtype = value.dtype
        else:
            tdtype = torch.from_numpy(np.zeros(0, value.dtype)).dtype
        if tdtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {tdtype}, which the port does not write")
        meta[name] = (tdtype, tuple(value.shape))
    order = sorted(meta, key=lambda n: (-torch.empty((), dtype=meta[n][0]).element_size(), n))
    header: dict = {}
    offset = 0
    for name in order:
        tdtype, shape = meta[name]
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=tdtype).element_size()
        header[name] = {"dtype": _NAMES[tdtype], "shape": list(shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-(8 + len(raw)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = _as_cpu_tensor(tensors[name], meta[name][0])
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def load_sharded_safetensors(model_dir: str) -> Dict[str, torch.Tensor]:
    """Load a HF model dir: single file or index-sharded safetensors."""
    index = os.path.join(model_dir, "diffusion_pytorch_model.safetensors.index.json")
    alt_index = os.path.join(model_dir, "model.safetensors.index.json")
    for idx_path in (index, alt_index):
        if os.path.exists(idx_path):
            with open(idx_path) as f:
                shard_files = sorted(set(json.load(f)["weight_map"].values()))
            out: Dict[str, torch.Tensor] = {}
            for shard in shard_files:
                out.update(load_safetensors(os.path.join(model_dir, shard)))
            return out
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors"):
        p = os.path.join(model_dir, name)
        if os.path.exists(p):
            return load_safetensors(p)
    # fall back: any single safetensors file
    cands = [f for f in os.listdir(model_dir) if f.endswith(".safetensors")]
    if len(cands) == 1:
        return load_safetensors(os.path.join(model_dir, cands[0]))
    raise FileNotFoundError(f"no safetensors found in {model_dir}")


def best_guess_lora_file(ckpt_dir: str) -> str:
    """Resolve the LoRA safetensors in an Accelerate checkpoint dir: filter
    out optimizer/scheduler/ema/random-state files, expect exactly one left
    (``s2v_tpu/loaders/safetensors_io.py:60``)."""
    if os.path.isfile(ckpt_dir):
        return ckpt_dir
    cands = [
        f
        for f in os.listdir(ckpt_dir)
        if f.endswith(".safetensors")
        and not any(sub in f for sub in ("optimizer", "scheduler", "ema", "random_states"))
    ]
    if len(cands) != 1:
        raise FileNotFoundError(
            f"expected exactly one LoRA .safetensors in {ckpt_dir}, found {cands}"
        )
    return os.path.join(ckpt_dir, cands[0])
