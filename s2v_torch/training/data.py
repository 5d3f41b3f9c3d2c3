"""Training batches from a dataset of clips (counterpart of
``s2v_tpu/training/data.py``): VAE posterior moments and T5 prompt
embeddings per item, cached, then shuffled epochs of latent batches.

A dataset is anything indexable with a length whose items are
``{"video": [T, H, W, 3], "ref_image": [H, W, 3], "prompt": str}`` with
pixels in [-1, 1].  The JAX package's ``VideoFolderDataset`` (mp4 decoding
through OpenCV) is not ported yet.
"""

from __future__ import annotations

import hashlib
import os
import random
from typing import Iterator, Optional

import numpy as np
import torch

from s2v_torch.models.t5 import t5_encode
from s2v_torch.models.vae import gaussian_sample, vae_encode


@torch.no_grad()
def _encode_moments(item: dict, pipe) -> dict:
    dev, dt = pipe.device, pipe.vae_cfg.dtype
    video = torch.as_tensor(np.asarray(item["video"], np.float32)).to(dev, dt)[None]
    ref = torch.as_tensor(np.asarray(item["ref_image"], np.float32)).to(dev, dt)[None, None]
    vm = vae_encode(pipe.vae_params, pipe.vae_cfg, video)
    rm = vae_encode(pipe.vae_params, pipe.vae_cfg, ref)
    ids = pipe.tokenizer.encode([item["prompt"]], pipe.transformer_cfg.max_text_seq_length)
    emb = t5_encode(pipe.t5_params, pipe.t5_cfg, torch.as_tensor(ids, device=dev))
    return {"vm": vm[0], "rm": rm[0], "emb": emb[0]}


def _encode_item_moments(dataset, pipe, idx: int) -> dict:
    """Deterministic per-item encodings on the pipeline's device: the VAE
    posterior moments (mean | logvar, not a sample, so caching them does not
    freeze the per-epoch posterior noise) and the T5 prompt embedding."""
    return _encode_moments(dataset[idx], pipe)


def _disk_cache_path(cache_dir: str, item: dict, idx: int) -> str:
    """Content-addressed path for an item's cached encodings.  The items are
    in memory, not files, so the key is the item's index, the video's
    geometry, the prompt and a sha1 of the video and subject pixels (the JAX
    package keys a video file's path, mtime and size instead); any change
    invalidates the entry."""
    video = np.ascontiguousarray(item["video"], np.float32)
    ref = np.ascontiguousarray(item["ref_image"], np.float32)
    content = hashlib.sha1(video.tobytes())
    content.update(ref.tobytes())
    ident = f"{idx}|{'x'.join(map(str, video.shape))}|{item['prompt']}|{content.hexdigest()}"
    return os.path.join(cache_dir, hashlib.sha1(ident.encode()).hexdigest()[:20] + ".npz")


def latent_batches(
    dataset,
    pipe,  # S2VPipeline: vae + t5 + tokenizer, on its device
    batch_size: int = 1,
    seed: int = 0,
    rng_noise: bool = True,
    cache: Optional[dict] = None,
    cache_dir: Optional[str] = None,
) -> Iterator[dict]:
    """One shuffled epoch of training batches on ``pipe.device``: video
    latents (a posterior sample times the VAE scaling factor), ref latents,
    T5 prompt embeddings, the inputs of ``lora_loss_fn``.

    The order is ``random.Random(seed)``'s shuffle, as in the JAX package.
    The posterior noise comes from a CPU ``torch.Generator`` seeded with
    ``seed`` (``rng_noise=False`` takes the posterior mean instead).
    ``cache``: a dict kept across epochs holds each item's moments and
    embedding on the host, so each item is encoded once.  ``cache_dir``
    (needs ``cache``) also keeps them on disk (:func:`_disk_cache_path`), so a
    restarted run skips the VAE and T5 encode."""
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
    order = list(range(len(dataset)))
    random.Random(seed).shuffle(order)
    gen = torch.Generator().manual_seed(seed)
    dev = pipe.device

    def moments(idx: int) -> dict:
        if cache is None:
            return _encode_item_moments(dataset, pipe, idx)
        if idx not in cache:
            item = dataset[idx]
            disk = _disk_cache_path(cache_dir, item, idx) if cache_dir else None
            if disk and os.path.exists(disk):
                with np.load(disk) as z:
                    loaded = {k: z[k] for k in ("vm", "rm", "emb")}
            else:
                loaded = {k: v.float().cpu().numpy() for k, v in _encode_moments(item, pipe).items()}
                if disk:
                    tmp = disk + ".tmp"
                    with open(tmp, "wb") as f:  # file object: no .npz suffixing
                        np.savez(f, **loaded)
                    os.replace(tmp, disk)  # atomic publish
            cache[idx] = loaded
        dtypes = {"vm": pipe.vae_cfg.dtype, "rm": pipe.vae_cfg.dtype, "emb": pipe.t5_cfg.dtype}
        return {k: torch.as_tensor(v).to(dev, dtypes[k]) for k, v in cache[idx].items()}

    def sample(m: torch.Tensor) -> torch.Tensor:
        noise = None
        if rng_noise:
            noise = torch.randn(m.shape[:-1] + (m.shape[-1] // 2,), generator=gen).to(dev)  # fp32
        return gaussian_sample(m, noise) * pipe.vae_cfg.scaling_factor

    for start in range(0, len(order) - batch_size + 1, batch_size):
        items = [moments(i) for i in order[start:start + batch_size]]
        vm = torch.stack([it["vm"] for it in items])
        rm = torch.stack([it["rm"] for it in items])
        yield {
            "video_latents": sample(vm),
            "ref_latents": sample(rm),
            "text_embeds": torch.stack([it["emb"] for it in items]),
        }


def prefetch_batches(it: Iterator[dict], depth: int = 2) -> Iterator[dict]:
    """Run ``it`` on a background thread with a bounded queue, so the host
    work of batch i+1 overlaps the train step on batch i.  The producer's
    exceptions re-raise at the consuming ``next()``; closing the generator
    early stops the producer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            put((end, e))
            return
        put((end, None))

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is end:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
        while not q.empty():  # unblock a producer mid-put, drop queued batches
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
