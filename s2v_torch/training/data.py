"""Training batches from a dataset of clips (counterpart of
``s2v_tpu/training/data.py``): a folder of videos decoded through OpenCV,
VAE posterior moments and T5 prompt embeddings per item, cached, then
shuffled epochs of latent batches.

A dataset is anything indexable with a length whose items are
``{"video": [T, H, W, 3], "ref_image": [H, W, 3], "prompt": str}`` with
pixels in [-1, 1]: :class:`VideoFolderDataset`, or items in memory.
"""

from __future__ import annotations

import hashlib
import os
import random
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np
import torch

from s2v_torch.models.t5 import t5_encode
from s2v_torch.models.vae import gaussian_sample, vae_encode

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def read_video_frames(
    path: str,
    num_frames: int = 49,
    height: int = 480,
    width: int = 720,
    skip_frames_start: int = 0,
    skip_frames_end: int = 0,
) -> np.ndarray:
    """Decode, trim, resize -> float32 [-1, 1] ``[T, H, W, 3]`` (RGB).

    The reference CLI's frame conventions (``--max_num_frames``,
    ``--skip_frames_start/end``): the first ``num_frames`` frames after the
    skips, each resized to H x W with ``INTER_AREA``; a short clip is padded
    by repeating its last frame.  OpenCV decodes on both machines (the
    card's has no libavformat, ROADMAP C.12)."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames: List[np.ndarray] = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    frames = frames[skip_frames_start:len(frames) - skip_frames_end][:num_frames]
    while len(frames) < num_frames:
        frames.append(frames[-1])
    out = np.empty((num_frames, height, width, 3), np.float32)
    for i, f in enumerate(frames):
        f = cv2.resize(f, (width, height), interpolation=cv2.INTER_AREA)
        out[i] = cv2.cvtColor(f, cv2.COLOR_BGR2RGB).astype(np.float32)
    return out / 255.0 * 2.0 - 1.0


@dataclass
class VideoFolderDataset:
    """``root/*.mp4`` (and the other ``VIDEO_EXTS``, sorted) with an optional
    ``root/prompts.txt`` (one prompt per non-empty line, in the sorted
    videos' order; without it every prompt is empty) and an optional subject
    image ``<stem>_ref.png`` per video (without it, the clip's first frame)."""

    root: str
    num_frames: int = 49
    height: int = 480
    width: int = 720

    def __post_init__(self):
        self.videos = sorted(os.path.join(self.root, f) for f in os.listdir(self.root)
                             if f.lower().endswith(VIDEO_EXTS))
        if not self.videos:
            raise ValueError(f"no videos in {self.root}")
        prompts_file = os.path.join(self.root, "prompts.txt")
        if os.path.exists(prompts_file):
            with open(prompts_file) as f:
                self.prompts = [line.strip() for line in f if line.strip()]
        else:
            self.prompts = [""] * len(self.videos)

    def __len__(self) -> int:
        return len(self.videos)

    def ref_path(self, idx: int) -> str:
        return os.path.splitext(self.videos[idx])[0] + "_ref.png"

    def prompt(self, idx: int) -> str:
        return self.prompts[idx % len(self.prompts)]

    def __getitem__(self, idx: int) -> dict:
        video = read_video_frames(self.videos[idx], self.num_frames, self.height, self.width)
        if os.path.exists(self.ref_path(idx)):
            from s2v_torch.utils.video import load_image

            ref = load_image(self.ref_path(idx))
        else:
            ref = video[0]  # the subject defaults to the first frame
        return {"video": video, "ref_image": ref, "prompt": self.prompt(idx)}


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


def _file_cache_ident(dataset: VideoFolderDataset, idx: int) -> str:
    """A file-backed item's identity, JAX's (``s2v_tpu/training/data.py:127-148``):
    the video file's absolute path, mtime and size, the requested geometry,
    the prompt, and the subject image's mtime and size when there is one."""
    path = dataset.videos[idx]
    st = os.stat(path)
    ref_id = ""
    if os.path.exists(dataset.ref_path(idx)):
        rst = os.stat(dataset.ref_path(idx))
        ref_id = f"|{rst.st_mtime_ns}|{rst.st_size}"
    return (f"{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}|"
            f"{dataset.num_frames}x{dataset.height}x{dataset.width}|{dataset.prompt(idx)}{ref_id}")


def _disk_cache_path(cache_dir: str, item: dict, idx: int, dataset=None) -> str:
    """Content-addressed path for an item's cached encodings; any change
    invalidates the entry.  An item of a :class:`VideoFolderDataset` is keyed
    on its files as the JAX package keys it (:func:`_file_cache_ident`, the
    same file name), without decoding the video; an item in memory on its
    index, the video's geometry, the prompt and a sha1 of the video and
    subject pixels."""
    if isinstance(dataset, VideoFolderDataset):
        ident = _file_cache_ident(dataset, idx)
        return os.path.join(cache_dir, hashlib.sha1(ident.encode()).hexdigest()[:20] + ".npz")
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
            # a file-backed item is keyed without decoding it; one in memory by its pixels
            item = None if isinstance(dataset, VideoFolderDataset) else dataset[idx]
            disk = _disk_cache_path(cache_dir, item, idx, dataset) if cache_dir else None
            if disk and os.path.exists(disk):
                with np.load(disk) as z:
                    loaded = {k: z[k] for k in ("vm", "rm", "emb")}
            else:
                item = dataset[idx] if item is None else item
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


def data_rows(batch_size: int, data: int) -> int:
    """The rows each rank of a ``data`` mesh dim of ``data`` ranks takes of
    every batch: the DiT keeps rank r's rows ``[r·n, (r+1)·n)``, the layout
    of JAX's ``P("data")`` batch (``models/transformer.py``); every rank
    loads the whole batch and draws its noise, so the step equals the
    unsharded one.  A batch the dim does not divide raises with the JAX
    trainer's text (``s2v_tpu/train.py:250-254``)."""
    if batch_size % data:
        raise ValueError(f"--train_batch_size {batch_size} must be divisible by the data mesh axis ({data})")
    return batch_size // data


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
