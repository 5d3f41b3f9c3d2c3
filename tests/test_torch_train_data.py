"""The port's video-folder dataset (``s2v_torch/training/data.py``:
``read_video_frames``, ``VideoFolderDataset`` and the disk cache's key)
against the JAX package's (``s2v_tpu/training/data.py:28-148``) on the same
files: small clips written here with OpenCV (``mp4v``), a ``prompts.txt``
and one ``<stem>_ref.png``.  Both decode through OpenCV and compute in
float32 numpy, so every item is equal bit for bit (tolerance 0)."""

import os

import numpy as np
import pytest
import torch

from s2v_tpu.training import data as j_data
from s2v_torch.training import data

H, W = 24, 40  # the stored frames; the datasets resize to 16 x 32


def _write_clip(path, frames, seed):
    import cv2

    rng = np.random.RandomState(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8, (W, H))
    assert writer.isOpened()
    for i in range(frames):
        writer.write((rng.rand(H, W, 3) * 255).astype(np.uint8))
    writer.release()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("clips")
    _write_clip(root / "b.mp4", 11, seed=1)
    _write_clip(root / "a.avi", 4, seed=2)  # short: padded by its last frame
    (root / "notes.txt").write_text("not a video")
    (root / "prompts.txt").write_text("a pig\n\na cat walking\n")
    Image.fromarray((np.random.RandomState(3).rand(20, 28, 3) * 255).astype(np.uint8)).save(root / "b_ref.png")
    return root


@pytest.mark.parametrize("kw", [dict(), dict(skip_frames_start=2, skip_frames_end=3), dict(num_frames=15)])
def test_read_video_frames_equals_jax(folder, kw):
    args = dict(num_frames=9, height=16, width=32)
    args.update(kw)
    for name in ("b.mp4",) if "skip_frames_end" in kw else ("b.mp4", "a.avi"):  # a.avi holds 4 frames
        got = data.read_video_frames(str(folder / name), **args)
        want = j_data.read_video_frames(str(folder / name), **args)
        assert got.dtype == np.float32 and got.shape == (args["num_frames"], 16, 32, 3)
        np.testing.assert_array_equal(got, want)
    if "skip_frames_end" not in kw:
        short = data.read_video_frames(str(folder / "a.avi"), **args)
        np.testing.assert_array_equal(short[-1], short[3])  # padding repeats the last decoded frame


def test_video_folder_dataset_items_equal_jax(folder):
    mine = data.VideoFolderDataset(str(folder), num_frames=9, height=16, width=32)
    theirs = j_data.VideoFolderDataset(str(folder), num_frames=9, height=16, width=32)
    assert mine.videos == theirs.videos and [os.path.basename(v) for v in mine.videos] == ["a.avi", "b.mp4"]
    assert mine.prompts == theirs.prompts == ["a pig", "a cat walking"]
    assert len(mine) == len(theirs) == 2
    for i in range(2):
        got, want = mine[i], theirs[i]
        assert got["prompt"] == want["prompt"]
        for key in ("video", "ref_image"):
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], want[key])
    assert mine[1]["ref_image"].shape == (20, 28, 3)  # b_ref.png at its own size
    np.testing.assert_array_equal(mine[0]["ref_image"], mine[0]["video"][0])  # no _ref.png: the first frame


def test_empty_folder_and_missing_prompts(tmp_path):
    with pytest.raises(ValueError, match="no videos"):
        data.VideoFolderDataset(str(tmp_path))
    _write_clip(tmp_path / "x.mp4", 3, seed=4)
    ds = data.VideoFolderDataset(str(tmp_path), num_frames=3, height=16, width=32)
    assert ds.prompts == [""] and ds[0]["prompt"] == ""


def test_disk_cache_key_is_jax_file_identity(folder, tmp_path):
    """A file-backed item's cache file is named as JAX names it (path,
    mtime, size, geometry, prompt, subject image), without decoding the
    video, and a changed subject image gives another name."""
    mine = data.VideoFolderDataset(str(folder), num_frames=9, height=16, width=32)
    theirs = j_data.VideoFolderDataset(str(folder), num_frames=9, height=16, width=32)
    for i in range(2):
        assert data._disk_cache_path(str(tmp_path), None, i, mine) == j_data._disk_cache_path(str(tmp_path), theirs, i)
    before = data._disk_cache_path(str(tmp_path), None, 1, mine)
    ref = folder / "b_ref.png"
    st = os.stat(ref)
    os.utime(ref, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    assert data._disk_cache_path(str(tmp_path), None, 1, mine) != before
    # an item in memory keeps its content key
    item = {"video": np.zeros((2, 4, 4, 3), np.float32), "ref_image": np.zeros((4, 4, 3), np.float32), "prompt": ""}
    key = data._disk_cache_path(str(tmp_path), item, 0)
    item["video"][0, 0, 0, 0] = 1.0
    assert data._disk_cache_path(str(tmp_path), item, 0) != key


def test_latent_batches_encode_a_folder_once(folder, tmp_path):
    """``latent_batches`` over the folder with a disk cache: the second
    epoch of a new process (a fresh dict) reads the cache files and never
    decodes a video; the batches equal the first run's."""
    from s2v_torch import S2VPipeline, T5Config, TransformerConfig, VAEConfig
    from s2v_torch.models.t5 import init_t5_params_random
    from s2v_torch.models.transformer import init_transformer_params_random
    from s2v_torch.models.vae import init_vae_params_random

    class Tok:
        def encode(self, prompts, max_length):
            return np.array([[(sum(p.encode()) + i) % 50 for i in range(max_length)] for p in prompts], np.int64)

    tcfg = TransformerConfig.tiny()
    vcfg = VAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64)
    pipe = S2VPipeline(transformer_params=init_transformer_params_random(tcfg, device="cpu"), transformer_cfg=tcfg,
                       vae_params=init_vae_params_random(vcfg, device="cpu"), vae_cfg=vcfg,
                       t5_params=init_t5_params_random(T5Config.tiny(), device="cpu"), t5_cfg=T5Config.tiny(),
                       tokenizer=Tok(), device="cpu")
    ds = data.VideoFolderDataset(str(folder), num_frames=9, height=16, width=32)
    first = list(data.latent_batches(ds, pipe, seed=1, cache={}, cache_dir=str(tmp_path)))
    assert len(os.listdir(tmp_path)) == 2

    def no_decode(*a, **k):
        raise AssertionError("decoded a cached video")

    real = data.read_video_frames
    data.read_video_frames = no_decode
    try:
        again = list(data.latent_batches(ds, pipe, seed=1, cache={}, cache_dir=str(tmp_path)))
    finally:
        data.read_video_frames = real
    for a, b in zip(first, again):
        for k in a:
            assert torch.equal(a[k], b[k])
