"""The port's image and video I/O against the JAX package's and PIL/OpenCV:
``load_image`` (PIL, and the zlib PNG decoder for hosts without PIL),
``export_to_video`` and its writer chain, the per-frame export, ``psnr``,
and ``postprocess_video``'s ``pt``/``pil`` outputs."""

import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from s2v_tpu.utils import video as jvideo
from s2v_torch.utils import mp4_native, video

# an mp4 of the same frames through another H.264 (or mp4v) encoder: lossy
MIN_PSNR_DB = 30.0


def _image(channels, seed=0, h=72, w=40):
    """Gradients, repeated rows, noise and flat stretches: rows on which
    PIL's adaptive filtering picks different PNG filter types."""
    rng = np.random.RandomState(seed)
    img = ((np.arange(w)[None, :, None] * 7 + np.arange(h)[:, None, None] * 3
            + rng.randint(0, 4, (h, w, channels))) % 256).astype(np.uint8)
    img[10:20] = img[9]
    img[20:30] = rng.randint(0, 256, (10, w, channels))
    img[30:40] = np.arange(w)[None, :, None] * 5 % 256
    return img


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _encode_png(arr, filters, depth=8, interlace=0):
    """A PNG whose row y uses filter ``filters[y % len(filters)]`` (PIL
    chooses its filters itself and never writes Average)."""
    h, w, c = arr.shape
    cur_rows = arr.reshape(h, w * c).astype(np.int64)
    prev = np.zeros(w * c, np.int64)
    raw = bytearray()
    for y in range(h):
        f, cur = filters[y % len(filters)], cur_rows[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw.append(f)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    color = {3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
            + _chunk(b"IDAT", zlib.compress(bytes(raw))) + _chunk(b"IEND", b""))


def _png_filters(data, bpp):
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * (w * bpp + 1)] for y in range(h)}


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_load_image_equals_jax(tmp_path, fmt):
    path = str(tmp_path / f"ref.{fmt.lower()}")
    Image.fromarray(_image(3, h=48, w=64)).save(path, format=fmt)
    got, want = video.load_image(path), jvideo.load_image(path)
    assert got.shape == (48, 64, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_png_decoder_equals_pil_on_pil_files(tmp_path, mode):
    c = len(mode)
    path = str(tmp_path / "a.png")
    Image.fromarray(_image(c), mode).save(path)
    with open(path, "rb") as f:
        assert _png_filters(f.read(), c) == {0, 1, 2, 4}  # PIL's adaptive filtering
    with Image.open(path) as img:
        np.testing.assert_array_equal(video.read_png_rgb(path), np.asarray(img.convert("RGB")))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_png_decoder_every_filter_type_equals_pil(tmp_path, mode):
    c = len(mode)
    path = tmp_path / "f.png"
    path.write_bytes(_encode_png(_image(c, seed=3), filters=[0, 1, 2, 3, 4, 3, 4]))
    assert _png_filters(path.read_bytes(), c) == {0, 1, 2, 3, 4}
    with Image.open(path) as img:
        np.testing.assert_array_equal(video.read_png_rgb(str(path)), np.asarray(img.convert("RGB")))


@pytest.mark.parametrize("case", ["interlaced", "16_bit", "palette", "not_png"])
def test_png_decoder_refuses_what_it_does_not_read(tmp_path, case):
    path = tmp_path / f"{case}.png"
    if case == "interlaced":
        path.write_bytes(_encode_png(_image(3), [0], interlace=1))
    elif case == "16_bit":
        path.write_bytes(_encode_png(_image(3), [0], depth=16))
    elif case == "palette":
        Image.fromarray(_image(3)).convert("P").save(path)
    else:
        Image.fromarray(_image(3)).save(path, format="JPEG")
    with pytest.raises(ValueError, match=case.split("_")[0] if case != "16_bit" else "bit depth 16") as err:
        video.read_png_rgb(str(path))
    assert str(path) in str(err.value)


def test_load_image_without_pil_uses_the_png_decoder(tmp_path, monkeypatch):
    path = str(tmp_path / "ref.png")
    Image.fromarray(_image(4), "RGBA").save(path)
    want = jvideo.load_image(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    np.testing.assert_array_equal(video.load_image(path), want)


def _frames(t=9, h=48, w=64, seed=0):
    rng = np.random.RandomState(seed)
    base = np.linspace(0, 1, h * w * 3, dtype=np.float32).reshape(h, w, 3)
    return np.stack([np.clip(np.roll(base, 3 * i, axis=1) + 0.05 * rng.rand(h, w, 3), 0, 1) for i in range(t)])


def _decode(path):
    cap = cv2.VideoCapture(path)
    frames, fps = [], cap.get(cv2.CAP_PROP_FPS)
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames), fps


def test_export_to_video_agrees_with_jax(tmp_path):
    """The port's writer chain (its own build of native/mp4_muxer.cc where
    libavformat is present, else OpenCV) against the JAX package's export of
    the same frames: cv2 reads 9 frames at 8 fps from both, within
    MIN_PSNR_DB."""
    frames = _frames()
    got = video.export_to_video(frames, str(tmp_path / "port.mp4"), fps=8)
    want = jvideo.export_to_video(frames, str(tmp_path / "jax.mp4"), fps=8)
    assert got == str(tmp_path / "port.mp4")  # an mp4 either way: native muxer or OpenCV
    port, port_fps = _decode(got)
    ref, _ = _decode(want)
    assert port.shape == ref.shape == (9, 48, 64, 3) and round(port_fps) == 8
    assert video.psnr(port / 255.0, ref / 255.0) >= MIN_PSNR_DB
    assert video.psnr(port / 255.0, video.to_uint8_frames(frames) / 255.0) >= MIN_PSNR_DB
    if mp4_native.is_available():  # libavformat here: H.264 from the native muxer
        fourcc = int(cv2.VideoCapture(got).get(cv2.CAP_PROP_FOURCC))
        assert fourcc in (cv2.VideoWriter_fourcc(*"avc1"), cv2.VideoWriter_fourcc(*"h264"))


def test_export_writer_chain_falls_back(tmp_path, monkeypatch):
    frames = _frames(t=3)

    def broken(*a, **k):
        raise RuntimeError("no libavformat")

    monkeypatch.setattr(mp4_native, "write_mp4", broken)
    path = video.export_to_video(frames, str(tmp_path / "cv2.mp4"))
    assert path.endswith("cv2.mp4") and _decode(path)[0].shape == (3, 48, 64, 3)
    monkeypatch.setitem(sys.modules, "cv2", None)
    signed = frames * 2 - 1  # [-1, 1] input
    path = video.export_to_video(signed, str(tmp_path / "none.mp4"))
    assert path == str(tmp_path / "none.npy")
    np.testing.assert_array_equal(np.load(path), video.to_uint8_frames(video.denormalize_video(signed)))


def test_write_mp4_pads_odd_sizes_and_checks_input(tmp_path):
    if not mp4_native.is_available():
        with pytest.raises(RuntimeError):
            mp4_native.write_mp4(np.zeros((2, 8, 8, 3), np.uint8), str(tmp_path / "x.mp4"))
        return
    out = mp4_native.write_mp4((_frames(t=4, h=33, w=47) * 255).astype(np.uint8), str(tmp_path / "odd.mp4"))
    assert _decode(out)[0].shape == (4, 34, 48, 3)
    with pytest.raises(ValueError, match="uint8"):
        mp4_native.write_mp4(np.zeros((2, 8, 8, 3), np.float32), str(tmp_path / "bad.mp4"))


def test_export_with_frames_equals_jax(tmp_path):
    frames = _frames(t=4)
    video.export_to_video_with_frames(frames, str(tmp_path / "p" / "clip.mp4"))
    jvideo.export_to_video_with_frames(frames, str(tmp_path / "j" / "clip.mp4"))
    for i in range(4):
        name = f"clip_frames/frame_{i:04d}.png"
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "p" / name)), cv2.imread(str(tmp_path / "j" / name)))


@pytest.mark.parametrize("case", ["equal", "noisy", "max_255"])
def test_psnr_equals_jax(case):
    a = _frames(t=2)
    b = a if case == "equal" else np.clip(a + 0.01 * np.random.RandomState(1).randn(*a.shape), 0, 1)
    kw = {"max_val": 255.0} if case == "max_255" else {}
    if case == "max_255":
        a, b = a * 255, b * 255
    assert video.psnr(a, b, **kw) == jvideo.psnr(a, b, **kw)


@pytest.fixture(scope="module")
def pipelines():
    """postprocess_video needs no weights: a pipeline of empty trees on
    each side."""
    from s2v_tpu.config import TransformerConfig as JT, VAEConfig as JV
    from s2v_tpu.pipelines.s2v import S2VPipeline as JPipe
    from s2v_torch.config import TransformerConfig, VAEConfig
    from s2v_torch.pipelines.s2v import S2VPipeline

    return (S2VPipeline({}, TransformerConfig.tiny(), {}, VAEConfig.tiny(), device="cpu"),
            JPipe({}, JT.tiny(), {}, JV.tiny()))


@pytest.mark.parametrize("output_type", ["pt", "pil", "np"])
def test_postprocess_video_equals_jax(pipelines, output_type):
    port, ref = pipelines
    clip = _frames(t=3)[None].repeat(2, axis=0)
    got, want = port.postprocess_video(clip, output_type), ref.postprocess_video(clip, output_type)
    if output_type == "pt":
        assert got.shape == (2, 3, 3, 48, 64) and torch.equal(got, want)
    elif output_type == "pil":
        assert [len(c) for c in got] == [3, 3]
        for gc, wc in zip(got, want):
            for g, w in zip(gc, wc):
                assert g.mode == w.mode == "RGB" and np.array_equal(np.asarray(g), np.asarray(w))
    else:
        assert got is clip
    with pytest.raises(ValueError, match="np | pil | pt | latent"):
        port.postprocess_video(clip, "gif")


def test_postprocess_pil_says_when_pil_is_absent(pipelines, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        pipelines[0].postprocess_video(_frames(t=1)[None], "pil")
