"""Image and video I/O and the array helpers of post-processing
(counterpart of ``s2v_tpu/utils/video.py``).

``export_to_video`` writes an mp4 through the native muxer
(``utils/mp4_native.py``: libavformat + libx264), else through OpenCV's
writer, else dumps the frames as ``.npy``, in the JAX package's order, and
returns the path it wrote; each step it skips is logged as a warning.
``load_image`` reads through PIL, or without PIL through a decoder of
8-bit non-interlaced RGB/RGBA PNG written here on ``zlib``.
"""

from __future__ import annotations

import logging
import os
import struct
import zlib
from typing import Optional

import numpy as np

_log = logging.getLogger("s2v_torch.video")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def denormalize_video(video: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> [0, 1] float32."""
    return np.clip(np.asarray(video, dtype=np.float32) / 2.0 + 0.5, 0.0, 1.0)


def to_uint8_frames(video01: np.ndarray) -> np.ndarray:
    """[0, 1] float frames -> uint8."""
    return np.round(video01 * 255.0).astype(np.uint8)


def _as_uint8(frames) -> np.ndarray:
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = to_uint8_frames(denormalize_video(frames) if frames.min() < 0 else frames)
    return frames


def export_to_video(frames: np.ndarray, path: str, fps: int = 8) -> str:
    """Write ``[T, H, W, 3]`` frames (uint8 RGB, or float in [0, 1] or
    [-1, 1]) to an mp4 at ``path`` at ``fps``; returns the path written
    (``.npy`` beside it when no video writer works here)."""
    frames = _as_uint8(frames)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    try:
        from s2v_torch.utils import mp4_native

        return mp4_native.write_mp4(frames, path, fps=fps)
    except Exception as e:  # the JAX package's writer chain: any failure moves on
        _log.warning("native mp4 muxer unavailable (%s); writing %s with OpenCV", str(e).splitlines()[0], path)
    try:
        import cv2

        _, h, w, _ = frames.shape
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not writer.isOpened():
            raise RuntimeError("cv2.VideoWriter failed to open")
        for frame in frames:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        writer.release()
        return path
    except Exception as e:
        alt = os.path.splitext(path)[0] + ".npy"
        _log.warning("OpenCV cannot write %s (%s); saving the frames to %s", path, e, alt)
        np.save(alt, frames)
        return alt


def export_to_video_with_frames(
    frames: np.ndarray, path: str, fps: int = 8, frames_dir: Optional[str] = None
) -> str:
    """mp4 (:func:`export_to_video`) plus one PNG per frame in
    ``frames_dir`` (default ``<path stem>_frames``; ``frames.npy`` there
    without OpenCV)."""
    out = export_to_video(frames, path, fps)
    frames_dir = frames_dir or os.path.splitext(path)[0] + "_frames"
    os.makedirs(frames_dir, exist_ok=True)
    arr = _as_uint8(frames)
    try:
        import cv2
    except ImportError:
        np.save(os.path.join(frames_dir, "frames.npy"), arr)
        return out
    for i, frame in enumerate(arr):
        cv2.imwrite(os.path.join(frames_dir, f"frame_{i:04d}.png"), cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    return out


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png_rgb(path: str) -> np.ndarray:
    """An 8-bit non-interlaced RGB or RGBA PNG as uint8 ``[H, W, 3]`` (alpha
    dropped, as PIL's ``convert("RGB")`` does); any other file raises
    ``ValueError`` naming it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (without PIL only PNG images are read)")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = ihdr
    if depth != 8 or color not in (2, 6) or interlace or compression or filtering:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB/RGBA PNG is read without PIL; this one has "
                         f"bit depth {depth}, color type {color}, interlace {interlace}")
    bpp = 3 if color == 2 else 4
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {w}x{h} with {bpp} bytes a pixel")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:  # None
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum along the row, per channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs its reconstructed left neighbour
            filt, up, rec = line.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                left = rec[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], up[x - bpp] if x >= bpp else 0)
                rec[x] = (filt[x] + pred) & 0xFF
            cur = np.asarray(rec, np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has unknown PNG filter type {kind}")
        out[y] = prev = cur
    return out.reshape(h, w, bpp)[..., :3]


def load_image(path: str) -> np.ndarray:
    """An image file as RGB float32 ``[H, W, 3]`` in [-1, 1], at its own
    size (no resize, as the reference feeds it)."""
    try:
        from PIL import Image
    except ImportError:
        rgb = read_png_rgb(path)
    else:
        with Image.open(path) as img:
            rgb = np.asarray(img.convert("RGB"))
    return rgb.astype(np.float32) / 255.0 * 2.0 - 1.0


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB (inf for equal inputs)."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(max_val**2 / mse)
