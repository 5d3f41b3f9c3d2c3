"""ctypes binding to the native H.264 mp4 muxer (``native/mp4_muxer.cc``,
libavformat + libavcodec + libswscale), built with ``g++`` into ``build/``
on first use (counterpart of ``s2v_tpu/utils/mp4_native.py``).  Where the
libav* headers or libraries are missing the build fails, and
``utils.video.export_to_video`` goes on to its next writer."""

from __future__ import annotations

import ctypes

import numpy as np

from s2v_torch.utils import native_build

SOURCE = native_build.REPO_ROOT / "native" / "mp4_muxer.cc"
LIB = native_build.Library(SOURCE, {
    "s2v_mp4_open": [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "s2v_mp4_write_frame": [ctypes.c_void_p, ctypes.c_char_p],
    "s2v_mp4_close": [ctypes.c_void_p],
    "s2v_mp4_last_error": [],
}, restype={"s2v_mp4_open": ctypes.c_void_p, "s2v_mp4_last_error": ctypes.c_char_p})


def is_available() -> bool:
    """Whether the muxer builds and loads here."""
    try:
        LIB.load()
    except (RuntimeError, OSError):
        return False
    return True


def write_mp4(frames: np.ndarray, path: str, fps: int = 8, crf: int = 23) -> str:
    """Encode uint8 RGB frames ``[T, H, W, 3]`` to an H.264 yuv420p mp4 at
    ``path``.  Odd sizes are edge-padded to even (yuv420p)."""
    lib = LIB.load()
    frames = np.ascontiguousarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected uint8 [T, H, W, 3], got {frames.dtype} {frames.shape}")
    _, h, w, _ = frames.shape
    if h % 2 or w % 2:
        frames = np.pad(frames, ((0, 0), (0, h % 2), (0, w % 2), (0, 0)), mode="edge")
        h, w = frames.shape[1:3]
    ctx = lib.s2v_mp4_open(path.encode(), w, h, int(fps), int(crf))
    if not ctx:
        raise RuntimeError(f"mp4 open failed: {lib.s2v_mp4_last_error().decode()}")
    try:
        for frame in frames:
            buf = np.ascontiguousarray(frame)
            if lib.s2v_mp4_write_frame(ctx, buf.ctypes.data_as(ctypes.c_char_p)) != 0:
                raise RuntimeError(f"mp4 write failed: {lib.s2v_mp4_last_error().decode()}")
    except Exception:
        lib.s2v_mp4_close(ctx)
        raise
    if lib.s2v_mp4_close(ctx) != 0:
        raise RuntimeError(f"mp4 close failed: {lib.s2v_mp4_last_error().decode()}")
    return path
