"""Post-processing of decoded video (counterpart of the array helpers in
``s2v_tpu/utils/video.py``; the mp4 muxer is later work)."""

from __future__ import annotations

import numpy as np


def denormalize_video(video: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> [0, 1] float32."""
    return np.clip(np.asarray(video, dtype=np.float32) / 2.0 + 0.5, 0.0, 1.0)


def to_uint8_frames(video01: np.ndarray) -> np.ndarray:
    """[0, 1] float frames -> uint8."""
    return np.round(video01 * 255.0).astype(np.uint8)
