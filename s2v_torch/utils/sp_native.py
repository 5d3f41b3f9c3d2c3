"""ctypes binding to the native sentencepiece unigram tokenizer
(``native/sp_tokenizer.cc``), built with ``g++`` into ``build/`` on first use
(counterpart of ``s2v_tpu/utils/sp_native.py``).

The native path applies no nmt_nfkc normalization.  A prompt that
normalization could change (any non-ASCII character, or ASCII that NFKC
rewrites) goes to ``s2v_torch.utils.tokenizer.T5CLSTokenizer`` on a
``tokenizer.json`` (by default the one next to the ``spiece.model``), as in
the JAX package; without such a file it raises.
"""

from __future__ import annotations

import ctypes
import os
import struct
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from s2v_torch.utils import native_build
from s2v_torch.utils.logging import get_logger

SOURCE = native_build.REPO_ROOT / "native" / "sp_tokenizer.cc"
LIB = native_build.Library(SOURCE, {
    "sp_load": [ctypes.c_char_p],
    "sp_vocab_size": [ctypes.c_void_p],
    "sp_piece_to_id": [ctypes.c_void_p, ctypes.c_char_p],
    "sp_encode": [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int],
    "sp_free": [ctypes.c_void_p],
}, restype={"sp_load": ctypes.c_void_p, "sp_free": None})


def _needs_nmt_nfkc(text: str) -> bool:
    """True when the native path (no normalization) could tokenize ``text``
    differently from sentencepiece's ``nmt_nfkc``: any non-ASCII character,
    or ASCII that NFKC would rewrite (the rule of ``s2v_tpu``'s guard)."""
    import unicodedata

    if any(ord(c) > 0x7F for c in text):
        return True
    return unicodedata.normalize("NFKC", text) != text


def _varint(n: int) -> bytes:
    out = b""
    while True:
        low = n & 0x7F
        n >>= 7
        if n:
            out += bytes([low | 0x80])
        else:
            return out + bytes([low])


def write_spiece_model(path: Union[str, Path], pieces: Iterable[Tuple[str, float, int]]) -> None:
    """Write a sentencepiece ModelProto holding ``pieces`` — (text, score,
    type) with type 1 normal, 2 unknown, 3 control — in raw wire format."""
    data = b""
    for text, score, ptype in pieces:
        raw = text.encode()
        body = b"\x0a" + _varint(len(raw)) + raw + b"\x15" + struct.pack("<f", score) + b"\x18" + _varint(ptype)
        data += b"\x0a" + _varint(len(body)) + body
    Path(path).write_bytes(data)


class NativeSPTokenizer:
    """T5-style tokenizer over a raw ``spiece.model``: unigram Viterbi in C++,
    ``<cls>`` as the first id past the vocab, EOS appended, padded to
    ``max_length``.  A prompt nmt_nfkc could change goes to
    ``T5CLSTokenizer`` on ``fallback_tokenizer_json`` (default: a
    ``tokenizer.json`` next to the ``spiece.model``, if there is one)."""

    def __init__(self, spiece_model_path: Union[str, Path], cls_token: str = "<cls>",
                 fallback_tokenizer_json: Optional[str] = None):
        self._lib = LIB.load()
        self._h = self._lib.sp_load(str(spiece_model_path).encode())
        if not self._h:
            raise ValueError(f"failed to parse sentencepiece model: {spiece_model_path}")
        self.pad_id = 0
        self.eos_id = 1
        self.unk_id = 2
        self.cls_token = cls_token
        self.cls_id = self._lib.sp_vocab_size(self._h)
        if fallback_tokenizer_json is None:
            candidate = os.path.join(os.path.dirname(os.path.abspath(spiece_model_path)), "tokenizer.json")
            fallback_tokenizer_json = candidate if os.path.exists(candidate) else None
        self._fallback_json = fallback_tokenizer_json
        self._fallback = None  # made on the first prompt that needs it

    def _fallback_tokenizer(self):
        if self._fallback is None and self._fallback_json:
            from s2v_torch.utils.tokenizer import T5CLSTokenizer

            self._fallback = T5CLSTokenizer(self._fallback_json, self.cls_token)
        return self._fallback

    def __len__(self) -> int:
        return self._lib.sp_vocab_size(self._h) + 1

    def piece_to_id(self, piece: str) -> int:
        if piece == self.cls_token:
            return self.cls_id
        return self._lib.sp_piece_to_id(self._h, piece.encode())

    def _encode_one(self, text: str, max_ids: int = 8192) -> List[int]:
        ids: List[int] = []
        buf = (ctypes.c_int * max_ids)()
        for i, part in enumerate(text.split(self.cls_token)):
            if i > 0:
                ids.append(self.cls_id)
            part = part.strip()
            if part:
                n = self._lib.sp_encode(self._h, part.encode(), buf, max_ids)
                ids.extend(buf[:n])
        return ids

    def encode(self, prompts: Union[str, Sequence[str]], max_length: int = 226) -> np.ndarray:
        """``[B, max_length]`` int32 ids; truncation keeps room for EOS."""
        if isinstance(prompts, str):
            prompts = [prompts]
        bad = [p for p in prompts if _needs_nmt_nfkc(p)]
        if bad:
            fallback = self._fallback_tokenizer()
            if fallback is not None:
                get_logger("s2v_torch.tokenizer").info(
                    "non-ASCII prompt: routing to the tokenizers backend (the native sentencepiece path skips "
                    "nmt_nfkc normalization)")
                return fallback.encode(prompts, max_length)
            raise ValueError(
                "the native tokenizer applies no nmt_nfkc normalization, so the ids of "
                f"{bad[0]!r} could differ from sentencepiece's; put a tokenizer.json next to the "
                "spiece.model (used automatically) or tokenize with s2v_torch.utils.tokenizer.T5CLSTokenizer"
            )
        out = np.full((len(prompts), max_length), self.pad_id, np.int32)
        for i, p in enumerate(prompts):
            ids = self._encode_one(p)
            if len(ids) > max_length - 1:
                # the native library has no detokenizer: the warning gives the span's size
                get_logger("s2v_torch.tokenizer").warning(
                    "Input truncated because `max_sequence_length` is set to %d tokens: %d trailing tokens removed",
                    max_length, len(ids) - (max_length - 1))
            ids = ids[: max_length - 1] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.sp_free(self._h)
            self._h = None

    def __del__(self):
        self.close()
