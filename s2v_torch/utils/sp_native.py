"""ctypes binding to the native sentencepiece unigram tokenizer
(``native/sp_tokenizer.cc``), built with ``g++`` into ``build/`` on first use
(counterpart of ``s2v_tpu/utils/sp_native.py``).

The native path applies no nmt_nfkc normalization.  A prompt that
normalization could change (any non-ASCII character, or ASCII that NFKC
rewrites) raises, as it does in the JAX package without a fallback
``tokenizer.json`` (the port has no ``tokenizer.json`` route yet).
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path
from typing import Iterable, List, Sequence, Tuple, Union

import numpy as np

from s2v_torch.utils import native_build

SOURCE = native_build.REPO_ROOT / "native" / "sp_tokenizer.cc"
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native_build.build_one(SOURCE)))
        lib.sp_load.restype = ctypes.c_void_p
        lib.sp_load.argtypes = [ctypes.c_char_p]
        lib.sp_vocab_size.restype = ctypes.c_int
        lib.sp_vocab_size.argtypes = [ctypes.c_void_p]
        lib.sp_piece_to_id.restype = ctypes.c_int
        lib.sp_piece_to_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.sp_encode.restype = ctypes.c_int
        lib.sp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.sp_free.restype = None
        lib.sp_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


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
    ``max_length``."""

    def __init__(self, spiece_model_path: Union[str, Path], cls_token: str = "<cls>"):
        self._lib = _library()
        self._h = self._lib.sp_load(str(spiece_model_path).encode())
        if not self._h:
            raise ValueError(f"failed to parse sentencepiece model: {spiece_model_path}")
        self.pad_id = 0
        self.eos_id = 1
        self.unk_id = 2
        self.cls_token = cls_token
        self.cls_id = self._lib.sp_vocab_size(self._h)

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
            raise ValueError(
                "the native tokenizer applies no nmt_nfkc normalization, so the ids of "
                f"{bad[0]!r} could differ from sentencepiece's; tokenize it with a "
                "tokenizer.json-backed tokenizer"
            )
        out = np.full((len(prompts), max_length), self.pad_id, np.int32)
        for i, p in enumerate(prompts):
            ids = self._encode_one(p)[: max_length - 1] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.sp_free(self._h)
            self._h = None

    def __del__(self):
        self.close()
