"""T5 tokenization with ``<cls>`` as a special token over a ``tokenizer.json``
(counterpart of ``s2v_tpu/utils/tokenizer.py``).

The reference tokenizes with the fast (Rust) HF T5 tokenizer, registers
``<cls>`` as an additional special token (id 32100, inside the checkpoint's
padded 32128-row embedding) and pads/truncates to 226 tokens.  Under
``truncation=True, add_special_tokens=True`` the fast pipeline truncates to
``max_length - 1``, keeping a slot for the EOS that its post-processor
appends, so an over-length prompt still ends in ``</s>``; ``encode``
reproduces that and logs the reference's truncation warning.  The
``tokenizers`` package is imported when a tokenizer is made.  Checkpoints
with only ``spiece.model`` go through ``s2v_torch.utils.sp_native``.
"""

from __future__ import annotations

import os
from typing import Sequence, Union

import numpy as np

from s2v_torch.utils.logging import get_logger


class T5CLSTokenizer:
    """Pads to max_length with pad id, appends EOS, knows ``<cls>``."""

    def __init__(self, tokenizer_json_path: str, cls_token: str = "<cls>"):
        from tokenizers import AddedToken, Tokenizer

        self._tok = Tokenizer.from_file(tokenizer_json_path)
        if self._tok.token_to_id(cls_token) is None:
            self._tok.add_special_tokens([AddedToken(cls_token, special=True)])
        self.cls_token = cls_token
        self.cls_id = self._tok.token_to_id(cls_token)
        self.eos_id = self._tok.token_to_id("</s>")
        self.pad_id = self._tok.token_to_id("<pad>")

    def __len__(self) -> int:
        return self._tok.get_vocab_size(with_added_tokens=True)

    @classmethod
    def from_checkpoint_dir(cls, model_dir: str, subfolder: str = "tokenizer"):
        path = os.path.join(model_dir, subfolder, "tokenizer.json")
        if not os.path.exists(path):
            path = os.path.join(model_dir, "tokenizer.json")
        return cls(path)

    def encode(self, prompts: Union[str, Sequence[str]], max_length: int = 226) -> np.ndarray:
        """``padding="max_length", truncation=True, add_special_tokens=True``
        (EOS appended, truncation keeps room for EOS) -> [B, max_length] int32."""
        if isinstance(prompts, str):
            prompts = [prompts]
        out = np.full((len(prompts), max_length), self.pad_id, np.int32)
        for i, p in enumerate(prompts):
            ids = self._tok.encode(p, add_special_tokens=False).ids
            if len(ids) > max_length - 1:
                get_logger("s2v_torch.tokenizer").warning(
                    "The following part of your input was truncated because "
                    "`max_sequence_length` is set to %d tokens: %s",
                    max_length, self._tok.decode(ids[max_length - 1:]),
                )
            ids = ids[: max_length - 1] + [self.eos_id]
            out[i, : len(ids)] = np.asarray(ids, np.int32)
        return out
