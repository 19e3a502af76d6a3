"""Byte-level tokenizer (port of ``repro.data.tokenizer``, for the runnable
examples: no external vocab)."""
from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    """Tokens = bytes + 3 specials. Vocab 259, stable and dependency-free."""

    PAD, BOS, EOS = 256, 257, 258
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.BOS] + ids
        if add_eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids) -> str:
        b = bytes(i for i in np.asarray(ids).tolist()
                  if 0 <= i < 256)
        return b.decode("utf-8", errors="replace")
