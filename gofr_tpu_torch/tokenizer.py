"""Byte-level BPE tokenizer (a copy of ``gofr_tpu/tokenizer.py``): the
Python trainer, and the encoder of the serving path, native
(``gofr_tpu_torch/native/tokenizer.cpp``, built with ``g++`` at first
use into ``build/gofr_tpu_torch/``) where a library can be built, else a
Python encoder that gives the same ids. Token ids 0..255 are raw bytes;
each learned merge i yields id 256+i. Given a logger, a tokenizer logs
which encoder serves. Host code: no device kernel runs here.
"""

from __future__ import annotations

import ctypes
import json
from typing import Dict, Iterable, List, Optional, Tuple


class Tokenizer:
    def __init__(self, merges: Optional[List[Tuple[int, int]]] = None,
                 logger=None, native: bool = True):
        self.merges: List[Tuple[int, int]] = list(merges or [])
        self._ranks: Dict[Tuple[int, int], int] = {
            pair: i for i, pair in enumerate(self.merges)}
        self._native = None
        self._native_handle = None
        if native:
            self._init_native()
        if logger is not None:
            if self._native is not None:
                logger.info("tokenizer: native BPE encoder (%d merges)",
                            len(self.merges))
            else:
                from gofr_tpu_torch.native import build_error
                logger.info("tokenizer: Python BPE encoder (%d merges; "
                            "native library: %s)", len(self.merges),
                            build_error() if native else "not asked for")

    @property
    def encoder(self) -> str:
        """Which encoder serves: ``"native"`` or ``"python"``."""
        return "native" if self._native is not None else "python"

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    # -- native wiring ------------------------------------------------------
    def _init_native(self) -> None:
        from gofr_tpu_torch.native import load_tokenizer_lib
        lib = load_tokenizer_lib()
        if lib is None:
            return
        flat = (ctypes.c_int32 * (2 * len(self.merges)))()
        for i, (left, right) in enumerate(self.merges):
            flat[2 * i] = left
            flat[2 * i + 1] = right
        handle = lib.gofr_tok_new(flat, len(self.merges))
        if handle:
            self._native = lib
            self._native_handle = handle

    def __del__(self):
        if self._native is not None and self._native_handle:
            self._native.gofr_tok_free(self._native_handle)

    # -- train (offline; python) --------------------------------------------
    @classmethod
    def train(cls, corpus: Iterable[str], vocab_size: int) -> "Tokenizer":
        """Greedy BPE: repeatedly merge the most frequent adjacent pair."""
        if vocab_size < 256:
            raise ValueError("vocab_size must be >= 256 (byte base)")
        sequences = [list(text.encode()) for text in corpus]
        merges: List[Tuple[int, int]] = []
        while 256 + len(merges) < vocab_size:
            counts: Dict[Tuple[int, int], int] = {}
            for seq in sequences:
                for a, b in zip(seq, seq[1:]):
                    counts[(a, b)] = counts.get((a, b), 0) + 1
            if not counts:
                break
            best = max(counts, key=lambda p: (counts[p], -p[0], -p[1]))
            if counts[best] < 2:
                break
            new_id = 256 + len(merges)
            merges.append(best)
            for seq in sequences:
                i = 0
                while i < len(seq) - 1:
                    if seq[i] == best[0] and seq[i + 1] == best[1]:
                        seq[i] = new_id
                        del seq[i + 1]
                    else:
                        i += 1
        return cls(merges)

    # -- persist -------------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as handle:
            json.dump({"merges": self.merges}, handle)

    @classmethod
    def load(cls, path: str, logger=None) -> "Tokenizer":
        with open(path) as handle:
            data = json.load(handle)
        return cls([tuple(pair) for pair in data["merges"]], logger=logger)

    # -- encode/decode -------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        raw = text.encode()
        if self._native is not None:
            return self._encode_native(raw)
        return self._encode_python(raw)

    def _encode_native(self, raw: bytes) -> List[int]:
        cap = max(16, len(raw))
        buf = (ctypes.c_int32 * cap)()
        text_buf = (ctypes.c_uint8 * max(1, len(raw))).from_buffer_copy(
            raw or b"\x00")
        n = self._native.gofr_tok_encode(self._native_handle, text_buf,
                                         len(raw), buf, cap)
        if n < 0:
            return self._encode_python(raw)
        return list(buf[:n])

    def _encode_python(self, raw: bytes) -> List[int]:
        ids = list(raw)
        ranks = self._ranks
        while len(ids) >= 2:
            best_rank, best_pos = None, -1
            for i, pair in enumerate(zip(ids, ids[1:])):
                rank = ranks.get(pair)
                if rank is not None and (best_rank is None
                                         or rank < best_rank):
                    best_rank, best_pos = rank, i
            if best_rank is None:
                break
            ids[best_pos] = 256 + best_rank
            del ids[best_pos + 1]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        ids = list(ids)
        if self._native is not None:
            arr = (ctypes.c_int32 * max(1, len(ids)))(*ids)
            cap = 16 + 8 * len(ids) * max(1, len(self.merges).bit_length())
            out = (ctypes.c_uint8 * cap)()
            n = self._native.gofr_tok_decode(self._native_handle, arr,
                                             len(ids), out, cap)
            if n >= 0:
                return bytes(out[:n]).decode("utf-8", "replace")
        return self._decode_python(ids)

    def _decode_python(self, ids: List[int]) -> str:
        out = bytearray()

        def expand(token: int):
            if token < 256:
                out.append(token)
            else:
                left, right = self.merges[token - 256]
                expand(left)
                expand(right)

        for token in ids:
            expand(token)
        return out.decode("utf-8", "replace")
