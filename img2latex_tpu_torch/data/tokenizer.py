"""Whitespace LaTeX tokenizer with a frequency-ordered vocabulary.

A copy of ``img2latex_tpu/data/tokenizer.py`` (numpy and json only), so the
port reads the same vocabulary files and gives the same ids: special tokens
``<PAD> <START> <END> <UNK>`` pinned to ids 0..3, frequency-descending ids
for the rest, batch encode padded/truncated to ``max_sequence_length``.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

PAD, START, END, UNK = "<PAD>", "<START>", "<END>", "<UNK>"


class LaTeXTokenizer:
    """Tokenizer mapping LaTeX formula strings <-> token-id sequences."""

    def __init__(
        self,
        special_tokens: Optional[Dict[str, str]] = None,
        max_sequence_length: int = 150,
    ):
        self.special_tokens = special_tokens or {
            "PAD": PAD,
            "START": START,
            "END": END,
            "UNK": UNK,
        }
        self.max_sequence_length = int(max_sequence_length)
        self.token_to_id: Dict[str, int] = {}
        self.id_to_token: Dict[int, str] = {}
        self.vocab_size = 0
        self._init_special_tokens()

    # ------------------------------------------------------------------
    def _init_special_tokens(self) -> None:
        self.token_to_id = {}
        self.id_to_token = {}
        for idx, token in enumerate(self.special_tokens.values()):
            self.token_to_id[token] = idx
            self.id_to_token[idx] = token
        self.vocab_size = len(self.token_to_id)
        self.pad_token_id = self.token_to_id[self.special_tokens["PAD"]]
        self.start_token_id = self.token_to_id[self.special_tokens["START"]]
        self.end_token_id = self.token_to_id[self.special_tokens["END"]]
        self.unk_token_id = self.token_to_id[self.special_tokens["UNK"]]

    # ------------------------------------------------------------------
    def fit(self, texts: Iterable[str]) -> None:
        """Fit on formula strings; ids ordered by descending frequency
        (ties broken by first-seen order, matching ``Counter`` + stable sort
        semantics of the reference, ``tokenizer.py:80-117``)."""
        self._init_special_tokens()
        counter: Counter = Counter()
        for text in texts:
            counter.update(text.split())
        for token, _ in sorted(counter.items(), key=lambda kv: kv[1], reverse=True):
            if token not in self.token_to_id:
                self.token_to_id[token] = self.vocab_size
                self.id_to_token[self.vocab_size] = token
                self.vocab_size += 1

    def fit_on_formulas_file(self, file_path: str) -> None:
        """Fit on a formulas file, wrapping each line in START/END first
        (reference ``tokenizer.py:119-141``)."""
        if not os.path.exists(file_path):
            raise FileNotFoundError(f"Formulas file not found: {file_path}")
        with open(file_path, encoding="utf-8", errors="replace") as f:
            formulas = [line.strip() for line in f]
        s, e = self.special_tokens["START"], self.special_tokens["END"]
        self.fit(f"{s} {formula} {e}" for formula in formulas)

    # ------------------------------------------------------------------
    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        if add_special_tokens:
            text = f"{self.special_tokens['START']} {text} {self.special_tokens['END']}"
        return [self.token_to_id.get(tok, self.unk_token_id) for tok in text.split()]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        special_ids = (
            {self.token_to_id[t] for t in self.special_tokens.values()}
            if skip_special_tokens
            else set()
        )
        # Out-of-vocab ids map to UNK; when specials are skipped they must be
        # skipped too (a real UNK id would be), not emitted as literal <UNK>.
        return " ".join(
            self.id_to_token.get(int(i), self.special_tokens["UNK"])
            for i in ids
            if int(i) not in special_ids
            and not (skip_special_tokens and int(i) not in self.id_to_token)
        )

    def encode_batch(
        self,
        texts: Sequence[str],
        add_special_tokens: bool = False,
        padding: bool = True,
        truncation: bool = True,
        length: Optional[int] = None,
    ) -> np.ndarray:
        """Encode to a dense ``(B, L)`` int32 array, padded/truncated to a
        fixed length (default ``max_sequence_length``).

        ``truncation=False`` widens L to the longest sequence when needed;
        ``padding=False`` returns a list of ragged int32 arrays (a dense
        array is impossible without padding)."""
        L = self.max_sequence_length if length is None else int(length)
        encoded = [self.encode(t, add_special_tokens) for t in texts]
        if truncation:
            encoded = [ids[:L] for ids in encoded]
        elif encoded:
            L = max(L, max(len(ids) for ids in encoded))
        if not padding:
            return [np.asarray(ids, dtype=np.int32) for ids in encoded]
        out = np.full((len(encoded), L), self.pad_token_id, dtype=np.int32)
        for i, ids in enumerate(encoded):
            out[i, : len(ids)] = ids
        return out

    def decode_batch(self, batch_ids, skip_special_tokens: bool = True) -> List[str]:
        arr = np.asarray(batch_ids)
        return [self.decode(row, skip_special_tokens) for row in arr]

    def _decode_table(self):
        """(max_id, keep_mask, token_array) for the vectorized decode —
        rebuilt lazily whenever the vocab size changes (fit/load)."""
        cache = getattr(self, "_decode_cache", None)
        key = (len(self.token_to_id), id(self.token_to_id))
        if cache is not None and cache[0] == key:
            return cache[1:]
        max_id = max(self.id_to_token) if self.id_to_token else 0
        special_ids = {self.token_to_id[t] for t in self.special_tokens.values()}
        keep = np.zeros(max_id + 1, dtype=bool)
        tab = np.empty(max_id + 1, dtype=object)
        for i, t in self.id_to_token.items():
            keep[i] = i not in special_ids
            tab[i] = t
        self._decode_cache = (key, max_id, keep, tab)
        return max_id, keep, tab

    def decode_rows(self, rows: Sequence[Sequence[int]]) -> List[str]:
        """Batch ``decode(..., skip_special_tokens=True)`` via one cached
        numpy lookup table instead of per-token dict probes — the eval hot
        path's detokenizer (identical output to ``decode``, tested; ids
        outside the vocab are skipped exactly like specials)."""
        max_id, keep, tab = self._decode_table()
        out: List[str] = []
        for ids in rows:
            a = np.asarray(ids, dtype=np.int64).ravel()
            if a.size:
                a = a[(a >= 0) & (a <= max_id)]
                a = a[keep[a]]
                out.append(" ".join(tab[a]))
            else:
                out.append("")
        return out

    # ------------------------------------------------------------------
    def save(self, file_path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
        with open(file_path, "w", encoding="utf-8") as f:
            json.dump(self.to_config(), f, ensure_ascii=False)

    def to_config(self) -> Dict:
        """Serializable state; same fields as the reference's torch.save dict
        (``tokenizer.py:268-274``) so checkpoints embed it verbatim."""
        return {
            "token_to_id": self.token_to_id,
            "special_tokens": self.special_tokens,
            "max_sequence_length": self.max_sequence_length,
        }

    @classmethod
    def from_config(cls, cfg: Dict) -> "LaTeXTokenizer":
        tok = cls(
            special_tokens=dict(cfg["special_tokens"]),
            max_sequence_length=int(cfg["max_sequence_length"]),
        )
        tok.token_to_id = {str(k): int(v) for k, v in cfg["token_to_id"].items()}
        tok.vocab_size = len(tok.token_to_id)
        tok.id_to_token = {i: t for t, i in tok.token_to_id.items()}
        tok.pad_token_id = tok.token_to_id[tok.special_tokens["PAD"]]
        tok.start_token_id = tok.token_to_id[tok.special_tokens["START"]]
        tok.end_token_id = tok.token_to_id[tok.special_tokens["END"]]
        tok.unk_token_id = tok.token_to_id[tok.special_tokens["UNK"]]
        return tok

    @classmethod
    def load(cls, file_path: str) -> "LaTeXTokenizer":
        """Load JSON vocab; falls back to ``torch.load`` for vocabularies
        saved by the reference implementation."""
        if not os.path.exists(file_path):
            raise FileNotFoundError(f"Tokenizer file not found: {file_path}")
        try:
            with open(file_path, encoding="utf-8") as f:
                return cls.from_config(json.load(f))
        except (json.JSONDecodeError, UnicodeDecodeError):
            import torch

            cfg = torch.load(file_path, map_location="cpu", weights_only=False)
            return cls.from_config(cfg)

    # ------------------------------------------------------------------
    def default_init(self) -> None:
        """Minimal built-in vocabulary for tests (reference
        ``tokenizer.py:323-385``)."""
        self._init_special_tokens()
        common = (
            "+ - = ( ) [ ] { } \\frac \\sum \\int a b c x y z 0 1 2 3 4 5 6 7 8 9 "
            "\\alpha \\beta \\gamma \\delta \\theta \\pi \\sigma \\mathbf \\mathrm "
            "\\mathcal \\limits _ ^ \\infty"
        ).split()
        for token in common:
            if token not in self.token_to_id:
                self.token_to_id[token] = self.vocab_size
                self.id_to_token[self.vocab_size] = token
                self.vocab_size += 1
