"""CLIP byte-pair-encoding tokenizer (pure Python, torch-free).

Parity surface: reference ``clip/simple_tokenizer.py`` (SimpleTokenizer,
:62-132) and ``clip/clip.py`` ``tokenize`` (:197-237): lowercased, whitespace-
normalized text is regex-split into words, each word is byte-mapped into the
GPT-2 printable-unicode alphabet and greedily merged by BPE rank; sequences are
wrapped in <|startoftext|> / <|endoftext|> and zero-padded to a 77-token
context.  Vocabulary = 256 byte symbols + 256 end-of-word variants + 48,894
merges + 2 specials = 49,408 ids.

The rebuild differs from the reference in structure, not behavior:

- ``ftfy`` is optional (the stock prompt templates are pure ASCII, for which
  ``ftfy.fix_text`` is the identity); when absent we fall back to NFC
  normalization.
- The merges blob (OpenAI's public ``bpe_simple_vocab_16e6.txt.gz``) is not
  vendored; it is resolved from ``CLIP_BPE_PATH`` or a list of well-known
  locations (see ``_find_bpe_vocab``).
- Batch tokenization returns an ``int32 numpy [N, 77]`` array ready to feed
  the text encoder (no per-string tensor writes).

This is the PyTorch port's own copy of ``debiasing_multi_modal_tpu``'s
tokenizer: the port imports nothing of the JAX package, and the two must
tokenize identically (pinned in tests/test_torch_extract.py).
"""

from __future__ import annotations

import gzip
import html
import os
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

try:  # pragma: no cover - exercised only when regex is installed
    import regex as _re

    _HAS_REGEX = True
except ImportError:  # pragma: no cover
    import re as _re  # type: ignore[no-redef]

    _HAS_REGEX = False

try:  # pragma: no cover
    import ftfy

    _HAS_FTFY = True
except ImportError:  # pragma: no cover
    _HAS_FTFY = False

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT_TOKEN = 49406  # <|startoftext|>
EOT_TOKEN = 49407  # <|endoftext|>

# Word-splitting pattern of the CLIP tokenizer (clip/simple_tokenizer.py:78).
# With the `regex` module we can use unicode property classes; the stdlib
# fallback approximates \p{L}/\p{N} with str.isalpha/isdigit-compatible classes
# good enough for ASCII prompt text.
_PAT_UNICODE = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
    r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
)
_PAT_ASCII = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
    r"""|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+"""
)

_VOCAB_ENV_VAR = "CLIP_BPE_PATH"
_VOCAB_FILENAME = "bpe_simple_vocab_16e6.txt.gz"
_VOCAB_SEARCH_PATHS = (
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", _VOCAB_FILENAME),
    os.path.join(os.path.expanduser("~/.cache/clip"), _VOCAB_FILENAME),
)


def _find_bpe_vocab(path: Optional[str] = None) -> str:
    if path:
        # An explicit path is a hard requirement, not a search hint.
        if os.path.isfile(path):
            return path
        raise FileNotFoundError(f"BPE merges file not found: {path!r}")
    candidates = []
    env = os.environ.get(_VOCAB_ENV_VAR)
    if env:
        candidates.append(env)
    candidates.extend(_VOCAB_SEARCH_PATHS)
    for cand in candidates:
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(
        f"CLIP BPE merges file {_VOCAB_FILENAME!r} not found. Set "
        f"${_VOCAB_ENV_VAR} or place it in one of: {list(candidates)}. "
        "It is OpenAI's public vocabulary blob, shipped with any CLIP "
        "distribution."
    )


@lru_cache()
def _byte_alphabet() -> Dict[int, str]:
    """GPT-2 reversible byte -> printable-unicode mapping.

    Printable bytes map to themselves; the remaining bytes are assigned
    codepoints 256, 257, ... in ascending byte order.  This is the standard
    byte-level-BPE alphabet (reference clip/simple_tokenizer.py:16-35).
    """
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping: Dict[int, str] = {b: chr(b) for b in printable}
    next_cp = 256
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(next_cp)
            next_cp += 1
    return mapping


def _clean_text(text: str) -> str:
    """ftfy mojibake repair (when available) + double HTML-unescape + strip,
    then whitespace collapse and lowercasing (simple_tokenizer.py:50-59,123).
    """
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    else:
        text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    text = " ".join(text.split())
    return text.strip().lower()


class ClipTokenizer:
    """CLIP BPE tokenizer producing numpy token-id batches.

    >>> tok = ClipTokenizer()
    >>> ids = tok("a photo of a landbird.")   # (1, 77) int32
    """

    def __init__(self, bpe_path: Optional[str] = None):
        self.bpe_path = _find_bpe_vocab(bpe_path)
        alphabet = _byte_alphabet()
        self._byte_to_sym = [alphabet[b] for b in range(256)]
        self._sym_to_byte = {s: b for b, s in alphabet.items()}

        with gzip.open(self.bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # First line is a version header; the CLIP vocab uses the first
        # 48,894 merge rules (= 49,152 - 256 - 2 slots in the original table).
        n_merges = 49152 - 256 - 2
        merge_lines = lines[1 : n_merges + 1]
        merges: List[Tuple[str, str]] = []
        for line in merge_lines:
            parts = line.split()
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        self.merge_rank: Dict[Tuple[str, str], int] = {
            pair: rank for rank, pair in enumerate(merges)
        }

        # id table: 256 byte symbols, their </w> variants, merged tokens,
        # specials — in the canonical table order (printable byte ranges
        # first, then remapped bytes; see _vocab_symbol_order).
        ordered_syms = _vocab_symbol_order()
        vocab: List[str] = list(ordered_syms)
        vocab += [s + "</w>" for s in ordered_syms]
        vocab += ["".join(pair) for pair in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.token_to_id: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.id_to_token: Dict[int, str] = {i: tok for tok, i in self.token_to_id.items()}
        assert len(vocab) == VOCAB_SIZE, len(vocab)
        assert self.token_to_id["<|startoftext|>"] == SOT_TOKEN
        assert self.token_to_id["<|endoftext|>"] == EOT_TOKEN

        self._word_cache: Dict[str, List[str]] = {}
        self._pattern = _re.compile(
            _PAT_UNICODE if _HAS_REGEX else _PAT_ASCII,
            _re.IGNORECASE,
        )

    # ------------------------------------------------------------------ BPE --
    def _bpe_word(self, token: str) -> List[str]:
        """Greedy lowest-rank merge loop over one regex word."""
        cached = self._word_cache.get(token)
        if cached is not None:
            return cached

        word: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            ranks = [
                self.merge_rank.get((word[i], word[i + 1]))
                for i in range(len(word) - 1)
            ]
            best_i, best_rank = -1, None
            for i, r in enumerate(ranks):
                if r is not None and (best_rank is None or r < best_rank):
                    best_i, best_rank = i, r
            if best_rank is None:
                break
            # merge *all* occurrences of this pair left-to-right
            first, second = word[best_i], word[best_i + 1]
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._word_cache[token] = word
        return word

    # -------------------------------------------------------------- encoding --
    def encode(self, text: str) -> List[int]:
        """Text -> list of BPE ids (no SOT/EOT, no padding)."""
        text = _clean_text(text)
        ids: List[int] = []
        for match in self._pattern.findall(text):
            if match in ("<|startoftext|>", "<|endoftext|>"):
                # the reference pre-seeds its BPE cache with the specials
                # (simple_tokenizer.py:69-70), so a LITERAL special token in
                # input text maps to its single id, not byte-BPE fragments
                ids.append(self.token_to_id[match])
                continue
            mapped = "".join(self._byte_to_sym[b] for b in match.encode("utf-8"))
            for piece in self._bpe_word(mapped):
                ids.append(self.token_to_id[piece])
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.id_to_token[int(i)] for i in ids)
        raw = bytearray(
            self._sym_to_byte[c] for c in text if c in self._sym_to_byte
        )
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(
        self,
        texts: Union[str, Sequence[str]],
        context_length: int = CONTEXT_LENGTH,
        truncate: bool = False,
    ) -> np.ndarray:
        """Batch tokenize to a zero-padded int32 [N, context_length] array.

        SOT/EOT wrapping and padding follow reference clip/clip.py:197-237.
        """
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [SOT_TOKEN] + self.encode(text) + [EOT_TOKEN]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(
                        f"input {text!r} is too long for context length "
                        f"{context_length}"
                    )
                ids = ids[:context_length]
                ids[-1] = EOT_TOKEN
            out[row, : len(ids)] = ids
        return out


def _vocab_symbol_order() -> List[str]:
    """Byte symbols in the canonical table order: the three printable ranges
    first (identity-mapped), then the remapped bytes in ascending byte value.
    """
    alphabet = _byte_alphabet()
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    rest = [b for b in range(256) if b not in set(printable)]
    return [alphabet[b] for b in printable + rest]


@lru_cache()
def default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = False,
) -> np.ndarray:
    """Module-level convenience mirroring ``clip.tokenize``."""
    return default_tokenizer()(texts, context_length=context_length, truncate=truncate)
