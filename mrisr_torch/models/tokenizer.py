"""Native CLIP byte-level BPE tokenizer (the port's copy of ``mrisr_tpu/models/tokenizer.py``).

Pure Python, so the port keeps its own copy and imports nothing of the JAX
package: byte-level BPE over a ``vocab.json``/``merges.txt`` pair (the files
every CLIP/SD checkpoint ships), lowercasing and whitespace cleanup, the
``</w>`` end-of-word marker, ``<|startoftext|>``/``<|endoftext|>`` specials,
and ``max_length`` padding with the EOS token (the SD1.5 convention).

The pre-tokenizer regex uses Python ``re`` unicode classes (``[^\\W\\d_]``
for letters); this matches CLIP's ``\\p{L}``/``\\p{N}`` for ASCII prompts.
"""
from __future__ import annotations

import functools
import html
import json
import re
from pathlib import Path

import numpy as np

_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPBPETokenizer:
    """Byte-level BPE with the CLIP ``</w>`` word-boundary convention."""

    model_max_length = 77
    bos_token = "<|startoftext|>"
    eos_token = "<|endoftext|>"

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token_id = self.encoder[self.bos_token]
        self.eos_token_id = self.encoder[self.eos_token]
        self.pad_token_id = self.eos_token_id  # SD1.5 pads with EOS
        self.vocab_size = len(self.encoder)
        self._cache: dict[str, list[str]] = {}

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_files(cls, vocab_json: str | Path, merges_txt: str | Path):
        vocab = json.loads(Path(vocab_json).read_text(encoding="utf-8"))
        lines = Path(merges_txt).read_text(encoding="utf-8").split("\n")
        # First line is the "#version:" header; trailing blanks are ignored.
        merges = [
            tuple(l.split()) for l in lines[1:] if l and not l.startswith("#")
        ]
        return cls(vocab, [m for m in merges if len(m) == 2])

    @classmethod
    def from_pretrained(cls, path: str | Path):
        """Load from a HF-style tokenizer directory (vocab.json + merges.txt)."""
        p = Path(path)
        return cls.from_files(p / "vocab.json", p / "merges.txt")

    # -- BPE core -----------------------------------------------------------
    def bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> list[int]:
        text = whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: list[int] = []
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok))
        return ids

    def __call__(
        self,
        texts,
        padding: str = "max_length",
        max_length: int | None = None,
        truncation: bool = True,
        **_,
    ) -> dict:
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        rows, masks = [], []
        for t in texts:
            ids = [self.bos_token_id] + self.tokenize(t) + [self.eos_token_id]
            if truncation and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos_token_id]
            mask = [1] * len(ids)
            if padding == "max_length":
                pad = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad
                mask = mask + [0] * pad
            rows.append(ids)
            masks.append(mask)
        return {
            "input_ids": np.asarray(rows, np.int32),
            "attention_mask": np.asarray(masks, np.int32),
        }

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        specials = {self.bos_token_id, self.eos_token_id}
        toks = [
            self.decoder[int(i)]
            for i in np.asarray(ids).reshape(-1)
            if not (skip_special_tokens and int(i) in specials)
        ]
        text = "".join(toks)
        data = bytes(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()


def build_mini_vocab(words: list[str]) -> tuple[dict[str, int], list[tuple[str, str]]]:
    """Construct a tiny but structurally faithful CLIP vocab/merges pair.

    Layout mirrors the real CLIP vocab: 256 byte tokens, 256 byte+``</w>``
    tokens, then one merged whole-word token per input word (with the merge
    chain that produces it), then the two specials.  Useful for hermetic
    tests and as the fallback tokenizer when no checkpoint files exist.
    """
    byte_chars = [bytes_to_unicode()[b] for b in range(256)]
    vocab: dict[str, int] = {}
    for c in byte_chars:
        vocab[c] = len(vocab)
    for c in byte_chars:
        vocab[c + "</w>"] = len(vocab)
    merges: list[tuple[str, str]] = []
    for w in words:
        w = w.lower()
        # merge right-to-left: (c0, c1..cn</w>)
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        while len(parts) > 1:
            a, b = parts[-2], parts[-1]
            if (a, b) not in merges:
                merges.append((a, b))
            merged = a + b
            if merged not in vocab:
                vocab[merged] = len(vocab)
            parts = parts[:-2] + [merged]
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges
