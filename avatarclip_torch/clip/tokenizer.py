"""CLIP text tokenizer (the port's own copy of
avatarclip_tpu/clipjax/tokenizer.py; the merges file is looked up through
the port's ``assets.find``).

Implements the byte-pair-encoding tokenizer used by OpenAI CLIP (the
reference calls ``clip.tokenize``, e.g. AvatarGen/AppearanceGen/main.py:275).
The real BPE requires the ``bpe_simple_vocab_16e6.txt.gz`` merges file; when it
is discoverable (``assets.find``) we run true BPE. In asset-free environments a
deterministic hashed fallback produces stable token ids with the same framing
(SOT ... EOT, context 77) so every pipeline stays runnable — embeddings from
random-init CLIP weights are meaningless anyway, and tests only require
determinism and shape correctness.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import html
import re

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT = 49406
EOT = 49407

def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _bytes_to_unicode():
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
    return dict(zip(bs, [chr(c) for c in cs]))


class BPETokenizer:
    """True CLIP BPE, built from the public merges file."""

    def __init__(self, merges_path: str):
        if merges_path.endswith(".gz"):
            merges = gzip.open(merges_path, "rt", encoding="utf-8").read().split("\n")
        else:
            merges = open(merges_path, encoding="utf-8").read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        self.byte_encoder = _bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE,
        )

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)

        def get_pairs(word):
            return set(zip(word[:-1], word[1:]))

        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: list[int] = []
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids


class HashedTokenizer:
    """Deterministic offline fallback: stable per-word hash ids."""

    def encode(self, text: str) -> list[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text)
        ids = []
        for w in words:
            h = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little")
            ids.append(1000 + h % (SOT - 2000))
        return ids


@functools.lru_cache(maxsize=1)
def default_tokenizer():
    from .. import assets

    path = assets.find("bpe_simple_vocab_16e6.txt.gz") or assets.find(
        "bpe_simple_vocab_16e6.txt"
    )
    if path:
        return BPETokenizer(path)
    return HashedTokenizer()


def tokenize(
    texts: str | list[str], context_length: int = CONTEXT_LENGTH
) -> np.ndarray:
    """Texts -> (N, 77) int32 with SOT/EOT framing (clip.tokenize contract)."""
    if isinstance(texts, str):
        texts = [texts]
    tok = default_tokenizer()
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        ids = [SOT] + tok.encode(t)[: context_length - 2] + [EOT]
        out[i, : len(ids)] = ids
    return out
