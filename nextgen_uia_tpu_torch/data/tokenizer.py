"""The CLIP byte-level BPE tokenizer (counterpart of
nextgen_uia_tpu/data/tokenizer.py::ClipTokenizer): the byte->unicode map,
greedy merge by rank over the bundled OpenAI vocabulary
(``assets/bpe_simple_vocab_16e6.txt.gz``, the same file as the JAX
package's), and ``clip.tokenize`` semantics: a 77-token context, SOT ... EOT,
zero padding, over-length captions truncated with EOT as the last token.

BiomedCLIP's PubMedBERT WordPiece tokenizer (``BertTokenizer``,
``load_hf_tokenizer``) is not ported: it comes with the BERT text tower.
"""

from __future__ import annotations

import functools
import gzip
import html
import pathlib
import re

import numpy as np

ASSETS = pathlib.Path(__file__).parent / "assets"


@functools.lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _basic_clean(text: str) -> str:
    # ftfy where installed; html-unescape + strip otherwise
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


try:  # unicode-property tokenisation pattern (standard CLIP BPE pattern)
    import regex as _re

    _CLIP_PATTERN = _re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _re.IGNORECASE)
except ImportError:  # pragma: no cover - ASCII classes where `regex` is missing
    _CLIP_PATTERN = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+",
        re.IGNORECASE)


class ClipTokenizer:
    PATTERN = _CLIP_PATTERN

    def __init__(self, bpe_path: str | None = None):
        path = pathlib.Path(bpe_path) if bpe_path else ASSETS / "bpe_simple_vocab_16e6.txt.gz"
        merges = gzip.open(path).read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        self.byte_encoder = _bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str):
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids = []
        for token in self.PATTERN.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts, context_length: int = 77) -> np.ndarray:
        """clip.tokenize semantics: [N, context] int32, SOT ... EOT, zero pad;
        over-length sequences truncated with EOT as last token."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out


def _bert_not_ported(*_args, **_kwargs):
    raise NotImplementedError(
        "The BERT WordPiece tokenizer is not ported to the PyTorch package yet "
        "(ROADMAP.md, section A, item 5: the BERT text tower)")


BertTokenizer = load_hf_tokenizer = _bert_not_ported
