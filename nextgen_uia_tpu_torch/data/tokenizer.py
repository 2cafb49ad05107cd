"""The CLIP byte-level BPE tokenizer (counterpart of
nextgen_uia_tpu/data/tokenizer.py::ClipTokenizer): the byte->unicode map,
greedy merge by rank over the bundled OpenAI vocabulary
(``assets/bpe_simple_vocab_16e6.txt.gz``, the same file as the JAX
package's), and ``clip.tokenize`` semantics: a 77-token context, SOT ... EOT,
zero padding, over-length captions truncated with EOT as the last token.

BiomedCLIP's PubMedBERT tokenizer: ``BertTokenizer`` (WordPiece over a
vocab.txt, lowercased, [CLS] ... [SEP], [PAD] padding, context 256) and
``load_hf_tokenizer``, which wraps a HuggingFace tokenizer only when its
files are already cached locally (nothing is downloaded) and returns None
otherwise.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
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


# ---------------------------------------------------------------------------
# BERT WordPiece
# ---------------------------------------------------------------------------

_PUNCT = re.compile(r"([^\w\s]|_)")


class BertTokenizer:
    def __init__(self, vocab, *, context_length: int = 256, lowercase: bool = True):
        """vocab: dict token -> id, list of tokens, or path to vocab.txt."""
        if isinstance(vocab, (str, pathlib.Path)):
            tokens = pathlib.Path(vocab).read_text().splitlines()
            vocab = {t: i for i, t in enumerate(tokens)}
        elif isinstance(vocab, (list, tuple)):
            vocab = {t: i for i, t in enumerate(vocab)}
        self.vocab = vocab
        self.context_length = context_length
        self.lowercase = lowercase
        self.cls = vocab["[CLS]"]
        self.sep = vocab["[SEP]"]
        self.pad = vocab.get("[PAD]", 0)
        self.unk = vocab.get("[UNK]", 1)

    def _wordpiece(self, word: str):
        """Greedy longest-match-first pieces ('##' marks a continuation);
        [UNK] for the whole word when a piece is missing."""
        if word in self.vocab:
            return [self.vocab[word]]
        ids, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str):
        if self.lowercase:
            text = text.lower()
        text = _PUNCT.sub(r" \1 ", text)
        return [i for word in text.split() for i in self._wordpiece(word)]

    def __call__(self, texts, context_length: int | None = None) -> np.ndarray:
        """[N, context] int32: [CLS] ids [SEP], truncated to fit, [PAD] after."""
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        out = np.full((len(texts), ctx), self.pad, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.cls] + self.encode(text)[: ctx - 2] + [self.sep]
            out[i, : len(ids)] = ids
        return out


def _hf_files_present(name_or_path: str) -> bool:
    """A local tokenizer directory, or the model's folder in the HuggingFace
    hub cache: checked before importing ``transformers``, which is slow."""
    if os.path.isdir(name_or_path):
        return True
    hf_home = os.environ.get("HF_HOME", os.path.join(os.path.expanduser("~"), ".cache",
                                                     "huggingface"))
    cache = os.environ.get("HF_HUB_CACHE", os.path.join(hf_home, "hub"))
    return os.path.isdir(os.path.join(cache, "models--" + name_or_path.replace("/", "--")))


def load_hf_tokenizer(name_or_path: str, context_length: int = 256):
    """A HuggingFace tokenizer as a ``(texts, ctx) -> [N, ctx] int32``
    callable when ``transformers`` and the tokenizer's files are available
    locally (``local_files_only``: nothing is fetched); None otherwise, so
    that callers can fall back."""
    if not _hf_files_present(name_or_path):
        return None
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)
    except Exception:
        return None

    def call(texts, ctx=context_length):
        if isinstance(texts, str):
            texts = [texts]
        enc = tok(texts, padding="max_length", truncation=True, max_length=ctx,
                  return_tensors="np")
        return enc["input_ids"].astype(np.int32)

    return call
