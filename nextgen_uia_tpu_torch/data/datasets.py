"""File-list datasets following the reference's on-disk conventions
(the port's own copy of nextgen_uia_tpu/data/datasets.py: numpy and PIL,
plus the native batch loader of native/loader.cc when it loads).

Layout (README.md:60-96 and src/datasets/*):
  <root>/classification/<dataset>/{train,val,test}.txt   one image name per line
  <root>/classification/<dataset>/labels.csv             "<name>,<int label>"
  <root>/all/images/<name>                               grayscale images
  <root>/all/masks/<name>                                binary masks (seg)

Host side loads+resizes images to uint8 numpy once (optionally cached). Few-shot sampling reproduces
src/datasets/fewshot_classification.py:86-131 (k-shot per class, stratified
ratio, random ratio). The contrastive finetune dataset reproduces
src/datasets/finetune.py: CSV concat, caption regex cleaning, len>20 filter,
existence check, seeded 90/10 split, bicubic resize + center crop.
"""

from __future__ import annotations

import csv
import os
import re
from collections import defaultdict
from pathlib import Path

import numpy as np
from PIL import Image


def read_split(root: str, dataset: str, split: str):
    p = Path(root) / "classification" / dataset / f"{split}.txt"
    return p.read_text().splitlines()


def read_labels(root: str, dataset: str):
    p = Path(root) / "classification" / dataset / "labels.csv"
    with open(p) as f:
        return {str(row[0]): int(row[1]) for row in csv.reader(f) if row}


def _use_native() -> bool:
    # default ON: the input-pipeline bench (PERF.md "Epoch-level input
    # pipeline") measured the C++ loader at 409-629 img/s/core vs PIL's
    # 247-586 and e2e 37.4 vs 35.2 img/s; NEXTGEN_UIA_NATIVE_LOADER=0 opts
    # out (e.g. for byte-exact PIL decode comparisons)
    return os.environ.get("NEXTGEN_UIA_NATIVE_LOADER", "1") == "1"


def load_image(path: str, img_size: int) -> np.ndarray:
    """Grayscale load + PIL-default (bicubic) resize to [img_size, img_size],
    uint8 (classification.py:176-181). By default the C++ loader
    (native/loader.cc) decodes when built — PIL-equivalent within +-3 gray
    levels (float vs PIL's fixed-point filter arithmetic; parity test
    tests/test_native_loader.py), much faster on multi-core hosts;
    NEXTGEN_UIA_NATIVE_LOADER=0 forces PIL."""
    return decode_image(path, img_size)[0]


def decode_image(path: str, img_size: int) -> tuple[np.ndarray, str]:
    """``load_image`` and the decoder that decoded the file: "native" (the
    C++ loader, when it is on and built) or "PIL" (otherwise, or where the
    C++ loader fails on the file)."""
    if _use_native():
        from . import native_loader

        if native_loader.available():
            batch, status = native_loader.decode_batch([path], img_size, gray=True)
            if status[0]:
                return batch[0, :, :, 0], "native"
    img = Image.open(path).convert("L")
    if img.size != (img_size, img_size):
        img = img.resize((img_size, img_size))
    return np.asarray(img, dtype=np.uint8), "PIL"


def load_mask(path: str, img_size: int) -> np.ndarray:
    """Binary mask: PIL convert('1') semantics = threshold at 128 after L
    (segmentation.py:176)."""
    img = Image.open(path).convert("L")
    if img.size != (img_size, img_size):
        img = img.resize((img_size, img_size))
    return (np.asarray(img, dtype=np.uint8) >= 128).astype(np.uint8)


class USDataset:
    """Classification / segmentation dataset over the file-list conventions.

    Items: dict(image [H,W] u8, label int | mask [H,W] u8, name str).
    """

    def __init__(self, root: str, dataset: str, names, img_size: int,
                 task: str = "cls", cache: bool = True):
        self.root = Path(root)
        self.names = list(names)
        self.img_size = img_size
        self.task = task
        self.labels = read_labels(root, dataset) if task == "cls" else None
        self._cache = {} if cache else None

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx: int):
        name = self.names[idx]
        if self._cache is not None and name in self._cache:
            return self._cache[name]
        image = load_image(str(self.root / "all" / "images" / name), self.img_size)
        if self.task == "cls":
            item = {"image": image, "label": self.labels[name], "name": name}
        else:
            mask = load_mask(str(self.root / "all" / "masks" / name), self.img_size)
            item = {"image": image, "mask": mask, "name": name}
        if self._cache is not None:
            self._cache[name] = item
        return item


def make_datasets(root: str, dataset: str, img_size: int, task: str = "cls",
                  zero_shot: bool = False, cache: bool = True):
    """Standard 3-way split; zero-shot mode evaluates on train+val+test
    (zero_shot.py:46-51). ``cache=False`` (--no-cache_images) disables the
    decoded-image RAM cache for corpora too large to hold resident."""
    splits = {s: read_split(root, dataset, s) for s in ("train", "val", "test")}
    if zero_shot:
        union = splits["train"] + splits["val"] + splits["test"]
        return {"test": USDataset(root, dataset, union, img_size, task,
                                  cache=cache)}
    return {s: USDataset(root, dataset, names, img_size, task, cache=cache)
            for s, names in splits.items()}


# ---------------------------------------------------------------------------
# Few-shot sampling (fewshot_classification.py:86-131)
# ---------------------------------------------------------------------------


def sample_few_shot(names, labels, *, rng: np.random.Generator,
                    shots_per_class: int | None = None,
                    train_ratio: float | None = None, stratified: bool = True):
    if shots_per_class is not None:
        by_class = defaultdict(list)
        for n in names:
            by_class[labels.get(n, 0) if labels else 0].append(n)
        sampled = []
        for _, imgs in by_class.items():
            k = min(shots_per_class, len(imgs))
            sampled.extend(rng.choice(imgs, size=k, replace=False).tolist())
    elif train_ratio is not None:
        if stratified and labels:
            by_class = defaultdict(list)
            for n in names:
                by_class[labels.get(n, 0)].append(n)
            sampled = []
            for _, imgs in by_class.items():
                k = max(1, int(len(imgs) * train_ratio))
                sampled.extend(rng.choice(imgs, size=k, replace=False).tolist())
        else:
            k = max(1, int(len(names) * train_ratio))
            sampled = rng.choice(names, size=k, replace=False).tolist()
    else:
        return list(names)
    rng.shuffle(sampled)
    return sampled


# ---------------------------------------------------------------------------
# Contrastive finetune dataset (finetune.py)
# ---------------------------------------------------------------------------

_CLEAN = re.compile(
    r"[^A-Za-z0-9\s\.,;:\(\)\[\]\{\}\/_\-+\*=<>@&\|\\\^'\"`~\$?#!…±°"
    r"µμ≤≥≈→–—•]")


def clean_caption(text: str) -> str:
    return _CLEAN.sub("", str(text)).strip()


class FinetuneDataset:
    """Image-caption pairs from one or more CSVs (MedPix + PMC-CURD layout)."""

    def __init__(self, rows, img_size: int):
        self.rows = rows  # list of (image_path, caption)
        self.img_size = img_size

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int):
        path, caption = self.rows[idx]
        img = Image.open(path).convert("RGB")
        img = _resize_center_crop(img, self.img_size)
        return {"image": np.asarray(img, dtype=np.uint8), "caption": caption}


def _resize_center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    short = min(w, h)
    nw, nh = round(w * size / short), round(h * size / short)
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    return img.crop((left, top, left + size, top + size))


def load_finetune_rows(csv_paths, img_dirs, *, caption_key="Caption",
                       img_key="filename", seed: int = 1, min_len: int = 20):
    """Build (train_rows, val_rows): concat CSVs, clean captions, drop short
    ones, resolve + existence-check image paths, seeded shuffle, 90/10 split
    (finetune.py:81-117)."""
    import pandas as pd

    dfs = [pd.read_csv(p) for p in csv_paths]
    df = pd.concat(dfs)
    df[caption_key] = df[caption_key].map(clean_caption)
    df = df[df[caption_key].str.len() > min_len]

    rows = []
    for _, r in df.iterrows():
        base = os.path.basename(str(r[img_key]))
        for d in img_dirs:
            cand = os.path.join(d, base)
            if os.path.exists(cand):
                rows.append((cand, r[caption_key]))
                break

    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(rows))
    rows = [rows[i] for i in idx]
    split = int(len(rows) * 0.9)
    return rows[:split], rows[split:]
