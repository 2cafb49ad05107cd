"""Experiment scaffolding (the port's counterpart of
nextgen_uia_tpu/core/experiment.py): parameter summaries, ``results.csv``
and the timestamped ``{time}_{metric}={value}`` backup folder, and an
optional TensorBoard writer. Logging setup lives in tasks/common.py.
"""

from __future__ import annotations

import csv
import datetime
import math
import os
import shutil

from .partition import path_str


def format_params(num: int) -> str:
    if num >= 1e6:
        return f"{num / 1e6:.1f} M"
    if num >= 1e3:
        return f"{num / 1e3:.1f} K"
    return str(num)


def model_summary(named_modules: dict, trainable_pred=None) -> str:
    """Parameter table over {name: module}; trainable_pred(path) marks rows."""
    lines = [f"\n{'=' * 60}"]
    total = trainable = 0
    for name, module in named_modules.items():
        params = [(path_str(k), p) for k, p in module.named_parameters()]
        n = sum(p.numel() for _, p in params)
        t = (sum(p.numel() for k, p in params if trainable_pred(k))
             if trainable_pred is not None else 0)
        total += n
        trainable += t
        lines.append(f"{name:<24} total={format_params(n):>10}  trainable={format_params(t):>10}")
    lines.append(f"{'-' * 60}")
    pct = 100.0 * trainable / total if total else 0.0
    lines.append(f"{'ALL':<24} total={format_params(total):>10}  "
                 f"trainable={format_params(trainable):>10} ({pct:.2f}%)")
    lines.append("=" * 60)
    return "\n".join(lines)


def save_results_csv(stats: dict, path: str, *, scale100=("acc", "rec", "pre", "f1", "auc")):
    """results.csv in the reference's Metric/Mean format, written as the JAX
    package's pandas call writes it (``float_format="%.2f"``, NaN as an empty
    field, no index), with the csv module."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rows = []
    for k, v in stats.items():
        if k == "loss":
            continue
        val = float(v * 100 if k in scale100 else v)
        rows.append((k.capitalize(), "" if math.isnan(val) else f"{val:.2f}"))
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["Metric", "Mean"])
        w.writerows(rows)
    return rows


def backup_folder(base_path: str, metric_name: str, metric_value: float) -> str:
    """Timestamped archive folder ``{time}_{metric}={value:.2f}``."""
    ts = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    folder = os.path.join(base_path, f"{ts}_{metric_name}={metric_value:.2f}")
    os.makedirs(folder, exist_ok=True)
    return folder


def archive_log(log_path: str, dest_folder: str):
    src = os.path.join(log_path, "log.log")
    if os.path.exists(src):
        shutil.move(src, os.path.join(dest_folder, "log.log"))


class TBWriter:
    """Thin TensorBoard writer; no-ops when tensorboard is not installed."""

    def __init__(self, logdir: str | None):
        if logdir is None:  # a process that writes no log
            self._w = None
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._w = None
        else:
            self._w = SummaryWriter(logdir)

    @property
    def enabled(self) -> bool:
        """False when tensorboard is unavailable, so callers can skip
        building image grids and figures."""
        return self._w is not None

    def scalar(self, tag: str, value: float, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, value, step)

    def images(self, tag: str, batch_nchw, step: int):
        if self._w is not None:
            self._w.add_images(tag, batch_nchw, step)

    def figure(self, tag: str, fig, step: int):
        if self._w is not None:
            self._w.add_figure(tag, fig, step)

    def close(self):
        if self._w is not None:
            self._w.close()

