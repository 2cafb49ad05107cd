"""The BiomedCLIP fine-tune CLI of both packages on one dataset, on the CPU
in float32: ``nextgen_uia_tpu.tasks.biomedclip.finetune`` against
``nextgen_uia_tpu_torch.tasks.biomedclip.finetune``, the same argv
(``--debug_tiny``, 32 px, batch 8 in 2 microbatches, one epoch) and the
same starting weights, for MONA with cached text (the default), MONA with
the text in the step (``--no-cache_text_features``) and LoRA
(``--lora_dropout 0``).

The starting weights are the JAX CLI's own init, its adapters given
nonzero values (MONA's gamma, LoRA's b) so that they shape the loss,
written as one flat ``.npz`` and handed to both CLIs through
``--backbone_ckpt`` and ``--mona_weights``/``--lora_weights``; each log
says every tensor of its tree came from that file.

MONA's rate-0.1 dropout has no CLI flag and draws from each package's own
generator (JAX's keys, torch's ``Generator``), so this test replaces it with
the identity in both packages (``monkeypatch`` of ``adapters/mona.py``'s
``dropout``) for the whole run; no file of either package changes for it.

Held: ``best_val_loss`` |d| <= 2.1e-5 (KERNELPARITY_r05's bar), and every
element of ``best_model.npz`` within 1e-4 * its tensor's max|ref| (PERF.md
section 2's AdamW bound) or, where it is larger, within the JAX package's
own gap at that element between its cached-text and in-step-text runs. The
two routes compute the same function, so that gap measures how far float32
fixes the element at all: AdamW's step lr * m / (sqrt(v) + eps) on an
element whose gradients sum to about eps turns their rounding into a move
of up to lr (ROADMAP C7). The LoRA case has no such twin and is held to
the bar alone. Each CLI runs once for the file, shared by the cases.
"""

import re

import jax
import numpy as np
import pytest

from nextgen_uia_tpu.adapters import lora as jax_lora
from nextgen_uia_tpu.adapters import mona as jax_mona
from nextgen_uia_tpu.core import checkpoint as jax_ckpt
from nextgen_uia_tpu.core.partition import flatten_with_paths as jax_flatten
from nextgen_uia_tpu.models import clip as jax_clip
from nextgen_uia_tpu.tasks import clip_finetune as jax_ft
from nextgen_uia_tpu.tasks import common as jax_common
from nextgen_uia_tpu.tasks.biomedclip import finetune as jax_cli
from nextgen_uia_tpu_torch.adapters import mona as torch_mona
from nextgen_uia_tpu_torch.core import checkpoint as ckpt
from nextgen_uia_tpu_torch.tasks.biomedclip import finetune as torch_cli
from synth_data import make_finetune_csv

LR = 1e-4  # the CLIs' default --lr, pinned in the argv
# JAX's init and injection, compiled once for the file (eager they take
# ~15 s a case on the CPU); the values are JAX's own
JIT_INIT = jax.jit(jax_clip.clip_init, static_argnums=1)
JIT_INJECT = {"mona": jax.jit(jax_mona.inject_mona,
                              static_argnames=("dim", "bottleneck", "variant", "num_layers")),
              "lora": jax.jit(jax_lora.inject_lora,
                              static_argnames=("dim", "r", "targets", "num_layers"))}
CASES = {"mona_cached": ["--method", "mona"],
         "mona_in_step": ["--method", "mona", "--no-cache_text_features"],
         "lora": ["--method", "lora", "--lora_dropout", "0"]}
# the case whose reference computes the same function by the other route
TWIN = {"mona_cached": "mona_in_step", "mona_in_step": "mona_cached"}
_RUNS = {}


def _starting_weights(argv, method, path):
    """The JAX CLI's init (its parser, ``build_clip_model``) with the adapter
    tensors that start at or near zero set to seeded values, saved flat."""
    args = jax_ft._finetune_parser("biomedclip").parse_args(argv)
    jax_common.apply_compat_flags(args)
    _, params = jax_common.build_clip_model(args, "biomedclip", adapter=method,
                                            rng=jax.random.key(args.seed))
    flat = {p: np.array(v) for p, v in jax_flatten(params)}
    rng = np.random.default_rng(4)
    for p in flat:
        if p.endswith("/mona/gamma"):
            flat[p] = (0.5 * rng.standard_normal(flat[p].shape)).astype(np.float32)
        elif "/lora/" in p and p.endswith("/b"):
            flat[p] = (0.05 * rng.standard_normal(flat[p].shape)).astype(np.float32)
    np.savez(path, **flat)
    return flat


def _loaded(log_path, what):
    text = open(log_path).read()
    return [int(n) for n in re.findall(rf"Loaded (\d+) {what} tensors from", text)]


def _run(tmp_path_factory, case, package):
    """``package``'s CLI ("jax" or "port") on ``case``, run once for the file:
    its result, its run directory, the starting weights and their adapter
    count. One dataset and one starting file a method."""
    key = (case, package)
    if key in _RUNS:
        return _RUNS[key]
    method = CASES[case][1]
    if method not in _RUNS:
        root = tmp_path_factory.mktemp(method)
        csv, img_dir = make_finetune_csv(root / "ft", n=24, img_size=32)
        argv = ["--debug_tiny", "--img_size", "32", "--batch_size", "8",
                "--accumulation_steps", "2", "--epochs", "1", "--device", "cpu",
                "--compute_dtype", "float32", "--num_workers", "2", "--lr", str(LR),
                "--finetune_csvs", csv, "--finetune_img_dirs", img_dir]
        start = str(root / "start.npz")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_clip, "clip_init", JIT_INIT)
            flat = _starting_weights(argv + CASES[case], method, start)
        argv += ["--backbone_ckpt", start, f"--{method}_weights", start]
        _RUNS[method] = root, argv, flat
    root, argv, flat = _RUNS[method]
    cli = jax_cli if package == "jax" else torch_cli
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mona, "dropout", lambda rng, x, rate: x)
        mp.setattr(torch_mona, "dropout", lambda x, rate, gen=None, mask=None: x)
        mp.setattr(jax_clip, "clip_init", JIT_INIT)
        for kind, fn in JIT_INJECT.items():
            mp.setattr(jax_common, f"inject_{kind}", fn)
        mp.chdir(root)
        result = cli.main(argv + CASES[case] + ["--exp", f"{package}_{case}"])
    n_adapter = sum(f"/{method}/" in p for p in flat)
    _RUNS[key] = result, root / "runs" / f"{package}_{case}", flat, n_adapter
    return _RUNS[key]


@pytest.mark.parametrize("case", list(CASES))
def test_finetune_cli_matches_jax(tmp_path_factory, case):
    want, ref_dir, flat, n_adapter = _run(tmp_path_factory, case, "jax")
    got, run_dir, _, _ = _run(tmp_path_factory, case, "port")

    label = "MONA" if CASES[case][1] == "mona" else "LoRA"
    for log in (ref_dir / "log.log", run_dir / "log.log"):
        # the backbone file fills every tensor but the adapters' (not yet
        # injected), the adapter file every tensor of the injected tree
        assert _loaded(log, "backbone") == [len(flat) - n_adapter], log
        assert _loaded(log, label) == [len(flat)], log
    assert want["best_epoch"] == got["best_epoch"] == 0
    assert abs(got["best_val_loss"] - want["best_val_loss"]) <= 2.1e-5, (got, want)

    ref = jax_ckpt.load_flat(str(ref_dir / "best_model.npz"))
    saved = ckpt.load_flat(str(run_dir / "best_model.npz"))
    assert set(saved) == set(ref) and len(ref) == n_adapter
    _, meta = ckpt.load_train_state(str(run_dir / "last_state.npz"))
    assert meta["applied_count"] == 2  # 21 training pairs, batch 8, drop_last
    twin = None
    if case in TWIN:
        other, twin_dir, _, _ = _run(tmp_path_factory, TWIN[case], "jax")
        # the reference's two routes are the same function: their losses
        # agree to the loss bar, and their weights give each element's gap
        assert abs(other["best_val_loss"] - want["best_val_loss"]) <= 2.1e-5
        twin = jax_ckpt.load_flat(str(twin_dir / "best_model.npz"))
    for path, w in ref.items():
        out = saved[path]
        assert out.shape == w.shape, path
        assert not np.array_equal(w, flat[path]), path  # every adapter tensor trained
        tol = np.full(w.shape, 1e-4 * np.abs(w).max(), np.float32)
        if twin is not None:
            tol = np.maximum(tol, np.abs(twin[path] - w))
        assert (np.abs(out - w) <= tol).all(), (path, float(np.abs(out - w).max()))
