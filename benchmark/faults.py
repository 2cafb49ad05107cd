"""Faults planted under a built program, for the readings that set a cell's
upper limits (``control.py``) and for the tests that see ``correct`` come
out false (``tests/test_harness_faults.py``). Each takes the built program
object of a mode and breaks its timed path in place."""

from __future__ import annotations

import torch


def half_batch(prog):
    """Train: each microbatch cut to its first half, the loss the mean over
    that half. Infer: the forward over the first half, its answers repeated
    for the rest."""
    if hasattr(prog, "train_step"):
        inner = prog.train_step.loss_fn
        prog.train_step.loss_fn = lambda mb, gen: inner(
            {k: v[: v.shape[0] // 2] for k, v in mb.items()}, gen)
        return prog
    inner = prog.infer

    def infer(x):
        answer, logits = inner(x[: x.shape[0] // 2])
        rep = lambda t: torch.cat([t, t[: x.shape[0] - t.shape[0]]])  # noqa: E731
        return rep(answer), rep(logits)

    prog.infer = infer
    return prog


def unchanged(prog):
    """Train: the step computes and returns as before but leaves every
    tensor it changes as it found it."""
    step = prog.step

    def frozen_step(i):
        keep = {k: v.detach().clone() for k, v in prog.leaves().items()}
        out = step(i)
        with torch.no_grad():
            for k, v in prog.leaves().items():
                v.copy_(keep[k])
        return out

    prog.step = frozen_step
    return prog


def altered_answer(prog):
    """Infer: the first image's answer altered where it is produced: its
    logits zeroed (a class map: every pixel class 0)."""
    inner = prog.infer

    def infer(x):
        answer, logits = inner(x)
        zeroed = logits.clone()
        zeroed[0] = 0
        if answer is logits:
            return zeroed, zeroed
        altered = answer.clone()
        altered[0] = 0
        return altered, zeroed

    prog.infer = infer
    return prog


FAULTS = {"half_batch": half_batch, "unchanged": unchanged, "altered_answer": altered_answer}
