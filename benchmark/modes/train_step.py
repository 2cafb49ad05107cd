"""Traffic of one training client, closed loop: the configuration's train step
called back to back on the batches of a pool held on the card.

Set-up builds the step once and drives it through ``checked_steps`` steps on
pool batches that all differ (the generator's state recorded before each,
the tensors the step changes copied before the first and after the last,
the first gradient read from AdamW's first moment after the first), then
``warmup_steps`` more; the window gets that same object. Once the window
has closed, the same object takes one more step through the same call (the
late step), its state copied before and after: the tensors it changes,
AdamW's moments and counts, the generator's state. The reference follows
the checked steps from the seed, and replays the late step from the
program's state before it.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import harness as H

KIND = "train"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    def __init__(self, cell, seed: int, device, sizes: dict, program=None):
        self.cell, self.seed, self.device, self.s = cell, seed, device, sizes
        self.traffic = cell.traffic
        self.prog_mod = cell.module("programs")
        t0 = time.perf_counter()
        self.prog = program or self.prog_mod.Train(sizes, self.traffic, seed, device)
        _sync(device)
        t1 = time.perf_counter()
        self.batch = self.prog_mod.images_per_step(sizes, self.traffic)
        self.k = 0
        self._checked_steps()
        _sync(device)
        t2 = time.perf_counter()
        for _ in range(self.traffic["warmup_steps"]):
            self._call()
        _sync(device)
        self.setup_phases = {"build_s": t1 - t0, "checked_steps_s": t2 - t1,
                             "warmup_s": time.perf_counter() - t2}

    def _call(self) -> dict:
        res = self.prog.step(self.k)
        self.k += 1
        return res

    def _checked_steps(self):
        n = self.traffic["checked_steps"]
        leaves = self.prog.leaves()
        start = {k: v.detach().clone() for k, v in leaves.items()}
        self.states, self.losses = [], []
        for t in range(n):
            self.states.append(self.prog.gen.get_state())
            self.losses.append(float(self._call()["loss"]))
            if t == 0:
                opt = self.prog.train_step.optimizer
                beta1 = opt.param_groups[0]["betas"][0]
                by_param = {id(p): n for n, p in leaves.items()}
                self.grad1 = {by_param[id(p)]: st["exp_avg"].detach().clone() / (1 - beta1)
                              for p, st in opt.state.items()}
        self.delta = {k: v.detach() - start[k] for k, v in self.prog.leaves().items()}

    def window(self, seconds: float) -> dict:
        """Steps back to back for ``seconds``; each call timed on the host.
        Then, outside the window, the late step."""
        _sync(self.device)
        n = failed = 0
        host = []
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            res = self._call()
            host.append(time.perf_counter() - a)
            n += 1
            failed += int(res["skipped"] > 0 or not math.isfinite(res["loss"]))
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.device)
        elapsed = time.perf_counter() - t0
        self.attempted, self.failed = n, failed
        self._late_step()
        return {"n": n, "failed": failed, "elapsed": elapsed, "host": host}

    def _late_step(self):
        """One more step of the window's object through the window's call,
        with the state it starts from: the program's own, for the
        reference to replay the step from."""
        opt = self.prog.train_step.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        leaves = self.prog.leaves()
        by_param = {id(p): n for n, p in leaves.items()}
        before = {k: v.detach().clone() for k, v in leaves.items()}
        m0 = {by_param[id(p)]: st["exp_avg"].detach().clone() for p, st in opt.state.items()}
        v0 = {by_param[id(p)]: st["exp_avg_sq"].detach().clone() for p, st in opt.state.items()}
        step = {float(st["step"]) for st in opt.state.values()}
        self.late_start = {"leaves": before, "m": m0, "v": v0, "step": int(max(step)),
                           "applied": self.prog.train_step.applied,
                           "pool": self.k % self.traffic["pool"]}
        self.late_state = self.prog.gen.get_state()
        loss = float(self._call()["loss"])
        grad = {by_param[id(p)]: (st["exp_avg"].detach() - beta1 * m0[by_param[id(p)]])
                / (1 - beta1) for p, st in opt.state.items()}
        delta = {k: v.detach() - before[k] for k, v in self.prog.leaves().items()}
        self.late = ([loss], grad, delta)

    def end_to_end(self, w: dict) -> dict:
        return {"train_img_s": (w["n"] * self.batch / w["elapsed"], "images/s")}

    def traced_steps(self, n: int):
        for _ in range(n):
            with torch.profiler.record_function("harness.train_step"):
                self._call()

    def free(self):
        """Drop the program's state before the reference runs."""
        self.prog = None

    def check(self) -> dict:
        """The numbers the cell's limits pick from, for the checked steps
        and (``late_``) the late step: the losses' gap (the worst step, and
        the first alone), and per leaf the gap of the gradient's and of the
        change's norms: the worst leaf (leaves named by the cell's
        ``worst_leaf_skips`` left out, and read apart as ``_skipped``) and
        the median leaf's."""
        R = self.cell.module("reference")
        return self._numbers((self.losses, self.grad1, self.delta), self.late, R.exact)

    def control(self) -> dict:
        """The same numbers with the reference at the control's precision
        (``reference.CONTROL``) in the program's place."""
        return self.witness(None)

    def witness(self, name) -> dict:
        """The same numbers with the reference at the precision
        ``reference.WITNESSES[name]`` (None: the control's) in the
        program's place."""
        R = self.cell.module("reference")
        q = R.CONTROL if name is None else R.WITNESSES[name]
        return self._numbers(self._reference(q), self._reference(q, late=True), R.exact)

    def _numbers(self, first, late, exact) -> dict:
        out = self._gaps(*first, self._reference(exact))
        detail = self.detail
        for k, v in self._gaps(*late, self._reference(exact, late=True)).items():
            if k != "loss1_gap":
                out[f"late_{k}"] = v
        self.detail = {**detail, "late": self.detail}
        return out

    def _reference(self, q, late: bool = False):
        if late:
            return self.prog_mod.reference_train(self.s, self.traffic, self.seed, self.device,
                                                 [self._draws(self.late_state)], q,
                                                 self.late_start)
        draws = [self._draws(st) for st in self.states]
        return self.prog_mod.reference_train(self.s, self.traffic, self.seed, self.device,
                                             draws, q)

    def _gaps(self, losses_p, grad1_p, delta_p, ref) -> dict:
        losses, grad1, delta = ref
        loss_gap = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses_p, losses))
        if not all(math.isfinite(v) for v in losses_p):
            loss_gap = math.inf
        skip = H.round_off_leaves(grad1)
        apart = self.cell.workload.get("worst_leaf_skips", [])
        out = {"loss_gap": loss_gap,
               "loss1_gap": abs(losses_p[0] - losses[0]) / max(abs(losses[0]), 1e-12)}
        self.detail = {"losses": losses_p, "ref_losses": losses, "leaves": len(grad1),
                       "round_off_leaves": sorted(skip)}
        for key, p, r in (("grad_gap", grad1_p, grad1), ("change_gap", delta_p, delta)):
            gaps = H.norm_gaps(p, r, skip)
            kept = {k: v for k, v in gaps.items() if not any(a in k for a in apart)}
            worst, leaf, _ = H.worst_and_median(kept)
            out[key], out[f"{key}_median"] = worst, H.worst_and_median(gaps)[2]
            self.detail[f"{key}_leaf"] = leaf
            self.detail[f"{key}_top"] = sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
            if len(kept) < len(gaps):
                out[f"{key}_skipped"] = H.worst_and_median(
                    {k: v for k, v in gaps.items() if k not in kept})[0]
        return out

    def _draws(self, state):
        fn = getattr(self.prog_mod, "draws", None)
        return None if fn is None else fn(self.s, self.traffic, self.device, state)
