"""Traffic of one inference client, closed loop: each batch of a pool held in
pinned host memory is copied to the card, run through the configuration's
forward, and its answer copied back to the host; the next batch starts when
that copy has landed. A batch's latency runs from the start of its copy to
the card to its answer on the host.

The answers compared are every answer of the window (``check`` "all") or
``check`` of them at batch positions drawn from the seed; the reference
recomputes their pool batches after the window has closed.
"""

from __future__ import annotations

import random
import time

import torch

from benchmark import harness as H

KIND = "infer"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    def __init__(self, cell, seed: int, device, sizes: dict, program=None):
        self.cell, self.seed, self.device, self.s = cell, seed, device, sizes
        self.traffic = cell.traffic
        self.prog_mod = cell.module("programs")
        t0 = time.perf_counter()
        self.prog = program or self.prog_mod.Infer(sizes, self.traffic, seed, device)
        _sync(device)
        t1 = time.perf_counter()
        self.batch = self.traffic["batch"]
        self.k = 0
        self.kept = []
        for _ in range(self.traffic["warmup_batches"]):
            a = time.perf_counter()
            self._call(keep=False)
            self.batch_s = time.perf_counter() - a
        _sync(device)
        self.setup_phases = {"build_s": t1 - t0, "warmup_s": time.perf_counter() - t1}

    def _call(self, keep: bool):
        j = self.k % len(self.prog.host_pool)
        self.k += 1
        with torch.profiler.record_function("harness.copy_in"):
            x = self.prog.host_pool[j].to(self.device, non_blocking=True)
        a = time.perf_counter()
        with torch.profiler.record_function("harness.forward"):
            answer, logits = self.prog.infer(x)
        call = time.perf_counter() - a
        with torch.profiler.record_function("harness.copy_out"):
            host = answer.cpu()
        if keep:
            self.kept.append((j, host, None if answer is logits else logits.clone()))
        return call

    def _sample(self, seconds: float):
        """Window positions whose answers are compared."""
        check = self.traffic["check"]
        if check == "all":
            return None
        n_est = max(int(0.8 * seconds / self.batch_s), check)
        return set(random.Random(H.sub_seed(self.seed, 5)).sample(range(n_est), check))

    def window(self, seconds: float) -> dict:
        _sync(self.device)
        sample = self._sample(seconds)
        lat, host = [], []
        n = 0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            host.append(self._call(keep=sample is None or n in sample))
            lat.append(time.perf_counter() - a)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.kept = [(j, h, None if lg is None else lg.cpu()) for j, h, lg in self.kept]
        self.attempted, self.failed = n, 0
        return {"n": n, "failed": 0, "elapsed": elapsed, "host": host, "latency": lat}

    def end_to_end(self, w: dict) -> dict:
        lat_ms = [v * 1e3 for v in w["latency"]]
        self.latency_note = {"p50_ms": H.percentile(lat_ms, 50),
                             "p95_ms": H.percentile(lat_ms, 95), "n": len(lat_ms)}
        return {"infer_img_s": (w["n"] * self.batch / w["elapsed"], "images/s"),
                "infer_ms_p95": (H.percentile(lat_ms, 95), "ms")}

    def traced_steps(self, n: int):
        for _ in range(n):
            self._call(keep=False)

    def free(self):
        self.prog = None

    def check(self) -> dict:
        """The widest gap of a compared answer's logits from the reference's,
        over the largest |logit| the answer can take (the program module's
        ``logit_scale``) or, without one, the reference's largest |logit| in
        that batch; the root mean square gap over the reference's; for class
        maps also the pixels whose class differs from the reference's where
        the reference's margin is over twice the widest gap's limit."""
        R = self.cell.module("reference")
        if not self.kept:
            return {"logit_gap": float("inf")}
        ids = sorted({j for j, _, _ in self.kept})
        ref = self._reference(ids, R.exact)
        self.detail = {"answers_compared": len(self.kept), "pool_batches": ids}
        return self._gaps(self.kept, ref)

    def control(self) -> dict:
        """The same numbers with the reference at the control's precision
        (``reference.CONTROL``) answering the same pool batches."""
        R = self.cell.module("reference")
        ids = sorted({j for j, _, _ in self.kept})
        ctl = self._reference(ids, R.CONTROL)
        kept = []
        for j in ids:
            logits = ctl[j].float().cpu()
            answer = logits if self.kept[0][2] is None else logits.argmax(1).to(torch.uint8)
            kept.append((j, answer, None if answer is logits else logits))
        return self._gaps(kept, self._reference(ids, R.exact))

    def _reference(self, ids, q):
        return self.prog_mod.reference_infer(self.s, self.traffic, self.seed, self.device, ids, q)

    def _gaps(self, kept, ref) -> dict:
        gap, flips, err2, ref2 = 0.0, 0, 0.0, 0.0
        limit = self.cell.limits.get("logit_gap", 0.0)
        scale_of = getattr(self.prog_mod, "logit_scale", None)
        scale = None if scale_of is None else scale_of(self.s, self.traffic, self.seed,
                                                       self.device)
        for j, answer, logits in kept:
            r = ref[j].float().cpu()
            p = (answer if logits is None else logits).float()
            norm = scale if scale is not None else float(r.abs().max().clamp(min=1e-30))
            g = float((p - r).abs().max()) / norm
            gap = g if not g <= gap else gap
            err2 += float(((p - r).double() ** 2).sum())
            ref2 += float((r.double() ** 2).sum())
            if not answer.is_floating_point():
                top2 = r.topk(2, dim=1).values
                clear = (top2[:, 0] - top2[:, 1]) > 2 * limit * norm
                flips += int(((answer.long() != r.argmax(dim=1)) & clear).sum())
        out = {"logit_gap": gap, "logit_rms_gap": (err2 / max(ref2, 1e-300)) ** 0.5}
        if "map_flips" in self.cell.limits:
            out["map_flips"] = float(flips)
        return out
