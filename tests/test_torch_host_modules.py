"""The port's last host modules against the JAX package, on the CPU:
``metrics/reconstruction.py`` (psnr, ssim with its Gaussian window,
ReconAccumulator) equal to JAX's on the same arrays, and
``core/profiling.py``: ``trace`` writes a Chrome trace of the block,
``annotate`` names a region in it, ``force_completion`` and ``StepTimer``
as the JAX package's (tests/test_aux_subsystems.py's counterpart).
"""

import glob
import json

import numpy as np
import pytest
import torch

from nextgen_uia_tpu.metrics import reconstruction as jax_recon
from nextgen_uia_tpu_torch.core.profiling import StepTimer, annotate, force_completion, trace
from nextgen_uia_tpu_torch.metrics import reconstruction as recon


@pytest.mark.parametrize("shape", [(3, 1, 24, 24), (2, 3, 17, 29)])
def test_reconstruction_metrics_equal_jax(shape):
    rng = np.random.default_rng(sum(shape))
    target = rng.random(shape)
    pred = np.clip(target + 0.1 * rng.standard_normal(shape), -0.2, 1.2)
    pred[0] = target[0]  # a perfect sample: PSNR inf, left out of the mean
    np.testing.assert_array_equal(recon.psnr(pred, target), jax_recon.psnr(pred, target))
    np.testing.assert_array_equal(recon.ssim(pred, target), jax_recon.ssim(pred, target))

    def mse(a, b):
        return float(np.mean((a - b) ** 2))

    accs = [mod.ReconAccumulator(criterion=mse) for mod in (recon, jax_recon)]
    for acc in accs:
        acc.update(pred, target)
        acc.update(target[::-1], pred[::-1])
    got, want = (acc.compute() for acc in accs)
    assert got == want and np.isfinite(got["psnr_mean"]) and got["ssim_mean"] < 1.0
    assert len(accs[0].psnr_list) == 2 * shape[0]


def test_profiling_utils(tmp_path):
    timer = StepTimer(warmup=1)
    x = torch.ones(4)
    for _ in range(3):
        timer.start()
        y = x * 2
        timer.stop(y)
    assert len(timer.times) == 2 and timer.mean_ms >= 0
    assert timer.throughput(8) > 0
    assert force_completion({"a": torch.ones(2, 2) * 3.0, "b": [torch.zeros(1)]}) == 3.0
    with trace(None):
        pass  # the no-op path

    logdir = tmp_path / "trace"
    with trace(str(logdir)):
        with annotate("baseline_step"):
            torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    (path,) = glob.glob(str(logdir / "*.json"))
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "baseline_step" for e in events)
    assert any("mm" in e.get("name", "") for e in events)


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
@pytest.mark.gpu
def test_step_timer_reads_cuda_events():
    timer = StepTimer(warmup=0, device="cuda")
    x = torch.randn(2048, 2048, device="cuda")
    timer.start()
    y = x @ x
    dt = timer.stop(y)
    assert dt > 0 and timer.times == [dt]
