"""The port's multi-process path (core/mesh.py, the sharded step and apply of
core/train.py, the fine-tune CLI's global negatives) against the JAX
package's mesh.

``param_spec``/``param_pspecs`` are pure policy, compared with no process.
The rest runs in one gloo group of two processes (tests/torch_mesh_worker.py,
launched with torchrun's environment) that computes four cases, each held
to JAX on a 2-device mesh of conftest's virtual CPU devices: the
data-parallel step on make_mesh(2, 1) over three updates (the second
skipped on both ranks, the third with one microbatch skipped on one rank;
losses, gradient norms, skip counts, weights and the pmean'd BatchNorm-like
aux), the frozen-sharded step on make_mesh(1, 2), InfoNCE with global
negatives (loss and gradients: the tiled all-gather's backward is JAX's
psum-scatter), and the sharded apply of a ragged batch padded by
``pad_eval_batch``. Last, the BiomedCLIP MONA fine-tune CLI at world 2
against world 1 on the same global batch (MONA's dropout masks all ones,
so both draw the same): the first update's loss equal to float32
tolerance, its gradient norm twice world 1's, as JAX's global negatives
give it, the second update's loss and the validation loss equal too (the
weights are not compared elementwise: AdamW's first step moves each weight
by about the rate times the sign of its gradient, and the MONA gradients
that are zero but for rounding take either sign). Tolerances: 1e-5
relative on losses and norms, 1e-5 * max|ref| on tensors, exact on skip
counts.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from nextgen_uia_tpu.core import mesh as jax_mesh
from nextgen_uia_tpu.core import train as JT
from nextgen_uia_tpu.losses import info_nce as jax_info_nce
from nextgen_uia_tpu_torch.core import mesh as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
D = 256  # f [D, D] has 2 ** 16 elements: param_spec shards it over 'model'

SPEC_CASES = [
    ("visual/blocks/0/mlp/fc1/w", (768, 3072), 2),
    ("visual/blocks/0/mona/down/w", (768, 64), 2),
    ("visual/blocks/3/attn/lora/q/a", (768, 16), 4),
    ("visual/norm/scale", (768,), 2),
    ("text/token_embedding/w", (49408, 512), 2),
    ("text/token_embedding/w", (49408, 511), 2),  # odd trailing dim: the leading one
    ("visual/blocks/0/attn/q/w", (255, 255), 2),  # under min_size: replicates
    ("visual/blocks/0/mlp/fc1/w", (768, 3072), 1),
]


@pytest.mark.parametrize("path,shape,n_model", SPEC_CASES)
def test_param_spec_matches_jax(path, shape, n_model):
    want = jax_mesh.param_spec(path, shape, model_axis_size=n_model)
    assert M.param_spec(path, shape, model_axis_size=n_model) == tuple(want)


def test_param_pspecs_matches_jax():
    import torch

    shapes = {f"p{i}/{path}": shape for i, (path, shape, _) in enumerate(SPEC_CASES)}
    tree = {k: jnp.zeros(s, jnp.int8) for k, s in shapes.items()}
    mesh = jax_mesh.make_mesh(1, 2, devices=jax.devices()[:2])
    want = jax_mesh.param_pspecs(tree, mesh)
    got = M.param_pspecs({k: torch.zeros(()).expand(*s) for k, s in shapes.items()},
                         M.Mesh(1, 2, 0, torch.device("cpu")))
    assert got == {k: tuple(v) for k, v in want.items()}


def test_make_mesh_refuses_a_grid_the_launch_does_not_have(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert M.make_mesh(device="cpu").world == 1
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        M.make_mesh(2, 2, device="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(args, world, cwd, timeout=240):
    """Run the worker as ``world`` ranks with torchrun's environment (or
    one plain process at world 0); raise with their output on failure."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    ranks = [{}] if world == 0 else [
        dict(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
             MASTER_PORT=str(port)) for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, *args], cwd=cwd, env={**env, **r},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in ranks]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def _inputs(rng):
    f32 = np.float32
    data = {"w": rng.standard_normal((D, 1)).astype(f32),
            "f": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(f32),
            "wi": rng.standard_normal((6, 4)).astype(f32),
            "wt": rng.standard_normal((5, 4)).astype(f32),
            "xi": rng.standard_normal((1, 8, 6)).astype(f32),
            "xt": rng.standard_normal((1, 8, 5)).astype(f32),
            "ragged": rng.standard_normal((5, D)).astype(f32)}
    for i in range(3):
        data[f"x{i}"] = rng.standard_normal((2, 8, D)).astype(f32)
        data[f"y{i}"] = rng.standard_normal((2, 8, 1)).astype(f32)
    data["x1"][:] = np.nan            # every microbatch of both ranks skipped
    data["x2"][0, :4] = np.nan        # rank 0's first microbatch skipped
    return data


def _toy_loss(p, fz, b, rng):
    h = jnp.tanh(b["x"] @ fz["f"])
    return jnp.mean((h @ p["w"] - b["y"]) ** 2), {"mean": h.mean(0)}


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The two ranks' outputs and the inputs they ran on."""
    tmp = tmp_path_factory.mktemp("gloo")
    data = _inputs(np.random.default_rng(0))
    np.savez(tmp / "inputs.npz", **data)
    _launch(["cases", str(tmp / "inputs.npz"), str(tmp / "rank")], 2, str(tmp))
    return data, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _jax_cfg(accum):
    return JT.TrainConfig(lr=0.1, lr_min=1e-8, weight_decay=0.01, grad_clip=0.0,
                          accum_steps=accum, total_updates=10)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(np.nanmax(np.abs(want)), 1e-30))


def test_sharded_step_matches_jax(gloo):
    data, ranks = gloo
    mesh = jax_mesh.make_mesh(2, 1, devices=jax.devices()[:2])
    cfg = _jax_cfg(2)
    opt, _ = JT.make_optimizer(cfg)
    step = JT.make_sharded_train_step(_toy_loss, opt, cfg, mesh, donate=False, has_aux=True)
    state = JT.init_state({"w": jnp.asarray(data["w"])}, opt)
    frozen = {"f": jnp.asarray(data["f"])}
    for i in range(3):
        batch = {"x": jnp.asarray(data[f"x{i}"]), "y": jnp.asarray(data[f"y{i}"])}
        state, m = step(state, frozen, batch, jax.random.key(0))
        for out in ranks:
            loss, norm, skipped = out[f"a_metrics{i}"]
            assert skipped == int(m["skipped"]) == (0, 2, 1)[i]
            _close(loss, m["loss"])
            _close(norm, m["grad_norm"])
            _close(out[f"a_w{i}"], state["params"]["w"])
            np.testing.assert_allclose(out[f"a_mean{i}"], np.asarray(m["aux"]["mean"]),
                                       rtol=0, atol=1e-6, equal_nan=True)
    assert np.isnan(ranks[0]["a_mean1"]).all()  # the skipped update's aux, as JAX's
    np.testing.assert_array_equal(ranks[0]["a_w1"], ranks[0]["a_w0"])
    assert int(ranks[0]["a_applied"]) == 2


def test_frozen_sharded_step_matches_jax(gloo):
    data, ranks = gloo
    mesh = jax_mesh.make_mesh(1, 2, devices=jax.devices()[:2])
    cfg = _jax_cfg(2)
    opt, _ = JT.make_optimizer(cfg)
    frozen = jax_mesh.shard_params({"f": jnp.asarray(data["f"])}, mesh)
    step, _ = JT.make_step_for_mesh(_toy_loss, opt, cfg, mesh, donate=False, has_aux=True,
                                    frozen_example=frozen)
    state = JT.init_state({"w": jnp.asarray(data["w"])}, opt)
    state, m = step(state, frozen, {"x": jnp.asarray(data["x0"]),
                                    "y": jnp.asarray(data["y0"])}, jax.random.key(0))
    for r, out in enumerate(ranks):
        loss, norm, skipped = out["b_metrics"]
        assert skipped == int(m["skipped"]) == 0
        _close(loss, m["loss"])
        _close(norm, m["grad_norm"])
        _close(out["b_w"], state["params"]["w"])
        # between steps each rank holds its slice of f's trailing dim
        np.testing.assert_array_equal(out["b_shard"], data["f"][:, r * D // 2:(r + 1) * D // 2])


def test_global_negatives_info_nce_matches_jax(gloo):
    data, ranks = gloo
    mesh = jax_mesh.make_mesh(2, 1, devices=jax.devices()[:2])

    def loss_fn(p, fz, b, rng):
        img = JT.scale_gradient(b["xi"] @ p["wi"], 2.0)
        txt = JT.scale_gradient(b["xt"] @ p["wt"], 2.0)
        img = jax.lax.all_gather(img, "data", axis=0, tiled=True)
        txt = jax.lax.all_gather(txt, "data", axis=0, tiled=True)
        return jax_info_nce(img, txt, temperature=0.07)

    opt = optax.sgd(1.0)  # one step of it gives the gradients: p - p'
    params = {"wi": jnp.asarray(data["wi"]), "wt": jnp.asarray(data["wt"])}
    step = JT.make_sharded_train_step(loss_fn, opt, _jax_cfg(1), mesh, donate=False)
    state, m = step(JT.init_state(params, opt), {},
                    {"xi": jnp.asarray(data["xi"]), "xt": jnp.asarray(data["xt"])},
                    jax.random.key(0))
    for out in ranks:
        loss, norm, skipped = out["c_metrics"]
        assert skipped == 0
        _close(loss, m["loss"])
        _close(norm, m["grad_norm"])
        for name in ("wi", "wt"):
            _close(out[f"c_g{name}"], params[name] - state["params"][name])


def test_sharded_apply_matches_jax(gloo):
    data, ranks = gloo
    mesh = jax_mesh.make_mesh(2, 1, devices=jax.devices()[:2])

    def fn(tp, fz, batch):
        return jnp.tanh(batch["x"] @ fz["f"]) @ tp["w"]

    apply, _, width = JT.make_sharded_apply(fn, mesh)
    padded, n_real = JT.pad_eval_batch({"x": data["ragged"]}, width)
    want = np.asarray(apply({"w": data["w"]}, {"f": data["f"]}, padded))[:n_real]
    for out in ranks:
        assert int(out["d_width"]) == width == 2
        assert out["d_out"].shape == (5, 1)
        _close(out["d_out"], want)


def test_finetune_cli_world2_matches_world1(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from synth_data import make_finetune_csv

    csv, img_dir = make_finetune_csv(tmp_path / "ft", n=24, img_size=32)
    results = {}
    for world in (0, 2):
        argv = ["--exp", f"w{world}", "--method", "mona", "--debug_tiny", "--img_size", "32",
                "--batch_size", "8", "--accumulation_steps", "2", "--epochs", "1",
                "--device", "cpu", "--compute_dtype", "float32", "--num_workers", "1",
                "--finetune_csvs", csv, "--finetune_img_dirs", img_dir]
        out = tmp_path / f"w{world}.json"
        _launch(["finetune", str(out), "--", *argv], world, str(tmp_path))
        results[world] = json.loads(out.read_text())
    one, two = results[0]["updates"], results[2]["updates"]
    assert len(one) == len(two) == 2 and one[0]["skipped"] == two[0]["skipped"] == 0
    # the first update: the same global batch from the same weights, the same InfoNCE
    np.testing.assert_allclose(two[0]["loss"], one[0]["loss"], rtol=1e-5)
    # JAX's psum-scatter transpose with scale_gradient(n_dp): the gradient of
    # the global loss, times the data-parallel width
    np.testing.assert_allclose(two[0]["grad_norm"], 2 * one[0]["grad_norm"], rtol=1e-4)
    # and after it, AdamW's update nearly the same: the next loss and the
    # validation loss agree
    np.testing.assert_allclose(two[1]["loss"], one[1]["loss"], rtol=1e-5)
    np.testing.assert_allclose(results[2]["best_val_loss"], results[0]["best_val_loss"],
                               rtol=1e-5)
