"""One rank of the gloo checks in test_torch_mesh.py, launched the way
``torchrun`` launches a rank (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT in the environment). Imports torch and the port only.

    python tests/torch_mesh_worker.py cases INPUTS.npz OUT_PREFIX
    python tests/torch_mesh_worker.py finetune OUT.json -- <finetune argv>

``cases`` runs the four mesh cases on the toy model of INPUTS.npz and
writes OUT_PREFIX<rank>.npz; ``finetune`` runs the BiomedCLIP fine-tune CLI
with MONA's dropout masks all ones (so runs at different world sizes draw
the same masks) and writes its result and every update's metrics as JSON.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nextgen_uia_tpu_torch.core import mesh as M  # noqa: E402
from nextgen_uia_tpu_torch.core import train as T  # noqa: E402
from nextgen_uia_tpu_torch.losses import info_nce  # noqa: E402


class Toy(torch.nn.Module):
    """w [D, 1] trains; f [D, D] is frozen; ``mean`` a BatchNorm-like
    buffer the train forward overwrites with the batch mean of tanh(x f)."""

    def __init__(self, w, f):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w))
        self.f = torch.nn.Parameter(torch.tensor(f), requires_grad=False)
        self.register_buffer("mean", torch.zeros(f.shape[1]))

    def loss(self, mb, gen=None):
        h = torch.tanh(mb["x"] @ self.f)
        self.mean.copy_(h.detach().mean(0))
        return ((h @ self.w - mb["y"]) ** 2).mean()

    def forward(self, x):
        return torch.tanh(x @ self.f) @ self.w


def step_record(step, toy, batch):
    m = step(batch)
    return [m["loss"], m["grad_norm"], m["skipped"]], toy.w.detach().clone(), toy.mean.clone()


def run_cases(inputs, prefix):
    data = dict(np.load(inputs))
    cfg = T.TrainConfig(lr=0.1, total_updates=10, weight_decay=0.01)
    out = {}

    # (a) data-parallel over make_mesh(2, 1): three updates, the second all
    # skipped on both ranks, the third with one skipped microbatch on rank 0
    mesh = M.make_mesh(2, 1, device="cpu")
    toy = Toy(data["w"], data["f"])
    step = T.make_step_for_mesh(toy.loss, T.make_optimizer([toy.w], cfg), cfg, mesh,
                                accum_steps=2, bn=toy)
    for i in range(3):
        batch = {"x": torch.from_numpy(data[f"x{i}"]), "y": torch.from_numpy(data[f"y{i}"])}
        metrics, w, mean = step_record(step, toy, batch)
        out[f"a_metrics{i}"], out[f"a_w{i}"], out[f"a_mean{i}"] = metrics, w, mean
    out["a_applied"] = step.applied

    # (b) the frozen matrix sharded over make_mesh(1, 2): the batch splits
    # over both ranks, f gathered whole for the step
    mesh_b = M.make_mesh(1, 2, device="cpu")
    toy = Toy(data["w"], data["f"])
    step = T.make_step_for_mesh(toy.loss, T.make_optimizer([toy.w], cfg), cfg, mesh_b,
                                accum_steps=2, frozen={"f": toy.f})
    batch = {"x": torch.from_numpy(data["x0"]), "y": torch.from_numpy(data["y0"])}
    out["b_metrics"], out["b_w"], _ = step_record(step, toy, batch)
    out["b_shard"] = toy.f.detach().clone()

    # (c) InfoNCE over the features of both ranks (global negatives)
    wi = torch.nn.Parameter(torch.tensor(data["wi"]))
    wt = torch.nn.Parameter(torch.tensor(data["wt"]))

    def nce(mb, gen=None):
        img = T.all_gather_batch(T.scale_gradient(mb["xi"] @ wi, 2.0), mesh)
        txt = T.all_gather_batch(T.scale_gradient(mb["xt"] @ wt, 2.0), mesh)
        return info_nce(img, txt, temperature=0.07)

    step = T.make_sharded_train_step(nce, T.make_optimizer([wi, wt], cfg), cfg, mesh)
    m = step({"xi": torch.from_numpy(data["xi"]), "xt": torch.from_numpy(data["xt"])})
    out["c_metrics"] = [m["loss"], m["grad_norm"], m["skipped"]]
    out["c_gwi"], out["c_gwt"] = wi.grad.clone(), wt.grad.clone()

    # (d) sharded eval of a ragged batch padded to the data-parallel width
    toy = Toy(data["w"], data["f"])
    apply = T.make_sharded_apply(lambda p, x: p(x), mesh)
    padded, n_real = T.pad_eval_batch({"x": data["ragged"]}, apply.dp_width)
    with torch.no_grad():
        out["d_out"] = apply(toy, torch.from_numpy(padded["x"]))[:n_real]
    out["d_width"] = apply.dp_width
    np.savez(f"{prefix}{mesh.rank}.npz",
             **{k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in out.items()})


def run_finetune(out_json, argv):
    from nextgen_uia_tpu_torch.adapters import mona
    from nextgen_uia_tpu_torch.nn import layers
    from nextgen_uia_tpu_torch.tasks import clip_finetune as ft

    def ones(gen, rate, shape, device=None):
        return torch.ones(shape, device=device)

    mona.dropout_mask = layers.dropout_mask = ones
    updates, update = [], T.TrainStep._update

    def recorded(self, *args):
        updates.append(update(self, *args))
        return updates[-1]

    T.TrainStep._update = recorded  # the sharded step's too: it inherits it
    result = ft.finetune_main("biomedclip", argv)
    if int(os.environ.get("RANK", "0")) == 0:
        with open(out_json, "w") as f:
            json.dump({**result, "updates": updates}, f)


if __name__ == "__main__":
    if sys.argv[1] == "cases":
        run_cases(sys.argv[2], sys.argv[3])
    else:
        run_finetune(sys.argv[2], sys.argv[4:])
