"""Process groups, the (data, model) layout and the sharding policy
(counterpart of nextgen_uia_tpu/core/mesh.py).

One process a device, launched by ``torchrun`` (which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``): NCCL
between CUDA devices, each rank on ``cuda:LOCAL_RANK``, gloo between CPU
processes. The ranks form a ``(data, model)`` grid as the JAX package's
``devices.reshape(n_data, n_model)`` does: rank ``r`` is data index
``r // n_model`` and model index ``r % n_model``.

  - batches are split over 'data': every rank reads the same seeded global
    batch and takes its contiguous slice; gradients are averaged by
    ``all_reduce`` (core/train.py);
  - large frozen matrices are sharded over 'model' (``param_spec``): each
    rank keeps one slice and the ranks of its data index (one process
    subgroup each) gather them whole once a step; the batch then splits
    over every rank;
  - small tensors (norms, biases, adapters) replicate.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the (data, model) grid. ``model_group`` is
    the subgroup of the ranks sharing its data index (None when n_model is
    1); ``distributed``: a process group is up (even at world size 1)."""
    n_data: int
    n_model: int
    rank: int
    device: torch.device
    model_group: object = None
    distributed: bool = False

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _launched() -> bool:
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def make_mesh(n_data: int | None = None, n_model: int = 1, *, device="cuda") -> Mesh:
    """The grid of the processes of this launch. Outside ``torchrun`` (no
    process group, no ``WORLD_SIZE``) the world is this process. Under it,
    the process group is set up from the environment if it is not yet (NCCL
    for ``device`` cuda, gloo for cpu) and each rank runs on
    ``cuda:LOCAL_RANK`` (or the CPU). ``n_data`` unset: the world size over
    ``n_model``. Raises when ``n_data * n_model`` is not the world size."""
    from ..tasks.common import resolve_device

    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if n_data is None:
        n_data = max(world // n_model, 1)
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(
            f"make_mesh: a ({n_data} data x {n_model} model) grid needs {n_data * n_model} "
            f"processes, but this launch has {world}: run it with torchrun "
            f"--nproc_per_node {n_data * n_model} (one process a device)")
    device = resolve_device(str(device))
    if not _launched():
        return Mesh(1, 1, 0, device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://", world_size=world,
                                rank=int(os.environ["RANK"]))
    rank, group = dist.get_rank(), None
    if n_model > 1:
        # every rank creates every subgroup, in the same order
        for d in range(n_data):
            g = dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
            if d == rank // n_model:
                group = g
    return Mesh(n_data, n_model, rank, device, group, True)


def param_spec(path: str, shape, *, model_axis_size: int, min_size: int = 2 ** 16) -> tuple:
    """The sharding of one parameter: one entry a dim, "model" on the dim
    split over the 'model' axis, else None; () replicates.

    2-D matrices with a divisible trailing dim and >= min_size elements
    shard that dim over 'model'; large 2-D ones whose trailing dim does not
    divide shard the leading dim; everything else replicates. Adapters
    (mona/lora) always replicate: their gradients are the ones averaged
    every step, and they are small."""
    if model_axis_size <= 1:
        return ()
    lpath = path.lower()
    if "mona" in lpath or "lora" in lpath:
        return ()
    size = int(np.prod(shape)) if len(shape) else 0
    if len(shape) == 2 and size >= min_size:
        if shape[1] % model_axis_size == 0:
            return (None, "model")
        if shape[0] % model_axis_size == 0:
            return ("model", None)
    return ()


def param_pspecs(flat: dict, mesh: Mesh) -> dict:
    """flat path -> ``param_spec`` of each tensor of a flat path -> tensor
    dict (core/partition.py's paths), over the mesh's 'model' axis."""
    return {path: param_spec(path, tuple(t.shape), model_axis_size=mesh.n_model)
            for path, t in flat.items()}


def sharded_dim(spec: tuple) -> int | None:
    """The dim a spec splits over 'model', or None."""
    return spec.index("model") if "model" in spec else None


def shard(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` under ``spec``."""
    dim = sharded_dim(spec)
    if dim is None:
        return t
    return t.chunk(mesh.n_model, dim)[mesh.model_index].contiguous()


def gather(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every model rank's slice ``t`` (the JAX
    package's tiled ``all_gather`` over 'model'): one
    ``all_gather_into_tensor`` over the subgroup of this data index."""
    dim = sharded_dim(spec)
    if dim is None:
        return t
    n = mesh.n_model
    moved = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * moved.shape[0], *moved.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, moved, group=mesh.model_group)
    return out.movedim(0, dim).contiguous()


def barrier(mesh: Mesh | None) -> None:
    """Wait for every process of ``mesh`` (nothing on one process)."""
    if mesh is not None and mesh.distributed:
        dist.barrier()
