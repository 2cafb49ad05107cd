"""The served kernels' CUDA forwards as registered torch ops.

Each op of the ``nextgen_uia`` namespace takes tensors and scalars only. Its
CUDA implementation is the kernel's launch: the library build, the device and
stream, the scratch buffers and the ``launches`` counter all live inside it.
Its fake implementation gives the outputs' shapes and dtypes, so
``torch.export`` traces a served forward on CUDA tensors into a graph that
calls these ops by name, and a trace never builds, launches or counts. The
wrappers build the weights the kernels read (casts, transposes,
concatenations) outside the op, where they trace as aten ops on the weight
arguments.

Importing ``nextgen_uia_tpu_torch.ops`` registers every op; a process that
loads an exported CUDA program imports it first::

    import nextgen_uia_tpu_torch.ops  # noqa: F401  (the nextgen_uia:: ops)
    program = torch.export.load("model.pt2")
"""

from __future__ import annotations

import torch

NAMESPACE = "nextgen_uia"
LIB = torch.library.Library(NAMESPACE, "DEF")


def register(name: str, schema: str, cuda, fake):
    """Define ``nextgen_uia::name`` with ``schema`` (its arguments and
    returns), ``cuda`` as its CUDA kernel and ``fake`` as its shape
    function; returns the op's default overload, which the wrappers call."""
    LIB.define(name + schema)
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def graph_ops(graph) -> list[str]:
    """The ``nextgen_uia`` ops an exported program's graph calls, by name,
    once each, sorted."""
    prefix = NAMESPACE + "."
    return sorted({str(n.target).split(".")[1] for n in graph.nodes
                   if n.op == "call_function" and str(n.target).startswith(prefix)})
