"""The data-parallel layout (port of ``mmt_psm_tpu/parallel/mesh.py``).

JAX runs one SPMD program over a 1-D ``data`` mesh: parameters replicated,
the batch sharded on its leading axis, the gradient all-reduce inserted by
XLA. One PyTorch process drives one card, so the counterpart of the mesh is
the process group's layout: ``Mesh`` (world, rank, device, backend).
Parameters are replicated by broadcasting rank 0's (``replicate``), each rank
keeps its equal, contiguous block of a global batch's rows (``shard_batch``),
and the train step reduces its gradients itself (``train/supervised.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from . import comm


@dataclasses.dataclass(frozen=True)
class Mesh:
    world: int
    rank: int
    device: torch.device
    backend: str | None  # None: no process group (world 1)


def current_mesh(device) -> Mesh:
    """The layout of the process group this process is in (world 1 without
    one), with this rank's ``device``."""
    backend = dist.get_backend() if dist.is_available() and dist.is_initialized() else None
    return Mesh(comm.get_world_size(), comm.get_rank(), torch.device(device), backend)


def mesh_size_for(cfg, batch_size: int, world: int) -> int:
    """Devices of the data mesh (JAX ``engine/trainer.py::mesh_size_for``):
    TPU.MESH_SHAPE[0] (-1: all) of the ``world`` processes, capped to a
    divisor of the batch so shards are equal. Every rank of the world must
    take part in the step's collectives, so a rule that leaves some out
    raises."""
    want = int(cfg.TPU.MESH_SHAPE[0])
    n = max(world if want == -1 else min(want, world), 1)
    while batch_size % n:
        n -= 1
    if n != world:
        raise ValueError(f"TPU.MESH_SHAPE {list(cfg.TPU.MESH_SHAPE)} with a batch of {batch_size} gives a mesh of "
                         f"{n} device(s), but the world has {world} process(es): every rank must hold a shard")
    return n


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every array of a global batch (numpy arrays or
    tensors, leading axis the batch): rank r of W keeps rows
    [r n / W, (r + 1) n / W). The batch itself at world 1."""
    if mesh.world == 1:
        return batch
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % mesh.world:
            raise ValueError(f"{k}: {n} rows do not split over {mesh.world} ranks")
        per = n // mesh.world
        out[k] = v[mesh.rank * per:(mesh.rank + 1) * per]
        if isinstance(v, np.ndarray):
            out[k] = np.ascontiguousarray(out[k])
    return out


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place."""
    if mesh.world > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module
