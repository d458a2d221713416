"""Process-group helpers and the batch-axis collectives of data-parallel
training (port of ``mmt_psm_tpu/parallel/comm.py``, after the reference's
maskrcnn_benchmark/utils/comm.py:15-147).

A world of W processes, one per card, computes what the JAX mesh computes:
the single-process step on the global batch, each rank holding an equal,
contiguous block of its images (``parallel/mesh.py::shard_batch``). Every
quantity of the train step that couples images is detached (a count, a
score, a draw) or is the gradient, so no collective carries gradient:

* ``global_sum``: a loss normalizer (a count of valid anchors, RoIs,
  positives, mask pixels) summed over the ranks; each rank divides its own
  numerator by it, and the ranks' gradients are summed;
* ``global_kth``: the k-th largest of the union of the ranks' values (the
  training proposals' top-k over the whole batch);
* ``gather_rows`` / ``rank_rows``: a tensor's rows of every rank, rank-major
  (the global batch), and this rank's rows of a global-batch tensor (the
  sampler's and dropout's draws, drawn for the global batch from generators
  that every rank seeds alike);
* ``batch_mean``: the mean of per-item values over the global batch.

At world 1 (no process group, or a group of one) every helper returns its
input or the plain single-process expression and calls no collective, so
the single-card step is the same bit for bit and never waits on the card.
Whether they call their collectives is ``distributed()``; a check of the
collectives' own path on a group of one (one card, NCCL) patches it true.

The tensors' collectives are ``all_reduce`` only: gloo reduces CUDA tensors
(two ranks that share one card run over gloo, since NCCL refuses two ranks
on one device) but does not gather them, so ``gather_rows`` sums each rank's
rows into a zero buffer. Adding zeros is exact.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List

import torch
import torch.distributed as dist

from ..ops.topk import top_k

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def distributed() -> bool:
    """Whether the helpers below call their collectives: in a process group
    of more than one rank."""
    return get_world_size() > 1


def synchronize() -> None:
    """A barrier across the ranks (comm.py:33-56); nothing at world 1."""
    if distributed():
        dist.barrier()


def all_gather(data: Any) -> List[Any]:
    """Every rank's picklable ``data``, of any size, in rank order
    (comm.py:81-147 without its temporary directory)."""
    if not distributed():
        return [data]
    out = [None] * get_world_size()
    dist.all_gather_object(out, data)
    return out


def reduce_loss_dict(loss_dict: dict) -> dict:
    """The mean over the ranks of a dict of scalars, for logging
    (MTtrainer.reduce_loss_dict, MTtrainer.py:16-42)."""
    if not distributed():
        return dict(loss_dict)
    gathered = all_gather({k: float(v) for k, v in loss_dict.items()})
    return {k: sum(g[k] for g in gathered) / len(gathered) for k in loss_dict}


def global_losses(losses: dict, replicated=()) -> dict:
    """The global batch's losses from each rank's shares (local numerators
    over global denominators): the values summed over the ranks in one
    all-reduce, but for the keys in ``replicated``, which every rank holds
    alike (``mt_weight``). ``losses`` itself at world 1."""
    if not distributed():
        return losses
    keys = [k for k in losses if k not in replicated]
    summed = global_sum(torch.stack([losses[k].detach().float() for k in keys]))
    return {**losses, **dict(zip(keys, summed.unbind()))}


def device_for_rank(device=None, local_rank: int = 0) -> torch.device:
    """The device of a rank: the card ``cuda:LOCAL_RANK`` unless the caller
    names one; a named card must be that one. Never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", local_rank)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            return torch.device("cuda", local_rank)
        if dev.index != local_rank:
            raise ValueError(f"device {dev} disagrees with LOCAL_RANK {local_rank}: each rank runs on "
                             f"cuda:LOCAL_RANK")
    return dev


def init_distributed(backend: str | None = None, device=None, *, rank: int | None = None,
                     world_size: int | None = None, init_method: str = "env://",
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group and return this rank's device.

    Rank, world size and LOCAL_RANK come from the environment ``torchrun``
    sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/MASTER_PORT for
    ``env://``) unless given. ``device``: as ``device_for_rank`` reads it
    (default ``cuda:LOCAL_RANK``, which becomes the current card).
    ``backend``: default ``nccl`` on the card and ``gloo`` on the CPU;
    ``gloo`` on the card is an explicit choice, for ranks that share one card.
    A group that fails to start raises: nothing falls back to another
    backend or device."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dev = device_for_rank(device, int(os.environ.get("LOCAL_RANK", 0)))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a card, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size, timeout=timeout,
                            **kw)
    return dev


def launch_device(device=None) -> torch.device:
    """A CLI's device. Under ``torchrun`` (WORLD_SIZE > 1): this rank's, the
    process group joined if it is not yet (``init_distributed``), ``device``
    checked against LOCAL_RANK. Else the card unless ``device`` names
    another (``models.detector.resolve_device``)."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if dist.is_initialized():
            return device_for_rank(device, int(os.environ.get("LOCAL_RANK", 0)))
        return init_distributed(device=device)
    from ..models.detector import resolve_device

    return resolve_device(device)


# ------------------------------------------------- batch-axis collectives
def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a detached count or normalizer) summed over the ranks; ``t``
    itself at world 1."""
    if not distributed():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order, without gradient; ``t`` at world 1."""
    if not distributed():
        return t
    world = get_world_size()
    n = t.shape[0]
    out = torch.zeros((world * n, *t.shape[1:]), dtype=t.dtype, device=t.device)
    rank = get_rank()
    out[rank * n:(rank + 1) * n] = t.detach()
    dist.all_reduce(out)
    return out


def global_rows(n: int) -> int:
    """Rows of the global batch of which each rank holds ``n``."""
    return n * get_world_size()


def rank_rows(t: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """This rank's rows of a global-batch tensor: dim 0 holds ``groups``
    equal groups (e.g. the views stacked on the batch axis), each the
    global batch's rows rank-major; returns the rank's block of each group,
    concatenated. ``t`` at world 1."""
    if not distributed():
        return t
    world = get_world_size()
    per = t.shape[0] // (groups * world)
    if per * groups * world != t.shape[0]:
        raise ValueError(f"{t.shape[0]} rows do not split into {groups} groups over {world} ranks")
    return t.reshape(groups, world, per, *t.shape[1:])[:, get_rank()].reshape(groups * per, *t.shape[1:])


def global_kth(values: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest of the union of every rank's 1-D ``values`` (k at
    most their total count): the rank's best k are gathered, which hold
    the global best k. Returned as a 0-d tensor, to be compared with
    ``>=`` (ties kept, as in ``models/rpn.py``)."""
    if not distributed():
        return top_k(values, k)[0][-1]
    best = top_k(values, min(k, values.shape[0]))[0]
    return top_k(gather_rows(best), k)[0][-1]


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch, each rank holding an equal
    share of its items: ``x.mean()`` at world 1, else the rank's sum over
    the global count (summed over the ranks it is the mean)."""
    if not distributed():
        return x.mean()
    return x.sum() / (x.numel() * get_world_size())


def all_reduce_grads_(tensors) -> None:
    """Sum the gradients of ``tensors`` (every one set, one dtype) over the
    ranks in place, in one bucket; nothing at world 1."""
    if not distributed():
        return
    grads = [t.grad for t in tensors]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)])
