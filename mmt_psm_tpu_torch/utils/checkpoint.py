"""Checkpoints on ``torch.save`` (the port's copy of
``mmt_psm_tpu/utils/checkpoint.py``, which writes orbax trees; after the
reference's maskrcnn_benchmark/utils/checkpoint.py:13-205).

``save(name, tree)`` writes ``<dir>/<name>.pth`` through a temporary file
and ``os.replace``, then the ``last_checkpoint`` tag file naming it;
``load(name=None)`` reads a name, or the tagged latest, with
``torch.load(weights_only=True)``. A tree is a dict of tensors, numbers and
nested dicts and lists; the model's weights sit under ``"model"`` as its
``state_dict`` in maskrcnn-benchmark names, as the reference's checkpoints
hold them. Students are saved as ``model_<iteration:07d>`` (and
``model_final``), teachers as ``t_model_*`` (MTtrainer.py:231-239).

``training_state`` is a train step object's resume payload (the JAX
``engine/trainer.py:168-178`` saves params, opt_state, step and teacher):
the student's ``state_dict`` under ``"model"``, the optimizer's and the
LambdaLR's ``state_dict``, ``Trainer.iteration``, the teacher's
``state_dict`` and the step generator's state. The generator is there
because JAX derives each step's draws from a fixed key and the step, while
a ``torch.Generator`` advances with every draw: without its state a resumed
run would draw other dropout masks and samples than a straight one.
``restore_training_state`` loads such a payload back in place.

In a process group only rank 0 writes; every rank then waits at a barrier
in ``save``, so a rank that loads next finds the file complete.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from ..parallel import comm

TAG_FILE = "last_checkpoint"


class Checkpointer:
    def __init__(self, output_dir: str):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)

    def _tag_file(self) -> str:
        return os.path.join(self.output_dir, TAG_FILE)

    def path(self, name: str) -> str:
        return os.path.join(self.output_dir, f"{name}.pth")

    def save(self, name: str, tree: Any, tag: bool = True) -> str:
        """Save ``tree`` under ``name`` (e.g. model_0000100); with ``tag``,
        point ``last_checkpoint`` at it. Rank 0 writes, every rank returns
        after it has."""
        path = self.path(name)
        if comm.is_main_process():
            _write_atomic(path, lambda f: torch.save(tree, f))
            if tag:
                _write_atomic(self._tag_file(), lambda f: f.write(name.encode()))
        comm.synchronize()
        return path

    def has_checkpoint(self) -> bool:
        return os.path.exists(self._tag_file())

    def last_name(self) -> str | None:
        if not self.has_checkpoint():
            return None
        with open(self._tag_file()) as f:
            return f.read().strip()

    def names(self) -> list[str]:
        """The student and teacher checkpoints in the directory, in name order."""
        stems = (f[: -len(".pth")] for f in os.listdir(self.output_dir) if f.endswith(".pth"))
        return sorted(n for n in stems if n.startswith(("model_", "t_model_")))

    def load(self, name: str | None = None) -> Any:
        """The tree saved under ``name``, or under the tagged latest; its
        tensors on the CPU."""
        name = name or self.last_name()
        if name is None:
            raise FileNotFoundError(f"no checkpoint in {self.output_dir}")
        return torch.load(self.path(name), map_location="cpu", weights_only=True)


def _write_atomic(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def training_state(trainer) -> dict:
    """The resume payload of a ``train.Trainer`` (or ``MTTrainer``)."""
    return {
        "model": trainer.model.state_dict(),
        "optimizer": trainer.optimizer.state_dict(),
        "scheduler": trainer.scheduler.state_dict(),
        "iteration": trainer.iteration,
        "teacher": trainer.teacher.state_dict() if trainer.teacher is not None else None,
        "generator": trainer.gen.get_state(),
    }


def restore_training_state(trainer, state: dict) -> None:
    """Load a ``training_state`` payload into ``trainer`` in place.

    ``load_state_dict`` copies into the existing tensors (never
    ``assign=True``): ``Trainer.clip_tensors``, ``trainable``, ``ema_pairs``
    and the optimizer hold references to them. The optimizer is loaded after
    the model; the LambdaLR's ``last_epoch`` (the learning rate's count) and
    ``Trainer.iteration`` (the MT gate's, the ramp's and the EMA's) both come
    back."""
    trainer.model.load_state_dict(state["model"])
    if trainer.teacher is not None:
        trainer.teacher.load_state_dict(state["teacher"])
    trainer.optimizer.load_state_dict(state["optimizer"])
    trainer.scheduler.load_state_dict(state["scheduler"])
    trainer.iteration = int(state["iteration"])
    trainer.gen.set_state(state["generator"])


def load_model_weights(model: torch.nn.Module, state: dict) -> None:
    """Copy a checkpoint's ``"model"`` state_dict into ``model`` in place.
    Every tensor of the model must be there; the MGD hint adaptor of a
    train-mode checkpoint is skipped where the model has none (a test-time
    model builds no adaptor)."""
    own = model.state_dict()
    extra = [k for k in state if k not in own and not k.startswith("hint_adaptor.")]
    missing = [k for k in own if k not in state]
    if extra or missing:
        raise KeyError(f"checkpoint does not fit the model: missing {missing[:5]}, unexpected {extra[:5]}")
    model.load_state_dict({k: v for k, v in state.items() if k in own})
