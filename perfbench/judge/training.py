"""Whether the training steps are those of the plain reference.

The program's first three steps were taken in set-up through the window's
own call and feed, on three different batches. The reference
(``perfbench/reference``, the configuration's precision, the plain NMS and
ROIAlign forward and backward) is built from the same seed, takes the same
three steps on the same batches with its own generator seeded alike (so
the same sampling and dropout draws), and these numbers compare them:

* ``first_loss_gap``: the gap of the first step's total loss, over the
  reference's.
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as each optimizer got it (its momentum buffer after one step
  less the weight decay's term), over the larger of that leaf's reference
  norm and the median leaf's.
* ``change_gap``: the same of each leaf's change after the three steps.
* ``total_change_gap``: the gap between the norms of the whole change
  after the three steps, all kept leaves together, over the reference's:
  steady where the worst and the median leaf swing with rounding. In the
  flagship, relation-NMS embeds each pair of boxes by sin and cos of
  100 x log |centre gap / width| (the gap floored at 1e-3), so a rounding of
  a near-duplicate box's centre turns the phase, and the gradient that
  flows back through it into the box regression outweighs every other leaf's
  and sets the clip of each; the clip holds each step's whole gradient at
  CLIP_GRAD_NORM all the same.

Leaves whose reference gradient is under a thousandth of the median leaf's
(rounding, such as the MGD adaptor's in a supervised step) are left out of
both. In a mean-teacher cell the reference's teacher takes, at each step, the
pseudo-labels (detections and mask probabilities) that the followed
trainer's teacher made: which proposals a random-weight teacher keeps turns
on float rounding (a K2 rounding reorders relation-NMS's near-ties), and
everything after the pseudo-labels follows them. The stage this skips is
checked by itself at the first step, where both teachers hold the same
weights: ``pseudo_unmatched`` and ``pseudo_mask_gap`` are the serving
judge's ``unmatched`` and ``mask_gap`` (``judge/detections.py``) of the
followed teacher's pseudo-labels against the reference teacher's own.

A number is compared only where the cell's file gives it a limit.
"""

from __future__ import annotations

import contextlib
import statistics
import sys

import torch

from ..harness.weights import STEP_STREAM, fill, generator
from ..reference.build import reference_model, train_cfg, train_model_config

EXCLUDE_BELOW = 1e-3


def reference_trainer(run, lower=None):
    """The reference's trainer of ``run``'s cell; ``lower`` (a function of
    the network) puts the network in the control's precision."""
    from ..reference.train.mean_teacher import MTTrainer, teacher_of
    from ..reference.train.supervised import Trainer

    cfg = train_cfg(run.conf, run.w["train_opts"])
    net = fill(reference_model(train_model_config(run.conf, cfg), run.dev), run.seed, run.conf["init"])
    if lower is not None:
        lower(net)
    gen = generator(run.seed, STEP_STREAM, run.dev)
    if not run.MT:
        return Trainer(net, cfg, gen)
    tr = MTTrainer(net, teacher_of(net), cfg, gen)
    tr.iteration = run.w["iteration"]
    return tr


def _plain_name(name: str) -> str:
    """A parameter's name without the control's parametrization in it."""
    return name.replace("parametrizations.", "").replace(".original", "")


@contextlib.contextmanager
def recording_pseudo_labels(tr, out: list):
    """Append to ``out`` the pseudo-labels (detached detections) that
    ``tr``'s teacher makes while the context is open."""
    teacher = getattr(tr, "teacher", None)
    if teacher is None:
        yield out
        return
    own = teacher.detections_from_features

    def recorded(*args, **kwargs):
        d = own(*args, **kwargs)
        out.append({k: getattr(d, k).detach().clone() for k in ("boxes", "scores", "labels", "valid", "masks")})
        return d

    teacher.detections_from_features = recorded
    try:
        yield out
    finally:
        del teacher.detections_from_features


def _rows(d: dict, n: int) -> dict:
    """Pseudo-labels cut or padded (with invalid rows) to ``n`` images: a
    faulty trainer may have labelled fewer."""
    if d["boxes"].shape[0] == n:
        return d
    out = {}
    for k, v in d.items():
        pad = torch.zeros((max(n - v.shape[0], 0), *v.shape[1:]), dtype=v.dtype, device=v.device)
        out[k] = torch.cat([v[:n], pad])
    return out


@contextlib.contextmanager
def following_pseudo_labels(tr, given: list, tally):
    """The reference teacher takes the ``given`` pseudo-labels, step by
    step; at the first step ``tally`` judges them against its own."""
    from ..reference import serve as RS
    from ..reference.structures.detections import Detections

    teacher, step = tr.teacher, [0]
    own = teacher.detections_from_features

    def followed(features, sizes, images=None):
        d = _rows(given[step[0]], sizes.shape[0])
        if step[0] == 0:
            mine = own(features, sizes, images)
            tf = RS.masks_on(teacher, features, d["boxes"], d["labels"], d["valid"])
            served = tuple(d[k].float().cpu().numpy() if k in ("boxes", "scores", "masks") else d[k].cpu().numpy()
                           for k in ("boxes", "scores", "labels", "valid", "masks"))
            ref = tuple(x.cpu().numpy() for x in (mine.boxes, mine.scores, mine.labels, mine.valid))
            tally.add(served, ref, tf.float().cpu().numpy())
        step[0] += 1
        return Detections(**d)

    teacher.detections_from_features = followed
    try:
        yield
    finally:
        del teacher.detections_from_features


def follow(run, tr, steps: int, given=None, tally=None) -> dict:
    """``steps`` steps of trainer ``tr`` on ``run``'s first batches: the
    initial weights, the losses, the first step's momentum buffers, the
    weights after the last step, by parameter name, and a mean teacher's
    pseudo-labels; with ``given``, ``tr``'s teacher takes those instead
    (``following_pseudo_labels``)."""
    names = {id(p): _plain_name(n) for n, p in tr.model.named_parameters()}
    params = [p for group in tr.optimizer.param_groups for p in group["params"]]
    before = {names[id(p)]: p.detach().cpu().clone() for p in params}
    losses, buffers, pseudo = [], None, []
    ctx = following_pseudo_labels(tr, given, tally) if given is not None else recording_pseudo_labels(tr, pseudo)
    with ctx:
        for i in range(steps):
            out = run.call(tr, run.feed(i))
            losses.append(float(out["loss_total"]))
            if i == 0:
                buffers = momentum_buffers(tr, params, names)
    after = {names[id(p)]: p.detach().cpu().clone() for p in params}
    rec = {"before": before, "losses": losses, "buffers": buffers, "after": after, "pseudo": pseudo}
    if getattr(tr, "teacher", None) is not None:
        rec["teacher"] = teacher_weights(tr, set(after))
    return rec


def teacher_weights(tr, names) -> dict:
    """The EMA teacher's copies of the student's trained weights."""
    return {n: t.detach().cpu().clone() for n, t in
            ((_plain_name(k), v) for k, v in tr.teacher.named_parameters()) if n in names}


def momentum_buffers(tr, params, names) -> dict:
    """The first gradient as the optimizer got it, by parameter name: SGD's
    momentum buffer after one step holds gradient + weight decay x weight
    (zeros where the optimizer holds none: it never stepped)."""
    out = {}
    for p in params:
        buf = tr.optimizer.state.get(p, {}).get("momentum_buffer")
        out[names[id(p)]] = torch.zeros(p.shape) if buf is None else buf.detach().cpu().clone()
    return out


def _leaf_gaps(got: dict, want: dict, keep) -> list:
    """Each kept leaf's gap of norms over max(its reference norm, the median leaf's)."""
    med = statistics.median(want.values())
    return [abs(got[n] - want[n]) / max(want[n], med) for n in keep]


def gaps(prog: dict, ref: dict, weight_decay) -> dict:
    """The gaps of a followed program (or control) against the followed
    reference: each step's loss gap (``loss``), each kept leaf's gap by
    quantity (``grad``, ``change``, ``teacher_change``), the gap of the norm
    of the kept leaves' whole change (``total_change``), and the count of
    leaves left out; ``weight_decay(name)`` is a leaf's decay."""
    p0 = ref["before"]
    grad = lambda r: {n: float((b - weight_decay(n) * p0[n]).norm()) for n, b in r["buffers"].items()}  # noqa: E731
    change = lambda r: {n: float((a - p0[n]).norm()) for n, a in r["after"].items()}  # noqa: E731
    g_ref, g_prog = grad(ref), grad(prog)
    med = statistics.median(g_ref.values())
    keep = [n for n, v in g_ref.items() if v >= EXCLUDE_BELOW * med]
    leaves = {"grad": _leaf_gaps(g_prog, g_ref, keep), "change": _leaf_gaps(change(prog), change(ref), keep)}
    if "teacher" in ref:
        t_change = lambda r: {n: float((t - p0[n]).norm()) for n, t in r["teacher"].items()}  # noqa: E731
        leaves["teacher_change"] = _leaf_gaps(t_change(prog), t_change(ref), keep)
    c_ref, c_prog = change(ref), change(prog)
    total = lambda c: sum(c[n] ** 2 for n in keep) ** 0.5  # noqa: E731
    return {"loss": [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])], "leaves": leaves,
            "total_change": abs(total(c_prog) - total(c_ref)) / total(c_ref), "left_out": len(g_ref) - len(keep)}


def numbers(prog: dict, ref: dict, weight_decay) -> dict:
    """The numbers of a followed program (or control) against the followed
    reference: the first step's loss gap, the worst leaf's gaps of the first
    gradient and of the change, and the gap of the whole change's norm."""
    g = gaps(prog, ref, weight_decay)
    return {"first_loss_gap": g["loss"][0], "grad_gap": max(g["leaves"]["grad"]),
            "change_gap": max(g["leaves"]["change"]), "total_change_gap": g["total_change"],
            "leaves_left_out": g["left_out"]}


def decay_of(run):
    cfg = train_cfg(run.conf, run.w["train_opts"])
    s = cfg.SOLVER
    return lambda n: s.WEIGHT_DECAY_BIAS if n.endswith(".bias") else s.WEIGHT_DECAY


def program_record(run) -> dict:
    rec = {"losses": run.losses, "buffers": run.first_buffers, "after": run.after, "pseudo": run.pseudo}
    if run.teacher_after is not None:
        rec["teacher"] = run.teacher_after
    return rec


def reference_record(run, lower=None, given=None, tally=None) -> dict:
    """The reference (``lower``: the control) followed over ``run``'s first
    steps; in a mean-teacher cell its teacher takes ``given`` pseudo-labels."""
    tr = reference_trainer(run, lower)
    rec = follow(run, tr, len(run.losses), given if run.MT else None, tally)
    del tr
    return rec


def judged(rec: dict, run) -> tuple:
    """(The numbers of a followed trainer's record ``rec`` against the
    reference, which follows its pseudo-labels; the reference's record.)"""
    from .detections import Tally

    tally = Tally()
    ref = reference_record(run, given=rec["pseudo"], tally=tally)
    nums = numbers(rec, ref, decay_of(run))
    if run.MT:
        pn = tally.numbers()
        nums.update(pseudo_unmatched=pn["unmatched"], pseudo_mask_gap=pn["mask_gap"])
    return nums, ref


def check(run, spec) -> dict:
    """{number: (value, limit)} of the numbers the cell's ``check`` limits;
    every number is printed to standard error as a reading."""
    nums, ref = judged(program_record(run), run)
    print(f"reading over {len(run.losses)} steps: losses {run.losses} reference {ref['losses']}: " +
          " ".join(f"{k}={v!r}" for k, v in nums.items()), file=sys.stderr)
    return {k: (nums[k], lim) for k, lim in spec["limits"].items()}
