"""Random weights of a configuration, made on the device from the seed.

One draw of normals and one of uniforms cover every parameter (in the
order of their names), and each parameter takes its slice, scaled by the
first rule of the configuration's ``init`` list whose ``match`` pattern it
meets. The program and the reference have the same parameter names and
shapes, so the same seed gives both the same weights. Buffers (the frozen
batch norms' statistics, the anchors) keep the values the model is built
with.
"""

from __future__ import annotations

import re

import torch

# the named random streams of a run's seed: the weights, the traffic, the
# check's sample of served batches, a training step's own draws
WEIGHT_STREAM, TRAFFIC_STREAM, SAMPLE_STREAM, STEP_STREAM = 1, 2, 3, 4


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of a run's seed; any
    whole number is a seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + stream) % (1 << 63))


def _rule(name: str, rules: list) -> dict:
    for r in rules:
        if re.search(r["match"], name):
            return r
    raise ValueError(f"no init rule matches parameter {name}")


@torch.no_grad()
def fill(model: torch.nn.Module, seed: int, rules: list) -> torch.nn.Module:
    params = sorted(model.named_parameters(), key=lambda kv: kv[0])
    dev = params[0][1].device
    total = sum(p.numel() for _, p in params)
    gen = generator(seed, WEIGHT_STREAM, dev)
    normal = torch.randn(total, generator=gen, device=dev)
    uniform = torch.rand(total, generator=gen, device=dev)
    at = 0
    for name, p in params:
        n = p.numel()
        r = _rule(name, rules)
        z, u = normal[at:at + n].view_as(p), uniform[at:at + n].view_as(p)
        at += n
        if "normal" in r:
            p.copy_(z * r["normal"])
        elif "normal_centred" in r:
            # zero mean along the input axis: no common offset over inputs that
            # share a sign, such as a ReLU's outputs
            p.copy_((z - z.mean(dim=-1, keepdim=True)) * r["normal_centred"])
        elif "normal_fan_in" in r:
            # fan in of a conv [out, in, k, k] or linear [out, in]; a transposed
            # conv [in, out, k, k] takes its output side, as flax's fans swap
            p.copy_(z * (r["normal_fan_in"] / (n // p.shape[0])) ** 0.5)
        elif "uniform" in r:
            lo, hi = r["uniform"]
            p.copy_(lo + (hi - lo) * u)
        elif "constant" in r:
            p.fill_(r["constant"])
        elif r.get("zeros"):
            p.zero_()
        else:
            raise ValueError(f"init rule {r} names no distribution")
    return model
