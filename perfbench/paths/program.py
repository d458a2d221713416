"""The program's configuration tree and model of a benchmark configuration."""

from __future__ import annotations

import os

import torch

from ..harness.spec import ROOT


def program_cfg(conf: dict, opts: dict | None = None):
    """The program's config tree of ``conf`` (its YAML or named variant and
    their overrides), plus the cell's ``KEY.PATH: value`` overrides."""
    from mmt_psm_tpu_torch.models.detector import load_config
    from mmt_psm_tpu_torch.models.variants import variant_config

    prog = conf["program"]
    extra = [x for k, v in (opts or {}).items() for x in (k, str(v))]
    if prog["variant"]:
        return variant_config(prog["variant"], [*prog["opts"], *extra])
    return load_config(os.path.join(ROOT, prog["yaml"]), [*prog["opts"], *extra])


def program_model(conf: dict, device, train: bool = False, opts: dict | None = None):
    """The program's model of ``conf``, parameters on ``device``, unfilled;
    ``train`` builds the training graph (the MGD hint adaptor)."""
    from mmt_psm_tpu_torch.models.detector import MaskRCNN, ModelConfig

    with torch.device(device):
        net = MaskRCNN(ModelConfig.from_cfg(program_cfg(conf, opts), train=train))
    net = net.to(device)
    return net if train else net.eval()
