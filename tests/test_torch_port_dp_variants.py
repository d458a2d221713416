"""Every model variant's supervised step at two gloo ranks against one
process, on the CPU (``mmt_psm_tpu_torch/models/variants.py``).

Each variant's graph at the parity tests' small size
(``torch_port_variants.variant_configs``: a 128 canvas in float32, the
train counts of TRAIN_SMALL, fewer RoIs for C4 and PRCNN), weights from
seed 0, the global batch ``generate_batch(0, 2, ...)`` (6 and 8 gt), one
image a rank, every draw from the step's generator. One spawn of two ranks
runs every variant's step at W = 2 and, beside it, its W = 1 reference on
the global batch (``torch_port_dist.steps_rank``), with PyTorch's own CPU
convolution: the losses within 2e-5 relative, the updated parameters within
``rtol=1e-4, atol=1e-7``, the ranks bit-identical.
"""

import pytest

import torch_port_dist as D
import torch_port_util as U
from mmt_psm_tpu_torch.data.synthetic import generate_batch
from mmt_psm_tpu_torch.models.variants import VARIANTS
from torch_port_variants import variant_configs

U.setup_torch()

NAMES = tuple(VARIANTS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    labeled = generate_batch(0, 2, image_size=128, max_instances=U.MAX_GT)
    jobs = {name: {"build": {"variant": name, "config": variant_configs(name, train=True)[1]}, "labeled": labeled,
                   "iteration": 0} for name in NAMES}
    checks = {name: i % 2 for i, name in enumerate(NAMES)}
    return D.run_world(D.steps_rank, 2, tmp_path_factory.mktemp("dp_variants"), args=(jobs, checks), timeout=900)


@pytest.mark.parametrize("name", NAMES)
def test_variant_step_two_ranks_equal_one_process(ranks, name):
    res = [r[name] for r in ranks if "ref_losses" in r[name]]
    assert len(res) == 1
    res = res[0]
    assert set(res["losses"]) == set(res["ref_losses"]) and len(res["losses"]) >= 3
    rel = D.loss_rel(res["losses"], res["ref_losses"])
    assert max(rel.values()) <= D.LOSS_RTOL, rel
    assert res["params_excess"][0] <= 0, res["params_excess"]
    assert ranks[0][name]["identical"] and ranks[1][name]["identical"]
    assert ranks[0][name]["losses"] == ranks[1][name]["losses"]
