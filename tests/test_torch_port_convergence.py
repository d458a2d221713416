"""The from-scratch convergence gate of the port (tests/test_convergence.py's,
on the port's tool).

Runs ``python -m mmt_psm_tpu_torch.tools.synthetic_convergence --iters
1000`` in a fresh process on the card: 1000 supervised iterations from the
seeded init on synthetic overlapping cells must reach the JAX gate's
thresholds, unchanged: AJI of the nuclei (class 2) at least 0.4 and AP50
at least 0.5. Marked ``slow`` and ``gpu``: it skips without a card. On a
GPU host: ``python -m pytest tests/test_torch_port_convergence.py -m "slow and gpu" --noconftest -s``;
the JSON and the tool's output are kept in the test's temporary directory.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = [pytest.mark.slow, pytest.mark.gpu]


def test_synthetic_convergence_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: training runs through the port's kernels")
    out = str(tmp_path / "conv.json")
    with open(tmp_path / "conv.log", "w") as log:
        proc = subprocess.run([sys.executable, "-m", "mmt_psm_tpu_torch.tools.synthetic_convergence", "--iters",
                               "1000", "--out", out], cwd=REPO, timeout=1800, stdout=log, stderr=subprocess.STDOUT)
    assert proc.returncode == 0, open(tmp_path / "conv.log").read()[-2000:]
    with open(out) as f:
        data = json.load(f)
    print(json.dumps(data))
    assert data["iters"] == 1000
    assert float(data["AJI"]["2"]) >= 0.4, data
    assert float(data["AP50_all"]) >= 0.5, data
