"""The semi-supervised lift gate of the port (tests/test_mt_lift.py's, on
the port's tool).

Runs ``python -m mmt_psm_tpu_torch.tools.mt_lift_experiment --sharpen
--hard-neg`` (the sup and mt arms at the JAX gate's recipe: 1800
iterations, MT from 400, seed 0) in a fresh process on the card, and holds
the result to the JAX gate's thresholds, unchanged: the mt arm's teacher's
mean AJI over both classes at least the supervised student's + 0.02, its
mAP at least the supervised's - 0.05 and its nuclei F1 at least the
supervised's - 0.03. Marked ``slow`` and ``gpu``: it skips without a card.
On a GPU host: ``python -m pytest tests/test_torch_port_mt_lift.py -m "slow and gpu" --noconftest -s``;
the JSON and the tool's output are kept in the test's temporary directory
(``--basetemp`` names it).
"""

import json
import os
import subprocess
import sys
import tempfile

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = [pytest.mark.slow, pytest.mark.gpu]


def test_mmt_psm_beats_supervised_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lift trains through the port's kernels")
    out = str(tmp_path / "lift.json")
    # the arms' checkpoints (~0.5 GB each) in a directory of their own
    with tempfile.TemporaryDirectory() as ckpts, open(tmp_path / "lift.log", "w") as log:
        proc = subprocess.run([sys.executable, "-m", "mmt_psm_tpu_torch.tools.mt_lift_experiment", "--sharpen",
                               "--hard-neg", "--out", out], cwd=REPO, env=dict(os.environ, TMPDIR=ckpts),
                              timeout=5400, stdout=log, stderr=subprocess.STDOUT)
    assert proc.returncode == 0, open(tmp_path / "lift.log").read()[-3000:]
    with open(out) as f:
        r = json.load(f)
    print(json.dumps(r))
    sup, mt_t = r["sup_student"], r["mt_teacher"]
    mean_aji = lambda a: (a["AJI_nuclei"] + a["AJI_cyto"]) / 2  # noqa: E731
    assert mean_aji(mt_t) >= mean_aji(sup) + 0.02, r
    assert mt_t["mAP_all"] >= sup["mAP_all"] - 0.05, r
    assert mt_t["F1_nuclei"] >= sup["F1_nuclei"] - 0.03, r
