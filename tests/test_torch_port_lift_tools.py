"""The learning tools end to end on the CPU (``--device cpu``) at 64 px.

``mmt_psm_tpu_torch/tools/{mt_lift_experiment,eval_lift_checkpoint,
synthetic_convergence,pseudo_label_probe}.py`` in a few iterations each,
at batch 2, their proposal counts cut to ``TOOL_SMALL`` and the held-out
split to 1 of its 8 slides (a forward of the lift's 512 proposals an image through
the CPU's plain ROIAlign takes ~10 s a batch on one thread); checkpoints
under a temporary directory (``tempfile.tempdir``):

* the lift tool's sup and mt arms write a JSON with exactly the JAX
  script's keys (each arm's as in experiments/lift_v4_seed1.json, meta's
  as scripts/mt_lift_experiment.py:301-314 writes them), the final student
  and teacher saves, finite numbers;
* a run cut by an exception after its save at iteration 2, started again,
  resumes at iteration 3 and ends at the last iteration with the same
  final weights and numbers as a straight run whose source loader replays
  its first batches after the third, as a resumed loop does;
* ``eval_lift_checkpoint`` on the arm's saves gives the arm's numbers
  exactly;
* ``synthetic_convergence`` and ``pseudo_label_probe`` run and write their
  JAX keys;
* in a fresh interpreter that cannot import ``jax`` or the JAX package,
  the four tools and every module of the port import, and none of them
  loads either.
"""

import ast
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu_torch.data.pap import synthetic_slide_dataset
from mmt_psm_tpu_torch.engine import trainer as T
from mmt_psm_tpu_torch.tools import eval_lift_checkpoint as E
from mmt_psm_tpu_torch.tools import mt_lift_experiment as L
from mmt_psm_tpu_torch.tools import pseudo_label_probe as PP
from mmt_psm_tpu_torch.tools import synthetic_convergence as C

U.setup_torch()

TOOLS = ("mt_lift_experiment", "synthetic_convergence", "eval_lift_checkpoint", "pseudo_label_probe")
TOOL_SMALL = dict(pre_nms_top_n_train=64, pre_nms_top_n_test=64, post_nms_top_n_train=64, post_nms_top_n_test=64,
                  fpn_post_nms_top_n_train=64, fpn_post_nms_top_n_test=64, box_batch_per_image=32, mask_max_pos=16,
                  detections_per_img=32)
HELD_OUT_SLIDES = 1
SIZE = "64"
BATCH = ["--batch", "2"]
LIFT = ["--size", SIZE, "--iters", "4", "--start-mt", "2", "--unlabeled-patches", "8", "--ckpt-period", "2",
        "--sharpen", "--hard-neg", "--device", "cpu"] + BATCH
ARM_KEYS = {"AJI_cyto", "AJI_nuclei", "mAP_all", "AP50_all", "F1_nuclei"}
META_KEYS = {"seed", "size", "canvas", "iters", "start_mt", "lambda", "alpha", "fg_hint", "train_ratio",
             "labeled_windows", "unlabeled_patches", "total_seconds"}
CONVERGENCE_KEYS = {"iters", "train_seconds", "sec_per_iter", "AJI", "F1", "mAP_all", "AP50_all",
                    "eval_images_per_sec"}
PROBE_KEYS = {"iters", "precision", "recall", "n_gt", "n_det", "mean_score_tp", "mean_score_fp", "by_score_thresh"}


def _held_out(size: int):
    return synthetic_slide_dataset(seed=99, num_slides=HELD_OUT_SLIDES, slide_size=2 * size, win_size=size,
                                   overlap=0.0, is_train=False)


@pytest.fixture
def small(monkeypatch, tmp_path):
    for k, v in TOOL_SMALL.items():
        monkeypatch.setitem(L.LIFT_MODEL, k, v)
    monkeypatch.setattr(L, "held_out", _held_out)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    yield tmp_path
    # a resume payload of the lift's model is ~0.5 GB
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def lift_run(tmp_path_factory):
    """The lift tool's sup and mt arms: (results, the JSON it wrote, the
    checkpoint root)."""
    root = tmp_path_factory.mktemp("lift")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in TOOL_SMALL.items():
            mp.setitem(L.LIFT_MODEL, k, v)
        mp.setattr(L, "held_out", _held_out)
        mp.setattr(tempfile, "tempdir", str(root))
        out = str(root / "lift.json")
        # no save before the final one: the resume test makes one
        results = L.main(LIFT + ["--arms", "sup,mt", "--tag", "e2e", "--ckpt-period", "0", "--out", out])
    with open(out) as f:
        written = json.load(f)
    yield results, written, root
    shutil.rmtree(root, ignore_errors=True)


def _finite(tree):
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    return isinstance(tree, (int, float)) and math.isfinite(tree)


def test_lift_tool_writes_the_jax_keys(lift_run):
    results, written, root = lift_run
    assert written == results
    with open(os.path.join(U.REPO, "experiments", "lift_v4_seed1.json")) as f:
        jax_run = json.load(f)
    assert set(written) == {"sup_student", "mt_student", "mt_teacher", "meta"} == set(jax_run)
    for arm in ("sup_student", "mt_student", "mt_teacher"):
        assert set(written[arm]) == ARM_KEYS == set(jax_run[arm]), arm
        assert _finite(written[arm]) and all(v == round(v, 4) for v in written[arm].values()), written[arm]
    assert set(written["meta"]) == META_KEYS
    assert written["meta"]["labeled_windows"] == 4 and written["meta"]["unlabeled_patches"] == 8
    saves = {arm: sorted(f for f in os.listdir(root / f"mt_lift_{arm}_e2e") if f.endswith(".pth"))
             for arm in ("sup", "mt")}
    assert "sup_final_student.pth" in saves["sup"] and "sup_final_teacher.pth" not in saves["sup"]
    assert saves["mt"] == ["model_final.pth", "mt_final_student.pth", "mt_final_teacher.pth", "t_model_final.pth"]


def test_eval_lift_checkpoint_gives_the_arms_numbers(lift_run, small):
    results, _, root = lift_run
    saves = [str(root / "mt_lift_sup_e2e" / "sup_final_student"), str(root / "mt_lift_mt_e2e" / "mt_final_student"),
             str(root / "mt_lift_mt_e2e" / "mt_final_teacher.pth")]
    out = str(small / "eval.json")
    scored = E.main(saves + ["--size", SIZE, "--out", out, "--device", "cpu"] + BATCH)
    assert scored == {"sup_final_student": results["sup_student"], "mt_final_student": results["mt_student"],
                      "mt_final_teacher": results["mt_teacher"]}
    with open(out) as f:
        assert json.load(f) == scored
    with pytest.raises(ValueError, match="orbax"):
        L.load_saved_weights(str(root / "mt_lift_mt_e2e"))


class Cut(Exception):
    pass


def test_cut_run_resumes_to_the_straight_runs_weights(small, monkeypatch):
    argv = LIFT + ["--arms", "sup"]
    loops, starts = [], []
    real_train_arm, real_save, real_resume = L.train_arm, T.MTTrainer.save, T.MTTrainer.resume

    def train_arm(*a):
        loops.append(real_train_arm(*a))
        return loops[-1]

    def resume(self):
        starts.append(real_resume(self))
        return starts[-1]

    def cutting_save(self, iteration, final=False):
        real_save(self, iteration, final)
        if iteration == 2 and not final:
            raise Cut(iteration)

    monkeypatch.setattr(L, "train_arm", train_arm)
    monkeypatch.setattr(T.MTTrainer, "resume", resume)
    with monkeypatch.context() as mp:
        mp.setattr(T.MTTrainer, "save", cutting_save)
        with pytest.raises(Cut):
            L.main(argv + ["--tag", "cut", "--out", str(small / "cut.json")])
    resumed = L.main(argv + ["--tag", "cut", "--out", str(small / "resumed.json")])
    assert starts == [0, 3] and loops[-1].steps.iteration == 4

    # the straight run: the source loader replays its first batches after
    # the third, as the resumed loop's fresh loader does
    real_loaders = L.arm_loaders

    def replaying(*a):
        src, unl = real_loaders(*a)
        return itertools.chain(itertools.islice(src, 3), real_loaders(*a)[0]), unl

    monkeypatch.setattr(L, "arm_loaders", replaying)
    straight = L.main(argv + ["--tag", "straight", "--out", str(small / "straight.json")])
    assert starts[-1] == 0 and loops[-1].steps.iteration == 4
    assert resumed == {**straight, "meta": {**straight["meta"], "total_seconds": resumed["meta"]["total_seconds"]}}
    got = L.load_saved_weights(str(small / "mt_lift_sup_cut" / "sup_final_student"))
    want = L.load_saved_weights(str(small / "mt_lift_sup_straight" / "sup_final_student"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_convergence_and_probe_write_their_jax_keys(small):
    out = str(small / "conv.json")
    conv = C.main(["--iters", "2", "--size", SIZE, "--out", out, "--device", "cpu"] + BATCH)
    with open(out) as f:
        assert json.load(f) == conv
    assert set(conv) == CONVERGENCE_KEYS and conv["iters"] == 2
    assert set(conv["AJI"]) == set(conv["F1"]) == {"1", "2"} and _finite(conv)

    out = str(small / "probe.json")
    probe = PP.main(["--iters", "2", "--size", SIZE, "--out", out, "--device", "cpu"] + BATCH)
    with open(out) as f:
        assert json.load(f) == probe
    assert set(probe) == PROBE_KEYS and probe["iters"] == 2
    assert set(probe["by_score_thresh"]) == {"0.05", "0.3", "0.5", "0.7"}
    assert probe["n_gt"] > 0 and _finite(probe)


def test_tools_import_no_jax():
    """Every import statement of the four tools names the standard library,
    numpy, torch or the port; in an interpreter where ``jax``, ``flax`` and
    the JAX package cannot be imported, every module of the port imports
    and none of the three is loaded."""
    allowed = {"argparse", "copy", "json", "math", "os", "tempfile", "time", "subprocess", "numpy", "torch",
               "__future__"}
    for tool in TOOLS:
        with open(os.path.join(U.REPO, "mmt_psm_tpu_torch", "tools", f"{tool}.py")) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert {a.name.split(".")[0] for a in node.names} <= allowed, (tool, ast.dump(node))
            elif isinstance(node, ast.ImportFrom):
                assert node.level > 0 or node.module.split(".")[0] in allowed, (tool, ast.dump(node))
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'flax', 'mmt_psm_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import mmt_psm_tpu_torch\n"
        "for m in pkgutil.walk_packages(mmt_psm_tpu_torch.__path__, 'mmt_psm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"for tool in {TOOLS!r}:\n"
        "    assert 'mmt_psm_tpu_torch.tools.' + tool in sys.modules, tool\n"
        "loaded = [n for n, m in sys.modules.items() if m is not None and n.split('.')[0] in ('jax', 'flax', "
        "'mmt_psm_tpu')]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=U.REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
