"""The lift tool's set-up and the port's seeded init against the JAX side.

* The JAX script's own ``main()`` (``scripts/mt_lift_experiment.py``,
  unedited) runs on the CPU with its model, init and scoring stubbed and
  its trainer replaced by a recorder, at 64 px with every arm: each arm's
  config keys, its loaders' first two batches and the held-out windows must
  equal those of the port's tool (``arm_config``, ``arm_loaders``,
  ``val_loader``): configs and arrays identical, the held-out images after
  the device stage's normalization bit-equal to JAX's normalized windows.
* ``init_model`` (the port's seeded ``init_weights``) against the JAX
  ``init_all`` parameters of the lift's graph with the hint adaptor, tensor
  by tensor: the same shapes; constant tensors (the FrozenBN statistics,
  the biases) equal; a random tensor of at least 4096 elements within 5% of
  JAX's standard deviation, with JAX's distribution's kurtosis (uniform or
  normal) within 0.15; a uniform one within 2% of JAX's bound.
"""

import glob
import shutil
import types
import uuid

import numpy as np
import pytest
import torch

import torch_port_lift as PL
import torch_port_util as U
from mmt_psm_tpu_torch.engine.inference import DeviceStage
from mmt_psm_tpu_torch.tools import mt_lift_experiment as L
from mmt_psm_tpu_torch.train.mt_step import MTConfig
from torch_port_variants import to_jax_flat

U.setup_torch()

SIZE = 64
ARGV = ["--size", str(SIZE), "--iters", "8", "--start-mt", "4", "--unlabeled-patches", "8", "--oracle-slides", "1",
        "--arms", "sup,mt,odkd,psm,mgd,oracle", "--sharpen", "--hard-neg"]
BATCHES = 2


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Every arm of the JAX script's ``main()``: (arm, cfg, source batches,
    unlabeled batches or None) in its order, and the held-out batches."""
    import mmt_psm_tpu.engine.trainer as jtrainer
    import mmt_psm_tpu.utils.checkpoint as jckpt
    import mmt_psm_tpu.utils.env as jenv

    script = PL.jax_script("mt_lift_experiment")
    tag = f"torchport{uuid.uuid4().hex[:8]}"
    out = str(tmp_path_factory.mktemp("jax_lift") / "lift.json")
    arms, held_out = [], []

    class Recorder:
        def __init__(self, model, params, cfg, src, unl, output_dir="."):
            arms.append((output_dir, cfg, _take(src, BATCHES), None if unl is None else _take(unl, BATCHES)))

        def resume(self):
            return 0

        def train(self, start_iter=0):
            return types.SimpleNamespace(params={}, teacher_params={})

    class NoSave:
        def __init__(self, *a, **k):
            pass

        def save(self, *a, **k):
            pass

    def evaluate(model, params, loader):
        held_out.append(list(loader))
        return {}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(script, "build_model", lambda size, with_hint=False: (None, None))
        mp.setattr(script, "init_params", lambda model, batch0, seed=0: {})
        mp.setattr(script, "evaluate", evaluate)
        mp.setattr(jtrainer, "MTTrainer", Recorder)
        mp.setattr(jckpt, "Checkpointer", NoSave)
        mp.setattr(jenv, "enable_persistent_compilation_cache", lambda *a, **k: None)
        mp.setattr("sys.argv", ["mt_lift_experiment.py", *ARGV, "--tag", tag, "--out", out])
        try:
            script.main()
        finally:
            for d in glob.glob(f"/tmp/mt_lift_*_{tag}"):
                shutil.rmtree(d, ignore_errors=True)
    return {"arms": arms, "held_out": held_out}


@pytest.fixture(scope="module")
def port_setup():
    args = L.parse_args(ARGV + ["--device", "cpu"])
    train_ds, unlabeled_ds, val_ds = L.lift_data(args)
    return args, train_ds, unlabeled_ds, val_ds


def _same_batches(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), (what, i, sorted(g), sorted(w))
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=f"{what} batch {i} {k}")


def test_every_arm_config_and_loader_match_jax(jax_run, port_setup):
    args, train_ds, unlabeled_ds, _ = port_setup
    arms = L.lift_arms(args, train_ds)
    assert [a for a, _, _ in arms] == ["sup", "mt", "odkd", "psm", "mgd", "oracle"]
    assert len(jax_run["arms"]) == len(arms)
    for (arm, arm_ds, with_mt), (out_dir, jcfg, j_src, j_unl) in zip(arms, jax_run["arms"]):
        assert out_dir.split("/")[-1].startswith(f"mt_lift_{arm}_"), (arm, out_dir)
        cfg = L.arm_config(args, arm)
        for block, keys in PL.ARM_KEYS.items():
            for k in keys:
                got, want = getattr(getattr(cfg, block), k), getattr(getattr(jcfg, block), k)
                assert got == want and type(got) is type(want), (arm, block, k, got, want)
        # the MT step's whole config as each package reads it
        from mmt_psm_tpu.train.mt_step import MTConfig as JaxMTConfig

        assert vars(MTConfig.from_cfg(cfg)) == vars(JaxMTConfig.from_cfg(jcfg)), arm
        src, unl = L.arm_loaders(args, arm_ds, unlabeled_ds, with_mt, SIZE)
        _same_batches(_take(src, BATCHES), j_src, f"{arm} source")
        assert (unl is None) == (j_unl is None) == (not with_mt), arm
        if with_mt:
            batches = _take(unl, BATCHES)
            assert batches[0]["t_images"].shape == (4, 2, SIZE, SIZE, 3)
            assert batches[0]["s_images"].shape == (4, 1, SIZE, SIZE, 3)
            _same_batches(batches, j_unl, f"{arm} unlabeled")


def test_held_out_windows_match_jax(jax_run, port_setup):
    """The JAX script scores normalized float32 windows; the port ships raw
    uint8 canvases and normalizes on the device: the same arrays after the
    device stage's normalization, every gt array identical."""
    args, _, _, val_ds = port_setup
    assert len(val_ds) == 32
    # one held-out loader a score: sup, mt x2, odkd x2, psm x2, mgd x2, oracle
    assert len(jax_run["held_out"]) == 10
    stage = DeviceStage(L.build_model(SIZE)[0])
    for want in jax_run["held_out"]:
        got = list(L.val_loader(args, val_ds, SIZE))
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert g["image"].dtype == np.uint8
            assert sorted(g) == sorted(w)
            for k in w:
                if k == "masks":  # ragged: one array an image
                    assert len(g[k]) == len(w[k])
                    for a, b in zip(g[k], w[k]):
                        np.testing.assert_array_equal(a, b, err_msg=k)
                elif k != "image":
                    np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
            normed = stage.normalize(torch.from_numpy(g["image"]), torch.from_numpy(g["image_size"]))
            np.testing.assert_array_equal(normed.numpy(), w["image"])


def test_seeded_init_matches_jax_initializers():
    jm, _ = PL.lift_configs(SIZE, with_hint=True, dtype="bfloat16")
    from mmt_psm_tpu.models import MaskRCNN as JaxMaskRCNN

    want = PL.jax_init_all(JaxMaskRCNN(config=jm), SIZE)
    model = L.init_model(L.build_model(SIZE, with_hint=True)[0], 0)
    assert model.config.compute_dtype == "bfloat16" and model.config.with_hint_adaptor
    got = to_jax_flat(model, (256, 7, 7))
    assert sorted(got) == sorted(want)
    compared = {"constant": 0, "uniform": 0, "normal": 0}
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        w = w.astype(np.float64)
        g = g.astype(np.float64)
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(g, w, err_msg=key)
            compared["constant"] += 1
            continue
        assert not np.all(g == g.flat[0]), key
        if w.size < 4096:
            continue
        sd_w, sd_g = w.std(), g.std()
        assert abs(sd_g / sd_w - 1) < 0.05, (key, sd_g, sd_w)
        kurt = lambda x: float(((x - x.mean()) ** 4).mean() / x.var() ** 2 - 3)  # noqa: E731
        assert abs(kurt(g) - kurt(w)) < 0.15, (key, kurt(g), kurt(w))
        if kurt(w) < -1.0:  # uniform: the same bound
            assert abs(np.abs(g).max() / np.abs(w).max() - 1) < 0.02, (key, np.abs(g).max(), np.abs(w).max())
            compared["uniform"] += 1
        else:
            compared["normal"] += 1
    assert compared["constant"] > 200 and compared["uniform"] >= 15 and compared["normal"] >= 50, compared
