"""Package rules of the port: no JAX, the card by default, its own config.

The import guard runs in a subprocess because this process has imported
JAX already (tests/conftest.py).
"""

import os
import subprocess
import sys

import pytest
import torch
import yaml

import torch_port_util as U
from mmt_psm_tpu_torch.config import get_cfg, load_yaml
from mmt_psm_tpu_torch.models import build_model, resolve_device

GUARD = r"""
import importlib, pkgutil, sys
import mmt_psm_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax", "mmt_psm_tpu"))
print("MODULES", len([k for k in sys.modules if k.startswith("mmt_psm_tpu_torch")]))
print("BAD", bad)
print("SERVING", ",".join(k.split(".", 1)[1] for k in sys.modules if k.startswith("mmt_psm_tpu_torch.")))
"""


def test_import_guard_no_jax():
    env = dict(os.environ, PYTHONPATH=U.REPO)
    out = subprocess.run([sys.executable, "-c", GUARD], capture_output=True, text=True, env=env, cwd=U.REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert lines["BAD"] == "[]"
    assert int(lines["MODULES"]) >= 80  # every module of the package was imported
    serving = ("evaluation.instmask", "evaluation._native", "evaluation.pap_eval", "engine.paste",
               "engine._eval_worker", "engine.inference", "engine.predictor", "data.transforms", "data.loader",
               "data.pap", "data.catalog", "utils.checkpoint", "tools.test_net")
    assert set(serving) <= set(lines["SERVING"].split(","))
    training = ("engine.trainer", "tools.train_mean_teacher", "utils.c2_loading", "utils.model_serialization",
                "utils.logger", "utils.metric_logger")
    assert set(training) <= set(lines["SERVING"].split(","))
    variants = ("models.variants", "models.c4", "models.mask_relation", "models.backbone", "ops.python_nms",
                "ops.matcher", "models.box_head", "models.mask_head")
    assert set(variants) <= set(lines["SERVING"].split(","))
    datasets = ("data.cell", "data.coco", "data.concat", "data.voc", "evaluation.coco_eval", "evaluation.voc_eval",
                "evaluation.dispatch", "utils.segms", "utils.visual", "utils.mat_output", "utils.env",
                "ops.roi_pool", "ops.grad_ops", "tools.webcam", "tools.convert_cityscapes_to_coco")
    assert set(datasets) <= set(lines["SERVING"].split(","))


def test_eval_worker_imports_without_torch():
    """What a spawned eval worker imports: numpy and the C++ library, never
    torch (the package's names load ``models`` lazily)."""
    code = ("import sys, mmt_psm_tpu_torch.engine._eval_worker as w; w.ping(); "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('torch', 'jax', 'mmt_psm_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=U.REPO, timeout=300,
                         env=dict(os.environ, PYTHONPATH=U.REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_import_nothing_of_the_jax_package():
    """A source check: ``mmt_psm_tpu`` is a prefix of ``mmt_psm_tpu_torch``."""
    import re

    pat = re.compile(r"^\s*(from|import)\s+(jax|flax|mmt_psm_tpu(?!_torch))\b", re.M)
    root = os.path.join(U.REPO, "mmt_psm_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    if pat.search(fh.read()):
                        offenders.append(f)
    with open(os.path.join(U.REPO, "chip_smoke.py")) as fh:
        if pat.search(fh.read()):
            offenders.append("chip_smoke.py")
    assert offenders == []


def test_entry_point_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model()
    assert resolve_device("cpu") == torch.device("cpu")


def test_yaml_reader_matches_pyyaml():
    with open(U.FLAGSHIP) as f:
        text = f.read()
    assert load_yaml(text) == yaml.safe_load(text)


def test_flagship_config_matches_jax():
    """The port's ModelConfig.from_cfg reads the flagship YAML as the JAX
    package does: every field the two configs share is equal."""
    import dataclasses

    from mmt_psm_tpu.config import get_cfg as jax_get_cfg
    from mmt_psm_tpu.models import ModelConfig as JaxModelConfig
    from mmt_psm_tpu_torch.models import ModelConfig

    jcfg = jax_get_cfg()
    jcfg.merge_from_file(U.FLAGSHIP)
    jm = JaxModelConfig.from_cfg(jcfg, train=False)
    cfg = get_cfg()
    cfg.merge_from_file(U.FLAGSHIP)
    tm = ModelConfig.from_cfg(cfg)
    shared = [f.name for f in dataclasses.fields(tm) if f.name not in ("relation", "relation_mask")]
    for name in shared:
        assert getattr(tm, name) == getattr(jm, name), name
    assert dataclasses.asdict(tm.relation) == dataclasses.asdict(jm.relation)
    assert dataclasses.asdict(tm.relation_mask) == dataclasses.asdict(jm.relation_mask)
    assert tm.image_size == 1024 and tm.compute_dtype == "bfloat16"


def test_build_model_on_cpu_at_full_width():
    """The flagship at full width builds on an explicit CPU device (no forward)."""
    m = build_model(device="cpu", seed=0)
    assert m.config.image_size == 1024 and not m.training
    assert sum(p.numel() for p in m.parameters()) > 40_000_000
    assert m.anchors[0].shape == (256 * 256 * 3, 4)
    a = build_model(device="cpu", seed=0).state_dict()
    b = m.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)  # weights come from the seed


def test_unsupported_settings_raise():
    """Every graph of the JAX ``from_cfg`` builds (relation-NMS off gives the
    greedy post-processor, tests/test_torch_port_variants_build.py walks the
    rest); settings no graph can run raise, naming the setting, instead of
    building something else."""
    import dataclasses

    from mmt_psm_tpu_torch.models import MaskRCNN, ModelConfig

    cfg = get_cfg()
    cfg.merge_from_file(U.FLAGSHIP)
    cfg.merge_from_list(["MODEL.RELATION_NMS.USE_RELATION_NMS", False])
    mc = ModelConfig.from_cfg(cfg)
    assert not mc.with_relation_nms and mc.nms_type == "greedy"
    with pytest.raises(ValueError, match="extractor 'NoSuchExtractor'"):
        MaskRCNN(dataclasses.replace(mc, relation_mask=dataclasses.replace(mc.relation_mask,
                                                                           extractor="NoSuchExtractor")))
    with pytest.raises(ValueError, match="shares the box head's"):
        MaskRCNN(dataclasses.replace(mc, mask_extractor="ResNet50Conv5ROIFeatureExtractor"))
