"""PyTorch/CUDA port of mmt_psm_tpu: MMT-PSM on NVIDIA Hopper.

``build_model(config_path, device=...)`` builds the flagship Mask R-CNN
R-50-FPN with relation-NMS and CIAM; ``model(images, image_sizes)`` runs
the test-time graph through the hand-written kernels in ``csrc/``.
``train.build_trainer`` builds the same model with its SGD step;
``Trainer.step(batch)`` runs the supervised train step.
``engine.inference.run_inference`` evaluates a model over test batches
(host paste and Papeval), and ``python -m mmt_psm_tpu_torch.tools.test_net``
sweeps a directory of checkpoints. ``python -m
mmt_psm_tpu_torch.tools.train_mean_teacher`` trains the flagship with the
mean teacher through the host loop ``engine.trainer.MTTrainer``, with
checkpoints and resume. ``models.variants`` names every other graph the
config builds (the plain Mask R-CNN, set-NMS, the mask relation variants,
RPN_ONLY, R-50-C4, PRCNN, backbone recomputation), for ``model_from_cfg``
and the trainers. ``data.catalog.build_datasets`` resolves Pap, synthetic,
COCO-format, VOC and file-list datasets (several names concatenated), and
``evaluation.evaluate`` scores predictions by the dataset's type (COCO AP,
VOC mAP, Papeval).

The names below load ``models`` (and torch) at first use, so the host eval
modules (``evaluation``, ``engine.paste``, ``engine._eval_worker``) import
without torch in the eval worker processes.
"""

__all__ = ["MaskRCNN", "ModelConfig", "build_model"]


def __getattr__(name):
    if name in __all__:
        from . import models

        return getattr(models, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
