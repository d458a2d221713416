"""The port's whole inference slice against ``MaskRCNN.forward_test``.

Flagship graph (relation-NMS and CIAM on) at a 128 canvas in float32 on
the CPU, small proposal counts as in ``__graft_entry__.dryrun_multichip``,
the same weights on both sides. ``valid`` and ``labels`` must be
identical; boxes, scores and mask probabilities agree to 5e-3 absolute:
the backbone's float32 noise (~2e-6 of the feature range, see
test_torch_port_modules.py) passes through untrained heads whose mask
logits reach the hundreds. The first measurement was 4e-4 on boxes, 5e-4
on scores and 5e-4 on masks.
"""

import jax
import numpy as np
import torch

import torch_port_util as U

U.setup_torch()


def test_forward_test_matches_jax():
    jm, params, tm, _ = U.build_pair()
    images, sizes = U.inputs()
    want = jax.jit(lambda p, i, s: jm.apply(p, i, s, train=False))(params, images, sizes)
    got = tm(torch.from_numpy(images), torch.from_numpy(sizes))

    k = 2 * min(tm.config.relation.first_n, tm.config.fpn_post_nms_top_n_test)
    assert got.boxes.shape == (2, k, 4) and got.masks.shape == (2, k, 28, 28)
    assert got.labels.dtype == torch.int32 and got.valid.dtype == torch.bool
    assert int(got.valid.sum()) > 10
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    U.assert_close(got.boxes, want.boxes, atol=5e-3, what="boxes")
    U.assert_close(got.scores, want.scores, atol=5e-3, what="scores")
    U.assert_close(got.masks, want.masks, atol=5e-3, what="mask probabilities")
    for name in ("boxes", "scores", "masks"):
        assert torch.isfinite(getattr(got, name)).all()
