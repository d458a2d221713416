"""Records of the kernel roles' calls in a traced segment, for the
rooflines: the program's launch wrappers of K1, K2 and K3 are wrapped for
the segment's length and put back after. Each call keeps what its count
(``perfbench/counts/kernels.py``) reads: K1's sorted boxes, valid flags and
output flags; K2's and K3's boxes, the maps' shapes and the element size.
No feature map is kept."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def kernel_calls():
    from mmt_psm_tpu_torch.ops import nms as N
    from mmt_psm_tpu_torch.ops import pooler as P

    calls = {"k1_nms": [], "k2_roi_align": [], "k3_roi_align_bwd": []}

    def k1(args, out):
        return args[0], args[1], out

    def k2(args, out):
        features, boxes, scales, p, g = args
        return tuple(tuple(f.shape) for f in features), boxes, tuple(scales), p, g, features[0].element_size()

    def k3(args, out):
        grad, boxes, shapes, scales, p, g = args
        return tuple(tuple(s) for s in shapes), boxes, p, grad.element_size()

    keep = {"k1_nms": k1, "k2_roi_align": k2, "k3_roi_align_bwd": k3}

    def wrap(module, name, record):
        orig = getattr(module, name)

        def recorded(*args):
            out = orig(*args)
            calls[record].append(keep[record](args, out))
            return out

        # the wrapper counts launches where the original does (``<fn>.launches``)
        recorded.launches = orig.launches
        setattr(module, name, recorded)
        return orig, recorded

    wrapped = [(N, "suppress_cuda", *wrap(N, "suppress_cuda", "k1_nms")),
               (P, "multilevel_roi_align_cuda", *wrap(P, "multilevel_roi_align_cuda", "k2_roi_align")),
               (P, "multilevel_roi_align_backward_cuda",
                *wrap(P, "multilevel_roi_align_backward_cuda", "k3_roi_align_bwd"))]
    try:
        yield calls
    finally:
        for module, name, orig, recorded in wrapped:
            orig.launches = recorded.launches
            setattr(module, name, orig)
