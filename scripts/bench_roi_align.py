"""ROIAlign kernels K2 (forward) and K3 (backward) against earlier versions, on one NVIDIA GPU.

    python3 scripts/bench_roi_align.py --old OLD_ROI_ALIGN_CU [--out FILE]

``OLD_ROI_ALIGN_CU`` is an earlier ``mmt_psm_tpu_torch/csrc/roi_align.cu``
with the C interface the port had before K3 lost its float32 buffer
(``roi_align_backward(..., total, ..., acc, out, rois, ...)``), e.g. the
parent commit's, unpacked outside git's view:

    mkdir -p _bench && git show <commit>:mmt_psm_tpu_torch/csrc/roi_align.cu > _bench/old_roi_align.cu

At the flagship's shapes (batch 4, bf16 FPN maps 256^2 ... 32^2 x 256,
sampling ratio 2; the forward's box head 4 x 1000 RoIs at P = 7 and mask
head 4 x 180 at P = 14, the train step's 4 x 512 and 4 x 128), with
``chip_smoke.py``'s random boxes (the backward's half in clusters), it
prints one JSON object with:
  * ``k2``: per call, the device time (``torch.profiler``, 20 calls after
    warm-up) of the kernels each version launches, without the wrapper's
    PyTorch ops: the old kernel, the current one, and
    ``block_per_roi_scalar`` (one block per RoI with the old per-channel
    scalar loads: the redesign's first step alone), in turns old, step, new,
    new, step, old;
  * ``k3``: per call, the same for the old entry point (memset, atomic
    kernel, rounding pass) and the current one (footprint helper, tile
    kernel), in turns old, new, new, old, each turn also by kernel, so the
    old atomic kernel alone (the old design without its memset and rounding
    pass) stands beside the tile kernel; then the current source rebuilt
    with one piece changed (``variants``: other tile shapes, and cuts that
    leave out the RoIs or their scatter, to show where the time goes);
  * ``checks``: the new K2 in f32 bit-equal to the old on every call, K3's
    f32 largest difference from the old, and two K3 launches bit-identical;
  * ``ptxas``: registers, shared memory and spills of every kernel of the
    current source, as ``nvcc -Xptxas -v`` reports them;
  * the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import BATCH, CANVAS, card_line, cluster_boxes, device_ms, random_boxes  # noqa: E402
from mmt_psm_tpu_torch.ops import kernels  # noqa: E402
from mmt_psm_tpu_torch.ops import pooler as Pm  # noqa: E402

SCALES = (0.25, 0.125, 0.0625, 0.03125)
C = 256
K2_CALLS = {"box_head": (1000, 7), "mask_head": (180, 14), "box_head_train": (512, 7), "mask_head_train": (128, 14)}
K3_CALLS = {"box_head_train": (512, 7), "mask_head_train": (128, 14)}
# K3 rebuilt with one piece of its source replaced: other tile shapes (cells
# a side, channels a block), and two cuts that show where its time goes: no
# RoI kept (the scan, zeroing and writing the tiles) and no scatter (also
# the sample tables of the RoIs kept)
VARIANTS = {
    "tile_8x8": [("constexpr int kTile = 4;", "constexpr int kTile = 8;")],
    "tile_16x16_64ch": [("constexpr int kTile = 4;", "constexpr int kTile = 16;"),
                        ("constexpr int kSlice = 256;", "constexpr int kSlice = 64;")],
    "no_roi_kept": [("keep = li == l &&", "keep = false && li == l &&")],
    "no_scatter": [("      if (active) {\n        for (int k = 0; k < kb; ++k) {",
                    "      if (false) {\n        for (int k = 0; k < kb; ++k) {")],
}

# The redesign's first step alone: one block per RoI, both sample tables
# computed once, the bins walked inside the block; one thread per channel
# with the old scalar loads and arithmetic. Same C interface as K2.
BLOCK_PER_ROI_SCALAR = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
struct Levels { const void* ptr[4]; int h[4]; int w[4]; float scale[4]; };
struct Sample { int lo, hi; float w_lo, w_hi; };
__device__ __forceinline__ Sample axis_sample(float start, float size, int pooled, int grid, int p, int i, int dim) {
  const float bin = __fdiv_rn(size, (float)pooled);
  const float coord = __fadd_rn(__fadd_rn(start, __fmul_rn((float)p, bin)),
                                __fdiv_rn(__fmul_rn((float)i + 0.5f, bin), (float)grid));
  const bool inb = coord >= -1.0f && coord <= (float)dim;
  const float c = fmaxf(coord, 0.0f);
  float low = floorf(c);
  const bool at_edge = low >= (float)(dim - 1);
  if (at_edge) low = (float)(dim - 1);
  const float frac = at_edge ? 0.0f : __fsub_rn(c, low);
  Sample s;
  s.lo = (int)low;
  s.hi = at_edge ? s.lo : s.lo + 1;
  s.w_lo = __fdiv_rn(inb ? __fsub_rn(1.0f, frac) : 0.0f, (float)grid);
  s.w_hi = __fdiv_rn(inb ? frac : 0.0f, (float)grid);
  return s;
}
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
template <typename T>
__global__ void roi_align_kernel(Levels lv, const float4* __restrict__ boxes, const int32_t* __restrict__ levels,
                       T* __restrict__ out, int rois_per_image, int channels, int pooled, int grid) {
  __shared__ Sample ys[256], xs[256];
  const int r = blockIdx.x, b = r / rois_per_image, l = levels[r], h = lv.h[l], w = lv.w[l];
  const float4 box = boxes[r];
  const float scale = lv.scale[l];
  const float sx = __fmul_rn(box.x, scale), sy = __fmul_rn(box.y, scale);
  const float rw = fmaxf(__fsub_rn(__fmul_rn(box.z, scale), sx), 1.0f);
  const float rh = fmaxf(__fsub_rn(__fmul_rn(box.w, scale), sy), 1.0f);
  const int n = pooled * grid;
  for (int k = threadIdx.x; k < 2 * n; k += blockDim.x) {
    if (k < n) ys[k] = axis_sample(sy, rh, pooled, grid, k / grid, k % grid, h);
    else xs[k - n] = axis_sample(sx, rw, pooled, grid, (k - n) / grid, (k - n) % grid, w);
  }
  __syncthreads();
  const T* feat = static_cast<const T*>(lv.ptr[l]) + (size_t)b * h * w * channels;
  T* oroi = out + (size_t)r * pooled * pooled * channels;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    const T* fc = feat + c;
    for (int bin = 0; bin < pooled * pooled; ++bin) {
      const int py = bin / pooled, px = bin % pooled;
      float acc = 0.0f;
      for (int iy = 0; iy < grid; ++iy) {
        const Sample y = ys[py * grid + iy];
        const T* row_lo = fc + (size_t)y.lo * w * channels;
        const T* row_hi = fc + (size_t)y.hi * w * channels;
        for (int ix = 0; ix < grid; ++ix) {
          const Sample x = xs[px * grid + ix];
          const float top = x.w_lo * load(row_lo + (size_t)x.lo * channels) + x.w_hi * load(row_lo + (size_t)x.hi * channels);
          const float bot = x.w_lo * load(row_hi + (size_t)x.lo * channels) + x.w_hi * load(row_hi + (size_t)x.hi * channels);
          acc += y.w_lo * top + y.w_hi * bot;
        }
      }
      store(oroi + (size_t)bin * channels + c, acc);
    }
  }
}
}  // namespace
extern "C" int roi_align_forward(const void* const* feats, const int* heights, const int* widths,
                                 const float* scales, int num_levels, const void* boxes, const void* levels,
                                 void* out, int rois, int rois_per_image, int channels, int pooled, int grid,
                                 int dtype, void* stream) {
  Levels lv = {};
  for (int i = 0; i < num_levels; ++i) {
    lv.ptr[i] = feats[i]; lv.h[i] = heights[i]; lv.w[i] = widths[i]; lv.scale[i] = scales[i];
  }
  const int threads = channels < 256 ? ((channels + 31) / 32) * 32 : 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  const int32_t* lvl = static_cast<const int32_t*>(levels);
  if (dtype == 0) roi_align_kernel<float><<<rois, threads, 0, s>>>(lv, bx, lvl, static_cast<float*>(out), rois_per_image, channels, pooled, grid);
  else roi_align_kernel<__nv_bfloat16><<<rois, threads, 0, s>>>(lv, bx, lvl, static_cast<__nv_bfloat16*>(out), rois_per_image, channels, pooled, grid);
  return (int)cudaGetLastError();
}
"""

_p, _i = ctypes.c_void_p, ctypes.c_int
OLD_BACKWARD_ARGS = (ctypes.POINTER(_i), ctypes.POINTER(_i), ctypes.POINTER(ctypes.c_float),
                     ctypes.POINTER(ctypes.c_longlong), _i, ctypes.c_longlong, _p, _p, _p, _p, _p,
                     _i, _i, _i, _i, _i, _i, _p)


def build(name, source, ptxas=False, old=False):
    """Compile CUDA source text with the port's nvcc flags into a ctypes library
    (and the ptxas report); builds go under the port's ignored build directory.
    ``old``: the library has the earlier backward C interface."""
    flags = list(kernels.NVCC_FLAGS) + (["-Xptxas", "-v"] if ptxas else [])
    digest = hashlib.sha256((source + " ".join(flags)).encode()).hexdigest()[:16]
    os.makedirs(os.path.join(kernels.BUILD_DIR, "bench"), exist_ok=True)
    base = os.path.join(kernels.BUILD_DIR, "bench", f"{name}_{digest}")
    with open(base + ".cu", "w") as f:
        f.write(source)
    proc = subprocess.run([kernels._nvcc(), *flags, "-o", base + ".so", base + ".cu"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(base + ".so")
    lib.roi_align_forward.argtypes = kernels.SIGNATURES["roi_align"]["roi_align_forward"]
    lib.roi_align_forward.restype = ctypes.c_int
    if hasattr(lib, "roi_align_backward"):
        lib.roi_align_backward.argtypes = OLD_BACKWARD_ARGS if old else kernels.SIGNATURES["roi_align"]["roi_align_backward"]
        lib.roi_align_backward.restype = ctypes.c_int
    return lib, proc.stderr


def ptxas_report(text):
    """{kernel (demangled enough to read): registers, smem bytes, spill stores/loads}."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(name, {})["registers"] = int(m.group(1))
            out[name]["smem_bytes"] = int(smem.group(1)) if smem else 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {})["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
    return out


def forward(lib, feats, boxes, p):
    """K2's wrapper with the kernel taken from ``lib``."""
    b, n = boxes.shape[:2]
    levels = Pm._levels(boxes, SCALES).contiguous()
    out = torch.empty((b, n, p, p, C), dtype=feats[0].dtype, device=boxes.device)
    num = len(feats)
    err = lib.roi_align_forward(
        (_p * num)(*[f.data_ptr() for f in feats]), (_i * num)(*[f.shape[1] for f in feats]),
        (_i * num)(*[f.shape[2] for f in feats]), (ctypes.c_float * num)(*SCALES), num, boxes.data_ptr(),
        levels.data_ptr(), out.data_ptr(), b * n, n, C, p, 2, 0 if feats[0].dtype == torch.float32 else 1,
        kernels.stream_handle(boxes.device))
    kernels.check(err, "roi_align_forward")
    return out


def backward_old(lib, grad, boxes, shapes, p):
    """The earlier K3's wrapper: a zeroed float32 buffer of all levels, atomics, a rounding pass."""
    b, n = boxes.shape[:2]
    levels = Pm._levels(boxes, SCALES).contiguous()
    sizes = [s[0] * s[1] * s[2] * s[3] for s in shapes]
    total = sum(sizes)
    acc = torch.empty(total, dtype=torch.float32, device=boxes.device)
    out = acc if grad.dtype == torch.float32 else torch.empty(total, dtype=grad.dtype, device=boxes.device)
    offsets = [0]
    for s in sizes[:-1]:
        offsets.append(offsets[-1] + s)
    num = len(shapes)
    err = lib.roi_align_backward(
        (_i * num)(*[s[1] for s in shapes]), (_i * num)(*[s[2] for s in shapes]), (ctypes.c_float * num)(*SCALES),
        (ctypes.c_longlong * num)(*offsets), num, total, boxes.data_ptr(), levels.data_ptr(), grad.data_ptr(),
        acc.data_ptr(), out.data_ptr(), b * n, n, C, p, 2, 0 if grad.dtype == torch.float32 else 1,
        kernels.stream_handle(boxes.device))
    kernels.check(err, "roi_align_backward (old)")
    return [t.view(s) for t, s in zip(out.split(sizes), shapes)]


def backward_new(lib, grad, boxes, shapes, p):
    """K3's wrapper with the kernel taken from ``lib`` (the current C interface)."""
    saved = kernels._libs.get("roi_align")
    kernels._libs["roi_align"] = lib
    try:
        return Pm.multilevel_roi_align_backward_cuda(grad, boxes, shapes, SCALES, p, 2)
    finally:
        kernels._libs["roi_align"] = saved


def by_kernel(fn):
    """Device ms per call of each kernel and memset ``fn`` launches, and their
    sum without PyTorch's own kernels (the wrapper's level assignment)."""
    times = {re.sub(r"\(.*", "", k.replace("(anonymous namespace)::", "")): v for k, v in device_ms(fn).items()}
    return {"ms": sum(v for k, v in times.items() if "at::native" not in k), "by_kernel": times}


def turns(fns, order):
    """``by_kernel`` of each named function, run in the given order of names."""
    got = {k: [] for k in fns}
    for k in order:
        got[k].append(by_kernel(fns[k]))
    return {k: {"mean_ms": sum(t["ms"] for t in v) / len(v), "turns": v} for k, v in got.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="an earlier roi_align.cu (the C interface described above)")
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_roi_align: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    with open(args.old) as f:
        old_src = f.read()
    with open(os.path.join(kernels.CSRC, "roi_align.cu")) as f:
        new_src = f.read()
    old, _ = build("old", old_src, old=True)
    new, report = build("new", new_src, ptxas=True)
    step, _ = build("block_per_roi_scalar", BLOCK_PER_ROI_SCALAR)
    variants = {}
    for name, edits in VARIANTS.items():
        src = new_src
        for a, b in edits:
            if src.count(a) != 1:
                raise RuntimeError(f"{name}: no single {a!r} in roi_align.cu")
            src = src.replace(a, b)
        variants[name] = build(name, src, ptxas=True)

    gen = torch.Generator(device=dev).manual_seed(2)
    feats32 = [torch.randn(BATCH, CANVAS // 4 >> i, CANVAS // 4 >> i, C, generator=gen, device=dev) for i in range(4)]
    feats16 = [f.to(torch.bfloat16) for f in feats32]
    shapes = [tuple(f.shape) for f in feats16]
    result = {"card": card_line(), "k2": {}, "k3": {}, "variants": {}, "checks": {}}

    for name, (n, p) in K2_CALLS.items():
        boxes = random_boxes(gen, BATCH, n, CANVAS, dev)
        a, b = forward(old, feats32, boxes, p), forward(new, feats32, boxes, p)
        result["checks"][f"k2_{name}_f32_bit_equal_to_old"] = bool(torch.equal(a, b))
        fns = {"old": lambda: forward(old, feats16, boxes, p), "new": lambda: forward(new, feats16, boxes, p),
               "block_per_roi_scalar": lambda: forward(step, feats16, boxes, p)}
        result["k2"][name] = turns(fns, ("old", "block_per_roi_scalar", "new", "new", "block_per_roi_scalar", "old"))

    for name, (n, p) in K3_CALLS.items():
        boxes = torch.cat([random_boxes(gen, BATCH, n // 2, CANVAS, dev), cluster_boxes(gen, BATCH, n - n // 2, dev)], 1)
        g32 = torch.randn(BATCH, n, p, p, C, generator=gen, device=dev)
        g16 = g32.to(torch.bfloat16)
        a, b = backward_old(old, g32, boxes, shapes, p), backward_new(new, g32, boxes, shapes, p)
        result["checks"][f"k3_{name}_f32_max_abs_diff_from_old"] = max(float((x - y).abs().max()) for x, y in zip(a, b))
        b2 = backward_new(new, g16, boxes, shapes, p)
        b3 = backward_new(new, g16, boxes, shapes, p)
        result["checks"][f"k3_{name}_bf16_two_launches_identical"] = all(torch.equal(x, y) for x, y in zip(b2, b3))
        fns = {"old": lambda: backward_old(old, g16, boxes, shapes, p),
               "new": lambda: backward_new(new, g16, boxes, shapes, p)}
        result["k3"][name] = turns(fns, ("old", "new", "new", "old"))
        var_fns = {"new": fns["new"], **{k: (lambda lib=lib: backward_new(lib, g16, boxes, shapes, p))
                                         for k, (lib, _) in variants.items()}}
        result["variants"][name] = turns(var_fns, (*var_fns, *reversed(var_fns)))

    result["ptxas"] = {"new": ptxas_report(report), **{k: ptxas_report(r) for k, (_, r) in variants.items()}}
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
