// Mask targets (K4): every positive RoI's gt mask cropped to the RoI at
// R x R and thresholded at 0.5, for all RoIs of a batch in one launch.
//
// Replaces no Pallas kernel. The JAX package computes these targets with
// XLA's dense contractions (mmt_psm_tpu/models/mask_head.py::
// crop_masks_to_boxes: a single-level ROIAlign of the float32 mask at scale
// 1 with 2 x 2 samples, then >= 0.5), and the port's plain version
// (models/mask_head.py::crop_masks_to_boxes_plain) repeats them in PyTorch:
// for each chunk of 32 RoIs, two one-hot interpolation matrices [32, R, Hm]
// and [32, R, Wm], a float32 copy of 32 full masks and two batched matrix
// products. On the card that loop made ~98 launches a chunk and 64 chunks a
// training step, and the host's time to launch them set the pace of the
// step. This kernel was added to make the targets one launch.
//
// What it computes: the plain version's function in the same float32
// arithmetic. Per axis and RoI, each bin's two samples
// (start + p*bin + (i+0.5)*bin/2, bin = max(x1 - x0, 1)/R) give corners and
// weights as ops/pooler.py::_axis_samples does: the in-bounds test on
// [-1, dim], the clamp at 0, the collapse onto the last row or column, the
// 1/2 of the mean, every product and sum rounded as there (-fmad=false and
// the explicit intrinsics). A bin's column of the dense matrix has at most
// four nonzero entries; where two corners meet one row or column their
// weights are added first, as the one-hot sum does. The contraction runs
// rows first, then columns, as JAX's roi_align does:
// t(x) = sum over the bin's rows of wy * m(y, x), then
// v = sum over its columns of t(x) * wx, each sum in ascending row or
// column order. The dense product adds the same terms and exact zeros in an
// order of its BLAS's choosing, so the two can differ only where float32
// sums of the same terms round differently, which moves a target only at a
// value within a few ulps of 0.5 (the exact ties of the tests' criterion).
//
// What bounds it: bytes, and the latency of scattered loads. Each output
// pixel reads 16 bytes of its RoI's uint8 mask (4 rows x 4 columns) and
// writes 4; a RoI reads at most 4R distinct rows x 4R distinct columns
// (12.5 KB at R = 28), no more than 26 MB for 2,048 RoIs, and writes 6.4 MB
// of targets: a few microseconds at 3.35 TB/s. The mask is read where it
// lies, [B, M, Hm, Wm] uint8 at row gt_idx[b, s]: no gather and no float
// copy. One block per RoI: its R row bins' and R column bins' taps (offset,
// weight) go into shared memory once, padded to four with weight 0 (an
// exact no-op in both sums) so that a pixel's 16 loads are all in flight at
// once; its threads walk the R*R pixels in row-major order, so a warp's
// loads fall in a few mask rows and neighbouring columns, read through the
// read-only cache, and its stores are coalesced. No sync, no allocation.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kMaxRes = 128;  // R per axis
constexpr int kTaps = 4;      // a bin's distinct rows (columns): 2 samples x 2 corners
constexpr int kThreads = 256;

// One sample of one bin along one axis (grid 2): its two corners and their
// weights, the in-bounds test and the 1/2 of the bin mean included.
__device__ __forceinline__ void axis_sample(float start, float bin, int p, int i, int dim, int& lo,
                                            int& hi, float& w_lo, float& w_hi) {
  const float coord = __fadd_rn(__fadd_rn(start, __fmul_rn((float)p, bin)),
                                __fdiv_rn(__fmul_rn((float)i + 0.5f, bin), 2.0f));
  const float d = (float)dim;
  const bool inb = coord >= -1.0f && coord <= d;
  const float c = fmaxf(coord, 0.0f);  // a NaN coordinate: row 0, weight 0
  float low = floorf(c);
  const bool at_edge = low >= __fsub_rn(d, 1.0f);
  if (at_edge) low = __fsub_rn(d, 1.0f);
  const float frac = at_edge ? 0.0f : __fsub_rn(c, low);
  lo = (int)low;
  hi = at_edge ? lo : lo + 1;
  w_lo = __fdiv_rn(inb ? __fsub_rn(1.0f, frac) : 0.0f, 2.0f);
  w_hi = __fdiv_rn(inb ? frac : 0.0f, 2.0f);
}

// w[idx] += v over the n taps found so far, or a new tap (every index a
// constant after unrolling, so the arrays stay in registers)
__device__ __forceinline__ void add_tap(int idx[kTaps], float w[kTaps], int& n, int at, float v) {
  bool found = false;
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
    if (k < n && idx[k] == at) {
      w[k] = __fadd_rn(w[k], v);
      found = true;
    }
  if (found) return;
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
    if (k == n) {
      idx[k] = at;
      w[k] = v;
    }
  ++n;
}

// Bin p's column of the dense interpolation matrix along an axis of `dim`
// cells: each sample's column (w_lo at lo plus w_hi at hi, one entry
// w_lo + w_hi where they meet), the two samples' columns summed. The taps
// come out in ascending index order (a later sample's corners never lie
// below an earlier one's), then padded to kTaps with weight 0 at the first
// index. `stride` scales the indices: a row's byte offset, or 1.
__device__ __forceinline__ void bin_taps(float start, float size, int res, int p, int dim,
                                         int stride, int4& offs, float4& ws) {
  const float bin = __fdiv_rn(size, (float)res);
  int idx[kTaps] = {0, 0, 0, 0};
  float w[kTaps] = {0.f, 0.f, 0.f, 0.f};
  int n = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int lo, hi;
    float w_lo, w_hi;
    axis_sample(start, bin, p, i, dim, lo, hi, w_lo, w_hi);
    if (lo == hi) {
      add_tap(idx, w, n, lo, __fadd_rn(w_lo, w_hi));
    } else {
      add_tap(idx, w, n, lo, w_lo);
      add_tap(idx, w, n, hi, w_hi);
    }
  }
#pragma unroll
  for (int k = 1; k < kTaps; ++k)
    if (k >= n) idx[k] = idx[0];
  offs = make_int4(idx[0] * stride, idx[1] * stride, idx[2] * stride, idx[3] * stride);
  ws = make_float4(w[0], w[1], w[2], w[3]);
}

// grid (B*S), block <= kThreads. masks u8 [B, M, H, W]; gt_idx i64 [B*S];
// boxes f32 [B*S, 4] in mask coordinates; out f32 [B*S, R, R].
__global__ void __launch_bounds__(kThreads)
mask_targets_kernel(const uint8_t* __restrict__ masks, const int64_t* __restrict__ gt_idx,
                    const float* __restrict__ boxes, float* __restrict__ out, int rois_per_image,
                    int masks_per_image, int height, int width, int res) {
  __shared__ int4 y_offs[kMaxRes];
  __shared__ float4 y_ws[kMaxRes];
  __shared__ int4 x_offs[kMaxRes];
  __shared__ float4 x_ws[kMaxRes];
  const int r = blockIdx.x;
  const float x0 = boxes[4 * r], y0 = boxes[4 * r + 1];
  const float rw = fmaxf(__fsub_rn(boxes[4 * r + 2], x0), 1.0f);
  const float rh = fmaxf(__fsub_rn(boxes[4 * r + 3], y0), 1.0f);
  for (int k = threadIdx.x; k < 2 * res; k += blockDim.x) {
    if (k < res)
      bin_taps(y0, rh, res, k, height, width, y_offs[k], y_ws[k]);
    else
      bin_taps(x0, rw, res, k - res, width, 1, x_offs[k - res], x_ws[k - res]);
  }
  __syncthreads();

  float* o = out + (size_t)r * res * res;
  const int64_t row = gt_idx[r];
  if (row < 0 || row >= masks_per_image) {  // no such gt mask: NaN targets, never a stray read
    for (int k = threadIdx.x; k < res * res; k += blockDim.x) o[k] = __int_as_float(0x7fc00000);
    return;
  }
  const int b = r / rois_per_image;
  const uint8_t* m = masks + ((size_t)b * masks_per_image + (size_t)row) * height * width;
  for (int k = threadIdx.x; k < res * res; k += blockDim.x) {
    const int py = k / res, px = k - py * res;
    const int4 yo = y_offs[py], xo = x_offs[px];
    const float4 wy = y_ws[py], wx = x_ws[px];
    const int ys[kTaps] = {yo.x, yo.y, yo.z, yo.w};
    const int xs[kTaps] = {xo.x, xo.y, xo.z, xo.w};
    const float wys[kTaps] = {wy.x, wy.y, wy.z, wy.w};
    const float wxs[kTaps] = {wx.x, wx.y, wx.z, wx.w};
    uint8_t v[kTaps][kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
#pragma unroll
      for (int i = 0; i < kTaps; ++i) v[j][i] = __ldg(m + ys[i] + xs[j]);
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      float t = 0.0f;  // rows first: the column's value at this bin's rows
#pragma unroll
      for (int i = 0; i < kTaps; ++i) t = __fadd_rn(t, __fmul_rn(wys[i], (float)v[j][i]));
      acc = __fadd_rn(acc, __fmul_rn(t, wxs[j]));
    }
    o[k] = acc >= 0.5f ? 1.0f : 0.0f;
  }
}

}  // namespace

// masks: u8 [batch, masks_per_image, height, width]; gt_idx: i64
// [batch, rois_per_image] rows of it (a row outside [0, masks_per_image)
// gives NaN targets); boxes: f32 [batch, rois_per_image, 4] x0, y0, x1, y1
// in mask coordinates; out: f32 [batch, rois_per_image, resolution,
// resolution]. All contiguous. Launches on `stream`; returns the launch's
// CUDA error code.
extern "C" int mask_targets(const void* masks, const void* gt_idx, const void* boxes, void* out,
                            int batch, int rois_per_image, int masks_per_image, int height,
                            int width, int resolution, void* stream) {
  if (batch < 0 || rois_per_image < 0 || masks_per_image < 1 || height < 1 || width < 1 ||
      resolution < 1 || resolution > kMaxRes || (long long)height * width > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long rois = (long long)batch * rois_per_image;
  if (rois == 0) return 0;
  if (rois > INT_MAX) return (int)cudaErrorInvalidValue;
  // as few rounds over the R*R pixels as kThreads threads need, then as
  // few warps as cover each round
  const int items = resolution * resolution;
  const int rounds = (items + kThreads - 1) / kThreads;
  const int per_round = (items + rounds - 1) / rounds;
  const int threads = ((per_round + 31) / 32) * 32;
  mask_targets_kernel<<<(int)rois, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const int64_t*>(gt_idx),
      static_cast<const float*>(boxes), static_cast<float*>(out), rois_per_image, masks_per_image,
      height, width, resolution);
  return (int)cudaGetLastError();
}
