// Multi-level ROIAlign over NHWC FPN maps: the forward (K2) and its
// transpose, the backward (K3), one launch per head each.
//
// K2 replaces the Pallas TPU kernel `_make_kernel` in
// mmt_psm_tpu/ops/roi_align_pallas.py (launched by `_pallas_pool`, entry
// `multilevel_roi_align_pallas`). Same function as the exact XLA path
// mmt_psm_tpu/ops/pooler.py::multilevel_roi_align: each RoI is pooled on the
// FPN level the caller assigned it (pooler.py:25-30), with Caffe2-style
// ROIAlign, aligned=False: sampling grid `start + p*bin + (i+0.5)*bin/G`,
// samples outside [-1, dim] contribute 0, coordinates clamped at 0, the
// high corner collapsed onto the last row/column at the edge, and the bin
// the mean of its G*G samples.
//
// What bounds it on the H100: memory traffic. Each output element costs
// 4*G*G corner reads and ~4*G*G multiply-adds, far below the card's
// operations-per-byte balance. The TPU kernel DMA'd a 48-cell window per
// RoI into VMEM and clamped RoIs that overflow it; here there is no window:
// a block owns one (RoI, output row) and its threads span the channels, so
// every bilinear corner read is one contiguous C-element row of the NHWC
// map (512 B in bf16), served from L2 when neighbouring RoIs overlap. The
// per-axis sample positions and weights are computed once per block in
// shared memory. Every RoI is exact whatever its size. Accumulation is in
// float32; the result is rounded once to the feature dtype.
//
// K3 replaces the Pallas TPU kernel `_make_bwd_kernel` in the same file
// (launched by `_pallas_pool_bwd` through the custom VJP `_bwd`): the
// scatter-add of the pooled cotangent g through the bilinear weights into
// per-level feature gradients, the exact transpose of K2 (the JAX
// package's `_bwd_dense`). The TPU kernel is race-free only because its
// grid steps run in order and flush read-modify-write windows one after
// another; on the H100 blocks run in no order, so K3 takes K2's block
// layout (one (RoI, output row) per block, threads across channels, the
// same per-axis sample arithmetic) and atomically adds weight * g into one
// float32 gradient buffer for all levels, zeroed first, then rounds that
// buffer once to the feature dtype in a second pass. Atomics make the
// order of each cell's sum vary from run to run (float32 rounding only).
// What bounds it: the cotangent read once and every cell of the gradient
// maps written once are the bytes; the 4*G*G atomic adds per cotangent
// element, serialised where RoIs share cells, are its actual cost.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxGrid = 32;      // sampling_ratio
constexpr int kMaxSamples = 256;  // pooled * sampling_ratio per axis

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

struct Sample {
  int lo, hi;
  float w_lo, w_hi;  // bilinear weight * inbounds / grid
};

// The per-axis math of mmt_psm_tpu/ops/roi_align.py::_axis_weights.
__device__ __forceinline__ Sample axis_sample(float start, float size, int pooled, int grid,
                                              int p, int i, int dim) {
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

// grid (R, pooled), block min(C, 256). out [R, pooled, pooled, C].
template <typename T>
__global__ void roi_align_kernel(Levels lv, const float4* __restrict__ boxes,
                                 const int32_t* __restrict__ levels, T* __restrict__ out,
                                 int rois_per_image, int channels, int pooled, int grid) {
  __shared__ Sample ys[kMaxGrid];
  __shared__ Sample xs[kMaxSamples];
  const int r = blockIdx.x, py = blockIdx.y;
  const int b = r / rois_per_image;
  const int l = levels[r];
  const int h = lv.h[l], w = lv.w[l];
  const float4 box = boxes[r];
  const float scale = lv.scale[l];
  const float sx = __fmul_rn(box.x, scale), sy = __fmul_rn(box.y, scale);
  const float rw = fmaxf(__fsub_rn(__fmul_rn(box.z, scale), sx), 1.0f);
  const float rh = fmaxf(__fsub_rn(__fmul_rn(box.w, scale), sy), 1.0f);
  const int t = threadIdx.x;
  if (t < grid) ys[t] = axis_sample(sy, rh, pooled, grid, py, t, h);
  if (t >= grid && t < grid + pooled * grid) {
    const int k = t - grid;
    xs[k] = axis_sample(sx, rw, pooled, grid, k / grid, k % grid, w);
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(lv.ptr[l]) + (size_t)b * h * w * channels;
  T* orow = out + ((size_t)r * pooled + py) * pooled * channels;
  for (int c = t; c < channels; c += blockDim.x) {
    const T* fc = feat + c;
    for (int px = 0; px < pooled; ++px) {
      float acc = 0.0f;
      for (int iy = 0; iy < grid; ++iy) {
        const Sample y = ys[iy];
        const T* row_lo = fc + (size_t)y.lo * w * channels;
        const T* row_hi = fc + (size_t)y.hi * w * channels;
        for (int ix = 0; ix < grid; ++ix) {
          const Sample x = xs[px * grid + ix];
          const float top = x.w_lo * load(row_lo + (size_t)x.lo * channels) +
                            x.w_hi * load(row_lo + (size_t)x.hi * channels);
          const float bot = x.w_lo * load(row_hi + (size_t)x.lo * channels) +
                            x.w_hi * load(row_hi + (size_t)x.hi * channels);
          acc += y.w_lo * top + y.w_hi * bot;
        }
      }
      store(orow + (size_t)px * channels + c, acc);
    }
  }
}

}  // namespace

// feats: host array of `num_levels` device pointers to NHWC maps [B, H_l, W_l, C];
// heights/widths/scales: host arrays; boxes f32 [R, 4]; levels i32 [R] in
// [0, num_levels); out [R, pooled, pooled, C]. dtype 0 = float32, 1 = bfloat16.
extern "C" int roi_align_forward(const void* const* feats, const int* heights, const int* widths,
                                 const float* scales, int num_levels, const void* boxes,
                                 const void* levels, void* out, int rois, int rois_per_image,
                                 int channels, int pooled, int grid, int dtype, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || grid < 1 || grid > kMaxGrid ||
      pooled < 1 || pooled * grid > kMaxSamples || rois_per_image <= 0)
    return (int)cudaErrorInvalidValue;
  if (rois <= 0) return 0;
  Levels lv = {};
  for (int i = 0; i < num_levels; ++i) {
    lv.ptr[i] = feats[i];
    lv.h[i] = heights[i];
    lv.w[i] = widths[i];
    lv.scale[i] = scales[i];
  }
  const int threads = channels < 256 ? ((channels + 31) / 32) * 32 : 256;
  if (threads < grid + pooled * grid) return (int)cudaErrorInvalidValue;
  dim3 g(rois, pooled);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  const int32_t* lvl = static_cast<const int32_t*>(levels);
  if (dtype == 0) {
    roi_align_kernel<float><<<g, threads, 0, s>>>(lv, bx, lvl, static_cast<float*>(out),
                                                   rois_per_image, channels, pooled, grid);
  } else if (dtype == 1) {
    roi_align_kernel<__nv_bfloat16><<<g, threads, 0, s>>>(
        lv, bx, lvl, static_cast<__nv_bfloat16*>(out), rois_per_image, channels, pooled, grid);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}


namespace {

struct BwdLevels {
  long long offset[kMaxLevels];  // element offset of each level in the gradient buffer
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

// grid (R, pooled), block min(C, 256). grad [R, pooled, pooled, C];
// acc float32, all levels' NHWC gradient maps back to back.
template <typename T>
__global__ void roi_align_backward_kernel(BwdLevels lv, const float4* __restrict__ boxes,
                                          const int32_t* __restrict__ levels,
                                          const T* __restrict__ grad, float* __restrict__ acc,
                                          int rois_per_image, int channels, int pooled, int grid) {
  __shared__ Sample ys[kMaxGrid];
  __shared__ Sample xs[kMaxSamples];
  const int r = blockIdx.x, py = blockIdx.y;
  const int b = r / rois_per_image;
  const int l = levels[r];
  const int h = lv.h[l], w = lv.w[l];
  const float4 box = boxes[r];
  const float scale = lv.scale[l];
  const float sx = __fmul_rn(box.x, scale), sy = __fmul_rn(box.y, scale);
  const float rw = fmaxf(__fsub_rn(__fmul_rn(box.z, scale), sx), 1.0f);
  const float rh = fmaxf(__fsub_rn(__fmul_rn(box.w, scale), sy), 1.0f);
  const int t = threadIdx.x;
  if (t < grid) ys[t] = axis_sample(sy, rh, pooled, grid, py, t, h);
  if (t >= grid && t < grid + pooled * grid) {
    const int k = t - grid;
    xs[k] = axis_sample(sx, rw, pooled, grid, k / grid, k % grid, w);
  }
  __syncthreads();

  float* dst = acc + lv.offset[l] + (size_t)b * h * w * channels;
  const T* grow = grad + ((size_t)r * pooled + py) * pooled * channels;
  for (int c = t; c < channels; c += blockDim.x) {
    float* dc = dst + c;
    for (int px = 0; px < pooled; ++px) {
      const float gv = load(grow + (size_t)px * channels + c);
      if (gv == 0.0f) continue;  // adds nothing
      for (int iy = 0; iy < grid; ++iy) {
        const Sample y = ys[iy];
        float* row_lo = dc + (size_t)y.lo * w * channels;
        float* row_hi = dc + (size_t)y.hi * w * channels;
        for (int ix = 0; ix < grid; ++ix) {
          const Sample x = xs[px * grid + ix];
          // the plain version's (wy * wx) * g, corner by corner
          const float w00 = __fmul_rn(y.w_lo, x.w_lo), w01 = __fmul_rn(y.w_lo, x.w_hi);
          const float w10 = __fmul_rn(y.w_hi, x.w_lo), w11 = __fmul_rn(y.w_hi, x.w_hi);
          if (w00 != 0.0f) atomicAdd(row_lo + (size_t)x.lo * channels, __fmul_rn(w00, gv));
          if (w01 != 0.0f) atomicAdd(row_lo + (size_t)x.hi * channels, __fmul_rn(w01, gv));
          if (w10 != 0.0f) atomicAdd(row_hi + (size_t)x.lo * channels, __fmul_rn(w10, gv));
          if (w11 != 0.0f) atomicAdd(row_hi + (size_t)x.hi * channels, __fmul_rn(w11, gv));
        }
      }
    }
  }
}

__global__ void round_to_bf16_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                                     long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16_rn(in[i]);
}

}  // namespace

// heights/widths/scales/offsets: host arrays, one per level; offsets are
// element offsets of each level's [B, H_l, W_l, C] map in `acc` (and
// `out`), `total` elements in all. boxes f32 [R, 4]; levels i32 [R];
// grad [R, pooled, pooled, C] in the feature dtype. acc float32 [total] is
// zeroed and accumulated; for dtype 1 (bfloat16) it is then rounded into
// out [total]; for dtype 0 (float32) acc is the result and out is unused.
extern "C" int roi_align_backward(const int* heights, const int* widths, const float* scales,
                                  const long long* offsets, int num_levels, long long total,
                                  const void* boxes, const void* levels, const void* grad,
                                  void* acc, void* out, int rois, int rois_per_image, int channels,
                                  int pooled, int grid, int dtype, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || grid < 1 || grid > kMaxGrid ||
      pooled < 1 || pooled * grid > kMaxSamples || rois_per_image <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int threads = channels < 256 ? ((channels + 31) / 32) * 32 : 256;
  if (threads < grid + pooled * grid) return (int)cudaErrorInvalidValue;
  BwdLevels lv = {};
  for (int i = 0; i < num_levels; ++i) {
    lv.offset[i] = offsets[i];
    lv.h[i] = heights[i];
    lv.w[i] = widths[i];
    lv.scale[i] = scales[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(acc);
  cudaError_t err = cudaMemsetAsync(a, 0, (size_t)total * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (rois > 0) {
    dim3 g(rois, pooled);
    const float4* bx = static_cast<const float4*>(boxes);
    const int32_t* lvl = static_cast<const int32_t*>(levels);
    if (dtype == 0) {
      roi_align_backward_kernel<float><<<g, threads, 0, s>>>(
          lv, bx, lvl, static_cast<const float*>(grad), a, rois_per_image, channels, pooled, grid);
    } else {
      roi_align_backward_kernel<__nv_bfloat16><<<g, threads, 0, s>>>(
          lv, bx, lvl, static_cast<const __nv_bfloat16*>(grad), a, rois_per_image, channels, pooled,
          grid);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dtype == 1 && total > 0) {
    const long long blocks = (total + 255) / 256;
    round_to_bf16_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, s>>>(
        a, static_cast<__nv_bfloat16*>(out), total);
  }
  return (int)cudaGetLastError();
}
