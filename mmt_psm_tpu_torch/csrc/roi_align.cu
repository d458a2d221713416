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
// What bounds K2 on the H100: memory traffic. Each output element costs
// 4*G*G corner reads and ~4*G*G multiply-adds, far below the card's
// operations-per-byte balance, and the corner reads (16 per bin at G = 2)
// are many times the distinct cells, so whether corners are reused in L1
// and L2 decides the time. The TPU kernel DMA'd a 48-cell window per RoI
// into VMEM and clamped RoIs that overflow it; here there is no window and
// every RoI is exact whatever its size. One block pools one RoI: its P*G
// sample positions and weights per axis go into shared memory once, and
// its threads walk the P*P bins in row-major order, so all bins of a RoI
// run together on one SM and neighbouring bins find their shared corner
// rows in L1. A lane owns 8 consecutive channels: one 16-byte load per
// corner in bf16 (two in float32) through the read-only path, every corner
// of a bin issued before its multiply-adds at G = 2, float32 accumulation
// in a fixed order, one rounding and one 16-byte store.
//
// K3 replaces the Pallas TPU kernel `_make_bwd_kernel` in the same file
// (launched by `_pallas_pool_bwd` through the custom VJP `_bwd`): the
// scatter-add of the pooled cotangent g through the bilinear weights into
// per-level feature gradients, the exact transpose of K2 (the JAX
// package's `_bwd_dense`). The TPU kernel is race-free because its grid
// steps run in order and flush read-modify-write windows one after
// another; Hopper blocks run in no order. Here a block owns a 4x4-cell
// tile of one level's gradient map (and up to 256 channels of it): it
// accumulates the tile in float32 in shared memory, visiting the RoIs of
// its image whose footprint on that level meets the tile in RoI order, and
// writes every cell of the tile once in the cotangent's dtype with 16-byte
// stores. Within the tile a lane group owns one row and each lane 8 fixed
// channels, so no two threads write one shared word: there are no atomics,
// no float32 copy of the maps, no memset and no rounding pass, and the
// order of every cell's sum is fixed, so two launches on the same inputs
// give bit-identical gradients. A helper kernel first computes each RoI's
// footprint (the cells its samples weigh in) on its level with the same
// per-axis arithmetic; blocks of the coarsest level, whose tiles meet the
// most RoIs, are launched first. What bounds K3: the cotangent read once
// and every cell of the gradient maps written once are the bytes, but its
// time goes to the scatter itself: for each RoI a tile meets, each row's
// lanes walk the bins that reach the row, load the bin's cotangent and add
// (wy * wx) * g into shared memory, two 16-byte reads and writes of shared
// memory per lane and corner; clustered RoIs pile onto a few tiles whose
// blocks run longest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxGrid = 32;      // sampling_ratio
constexpr int kMaxSamples = 256;  // pooled * sampling_ratio per axis
constexpr int kLaneChannels = 8;  // channels a lane owns: 16 bytes of bf16
constexpr int kThreads = 256;     // K2's block at most; K3's block
constexpr int kTile = 4;          // K3: a block owns kTile x kTile cells ...
constexpr int kSlice = 256;       // ... of at most kSlice channels
constexpr int kTableBytes = 8192; // K3: shared memory for a batch of RoIs' sample tables

// One FPN level: K2 reads `ptr`; K3 writes at element `offset` of its
// output and owns blocks [first_block, first_block + blocks) of its grid.
struct Level {
  const void* ptr;
  long long offset;
  int h, w;
  float scale;
  int tiles_x, first_block, blocks;
};

struct Levels {
  Level l[kMaxLevels];
  int num;
};

// lv.l[l] with every index a constant, so the table stays in the kernel's
// parameter space (indexing it with a variable copies it to local memory).
__device__ __forceinline__ Level pick(const Levels& lv, int l) {
  Level o = lv.l[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i == l) o = lv.l[i];
  return o;
}

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

// A RoI's box on its level: start and size per axis, as the plain version has them.
struct RoiBox {
  float sx, sy, rw, rh;
};

__device__ __forceinline__ RoiBox roi_box(float4 box, float scale) {
  RoiBox r;
  r.sx = __fmul_rn(box.x, scale);
  r.sy = __fmul_rn(box.y, scale);
  r.rw = fmaxf(__fsub_rn(__fmul_rn(box.z, scale), r.sx), 1.0f);
  r.rh = fmaxf(__fsub_rn(__fmul_rn(box.w, scale), r.sy), 1.0f);
  return r;
}

// 8 consecutive channels: one 16-byte vector in bf16, two in float32.
// Loads go through the read-only path; pointers are 16-byte aligned (the
// wrappers check the base pointers and that C is a multiple of 8).
template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ static Pack load(const __nv_bfloat16* p) {
    Pack r;
    r.v = __ldg(reinterpret_cast<const uint4*>(p));
    return r;
  }
  __device__ __forceinline__ void to_float(float f[8]) const {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // bf16 is the high half of a float32: exact
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float f[8]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k + 1])) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Pack<float> {
  float4 a, b;
  __device__ __forceinline__ static Pack load(const float* p) {
    Pack r;
    r.a = __ldg(reinterpret_cast<const float4*>(p));
    r.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    return r;
  }
  __device__ __forceinline__ void to_float(float f[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  __device__ __forceinline__ static void store(float* p, const float f[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

// One sample's four corners (row lo: x lo, x hi; row hi: x lo, x hi) into
// acc: acc += wy_lo*(wx_lo*v00 + wx_hi*v01) + wy_hi*(wx_lo*v10 + wx_hi*v11),
// every product and sum rounded (-fmad=false).
template <typename T>
__device__ __forceinline__ void add_sample(float acc[8], const Sample& y, const Sample& x,
                                           const Pack<T> v[4]) {
  float f00[8], f01[8], f10[8], f11[8];
  v[0].to_float(f00);
  v[1].to_float(f01);
  v[2].to_float(f10);
  v[3].to_float(f11);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float top = x.w_lo * f00[k] + x.w_hi * f01[k];
    const float bot = x.w_lo * f10[k] + x.w_hi * f11[k];
    acc[k] += y.w_lo * top + y.w_hi * bot;
  }
}

template <typename T>
__device__ __forceinline__ void load_corners(Pack<T> v[4], const T* fc, const Sample& y,
                                             const Sample& x, size_t row, int channels) {
  v[0] = Pack<T>::load(fc + y.lo * row + (size_t)x.lo * channels);
  v[1] = Pack<T>::load(fc + y.lo * row + (size_t)x.hi * channels);
  v[2] = Pack<T>::load(fc + y.hi * row + (size_t)x.lo * channels);
  v[3] = Pack<T>::load(fc + y.hi * row + (size_t)x.hi * channels);
}

// grid (R), block <= kThreads. out [R, pooled, pooled, C]. G: the sampling
// ratio when it is 2 (all 16 corner loads of a bin in flight), else 0.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(Levels lv, const float4* __restrict__ boxes, const int32_t* __restrict__ levels,
                 T* __restrict__ out, int rois_per_image, int channels, int pooled, int grid) {
  __shared__ Sample ys[kMaxSamples];
  __shared__ Sample xs[kMaxSamples];
  const int r = blockIdx.x;
  const int b = r / rois_per_image;
  const Level lvl = pick(lv, levels[r]);
  const int h = lvl.h, w = lvl.w;
  const RoiBox rb = roi_box(boxes[r], lvl.scale);
  const int n = pooled * grid;
  for (int k = threadIdx.x; k < 2 * n; k += blockDim.x) {
    if (k < n)
      ys[k] = axis_sample(rb.sy, rb.rh, pooled, grid, k / grid, k % grid, h);
    else
      xs[k - n] = axis_sample(rb.sx, rb.rw, pooled, grid, (k - n) / grid, (k - n) % grid, w);
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(lvl.ptr) + (size_t)b * h * w * channels;
  T* oroi = out + (size_t)r * pooled * pooled * channels;
  const size_t row = (size_t)w * channels;
  const int chunks = channels / kLaneChannels;
  // items in (bin, channel chunk) order: consecutive lanes on consecutive
  // 16-byte chunks of one bin, consecutive warps on neighbouring bins
  for (int item = threadIdx.x; item < pooled * pooled * chunks; item += blockDim.x) {
    const int bin = item / chunks;
    const int c = (item - bin * chunks) * kLaneChannels;
    const int py = bin / pooled, px = bin - py * pooled;
    const T* fc = feat + c;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (G == 2) {
      Pack<T> v[2][2][4];
#pragma unroll
      for (int iy = 0; iy < 2; ++iy)
#pragma unroll
        for (int ix = 0; ix < 2; ++ix)
          load_corners(v[iy][ix], fc, ys[py * 2 + iy], xs[px * 2 + ix], row, channels);
#pragma unroll
      for (int iy = 0; iy < 2; ++iy)
#pragma unroll
        for (int ix = 0; ix < 2; ++ix) add_sample(acc, ys[py * 2 + iy], xs[px * 2 + ix], v[iy][ix]);
    } else {
      for (int iy = 0; iy < grid; ++iy) {
        const Sample y = ys[py * grid + iy];
        for (int ix = 0; ix < grid; ++ix) {
          const Sample x = xs[px * grid + ix];
          Pack<T> v[4];
          load_corners(v, fc, y, x, row, channels);
          add_sample(acc, y, x, v);
        }
      }
    }
    Pack<T>::store(oroi + (size_t)bin * channels + c, acc);
  }
}

template <typename T>
int launch_forward(const Levels& lv, const float4* bx, const int32_t* lvl, void* out, int rois,
                   int rois_per_image, int channels, int pooled, int grid, cudaStream_t s) {
  // threads: as few rounds over the RoI's items as 256 threads need, then
  // as few warps as cover each round
  const int items = pooled * pooled * (channels / kLaneChannels);
  const int rounds = (items + kThreads - 1) / kThreads;
  const int per_round = (items + rounds - 1) / rounds;
  const int threads = ((per_round + 31) / 32) * 32;
  T* o = static_cast<T*>(out);
  if (grid == 2)
    roi_align_kernel<T, 2><<<rois, threads, 0, s>>>(lv, bx, lvl, o, rois_per_image, channels, pooled, grid);
  else
    roi_align_kernel<T, 0><<<rois, threads, 0, s>>>(lv, bx, lvl, o, rois_per_image, channels, pooled, grid);
  return (int)cudaGetLastError();
}

}  // namespace

// feats: host array of `num_levels` device pointers to NHWC maps [B, H_l, W_l, C],
// each 16-byte aligned, C a multiple of 8; heights/widths/scales: host arrays;
// boxes f32 [R, 4]; levels i32 [R] in [0, num_levels); out [R, pooled, pooled, C].
// dtype 0 = float32, 1 = bfloat16.
extern "C" int roi_align_forward(const void* const* feats, const int* heights, const int* widths,
                                 const float* scales, int num_levels, const void* boxes,
                                 const void* levels, void* out, int rois, int rois_per_image,
                                 int channels, int pooled, int grid, int dtype, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || grid < 1 || grid > kMaxGrid ||
      pooled < 1 || pooled * grid > kMaxSamples || rois_per_image <= 0 || channels <= 0 ||
      channels % kLaneChannels != 0)
    return (int)cudaErrorInvalidValue;
  if (rois <= 0) return 0;
  Levels lv = {};
  lv.num = num_levels;
  for (int i = 0; i < num_levels; ++i) {
    if (reinterpret_cast<uintptr_t>(feats[i]) % 16 != 0) return (int)cudaErrorMisalignedAddress;
    lv.l[i].ptr = feats[i];
    lv.l[i].h = heights[i];
    lv.l[i].w = widths[i];
    lv.l[i].scale = scales[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  const int32_t* lvl = static_cast<const int32_t*>(levels);
  if (dtype == 0)
    return launch_forward<float>(lv, bx, lvl, out, rois, rois_per_image, channels, pooled, grid, s);
  if (dtype == 1)
    return launch_forward<__nv_bfloat16>(lv, bx, lvl, out, rois, rois_per_image, channels, pooled,
                                         grid, s);
  return (int)cudaErrorInvalidValue;
}


namespace {

// One thread per RoI: the inclusive cell range (y0, y1, x0, x1) on its level
// of the corners its samples give a nonzero weight, empty (y0 > y1) if none.
__global__ void roi_footprint_kernel(Levels lv, const float4* __restrict__ boxes,
                                     const int32_t* __restrict__ levels, int4* __restrict__ fp,
                                     int rois, int pooled, int grid) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rois) return;
  const Level lvl = pick(lv, levels[r]);
  const RoiBox rb = roi_box(boxes[r], lvl.scale);
  int4 f = make_int4(INT_MAX, -1, INT_MAX, -1);
  for (int k = 0; k < pooled * grid; ++k) {
    const Sample y = axis_sample(rb.sy, rb.rh, pooled, grid, k / grid, k % grid, lvl.h);
    const Sample x = axis_sample(rb.sx, rb.rw, pooled, grid, k / grid, k % grid, lvl.w);
    if (y.w_lo != 0.0f) { f.x = min(f.x, y.lo); f.y = max(f.y, y.lo); }
    if (y.w_hi != 0.0f) { f.x = min(f.x, y.hi); f.y = max(f.y, y.hi); }
    if (x.w_lo != 0.0f) { f.z = min(f.z, x.lo); f.w = max(f.w, x.lo); }
    if (x.w_hi != 0.0f) { f.z = min(f.z, x.hi); f.w = max(f.w, x.hi); }
  }
  fp[r] = f;
}

// One cotangent bin's 8 channels into the tile row this thread owns: every
// corner of the bin's samples that lands in (gy, [x0, x0 + kTile)) adds
// (wy * wx) * g, the plain version's product, in a fixed order.
template <typename T, int G>
__device__ __forceinline__ void scatter_bin(float* arow, int lanes, int lane, int gy, int x0,
                                            const Sample* ysb, const Sample* xsb, int grid,
                                            const Pack<T>& gp) {
  float g[8];
  gp.to_float(g);
  if constexpr (G != 0) grid = G;
#pragma unroll
  for (int iy = 0; iy < grid; ++iy) {
    const Sample y = ysb[iy];
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
      const int yy = cy ? y.hi : y.lo;
      const float wy = cy ? y.w_hi : y.w_lo;
      if (yy != gy || wy == 0.0f) continue;
#pragma unroll
      for (int ix = 0; ix < grid; ++ix) {
        const Sample x = xsb[ix];
#pragma unroll
        for (int cx = 0; cx < 2; ++cx) {
          const int tx = (cx ? x.hi : x.lo) - x0;
          const float wt = __fmul_rn(wy, cx ? x.w_hi : x.w_lo);
          if (tx < 0 || tx >= kTile || wt == 0.0f) continue;
          // a cell's lanes*8 floats: lane's channels 0-3 at lane*4, 4-7 at (lanes + lane)*4
          float4* a = reinterpret_cast<float4*>(arow + tx * lanes * kLaneChannels);
          float4 u = a[lane], v = a[lanes + lane];
          u.x += __fmul_rn(wt, g[0]); u.y += __fmul_rn(wt, g[1]);
          u.z += __fmul_rn(wt, g[2]); u.w += __fmul_rn(wt, g[3]);
          v.x += __fmul_rn(wt, g[4]); v.y += __fmul_rn(wt, g[5]);
          v.z += __fmul_rn(wt, g[6]); v.w += __fmul_rn(wt, g[7]);
          a[lane] = u;
          a[lanes + lane] = v;
        }
      }
    }
  }
}

// Whether a bin's samples (first and last of `grid`) have cells in row gy,
// or in the tile's columns [x0, x0 + kTile).
__device__ __forceinline__ bool meets_row(const Sample* s, int grid, int gy) {
  return s[0].lo <= gy && s[grid - 1].hi >= gy;
}

__device__ __forceinline__ bool meets_cols(const Sample* s, int grid, int x0) {
  return s[0].lo < x0 + kTile && s[grid - 1].hi >= x0;
}

// grid (tiles of all levels and images, coarsest level first; channel
// slices), block kThreads: kTile lane groups of `lanes` = slice/8 threads
// (rounded up to whole warps), group t owning tile row t. Dynamic shared
// memory: the float32 tile [kTile][kTile][lanes*8], then the sample tables
// of `batch` RoIs. G: the sampling ratio when it is 2, else 0.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
roi_align_backward_kernel(Levels lv, const float4* __restrict__ boxes,
                          const int32_t* __restrict__ levels, const int4* __restrict__ fp,
                          const T* __restrict__ grad, T* __restrict__ out, int rois_per_image,
                          int channels, int pooled, int grid, int lanes, int batch) {
  if constexpr (G != 0) grid = G;
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const int n = pooled * grid;
  Sample* tables = reinterpret_cast<Sample*>(tile + kTile * kTile * lanes * kLaneChannels);
  __shared__ int kept[kThreads];
  __shared__ int warp_kept[kThreads / 32];

  // which level, image and tile
  const int bid = blockIdx.x;
  int l = 0;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i < lv.num && bid >= lv.l[i].first_block && bid < lv.l[i].first_block + lv.l[i].blocks) l = i;
  const Level lvl = pick(lv, l);
  const int h = lvl.h, w = lvl.w, tiles_x = lvl.tiles_x;
  const int tiles_y = (h + kTile - 1) / kTile;
  int t = bid - lvl.first_block;
  const int b = t / (tiles_y * tiles_x);
  t -= b * tiles_y * tiles_x;
  const int y0 = (t / tiles_x) * kTile, x0 = (t % tiles_x) * kTile;
  const int c0 = blockIdx.y * kSlice;
  const int slice = min(kSlice, channels - c0);

  const int row = threadIdx.x / lanes, lane = threadIdx.x - row * lanes;
  const bool active = row < kTile && lane * kLaneChannels < slice;
  const int gy = y0 + row;
  float* arow = tile + row * kTile * lanes * kLaneChannels;
  if (row < kTile)
    for (int k = lane; k < kTile * lanes * 2; k += lanes)
      reinterpret_cast<float4*>(arow)[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const unsigned below = (1u << (threadIdx.x % 32)) - 1u;
  const int first = b * rois_per_image;
  for (int start = 0; start < rois_per_image; start += blockDim.x) {
    // the RoIs of this chunk whose footprint on this level meets the tile, in RoI order
    const int i = start + threadIdx.x;
    bool keep = false;
    if (i < rois_per_image) {
      const int li = levels[first + i];
      const int4 f = fp[first + i];
      keep = li == l && f.x <= y0 + kTile - 1 && f.y >= y0 && f.z <= x0 + kTile - 1 && f.w >= x0;
    }
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (threadIdx.x % 32 == 0) warp_kept[warp] = __popc(m);
    __syncthreads();
    int offset = 0, total = 0;
    for (int k = 0; k < nwarps; ++k) {
      offset += k < warp ? warp_kept[k] : 0;
      total += warp_kept[k];
    }
    if (keep) kept[offset + __popc(m & below)] = first + i;
    __syncthreads();

    for (int k0 = 0; k0 < total; k0 += batch) {
      const int kb = min(batch, total - k0);
      for (int e = threadIdx.x; e < kb * 2 * n; e += blockDim.x) {
        const int r = kept[k0 + e / (2 * n)], j = e % (2 * n);
        const RoiBox rb = roi_box(boxes[r], lvl.scale);
        tables[e] = j < n ? axis_sample(rb.sy, rb.rh, pooled, grid, j / grid, j % grid, h)
                          : axis_sample(rb.sx, rb.rw, pooled, grid, (j - n) / grid, (j - n) % grid, w);
      }
      __syncthreads();
      if (active) {
        for (int k = 0; k < kb; ++k) {
          const Sample* ys = tables + k * 2 * n;
          const Sample* xs = ys + n;
          const T* groi = grad + (size_t)kept[k0 + k] * pooled * pooled * channels + c0 +
                          lane * kLaneChannels;
          // the bins, in row-major order, whose samples have a cell in this
          // row and in the tile's columns: a bin's samples' cells grow with
          // the sample index, so its first and last sample bound them
          for (int py = 0; py < pooled; ++py) {
            if (!meets_row(ys + py * grid, grid, gy)) continue;
            for (int px = 0; px < pooled; ++px) {
              if (!meets_cols(xs + px * grid, grid, x0)) continue;
              scatter_bin<T, G>(arow, lanes, lane, gy, x0, ys + py * grid, xs + px * grid, grid,
                                Pack<T>::load(groi + (size_t)(py * pooled + px) * channels));
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // every cell of the tile once, in the output dtype
  if (active && gy < h) {
    T* orow = out + lvl.offset + ((size_t)(b * h + gy) * w + x0) * channels + c0 + lane * kLaneChannels;
    for (int tx = 0; tx < kTile && x0 + tx < w; ++tx) {
      const float4* a = reinterpret_cast<const float4*>(arow + tx * lanes * kLaneChannels);
      const float4 u = a[lane], v = a[lanes + lane];
      const float f[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
      Pack<T>::store(orow + (size_t)tx * channels, f);
    }
  }
}

template <typename T, int G>
int launch_backward(const Levels& lv, int blocks, const float4* bx, const int32_t* lvl,
                    const int4* fp, const void* grad, void* out, int rois_per_image, int channels,
                    int pooled, int grid, cudaStream_t s) {
  const int lanes = min(channels, kSlice) / kLaneChannels;
  const int threads = ((kTile * lanes + 31) / 32) * 32;
  const int batch = max(1, kTableBytes / (2 * pooled * grid * (int)sizeof(Sample)));
  const size_t shared = (size_t)kTile * kTile * lanes * kLaneChannels * sizeof(float) +
                        (size_t)batch * 2 * pooled * grid * sizeof(Sample);
  auto kernel = roi_align_backward_kernel<T, G>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  // all of L1 as shared memory, so that as many blocks as fit share an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 g(blocks, (channels + kSlice - 1) / kSlice);
  kernel<<<g, threads, shared, s>>>(lv, bx, lvl, fp, static_cast<const T*>(grad), static_cast<T*>(out),
                                    rois_per_image, channels, pooled, grid, lanes, batch);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_backward(const Levels& lv, int blocks, const float4* bx, const int32_t* lvl,
                    const int4* fp, const void* grad, void* out, int rois_per_image, int channels,
                    int pooled, int grid, cudaStream_t s) {
  if (grid == 2)
    return launch_backward<T, 2>(lv, blocks, bx, lvl, fp, grad, out, rois_per_image, channels, pooled,
                                 grid, s);
  return launch_backward<T, 0>(lv, blocks, bx, lvl, fp, grad, out, rois_per_image, channels, pooled,
                               grid, s);
}

}  // namespace

// heights/widths/scales/offsets: host arrays, one per level; offsets are
// element offsets of each level's [B, H_l, W_l, C] map in `out`, which
// holds them all in the cotangent's dtype and is written whole. boxes f32
// [B * N, 4]; levels i32 [B * N]; grad [B * N, pooled, pooled, C], 16-byte
// aligned, C a multiple of 8; footprints: int32 [B * N, 4] scratch.
// dtype 0 = float32, 1 = bfloat16.
extern "C" int roi_align_backward(const int* heights, const int* widths, const float* scales,
                                  const long long* offsets, int num_levels, const void* boxes,
                                  const void* levels, const void* grad, void* footprints, void* out,
                                  int batch, int rois_per_image, int channels, int pooled, int grid,
                                  int dtype, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || grid < 1 || grid > kMaxGrid || pooled < 1 ||
      pooled * grid > kMaxSamples || batch < 1 || rois_per_image <= 0 || channels <= 0 ||
      channels % kLaneChannels != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(grad) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  // the coarsest level's tiles first: they meet the most RoIs each
  Levels lv = {};
  lv.num = num_levels;
  long long blocks = 0;
  for (int i = num_levels - 1; i >= 0; --i) {
    Level& l = lv.l[i];
    l.offset = offsets[i];
    l.h = heights[i];
    l.w = widths[i];
    l.scale = scales[i];
    l.tiles_x = (widths[i] + kTile - 1) / kTile;
    l.first_block = (int)blocks;
    blocks += (long long)batch * ((heights[i] + kTile - 1) / kTile) * l.tiles_x;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    l.blocks = (int)(blocks - l.first_block);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rois = batch * rois_per_image;
  const float4* bx = static_cast<const float4*>(boxes);
  const int32_t* lvl = static_cast<const int32_t*>(levels);
  int4* fp = static_cast<int4*>(footprints);
  roi_footprint_kernel<<<(rois + 127) / 128, 128, 0, s>>>(lv, bx, lvl, fp, rois, pooled, grid);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    return launch_backward<float>(lv, (int)blocks, bx, lvl, fp, grad, out, rois_per_image, channels,
                                  pooled, grid, s);
  return launch_backward<__nv_bfloat16>(lv, (int)blocks, bx, lvl, fp, grad, out, rois_per_image,
                                        channels, pooled, grid, s);
}
