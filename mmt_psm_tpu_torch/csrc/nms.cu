// Exact greedy NMS suppression flags for a batch of independent problems.
//
// Replaces the Pallas TPU kernel `_nms_kernel` in
// mmt_psm_tpu/ops/nms_pallas.py (launched by `nms_suppress_pallas`). Same
// semantics: boxes are pre-sorted by descending score; box j is suppressed
// when an earlier, valid, unsuppressed box i has
//   IoU(i, j) = inter / max(a_i + a_j - inter, 1e-10) >= thr
// with the +1 area convention; invalid and padding rows never suppress.
//
// What bounds it on the H100: not bytes (a 1000-box problem is 16 KB of
// boxes) and not arithmetic (N^2/2 IoUs, ~8 MFLOP per problem), but the
// greedy dependency chain: box i's fate depends on every earlier keep.
// The TPU kernel resolved that with a Jacobi fixpoint per 128-box tile
// because its grid runs in order on one core. Here the work is split in
// two launches instead:
//   1. nms_mask_kernel: all IoU tests at once, in parallel over every
//      (problem, 64-row block, 64-column block) of the upper triangle,
//      written as 64-bit suppression words into scratch [P, N, W].
//   2. nms_scan_kernel: one warp per problem walks the rows in order; the
//      "removed" bitset (W words) lives in shared memory and a kept row ORs
//      its W words into it, the lanes splitting the words. The sequential
//      part is N steps of a few shared-memory operations.
// No host sync: the scan writes fixed-size flags [P, N].
//
// Exactness: the IoU uses the explicitly rounded intrinsics below (and the
// file is built with -fmad=false) so that a_i + a_j - inter is never
// contracted into an FMA and every comparison matches float32 on the CPU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;

__device__ __forceinline__ float area_plus1(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

__device__ __forceinline__ bool iou_at_least(float4 a, float4 b, float thr) {
  float w = fmaxf(__fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f), 0.0f);
  float h = fmaxf(__fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f), 0.0f);
  float inter = __fmul_rn(w, h);
  float uni = __fsub_rn(__fadd_rn(area_plus1(a), area_plus1(b)), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-10f)) >= thr;
}

// grid (W, W, P), block kBlock. Row block blockIdx.y, column block blockIdx.x.
__global__ void nms_mask_kernel(const float4* __restrict__ boxes, const float* __restrict__ thr,
                                unsigned long long* __restrict__ mask, int n, int words) {
  const int col_block = blockIdx.x, row_block = blockIdx.y, p = blockIdx.z;
  if (col_block < row_block) return;  // lower triangle: never read by the scan
  __shared__ float4 cols[kBlock];
  const float4* pb = boxes + (size_t)p * n;
  const int c = col_block * kBlock + threadIdx.x;
  if (c < n) cols[threadIdx.x] = pb[c];
  __syncthreads();
  const int i = row_block * kBlock + threadIdx.x;
  if (i >= n) return;
  const float4 bi = pb[i];
  const float t = thr[p];
  const int ncols = min(kBlock, n - col_block * kBlock);
  unsigned long long bits = 0;
  for (int k = 0; k < ncols; ++k) {
    const int j = col_block * kBlock + k;
    if (j > i && iou_at_least(bi, cols[k], t)) bits |= 1ull << k;
  }
  mask[((size_t)p * n + i) * words + col_block] = bits;
}

// grid P, block 32 (one warp), dynamic shared memory words * 8 bytes.
__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid, uint8_t* __restrict__ suppressed,
                                int n, int words) {
  extern __shared__ unsigned long long removed[];
  const int p = blockIdx.x, lane = threadIdx.x;
  for (int w = lane; w < words; w += 32) removed[w] = 0ull;
  __syncwarp();
  const uint8_t* pv = valid + (size_t)p * n;
  const unsigned long long* pm = mask + (size_t)p * n * words;
  for (int i = 0; i < n; ++i) {
    const int wi = i >> 6;
    const bool alive = !((removed[wi] >> (i & 63)) & 1ull) && pv[i];
    __syncwarp();
    if (alive) {
      const unsigned long long* row = pm + (size_t)i * words;
      for (int w = wi + lane; w < words; w += 32) removed[w] |= row[w];
    }
    __syncwarp();
  }
  uint8_t* out = suppressed + (size_t)p * n;
  for (int i = lane; i < n; i += 32) out[i] = (uint8_t)((removed[i >> 6] >> (i & 63)) & 1ull);
}

}  // namespace

// boxes f32 [P, N, 4] sorted by descending score; valid u8 [P, N];
// thr f32 [P]; scratch u64 [P, N, ceil(N/64)]; suppressed u8 [P, N].
extern "C" int nms_suppress(const void* boxes, const void* valid, const void* thr, void* scratch,
                            void* suppressed, int problems, int n, void* stream) {
  if (problems <= 0 || n <= 0) return 0;
  const int words = (n + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(words, words, problems);
  nms_mask_kernel<<<grid, kBlock, 0, s>>>(static_cast<const float4*>(boxes),
                                          static_cast<const float*>(thr),
                                          static_cast<unsigned long long*>(scratch), n, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<problems, 32, words * sizeof(unsigned long long), s>>>(
      static_cast<const unsigned long long*>(scratch), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(suppressed), n, words);
  return (int)cudaGetLastError();
}
