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
// two launches, and the chain touches registers and shared memory only:
//   1. nms_iou_mask_kernel: every IoU test of the upper triangle at once,
//      one block per (problem, 64-row block r, 64-column block c >= r):
//      W(W+1)/2 blocks a problem, W = ceil(N/64). Rows and columns pass
//      through shared memory with their +1 areas computed once; the IEEE
//      division runs only where the boxes meet (or thr <= 0). Block (r, c)
//      writes its 64 suppression words side by side, and the blocks of row
//      block r follow each other (c = r .. W-1), so row block k's words
//      [k, W) are one contiguous run of scratch.
//   2. nms_block_scan_kernel: one block per problem walks the row blocks
//      in order. The valid flags become 64-bit words (a ballot) and the
//      cross-block "removed" bitset lives in shared memory. While row block
//      k resolves, cp.async stages block k+1's run into the other of two
//      buffers. Block k's own rows resolve in registers (a bit test and a
//      masked AND a row, the staged diagonal words loaded off the chain);
//      then the warps OR the kept rows' words into the later words of
//      "removed", a warp per word, and one barrier ends the row block.
// No host sync: the scan writes fixed-size flags [P, N].
//
// Exactness: the IoU uses the explicitly rounded intrinsics below (and the
// file is built with -fmad=false) so that a_i + a_j - inter is never
// contracted into an FMA and every comparison matches float32 on the CPU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;  // rows and columns of a mask block: one 64-bit word per row
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
// dynamic shared memory a block may opt in to on sm_90
constexpr size_t kMaxSmem = 232448;

constexpr size_t scan_smem_bytes(int words) {
  // two staged runs of a row block, "removed", valid words, in-block hits
  return (size_t)(2 * kBlock + 3) * words * sizeof(u64);
}

// first mask block of row block r: blocks (r, r), (r, r+1), ... follow it
__host__ __device__ __forceinline__ int tri_start(int r, int words) { return r * words - r * (r - 1) / 2; }

__device__ __forceinline__ float area_plus1(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

__device__ __forceinline__ bool iou_at_least(float4 a, float area_a, float4 b, float area_b, float thr) {
  float w = fmaxf(__fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f), 0.0f);
  float h = fmaxf(__fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f), 0.0f);
  float inter = __fmul_rn(w, h);
  // boxes that do not meet have IoU 0, which fails every thr > 0 (and a NaN thr)
  if (!(inter > 0.0f) && !(thr <= 0.0f)) return false;
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-10f)) >= thr;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// start copying `count` words (a multiple of 2) from device to shared memory
__device__ __forceinline__ void stage_run(u64* dst, const u64* src, int count) {
  for (int q = threadIdx.x; q < count / 2; q += kScanThreads) cp_async16(dst + 2 * q, src + 2 * q);
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ unsigned bit_mask(unsigned v, int b) {  // all ones where bit b of v is set
  return (unsigned)((int)(v << (31 - b)) >> 31);
}

// The greedy result within one row block: the rows of `cand` (valid, not
// removed by earlier row blocks) that no earlier kept row of the block
// suppresses. `diag` holds the block's own 64 words, bits only above each
// row. Rows are walked in order, unrolled and without branches: row b, if
// still a candidate, clears what it suppresses. The chain is three ALU
// operations a row; no load depends on it, so the loads run ahead of it.
// (One step per kept row, `__ffsll` of the candidates and a load of that
// row's word, wins only where few rows are kept: scripts/bench_nms.py's
// `ffs_loop` variant.)
__device__ __forceinline__ u64 resolve_block(u64 cand, const u64* diag) {
  unsigned lo = (unsigned)cand, hi = (unsigned)(cand >> 32);
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const u64 d = diag[b];
    const unsigned m = bit_mask(lo, b);
    lo &= ~((unsigned)d & m);
    hi &= ~((unsigned)(d >> 32) & m);
  }
#pragma unroll
  for (int b = 0; b < 32; ++b)  // rows 32..63 suppress in the high half only
    hi &= ~((unsigned)(diag[32 + b] >> 32) & bit_mask(hi, b));
  return (u64)hi << 32 | lo;
}

// grid (W(W+1)/2, P), block kBlock; blockIdx.x = tri_start(r, W) + (c - r)
__global__ void __launch_bounds__(kBlock) nms_iou_mask_kernel(const float4* __restrict__ boxes,
                                                              const float* __restrict__ thr,
                                                              u64* __restrict__ mask, int n, int words) {
  __shared__ float4 rows[kBlock], cols[kBlock];
  __shared__ float row_area[kBlock], col_area[kBlock];
  const int t = blockIdx.x, p = blockIdx.y, x = threadIdx.x;
  // the row block r with tri_start(r) <= t < tri_start(r + 1), from the
  // quadratic's root, then exact in integers
  const float b = 2.0f * words + 1.0f;
  int r = min(max((int)(0.5f * (b - sqrtf(b * b - 8.0f * t))), 0), words - 1);
  while (r + 1 < words && tri_start(r + 1, words) <= t) ++r;
  while (tri_start(r, words) > t) --r;
  const int c = r + t - tri_start(r, words);

  const float4* pb = boxes + (size_t)p * n;
  const int i = r * kBlock + x, j = c * kBlock + x;
  if (i < n) {
    const float4 v = pb[i];
    rows[x] = v;
    row_area[x] = area_plus1(v);
  }
  if (j < n) {
    const float4 v = pb[j];
    cols[x] = v;
    col_area[x] = area_plus1(v);
  }
  __syncthreads();
  if (i >= n) return;  // rows past N are never valid: the scan never uses their words
  const float4 bi = rows[x];
  const float ai = row_area[x], th = thr[p];
  const int ncols = min(kBlock, n - c * kBlock);
  u64 bits = 0;
  for (int k = c == r ? x + 1 : 0; k < ncols; ++k)  // only later boxes
    if (iou_at_least(bi, ai, cols[k], col_area[k], th)) bits |= 1ull << k;
  mask[((size_t)p * gridDim.x + t) * kBlock + x] = bits;
}

// grid P, block kScanThreads, dynamic shared memory scan_smem_bytes(W)
__global__ void __launch_bounds__(kScanThreads) nms_block_scan_kernel(const u64* __restrict__ mask,
                                                                      const uint8_t* __restrict__ valid,
                                                                      uint8_t* __restrict__ suppressed,
                                                                      int n, int words) {
  extern __shared__ __align__(16) u64 smem[];
  const size_t buf = (size_t)words * kBlock;  // a staging buffer; row block k's run is (W - k) x 64 words
  u64* removed = smem + 2 * buf;  // by kept rows of earlier row blocks
  u64* valid_w = removed + words;
  u64* hits = valid_w + words;  // by kept rows of the same row block
  const int p = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const u64* pm = mask + (size_t)p * (words * (words + 1) / 2) * kBlock;

  stage_run(smem, pm, words * kBlock);
  const uint8_t* pv = valid + (size_t)p * n;
  for (int w = warp; w < words; w += kScanWarps) {
    const int i = w * kBlock + lane;
    const unsigned lo = __ballot_sync(~0u, i < n && pv[i]);
    const unsigned hi = __ballot_sync(~0u, i + 32 < n && pv[i + 32]);
    if (lane == 0) {
      valid_w[w] = (u64)hi << 32 | lo;
      removed[w] = 0;
      hits[w] = 0;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int k = 0; k < words; ++k) {
    const u64* cur = smem + (k & 1) * buf;
    if (k + 1 < words) stage_run(smem + ((k + 1) & 1) * buf, pm + (size_t)tri_start(k + 1, words) * kBlock,
                                 (words - k - 1) * kBlock);
    // every thread resolves the row block's own rows, the same steps on
    // registers; the staged diagonal words load off the chain
    const u64 kept = resolve_block(valid_w[k] & ~removed[k], cur);
    // the kept rows' suppressions: a warp per word ORs the kept rows' staged
    // words (a lane per row, two rows a lane), word k into the row block's
    // own hits and the later words into "removed". A warp's j-th word waits
    // in lane j and is stored after the loop, so that no shared-memory store
    // holds the loop's loads back.
    if (kept) {
      const bool k0 = (kept >> lane) & 1, k1 = (kept >> (lane + 32)) & 1;
      u64 mine = 0;
      int steps = 0;
#pragma unroll 4
      for (int w = k + warp; w < words; w += kScanWarps, ++steps) {
        const u64* run = cur + (size_t)(w - k) * kBlock;
        const u64 v = (k0 ? run[lane] : 0ull) | (k1 ? run[lane + 32] : 0ull);
        const unsigned lo = __reduce_or_sync(~0u, (unsigned)v);
        const unsigned hi = __reduce_or_sync(~0u, (unsigned)(v >> 32));
        if (lane == steps) mine = (u64)hi << 32 | lo;
      }
      const int w = k + warp + kScanWarps * lane;
      if (lane < steps) {
        if (w == k) hits[k] = mine;
        else removed[w] |= mine;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  uint8_t* out = suppressed + (size_t)p * n;
  for (int i = threadIdx.x; i < n; i += kScanThreads)
    out[i] = (uint8_t)(((removed[i >> 6] | hits[i >> 6]) >> (i & 63)) & 1ull);
}

}  // namespace

// boxes f32 [P, N, 4] sorted by descending score; valid u8 [P, N];
// thr f32 [P]; scratch u64 [P, W(W+1)/2, 64] with W = ceil(N/64);
// suppressed u8 [P, N] (0 or 1). N may be at most 14144 (the scan's two
// staged runs of 64 x W words in 227 KB of shared memory).
extern "C" int nms_suppress(const void* boxes, const void* valid, const void* thr, void* scratch,
                            void* suppressed, int problems, int n, void* stream) {
  if (problems <= 0 || n <= 0) return 0;
  const int words = (n + kBlock - 1) / kBlock;
  const size_t smem = scan_smem_bytes(words);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_iou_mask_kernel<<<dim3(words * (words + 1) / 2, problems), kBlock, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(thr), static_cast<u64*>(scratch), n, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_block_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_block_scan_kernel<<<problems, kScanThreads, smem, s>>>(
      static_cast<const u64*>(scratch), static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(suppressed), n,
      words);
  return (int)cudaGetLastError();
}
