// FrozenBN applied in the ResNet body's conv epilogues on forwards that
// record no gradient: K5 prepares a conv-FrozenBN pair (the conv's weight in
// the compute dtype, FrozenBN's scale and shift) in one launch, and K6
// applies the scale, the shift, the residual add and the ReLU to the conv's
// output in one in-place pass.
//
// Neither replaces a Pallas kernel. The JAX package computes FrozenBN as
// plain jnp arithmetic (mmt_psm_tpu/models/layers.py::FrozenBatchNorm),
// which XLA fuses into the convolution's epilogue on the TPU. The port's
// unfused form (models/layers.py::FrozenBatchNorm2d.forward) recomputes
// scale and shift from the four buffers on every call in five launches,
// casts both and the conv's weight, then multiplies and adds over the
// activation; a ReLU and the residual add follow, each its own pass. On the
// card those passes took 103 of 170 ms of a C4 serving batch, and a conv
// ~12 launches. These kernels make a conv-FrozenBN(-residual)-ReLU three
// launches: K5, cuDNN's convolution, K6. Their plain versions sit beside
// the wrappers (models/layers.py::prepare_conv_bn_plain,
// bn_residual_relu_plain).
//
// The arithmetic is the unfused formula's, operation for operation: y *
// scale, then + shift, the downsample's residual r * scale' + shift' the
// same way, then the residual add and the ReLU, each float32 operation
// separately rounded (-fmad=false and the _rn intrinsics) and, in bf16,
// each result rounded to bf16 as PyTorch's bf16 operators round it, with
// scale and shift themselves cast to bf16 first. So the output equals the
// unfused formula's bit for bit in both dtypes: only passes and launches
// go, no rounding changes. (Folding the scale into the conv's weight
// instead rounds W * scale once more in float32 and moves the MT teacher's
// features by ~1e-6 of their size, which the parity tests against the JAX
// package do not absorb.)
//
// K5, prepare_conv_bn: scale = weight * (1 / sqrt(var)), no eps, shift =
// bias - mean * scale (__fsqrt_rn, __frcp_rn), and the conv's float32
// weight cast to bf16 where the compute dtype is bf16 (in float32 the conv
// takes its own weight). What bounds it: bytes, the weight read once and
// written once (~141 MB a forward of the R-50 body, tens of microseconds);
// most calls are small enough that the launch itself is the time. One
// grid-stride loop over the weight and one over the channels, coalesced.
//
// K6, bn_residual_relu: y = relu(y * scale + shift (+ residual)), written
// over y. The conv's output is channels_last, so its memory is NHWC [M, C]. What bounds it: bytes, y (and the residual) read
// once and y written once, at 3.35 TB/s. A thread owns one 16-byte vector
// of channels (8 in bf16, 4 in float32): its constants stay in registers
// while it walks rows in a grid-stride loop, and a warp's loads cover whole
// 512-byte runs of neighbouring rows or channels; the residual is read
// through the read-only path. The grid holds as many blocks as the SMs keep
// resident and no more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 8 x 256 threads: an SM's 2,048

int resident_blocks(int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = sms * kBlocksPerSm;
  return (int)err;
}

// grid-stride over the weight (out null: no cast) and over the channels.
// w f32 [n]; out bf16 [n]; bn_* f32 [C]; ss f32 [2, C]: scale, then shift.
__global__ void __launch_bounds__(kThreads)
prepare_conv_bn_kernel(const float* __restrict__ w, const float* __restrict__ bn_w,
                       const float* __restrict__ bn_b, const float* __restrict__ bn_mean,
                       const float* __restrict__ bn_var, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ ss, int channels, long long n) {
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long c = first; c < channels; c += step) {
    const float s = __fmul_rn(bn_w[c], __frcp_rn(__fsqrt_rn(bn_var[c])));
    ss[c] = s;
    ss[channels + c] = __fsub_rn(bn_b[c], __fmul_rn(bn_mean[c], s));
  }
  if (out != nullptr)
    for (long long i = first; i < n; i += step) out[i] = __float2bfloat16_rn(w[i]);
}

// 16 bytes of channels: 8 in bf16, 4 in float32, as floats; round(v): v
// rounded to T, as a float.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static void to_float(uint4 v, float f[kN]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 is the high half of a float32: exact
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 from_float(const float f[kN]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static float round(float v) { return v; }
  __device__ __forceinline__ static void to_float(uint4 v, float f[kN]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 from_float(const float f[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// kN floats of a [2, C] scale-and-shift table at vector v, cast to T as
// the unfused formula casts them: scale, shift
template <typename T>
__device__ __forceinline__ void load_constants(const float* ss, int channels, int v,
                                               float s[Vec<T>::kN], float sh[Vec<T>::kN]) {
  constexpr int kN = Vec<T>::kN;
#pragma unroll
  for (int i = 0; i < kN; i += 4) {
    const float4 a = reinterpret_cast<const float4*>(ss + (size_t)v * kN)[i / 4];
    const float4 b = reinterpret_cast<const float4*>(ss + channels + (size_t)v * kN)[i / 4];
    const float sa[4] = {a.x, a.y, a.z, a.w}, sb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i + j] = Vec<T>::round(sa[j]);
      sh[i + j] = Vec<T>::round(sb[j]);
    }
  }
}

// x * scale + shift, each result rounded to T
template <typename T>
__device__ __forceinline__ float scale_shift(float x, float scale, float shift) {
  return Vec<T>::round(__fadd_rn(Vec<T>::round(__fmul_rn(x, scale)), shift));
}

enum Residual { kNone = 0, kPlain = 1, kScaled = 2 };

// grid (row blocks, ceil(V / blockDim.x)), block (min(V, 32), kThreads / that):
// threadIdx.x and blockIdx.y pick the thread's vector of channels, the
// rest its rows. y [M, V] 16-byte vectors (residual alike); ss, rss f32
// [2, C]. ReLU as torch.relu: a NaN stays NaN, and ReLU commutes with the
// rounding to T.
template <typename T, int kRes>
__global__ void __launch_bounds__(kThreads)
bn_residual_relu_kernel(uint4* __restrict__ y, const uint4* __restrict__ residual,
                        const float* __restrict__ ss, const float* __restrict__ rss, long long rows,
                        int vecs) {
  constexpr int kN = Vec<T>::kN;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= vecs) return;
  const int channels = vecs * kN;
  float s[kN], sh[kN], rs[kN], rsh[kN];
  load_constants<T>(ss, channels, v, s, sh);
  if (kRes == kScaled) load_constants<T>(rss, channels, v, rs, rsh);
  const long long step = (long long)gridDim.x * blockDim.y;
  for (long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y; r < rows; r += step) {
    const size_t at = (size_t)r * vecs + v;
    float a[kN];
    Vec<T>::to_float(y[at], a);
#pragma unroll
    for (int i = 0; i < kN; ++i) a[i] = scale_shift<T>(a[i], s[i], sh[i]);
    if (kRes != kNone) {
      float b[kN];
      Vec<T>::to_float(__ldg(residual + at), b);
      if (kRes == kScaled) {
#pragma unroll
        for (int i = 0; i < kN; ++i) b[i] = scale_shift<T>(b[i], rs[i], rsh[i]);
      }
#pragma unroll
      for (int i = 0; i < kN; ++i) a[i] = __fadd_rn(a[i], b[i]);  // rounded to T at the store
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) a[i] = a[i] < 0.0f ? 0.0f : a[i];
    y[at] = Vec<T>::from_float(a);
  }
}

template <typename T, int kRes>
int launch_mode(void* y, const void* residual, const float* ss, const float* rss,
                    long long rows, int channels, cudaStream_t stream) {
  const int vecs = channels / Vec<T>::kN;
  int resident = 0;
  const int err = resident_blocks(&resident);
  if (err != 0) return err;
  const int bx = vecs < 32 ? vecs : 32;
  const int by = kThreads / bx;
  const int gy = (vecs + bx - 1) / bx;
  const long long want = (rows + by - 1) / by;
  const long long room = resident / gy > 0 ? resident / gy : 1;
  bn_residual_relu_kernel<T, kRes><<<dim3((int)(want < room ? want : room), gy), dim3(bx, by), 0, stream>>>(
      static_cast<uint4*>(y), static_cast<const uint4*>(residual), ss, rss, rows, vecs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_epilogue(void* y, const void* residual, const float* ss, const float* rss,
                    long long rows, int channels, cudaStream_t stream) {
  if (residual == nullptr)
    return launch_mode<T, kNone>(y, residual, ss, rss, rows, channels, stream);
  if (rss == nullptr)
    return launch_mode<T, kPlain>(y, residual, ss, rss, rows, channels, stream);
  return launch_mode<T, kScaled>(y, residual, ss, rss, rows, channels, stream);
}

}  // namespace

// weight: f32 [n] (a conv's [O, I, kh, kw], contiguous); bn_*: f32
// [channels] (weight, bias, running_mean, running_var); out: bf16 [n], or
// null where the conv computes in float32 and takes its own weight; ss: f32
// [2, channels], scale then shift. Launches on `stream`; returns the
// launch's CUDA error code.
extern "C" int prepare_conv_bn(const void* weight, const void* bn_w, const void* bn_b,
                               const void* bn_mean, const void* bn_var, void* out, void* ss,
                               int channels, long long n, void* stream) {
  if (channels < 1 || n < 0) return (int)cudaErrorInvalidValue;
  int resident = 0;
  const int err = resident_blocks(&resident);
  if (err != 0) return err;
  const long long work = n > channels ? n : channels;
  const long long want = (work + kThreads - 1) / kThreads;
  prepare_conv_bn_kernel<<<(int)(want < resident ? want : resident), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(weight), static_cast<const float*>(bn_w),
      static_cast<const float*>(bn_b), static_cast<const float*>(bn_mean),
      static_cast<const float*>(bn_var), static_cast<__nv_bfloat16*>(out), static_cast<float*>(ss),
      channels, n);
  return (int)cudaGetLastError();
}

// y: [rows, channels] in `dtype` (a channels_last conv output), updated in
// place; ss: f32 [2, channels], scale then shift; residual: the same shape
// and dtype as y, or null; rss: the residual's own scale and shift [2,
// channels] (a downsample conv's FrozenBN), or null where it is added as it
// is. channels a multiple of 8, every pointer 16-byte aligned. dtype 0 =
// float32, 1 = bfloat16. Launches on `stream`; returns the launch's CUDA
// error code.
extern "C" int bn_residual_relu(void* y, const void* ss, const void* residual, const void* rss,
                                long long rows, int channels, int dtype, void* stream) {
  if (rows < 0 || channels < 8 || channels % 8 != 0 || (dtype != 0 && dtype != 1) ||
      (residual == nullptr && rss != nullptr))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {static_cast<const void*>(y), ss, residual, rss})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(ss);
  const float* b = static_cast<const float*>(rss);
  if (dtype == 0) return launch_epilogue<float>(y, residual, a, b, rows, channels, s);
  return launch_epilogue<__nv_bfloat16>(y, residual, a, b, rows, channels, s);
}
