// Inference BatchNorm + ReLU, max(x * scale + bias, 0), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel step_tpu/ops/fused_bn_relu.py::_kernel
// (pallas_call at :54, reached through fused_scale_bias_relu and
// bn_relu_inference, i.e. every Unit3D of a fused_bn_relu=True model whose
// BN is not folded). The plain PyTorch version is
// step_tpu_torch/ops/fused_bn_relu.py::fused_scale_bias_relu_plain.
//
// What bounds it on the card: memory. Two flops per element against one
// read and one write of the activation (2 + 2 bytes in bf16); the
// per-channel scale and bias are a few KB. The Conv3d_1a output
// [8, 64, 9, 112, 112] bf16 is 116 MB each way, ~69 us at 3.35 TB/s.
//
// Design: the activation is [rows, C] with C innermost (the channels-last
// view of an NCDHW channels_last_3d tensor), read and written as vectors of
// V elements, V = 16 bytes / element size when C and the pointers allow it.
//   * A thread's channels never change: the G threads of the grid step
//     through the tensor G vectors at a time, and the launcher makes G a
//     multiple of the C / V vectors of a row. So each thread reads its V
//     scales and biases once, into registers, and its loop has no division.
//   * The grid is at most BLOCKS_PER_SM blocks of 256 threads on each SM,
//     walked grid-stride; each thread keeps two 16-byte loads in flight.
//   * Indices are 32-bit wherever the tensor has fewer than 2^31 vectors.
// The affine runs in float32 and the result is rounded once to the
// activation's dtype, as the Pallas kernel does. The build's -fmad=false
// keeps x * scale + bias a multiply and an add, each rounded, like the
// plain version's two PyTorch ops. "y < 0 ? 0 : y" keeps NaN, as
// jnp.maximum and torch.relu do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "sm_count.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& d, float v) {
  d = __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> affine_relu(const Vec<T, V>& in, const float* s,
                                                 const float* b) {
  Vec<T, V> res;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float y = to_f32(in.v[j]) * s[j] + b[j];
    from_f32(res.v[j], y < 0.f ? 0.f : y);
  }
  return res;
}

// I: the index type, int32_t when every index the loop forms fits in it.
template <typename T, int V, typename I>
__global__ void __launch_bounds__(THREADS)
scale_bias_relu_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out,
                       I vectors, int row_vectors) {
  using VecT = Vec<T, V>;
  const I g = static_cast<I>(gridDim.x) * THREADS;
  I i = static_cast<I>(blockIdx.x) * THREADS + threadIdx.x;
  // C % V == 0 whenever V > 1, so a vector never crosses a row; g is a
  // multiple of row_vectors, so this thread's channel is fixed.
  const int c = static_cast<int>(i % row_vectors) * V;
  float s[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s[j] = scale[c + j];
    b[j] = bias[c + j];
  }
  const VecT* xv = reinterpret_cast<const VecT*>(x);
  VecT* ov = reinterpret_cast<VecT*>(out);
  for (; i + g < vectors; i += 2 * g) {
    const VecT a = xv[i], a2 = xv[i + g];
    ov[i] = affine_relu(a, s, b);
    ov[i + g] = affine_relu(a2, s, b);
  }
  if (i < vectors) ov[i] = affine_relu(xv[i], s, b);
}

int64_t gcd(int64_t a, int64_t b) { return b == 0 ? a : gcd(b, a % b); }

template <typename T, int V>
int launch(const void* x, const float* scale, const float* bias, void* out,
           int64_t elements, int C, cudaStream_t stream) {
  const int64_t vectors = elements / V;
  const int64_t row_vectors = C / V;
  // Blocks come in multiples of `unit`, so that the grid's threads are a
  // multiple of row_vectors: two vectors a thread if the cap allows.
  const int64_t unit = row_vectors / gcd(row_vectors, THREADS);
  const int64_t want = (vectors + 2 * THREADS - 1) / (2 * THREADS);
  const int64_t cap = static_cast<int64_t>(BLOCKS_PER_SM) * step::sm_count();
  const int64_t blocks = (std::min(want, cap) + unit - 1) / unit * unit;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t g = blocks * THREADS;
  const auto* xt = static_cast<const T*>(x);
  auto* ot = static_cast<T*>(out);
  if (vectors + 2 * g <= INT32_MAX)
    scale_bias_relu_kernel<T, V, int32_t><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        xt, scale, bias, ot, static_cast<int32_t>(vectors), static_cast<int>(row_vectors));
  else
    scale_bias_relu_kernel<T, V, int64_t><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        xt, scale, bias, ot, vectors, static_cast<int>(row_vectors));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const float* scale, const float* bias, void* out,
             int64_t elements, int C, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned && C % V == 0)
    return launch<T, V>(x, scale, bias, out, elements, C, stream);
  return launch<T, 1>(x, scale, bias, out, elements, C, stream);
}

}  // namespace

// x, out: [rows, C] contiguous; scale, bias: [C] float32;
// dtype 0 = float32, 1 = bfloat16 (x and out share it).
extern "C" int step_scale_bias_relu(const void* x, const float* scale,
                                    const float* bias, void* out, int dtype,
                                    int64_t rows, int C, void* stream) {
  if (rows < 0 || C < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t elements = rows * C;
  if (elements == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, scale, bias, out, elements, C, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, scale, bias, out, elements, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
