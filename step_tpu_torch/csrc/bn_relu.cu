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
// per-channel scale and bias are a few KB and stay in L1. The Conv3d_1a
// output [8, 64, 9, 112, 112] bf16 is 116 MB each way, ~69 us at 3.35 TB/s.
//
// Design: the activation is [rows, C] with C innermost (the channels-last
// view of an NCDHW channels_last_3d tensor). One thread per vector of V
// elements, V = 16 bytes / element size when C and the pointers allow it,
// so every load and store is a 16-byte access and a warp's accesses are
// contiguous. The affine runs in float32 and the result is rounded once to
// the activation's dtype, as the Pallas kernel does. The build's
// -fmad=false keeps x * scale + bias a multiply and an add, each rounded,
// like the plain version's two PyTorch ops. "y < 0 ? 0 : y" keeps NaN, as
// jnp.maximum and torch.relu do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
__global__ void scale_bias_relu_kernel(const T* __restrict__ x,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias,
                                       T* __restrict__ out, int64_t vectors,
                                       int C) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < vectors; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    // C % V == 0 whenever V > 1, so a vector never crosses a row.
    const int c = static_cast<int>((i * V) % C);
    const Vec<T, V> in = reinterpret_cast<const Vec<T, V>*>(x)[i];
    Vec<T, V> res;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float y = to_f32(in.v[j]) * scale[c + j] + bias[c + j];
      from_f32(res.v[j], y < 0.f ? 0.f : y);
    }
    reinterpret_cast<Vec<T, V>*>(out)[i] = res;
  }
}

template <typename T, int V>
int launch(const void* x, const float* scale, const float* bias, void* out,
           int64_t elements, int C, cudaStream_t stream) {
  const int64_t vectors = elements / V;
  const int threads = 256;
  const int64_t blocks = (vectors + threads - 1) / threads;
  const unsigned grid = static_cast<unsigned>(blocks < (1 << 30) ? blocks : (1 << 30));
  scale_bias_relu_kernel<T, V><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), vectors, C);
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
