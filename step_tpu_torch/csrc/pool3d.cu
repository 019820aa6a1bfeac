// 3x3x3 max pool, stride 1, SAME padding (with -inf), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel step_tpu/ops/pool_pallas.py::_pool_kernel
// (pallas_call at :97, reached through max_pool3x3_same_pallas when
// STEP_TPU_POOL3D=pallas): the Inception b3-branch pool of every block of
// the stem and of each refinement step's tail. The plain PyTorch version is
// step_tpu_torch/ops/pool.py::max_pool3x3_same_plain (F.max_pool3d).
//
// What bounds it on the card: memory. Per output element it does 27
// compares and one store; the 27 loads are the element's neighbours, which
// adjacent threads share through L1/L2, so the ideal traffic is one read
// and one write of the tensor (the tail's [128, 5, 7, 7, 832] bf16 is
// 20 MB each way, ~12 us at 3.35 TB/s). PyTorch's max_pool3d also writes
// int64 argmax indices, four times the output's bytes in bf16, which
// serving never reads.
//
// Design: channels-last [N, T, H, W, C]; one thread per (position, vector
// of V channels), V = 16 bytes / element size when C and the pointers allow
// it, so a warp's loads and its store are contiguous 16-byte accesses. The
// window is scanned in (t, h, w) order with "v > m || isnan(v)", the rule
// of PyTorch's max_pool3d: the result equals the plain version bit for bit,
// and NaN propagates (fmaxf would drop it). Out-of-range taps are skipped,
// which is the same as padding with -inf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() { return -INFINITY; }
template <> __device__ __forceinline__ __nv_bfloat16 neg_inf<__nv_bfloat16>() {
  return __float2bfloat16_rn(-INFINITY);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void max_pool3x3_kernel(const T* __restrict__ x, T* __restrict__ out,
                                   int64_t positions, int Tn, int H, int W,
                                   int C) {
  const int cv = C / V;  // channel vectors per position
  const int64_t total = positions * cv;
  const int64_t hw = static_cast<int64_t>(H) * W;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % cv) * V;
    int64_t p = i / cv;
    const int w = static_cast<int>(p % W); p /= W;
    const int h = static_cast<int>(p % H); p /= H;
    const int t = static_cast<int>(p % Tn);
    const int64_t n = p / Tn;
    const T* clip = x + n * Tn * hw * C;

    float m[V];
    Vec<T, V> best;
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] = -INFINITY;
    for (int dt = -1; dt <= 1; ++dt) {
      const int tt = t + dt;
      if (tt < 0 || tt >= Tn) continue;
      for (int dh = -1; dh <= 1; ++dh) {
        const int hh = h + dh;
        if (hh < 0 || hh >= H) continue;
        for (int dw = -1; dw <= 1; ++dw) {
          const int ww = w + dw;
          if (ww < 0 || ww >= W) continue;
          const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(
              clip + ((tt * hw + static_cast<int64_t>(hh) * W + ww) * C + c));
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float f = to_f32(v.v[j]);
            if (f > m[j] || isnan(f)) {
              m[j] = f;
              best.v[j] = v.v[j];
            }
          }
        }
      }
    }
    // The centre tap is always in range, so every lane of `best` is set
    // unless all 27 values are -inf; the result is then -inf as well.
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (m[j] == -INFINITY) best.v[j] = neg_inf<T>();
    *reinterpret_cast<Vec<T, V>*>(out + (i / cv) * C + c) = best;
  }
}

template <typename T, int V>
int launch(const void* x, void* out, int64_t positions, int Tn, int H, int W,
           int C, cudaStream_t stream) {
  const int64_t total = positions * (C / V);
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  const unsigned grid = static_cast<unsigned>(blocks < (1 << 30) ? blocks : (1 << 30));
  max_pool3x3_kernel<T, V><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), positions, Tn, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, void* out, int64_t positions, int Tn, int H, int W,
             int C, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned && C % V == 0)
    return launch<T, V>(x, out, positions, Tn, H, W, C, stream);
  return launch<T, 1>(x, out, positions, Tn, H, W, C, stream);
}

}  // namespace

// x, out: [N, T, H, W, C] contiguous; dtype 0 = float32, 1 = bfloat16.
extern "C" int step_max_pool3x3(const void* x, void* out, int dtype, int N,
                                int Tn, int H, int W, int C, void* stream) {
  if (N < 0 || Tn < 0 || H < 0 || W < 0 || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t positions = static_cast<int64_t>(N) * Tn * H * W;
  if (positions == 0 || C == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, out, positions, Tn, H, W, C, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, out, positions, Tn, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
