// 3x3x3 convolution, stride 1, SAME (zero) padding, with the inference
// BatchNorm affine and the ReLU in its epilogue, for Hopper (sm_90a):
//
//     out = relu(conv3d(x, w) * scale + bias)
//
// Replaces the Pallas TPU kernel step_tpu/ops/conv3d_pallas.py::_kernel
// (pallas_call at :114, conv3x3x3_bn_relu at :86). In the port it runs every
// 3x3x3 stride-1 Unit3D (Conv3d_2c_3x3 and each Inception b1b/b2b) of a
// fused_bn_relu=True model whose BN is not folded. The plain PyTorch version
// is step_tpu_torch/ops/conv3d.py::conv3x3x3_bn_relu_plain.
//
// What bounds it on the card: arithmetic. An implicit GEMM of
// M = N*T*H*W positions by K output channels over 27*C products: the tail's
// Mixed_5c b1b at B=8 (M = 31,360, C = 192, K = 384) is 125 GFLOP against
// ~60 MB of traffic, far above the card's ridge point. This first version
// runs on the CUDA cores in float32 (67 TFLOP/s peak), not on the tensor
// cores (989 TFLOP/s in bf16), so cuDNN is expected to be much faster; a
// wgmma/TMA version is the next step.
//
// Design: one block of 256 threads per (64 positions x 64 output channels)
// tile; each thread holds a 4 x 4 tile of float32 accumulators in
// registers. The reduction walks the 27 taps and, per tap, C in chunks of
// 16. Each chunk stages the gathered input tile [16 channels x 64
// positions] and the weight tile [16 x 64] (tap-major weights [27, C, K])
// in shared memory as float32. The zero padding, the ragged C and K and the
// ragged last tile are masked loads that write zeros. Products accumulate
// with explicit fmaf in float32 (bf16 x bf16 products are exact in
// float32). The epilogue applies scale, bias and ReLU in float32 and
// rounds once to the activation dtype before the single store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // positions per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // input channels per stage
constexpr int TM = 4;    // positions per thread
constexpr int TN = 4;    // output channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& d, float v) {
  d = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3x3_bn_relu_kernel(const T* __restrict__ x,       // [N, D, H, W, C]
                         const T* __restrict__ w,       // [27, C, K]
                         const float* __restrict__ scale,  // [K]
                         const float* __restrict__ bias,   // [K]
                         T* __restrict__ out,           // [N, D, H, W, K]
                         int64_t M, int D, int H, int W, int C, int K) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int k0 = blockIdx.y * BN;

  // The input loader: this thread fills row a_m of the tile, channels
  // a_c .. a_c + 3 of each chunk. Its output position is fixed.
  const int a_m = tid / (BK / 4);
  const int a_c = (tid % (BK / 4)) * 4;
  const int64_t gm = m0 + a_m;
  const bool row_ok = gm < M;
  int pw = 0, ph = 0, pt = 0;
  int64_t pn = 0;
  if (row_ok) {
    int64_t p = gm;
    pw = static_cast<int>(p % W); p /= W;
    ph = static_cast<int>(p % H); p /= H;
    pt = static_cast<int>(p % D);
    pn = p / D;
  }
  // The weight loader: row b_k of the tile, output channels b_n .. b_n + 3.
  const int b_k = tid / (BN / 4);
  const int b_n = (tid % (BN / 4)) * 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 27; ++tap) {
    const int tt = pt + tap / 9 - 1;
    const int hh = ph + (tap / 3) % 3 - 1;
    const int ww = pw + tap % 3 - 1;
    const bool inside = row_ok && tt >= 0 && tt < D && hh >= 0 && hh < H &&
                        ww >= 0 && ww < W;
    const T* src =
        x + (((pn * D + (inside ? tt : 0)) * H + (inside ? hh : 0)) * W +
             (inside ? ww : 0)) * C;
    const T* wt = w + static_cast<int64_t>(tap) * C * K;
    for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + a_c + j;
        As[a_c + j][a_m] = (inside && c < C) ? to_f32(src[c]) : 0.f;
      }
      const int kc = c0 + b_k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + b_n + j;
        Bs[b_k][b_n + j] =
            (kc < C && k < K) ? to_f32(wt[static_cast<int64_t>(kc) * K + k]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // Epilogue: BN affine and ReLU in float32, one rounding, one store.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + ty * TM + i;
    if (m >= M) continue;
    T* dst = out + m * K;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = k0 + tx * TN + j;
      if (k >= K) continue;
      const float y = acc[i][j] * scale[k] + bias[k];
      from_f32(dst[k], y < 0.f ? 0.f : y);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const float* scale, const float* bias,
           void* out, int N, int D, int H, int W, int C, int K,
           cudaStream_t stream) {
  const int64_t M = static_cast<int64_t>(N) * D * H * W;
  if (M == 0 || K == 0) return 0;
  const int64_t mblocks = (M + BM - 1) / BM;
  if (mblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(mblocks), (K + BN - 1) / BN);
  conv3x3x3_bn_relu_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias,
      static_cast<T*>(out), M, D, H, W, C, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [N, D, H, W, C], w: [27, C, K] (tap = 9*dt + 3*dh + dw), out:
// [N, D, H, W, K], all contiguous and of one dtype (0 = float32,
// 1 = bfloat16); scale, bias: [K] float32.
extern "C" int step_conv3x3x3_bn_relu(const void* x, const void* w,
                                      const float* scale, const float* bias,
                                      void* out, int dtype, int N, int D, int H,
                                      int W, int C, int K, void* stream) {
  if (N < 0 || D < 0 || H < 0 || W < 0 || C < 1 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, scale, bias, out, N, D, H, W, C, K, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, scale, bias, out, N, D, H, W, C, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
