// Tube-of-interest ROI-align forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// step_tpu/ops/roi_align_pallas.py::_kernel_kron_matmul (pallas_call at
// :83), which the JAX detector reaches through tube_roi_align_pallas, and
// the identical XLA contraction batched_tube_roi_align_kron
// (step_tpu/ops/roi_align.py:270). The plain PyTorch version is
// step_tpu_torch/ops/roi_align.py::tube_roi_align_plain.
//
// The TPU kernel multiplies prebuilt Kronecker interpolation weights
// [N*P*P, H*W] by the flattened feature slice [H*W, C] on the MXU. That
// matrix is ~99% zeros (each bin reads at most 4*ratio^2 of the H*W cells);
// on the card the natural form is a gather (the reference family's
// maskrcnn-benchmark ROIAlign_cuda.cu).
//
// What bounds it on the card: memory traffic. The serving call reads a
// [8,5,14,14,832] bf16 feature map (13 MB, which stays in the 50 MB L2) and
// writes a [8,16,5,7,7,832] bf16 output (52 MB) once to HBM: 65 MB, about
// 0.02 ms at 3.35 TB/s. Each output element also gathers several feature
// cells, which L1 and L2 serve, and converts and weighs each one: at this
// size the instructions per output element matter as much as the bytes.
//
// Design: one block per pooled row of one ROI slice (b, n, t', ph). It
// reads its box from the tubes [B, N, T, 4] at the frame that pools slice
// t' (ops/roi_align.py::feature_time_indices), so the wrapper gathers
// nothing. The
// interpolation is separable, so the block first builds, once, the row's
// interpolation weights along each axis, as the plain version's
// interp_matrix does: each bilinear sample adds (1 - frac) to its lower
// and frac to its upper cell, and the samples of one bin merge into a short
// list of (cell, summed weight) — at the serving ratio 2 about 2-3 cells per
// axis instead of 4 sample corners, so a bin reads 4-9 cells, not 16. The
// lists live in shared memory. Then the block's threads run over
// (bin, channel vector) items in the output's row-major order: each loads
// the listed cells as 16-byte vectors (8 bf16 or 4 float32 channels),
// accumulates the weighted cells with FMAs in float32 registers, divides
// by the sample count and writes one 16-byte vector. Neighbouring threads
// take neighbouring vectors of the same bin, so loads and stores coalesce.
// A C that is not a multiple of the vector width, or a pointer that is not
// 16-byte aligned, takes the same kernel with one channel per item.
//
// sampling_ratio > 0 samples ratio x ratio points per bin. sampling_ratio
// <= 0 is the adaptive branch of the plain version: per ROI and axis
// g = clamp(ceil(extent / pooled), 1, S) samples with
// S = max(1, ceil(max(H, W) / pooled)), and the bin averages g_y * g_x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

// One cell of a bin's interpolation row and its summed weight.
struct Tap {
  int cell;
  float w;
};

// Adds the Detectron bilinear sample at `coord` (step_tpu/ops/roi_align.py
// :39-52) to the list taps[0 .. n): weight 1 - frac on the lower cell,
// frac on the upper, merged with a cell already listed. A sample outside
// [-1, limit] adds nothing.
__device__ __forceinline__ void add_sample(float coord, int limit, Tap* taps, int& n) {
  if (!(coord >= -1.f && coord <= static_cast<float>(limit))) return;
  // Clamping at `limit` as well keeps the int conversion in range; every
  // c >= limit - 1 lands on the edge below.
  float c = fminf(fmaxf(coord, 0.f), static_cast<float>(limit));
  const int lo = min(static_cast<int>(floorf(c)), limit - 1);
  const bool at_edge = lo >= limit - 1;
  const int hi = at_edge ? limit - 1 : lo + 1;
  if (at_edge) c = static_cast<float>(lo);
  const float frac = c - static_cast<float>(lo);
  const int cells[2] = {lo, hi};
  const float ws[2] = {1.f - frac, frac};
  for (int k = 0; k < 2; ++k) {
    int i = 0;
    while (i < n && taps[i].cell != cells[k]) ++i;
    if (i == n) taps[n++] = {cells[k], 0.f};
    taps[i].w += ws[k];
  }
}

// V consecutive channels as float32: V = 8 (bf16) or 4 (float32) is one
// 16-byte load, V = 1 a scalar.
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* f) { f[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float* f) { *p = f[0]; }
};
template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    f[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    *p = __float2bfloat16_rn(f[0]);
  }
};
template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = g.x;
      f[2 * i + 1] = g.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 g = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&g);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
tube_roi_align_kernel(const T* __restrict__ feat,       // [B, T', H, W, C]
                      const float* __restrict__ tubes,  // [B, N, T, 4], image coordinates
                      T* __restrict__ out,              // [B, N, T', pooled, pooled, C]
                      int N, int Tf, int Tp, int H, int W, int C, int pooled,
                      float frames_per_slice, float scale, int ratio, int S) {
  // Interpolation lists of at most 2*S cells: y for this block's row, then
  // x for each of the row's bins; their lengths after them.
  extern __shared__ Tap lists[];
  Tap* ys = lists;
  Tap* xs = lists + 2 * S;
  int* counts = reinterpret_cast<int*>(lists + 2 * S * (pooled + 1));

  const int ph = static_cast<int>(blockIdx.x % pooled);
  const int64_t roi = blockIdx.x / pooled;  // (b, n, t') in row-major order
  const int t = static_cast<int>(roi % Tp);
  const int b = static_cast<int>(roi / (static_cast<int64_t>(N) * Tp));

  // The frame at the centre of slice t', as feature_time_indices computes
  // it in float32: trunc((t' + 0.5) * (T / T')), or t' when T == T'.
  const int frame = Tf == Tp ? t
                             : static_cast<int>(__fmul_rn(static_cast<float>(t) + 0.5f,
                                                          frames_per_slice));
  const float* box = tubes + ((roi / Tp) * Tf + frame) * 4;
  const float x1 = box[0] * scale;
  const float y1 = box[1] * scale;
  const float roi_w = fmaxf(box[2] * scale - x1, 1.f);
  const float roi_h = fmaxf(box[3] * scale - y1, 1.f);
  const float fp = static_cast<float>(pooled);
  // Samples per bin and axis: fixed, or the adaptive ceil(extent / pooled)
  // capped at S.
  const int gy = ratio > 0 ? ratio
                           : static_cast<int>(fminf(fmaxf(ceilf(roi_h / fp), 1.f),
                                                    static_cast<float>(S)));
  const int gx = ratio > 0 ? ratio
                           : static_cast<int>(fminf(fmaxf(ceilf(roi_w / fp), 1.f),
                                                    static_cast<float>(S)));
  // Thread p < pooled lists bin p's x cells, thread `pooled` the row's y
  // cells; sample coordinates as roi_sample_coords computes them.
  if (threadIdx.x <= pooled) {
    const bool is_y = threadIdx.x == pooled;
    const int p = is_y ? ph : threadIdx.x;
    const int g = is_y ? gy : gx;
    const float start = is_y ? y1 : x1;
    const float bin = (is_y ? roi_h : roi_w) / fp;
    Tap* taps = is_y ? ys : xs + 2 * S * p;
    int n = 0;
    for (int sub = 0; sub < g; ++sub) {
      const float off = static_cast<float>(p) +
                        (static_cast<float>(sub) + 0.5f) / static_cast<float>(g);
      add_sample(start + off * bin, is_y ? H : W, taps, n);
    }
    counts[threadIdx.x] = n;
  }
  __syncthreads();

  const T* slice = feat + (static_cast<int64_t>(b) * Tp + t) * H * W * C;
  T* dst = out + (roi * pooled + ph) * pooled * C;
  const float count = static_cast<float>(gy * gx);
  const int ny = counts[pooled];
  const int nvec = C / V;
  const int items = pooled * nvec;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int pw = item / nvec;
    const int c = (item - pw * nvec) * V;
    const Tap* xt = xs + 2 * S * pw;
    const int nx = counts[pw];
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    for (int i = 0; i < ny; ++i) {
      const Tap ty = ys[i];
      const T* row = slice + static_cast<int64_t>(ty.cell) * W * C + c;
#pragma unroll 4
      for (int j = 0; j < nx; ++j) {
        const Tap tx = xt[j];
        const float w = ty.w * tx.w;
        float f[V];
        Vec<T, V>::load(row + tx.cell * C, f);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(f[k], w, acc[k]);
      }
    }
    // The plain version divides the sum by the count; so does this.
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = acc[k] / count;
    Vec<T, V>::store(dst + static_cast<int64_t>(pw) * C + c, acc);
  }
}

template <typename T>
int launch(const void* feat, const float* tubes, void* out, int B, int N,
           int Tf, int Tp, int H, int W, int C, int pooled, float scale,
           int ratio, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(B) * N * Tp * pooled;
  if (blocks == 0 || C == 0) return 0;
  if (blocks > 0x7fffffffLL || pooled >= THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  // Samples per bin and axis, at most: the fixed ratio, or the adaptive
  // cap (ops/roi_align.py::adaptive_max_ratio).
  const int S = ratio > 0 ? ratio : max(1, (max(H, W) + pooled - 1) / pooled);
  const size_t smem = 2 * static_cast<size_t>(S) * (pooled + 1) * sizeof(Tap) +
                      (pooled + 1) * sizeof(int);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  const bool vec = C % V == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto kernel = vec ? tube_roi_align_kernel<T, V> : tube_roi_align_kernel<T, 1>;
  const float frames_per_slice =
      static_cast<float>(static_cast<double>(Tf) / static_cast<double>(Tp));
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(feat), tubes, static_cast<T*>(out), N, Tf, Tp, H,
      W, C, pooled, frames_per_slice, scale, ratio, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feat [B, T', H, W, C], tubes [B, N, T, 4] float32, out
// [B, N, T', pooled, pooled, C]; dtype: 0 = float32, 1 = bfloat16 (features
// and output share it). ratio <= 0 selects the adaptive sample count.
extern "C" int step_tube_roi_align(const void* feat, const float* tubes,
                                   void* out, int dtype, int B, int N, int Tf,
                                   int Tp, int H, int W, int C, int pooled,
                                   float scale, int ratio, void* stream) {
  if (B < 0 || N < 0 || Tf < 1 || Tp < 0 || H < 1 || W < 1 || C < 0 ||
      pooled < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(feat, tubes, out, B, N, Tf, Tp, H, W, C, pooled,
                         scale, ratio, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feat, tubes, out, B, N, Tf, Tp, H, W, C,
                                 pooled, scale, ratio, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
