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
// matrix is ~99% zeros (each bin reads at most 4*ratio^2 of the H*W cells)
// and costs memory to build; on the card the natural form is the gather
// kernel of the reference family (maskrcnn-benchmark ROIAlign_cuda.cu).
//
// What bounds it on the card: memory traffic. Per output element it makes
// ratio^2 * 4 reads (16 at ratio 2) of feature values that live in L2 (the
// serving feature map [8,5,14,14,832] bf16 is 13 MB against a 50 MB L2),
// ~4*16 flops, and one write; the output [8,16,5,7,7,832] bf16 is 52 MB,
// written once to HBM. So it is bound by L2 load bandwidth and by the HBM
// write of the output.
//
// Design: one block per output bin (b, n, t', ph, pw), blocks enumerated in
// the output's row-major order so that block i writes out[i*C : (i+1)*C];
// the block's threads walk the contiguous channel axis, so every load and
// the store coalesce across a warp. Sample coordinates and the four corner
// weights are computed in registers from the box, exactly as
// roi_sample_coords and _bilinear_weights compute them
// (step_tpu/ops/roi_align.py:155-185, :39-52); every thread of a block
// computes the same values, which costs far less than a shared-memory
// round trip. Accumulation is float32; the output is written in the feature
// dtype (float32 or bfloat16). Only the fixed sampling grid
// (sampling_ratio > 0) is implemented; the wrapper rejects the adaptive
// branch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Corners {
  int lo, hi;
  float w_lo, w_hi;
  bool ok;
};

// Detectron bilinear along one axis (step_tpu/ops/roi_align.py:39-52).
__device__ __forceinline__ Corners bilinear(float coord, int limit) {
  Corners r;
  r.ok = (coord >= -1.f) && (coord <= static_cast<float>(limit));
  // Clamping at `limit` as well keeps the int conversion in range; it
  // changes nothing, since coord > limit is masked and every c >= limit-1
  // lands on the edge below.
  float c = fminf(fmaxf(coord, 0.f), static_cast<float>(limit));
  int lo = min(static_cast<int>(floorf(c)), limit - 1);
  const bool at_edge = lo >= limit - 1;
  r.hi = at_edge ? limit - 1 : lo + 1;
  if (at_edge) c = static_cast<float>(lo);
  const float frac = c - static_cast<float>(lo);
  r.lo = lo;
  r.w_lo = 1.f - frac;
  r.w_hi = frac;
  return r;
}

template <typename T>
__global__ void tube_roi_align_kernel(
    const T* __restrict__ feat,       // [B, T', H, W, C]
    const float* __restrict__ boxes,  // [B, N, T', 4], image coordinates
    T* __restrict__ out,              // [B, N, T', pooled, pooled, C]
    int N, int Tp, int H, int W, int C, int pooled, float scale, int ratio) {
  int64_t bin = blockIdx.x;
  const int pw = static_cast<int>(bin % pooled); bin /= pooled;
  const int ph = static_cast<int>(bin % pooled); bin /= pooled;
  const int t = static_cast<int>(bin % Tp); bin /= Tp;
  const int n = static_cast<int>(bin % N);
  const int b = static_cast<int>(bin / N);

  const float* box = boxes + ((static_cast<int64_t>(b) * N + n) * Tp + t) * 4;
  const float x1 = box[0] * scale;
  const float y1 = box[1] * scale;
  const float bin_w = fmaxf(box[2] * scale - x1, 1.f) / static_cast<float>(pooled);
  const float bin_h = fmaxf(box[3] * scale - y1, 1.f) / static_cast<float>(pooled);

  const T* slice = feat + (static_cast<int64_t>(b) * Tp + t) * H * W * C;
  T* dst = out + static_cast<int64_t>(blockIdx.x) * C;
  const float count = static_cast<float>(ratio * ratio);

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int iy = 0; iy < ratio; ++iy) {
      const float off_y = static_cast<float>(ph) +
                          (static_cast<float>(iy) + 0.5f) / static_cast<float>(ratio);
      const Corners ay = bilinear(y1 + off_y * bin_h, H);
      for (int ix = 0; ix < ratio; ++ix) {
        const float off_x = static_cast<float>(pw) +
                            (static_cast<float>(ix) + 0.5f) / static_cast<float>(ratio);
        const Corners ax = bilinear(x1 + off_x * bin_w, W);
        if (!(ay.ok && ax.ok)) continue;
        const T* row_lo = slice + static_cast<int64_t>(ay.lo) * W * C;
        const T* row_hi = slice + static_cast<int64_t>(ay.hi) * W * C;
        acc += load_f32(row_lo + ax.lo * C + c) * (ay.w_lo * ax.w_lo) +
               load_f32(row_lo + ax.hi * C + c) * (ay.w_lo * ax.w_hi) +
               load_f32(row_hi + ax.lo * C + c) * (ay.w_hi * ax.w_lo) +
               load_f32(row_hi + ax.hi * C + c) * (ay.w_hi * ax.w_hi);
      }
    }
    store_f32(dst + c, acc / count);
  }
}

template <typename T>
int launch(const void* feat, const float* boxes, void* out, int B, int N,
           int Tp, int H, int W, int C, int pooled, float scale, int ratio,
           cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(B) * N * Tp * pooled * pooled;
  if (blocks == 0 || C == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = min(1024, ((C + 31) / 32) * 32);
  tube_roi_align_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(feat), boxes, static_cast<T*>(out), N, Tp, H, W,
      C, pooled, scale, ratio);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (features and output share it).
extern "C" int step_tube_roi_align(const void* feat, const float* boxes,
                                   void* out, int dtype, int B, int N, int Tp,
                                   int H, int W, int C, int pooled,
                                   float scale, int ratio, void* stream) {
  if (B < 0 || N < 0 || Tp < 0 || H < 1 || W < 1 || C < 0 || pooled < 1 ||
      ratio < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(feat, boxes, out, B, N, Tp, H, W, C, pooled, scale,
                         ratio, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feat, boxes, out, B, N, Tp, H, W, C, pooled,
                                 scale, ratio, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
