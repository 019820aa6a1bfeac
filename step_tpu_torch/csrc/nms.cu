// Batched greedy NMS for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel step_tpu/ops/nms_pallas.py::_nms_kernel
// (pallas_call at :109), reached through nms_many from
// step_tpu/inference.py::nms_surface. The plain PyTorch version is
// step_tpu_torch/ops/nms.py::nms_many_plain; this kernel must equal it bit
// for bit.
//
// What bounds it on the card: nothing in the arithmetic. At the serving
// shape (B=8: 8*18*24 = 3,456 problems of P=16 boxes, K=16 keeps) it reads
// 3456*16*20 bytes and writes 3456*16*8 bytes — about 1.5 MB, well under a
// microsecond of HBM time. What costs is the chain of K dependent steps per
// problem (reduce, broadcast, compare), i.e. latency. The plain version
// pays that chain as ~20 small kernel launches per step; here the chain
// runs inside one warp, in registers.
//
// Design: one warp per problem, one box per lane (P <= 32; lanes >= P hold
// -inf and never win). Each of the K iterations is
//   1. a warp max of the live scores, then a warp min of the lanes holding
//      that max — ties go to the lowest index, as jnp.argmax does;
//   2. a shuffle broadcast of the chosen box;
//   3. IoU of every lane's box against it, suppression at iou > thr, and
//      the explicit knockout of the chosen lane;
//   4. a freeze when nothing is live (best <= NEG/2): idx 0, mask 0, live
//      scores unchanged.
//
// Bit-exactness: the IoU is written with __fsub_rn/__fmul_rn/__fadd_rn/
// __fdiv_rn, which nvcc never contracts into FMAs, and the library is also
// built with -fmad=false. The box area is (x2-x1)*(y2-y1) with no clamp,
// as in the Pallas kernel (nms_pallas.py:47); ops/nms.py clamps it at 0
// through box_area, and the two agree whenever x1 <= x2 and y1 <= y2,
// which decode_boxes/clip_boxes guarantee on the detection path.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr float kEps = 1e-8f;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
nms_many_kernel(const float* __restrict__ live_in,   // [N, P]
                const float* __restrict__ boxes,     // [N, P, 4]
                int32_t* __restrict__ keep_idx,      // [N, K]
                float* __restrict__ keep_mask,       // [N, K]
                int n_problems, int P, int K, float thr) {
  const int lane = threadIdx.x & 31;
  const int problem = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (problem >= n_problems) return;  // the whole warp leaves together

  const bool real = lane < P;
  const int64_t slot = static_cast<int64_t>(problem) * P + lane;
  float live = -INFINITY;
  float x1 = 0.f, y1 = 0.f, x2 = 0.f, y2 = 0.f;
  if (real) {
    live = live_in[slot];
    x1 = boxes[slot * 4 + 0];
    y1 = boxes[slot * 4 + 1];
    x2 = boxes[slot * 4 + 2];
    y2 = boxes[slot * 4 + 3];
  }
  const float area = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
  int32_t* idx_out = keep_idx + static_cast<int64_t>(problem) * K;
  float* mask_out = keep_mask + static_cast<int64_t>(problem) * K;

  for (int k = 0; k < K; ++k) {
    float best = live;
    for (int off = 16; off > 0; off >>= 1)
      best = fmaxf(best, __shfl_xor_sync(kFullMask, best, off));
    int idx = (live == best) ? lane : 32;
    for (int off = 16; off > 0; off >>= 1)
      idx = min(idx, __shfl_xor_sync(kFullMask, idx, off));
    const bool ok = best > kNeg * 0.5f;

    const float cx1 = __shfl_sync(kFullMask, x1, idx);
    const float cy1 = __shfl_sync(kFullMask, y1, idx);
    const float cx2 = __shfl_sync(kFullMask, x2, idx);
    const float cy2 = __shfl_sync(kFullMask, y2, idx);
    const float carea = __fmul_rn(__fsub_rn(cx2, cx1), __fsub_rn(cy2, cy1));
    const float w = fmaxf(__fsub_rn(fminf(cx2, x2), fmaxf(cx1, x1)), 0.f);
    const float h = fmaxf(__fsub_rn(fminf(cy2, y2), fmaxf(cy1, y1)), 0.f);
    const float inter = __fmul_rn(w, h);
    const float uni = __fsub_rn(__fadd_rn(carea, area), inter);
    const float iou = __fdiv_rn(inter, fmaxf(uni, kEps));
    if (ok && real && (iou > thr || lane == idx)) live = kNeg;

    if (lane == 0) {
      idx_out[k] = idx;
      mask_out[k] = ok ? 1.f : 0.f;
    }
  }
}

}  // namespace

extern "C" int step_nms_many(const float* live, const float* boxes,
                             int32_t* keep_idx, float* keep_mask,
                             int n_problems, int P, int K, float thr,
                             void* stream) {
  if (n_problems < 0 || P < 1 || P > 32 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_problems == 0 || K == 0) return 0;
  const int blocks = (n_problems + kWarpsPerBlock - 1) / kWarpsPerBlock;
  nms_many_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      live, boxes, keep_idx, keep_mask, n_problems, P, K, thr);
  return static_cast<int>(cudaGetLastError());
}
