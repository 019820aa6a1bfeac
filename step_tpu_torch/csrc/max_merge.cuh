// The merge rule of the max pools (csrc/pool3d.cu, csrc/pool3d_same.cu):
// m takes v, lane by lane, where v > m or v is NaN, keeping v's bits. It is
// the rule of PyTorch's max_pool3d, so taps merged in PyTorch's scan order
// give its bits: the first maximum, or the last NaN, +-0 and NaN payloads
// included.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace step {

// V channels of one position: 16 bytes when V * sizeof(T) == 16.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <int V>
__device__ __forceinline__ void merge(Vec<float, V>& m, const Vec<float, V>& v) {
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (v.v[j] > m.v[j] || isnan(v.v[j])) m.v[j] = v.v[j];
}
__device__ __forceinline__ void merge(Vec<__nv_bfloat16, 1>& m,
                                      const Vec<__nv_bfloat16, 1>& v) {
  const float f = __bfloat162float(v.v[0]);
  if (f > __bfloat162float(m.v[0]) || isnan(f)) m.v[0] = v.v[0];
}
// Two lanes at a time: set.bf16x2 gives each 16-bit half a mask of ones
// where its comparison holds (gt: ordered, so +0 > -0 is false; neu: true
// for a NaN), and the masks select the bits.
__device__ __forceinline__ void merge(Vec<__nv_bfloat16, 8>& m,
                                      const Vec<__nv_bfloat16, 8>& v) {
  uint32_t* mm = reinterpret_cast<uint32_t*>(m.v);
  const uint32_t* vv = reinterpret_cast<const uint32_t*>(v.v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t gt, nan;
    asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(gt) : "r"(vv[j]), "r"(mm[j]));
    asm("set.neu.u32.bf16x2 %0, %1, %1;" : "=r"(nan) : "r"(vv[j]));
    const uint32_t take = gt | nan;
    mm[j] = (vv[j] & take) | (mm[j] & ~take);
  }
}

}  // namespace step
