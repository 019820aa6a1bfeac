// 3-D max pool with TF-SAME padding of -inf, any window up to 3 and any
// stride up to 2 on each axis, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves its strided pools to
// XLA's reduce_window (step_tpu/models/i3d.py::max_pool_3d). The port ran
// them as F.pad(-inf) followed by F.max_pool3d, a copy of the input and a
// kernel that walks NCDHW-ordered windows. It pools the backbone's strided
// pools (MaxPool_2a and 3a, (1,3,3)/(1,2,2); MaxPool_4a, (3,3,3)/(2,2,2))
// and the classifier's MaxPool_5a ((2,2,2)/(2,2,2)). The plain PyTorch
// version is step_tpu_torch/ops/pool.py::max_pool3d_same_plain.
//
// What bounds it on the card: memory. A strided window shares few taps
// with its neighbours (9 taps per 4 inputs at (1,3,3)/(1,2,2), 27 per 8 at
// (3,3,3)/(2,2,2)), and the output is a quarter or an eighth of the input,
// so the input's one read sets the pace: MaxPool_2a at B=32 reads 462 MB
// and writes 116 MB, 0.17 ms at 3.35 TB/s.
//
// Design: channels-last [N, T, H, W, C] in and out.
//   * A thread owns one output position and one channel vector of V
//     elements (16 bytes when C and the pointers allow it), and reads its
//     taps straight from global memory with 16-byte loads. The threads of a
//     block hold consecutive channel vectors, then consecutive output
//     columns, so a warp's loads are whole 128-byte lines, and the taps it
//     shares with the next column or row come from L1 or L2: each input
//     byte leaves device memory about once.
//   * Grid: x over one output frame's positions and vectors, y over the
//     clips' output frames, so a B=1 pool fills the SMs as a B=32 one does.
//     A frame's offsets are 32-bit, a clip's frames 64-bit.
//   * Borders: a tap index is clamped to the tensor. SAME pads at most one
//     cell on each side of an axis for these windows, so a clamped tap
//     repeats its neighbour in the same 1-D pass, which changes no result
//     under the merge rule; there is no -inf padding and no pad copy.
//   * Bit-exactness: the taps of an output are reduced along w, then h,
//     then t, each pass in ascending order with the rule "v > m ||
//     isnan(v)" on raw bits (`step::merge`, max_merge.cuh, shared with K5).
//     That picks the first maximum in (t, h, w) order, or the last NaN, as
//     PyTorch's scan does: the result equals F.pad(x, pads, value=-inf)
//     followed by F.max_pool3d bit for bit, NaN payloads and +-0 included.
//   * A C that is not a multiple of the vector, or an unaligned pointer,
//     takes the same kernel on one-element vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "max_merge.cuh"

namespace {

using step::merge;
using step::Vec;

constexpr int THREADS = 128;
constexpr int MAX_FRAMES_Y = 65535;   // gridDim.y

struct Pool {
  int T, H, W, C;           // input
  int To, Ho, Wo;           // output
  int kt, kh, kw;           // window
  int st, sh, sw;           // stride
  int pt, ph, pw;           // low pads
  int frames;               // N * To
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  if constexpr (sizeof(Vec<T, V>) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<const Vec<T, V>*>(&raw);
  } else {
    return *reinterpret_cast<const Vec<T, V>*>(p);
  }
}

// The w pass of one row: its (up to) three taps in ascending order, a tap
// past the window repeating the one before it.
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> row_max(const T* row, const int (&col)[3], int kw) {
  Vec<T, V> m = load<T, V>(row + col[0]);
  const Vec<T, V> b = kw > 1 ? load<T, V>(row + col[1]) : m;
  const Vec<T, V> c = kw > 2 ? load<T, V>(row + col[2]) : b;
  merge(m, b);
  merge(m, c);
  return m;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
max_pool3d_same_kernel(const T* __restrict__ x, T* __restrict__ out, Pool p) {
  using VecT = Vec<T, V>;
  const unsigned CV = p.C / V;
  const unsigned f = blockIdx.x * THREADS + threadIdx.x;
  if (f >= static_cast<unsigned>(p.Ho * p.Wo) * CV) return;
  const int cv = f % CV;
  const unsigned q = f / CV;
  const int wo = q % p.Wo, ho = q / p.Wo;
  int col[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    col[c] = min(max(wo * p.sw - p.pw + c, 0), p.W - 1) * p.C + cv * V;
  const int64_t frame = static_cast<int64_t>(p.H) * p.W * p.C;
  const int64_t oframe = static_cast<int64_t>(p.Ho) * p.Wo * p.C;
  for (int nt = blockIdx.y; nt < p.frames; nt += gridDim.y) {
    const int n = nt / p.To, to = nt % p.To;
    const T* const clip = x + static_cast<int64_t>(n) * p.T * frame;
    VecT mt;
    for (int a = 0; a < p.kt; ++a) {
      const int ti = min(max(to * p.st - p.pt + a, 0), p.T - 1);
      const T* const fr = clip + ti * frame;
      VecT mh;
      for (int b = 0; b < p.kh; ++b) {
        const int hi = min(max(ho * p.sh - p.ph + b, 0), p.H - 1);
        const VecT r = row_max<T, V>(fr + hi * p.W * p.C, col, p.kw);
        if (b == 0) mh = r; else merge(mh, r);
      }
      if (a == 0) mt = mh; else merge(mt, mh);
    }
    *reinterpret_cast<VecT*>(out + nt * oframe + (ho * p.Wo + wo) * p.C + cv * V) = mt;
  }
}

template <typename T, int V>
int launch(const void* x, void* out, const Pool& p, cudaStream_t stream) {
  const int64_t items = static_cast<int64_t>(p.Ho) * p.Wo * (p.C / V);
  const int64_t blocks = (items + THREADS - 1) / THREADS;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(std::min(p.frames, MAX_FRAMES_Y)));
  max_pool3d_same_kernel<T, V><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, void* out, const Pool& p, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned && p.C % V == 0) return launch<T, V>(x, out, p, stream);
  return launch<T, 1>(x, out, p, stream);
}

// TF-SAME along one axis: the output length and the low pad.
void same(int n, int k, int s, int* n_out, int* lo) {
  *n_out = (n + s - 1) / s;
  *lo = std::max((*n_out - 1) * s + k - n, 0) / 2;
}

}  // namespace

// x: [N, T, H, W, C] contiguous; out: [N, ceil(T/st), ceil(H/sh),
// ceil(W/sw), C] contiguous; window and stride {t, h, w}, each window 1..3
// and each stride 1..2; dtype 0 = float32, 1 = bfloat16.
extern "C" int step_max_pool3d_same(const void* x, void* out, int dtype, int N, int T,
                                    int H, int W, int C, int kt, int kh, int kw,
                                    int st, int sh, int sw, void* stream) {
  if (N < 0 || T < 0 || H < 0 || W < 0 || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k : {kt, kh, kw})
    if (k < 1 || k > 3) return static_cast<int>(cudaErrorInvalidValue);
  for (int s : {st, sh, sw})
    if (s < 1 || s > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(N) * T * H * W * C == 0) return 0;
  if (static_cast<int64_t>(H) * W * C >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);   // one frame's offsets are 32-bit
  Pool p{T, H, W, C, 0, 0, 0, kt, kh, kw, st, sh, sw, 0, 0, 0, 0};
  same(T, kt, st, &p.To, &p.pt);
  same(H, kh, sh, &p.Ho, &p.ph);
  same(W, kw, sw, &p.Wo, &p.pw);
  if (static_cast<int64_t>(N) * p.To >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  p.frames = N * p.To;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, out, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, out, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
