// 3x3x3 max pool, stride 1, SAME padding (with -inf), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel step_tpu/ops/pool_pallas.py::_pool_kernel
// (pallas_call at :97, reached through max_pool3x3_same_pallas when
// STEP_TPU_POOL3D=pallas): the Inception b3-branch pool of every block of
// the stem and of each refinement step's tail. The plain PyTorch version is
// step_tpu_torch/ops/pool.py::max_pool3x3_same_plain (F.max_pool3d).
//
// What bounds it on the card: memory, and instructions close behind. The
// ideal traffic is one read and one write of the tensor (the tail's
// [128, 5, 7, 7, 832] bf16 is 52 MB each way, 31 us at 3.35 TB/s). Reading
// the 27 taps of every output from memory, as a kernel without reuse does,
// sends 27 reads of each byte to L2, whose rate then sets the pace; and at
// ~20 instructions per output element the issue rate of the SMs is near
// the bound as well.
//
// Design: channels-last [N, T, H, W, C].
//   * Tiles: a block owns tH rows by tW columns (at most 64 positions, 32
//     columns) of every frame of one clip, by a slab of SV = 8 channel
//     vectors of V elements (16 bytes each when C and the pointers allow
//     it: a slab is 64 bf16 or 32 f32 channels), with 256 threads. It walks
//     the clip's frames in order. Each frame's part of the tile, with a
//     one-cell halo in h and w clamped to the tensor, goes into a ring of
//     shared-memory slots by 16-byte cp.async copies, as many frames ahead
//     as STAGE_BYTES holds (two at least). So each input byte leaves device
//     memory once: the tail's 7x7 frame is one tile and has no halo; the
//     Mixed_3 and Mixed_4 frames are cut into tiles of 2 to 4 rows, as few
//     as give the grid two blocks per SM, and their halo rows are read
//     again, from L2, which holds those tensors (9-29 MB) whole.
//   * Separable max: along w from the staged frame into a buffer, along h
//     into a ring of three h-reduced frames, along t from those three to
//     the output with 16-byte stores: 6 merges per output, not 26.
//   * Instructions: bf16 lanes merge two at a time on their raw bits
//     (set.gt / set.neu on bf16x2 give masks that select the bits); the
//     passes walk their positions without integer division; a frame's
//     offsets are 32-bit.
//   * Borders: each tap index is clamped to the tensor. A clamped tap
//     repeats its neighbour in scan order, which changes no result under
//     the rule below; there is no -inf padding.
//   * Bit-exactness: every pass scans its three taps in ascending order,
//     takes the later value if "v > m || isnan(v)" (the rule of PyTorch's
//     max_pool3d; `step::merge` in max_merge.cuh, which the strided pool
//     of pool3d_same.cu shares) and keeps the winning value's bits.
//     Reducing w, then h, then t so picks the first maximum in (t, h, w)
//     order, or the last NaN, as the 27-tap scan does: the result equals
//     the plain version bit for bit, NaN payloads and +-0 included.
//   * A C that is not a multiple of the vector, or an unaligned pointer,
//     takes the same kernel on one-element vectors with plain loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "max_merge.cuh"
#include "sm_count.cuh"

namespace {

constexpr int SV = 8;            // channel vectors per slab (threadIdx.x)
constexpr int NY = 32;           // threadIdx.y: 256 threads a block
constexpr int MAX_TW = 32;       // tile columns
constexpr int MAX_POS = 64;      // tile positions, tH * tW
constexpr int MAX_STAGES = 8;    // frames staged ahead
constexpr int STAGE_BYTES = 16 * 1024;   // what the staging ring may hold

using step::merge;
using step::Vec;

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> max3(Vec<T, V> a, const Vec<T, V>& b,
                                          const Vec<T, V>& c) {
  merge(a, b);
  merge(a, c);
  return a;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n of this thread's groups are pending, n < MAX_STAGES.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

struct Tile {
  int tH, tW, htiles, wtiles, slabs, stages;
};

// Positions first, first + NY, ... of a grid `cols` wide, as (row, col),
// with no division past the first.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ Walk(int first, int cols_)
      : r(first / cols_), c(first % cols_), dr(NY / cols_), dc(NY % cols_), cols(cols_) {}
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// Shared memory, in Vecs: a ring of `stages` staged frames [nr][nw][SV],
// the w-pass buffer [nr][tw][SV] and three h-reduced frames [th][tw][SV].
int smem_vectors(int stages, int nr, int nw, int tH, int tW) {
  return (stages * nr * nw + nr * tW + 3 * tH * tW) * SV;
}

// Block b: slab, then column tile, then row tile, then clip. Thread
// (lane, y) owns channel vector `lane` of the slab and walks the tile's
// positions y, y + NY, ...
template <typename T, int V>
__global__ void __launch_bounds__(SV * NY, 5)
max_pool3x3_kernel(const T* __restrict__ x, T* __restrict__ out, int Tn, int H,
                   int W, int C, Tile tile) {
  using VecT = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x, ty = threadIdx.y;
  int b = blockIdx.x;
  const int slab = b % tile.slabs; b /= tile.slabs;
  const int wt = b % tile.wtiles; b /= tile.wtiles;
  const int ht = b % tile.htiles;
  const int64_t n = b / tile.htiles;
  const int c0 = slab * SV * V;
  const bool live = lane < min(SV, (C - c0) / V);
  const int h0 = ht * tile.tH, th = min(tile.tH, H - h0);
  const int w0 = wt * tile.tW, tw = min(tile.tW, W - w0);
  const int hs = max(h0 - 1, 0), nr = min(h0 + th, H - 1) - hs + 1;
  const int ws = max(w0 - 1, 0), nw = min(w0 + tw, W - 1) - ws + 1;
  const int S = tile.stages, fsz = nr * nw * SV, hsz = th * tw * SV;
  VecT* const ring = reinterpret_cast<VecT*>(smem_raw);
  VecT* const wbuf = ring + S * fsz;        // [nr][tw][SV]
  VecT* const hbuf = wbuf + nr * tw * SV;   // [3][th][tw][SV]
  const int64_t frame = static_cast<int64_t>(H) * W * C;
  const T* const clip = x + n * Tn * frame + c0 + lane * V;
  T* const oclip = out + n * Tn * frame + c0 + lane * V;
  const Walk staged(ty, nw), tiled(ty, tw);   // over [nr][nw] and [*][tw]

  // Frame t's rows hs.. and columns ws.. of the tile → its ring slot. A
  // frame's offsets are 32-bit (the launcher checks H * W * C).
  auto load = [&](int t) {
    if (t >= Tn || !live) return;
    const T* src = clip + t * frame + (hs * W + ws) * C;
    VecT* buf = ring + (t % S) * fsz + lane;
    for (Walk q = staged; q.r < nr; q.next()) {
      const T* g = src + (q.r * W + q.c) * C;
      VecT* d = buf + (q.r * nw + q.c) * SV;
      if constexpr (sizeof(VecT) == 16)
        cp_async16(d, g);
      else
        *d = *reinterpret_cast<const VecT*>(g);
    }
  };
  // Output frame t: the max over the h-reduced frames lo, mid, hi, in that
  // order (frame f is in hbuf slot f % 3).
  auto emit = [&](int t, int lo, int mid, int hi) {
    if (!live) return;
    T* dst = oclip + t * frame + (h0 * W + w0) * C;
    const VecT* a = hbuf + (lo % 3) * hsz + lane;
    const VecT* b = hbuf + (mid % 3) * hsz + lane;
    const VecT* c = hbuf + (hi % 3) * hsz + lane;
    for (Walk q = tiled; q.r < th; q.next()) {
      const int p = (q.r * tw + q.c) * SV;
      *reinterpret_cast<VecT*>(dst + (q.r * W + q.c) * C) = max3(a[p], b[p], c[p]);
    }
  };

  for (int t = 0; t < S; ++t) {
    load(t);
    cp_async_commit();
  }
  for (int t = 0; t < Tn; ++t) {
    cp_async_wait(S - 1);     // frame t has landed; up to t + S - 1 may be in flight
    __syncthreads();
    const VecT* const buf = ring + (t % S) * fsz + lane;
    if (live) {               // along w: every staged row, the tile's columns
      for (Walk q = tiled; q.r < nr; q.next()) {
        const int w = w0 + q.c;
        const VecT* row = buf + q.r * nw * SV;
        wbuf[(q.r * tw + q.c) * SV + lane] =
            max3(row[(max(w - 1, 0) - ws) * SV], row[(w - ws) * SV],
                 row[(min(w + 1, W - 1) - ws) * SV]);
      }
    }
    __syncthreads();          // the slot is free, wbuf is whole
    load(t + S);
    cp_async_commit();
    if (live) {               // along h: the tile's rows, into hbuf slot t % 3
      VecT* const slot = hbuf + (t % 3) * hsz + lane;
      for (Walk q = tiled; q.r < th; q.next()) {
        const int h = h0 + q.r;
        const VecT* col = wbuf + q.c * SV + lane;
        slot[(q.r * tw + q.c) * SV] = max3(col[(max(h - 1, 0) - hs) * tw * SV],
                                           col[(h - hs) * tw * SV],
                                           col[(min(h + 1, H - 1) - hs) * tw * SV]);
      }
    }
    __syncthreads();          // hbuf slot t is whole
    if (t > 0) emit(t - 1, max(t - 2, 0), t - 1, t);   // along t
  }
  emit(Tn - 1, max(Tn - 2, 0), Tn - 1, Tn - 1);
}

// n cells in tiles of at most cap, as even as they come: the tile size.
int even_tiles(int n, int cap) {
  const int tiles = (n + cap - 1) / cap;
  return (n + tiles - 1) / tiles;
}

// Tiles of at most MAX_POS positions, MAX_TW columns, as even as the frame
// allows; fewer rows while the grid is short of two blocks per SM (a
// smaller tile re-reads more halo rows, but from L2); a slab per SV
// vectors of channels; as many frames staged ahead as STAGE_BYTES holds,
// two at least.
template <typename T, int V>
Tile pick_tile(int N, int Tn, int H, int W, int C) {
  Tile t;
  t.tW = even_tiles(W, MAX_TW);
  t.wtiles = (W + t.tW - 1) / t.tW;
  t.slabs = (C / V + SV - 1) / SV;
  t.tH = even_tiles(H, std::max(1, MAX_POS / t.tW));
  const int64_t per_row_tile = static_cast<int64_t>(N) * t.wtiles * t.slabs;
  while (t.tH > 1 && per_row_tile * ((H + t.tH - 1) / t.tH) < 2 * step::sm_count())
    t.tH = even_tiles(H, t.tH / 2);
  t.htiles = (H + t.tH - 1) / t.tH;
  const int frame_bytes = std::min(t.tH + 2, H) * std::min(t.tW + 2, W) * SV *
                          static_cast<int>(sizeof(Vec<T, V>));
  t.stages = std::min(Tn, std::max(2, std::min(MAX_STAGES, STAGE_BYTES / frame_bytes)));
  return t;
}

template <typename T, int V>
int launch(const void* x, void* out, int N, int Tn, int H, int W, int C,
           cudaStream_t stream) {
  auto kernel = max_pool3x3_kernel<T, V>;
  const Tile tile = pick_tile<T, V>(N, Tn, H, W, C);
  const size_t smem = sizeof(Vec<T, V>) *
                      smem_vectors(tile.stages, std::min(tile.tH + 2, H),
                                   std::min(tile.tW + 2, W), tile.tH, tile.tW);
  // Above 48 KB of dynamic shared memory a kernel must be allowed it, once
  // per device: the most any tile needs. The ring holds STAGE_BYTES, or two
  // frames of at most (MAX_POS + 2) x 3 cells (a one-column tile); the
  // w-pass buffer (tH + 2) x tW <= MAX_POS + 2 MAX_TW cells; hbuf 3 MAX_POS.
  constexpr size_t kVec = SV * sizeof(Vec<T, V>);
  constexpr size_t kFrame = (MAX_POS + 2) * 3 * kVec;
  constexpr size_t kMaxSmem = (2 * kFrame > STAGE_BYTES ? 2 * kFrame : STAGE_BYTES) +
                              (MAX_POS + 2 * MAX_TW + 3 * MAX_POS) * kVec;
  if (smem > 48 * 1024) {
    static bool allowed[64] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!allowed[device]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kMaxSmem));
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed[device] = true;
    }
  }
  const int64_t blocks = static_cast<int64_t>(N) * tile.htiles * tile.wtiles * tile.slabs;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), dim3(SV, NY), smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), Tn, H, W, C, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, void* out, int N, int Tn, int H, int W, int C,
             cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned && C % V == 0) return launch<T, V>(x, out, N, Tn, H, W, C, stream);
  return launch<T, 1>(x, out, N, Tn, H, W, C, stream);
}

}  // namespace

// x, out: [N, T, H, W, C] contiguous; dtype 0 = float32, 1 = bfloat16.
extern "C" int step_max_pool3x3(const void* x, void* out, int dtype, int N,
                                int Tn, int H, int W, int C, void* stream) {
  if (N < 0 || Tn < 0 || H < 0 || W < 0 || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(N) * Tn * H * W * C == 0) return 0;
  if (static_cast<int64_t>(H) * W * C >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);   // one frame's offsets are 32-bit
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, out, N, Tn, H, W, C, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, out, N, Tn, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
