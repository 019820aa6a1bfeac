// The bf16 implicit GEMM on Hopper's tensor cores that runs the port's
// stride-1 SAME convolutions over channels-last rows: the 3x3x3 conv K3
// (conv3d.cu, TAPS = 27) and the 1x1x1 conv (gemm.cu, TAPS = 1), each with
// an affine or a bias and the ReLU in its epilogue:
//
//     out[m, k] = relu(sum_r A[m, r] * Wt[k, r] * scale[k] + bias[k])
//
// A is gathered from the input on the fly: row m is an output position of
// an [N, D, H, W] grid; the reduction index r = tap * Cpad + c runs over
// the taps (tap = 9*dt + 3*dh + dw for 27, the position itself for 1) and
// C channels padded to Cpad. Input row m, channel c lies at x[m * ldx + c],
// so the input may be a channel slice of a wider tensor (the Inception
// block's b1|b2 scratch, read in place). The output's columns may go to
// two places: k < split to out0[m * ld0 + k], the rest to
// out1[m * ld1 + k - split], each a channel slice of a wider tensor (the
// Inception block's output and its scratch).
//
// Design (as it was first written for K3 in conv3d.cu): the wrapper packs
// the weight as a dense, zero-padded [Kw, Rpad] bf16 matrix, Kw a multiple
// of the tile width TBN and Rpad of 64 (ops/conv3d.py::pack_conv_weight). A
// block of two to four warpgroups computes a BM x TBN output tile, 64 rows
// per warpgroup:
//   * the reduction runs in chunks of 64 (128 bytes of bf16), through a
//     ring of 3-6 shared-memory stages (as many as 227 KB hold for the
//     tile, at most 6). Every thread gathers its part of the A tile (BM
//     positions x 64 reduction elements) with 16-byte cp.async copies, one
//     per 8 channels of one tap; SAME padding, rows past M and the tail
//     past TAPS * Cpad are cp.async's zero-fill (source size 0). The B tile
//     (TBN channels x 64) is a straight 16-byte cp.async copy of the packed
//     weight. Both land in the 128-byte swizzled K-major layout that wgmma
//     reads through a descriptor;
//   * the loads of chunks i + 1 .. i + STAGES - 2 are in flight while the
//     tensor cores run chunk i: each warpgroup issues four wgmma.mma_async
//     m64nTBNk16 per chunk (bf16 x bf16 into float32 registers), commits
//     them and waits only for the previous chunk's group;
//   * the epilogue applies scale (or 1), bias and ReLU in float32, rounds
//     once to bf16, stages the tile in shared memory and writes 16-byte
//     stores at each destination's offset and row stride.
// Blocks that share an M tile are neighbours in the grid, so the A rows of
// the second N tile come from L2. A C that is not a multiple of 8, or an
// input that is not 16-byte aligned, gathers A with scalar loads into the
// same tile (kVec = false; only the 3x3x3 conv has that variant).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace igemm {
namespace {

constexpr int TC_BK = 64;             // reduction elements per chunk (128 bytes)
constexpr int A_ROWS_PER_THREAD = 4;  // 64 rows x 8 chunks / 128 threads
constexpr int MAX_SMEM = 232448;      // dynamic shared memory a block may use

// The widest block for tile width bn, in warpgroups of 64 rows each with
// bn / 2 accumulators a thread: as many as the SM's 64K registers hold
// (4 up to bn = 160, 3 up to 224, else 2). A wider block reads each weight
// tile once for more positions; the launcher picks it or two warpgroups.
__host__ __device__ constexpr int tc_wide(int bn) {
  return bn <= 160 ? 4 : bn <= 224 ? 3 : 2;
}
__host__ __device__ constexpr int tc_stage_bytes(int bn, int nwg) {
  return (64 * nwg + bn) * TC_BK * 2;  // A tile + B tile
}
// Stages of the ring: as many as fit, at most 6.
__host__ __device__ constexpr int tc_stages(int bn, int nwg) {
  return (MAX_SMEM - 1024) / tc_stage_bytes(bn, nwg) < 6
             ? (MAX_SMEM - 1024) / tc_stage_bytes(bn, nwg)
             : 6;
}
__host__ __device__ constexpr int tc_smem_bytes(int bn, int nwg) {
  // The ring, plus 1 KB to align it to the 1024-byte swizzle atom.
  return tc_stages(bn, nwg) * tc_stage_bytes(bn, nwg) + 1024;
}

// Byte offset of 16-byte chunk j (0..7) of row r in a 128-byte-swizzled
// tile of 128-byte rows: the chunk index is XORed with r mod 8.
__device__ __forceinline__ uint32_t swizzle128(int r, int j) {
  return static_cast<uint32_t>(r * 128 + ((j ^ (r & 7)) << 4));
}

// A wgmma shared-memory descriptor for a K-major tile of 128-byte rows in
// the 128-byte swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);         // start address
  d |= static_cast<uint64_t>(16 >> 4) << 16;                 // leading byte offset
  d |= static_cast<uint64_t>(1024 >> 4) << 32;               // stride byte offset
  d |= static_cast<uint64_t>(1) << 62;                       // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async16_cg(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
// Make this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

struct Args {
  const __nv_bfloat16* x;  // input row m, channel c at x[m * ldx + c]
  const __nv_bfloat16* w;  // [Kw, Rpad] packed
  const float* scale;      // [K], or null for 1
  const float* bias;       // [K]
  __nv_bfloat16* out0;     // column k < split at out0[m * ld0 + k]
  __nv_bfloat16* out1;     // column k >= split at out1[m * ld1 + k - split]
  int ldx, ld0, ld1, split;
  int M, D, H, W, C, K, Cpad, Rpad, n_tiles;
  bool out_vec;            // 16-byte stores: every 8-column group in one place, aligned
};

template <int TBN, int NWG, bool kVec, int TAPS>
__global__ void __launch_bounds__(128 * NWG, 1) igemm_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  constexpr int THREADS = 128 * NWG;
  constexpr int BM = 64 * NWG;  // positions per block
  constexpr int STAGES = tc_stages(TBN, NWG);
  static_assert(STAGES >= 3, "the ring needs at least three stages");
  static_assert(TAPS == 1 || TAPS == 27, "1x1x1 or 3x3x3");
  constexpr int A_STAGE_BYTES = BM * TC_BK * 2;
  constexpr int B_STAGE_BYTES = TBN * TC_BK * 2;
  const uint32_t a_smem = base;                                  // [STAGES][BM][128 B]
  const uint32_t b_smem = base + STAGES * A_STAGE_BYTES;         // [STAGES][TBN][128 B]

  const int tid = threadIdx.x;
  const int n_tile = blockIdx.x % a.n_tiles;
  const int m0 = (blockIdx.x / a.n_tiles) * BM;
  const int n0 = n_tile * TBN;
  const int D = a.D, H = a.H, W = a.W, C = a.C, Cpad = a.Cpad;
  const __nv_bfloat16* const x = a.x;

  // This thread gathers 16-byte chunk j of rows tid/8 + (THREADS/8)*i of
  // every A tile; their positions (t, h, w) are fixed for the whole
  // reduction. A row past M gets t = -4: every tap of it falls outside.
  const int a_j = tid & 7;
  int a_t[A_ROWS_PER_THREAD], a_h[A_ROWS_PER_THREAD], a_w[A_ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
    const int m = m0 + (tid >> 3) + (THREADS / 8) * i;
    a_t[i] = m < a.M ? 0 : -4;
    a_h[i] = 0;
    a_w[i] = 0;
    if (TAPS == 27 && m < a.M) {
      a_w[i] = m % W;
      a_h[i] = (m / W) % H;
      a_t[i] = (m / (H * W)) % D;
    }
  }
  const __nv_bfloat16* w_tile = a.w + static_cast<int64_t>(n0) * a.Rpad;

  auto load_chunk = [&](int chunk, int stage) {
    // A: reduction elements [chunk*64 + 8*a_j, +8) = one tap, 8 channels.
    const int r0 = chunk * TC_BK + 8 * a_j;
    const int tap = r0 / Cpad;
    const int c = r0 - tap * Cpad;
    const int dt = TAPS == 1 ? 0 : tap / 9 - 1;
    const int dh = TAPS == 1 ? 0 : (tap / 3) % 3 - 1;
    const int dw = TAPS == 1 ? 0 : tap % 3 - 1;
    const int shift = (dt * H + dh) * W + dw;
    const uint32_t a_stage = a_smem + stage * A_STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
      const int row = (tid >> 3) + (THREADS / 8) * i;
      const int tt = a_t[i] + dt, hh = a_h[i] + dh, ww = a_w[i] + dw;
      const bool inside = tap < TAPS && tt >= 0 && tt < D && hh >= 0 && hh < H &&
                          ww >= 0 && ww < W;
      const int64_t src = (static_cast<int64_t>(m0 + row) + shift) * a.ldx + c;
      const uint32_t dst = a_stage + swizzle128(row, a_j);
      if (kVec) {
        cp_async16(dst, inside ? x + src : x, inside ? 16 : 0);
      } else {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (inside && c + e < C) ? x[src + e] : __float2bfloat16_rn(0.f);
        st_shared16(dst, *reinterpret_cast<const uint4*>(v));
      }
    }
    // B: rows n0 .. n0 + TBN of the packed weight, the same 64 elements.
    const uint32_t b_stage = b_smem + stage * B_STAGE_BYTES;
    const __nv_bfloat16* w_chunk = w_tile + chunk * TC_BK;
#pragma unroll
    for (int v = tid; v < TBN * 8; v += THREADS) {
      const int row = v >> 3, j = v & 7;
      cp_async16_cg(b_stage + swizzle128(row, j),
                    w_chunk + static_cast<int64_t>(row) * a.Rpad + 8 * j);
    }
  };

  float acc[TBN / 2];
#pragma unroll
  for (int i = 0; i < TBN / 2; ++i) acc[i] = 0.f;

  const int warpgroup = tid >> 7;
  const int chunks = a.Rpad / TC_BK;
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < chunks) load_chunk(s, s);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < chunks; ++chunk) {
    // Chunk `chunk` has landed (STAGES - 3 younger groups may still be in
    // flight); after the barrier, every warpgroup has also finished the
    // wgmma of chunk - 2, whose stage the next load reuses.
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();
    __syncthreads();
    const int next = chunk + STAGES - 2;
    if (next < chunks) load_chunk(next, next % STAGES);
    cp_async_commit();

    const int stage = chunk % STAGES;
    const uint32_t a_tile = a_smem + stage * A_STAGE_BYTES + warpgroup * 64 * 128;
    const uint32_t b_tile = b_smem + stage * B_STAGE_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < TC_BK / 16; ++k)
      Wgmma<TBN>::mma(acc, smem_desc(a_tile + 32 * k), smem_desc(b_tile + 32 * k));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue. This thread's accumulators: for each 8-wide column group g,
  // acc[4g], acc[4g+1] at row r0, columns 8g + 2*(lane % 4) + {0, 1}, and
  // acc[4g+2], acc[4g+3] at row r0 + 8, with r0 = 16*warp + lane / 4 within
  // the warpgroup's 64 rows.
  constexpr int CT_STRIDE = TBN + 8;  // bf16 elements per staged row
  __nv_bfloat16* ctile = reinterpret_cast<__nv_bfloat16*>(smem);
  const int lane = tid & 31;
  const int row0 = warpgroup * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int K = a.K;
#pragma unroll
  for (int g = 0; g < TBN / 8; ++g) {
    const int col = 8 * g + 2 * (lane & 3);
    const int k = n0 + col;
    const float s0 = a.scale == nullptr ? 1.f : k < K ? a.scale[k] : 0.f;
    const float s1 = a.scale == nullptr ? 1.f : k + 1 < K ? a.scale[k + 1] : 0.f;
    const float b0 = k < K ? a.bias[k] : 0.f, b1 = k + 1 < K ? a.bias[k + 1] : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float y0 = acc[4 * g + 2 * half] * s0 + b0;
      float y1 = acc[4 * g + 2 * half + 1] * s1 + b1;
      y0 = y0 < 0.f ? 0.f : y0;
      y1 = y1 < 0.f ? 0.f : y1;
      *reinterpret_cast<__nv_bfloat162*>(ctile + (row0 + 8 * half) * CT_STRIDE + col) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
  __syncthreads();
  for (int v = tid; v < BM * (TBN / 8); v += THREADS) {
    const int row = v / (TBN / 8);
    const int col = 8 * (v - row * (TBN / 8));
    const int m = m0 + row;
    const int k = n0 + col;
    if (m >= a.M || k >= K) continue;
    const __nv_bfloat16* src = ctile + row * CT_STRIDE + col;
    if (a.out_vec && k + 8 <= K) {
      __nv_bfloat16* dst = k < a.split
                               ? a.out0 + static_cast<int64_t>(m) * a.ld0 + k
                               : a.out1 + static_cast<int64_t>(m) * a.ld1 + (k - a.split);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && k + e < K; ++e) {
        const int kk = k + e;
        __nv_bfloat16* dst = kk < a.split
                                 ? a.out0 + static_cast<int64_t>(m) * a.ld0 + kk
                                 : a.out1 + static_cast<int64_t>(m) * a.ld1 + (kk - a.split);
        *dst = src[e];
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int TBN, int NWG, int TAPS>
int launch_tiles(Args a, cudaStream_t stream) {
  a.n_tiles = (a.K + TBN - 1) / TBN;
  const int64_t blocks = static_cast<int64_t>((a.M + 64 * NWG - 1) / (64 * NWG)) * a.n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = a.C % 8 == 0 && a.ldx % 8 == 0 && aligned16(a.x);
  a.out_vec = a.K % 8 == 0 && a.split % 8 == 0 && a.ld0 % 8 == 0 && a.ld1 % 8 == 0 &&
              aligned16(a.out0) && aligned16(a.out1);
  constexpr int smem = tc_smem_bytes(TBN, NWG);
  void (*kernel)(const Args) = igemm_kernel<TBN, NWG, true, TAPS>;
  if constexpr (TAPS == 1) {
    if (!vec) return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (!vec) kernel = igemm_kernel<TBN, NWG, false, TAPS>;
  }
  // Above 48 KB of dynamic shared memory a kernel must be allowed it, once
  // per device.
  static bool allowed[2][64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!allowed[vec][device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[vec][device] = true;
  }
  kernel<<<static_cast<unsigned>(blocks), 128 * NWG, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The wide block or two warpgroups (warpgroups = 0), whichever a model of
// a run bound by loads into shared memory puts ahead: full waves of blocks
// over the SMs (one block each), times the rows each block loads per chunk
// (BM + BN). The wide block must win by 12% in the model, which overstates
// its gain. warpgroups = 2, or the wide count, forces one.
template <int TBN, int TAPS>
int launch_width(const Args& a, int sms, int warpgroups, cudaStream_t stream) {
  constexpr int WIDE = tc_wide(TBN);
  const int64_t n_tiles = (a.K + TBN - 1) / TBN;
  auto cost = [&](int nwg) {
    const int64_t blocks = (a.M + 64 * nwg - 1) / (64 * nwg) * n_tiles;
    return static_cast<double>((blocks + sms - 1) / sms) * (64 * nwg + TBN);
  };
  if (warpgroups != 0 && warpgroups != 2 && warpgroups != WIDE)
    return static_cast<int>(cudaErrorInvalidValue);
  if (warpgroups == 0) warpgroups = cost(WIDE) < 0.88 * cost(2) ? WIDE : 2;
  if (warpgroups == WIDE) return launch_tiles<TBN, WIDE, TAPS>(a, stream);
  return launch_tiles<TBN, 2, TAPS>(a, stream);
}

// Checks the arguments and launches the block for tile width block_n (one
// of the widths in wgmma.cuh). M = N * D * H * W positions.
template <int TAPS>
int launch(Args a, int N, int block_n, int warpgroups, cudaStream_t stream) {
  if (N < 0 || a.D < 0 || a.H < 0 || a.W < 0 || a.C < 1 || a.K < 0 || a.Cpad < a.C ||
      a.Cpad % 8 != 0 || a.Rpad < TAPS * a.Cpad || a.Rpad % TC_BK != 0 || a.ldx < a.C ||
      a.split < 0 || a.split > a.K || (a.split > 0 && a.ld0 < a.split) ||
      (a.split < a.K && a.ld1 < a.K - a.split))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t M64 = static_cast<int64_t>(N) * a.D * a.H * a.W;
  if (M64 == 0 || a.K == 0) return 0;
  // Positions are int32 inside the kernel.
  if (M64 + 256 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.M = static_cast<int>(M64);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
#define STEP_IGEMM_TILE(n) \
  case n:                  \
    return launch_width<n, TAPS>(a, sms, warpgroups, stream);
  switch (block_n) {
    STEP_IGEMM_TILE(32) STEP_IGEMM_TILE(48) STEP_IGEMM_TILE(64) STEP_IGEMM_TILE(96)
    STEP_IGEMM_TILE(128) STEP_IGEMM_TILE(144) STEP_IGEMM_TILE(160)
    STEP_IGEMM_TILE(192) STEP_IGEMM_TILE(208) STEP_IGEMM_TILE(224)
    STEP_IGEMM_TILE(256)
  }
#undef STEP_IGEMM_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace igemm

// The C entry of one TAPS: x, w, scale (or null), bias, then out0 / ld0
// for columns below split and out1 / ld1 for the rest; the grid N, D, H,
// W; C input channels (row stride ldx), K output channels; Cpad and Rpad of
// the packed weight; the tile width and the warpgroups (0: the launcher
// picks).
#define STEP_IGEMM_ENTRY(name, TAPS)                                                     \
  extern "C" int name(const void* x, int ldx, const void* w, const float* scale,        \
                      const float* bias, void* out0, int ld0, void* out1, int ld1,       \
                      int split, int N, int D, int H, int W, int C, int K, int Cpad,     \
                      int Rpad, int block_n, int warpgroups, void* stream) {            \
    igemm::Args a{};                                                                     \
    a.x = static_cast<const __nv_bfloat16*>(x);                                          \
    a.w = static_cast<const __nv_bfloat16*>(w);                                          \
    a.scale = scale;                                                                     \
    a.bias = bias;                                                                       \
    a.out0 = static_cast<__nv_bfloat16*>(out0);                                          \
    a.out1 = static_cast<__nv_bfloat16*>(out1);                                          \
    a.ldx = ldx; a.ld0 = ld0; a.ld1 = ld1; a.split = split;                              \
    a.D = D; a.H = H; a.W = W; a.C = C; a.K = K; a.Cpad = Cpad; a.Rpad = Rpad;           \
    return igemm::launch<TAPS>(a, N, block_n, warpgroups,                                \
                               static_cast<cudaStream_t>(stream));                       \
  }
