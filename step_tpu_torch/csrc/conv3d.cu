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
// Mixed_5b b1b at B=8 (M = 31,360, C = 160, K = 320) is 86.7 GFLOP against
// ~25 MB of traffic, far above the card's ridge point, so in bf16 only the
// tensor cores (989 TFLOP/s) can come near the bound.
//
// bfloat16: an implicit GEMM on the tensor cores (conv_bf16_kernel). The
// GEMM is [M positions] x [K channels], reduced over R = 27 * Cpad, where
// Cpad is C rounded up to 8 and the reduction index is tap * Cpad + c
// (tap = 9*dt + 3*dh + dw). The wrapper packs the weight as a dense,
// zero-padded [Kw, Rpad] matrix, Kw a multiple of the tile width BN and Rpad
// of 64 (ops/conv3d.py::pack_conv3x3x3_weight). A block of two to four
// warpgroups computes a BM x BN output tile, 64 rows per warpgroup:
//   * the reduction runs in chunks of 64 (128 bytes of bf16), through a
//     ring of 4-6 shared-memory stages (as many as 227 KB hold for the
//     tile, at most 6). Every thread gathers its part of the A tile
//     (BM positions x 64 reduction elements) from the NDHWC input with
//     16-byte cp.async copies, one per 8 channels of one tap; SAME
//     padding, the ragged C and the tail past 27 * Cpad are cp.async's
//     zero-fill (source size 0). The B tile (BN channels x 64) is a straight
//     16-byte cp.async copy of the packed weight. Both land in the 128-byte
//     swizzled K-major layout that wgmma reads through a descriptor;
//   * the loads of chunks i + 1 .. i + STAGES - 2 are in flight while the
//     tensor cores run chunk i: each warpgroup issues four wgmma.mma_async
//     m64nBNk16 per chunk (bf16 x bf16 into float32 registers), commits
//     them and waits only for the previous chunk's group;
//   * the epilogue applies scale, bias and ReLU in float32, rounds once to
//     bf16, stages the tile in shared memory and writes 16-byte stores.
// BN is chosen per launch from K (kernels.py::conv_tile_n) so that the
// Inception widths 208, 224, 288, 320 and 384 fill whole tiles; a K that no
// width divides is masked in the epilogue. Every chunk streams a B tile
// from L2, so a wider block (BM = 192 or 256, as far as the registers
// allow) reads less per product; the launcher takes it where the grid still
// fills the SMs (launch_bf16). A C that is not a multiple of 8,
// or an input that is not 16-byte aligned, gathers A with scalar loads into
// the same shared-memory tile (the kVec = false variant), still on wgmma.
//
// float32 (the parity mode): the CUDA-core kernel conv_f32_kernel. One
// block of 256 threads per 64 x 64 output tile, a 4 x 4 tile of float32
// accumulators per thread; the reduction walks the 27 taps and C in chunks
// of 16, staged through shared memory with zero padding as masked loads;
// products accumulate with explicit fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

// ------------------------------------------------------------ float32 path
constexpr int BM = 64;   // positions per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // input channels per stage
constexpr int TM = 4;    // positions per thread
constexpr int TN = 4;    // output channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
conv_f32_kernel(const float* __restrict__ x,      // [N, D, H, W, C]
                const float* __restrict__ w,      // [27, C, K]
                const float* __restrict__ scale,  // [K]
                const float* __restrict__ bias,   // [K]
                float* __restrict__ out,          // [N, D, H, W, K]
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
    const float* src =
        x + (((pn * D + (inside ? tt : 0)) * H + (inside ? hh : 0)) * W +
             (inside ? ww : 0)) * C;
    const float* wt = w + static_cast<int64_t>(tap) * C * K;
    for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + a_c + j;
        As[a_c + j][a_m] = (inside && c < C) ? src[c] : 0.f;
      }
      const int kc = c0 + b_k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + b_n + j;
        Bs[b_k][b_n + j] = (kc < C && k < K) ? wt[static_cast<int64_t>(kc) * K + k] : 0.f;
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

  // Epilogue: BN affine and ReLU, one store.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + ty * TM + i;
    if (m >= M) continue;
    float* dst = out + m * K;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = k0 + tx * TN + j;
      if (k >= K) continue;
      const float y = acc[i][j] * scale[k] + bias[k];
      dst[k] = y < 0.f ? 0.f : y;
    }
  }
}

// ----------------------------------------------------- bfloat16 tensor cores
constexpr int TC_BK = 64;         // reduction elements per chunk (128 bytes)
constexpr int A_ROWS_PER_THREAD = 4;  // 64 rows x 8 chunks / 128 threads
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use

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

template <int TBN, int NWG, bool kVec>
__global__ void __launch_bounds__(128 * NWG, 1)
conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,     // [N, D, H, W, C]
                 const __nv_bfloat16* __restrict__ w,     // [Kw, Rpad] packed
                 const float* __restrict__ scale,         // [K]
                 const float* __restrict__ bias,          // [K]
                 __nv_bfloat16* __restrict__ out,         // [N, D, H, W, K]
                 int M, int D, int H, int W, int C, int K, int Cpad, int Rpad,
                 int n_tiles, bool out_vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  constexpr int THREADS = 128 * NWG;
  constexpr int BM = 64 * NWG;  // positions per block
  constexpr int STAGES = tc_stages(TBN, NWG);
  static_assert(STAGES >= 3, "the ring needs at least three stages");
  constexpr int A_STAGE_BYTES = BM * TC_BK * 2;
  constexpr int B_STAGE_BYTES = TBN * TC_BK * 2;
  const uint32_t a_smem = base;                                  // [STAGES][BM][128 B]
  const uint32_t b_smem = base + STAGES * A_STAGE_BYTES;         // [STAGES][TBN][128 B]

  const int tid = threadIdx.x;
  const int n_tile = blockIdx.x % n_tiles;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = n_tile * TBN;
  const int HW = H * W;

  // This thread gathers 16-byte chunk j of rows tid/8 + (THREADS/8)*i of
  // every A tile; their positions (t, h, w) are fixed for the whole
  // reduction.
  const int a_j = tid & 7;
  int a_t[A_ROWS_PER_THREAD], a_h[A_ROWS_PER_THREAD], a_w[A_ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
    const int m = m0 + (tid >> 3) + (THREADS / 8) * i;
    if (m < M) {
      a_w[i] = m % W;
      a_h[i] = (m / W) % H;
      a_t[i] = (m / HW) % D;
    } else {
      a_t[i] = -4;  // every tap of a row past M falls outside
      a_h[i] = 0;
      a_w[i] = 0;
    }
  }
  const __nv_bfloat16* w_tile = w + static_cast<int64_t>(n0) * Rpad;

  auto load_chunk = [&](int chunk, int stage) {
    // A: reduction elements [chunk*64 + 8*a_j, +8) = one tap, 8 channels.
    const int r0 = chunk * TC_BK + 8 * a_j;
    const int tap = r0 / Cpad;
    const int c = r0 - tap * Cpad;
    const int dt = tap / 9 - 1, dh = (tap / 3) % 3 - 1, dw = tap % 3 - 1;
    const int shift = (dt * H + dh) * W + dw;
    const uint32_t a_stage = a_smem + stage * A_STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
      const int row = (tid >> 3) + (THREADS / 8) * i;
      const int tt = a_t[i] + dt, hh = a_h[i] + dh, ww = a_w[i] + dw;
      const bool inside = tap < 27 && tt >= 0 && tt < D && hh >= 0 && hh < H &&
                          ww >= 0 && ww < W;
      const int64_t src = (static_cast<int64_t>(m0 + row) + shift) * C + c;
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
                    w_chunk + static_cast<int64_t>(row) * Rpad + 8 * j);
    }
  };

  float acc[TBN / 2];
#pragma unroll
  for (int i = 0; i < TBN / 2; ++i) acc[i] = 0.f;

  const int warpgroup = tid >> 7;
  const int chunks = Rpad / TC_BK;
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
#pragma unroll
  for (int g = 0; g < TBN / 8; ++g) {
    const int col = 8 * g + 2 * (lane & 3);
    const int k = n0 + col;
    const float s0 = k < K ? scale[k] : 0.f, s1 = k + 1 < K ? scale[k + 1] : 0.f;
    const float b0 = k < K ? bias[k] : 0.f, b1 = k + 1 < K ? bias[k + 1] : 0.f;
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
    if (m >= M || k >= K) continue;
    const __nv_bfloat16* src = ctile + row * CT_STRIDE + col;
    __nv_bfloat16* dst = out + static_cast<int64_t>(m) * K + k;
    if (out_vec && k + 8 <= K) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && k + e < K; ++e) dst[e] = src[e];
    }
  }
}

template <int TBN, int NWG>
int launch_tiles(const void* x, const void* w, const float* scale,
                 const float* bias, void* out, int M, int D, int H, int W,
                 int C, int K, int Cpad, int Rpad, cudaStream_t stream) {
  const int n_tiles = (K + TBN - 1) / TBN;
  const int64_t blocks = static_cast<int64_t>((M + 64 * NWG - 1) / (64 * NWG)) * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool out_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int smem = tc_smem_bytes(TBN, NWG);
  auto kernel = vec ? conv_bf16_kernel<TBN, NWG, true> : conv_bf16_kernel<TBN, NWG, false>;
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
  kernel<<<static_cast<unsigned>(blocks), 128 * NWG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      scale, bias, static_cast<__nv_bfloat16*>(out), M, D, H, W, C, K, Cpad,
      Rpad, n_tiles, out_vec);
  return static_cast<int>(cudaGetLastError());
}

// The wide block or two warpgroups (warpgroups = 0), whichever a model of
// a run bound by loads into shared memory puts ahead: full waves of blocks
// over the SMs (one block each), times the rows each block loads per chunk
// (BM + BN). The wide block must win by 12% in the model, which overstates
// its gain (conv_tune.py measures both). warpgroups = 2, or the wide count,
// forces one.
template <int TBN>
int launch_bf16(const void* x, const void* w, const float* scale,
                const float* bias, void* out, int M, int D, int H, int W,
                int C, int K, int Cpad, int Rpad, int sms, int warpgroups,
                cudaStream_t stream) {
  constexpr int WIDE = tc_wide(TBN);
  const int64_t n_tiles = (K + TBN - 1) / TBN;
  auto cost = [&](int nwg) {
    const int64_t blocks = (M + 64 * nwg - 1) / (64 * nwg) * n_tiles;
    return static_cast<double>((blocks + sms - 1) / sms) * (64 * nwg + TBN);
  };
  if (warpgroups != 0 && warpgroups != 2 && warpgroups != WIDE)
    return static_cast<int>(cudaErrorInvalidValue);
  if (warpgroups == 0) warpgroups = cost(WIDE) < 0.88 * cost(2) ? WIDE : 2;
  if (warpgroups == WIDE)
    return launch_tiles<TBN, WIDE>(x, w, scale, bias, out, M, D, H, W, C, K,
                                   Cpad, Rpad, stream);
  return launch_tiles<TBN, 2>(x, w, scale, bias, out, M, D, H, W, C, K, Cpad,
                              Rpad, stream);
}

}  // namespace

// float32. x: [N, D, H, W, C], w: [27, C, K] (tap = 9*dt + 3*dh + dw), out:
// [N, D, H, W, K], scale, bias: [K], all contiguous.
extern "C" int step_conv3x3x3_bn_relu_f32(const float* x, const float* w,
                                          const float* scale, const float* bias,
                                          float* out, int N, int D, int H, int W,
                                          int C, int K, void* stream) {
  if (N < 0 || D < 0 || H < 0 || W < 0 || C < 1 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t M = static_cast<int64_t>(N) * D * H * W;
  if (M == 0 || K == 0) return 0;
  const int64_t mblocks = (M + BM - 1) / BM;
  if (mblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(mblocks), (K + BN - 1) / BN);
  conv_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, scale, bias, out, M, D, H, W, C, K);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 on the tensor cores. x: [N, D, H, W, C], w: the packed
// [Kw, Rpad] weight (Cpad = C rounded up to 8, Rpad = 27 * Cpad rounded up
// to 64, Kw = K rounded up to block_n), out: [N, D, H, W, K] bf16; scale,
// bias: [K] float32. block_n is one of the widths in wgmma.cuh;
// warpgroups is 0 (the launcher picks the block), 2, or the widest block
// for block_n.
extern "C" int step_conv3x3x3_bn_relu_bf16(const void* x, const void* w,
                                           const float* scale, const float* bias,
                                           void* out, int N, int D, int H, int W,
                                           int C, int K, int Cpad, int Rpad,
                                           int block_n, int warpgroups,
                                           void* stream) {
  if (N < 0 || D < 0 || H < 0 || W < 0 || C < 1 || K < 0 || Cpad < C ||
      Cpad % 8 != 0 || Rpad < 27 * Cpad || Rpad % TC_BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t M64 = static_cast<int64_t>(N) * D * H * W;
  if (M64 == 0 || K == 0) return 0;
  // Positions are int32 inside the kernel, and so are offsets into x / C.
  if (M64 + 256 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int M = static_cast<int>(M64);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
#define STEP_CONV_TILE(n)                                                     \
  case n:                                                                     \
    return launch_bf16<n>(x, w, scale, bias, out, M, D, H, W, C, K, Cpad,     \
                          Rpad, sms, warpgroups, s);
  switch (block_n) {
    STEP_CONV_TILE(32) STEP_CONV_TILE(48) STEP_CONV_TILE(64) STEP_CONV_TILE(96)
    STEP_CONV_TILE(128) STEP_CONV_TILE(144) STEP_CONV_TILE(160)
    STEP_CONV_TILE(192) STEP_CONV_TILE(208) STEP_CONV_TILE(224)
    STEP_CONV_TILE(256)
  }
#undef STEP_CONV_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
