// 3x3x3 convolution, stride 1, SAME (zero) padding, with an affine (the
// inference BatchNorm) or a bias (a folded BN) and the ReLU in its
// epilogue, for Hopper (sm_90a):
//
//     out = relu(conv3d(x, w) * scale? + bias)
//
// Replaces the Pallas TPU kernel step_tpu/ops/conv3d_pallas.py::_kernel
// (pallas_call at :114, conv3x3x3_bn_relu at :86). In the port it runs
// every 3x3x3 stride-1 Unit3D (Conv3d_2c_3x3 and each Inception b1b/b2b)
// of a fused_bn_relu=True model whose BN is not folded (K3,
// ops/conv3d.py), and the b1b and b2b convs of each served Inception block
// of the heads' tail (ops/inception.py, the tube conv), which read their
// input channels in place from the block's b1|b2 scratch (row stride
// c1 + c3) and write into their channel slice of the block's output (row
// stride Cout).
// The plain PyTorch versions are ops/conv3d.py::conv3x3x3_bn_relu_plain and
// ops/inception.py::inception_block_plain.
//
// What bounds it on the card: arithmetic. An implicit GEMM of
// M = N*T*H*W positions by K output channels over 27*C products. The heads'
// convs of a B=32 request (M = 512 tubes x 5 x 49 = 125,440 rows): Mixed_5b
// b1b 160 -> 320 is 347 GFLOP (0.35 ms at 989 TFLOP/s) against 120 MB of
// bf16 input and output (0.04 ms at 3.35 TB/s); Mixed_5c b1b 192 -> 384 is
// 499 GFLOP; the b2b convs 28 and 42 GFLOP. Far above the card's ridge
// point, so only the tensor cores can come near the bound.
//
// bfloat16, two kernels on the tensor cores, chosen by the grid:
//   * K3, any grid: the implicit GEMM of igemm.cuh with TAPS = 27 (its note
//     gives the design). The tile width is chosen per launch from K
//     (kernels.py::conv_tile_n) so that the Inception widths 128, 208, 224,
//     288, 320 and 384 fill whole tiles; a K that no width divides is
//     masked in the epilogue. Its A gather reads every input value once per
//     tap from L2, which held it to 44% of its bound at the tail's shape;
//   * the heads' 7x7 ROI grid: tube_conv_kernel below, whose note gives the
//     design: each input chunk staged once and reused by all 27 taps, A
//     built in registers with ldmatrix, the weight tile landed by one bulk
//     copy a step. It reads its input rows at a row stride and writes at
//     another, so a channel slice goes in and out with no copy. On an H100
//     SXM at 700 W, at the B=32 shapes: the b1b convs at 63-65% of their
//     bound, the narrow b2b convs (32-48 channels) at 30-40% (PERF.md §6).
//
// float32 (the parity mode): the CUDA-core kernel conv_f32_kernel. One
// block of 256 threads per 64 x 64 output tile, a 4 x 4 tile of float32
// accumulators per thread; the reduction walks the 27 taps and C in chunks
// of 16, staged through shared memory with zero padding as masked loads;
// products accumulate with explicit fmaf.

#include <cuda_runtime.h>
#include <stdint.h>

#include "igemm.cuh"

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


// ------------------------------------------- bfloat16 tube conv (the heads)
// The 3x3x3 conv over the heads' 7x7 ROI grid: input row m = (n * T + t)
// * 49 + 7 h + w, channel c at x[m * ldx + c], output row m at
// out[m * ldo + k]. A block computes 256 consecutive rows (5.2 frames,
// crossing from one tube into the next where they meet) by TBN output
// channels with four consumer warpgroups; the rows of a request's tubes,
// 512 x T' x 49, are a whole number of blocks at T' = 5 and 9. The
// reduction runs channel chunk by channel chunk (64 channels), and within
// a chunk tap by tap; one step is one (chunk, tap):
//   * the chunk's input, the frames the block's rows touch and one frame
//     either side (at most 9 x 49 positions x 128 bytes, 56 KB), is staged
//     once into one of two shared-memory slabs with 16-byte cp.async
//     copies, zero past the tensor's ends or C, the next chunk's slab in
//     flight while this chunk's 27 taps run. Each position's 128 bytes are
//     XOR-swizzled by its row index mod 8, so the 8 rows of an ldmatrix
//     fall in 8 different bank groups. A tap that leaves the 7x7 grid, or
//     its tube's frames, reads one zero row kept at the end of the slab;
//   * each warp builds its A fragments from the slab with ldmatrix.x4, one
//     per k16 step, each lane pointing at its row's shifted position, and
//     issues wgmma.mma_async with A from registers (WgmmaRS) and B from the
//     step's weight tile: 27 taps reuse one staged slab, where the gather
//     of igemm.cuh read every input value 27 times from L2;
//   * the weight is packed tile by tile in the order the steps read it,
//     each tile already in the 128-byte swizzle (ops/conv3d.py::
//     pack_tube_weight), so one thread loads a step's whole B tile with one
//     cp.async.bulk copy completing on that stage's mbarrier, S - 2 steps
//     ahead in a ring of S stages;
//   * a step's four k16 wgmmas go as two commit groups, each with its own
//     A registers, so a group's ldmatrix overlaps the other's tensor work;
//     a chunk whose last 32 channels are padding (C = 32, or the third
//     chunk of C = 160) runs the first group alone;
//   * the epilogue adds the bias (the served units are BN-folded), applies
//     the ReLU, rounds once and, staged in shared memory, stores 16 bytes at
//     a time at the output's row stride.
constexpr int TUBE_HW = 49;                         // the 7x7 grid
constexpr int TUBE_BM = 256;                        // rows a block
// The frames 256 rows can touch (7), one either side, and the zero row.
constexpr int TUBE_SLAB_ROWS = ((TUBE_BM + TUBE_HW - 2) / TUBE_HW + 1 + 2) * TUBE_HW + 1;
constexpr int TUBE_ZERO_ROW = TUBE_SLAB_ROWS - 1;
constexpr int TUBE_SLAB_BYTES = (TUBE_SLAB_ROWS * 128 + 1023) / 1024 * 1024;
constexpr int TUBE_THREADS = 512;
constexpr int TUBE_MAX_SMEM = 232448;

__host__ __device__ constexpr int tube_stages(int tbn) {
  return (TUBE_MAX_SMEM - 2048 - 2 * TUBE_SLAB_BYTES) / (tbn * 128) < 6
             ? (TUBE_MAX_SMEM - 2048 - 2 * TUBE_SLAB_BYTES) / (tbn * 128)
             : 6;
}
__host__ __device__ constexpr int tube_smem_bytes(int tbn) {
  return 1024 + tube_stages(tbn) * tbn * 128 + 2 * TUBE_SLAB_BYTES + 1024;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
// fence_regs for the A registers that a pending wgmma reads.
template <int R>
__device__ __forceinline__ void fence_words(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

struct TubeArgs {
  const __nv_bfloat16* x;  // input row (n, t, h, w), channel c at x[row * ldx + c]
  const __nv_bfloat16* w;  // [n_tiles][steps][TBN][64], each tile swizzled
  const float* bias;       // [K]
  __nv_bfloat16* out;      // output row, channel k at out[row * ldo + k]
  int ldx, ldo, T, C, K, M, frames, n_tiles, chunks;   // frames = N * T
  bool out_vec;
};

template <int TBN>
__global__ void __launch_bounds__(TUBE_THREADS, 1) tube_conv_kernel(const TubeArgs a) {
  using namespace igemm;
  constexpr int S = tube_stages(TBN);
  static_assert(S >= 3, "the weight ring needs at least three stages");
  constexpr uint32_t B_BYTES = TBN * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t b_smem = base;                              // [S][TBN][128 B]
  const uint32_t slab_smem = base + S * B_BYTES;             // [2][SLAB_ROWS][128 B]
  const uint32_t bars = slab_smem + 2 * TUBE_SLAB_BYTES;     // [S] mbarriers

  const int tid = threadIdx.x;
  const int n_tile = blockIdx.x % a.n_tiles;
  const int m0 = (blockIdx.x / a.n_tiles) * TUBE_BM;
  const int rows = min(TUBE_BM, a.M - m0);
  const int g0 = m0 / TUBE_HW - 1;                   // the slab's first frame
  const int slab_frames = (m0 + rows - 1) / TUBE_HW - g0 + 2;
  const int n0 = n_tile * TBN;
  const int steps = 27 * a.chunks;
  const __nv_bfloat16* w_tiles = a.w + static_cast<int64_t>(n_tile) * steps * TBN * 64;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 16) {  // the zero row of each slab
    const uint32_t z = slab_smem + (tid >> 3) * TUBE_SLAB_BYTES + TUBE_ZERO_ROW * 128 +
                       (tid & 7) * 16;
    st_shared16(z, make_uint4(0u, 0u, 0u, 0u));
  }
  __syncthreads();

  // A chunk's slab: position p = 49 f + 7 h + w of global frame g0 + f
  // (frame n * T + t), 16-byte piece j of channels 64 cc + 8 j at
  // (j ^ p % 8).
  auto load_slab = [&](int cc) {
    const uint32_t slab = slab_smem + (cc & 1) * TUBE_SLAB_BYTES;
    const int pieces = slab_frames * TUBE_HW * 8;
    for (int v = tid; v < pieces; v += TUBE_THREADS) {
      const int p = v >> 3, j = v & 7;
      const int g = g0 + p / TUBE_HW, c = 64 * cc + 8 * j;
      const bool ok = g >= 0 && g < a.frames && c < a.C;
      const __nv_bfloat16* src =
          a.x + (static_cast<int64_t>(g0) * TUBE_HW + p) * a.ldx + c;
      cp_async16(slab + p * 128 + ((j ^ (p & 7)) << 4), ok ? src : a.x, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  auto load_b = [&](int step) {
    const int s = step % S;
    mbar_expect_tx(bars + 8 * s, B_BYTES);
    bulk_load(b_smem + s * B_BYTES, w_tiles + static_cast<int64_t>(step) * TBN * 64, B_BYTES,
              bars + 8 * s);
  };

  load_slab(0);
  if (tid == 0)
    for (int s = 0; s < S - 2 && s < steps; ++s) load_b(s);

  // This lane's ldmatrix row: row (lane % 8) + 8 ((lane / 8) % 2) of its
  // warp's 16, k half lane / 16; its frame's place in the slab (mf) and in
  // its tube (mt). A row past the block's reads the zero row.
  const int warpgroup = tid >> 7, lane = tid & 31;
  const int m = warpgroup * 64 + ((tid >> 5) & 3) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const bool row_ok = m < rows;
  const int mg = (m0 + m) / TUBE_HW, mhw = (m0 + m) % TUBE_HW;
  const int mf = mg - g0, mt = mg % a.T, mh = mhw / 7, mw = mhw % 7;
  const int khalf = lane >> 4;

  float acc[TBN / 2];
#pragma unroll
  for (int i = 0; i < TBN / 2; ++i) acc[i] = 0.f;
  uint32_t a0[2][4], a1[2][4];

  for (int step = 0; step < steps; ++step) {
    const int cc = step / 27, tap = step - 27 * cc;
    if (tap == 0) {
      cp_async_wait<0>();  // this chunk's slab (the only cp.async group in flight)
      __syncthreads();     // ... from every thread; the other slab is free
      if (cc + 1 < a.chunks) load_slab(cc + 1);
    } else {
      __syncthreads();     // every warpgroup is past the wgmma of step - 2
    }
    if (tid == 0 && step + S - 2 < steps) load_b(step + S - 2);
    const int s = step % S;
    while (!mbar_try_wait(bars + 8 * s, (step / S) & 1)) {
    }

    const int dt = tap / 9 - 1, dh = (tap / 3) % 3 - 1, dw = tap % 3 - 1;
    const int tt = mt + dt, hh = mh + dh, ww = mw + dw;
    const int p = row_ok && tt >= 0 && tt < a.T && hh >= 0 && hh < 7 && ww >= 0 && ww < 7
                      ? (mf + dt) * TUBE_HW + 7 * hh + ww
                      : TUBE_ZERO_ROW;
    const uint32_t row_addr = slab_smem + (cc & 1) * TUBE_SLAB_BYTES + p * 128;
    const int sw = p & 7;
    const uint32_t b_tile = b_smem + s * B_BYTES;

    // k16 steps 0 and 1, then 2 and 3, each pair with its own registers.
#pragma unroll
    for (int k = 0; k < 2; ++k) ldmatrix_x4(a0[k], row_addr + (((2 * k + khalf) ^ sw) << 4));
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 2; ++k) WgmmaRS<TBN>::mma(acc, a0[k], smem_desc(b_tile + 32 * k));
    wgmma_commit();
    if (a.C - 64 * cc <= 32) {
      // The chunk's last 32 channels are padding: no second pair.
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int k = 0; k < 2; ++k) fence_words(a0[k]);
      continue;
    }
    wgmma_wait<1>();     // the previous step's second pair is done: a1 is free
    fence_regs(acc);
#pragma unroll
    for (int k = 0; k < 2; ++k) fence_words(a1[k]);
#pragma unroll
    for (int k = 2; k < 4; ++k)
      ldmatrix_x4(a1[k - 2], row_addr + (((2 * k + khalf) ^ sw) << 4));
    wgmma_fence();
#pragma unroll
    for (int k = 2; k < 4; ++k) WgmmaRS<TBN>::mma(acc, a1[k - 2], smem_desc(b_tile + 32 * k));
    wgmma_commit();
    wgmma_wait<1>();     // this step's first pair is done: a0 is free
    fence_regs(acc);
#pragma unroll
    for (int k = 0; k < 2; ++k) fence_words(a0[k]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // Epilogue, as igemm.cuh's: this thread's accumulators for each 8-wide
  // column group g at rows r0 and r0 + 8.
  constexpr int CT_STRIDE = TBN + 8;
  __nv_bfloat16* ctile = reinterpret_cast<__nv_bfloat16*>(smem);
  const int row0 = warpgroup * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int K = a.K;
#pragma unroll
  for (int g = 0; g < TBN / 8; ++g) {
    const int col = 8 * g + 2 * (lane & 3);
    const int k = n0 + col;
    const float b0 = k < K ? a.bias[k] : 0.f, b1 = k + 1 < K ? a.bias[k + 1] : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float y0 = acc[4 * g + 2 * half] + b0, y1 = acc[4 * g + 2 * half + 1] + b1;
      *reinterpret_cast<__nv_bfloat162*>(ctile + (row0 + 8 * half) * CT_STRIDE + col) =
          __floats2bfloat162_rn(y0 < 0.f ? 0.f : y0, y1 < 0.f ? 0.f : y1);
    }
  }
  __syncthreads();
  for (int v = tid; v < rows * (TBN / 8); v += TUBE_THREADS) {
    const int row = v / (TBN / 8);
    const int col = 8 * (v - row * (TBN / 8));
    const int k = n0 + col;
    if (k >= K) continue;
    const __nv_bfloat16* src = ctile + row * CT_STRIDE + col;
    __nv_bfloat16* dst = a.out + static_cast<int64_t>(m0 + row) * a.ldo + k;
    if (a.out_vec && k + 8 <= K) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && k + e < K; ++e) dst[e] = src[e];
    }
  }
}

template <int TBN>
int launch_tube(TubeArgs a, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>((a.M + TUBE_BM - 1) / TUBE_BM) * a.n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = tube_smem_bytes(TBN);
  static bool allowed[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(tube_conv_kernel<TBN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = true;
  }
  tube_conv_kernel<TBN><<<static_cast<unsigned>(blocks), TUBE_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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

// bfloat16 on the tensor cores (igemm.cuh, TAPS = 27): x row m, channel c
// at x[m * ldx + c]; w the packed [Kw, Rpad] weight (Cpad = C rounded up
// to 8, Rpad = 27 * Cpad rounded up to 64, Kw = K rounded up to block_n);
// scale (or null for 1) and bias [K] float32; output column k < split at
// out0[m * ld0 + k], the rest at out1[m * ld1 + k - split], bf16. block_n is
// one of the widths in wgmma.cuh; warpgroups is 0 (the launcher picks the
// block), 2, or the widest block for block_n.
STEP_IGEMM_ENTRY(step_conv3x3x3_bf16, 27)

// The tube conv (tube_conv_kernel) of the heads' 7x7 grid, bfloat16: x
// row (n, t, h, w), channel c at x[((n * T + t) * 49 + 7 h + w) * ldx + c]
// (C and ldx multiples of 8, x 16-byte aligned); w the tile-packed weight
// of ops/conv3d.py::pack_tube_weight for tile width block_n, [ceil(K /
// block_n)][27 * ceil(C / 64)][block_n][64]; bias [K] float32; out row at
// out[row * ldo + k], bf16.
extern "C" int step_conv3x3x3_tube_bf16(const void* x, int ldx, const void* w,
                                        const float* bias, void* out, int ldo, int N, int T,
                                        int C, int K, int block_n, void* stream) {
  if (N < 0 || T < 0 || C < 8 || C % 8 != 0 || ldx < C || ldx % 8 != 0 || K < 1 ||
      ldo < K || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(N) * T * TUBE_HW + TUBE_BM > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || T == 0) return 0;
  TubeArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = bias;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ldx = ldx; a.ldo = ldo; a.T = T; a.C = C; a.K = K;
  a.frames = N * T;
  a.M = a.frames * TUBE_HW;
  a.n_tiles = (K + block_n - 1) / block_n;
  a.chunks = (C + 63) / 64;
  a.out_vec = K % 8 == 0 && ldo % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_n) {
    case 64: return launch_tube<64>(a, s);
    case 128: return launch_tube<128>(a, s);
    case 160: return launch_tube<160>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
