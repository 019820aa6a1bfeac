// MViTv2's attention pools for Hopper (sm_90a): one part (q, k or v) of a
// block's qkv GEMM output, read in place, through the depthwise 3x3x3
// convolution and the LayerNorm over d in one pass:
//
//     out[b, h, t, i, j, :] = LN_d(sum over 27 taps (kt, kh, kw) of
//         w[:, kt, kh, kw] * x[b, t + kt - 1, s*i + kh - 1, s*j + kw - 1, h, :])
//
// x is the part's channels of the GEMM's `[B, T*H*W, 3*dim_out]` bf16 output
// (token stride 3*dim_out, the part at channel offset part*dim_out, head h at
// h*96 within it), zero outside the grid (the conv's padding 1); the stride
// is (1, s, s) with s in {1, 2, 4, 8}; one `[96, 1, 3, 3, 3]` weight is shared
// by the heads. The conv's sum and the norm (biased variance, rsqrt(var +
// eps), then the norm's weight and bias) are float32 in registers with no
// rounding between them; the weights are rounded to bf16 first, as the plain
// version rounds them to the activations' dtype
// (ops/attn_pool.py::attn_pool_plain); the output is rounded once and
// written as `[B, h, T, Ho, Wo, 96]` bf16, contiguous: the `[B, h, N', d]`
// that models/mvit.py::packed_attention reads.
//
// It replaces no TPU kernel: the JAX package has no MViTv2 backbone, and a
// JAX model would leave this conv and norm to XLA. Before it the port ran
// PyTorch's conv_depthwise3d_cuda_kernel on channel-major parts (one GEMM a
// part to make them), then a LayerNorm on the transposed view behind a copy:
// 31.6 ms of a B=32 request over the 21 blocks.
//
// What bounds it on the card: bytes. A B=32 request's 63 pools read 3.97 GB
// of the parts' taps and write 1.79 GB (1.72 ms at 3.35 TB/s; the benchmark
// counts 6.86 GB, all of each part's input, 2.05 ms) for 48 GFLOP of conv,
// which the tensor cores cannot take (27 taps a channel, no shared
// reduction) and the CUDA cores' float32 rate, with the bf16 unpacking, does
// in about 1 ms. So the float32 work nearly matches the bytes, and the
// design keeps both moving:
//   * every input byte is read from device memory once: a block owns a
//     tile of output rows and columns of one (clip, head) and walks the
//     output frames, and each thread keeps the float32 sums of its two
//     outputs for three frames in registers (the frame ring), so an input
//     frame is read once, when it enters the ring, and each loaded vector is
//     applied to the kt = 0, 1 and 2 taps of the three outputs it feeds;
//   * the next frame's taps are in flight while this one is summed: each
//     thread copies its own taps of frame f + 1 into its slots of a
//     double-buffered array in shared memory (cp.async, zero-filled in the
//     padding), so no register holds them and no barrier orders them;
//   * the strided pools read only the rows and columns their taps touch
//     (9/64 of the grid at (1, 8, 8));
//   * loads and stores are 16 bytes a thread: four neighbouring lanes take
//     one token's 64 contiguous bytes, eight tokens a warp, so every sector
//     fetched is used whole, and a token's output is written as whole
//     sectors;
//   * a warp holds one group of 4 channel vectors (32 channels) for 8
//     output pairs, so its loads of the weights (float32, in shared memory)
//     are 4 distinct 16-byte words broadcast to 8 lanes each;
//   * the norm's mean and variance (two passes over the float32 sums) are
//     reduced over a token's 12 threads through a small double-buffered
//     array in shared memory, two barriers an output frame;
//   * blocks of 192 threads, two to an SM at s <= 2, so one block's
//     barriers and loads overlap the other's sums (one at s >= 4, whose
//     staged taps take 110.6 KB).
// Measured on an H100 (700 W): a B=32 request's 63 pools take 5.5 ms, 37% of
// the counted bound; the sums and norms alone (no loads) take 3.3 ms, so the
// float32 work, not the bytes, sets the pace. The variants measured slower
// are listed in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm_count.cuh"

namespace {

constexpr int D = 96;               // channels of a head
constexpr int VECS = D / 8;         // 16-byte vectors of a head's channels
constexpr int GROUP_VECS = 4;       // channel vectors of a warp
constexpr int WARP_GROUPS = 8;      // output pairs of a warp
constexpr int P = 2;                // output columns of a thread
constexpr int MAX_PAIRS = 16;       // output pairs of a block
constexpr int THREADS = MAX_PAIRS / WARP_GROUPS * (VECS / GROUP_VECS) * 32;  // at most 192
constexpr int TAPS = 27;
static_assert(VECS % GROUP_VECS == 0, "a head's vectors split into warp groups");

struct Pool {
  long long ld;     // token stride of qkv, elements
  int T, H, W;      // the input grid
  int Ho, Wo;       // the output grid (T frames)
  int heads;
  int th, cg;       // a tile: th output rows x cg output pairs
  int row_tiles, col_tiles;
  int tc, chunks;   // output frames a block, and blocks along T
  float eps;
};

__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 bytes from global to shared memory, asynchronously, through L2 only;
// `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A weight as the kernel takes it: rounded to bf16, held as float32.
__device__ __forceinline__ float rounded(const void* p, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : __bfloat162float(__float2bfloat16_rn(static_cast<const float*>(p)[i]));
}

// Distinct input columns a thread's two outputs touch along a row, and the
// column of the m-th (relative to s*j0 - 1): at s <= 2 neighbouring taps
// share columns, at s >= 4 none do.
template <int S>
struct Cols {
  static constexpr int N = S == 1 ? P + 2 : S == 2 ? 2 * P + 1 : 3 * P;
  static __device__ __forceinline__ constexpr int of(int m) {
    return S <= 2 ? m : S * (m / 3) + m % 3;
  }
  static __device__ __forceinline__ constexpr int index(int q, int dc) {
    return S <= 2 ? S * q + dc : 3 * q + dc;
  }
};

template <int S>
__global__ void __launch_bounds__(THREADS, 2)
attn_pool_kernel(const __nv_bfloat16* __restrict__ qkv, const void* __restrict__ weight,
                 const void* __restrict__ norm_w, const void* __restrict__ norm_b, int wbf16,
                 __nv_bfloat16* __restrict__ out, Pool p) {
  using C = Cols<S>;
  __shared__ float4 wlo[TAPS][VECS], whi[TAPS][VECS];   // channels 8v..8v+3, 8v+4..8v+7
  __shared__ __align__(16) float gamma[D], beta[D];
  __shared__ __align__(16) float red[2][MAX_PAIRS * P][VECS];
  extern __shared__ uint4 staged[];   // [2 frames][3 rows][C::N taps][blockDim.x]

#pragma unroll 4
  for (int k = threadIdx.x; k < TAPS * D; k += blockDim.x) {
    const int c = k / TAPS, tap = k % TAPS;   // the weight is [96, 1, 3, 3, 3]
    float4* row = (c % 8 < 4 ? wlo : whi)[tap];
    reinterpret_cast<float*>(row)[(c / 8) * 4 + c % 4] = rounded(weight, k, wbf16);
  }
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    gamma[c] = rounded(norm_w, c, wbf16);
    beta[c] = rounded(norm_b, c, wbf16);
  }

  int bx = blockIdx.x;
  const int chunk = bx % p.chunks;
  bx /= p.chunks;
  const int tile_c = bx % p.col_tiles;
  bx /= p.col_tiles;
  const int tile_r = bx % p.row_tiles;
  const int bh = bx / p.row_tiles;
  const int b = bh / p.heads, h = bh % p.heads;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int v = (warp % (VECS / GROUP_VECS)) * GROUP_VECS + lane % GROUP_VECS;
  const int pair = (warp / (VECS / GROUP_VECS)) * WARP_GROUPS + lane / GROUP_VECS;
  const bool active = pair < p.th * p.cg;
  const int i = tile_r * p.th + pair / p.cg;             // output row
  const int j0 = P * (tile_c * p.cg + pair % p.cg);      // first output column
  const bool live = active && i < p.Ho;

  const __nv_bfloat16* src = qkv + (long long)b * p.T * p.H * p.W * p.ld + h * D + v * 8;
  __nv_bfloat16* dst = out + (long long)bh * p.T * p.Ho * p.Wo * D + v * 8;
  float* red_row[2] = {red[0][pair * P], red[1][pair * P]};
  const float inv_d = 1.0f / D;
  const int t0 = chunk * p.tc, t1 = min(t0 + p.tc, p.T);

  // The tap m of the input row s*i - 1 + dr of frame f, or null in the padding.
  auto tap = [&](int f, int dr, int m) -> const __nv_bfloat16* {
    const int row = S * i - 1 + dr, col = S * j0 - 1 + C::of(m);
    if (row < 0 || row >= p.H || col < 0 || col >= p.W) return nullptr;
    return src + (((long long)f * p.H + row) * p.W + col) * p.ld;
  };
  // Whether this thread reads the input frame f.
  auto reads = [&](int f) { return f >= 0 && f < p.T && f <= t1 && live; };
  // This thread's slots for frame f: tap (dr, m) at [(dr * C::N + m) * blockDim.x].
  auto slots = [&](int f) { return staged + (f & 1) * 3 * C::N * blockDim.x + threadIdx.x; };
  auto stage = [&](int f) {
    if (reads(f)) {
      uint4* s = slots(f);
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int m = 0; m < C::N; ++m) {
          const __nv_bfloat16* a = tap(f, dr, m);
          cp_async16(s + (dr * C::N + m) * blockDim.x, a != nullptr ? a : src,
                     a != nullptr ? 16 : 0);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // acc[0] sums the output frame f - 1 of the input frame f being read,
  // acc[1] the frame f, acc[2] the frame f + 1.
  float acc[3][P][8];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[a][q][e] = 0.0f;
  auto sum_row = [&](int dr, const uint4* x) {
#pragma unroll
    for (int dc = 0; dc < 3; ++dc) {
      float w[3][8];
#pragma unroll
      for (int kt = 0; kt < 3; ++kt) {
        const int k = kt * 9 + dr * 3 + dc;
        const float4 lo = wlo[k][v], hi = whi[k][v];
        w[kt][0] = lo.x; w[kt][1] = lo.y; w[kt][2] = lo.z; w[kt][3] = lo.w;
        w[kt][4] = hi.x; w[kt][5] = hi.y; w[kt][6] = hi.z; w[kt][7] = hi.w;
      }
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float xf[8];
        unpack(x[C::index(q, dc)], xf);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc[0][q][e] = fmaf(w[2][e], xf[e], acc[0][q][e]);
          acc[1][q][e] = fmaf(w[1][e], xf[e], acc[1][q][e]);
          acc[2][q][e] = fmaf(w[0][e], xf[e], acc[2][q][e]);
        }
      }
    }
  };
  __syncthreads();

  stage(t0 - 1);
  for (int f = t0 - 1; f <= t1; ++f) {
    stage(f + 1);
    asm volatile("cp.async.wait_group 1;\n" ::);   // this thread's copies of frame f
    if (reads(f)) {
      const uint4* s = slots(f);
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
        uint4 x[C::N];
#pragma unroll
        for (int m = 0; m < C::N; ++m) x[m] = s[(dr * C::N + m) * blockDim.x];
        sum_row(dr, x);
      }
    }
    if (f - 1 >= t0) {   // the output frame f - 1 has all its taps
      const int t = f - 1;
      float mean[P], rstd[P];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s += acc[0][q][e];
        if (active) red_row[0][q * VECS + v] = s;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float s = 0.0f;
        if (active) {
          const float4* r = reinterpret_cast<const float4*>(red_row[0] + q * VECS);
#pragma unroll
          for (int u = 0; u < VECS / 4; ++u) s += (r[u].x + r[u].y) + (r[u].z + r[u].w);
        }
        mean[q] = s * inv_d;
        float s2 = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float dv = acc[0][q][e] - mean[q];
          s2 = fmaf(dv, dv, s2);
        }
        if (active) red_row[1][q * VECS + v] = s2;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float s = 0.0f;
        if (active) {
          const float4* r = reinterpret_cast<const float4*>(red_row[1] + q * VECS);
#pragma unroll
          for (int u = 0; u < VECS / 4; ++u) s += (r[u].x + r[u].y) + (r[u].z + r[u].w);
        }
        rstd[q] = rsqrtf(s * inv_d + p.eps);
      }
      if (live) {
        const float4* g = reinterpret_cast<const float4*>(gamma) + 2 * v;
        const float4* bb = reinterpret_cast<const float4*>(beta) + 2 * v;
        const float gw[8] = {g[0].x, g[0].y, g[0].z, g[0].w, g[1].x, g[1].y, g[1].z, g[1].w};
        const float bw[8] = {bb[0].x, bb[0].y, bb[0].z, bb[0].w,
                             bb[1].x, bb[1].y, bb[1].z, bb[1].w};
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const int j = j0 + q;
          if (j >= p.Wo) continue;
          float y[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) y[e] = (acc[0][q][e] - mean[q]) * rstd[q] * gw[e] + bw[e];
          const uint4 o = make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]), pack2(y[4], y[5]),
                                     pack2(y[6], y[7]));
          *reinterpret_cast<uint4*>(dst + (((long long)t * p.Ho + i) * p.Wo + j) * D) = o;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc[0][q][e] = acc[1][q][e];
        acc[1][q][e] = acc[2][q][e];
        acc[2][q][e] = 0.0f;
      }
  }
}

// The largest divisor of n that is at most cap.
int divisor_at_most(int n, int cap) {
  for (int k = cap < n ? cap : n; k > 1; --k)
    if (n % k == 0) return k;
  return 1;
}

template <int S>
int launch(const void* qkv, const void* w, const void* nw, const void* nb, int wbf16,
           void* out, const Pool& p, int blocks, int threads, cudaStream_t stream) {
  // The staged taps: 110.6 KB at s >= 4 with 192 threads, beside 14 KB static.
  const int smem = 2 * 3 * Cols<S>::N * threads * static_cast<int>(sizeof(uint4));
  const cudaError_t e = cudaFuncSetAttribute(attn_pool_kernel<S>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_pool_kernel<S><<<blocks, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), w, nw, nb, wbf16,
      static_cast<__nv_bfloat16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: [B, T*H*W, ld] bf16, 16-byte aligned, ld and offset multiples of 8;
// the part's heads at channels offset + h*96. weight: [96, 1, 3, 3, 3],
// norm_w and norm_b: [96], all float32 (wdtype 0) or all bf16 (wdtype 1).
// out: [B, heads, T, Ho, Wo, 96] bf16, Ho = (H - 1) / s + 1, Wo likewise.
extern "C" int step_attn_pool(const void* qkv, long long ld, long long offset,
                              const void* weight, const void* norm_w, const void* norm_b,
                              int wdtype, float eps, void* out, int B, int heads, int T,
                              int H, int W, int s, void* stream) {
  if (B < 0 || heads < 1 || T < 0 || H < 0 || W < 0 || (wdtype != 0 && wdtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (s != 1 && s != 2 && s != 4 && s != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (ld % 8 || offset % 8 || offset + (long long)heads * D > ld ||
      reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * T * H * W == 0) return 0;
  Pool p{};
  p.ld = ld;
  p.T = T; p.H = H; p.W = W;
  p.Ho = (H - 1) / s + 1;
  p.Wo = (W - 1) / s + 1;
  p.heads = heads;
  p.eps = eps;
  // A tile: cg output pairs of a row (4 where the row's pairs split in 4s,
  // else the row's pairs or their largest divisor up to 8) by th rows (as
  // many as MAX_PAIRS allows, spread evenly over the row tiles).
  const int gw = (p.Wo + P - 1) / P;
  p.cg = gw % 4 == 0 ? 4 : divisor_at_most(gw, 8);
  p.th = std::min(p.Ho, std::max(1, MAX_PAIRS / p.cg));
  p.row_tiles = (p.Ho + p.th - 1) / p.th;
  p.th = (p.Ho + p.row_tiles - 1) / p.row_tiles;
  p.col_tiles = (gw + p.cg - 1) / p.cg;
  const int pairs = (p.th * p.cg + WARP_GROUPS - 1) / WARP_GROUPS * WARP_GROUPS;
  const int threads = pairs / WARP_GROUPS * (VECS / GROUP_VECS) * 32;
  // Frames split over blocks only where the tiles alone give too few blocks
  // for two waves; each chunk reads one halo frame at each end.
  const long long tiles = static_cast<long long>(B) * heads * p.row_tiles * p.col_tiles;
  const long long want = 2LL * step::sm_count();
  const int split = tiles >= want
                        ? 1
                        : static_cast<int>(std::min<long long>(T, (want + tiles - 1) / tiles));
  p.tc = (T + split - 1) / split;
  p.chunks = (T + p.tc - 1) / p.tc;
  const long long blocks = tiles * p.chunks;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* base = static_cast<const __nv_bfloat16*>(qkv) + offset;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(blocks);
  switch (s) {
    case 1: return launch<1>(base, weight, norm_w, norm_b, wdtype, out, p, n, threads, st);
    case 2: return launch<2>(base, weight, norm_w, norm_b, wdtype, out, p, n, threads, st);
    case 4: return launch<4>(base, weight, norm_w, norm_b, wdtype, out, p, n, threads, st);
    default: return launch<8>(base, weight, norm_w, norm_b, wdtype, out, p, n, threads, st);
  }
}
