// The I3D stem unit's convolution, Conv3d_1a_7x7, for Hopper (sm_90a): a
// 7x7x7 convolution over 2 or 3 input channels to 64, stride 2 on T, H and
// W, TF-SAME zero padding, with the unit's affine and ReLU in its epilogue:
//
//     out = relu?(conv3d_SAME(x, w, stride (2, 2, 2)) * scale? + bias?)
//
// It replaces no Pallas kernel: the JAX package recasts this convolution
// for the TPU's matrix unit as a space-to-depth convolution that XLA runs
// (step_tpu/ops/stem_conv.py::space_to_depth_conv3d); this is its Hopper
// counterpart. In the port it runs every inference stem unit of a bf16
// CUDA tensor (models/i3d.py::Unit3D, through ops/stem_conv.py); the plain
// PyTorch version is ops/stem_conv.py::stem_conv_plain. Before it, cuDNN
// ran the bf16 stem as a transpose to NCDHW and a float32 CUDA-core
// implicit GEMM, after an F.pad copy of the clip and before a ReLU pass.
//
// What bounds it on the card: arithmetic. A B=32 request of 18 frames at
// 224 px has 32 x 9 x 112 x 112 = 3.61 M output positions, each 64
// channels of 343 x 3 products: 475.8 GFLOP, 0.48 ms at 989 TFLOP/s bf16,
// against 636 MB of bf16 input and output (0.19 ms at 3.35 TB/s).
//
// What makes it hard is feeding the tensor cores the A operand. A pixel is
// 3 bf16 values (6 bytes), so no tap of the input is 16-byte aligned, and
// each input value feeds ~43 products (343 taps over the 8 of a 2x2x2
// stride). So the input is read once per output tile into shared memory
// and A is built from there in registers:
//   * the reduction is laid out by row segments: for each of the 49 (dt,
//     dh) pairs, the 7 dw taps x C channels are 7C contiguous values of an
//     input row in NDHWC order, padded to a multiple of 8 (24 for C = 3, 16
//     for C = 2). R = 49 x 24 = 1,176 (space-to-depth, the JAX package's
//     regrouping, needs 7 x 4 x 4 x 12 = 1,344 with 23% zero taps). So a
//     pair of A's values (one 32-bit register of a wgmma A fragment) is one
//     aligned 32-bit shared-memory load from the input patch, at an offset
//     from the thread's output position that is known at compile time: the
//     k loop is unrolled and every load carries its offset as an immediate;
//   * a block holds the whole packed weight in shared memory (152 KB for C
//     = 3, read once per block) and walks output tiles of 8 x 16 positions
//     of one (n, t') as a persistent block: a producer warpgroup stages the
//     tile's input patch (7 frames x 21 rows x 38 pixels, zero where SAME
//     padding or the tensor's edge cuts it) into one of two buffers, as
//     4-byte cp.async copies all in flight at once (2-byte loads where a
//     row starts at an odd element: C = 3 with W odd), while two consumer
//     warpgroups run the previous tile; named barriers hand the buffers
//     back and forth. Copies, not loads through registers: staged with
//     2-byte loads, eight rows in flight, the producer held the kernel to
//     1.90 ms at the served shape, against 1.26 with the copies;
//   * each consumer warpgroup computes 64 positions (4 output rows of 16)
//     by 64 channels: per k16 step four 32-bit loads a thread and one
//     wgmma.mma_async m64n64k16 with A from registers and B from the
//     shared weight (bf16 x bf16 into float32 registers), two steps a
//     commit group, the next group's A loaded while the tensor cores run
//     this one. A warp's lanes read 8 neighbouring positions 3 words apart
//     (C = 3) and 4 consecutive words each, so its 32 loads fall in 25
//     distinct words: no bank conflict. Each m64n64k16 reads 2 KB of B and
//     2 KB of A from shared memory for 32 tensor-core cycles of the SM:
//     all of shared memory's 128 bytes a cycle, so the two are matched and
//     latency decides (1.13 ms at the served shape with no patch staged);
//   * the epilogue applies the scale, bias and ReLU in float32, rounds once
//     to bf16 and writes the tile channels-last, 64 channels a position.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KOUT = 64;          // output channels: one wgmma width
constexpr int TAPS = 7;           // kernel extent on each axis
constexpr int TILE_H = 8;         // output rows of a block's tile
constexpr int TILE_W = 16;        // output columns of a block's tile
constexpr int PATCH_H = 2 * (TILE_H - 1) + TAPS;      // 21 input rows
// 37 input pixels cover a row of 16 outputs; one more holds the padded tail
// of the last segment (values that the kernel masks to zero).
constexpr int PATCH_W = 2 * (TILE_W - 1) + TAPS + 1;  // 38
constexpr int CONSUMERS = 2;      // consumer warpgroups, 4 output rows each
constexpr int GROUP_STEPS = 2;    // k16 steps a wgmma commit group (3 and 4: no faster)
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int MAX_SMEM = 232448;
// Named barriers (0 is __syncthreads): a buffer full, a buffer empty.
constexpr int BAR_FULL = 1, BAR_EMPTY = 3;
static_assert(CONSUMERS * 4 == TILE_H, "a consumer warp computes one output row");

template <int C>
struct Geometry {
  static constexpr int SEG = (TAPS * C + 7) / 8 * 8;   // a (dt, dh) segment: 24 or 16
  static constexpr int GROUPS = SEG / 8;               // 8-value groups a segment
  static constexpr int HALVES = TAPS * TAPS * GROUPS;  // 8-wide halves of k16 steps
  static constexpr int STEPS = (HALVES + 1) / 2;       // wgmma k16 steps: 74 or 49
  static constexpr int CHUNKS = (TAPS * TAPS * SEG + 63) / 64;  // 128-byte weight rows
  static constexpr int RPAD = CHUNKS * 64;             // packed weight row: 1216 or 832
  static constexpr int PWC = PATCH_W * C;              // values in a patch row
  static constexpr int PATCH_VALUES = TAPS * PATCH_H * PWC;
  static constexpr int PATCH_BYTES = (PATCH_VALUES * 2 + 127) / 128 * 128;
  static constexpr int B_BYTES = CHUNKS * KOUT * 128;
  static constexpr int SMEM = 1024 + B_BYTES + 2 * PATCH_BYTES;
  static_assert(SMEM <= MAX_SMEM, "the weight and two patches exceed shared memory");
  static_assert(PWC % 2 == 0, "patch rows must keep 32-bit pairs aligned");
};

__device__ __forceinline__ uint32_t swizzle128(int r, int j) {
  return static_cast<uint32_t>(r * 128 + ((j ^ (r & 7)) << 4));
}

// A wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle (8-row groups 1024 bytes apart), as csrc/conv3d.cu builds it.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(16 >> 4) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(THREADS) : "memory");
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
// Keep registers that an asynchronous wgmma reads or writes in place
// across its issue, commit and wait (the compiler does not see them used).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

// d[64 x 64] += A[64 x 16] * B[16 x 64] for one warpgroup: A from this
// thread's four registers (the m16n8k16 A fragment of its warp's 16 rows),
// B through a shared-memory descriptor.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The A fragment of k16 step k for the two rows this thread holds: p0 and
// p1 point at (in 32-bit words) the patch value of this thread's column
// pair at reduction index 0 for its rows g and g + 8. Half h of the step
// (columns 8h .. 8h + 7) is 8-value group gg of segment s = (dt, dh); its
// offset is a compile-time constant once the k loop is unrolled. The pad of
// the last group of a segment is masked to zero (`mask`), and a half past
// the 49 segments is zero.
template <int C>
__device__ __forceinline__ void load_step(uint32_t (&a)[4], const uint32_t* p0,
                                          const uint32_t* p1, int k, uint32_t mask) {
  using G = Geometry<C>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = 2 * k + h;
    if (u < G::HALVES) {
      const int s = u / G::GROUPS, gg = u % G::GROUPS;
      const int dt = s / TAPS, dh = s % TAPS;
      const int word = ((dt * PATCH_H + dh) * G::PWC + 8 * gg) / 2;
      uint32_t v0 = p0[word], v1 = p1[word];
      if (gg == G::GROUPS - 1) {
        v0 &= mask;
        v1 &= mask;
      }
      a[2 * h] = v0;
      a[2 * h + 1] = v1;
    } else {
      a[2 * h] = 0u;
      a[2 * h + 1] = 0u;
    }
  }
}

// The tile's input patch, [7 frames][21 rows][38 pixels x C] bf16, from
// x [N, T, H, W, C] at input origin (t_in0, h_in0, w_in0): zero outside
// the tensor. 128 producer threads, a warp a row. Where every patch row
// starts at an even element of x (W C and w_in0 C even, x 4-byte
// aligned: every C = 2 input, and C = 3 with W even), the rows go as
// 4-byte cp.async copies, zero-filled outside x, all in flight at once
// (load_patch_pairs); else as 2-byte loads, eight rows in flight.
template <int C>
__device__ __forceinline__ void load_patch_pairs(const uint16_t* __restrict__ x, uint32_t patch,
                                                 int n, int t_in0, int h_in0, int w_in0, int T,
                                                 int H, int W, int ptid) {
  using G = Geometry<C>;
  constexpr int ROWS = TAPS * PATCH_H;
  constexpr int PAIRS = G::PWC / 2;
  const int warp = ptid >> 5, lane = ptid & 31;
  const int64_t WC = static_cast<int64_t>(W) * C;
  for (int row = warp; row < ROWS; row += 4) {
    const int f = row / PATCH_H, rr = row - f * PATCH_H;
    const int t = t_in0 + f, h = h_in0 + rr;
    const bool row_ok = t >= 0 && t < T && h >= 0 && h < H;
    const uint16_t* src =
        x + ((static_cast<int64_t>(n) * T + (row_ok ? t : 0)) * H + (row_ok ? h : 0)) * WC;
#pragma unroll
    for (int j = lane; j < PAIRS; j += 32) {
      const int64_t col = static_cast<int64_t>(w_in0) * C + 2 * j;
      const bool ok = row_ok && col >= 0 && col < WC;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(patch + 2 * (row * G::PWC + 2 * j)), "l"(ok ? src + col : x),
                      "r"(ok ? 4 : 0) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int C>
__device__ __forceinline__ void load_patch(const uint16_t* __restrict__ x, uint16_t* patch,
                                           int n, int t_in0, int h_in0, int w_in0, int T,
                                           int H, int W, int ptid) {
  using G = Geometry<C>;
  constexpr int ROWS = TAPS * PATCH_H;
  constexpr int NCOL = (G::PWC + 31) / 32;
  constexpr int RB = 8;
  const int warp = ptid >> 5, lane = ptid & 31;
  const int64_t WC = static_cast<int64_t>(W) * C;
  int64_t col[NCOL];
  bool col_ok[NCOL];
#pragma unroll
  for (int i = 0; i < NCOL; ++i) {
    const int e = lane + 32 * i;
    col[i] = static_cast<int64_t>(w_in0) * C + e;
    col_ok[i] = e < G::PWC && col[i] >= 0 && col[i] < WC;
  }
  for (int r0 = warp; r0 < ROWS; r0 += 4 * RB) {
    uint16_t v[RB][NCOL];
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int row = r0 + 4 * b;
      const int f = row / PATCH_H, rr = row - f * PATCH_H;
      const int t = t_in0 + f, h = h_in0 + rr;
      const bool ok = row < ROWS && t >= 0 && t < T && h >= 0 && h < H;
      const uint16_t* src =
          x + ((static_cast<int64_t>(n) * T + (ok ? t : 0)) * H + (ok ? h : 0)) * WC;
#pragma unroll
      for (int i = 0; i < NCOL; ++i) v[b][i] = ok && col_ok[i] ? __ldg(src + col[i]) : 0;
    }
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int row = r0 + 4 * b;
      if (row >= ROWS) continue;
#pragma unroll
      for (int i = 0; i < NCOL; ++i) {
        const int e = lane + 32 * i;
        if (e < G::PWC) patch[row * G::PWC + e] = v[b][i];
      }
    }
  }
}

template <int C, bool kPairs>
__global__ void __launch_bounds__(THREADS, 1)
stem_conv_kernel(const uint16_t* __restrict__ x,           // [N, T, H, W, C] bf16
                 const __nv_bfloat16* __restrict__ w,      // [64, RPAD] packed
                 const float* __restrict__ scale,          // [64] or null
                 const float* __restrict__ bias,           // [64] or null
                 __nv_bfloat16* __restrict__ out,          // [N, To, Ho, Wo, 64]
                 int T, int H, int W, int To, int Ho, int Wo, int pad_t, int pad_h,
                 int pad_w, int tiles_w, int tiles_h, int tiles, int relu) {
  using G = Geometry<C>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t b_smem = base;                          // [CHUNKS][64][128 B] swizzled
  uint16_t* const patches = reinterpret_cast<uint16_t*>(smem + G::B_BYTES);
  const int tid = threadIdx.x;

  // The packed weight, once: chunk c of row o is its reduction values
  // 64c .. 64c + 63, in csrc/conv3d.cu's swizzled K-major layout.
  for (int v = tid; v < G::CHUNKS * KOUT * 8; v += THREADS) {
    const int c = v / (KOUT * 8), rem = v - c * (KOUT * 8);
    const int row = rem >> 3, j = rem & 7;
    cp_async16(b_smem + c * (KOUT * 128) + swizzle128(row, j),
               w + static_cast<int64_t>(row) * G::RPAD + 64 * c + 8 * j);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int my_tiles = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int wg = tid >> 7;
  auto decode = [&](int i, int& n, int& to, int& h0, int& w0) {
    int tile = blockIdx.x + i * gridDim.x;
    w0 = (tile % tiles_w) * TILE_W;
    tile /= tiles_w;
    h0 = (tile % tiles_h) * TILE_H;
    tile /= tiles_h;
    to = tile % To;
    n = tile / To;
  };

  if (wg == CONSUMERS) {
    // Producer: stage each tile's patch, two buffers ahead.
    for (int i = 0; i < my_tiles; ++i) {
      const int buf = i & 1;
      if (i >= 2) bar_sync(BAR_EMPTY + buf);
      int n, to, h0, w0;
      decode(i, n, to, h0, w0);
      if (kPairs)
        load_patch_pairs<C>(x, base + G::B_BYTES + buf * G::PATCH_BYTES, n, 2 * to - pad_t,
                            2 * h0 - pad_h, 2 * w0 - pad_w, T, H, W, tid - 128 * CONSUMERS);
      else
        load_patch<C>(x, patches + buf * (G::PATCH_BYTES / 2), n, 2 * to - pad_t,
                      2 * h0 - pad_h, 2 * w0 - pad_w, T, H, W, tid - 128 * CONSUMERS);
      bar_arrive(BAR_FULL + buf);
    }
    return;
  }

  // Consumer warpgroup wg: output rows 4 wg .. 4 wg + 3 of the tile, a warp
  // a row; lane (g, q) holds positions g and g + 8 of that row.
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int row = 4 * wg + warp;
  // Of the last 8-value group of a segment only the first 7C - 8(GROUPS-1)
  // values are taps: 5 for C = 3 (a q = 2 pair keeps its low half), 6 for
  // C = 2.
  constexpr int LAST = TAPS * C - 8 * (G::GROUPS - 1);
  const uint32_t mask = 2 * q + 2 <= LAST ? 0xFFFFFFFFu : 2 * q + 1 == LAST ? 0x0000FFFFu : 0u;
  float sc[16], bi[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * (i >> 1) + 2 * q + (i & 1);
    sc[i] = scale ? scale[col] : 1.f;
    bi[i] = bias ? bias[col] : 0.f;
  }

  for (int i = 0; i < my_tiles; ++i) {
    const int buf = i & 1;
    int n, to, h0, w0;
    decode(i, n, to, h0, w0);
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    bar_sync(BAR_FULL + buf);
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(patches + buf * (G::PATCH_BYTES / 2)) +
                         row * G::PWC + g * C + q;
    const uint32_t* p1 = p0 + 8 * C;
    constexpr int GROUPS_K = (G::STEPS + GROUP_STEPS - 1) / GROUP_STEPS;
    uint32_t a[2][GROUP_STEPS][4];
#pragma unroll
    for (int s = 0; s < GROUP_STEPS; ++s) load_step<C>(a[0][s], p0, p1, s, mask);
#pragma unroll
    for (int grp = 0; grp < GROUPS_K; ++grp) {
      const int cur = grp & 1;
#pragma unroll
      for (int s = 0; s < GROUP_STEPS; ++s) fence_regs(a[cur][s]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < GROUP_STEPS; ++s) {
        const int k = GROUP_STEPS * grp + s;
        if (k < G::STEPS)
          wgmma_rs(acc, a[cur][s], smem_desc(b_smem + (k >> 2) * (KOUT * 128) + 32 * (k & 3)));
      }
      wgmma_commit();
      if (grp + 1 < GROUPS_K) {
        // The previous group has finished reading its registers.
        wgmma_wait<1>();
#pragma unroll
        for (int s = 0; s < GROUP_STEPS; ++s) {
          fence_regs(a[cur ^ 1][s]);
          load_step<C>(a[cur ^ 1][s], p0, p1, GROUP_STEPS * (grp + 1) + s, mask);
        }
      }
    }
    // Every load from this buffer has landed in a register: hand it back
    // (not for the last two tiles, which the producer does not refill).
    if (i + 2 < my_tiles) bar_arrive(BAR_EMPTY + buf);
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int s = 0; s < GROUP_STEPS; ++s) {
      fence_regs(a[0][s]);
      fence_regs(a[1][s]);
    }

    // Epilogue: acc[4 cg + 2 half + e] is row g + 8 half of this warp's
    // row, column 8 cg + 2 q + e.
    const int ho = h0 + row;
    if (ho >= Ho) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int wo = w0 + g + 8 * half;
      if (wo >= Wo) continue;
      __nv_bfloat16* dst =
          out + (((static_cast<int64_t>(n) * To + to) * Ho + ho) * Wo + wo) * KOUT + 2 * q;
#pragma unroll
      for (int cg = 0; cg < 8; ++cg) {
        float y0 = acc[4 * cg + 2 * half] * sc[2 * cg] + bi[2 * cg];
        float y1 = acc[4 * cg + 2 * half + 1] * sc[2 * cg + 1] + bi[2 * cg + 1];
        if (relu) {
          y0 = y0 < 0.f ? 0.f : y0;
          y1 = y1 < 0.f ? 0.f : y1;
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * cg) = __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

// TF-SAME padding before an axis of n for the 7-tap, stride-2 window (the
// odd cell goes after): ops/pool.py::same_pads.
int pad_before(int n) {
  const int total = ((n + 1) / 2 - 1) * 2 + TAPS - n;
  return total > 0 ? total / 2 : 0;
}

template <int C>
int launch(const void* x, const void* w, const float* scale, const float* bias, void* out,
           int N, int T, int H, int W, int relu, cudaStream_t stream) {
  using G = Geometry<C>;
  const int To = (T + 1) / 2, Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int tiles_w = (Wo + TILE_W - 1) / TILE_W, tiles_h = (Ho + TILE_H - 1) / TILE_H;
  const int64_t tiles = static_cast<int64_t>(N) * To * tiles_h * tiles_w;
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  const int pad_w = pad_before(W);
  const bool pairs = (static_cast<int64_t>(W) * C) % 2 == 0 && (pad_w * C) % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 4 == 0;
  auto kernel = pairs ? stem_conv_kernel<C, true> : stem_conv_kernel<C, false>;
  // Above 48 KB of dynamic shared memory a kernel must be allowed it, once
  // per device.
  static bool allowed[2][64] = {};
  if (!allowed[pairs][device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[pairs][device] = true;
  }
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<blocks, THREADS, G::SMEM, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const __nv_bfloat16*>(w), scale, bias,
      static_cast<__nv_bfloat16*>(out), T, H, W, To, Ho, Wo, pad_before(T), pad_before(H),
      pad_w, tiles_w, tiles_h, static_cast<int>(tiles), relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [N, T, H, W, C] bf16, contiguous, C 2 or 3; w: the packed [64, Rpad]
// bf16 weight of ops/stem_conv.py::pack_stem_weight (Rpad 1216 for C = 3,
// 832 for C = 2), 16-byte aligned; scale, bias: [64] float32 or null (1
// and 0); out: [N, ceil(T/2), ceil(H/2), ceil(W/2), 64] bf16, contiguous,
// 4-byte aligned. relu != 0 applies the ReLU.
extern "C" int step_stem_conv(const void* x, const void* w, const float* scale,
                              const float* bias, void* out, int N, int T, int H, int W,
                              int C, int relu, void* stream) {
  if (N < 0 || T < 0 || H < 0 || W < 0 || (C != 2 && C != 3) ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 3) return launch<3>(x, w, scale, bias, out, N, T, H, W, relu, s);
  return launch<2>(x, w, scale, bias, out, N, T, H, W, relu, s);
}
