// Batched greedy NMS for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel step_tpu/ops/nms_pallas.py::_nms_kernel
// (pallas_call at :109), reached through nms_many from
// step_tpu/inference.py::nms_surface. The plain PyTorch versions are
// step_tpu_torch/ops/nms.py::nms_many_plain and
// step_tpu_torch/inference.py::nms_surface_plain; this kernel must equal
// them bit for bit.
//
// The problems come in groups that share their boxes: G groups of P boxes,
// each scored by C rows. nms_surface is G = B*T frames of C classes, read
// through strides from tubes [B,P,T,4], scores [B,P,C] and the proposal
// mask [B,P], with no expanded copies, and it writes the kept boxes, scores
// and mask itself. nms_many is N groups with C = 1.
//
// What bounds it on the card: not bytes (a B=8 surface reads ~50 KB and
// writes ~1.3 MB, 0.4 us of HBM time) but latency and, with 32 warps on an
// SM, instruction issue. Each problem is a chain of K dependent greedy
// steps, and the design takes all it can out of it:
//   1. per group (a block; up to P = 128 a group's C problems are split
//      over blocks of up to 8 warps, one problem a warp), in parallel: the
//      P x P suppression bits sup[i] = {j : iou(i, j) > thr} in shared
//      memory, ceil(P/32) words a row. Every division and all float work
//      happen here, once for the block's problems.
//   2. per problem (a warp): the premask of ops/nms.py::premask_scores and
//      each box's place in the greedy order (score descending, ties to the
//      lower index) as a key, rank << 10 | box.
//   3. the chain, one step per kept box, in bit operations. For P <= 32 a
//      lane holds the box of one rank and its row of sup permuted into rank
//      order; a step takes the lowest alive rank and clears that row with
//      one shuffle. Beyond, a lane holds S = 2, 4 ... 32 boxes (lane * S +
//      s), a step takes the least key among the alive boxes (one
//      __reduce_min_sync) and clears alive &= ~sup[idx] & ~bit(idx) with
//      one shared-memory word; so P <= 32 * 32.
// A problem freezes when no alive box scores above NEG/2: the slot takes
// mask 0 and the lowest index of the maximum of the current live array
// (alive boxes at their score, removed ones at NEG), as the Pallas kernel
// leaves it, and so does every later slot.
//
// Bit-exactness: the IoU is the Pallas kernel's expression in its order
// (the chosen box first; nms_pallas.py:60-64), with __f*_rn ops, which
// nvcc never contracts into FMAs (the library is also built with
// -fmad=false), and a min and max that propagate NaN as jnp.minimum and
// jnp.maximum do (PTX min.NaN / max.NaN): a box with a NaN coordinate has
// a NaN IoU, which suppresses nothing. The box area is (x2-x1)*(y2-y1)
// with no clamp, as in the Pallas kernel (:47).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr float kEps = 1e-8f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBoxes = 1024;  // keys hold the box in 10 bits; kernels.NMS_MAX_BOXES

struct NmsArgs {
  const float* boxes;   // [G, P, 4] by strides bs*; coordinates contiguous
  const void* scores;   // [G, P, C] by strides ss*, float32 or bfloat16
  const void* valid;    // [G, P] by strides vs*, float32 or bool, or null
  int32_t* keep_idx;    // [G, C, K], or null
  float* keep_mask;     // [G, C, K]
  float* out_boxes;     // [G, C, K, 4], or null: the kept boxes
  float* out_scores;    // [G, C, K], or null: kept score x mask
  int score_bf16, valid_kind;  // valid_kind: 0 none, 1 float32, 2 bool
  int G2, P, C, K;             // group g is (g / G2, g % G2)
  long long bs0, bs1, bs2, ss0, ss1, ss2, ss3, vs0, vs1, vs2;
  float iou_thr, score_thr;
};

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float load_score(const NmsArgs& a, long long off) {
  if (a.score_bf16) {
    const unsigned short bits =
        __ldg(static_cast<const unsigned short*>(a.scores) + off);
    return __uint_as_float(static_cast<uint32_t>(bits) << 16);
  }
  return __ldg(static_cast<const float*>(a.scores) + off);
}

// The IoU of c, the chosen box, and o as the Pallas kernel computes it, up
// to its division: the intersection and the union floored at EPS (ac and
// ao are the areas).
__device__ __forceinline__ void overlap(float4 c, float4 o, float ac, float ao,
                                        float& inter, float& uni) {
  const float w = max_nan(__fsub_rn(min_nan(c.z, o.z), max_nan(c.x, o.x)), 0.f);
  const float h = max_nan(__fsub_rn(min_nan(c.w, o.w), max_nan(c.y, o.y)), 0.f);
  inter = __fmul_rn(w, h);
  uni = max_nan(__fsub_rn(__fadd_rn(ac, ao), inter), kEps);
}

// inter / uni > thr. 0 / uni is 0 or NaN: the division takes 1 / uni there
// instead, since a zero numerator sends __fdiv_rn down its slow path.
__device__ __forceinline__ bool iou_above(float inter, float uni, float thr) {
  const float q = __fdiv_rn(inter == 0.f ? 1.f : inter, uni);
  return (inter == 0.f ? (uni != uni ? uni : inter) : q) > thr;
}

// Up to P = 16 a warp takes two problems, one a half; beyond, one. A
// problem's lanes are hl = 0 .. W-1 of its part of the warp.
__host__ __device__ constexpr int halves_of(int S, int L) {
  return S == 1 && L == 16 ? 2 : 1;
}

// The problem's live scores go into `live`: NEG unless the box is valid and
// its score is above the threshold (ops/nms.py::premask_scores), and NEG
// throughout for a part of a warp that has no problem. The raw scores go to
// `raw`, for the kept boxes' scores.
template <int W>
__device__ __forceinline__ void load_live(const NmsArgs& a, long long gs,
                                          long long gv, int c, bool active,
                                          float* live, float* raw, int hl) {
  for (int p = hl; p < a.P; p += W) {
    bool ok = active;
    if (active && a.valid_kind == 1)
      ok = __ldg(static_cast<const float*>(a.valid) + gv + p * a.vs2) > 0.f;
    else if (active && a.valid_kind == 2)
      ok = __ldg(static_cast<const unsigned char*>(a.valid) + gv + p * a.vs2) != 0;
    const float s = active ? load_score(a, gs + p * a.ss2 + c * a.ss3) : 0.f;
    raw[p] = s;
    live[p] = ok && s > a.score_thr ? s : kNeg;
  }
}

// Each of the lane's boxes p = hl * S + s gets its key: the number of boxes
// ahead of it in the greedy order (live scores hold no NaN), shifted over
// the box index. `alive` marks the lane's real boxes; `nsel` is the
// problem's count of boxes above NEG/2, which hold the ranks 0 .. nsel-1.
template <int S, int L>
__device__ __forceinline__ void rank_boxes(const float* live, int P, int hl, int half,
                                           uint32_t (&key)[S], uint32_t& alive,
                                           int& nsel) {
  float v[S];
  int mine = 0;
  alive = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int p = hl * S + s;
    v[s] = p < P ? live[p] : 0.f;
    key[s] = 0;
    if (p < P) {
      alive |= 1u << s;
      mine += v[s] > kNeg * 0.5f;
    }
  }
  if constexpr (S == 1) {
#pragma unroll
    for (int j = 0; j < L; ++j) {  // -inf past P: ahead of no box
      const float u = j < P ? live[j] : -INFINITY;
      key[0] += j < hl ? u >= v[0] : u > v[0];
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < P; ++j) {
      const float u = live[j];
#pragma unroll
      for (int s = 0; s < S; ++s)
        key[s] += (u > v[s]) | ((u == v[s]) & (j < hl * S + s));
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) key[s] = key[s] << 10 | (hl * S + s);
  if constexpr (S == 1) {
    constexpr int W = 32 / halves_of(S, L);
    const uint32_t votes = __ballot_sync(kFull, mine) >> (half * W);
    nsel = __popc(W == 32 ? votes : votes & ((1u << W) - 1u));
  } else {
    nsel = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(mine)));
  }
}

// The greedy chain of problem (g, c), on its part of the warp, and its K
// slots written out if `active`.
template <int S, int L>
__device__ __forceinline__ void solve(const NmsArgs& a, int g, int c, bool active,
                                      const float4* box, const uint32_t* sup,
                                      const float* live, const float* raw,
                                      uint16_t* kept, const uint32_t (&key)[S],
                                      uint32_t alive, int nsel, int hl) {
  constexpr int H = halves_of(S, L), W = 32 / H;
  int nk = 0;
  if constexpr (S == 1) {
    // P <= 32: the chain in rank space. Lane r holds the box of rank r and
    // its row of sup over ranks (its own bit set: the knockout). A step
    // keeps the lowest alive rank, if it is one of the nsel above NEG/2,
    // and clears that rank's row, which one shuffle brings. The kept ranks
    // rise step by step, so a mask of them keeps their order.
    const int rank = static_cast<int>(key[0] >> 10);
    if (hl < a.P) kept[rank] = static_cast<uint16_t>(hl);
    __syncwarp();
    const int b = hl < a.P ? kept[hl] : 0;
    __syncwarp();
    const uint32_t row = hl < a.P ? sup[b] : 0u;
    uint32_t rrow = 1u << hl;
#pragma unroll
    for (int q = 0; q < L; ++q)  // bits past P are never alive
      rrow |= ((row >> __shfl_sync(kFull, b, q, W)) & 1u) << q;
    uint32_t ranks = a.P == 32 ? kFull : (1u << a.P) - 1u;  // alive, by rank
    const uint32_t above = nsel == 32 ? kFull : (1u << nsel) - 1u;
    uint32_t taken = 0;
    for (int step = 0; step < a.K; ++step) {
      const uint32_t low = ranks & (0u - ranks) & above;
      if (H == 1 ? !low : !__any_sync(kFull, low)) break;
      taken |= low;
      const uint32_t cut = __shfl_sync(kFull, rrow, 31 - __clz(low), W);
      ranks &= low ? ~cut : kFull;
    }
    nk = __popc(taken);
    if ((taken >> hl) & 1u)
      kept[__popc(taken & ((1u << hl) - 1u))] = static_cast<uint16_t>(b);
    alive = hl < a.P ? (ranks >> rank) & 1u : 0u;
  } else {
    constexpr uint32_t kSlots = S == 32 ? kFull : (1u << S) - 1u;
    const int words = (a.P + 31) >> 5;
    const int word = (hl * S) >> 5, shift = (hl * S) & 31;
    for (; nk < a.K; ++nk) {
      uint32_t m = kFull;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if ((alive >> s) & 1u) m = min(m, key[s]);
      m = __reduce_min_sync(kFull, m);
      if (static_cast<int>(m >> 10) >= nsel) break;  // nothing above NEG/2
      const int idx = static_cast<int>(m & 1023u);
      if (hl == 0) kept[nk] = static_cast<uint16_t>(idx);
      if (alive) alive &= ~((sup[idx * words + word] >> shift) & kSlots);
      if (idx / S == hl) alive &= ~(1u << (idx % S));
    }
  }
  unsigned frozen = 0;
  if (H > 1 || nk < a.K) {
    // The lowest index of the maximum of the live array as it stands.
    float best = -INFINITY;
    unsigned at = 0xffffffffu;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int p = hl * S + s;
      if (p < a.P) {
        const float v = (alive >> s) & 1u ? live[p] : kNeg;
        if (v > best) {
          best = v;
          at = p;
        }
      }
    }
    float top = best;
    for (int off = W / 2; off > 0; off >>= 1)
      top = fmaxf(top, __shfl_xor_sync(kFull, top, off, W));
    frozen = best == top ? at : 0xffffffffu;
    for (int off = W / 2; off > 0; off >>= 1)
      frozen = min(frozen, __shfl_xor_sync(kFull, frozen, off, W));
  }
  __syncwarp();
  if (!active) return;
  const long long base = (static_cast<long long>(g) * a.C + c) * a.K;
  for (int k = hl; k < a.K; k += W) {
    const int idx = k < nk ? kept[k] : static_cast<int>(frozen);
    const float mask = k < nk ? 1.f : 0.f;
    a.keep_mask[base + k] = mask;
    if (a.keep_idx) a.keep_idx[base + k] = idx;
    if (a.out_boxes) reinterpret_cast<float4*>(a.out_boxes)[base + k] = box[idx];
    if (a.out_scores) a.out_scores[base + k] = __fmul_rn(raw[idx], mask);
  }
}

// Block (g, y) takes group g and the problems c = (y * warps + warp) * H +
// half, then every warps * H * gridDim.y-th. Shared memory: the group's
// boxes (float4) and areas, its suppression bits, then each problem
// slot's live and raw scores and kept indices. S is the boxes a lane holds;
// for S = 1, L (16 or 32) bounds P, and so the unrolled loops over boxes.
template <int S, int L>
__global__ void __launch_bounds__(S <= 4 ? 256 : 512, S <= 4 ? 4 : 1)
nms_groups_kernel(const __grid_constant__ NmsArgs a) {
  constexpr int H = halves_of(S, L), W = 32 / H;
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = a.P, words = (P + 31) >> 5, warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = lane / W, hl = lane % W, slot = warp * H + half;
  float4* box = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(box + P);
  uint32_t* sup = reinterpret_cast<uint32_t*>(area + P);
  float* lives = reinterpret_cast<float*>(sup + P * words);
  float* live = lives + slot * 2 * P;
  float* raw = live + P;
  uint16_t* kept = reinterpret_cast<uint16_t*>(lives + warps * H * 2 * P) + slot * P;

  const int g = blockIdx.x, g1 = g / a.G2, g2 = g - g1 * a.G2;
  const float* gb = a.boxes + g1 * a.bs0 + g2 * a.bs1;
  const long long gs = g1 * a.ss0 + g2 * a.ss1, gv = g1 * a.vs0 + g2 * a.vs1;
  const int first = (blockIdx.y * warps + warp) * H, stride = warps * H * gridDim.y;

  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float* b = gb + p * a.bs2;
    const float4 v = make_float4(__ldg(b), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3));
    box[p] = v;
    area[p] = __fmul_rn(__fsub_rn(v.z, v.x), __fsub_rn(v.w, v.y));
  }
  if (first < a.C)
    load_live<W>(a, gs, gv, first + half, first + half < a.C, live, raw, hl);
  __syncthreads();

  // sup[i] word w: a warp per word, a lane per column j = 32 w + lane, or
  // for P <= 16 two rows a warp, lanes 16-31 on the second. A warp takes up
  // to four tasks at once: their overlaps first, then the divisions (each
  // a branch, which nothing is moved across).
  constexpr int R = L == 16 ? 2 : 1;
  const int tasks = (P * words + R - 1) / R;
  for (int t0 = warp; t0 < tasks; t0 += 4 * warps) {
    float inter[4], uni[4];
    bool in[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + u * warps;
      const int i = R == 2 ? 2 * t + (lane >> 4) : words == 1 ? t : t / words;
      const int j = R == 2 ? lane & 15 : (t - i * words) * 32 + lane;
      const int ii = min(i, P - 1), jj = min(j, P - 1);
      in[u] = i < P && j < P;
      overlap(box[ii], box[jj], area[ii], area[jj], inter[u], uni[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + u * warps;
      if (t >= tasks) break;
      const uint32_t bits = __ballot_sync(kFull, in[u] && iou_above(inter[u], uni[u], a.iou_thr));
      if (lane == 0) {
        if (R == 2) {
          sup[2 * t] = bits & 0xffffu;
          if (2 * t + 1 < P) sup[2 * t + 1] = bits >> 16;
        } else {
          sup[t] = bits;
        }
      }
    }
  }
  uint32_t key[S], alive = 0;
  int nsel = 0;
  if (first < a.C) rank_boxes<S, L>(live, P, hl, half, key, alive, nsel);
  __syncthreads();

  for (int base = first; base < a.C; base += stride) {
    const int c = base + half;
    if (base != first) {
      __syncwarp();
      load_live<W>(a, gs, gv, c, c < a.C, live, raw, hl);
      __syncwarp();
      rank_boxes<S, L>(live, P, hl, half, key, alive, nsel);
    }
    solve<S, L>(a, g, c, c < a.C, box, sup, live, raw, kept, key, alive, nsel, hl);
  }
}

// Shared memory of a block of `slots` problem slots.
size_t smem_bytes(int P, int slots) {
  const size_t words = (P + 31) / 32;
  return static_cast<size_t>(P) * (16 + 4 + 4 * words) +
         static_cast<size_t>(slots) * P * (4 + 4 + 2);
}

template <int S, int L = 32>
int launch(const NmsArgs& a, dim3 grid, int warps, size_t bytes, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_groups_kernel<S, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_groups_kernel<S, L><<<grid, warps * 32, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int step_nms(const float* boxes, const void* scores, const void* valid,
                        int32_t* keep_idx, float* keep_mask, float* out_boxes,
                        float* out_scores, int score_bf16, int valid_kind, int G,
                        int G2, int P, int C, int K, long long bs0, long long bs1,
                        long long bs2, long long ss0, long long ss1, long long ss2,
                        long long ss3, long long vs0, long long vs1, long long vs2,
                        float iou_thr, float score_thr, void* stream) {
  if (G < 0 || G2 < 1 || P < 1 || P > kMaxBoxes || C < 0 || K < 0 ||
      valid_kind < 0 || valid_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0 || C == 0 || K == 0) return 0;
  int S = 1;
  while (S * 32 < P) S <<= 1;
  // A warp per problem (two up to P = 16), and for larger P enough warps to
  // share the P x P suppression bits; fewer if shared memory does not hold
  // them. Up to P = 128 a group's problems are split evenly over blocks of
  // at most 8 warps, each warp running its problems' chains at once, so
  // that blocks stay small; beyond, where the bits cost more than a chain,
  // one block per group, its warps taking turns at the problems.
  const int words = (P + 31) / 32, halves = P <= 16 ? 2 : 1;
  const int need = (C + halves - 1) / halves, most = S <= 4 ? 8 : 16;
  int warps = need > words * words ? need : words * words;
  if (warps > most) {
    const int blocks = S <= 4 ? (need + most - 1) / most : 1;
    warps = (need + blocks - 1) / blocks;
    if (warps < words * words) warps = words * words;
    if (warps > most) warps = most;
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  while (warps > 1 && smem_bytes(P, warps * halves) > static_cast<size_t>(optin)) --warps;
  const size_t bytes = smem_bytes(P, warps * halves);
  if (bytes > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);

  const NmsArgs a{boxes, scores, valid, keep_idx, keep_mask, out_boxes, out_scores,
                  score_bf16, valid_kind, G2, P, C, K, bs0, bs1, bs2, ss0, ss1, ss2,
                  ss3, vs0, vs1, vs2, iou_thr, score_thr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(G, S <= 4 ? (need + warps - 1) / warps : 1);
  switch (S) {
    case 1: return P <= 16 ? launch<1, 16>(a, grid, warps, bytes, st)
                           : launch<1, 32>(a, grid, warps, bytes, st);
    case 2: return launch<2>(a, grid, warps, bytes, st);
    case 4: return launch<4>(a, grid, warps, bytes, st);
    case 8: return launch<8>(a, grid, warps, bytes, st);
    case 16: return launch<16>(a, grid, warps, bytes, st);
    default: return launch<32>(a, grid, warps, bytes, st);
  }
}
