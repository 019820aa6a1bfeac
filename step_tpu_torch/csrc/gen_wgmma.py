"""Write `wgmma.cuh`: one `Wgmma<N>::mma` and one `WgmmaRS<N>::mma` per
tile width N that the conv kernels (`igemm.cuh`, `conv3d.cu`) use.

Each wraps one Hopper `wgmma.mma_async` m64nNk16 instruction (bf16 inputs,
float32 accumulators, B read from shared memory through a descriptor,
K-major): `Wgmma` reads A from shared memory through a descriptor too,
`WgmmaRS` from four registers a thread (the m16n8k16 A fragment of its
warp's 16 rows). The instruction names each of its N / 2 accumulator
registers per thread, so the asm text differs per N and is generated here
rather than written by hand.

    python3 step_tpu_torch/csrc/gen_wgmma.py

The widths must match `kernels.CONV_TILE_N`.
"""

from pathlib import Path

WIDTHS = (32, 48, 64, 96, 128, 144, 160, 192, 208, 224, 256)
# The widths of the tube conv (conv3d.cu), `kernels.TUBE_TILE_N`.
RS_WIDTHS = (64, 128, 160)

HEADER = """\
// Generated by gen_wgmma.py; do not edit.
//
// Wgmma<N>::mma(d, a, b): d[64 x N] += A[64 x 16] * B[16 x N] for one
// warpgroup, bf16 x bf16 into float32 registers. a and b are shared-memory
// matrix descriptors of K-major tiles; d holds this thread's N / 2
// accumulators in the wgmma fragment order. WgmmaRS<N>::mma(d, a, b): the
// same with A in this thread's four registers a (rows g and g + 8 of its
// warp's 16, columns 2q, 2q + 1 and 2q + 8, 2q + 9, for lane 4g + q). The
// instruction is asynchronous: the caller fences, commits and waits
// (igemm.cuh, conv3d.cu); registers that a pending instruction reads stay
// unchanged until it completes.
#pragma once
#include <stdint.h>

template <int N>
struct Wgmma;
"""


def one(n: int) -> str:
    regs = n // 2
    rows = [range(i, min(i + 8, regs)) for i in range(0, regs, 8)]
    names = '"\n        "'.join(", ".join(f"%{i}" for i in r) + ", " for r in rows)
    names = names[:-2]
    outs = ",\n          ".join(", ".join(f'"+f"(d[{i}])' for i in r) for r in rows)
    return f"""
template <>
struct Wgmma<{n}> {{
  static __device__ __forceinline__ void mma(float (&d)[{regs}], uint64_t a, uint64_t b) {{
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{names}}}, %{regs}, %{regs + 1}, 1, 1, 1, 0, 0;\\n"
        : {outs}
        : "l"(a), "l"(b));
  }}
}};
"""


def one_rs(n: int) -> str:
    regs = n // 2
    rows = [range(i, min(i + 8, regs)) for i in range(0, regs, 8)]
    names = '"\n        "'.join(", ".join(f"%{i}" for i in r) + ", " for r in rows)
    names = names[:-2]
    outs = ",\n          ".join(", ".join(f'"+f"(d[{i}])' for i in r) for r in rows)
    a = ", ".join(f"%{regs + i}" for i in range(4))
    return f"""
template <>
struct WgmmaRS<{n}> {{
  static __device__ __forceinline__ void mma(float (&d)[{regs}], const uint32_t (&a)[4],
                                             uint64_t b) {{
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{names}}}, {{{a}}}, %{regs + 4}, 1, 1, 1, 0;\\n"
        : {outs}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }}
}};
"""


def main() -> None:
    text = (HEADER + "".join(one(n) for n in WIDTHS)
            + "\ntemplate <int N>\nstruct WgmmaRS;\n" + "".join(one_rs(n) for n in RS_WIDTHS))
    (Path(__file__).resolve().parent / "wgmma.cuh").write_text(text)


if __name__ == "__main__":
    main()
