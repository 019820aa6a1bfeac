"""Write `wgmma.cuh`: one `Wgmma<N>::mma` per tile width N that the 3x3x3
conv kernel (`conv3d.cu`) uses.

Each wraps one Hopper `wgmma.mma_async` m64nNk16 instruction (bf16 inputs,
float32 accumulators, A and B both read from shared memory through
descriptors, both K-major). The instruction names each of its N / 2
accumulator registers per thread, so the asm text differs per N and is
generated here rather than written by hand.

    python3 step_tpu_torch/csrc/gen_wgmma.py

The widths must match `kernels.CONV_TILE_N`.
"""

from pathlib import Path

WIDTHS = (32, 48, 64, 96, 128, 144, 160, 192, 208, 224, 256)

HEADER = """\
// Generated by gen_wgmma.py; do not edit.
//
// Wgmma<N>::mma(d, a, b): d[64 x N] += A[64 x 16] * B[16 x N] for one
// warpgroup, bf16 x bf16 into float32 registers. a and b are shared-memory
// matrix descriptors of K-major tiles; d holds this thread's N / 2
// accumulators in the wgmma fragment order. The instruction is
// asynchronous: the caller fences, commits and waits (conv3d.cu).
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


def main() -> None:
    text = HEADER + "".join(one(n) for n in WIDTHS)
    (Path(__file__).resolve().parent / "wgmma.cuh").write_text(text)


if __name__ == "__main__":
    main()
