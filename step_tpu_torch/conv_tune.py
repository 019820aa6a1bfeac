"""K3 (`csrc/conv3d.cu`) on the card: its block widths side by side, and
how far its bf16 output strays from the plain version.

    python3 -m step_tpu_torch.conv_tune [--seeds 4]

For each 3x3x3 conv shape of `chip_smoke.py` phase 9 and the tail's widest
unit (Mixed_5c b1b, 192 → 384), bf16:
  * the kernel's time (CUDA events, mean of 20 calls, best of 3) with the
    block the launcher picks, with two warpgroups (128 positions) and with
    the widest block its tile width allows (192 or 256 positions), and
    cuDNN's bf16 conv (BN folded) + ReLU beside them;
  * over `--seeds` random inputs, the largest amount by which the kernel
    differs from `conv3x3x3_bn_relu_plain` beyond one bf16 rounding step of
    the plain output, and how many elements differ by more than 1e-5
    beyond it. The tensor cores truncate as they accumulate, so outputs
    that BN and ReLU bring near 0 can stray by more than one step of
    themselves; chip_smoke.py's K3_BF16_ATOL covers that.

Needs a CUDA device; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

SHAPES = (((8, 64, 9, 56, 56), 192), ((128, 160, 5, 7, 7), 320),
          ((8, 24, 5, 14, 14), 64), ((8, 96, 5, 14, 14), 208),
          ((128, 192, 5, 7, 7), 384))


def wide_warpgroups(block_n: int) -> int:
    """The widest block for a tile width (csrc/conv3d.cu::tc_wide)."""
    return 4 if block_n <= 160 else 3 if block_n <= 224 else 2


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def inputs(seed: int, shape, K: int, dev):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    w = torch.from_numpy((rng.randn(K, shape[1], 3, 3, 3) / np.sqrt(27 * shape[1]))
                         .astype(np.float32)).to(dev)
    scale = torch.from_numpy((rng.rand(K) + 0.5).astype(np.float32)).to(dev)
    bias = torch.from_numpy((rng.randn(K) * 0.1).astype(np.float32)).to(dev)
    return x, w, scale, bias


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this runs only on the card", file=sys.stderr)
        return 1
    from step_tpu_torch import kernels
    from step_tpu_torch.ops.conv3d import (conv3x3x3_bn_relu, conv3x3x3_bn_relu_plain,
                                           pack_conv3x3x3_weight)

    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}; bf16; times in ms")
    for shape, K in SHAPES:
        x, w, scale, bias = inputs(0, shape, K, dev)
        packed = pack_conv3x3x3_weight(w, torch.bfloat16)
        out = kernels.empty_ncdhw((shape[0], K, *shape[2:]), x)
        wide = wide_warpgroups(kernels.conv_tile_n(K))
        times = {}
        for label, wg in (("picked", 0), ("2 warpgroups", 2), (f"{wide} warpgroups", wide)):
            times[label] = cuda_ms(lambda: kernels.conv3x3x3_bn_relu_forward(
                kernels.ndhwc(x), packed, scale, bias, kernels.ndhwc(out), wg))
        w_fold = (w * scale.view(-1, 1, 1, 1, 1)).to(torch.bfloat16)
        times["cuDNN"] = cuda_ms(lambda: F.relu_(F.conv3d(x, w_fold, bias.to(torch.bfloat16),
                                                          1, 1)))
        worst, beyond = 0.0, 0
        for seed in range(args.seeds):
            x, w, scale, bias = inputs(seed, shape, K, dev)
            got = conv3x3x3_bn_relu(x, w, scale, bias).float()
            want = conv3x3x3_bn_relu_plain(x, w, scale, bias).float()
            excess = (got - want).abs() - 2.0 ** -7 * want.abs()
            worst = max(worst, float(excess.max()))
            beyond += int((excess > 1e-5).sum())
        print(f"{list(shape)}->{K} (tile {kernels.conv_tile_n(K)}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
              + f"; beyond one bf16 step: max {worst:.3g}, {beyond} elements over 1e-5 "
              f"in {args.seeds} seeds", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
