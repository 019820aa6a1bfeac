// 1x1x1 convolution, a GEMM over channels-last rows, with the bias and the
// ReLU in its epilogue, for Hopper (sm_90a):
//
//     out[m, k] = relu(sum_c x[m, c] * w[k, c] + bias[k])
//
// It replaces no Pallas kernel: the JAX package leaves its 1x1x1 convs to
// XLA. It runs the 1x1x1 units of each served Inception block of the heads'
// tail (ops/inception.py): b012, whose output columns split between the
// block's output (b0, row stride Cout) and a dense scratch (b1|b2, row
// stride c1 + c3), and b3b, which writes its slice of the output; and each
// head's reg_reduce (1024 -> 64, ops/inception.py::conv1x1x1_bias_relu),
// in place of cuDNN's conv and ATen's bias-add, ReLU, slice-copy and
// concatenation passes around it.
//
// What bounds it on the card: arithmetic. At a B=32 request (M = 125,440
// rows of 832 channels; 225,792 of 768 at the ViT cell's T' = 9) Mixed_5c's
// b012 (832 -> 624) is 130 GFLOP (0.13 ms at 989 TFLOP/s) against 365 MB of
// bf16 input and output (0.11 ms at 3.35 TB/s); b3b (832 -> 128) is 27
// GFLOP against 241 MB, so it sits at the ridge and its bytes bound it.
// What the design does about it: every output byte is written once, in its
// place, rounded once to bf16, and no pass reads it again before the next
// block; A rows are read once per tile width (the N tiles of one M tile are
// neighbours in the grid, so the second reads them from L2).
//
// The kernel is igemm.cuh's implicit GEMM with TAPS = 1 (its note gives the
// design): the reduction is the input channels alone, A is a straight
// 16-byte cp.async copy of each row's channels, and the epilogue writes
// columns below `split` to one destination and the rest to another, each at
// its own offset and row stride.

#include "igemm.cuh"

// x row m, channel c at x[m * ldx + c] (C a multiple of 8, x 16-byte
// aligned); w the packed [Kw, Rpad] weight (Rpad = C rounded up to 64);
// the rest as step_conv3x3x3_bf16 (conv3d.cu).
STEP_IGEMM_ENTRY(step_conv1x1x1_bf16, 1)
