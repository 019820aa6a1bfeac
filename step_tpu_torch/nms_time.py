"""Device time of K1 (`csrc/nms.cu`) and of the whole NMS surface, on one
CUDA card, for comparing two trees of the port in one call.

    python3 -m step_tpu_torch.nms_time
    cd artifacts/parent && PYTHONPATH=. python3 ../../step_tpu_torch/nms_time.py

It times whichever `step_tpu_torch` is on the path: this tree's launcher
(groups of boxes shared by C problems, raw scores pre-masked in the
kernel), or the earlier one, `nms_many_forward(live, boxes, keep_idx,
keep_mask, thr)` (N problems of P <= 32 boxes on pre-masked scores). The
shapes are `ucf_3step`'s (T = 18 frames, C = 24 classes, P = 16, K = 16):
  (a) B = 8: 3,456 problems;  (b) B = 64: 27,648, the streaming batch;
  (c) N = 1, the latency floor;  (d) P = 64 and P = 1024 at B = 8, this
  tree only.
Each launcher is timed alone: 20 launches on preallocated outputs captured
in a CUDA graph, replayed between CUDA events. At (a) and (b) the whole
`nms_surface` call is timed the same way (the earlier tree's expands,
pre-masks, launches and gathers). Prints one JSON object per line, each
with the card's name and power limit.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys

import numpy as np
import torch

T, C, P, K = 18, 24, 16, 16


def graph_ms(launch, n: int = 20, reps: int = 5) -> float:
    """Device time of one call of `launch`: `n` calls captured in a CUDA
    graph, the graph replayed `reps` times between CUDA events."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def surface_inputs(rng, B: int, p: int, dev):
    """tubes `[B, p, T, 4]` (a few NaN coordinates), scores `[B, p, C]`
    with ties, zero on padding, and the proposal mask (the last quarter of
    the slots padding)."""
    xy = rng.uniform(0, 200, (B, p, T, 2))
    wh = rng.uniform(0, 60, (B, p, T, 2))
    tubes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    tubes[rng.rand(B, p, T, 4) < 0.01] = np.nan
    mask = np.ones((B, p), np.float32)
    mask[:, p - p // 4:] = 0.0
    scores = (rng.randint(0, 9, (B, p, C)) / 8.0).astype(np.float32) * mask[..., None]
    return (torch.from_numpy(a).to(dev) for a in (tubes, scores, mask))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this timing runs only on the card", file=sys.stderr)
        return 1
    from step_tpu_torch import PRESETS, kernels
    from step_tpu_torch.inference import nms_surface
    from step_tpu_torch.ops.nms import _f32, premask_scores

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    earlier = next(iter(inspect.signature(kernels.nms_many_forward).parameters)) == "live"
    tree = "earlier" if earlier else "this"
    cfg = PRESETS["ucf_3step"]
    thr, sthr = _f32(cfg.nms_thresh), _f32(cfg.score_thresh)
    rng = np.random.RandomState(0)

    def emit(shape: str, what: str, ms: float, **kw) -> None:
        print(json.dumps({"tree": tree, "shape": shape, "what": what, "ms": ms, **kw,
                          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
              flush=True)

    def flat(boxes, scores, valid, k):
        """The launcher on N independent problems `[N, p]`."""
        N, p = scores.shape
        idx = torch.empty((N, k), dtype=torch.int32, device=dev)
        mask = torch.empty((N, k), dtype=torch.float32, device=dev)
        if earlier:
            live = premask_scores(scores, sthr, valid)
            boxes = boxes.contiguous()
            return lambda: kernels.nms_many_forward(live, boxes, idx, mask, thr)
        return lambda: kernels.nms_many_forward(
            boxes[:, None], scores[:, None, :, None], valid[:, None],
            mask.view(N, 1, 1, k), thr, sthr, keep_idx=idx.view(N, 1, 1, k))

    shapes = [("a", 8, P), ("b", 64, P), ("c", None, P)]
    if not earlier:
        shapes += [("d", 8, 64), ("d", 8, 1024)]
    for shape, B, p in shapes:
        b = B or 1
        tubes, scores, mask = surface_inputs(rng, b, p, dev)
        k = min(K, p)
        # The problems as the surface makes them, one per (b, t, c).
        boxes = tubes.transpose(1, 2)[:, :, None].expand(b, T, C, p, 4).reshape(-1, p, 4)
        probs = scores.transpose(1, 2)[:, None].expand(b, T, C, p).reshape(-1, p)
        valid = mask[:, None, None].expand(b, T, C, p).reshape(-1, p)
        if B is None:
            boxes, probs, valid = boxes[:1], probs[:1], valid[:1]
        n = probs.shape[0]
        emit(shape, "launcher, problems apart", graph_ms(flat(boxes, probs, valid, k)),
             problems=n, P=p, K=k)
        if B is None:
            continue
        c = cfg.replace(max_proposals=p, max_detections=k)
        if not earlier:
            out = [torch.empty((b, T, C, k) + e, dtype=torch.float32, device=dev)
                   for e in ((4,), (), ())]
            emit(shape, "launcher, boxes shared per frame", graph_ms(
                lambda: kernels.nms_many_forward(
                    tubes.transpose(1, 2), scores[:, None].expand(b, T, p, C),
                    mask[:, None].expand(b, T, p), out[2], thr, sthr,
                    out_boxes=out[0], out_scores=out[1])), problems=n, P=p, K=k)
        emit(shape, "nms_surface call", graph_ms(lambda: nms_surface(tubes, scores, mask, c)),
             problems=n, P=p, K=k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
