"""The comparison that decides `correct`: what the timed path produced,
judged against the plain reference (`reference/`) on the same weights and
inputs, each number against the limit the workload file sets.

Serving, over a sample of the requests the window finished:
  logp_gap      the widest gap between the log of a served tube score and
                the log of the reference's, over the real proposals (the
                scores are probabilities; a log-probability's gap follows the
                logits' error, where the probabilities' own gap shrinks as
                the softmax sharpens)
  tube_gap      the widest gap between a served tube coordinate and the
                reference's after the three refinement steps, as a share of
                the image's side (10.1 px of 224 is 0.045)
  nms_mismatch  entries of the served NMS surface (the mask everywhere,
                boxes and scores where either side keeps a box) that differ
                from the reference's NMS run on the served tubes and scores
Training, over the three steps that set-up drove through the window's call:
  loss_gap      the widest relative gap between a step's loss and the
                reference's
  positives_gap the widest relative gap between the positives a step's
                first refinement step matched (the program's
                `num_positive_per_step`) and the reference's: its proposals
                are the initial cuboids and its targets the batch's boxes,
                so a sound step matches exactly the same
  grad_gap_median  the median leaf's gap between the norms of the first
                step's clipped gradient (the optimizer's first moment / (1 -
                b1)) and the reference's, over the larger of that leaf's
                reference norm and the median leaf's. The median and not the
                worst leaf: the reference itself in bfloat16 reads as wide a
                worst gap as the program (0.2 to 0.6, a few BatchNorm leaves
                of the early stem, whose gradients are sums that cancel), and
                so does the float8 control, so the worst leaf separates
                nothing
  change_gap    the worst leaf's gap (as above) in the change of each leaf
                over the three steps,
                the BatchNorm statistics included; leaves whose reference
                gradient is under a thousandth of the median leaf's are left
                out (they move by round-off alone under Adam)
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.reference import detector as ref
from benchmark.reference import training as ref_train

TINY = 1e-30


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the reference's matrix products and convolutions, as
    the program left it after."""
    kept = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = kept


def reference_detect(weights, cfg, rgb, props, mask, prec=ref.FLOAT32, block=8):
    """The reference's answer to a request, in blocks of clips."""
    parts = [ref.detect(weights, cfg, rgb[i:i + block], props[i:i + block],
                        mask[i:i + block], prec) for i in range(0, rgb.shape[0], block)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def serve_readings(weights, cfg, samples, device) -> dict:
    """samples: (uint8 clips `[B, T, H, W, 3]` on the host, proposals and
    mask on the host, the served answer as host tensors)."""
    logp = score = tube = 0.0
    mismatch = 0
    with float32_exact():
        for clips, props, mask, served in samples:
            rgb, props, mask = (t.to(device) for t in (clips, props, mask))
            want = reference_detect(weights, cfg, rgb, props, mask)
            got = {k: v.to(device) for k, v in served.items()}
            score = max(score, float((got["tube_scores"].float() - want["tube_scores"]).abs().max()))
            real = mask[..., None].expand_as(want["tube_scores"]) > 0
            log = lambda p: torch.log(torch.clamp(p.float(), min=TINY))  # noqa: E731
            logp = max(logp, float((log(got["tube_scores"]) - log(want["tube_scores"]))[real]
                                   .abs().max()))
            gap = (got["tubes"].float() - want["tubes"]).abs() / cfg.image_size
            tube = max(tube, float(gap.max()))
            surface = ref.nms_surface(got["tubes"].float(), got["tube_scores"].float(), mask, cfg)
            kept = (surface["frame_mask"] > 0) | (got["frame_mask"] > 0)
            mismatch += int((surface["frame_mask"] != got["frame_mask"]).sum())
            mismatch += int(((surface["frame_scores"] != got["frame_scores"]) & kept).sum())
            mismatch += int(((surface["frame_boxes"] != got["frame_boxes"]).any(-1) & kept).sum())
    return {"logp_gap": logp, "tube_gap": tube, "nms_mismatch": mismatch}, {"score_gap": score}


def _norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def _gaps(got: dict, want: dict, names) -> list:
    """(gap, name) of each leaf, the worst first."""
    median = float(np.median([want[n] for n in names]))
    return sorted(((abs(got[n] - want[n]) / max(want[n], median), n) for n in names),
                  reverse=True)


def train_readings(weights, cfg, batches, generator, served, device) -> dict:
    """served: the program's `losses` of the three steps, its first-step
    gradient `grads` and its `weights` after the third step, by name, on the
    host. The reference trains from `weights` on the same `batches` with
    the masks of the same `generator`."""
    with float32_exact():
        losses, positives, grads, after = ref_train.train_steps(weights, cfg, batches,
                                                                generator)
    want_g = _norms(grads)
    got_g = _norms({n: served["grads"][n].to(device) for n in grads})
    median_g = float(np.median(list(want_g.values())))
    moved = [n for n in after if ref.is_statistic(n) or want_g[n] >= 1e-3 * median_g]
    want_d = _norms({n: after[n] - weights[n] for n in moved})
    got_d = _norms({n: served["weights"][n].to(device).float() - weights[n] for n in moved})
    grad, change = _gaps(got_g, want_g, list(grads)), _gaps(got_d, want_d, moved)
    notes = {"grad_gap_worst": [grad[0][1], grad[0][0]],
             "change_gap_worst": [change[0][1], change[0][0]],
             "losses": [served["losses"], losses]}
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(served["losses"], losses)),
            "positives_gap": max(abs(a - b) / max(b, 1.0)
                                 for a, b in zip(served["positives"], positives)),
            "grad_gap_median": float(np.median([g for g, _ in grad])),
            "change_gap": change[0][0]}, notes


def verdict(readings: dict, limits: dict):
    """(correct, the readings beside their limits): every reading at or
    under its limit; a reading that is not a number fails."""
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
