"""Cross-clip tube linking on the device of its inputs.

Port of `step_tpu/tubes/linking.py`: the Viterbi dynamic program over the
clip axis that links per-clip tubes into video tubes, with the K-path
iterative form (`link_tubes_k`), its node suppression (`suppress_iou`),
the Kadane trim (`max_subarray_mask`) and the class-batched forms.

Edge weight between tube i of clip t and tube j of clip t+1:
    w = score_j + link_iou_weight * transition_IoU(i, j)

`transition_IoU` follows the clip tiling (`stride`, video frames between
consecutive clips' first frames): None (or not in (0, T)) compares the
last box of i with the first box of j, the non-overlapping tiling; 0 <
stride < T takes the mean IoU over the T - stride temporally aligned frame
pairs of the window overlap.

Where the JAX package maps over classes and paths with `vmap` and over
clips with `lax.scan`, this module runs classes (and the K rows of the
trim) as a leading batch axis and loops over the K paths and the clip axis
in Python. Nothing syncs with the host: the backtrack is a `torch.gather`
on the device. `NEG = -1e9` absorbs small terms in float32, so the order of
operations is the JAX package's: `cand = prev[:, None] + w * tr`, then
`max + score`. `torch.max` over a dimension picks the first maximal index
and treats NaN as the maximum, as `jnp.argmax` does. Scores stay float32.
"""

from __future__ import annotations

import torch

from step_tpu_torch.tubes.boxes import pairwise_iou

NEG = -1e9
DEAD = -1e6     # trim input of padded clips and re-used nodes


def _transition_iou(tubes: torch.Tensor, stride: int | None = None) -> torch.Tensor:
    """`[L, P, T, 4]` → `[L-1, P, P]` cross-clip transition IoU (see the
    module docstring for the two conventions)."""
    T = tubes.shape[2]
    if stride and 0 < stride < T:
        a = tubes[:-1, :, stride:].transpose(1, 2)          # [L-1, D, P, 4]
        b = tubes[1:, :, : T - stride].transpose(1, 2)
        return pairwise_iou(a, b).mean(dim=1)              # [L-1, P, P]
    return pairwise_iou(tubes[:-1, :, -1], tubes[1:, :, 0])


def _viterbi(masked_scores: torch.Tensor, weighted_trans: torch.Tensor):
    """Best path through `[..., L, P]` node scores with `[L-1, P, P]`
    transition weights, `link_iou_weight * transition IoU` (prev x cur,
    broadcast over the leading axes). Returns (path `[..., L]` int64,
    value `[...]`)."""
    L = masked_scores.shape[-2]
    val = masked_scores[..., 0, :]
    backptrs = []
    for t in range(1, L):
        cand = val[..., :, None] + weighted_trans[t - 1]   # [..., P, P]
        best, best_prev = torch.max(cand, dim=-2)
        val = best + masked_scores[..., t, :]
        backptrs.append(best_prev)
    value, idx = torch.max(val, dim=-1)
    path = [idx]
    for bp in reversed(backptrs):
        idx = torch.gather(bp, -1, idx[..., None])[..., 0]
        path.append(idx)
    return torch.stack(path[::-1], dim=-1), value


def link_tubes(tubes: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor | None = None, link_iou_weight: float = 1.0,
               stride: int | None = None):
    """Link per-clip tubes into ONE video tube by Viterbi (the k=1 core).

    tubes `[L, P, T, 4]`, scores `[..., L, P]` (one class; leading axes
    batch), valid `[L, P]` (or broadcastable to scores) for padded tube
    slots. Returns path `[..., L]` int32, the tube index per clip, and the
    path's value `[...]` (sum of chosen scores and weighted IoUs)."""
    if valid is None:
        valid = torch.ones_like(scores)
    masked = torch.where(valid > 0, scores, NEG)
    path, value = _viterbi(masked, link_iou_weight * _transition_iou(tubes, stride))
    return path.to(torch.int32), value


def max_subarray_mask(x: torch.Tensor):
    """Kadane over the last axis of `[..., L]`: the contiguous run with the
    largest sum. Returns (mask `[..., L]` float32, 1 inside the best run;
    the run's sum `[...]`). With all-negative input the run is the single
    largest element (the first of equals)."""
    x = x.to(torch.float32)
    L = x.shape[-1]
    lead = x.shape[:-1]
    kw = dict(dtype=torch.float32, device=x.device)
    cur = torch.full(lead, NEG, **kw)
    best = torch.full(lead, NEG, **kw)
    zero = torch.zeros(lead, dtype=torch.int64, device=x.device)
    cur_start, best_start, best_end = zero, zero, zero
    for t in range(L):
        xt = x[..., t]
        ext = cur + xt
        restart = ext < xt
        cur = torch.where(restart, xt, ext)
        cur_start = torch.where(restart, t, cur_start)
        better = cur > best
        best = torch.where(better, cur, best)
        best_start = torch.where(better, cur_start, best_start)
        best_end = torch.where(better, t, best_end)
    idx = torch.arange(L, device=x.device)
    mask = (idx >= best_start[..., None]) & (idx <= best_end[..., None])
    return mask.to(torch.float32), best


def link_tubes_k(tubes: torch.Tensor, scores: torch.Tensor,
                 valid: torch.Tensor | None = None, link_iou_weight: float = 1.0,
                 k: int = 4, trim_thresh: float = 0.05,
                 clip_mask: torch.Tensor | None = None,
                 stride: int | None = None, suppress_iou: float | None = None):
    """K video tubes by iterative Viterbi with node suppression.

    tubes `[L, P, T, 4]`; scores `[..., L, P]` (leading axes batch, e.g.
    classes); valid `[L, P]` or `[..., L, P]`; clip_mask `[L]`, 0 for padded
    clip slots; stride the clip tiling (`_transition_iou`).

    After each extraction the path's (clip, tube) nodes are invalidated, so
    the K paths are node-disjoint; with `suppress_iou` every node whose tube
    overlaps the chosen one of its clip above that mean IoU goes too, so
    later paths find other actors rather than near-duplicate proposals.
    Each path is trimmed to the maximal-sum run of its per-clip scores
    minus `trim_thresh`; a clip where the path had to re-use a node (its
    valid nodes exhausted) or a padded clip enters the trim as `DEAD`, so
    it is never emitted, and a path with no fresh clip trims to nothing.

    Returns a dict with the K axis after the leading axes:
      paths `[..., K, L]` int32; values `[..., K]`, the path objective over
      the emitted run (chosen scores plus weighted transition IoUs between
      consecutive active clips, never the NEG-contaminated accumulator);
      trim `[..., K, L]` float32, 1 where the tube is active; tube_scores
      `[..., K]`, the mean chosen score over the run.
    """
    L, P = scores.shape[-2:]
    if valid is None:
        valid = torch.ones_like(scores)
    if clip_mask is None:
        clip_mask = torch.ones((L,), dtype=scores.dtype, device=scores.device)
    scores = scores * clip_mask[:, None]
    trans = _transition_iou(tubes, stride) * torch.minimum(
        clip_mask[:-1], clip_mask[1:])[:, None, None]
    if suppress_iou is not None:
        tt = tubes.transpose(1, 2)                          # [L, T, P, 4]
        intra = pairwise_iou(tt, tt).mean(dim=1)            # [L, P, P]
    valid_carry = valid.to(scores.dtype).expand(scores.shape)
    weighted_trans = link_iou_weight * trans
    clips = torch.arange(L, device=scores.device)
    live_clip = clip_mask[:, None] > 0
    paths, chosen, fresh = [], [], []
    for _ in range(k):
        masked = torch.where(valid_carry > 0, scores, NEG)
        masked = torch.where(live_clip, masked, 0.0)
        path, _ = _viterbi(masked, weighted_trans)          # [..., L]
        at = path[..., None]
        fresh.append(torch.gather(valid_carry, -1, at)[..., 0] > 0)
        valid_carry = valid_carry.scatter(-1, at, 0.0)
        if suppress_iou is not None:
            overlap = intra[clips, path]                     # [..., L, P]
            valid_carry = torch.where(overlap > suppress_iou, 0.0, valid_carry)
        chosen.append(torch.gather(scores, -1, at)[..., 0])
        paths.append(path)
    paths, chosen, fresh = (torch.stack(v, dim=-2) for v in (paths, chosen, fresh))

    trim_in = torch.where((clip_mask > 0) & fresh, chosen - trim_thresh, DEAD)
    trim, best = max_subarray_mask(trim_in)
    # The run always keeps one element: zero the row when even its best is dead.
    trim = trim * (best > 0.5 * DEAD).to(trim.dtype)[..., None]
    n_active = torch.clamp(trim.sum(dim=-1), min=1.0)
    tube_scores = (chosen * trim).sum(dim=-1) / n_active
    tsel = trans[clips[:-1], paths[..., :-1], paths[..., 1:]]      # [..., K, L-1]
    pair = trim[..., :-1] * trim[..., 1:]
    values = (chosen * trim).sum(dim=-1) + link_iou_weight * (tsel * pair).sum(dim=-1)
    return {"paths": paths.to(torch.int32), "values": values, "trim": trim,
            "tube_scores": tube_scores}


def link_tubes_multiclass(tubes: torch.Tensor, class_scores: torch.Tensor,
                          valid: torch.Tensor | None = None,
                          link_iou_weight: float = 1.0, stride: int | None = None):
    """`link_tubes` for every class at once: tubes `[L, P, T, 4]`,
    class_scores `[L, P, C]`, valid `[L, P]` → paths `[C, L]` int32, values
    `[C]`."""
    return link_tubes(tubes, class_scores.movedim(-1, 0), valid,
                      link_iou_weight, stride)


def link_tubes_multiclass_k(tubes: torch.Tensor, class_scores: torch.Tensor,
                            valid: torch.Tensor | None = None,
                            link_iou_weight: float = 1.0, k: int = 4,
                            trim_thresh: float = 0.05,
                            clip_mask: torch.Tensor | None = None,
                            stride: int | None = None,
                            suppress_iou: float | None = None):
    """`link_tubes_k` for every class at once: class_scores `[L, P, C]` →
    paths `[C, K, L]`, values `[C, K]`, trim `[C, K, L]`, tube_scores
    `[C, K]`."""
    return link_tubes_k(tubes, class_scores.movedim(-1, 0), valid,
                        link_iou_weight, k, trim_thresh, clip_mask, stride,
                        suppress_iou)
