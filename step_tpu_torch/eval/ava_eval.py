"""AVA v2.1-style frame-mAP evaluator with official-protocol bookkeeping.

A copy of `step_tpu/eval/ava_eval.py` (host-side, no JAX), held equal to
it by `tests/test_torch_port_ava.py`.

Reference parity: the vendored ActivityNet/AVA toolkit evaluator
(``external/ActivityNet`` (recon), ``get_ava_performance``-style). The AVA
protocol is per-class all-point AP over keyframe detections at spatial IoU
0.5, multi-label (every (box, class) GT pair is a separate target), with:

  * a **label map** (pbtxt): AVA action ids are sparse 1-based ids in 1..80,
    of which only 60 are evaluated (the ``*_for_activitynet`` whitelist).
    `AVALabelMap` owns the sparse-id <-> dense-class-index bijection; ids not
    in the map are dropped from both detections and groundtruth, exactly as
    the official evaluator ignores classes absent from its label map.
  * an **excluded-timestamps CSV** (`video_id,timestamp` rows): those
    keyframes are removed from both sides before matching.

Built on the same matching/AP core as the UCF evaluator
(`detection_metrics.frame_map`) — the protocols only differ in bookkeeping,
not math. Keyframe keys are `(video_id, timestamp)` tuples; boxes are
x1y1x2y2 (any consistent scale — AVA uses normalized [0,1] coords, which IoU
is invariant to).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Sequence, Set, Tuple

from step_tpu_torch.eval.detection_metrics import frame_map


class AVALabelMap:
    """Sparse 1-based AVA action ids -> dense class indices [0, num_classes).

    `ids[i]` is the sparse id of dense class i (ids kept in ascending order,
    matching the official evaluator's per-class AP table ordering).
    """

    def __init__(self, ids: Sequence[int], names: Optional[Sequence[str]] = None):
        self.ids: Tuple[int, ...] = tuple(sorted(int(i) for i in ids))
        if len(set(self.ids)) != len(self.ids):
            raise ValueError("duplicate action ids in label map")
        self.names: Tuple[str, ...] = tuple(names) if names else tuple(
            f"action_{i}" for i in self.ids
        )
        self._to_dense = {aid: d for d, aid in enumerate(self.ids)}

    @property
    def num_classes(self) -> int:
        return len(self.ids)

    def dense(self, action_id: int) -> int:
        """Sparse AVA id -> dense index, or -1 if not an evaluated class."""
        return self._to_dense.get(int(action_id), -1)

    def sparse(self, dense_idx: int) -> int:
        return self.ids[dense_idx]

    @classmethod
    def identity(cls, num_classes: int) -> "AVALabelMap":
        """Dense i <-> id i+1 — the no-whitelist fallback."""
        return cls(range(1, num_classes + 1))

    @classmethod
    def from_pbtxt(cls, path: str) -> "AVALabelMap":
        with open(path) as f:
            return cls.from_pbtxt_text(f.read())

    @classmethod
    def from_pbtxt_text(cls, text: str) -> "AVALabelMap":
        """Parse the AVA label-map pbtxt (``ava_action_list_*.pbtxt``).

        Accepts both official shapes: ``item { name: "..." id: N }`` and
        ``label { name: "..." label_id: N label_type: ... }``. Only the
        (name, id) pairs matter; a full protobuf parser is unnecessary.
        """
        ids, names = [], []
        # Pair each name with the id that follows it inside the same block.
        for block in re.findall(r"\{([^}]*)\}", text):
            name_m = re.search(r'name:\s*"((?:[^"\\]|\\.)*)"', block)
            id_m = re.search(r"(?:label_)?id:\s*(\d+)", block)
            if id_m:
                ids.append(int(id_m.group(1)))
                names.append(name_m.group(1) if name_m else f"action_{id_m.group(1)}")
        if not ids:
            raise ValueError("no label entries found in pbtxt")
        order = sorted(range(len(ids)), key=lambda i: ids[i])
        return cls([ids[i] for i in order], [names[i] for i in order])


def read_exclusions(path: str) -> Set[Tuple[str, float]]:
    """Parse the official excluded-timestamps CSV (`video_id,timestamp`)
    into keyframe keys matching the dataset's `(video, float(ts))` keys."""
    excluded: Set[Tuple[str, float]] = set()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            excluded.add((parts[0], float(parts[1])))
    return excluded


def ava_frame_map(
    detections: Sequence[Tuple],    # ((video, t), class_id, score, box[4])
    groundtruth: Sequence[Tuple],   # ((video, t), class_id, box[4])
    num_classes: int = 60,
    iou_threshold: float = 0.5,
    excluded_keyframes: Optional[Iterable[Tuple]] = None,
    label_map: Optional[AVALabelMap] = None,
) -> Dict:
    """AVA frame-mAP@IoU over dense class indices.

    Class ids outside [0, num_classes) are dropped (never crash on raw AVA
    ids) — map sparse ids to dense first via `AVALabelMap` /
    `parse_ava_csv_rows(label_map=...)`. With `label_map`, `num_classes` is
    taken from it. Returns {'mAP', 'ap_per_class', 'num_gt'}.
    """
    if label_map is not None:
        num_classes = label_map.num_classes
    excluded: Set[Tuple] = set(excluded_keyframes or ())
    detections = [d for d in detections
                  if d[0] not in excluded and 0 <= d[1] < num_classes]
    groundtruth = [g for g in groundtruth
                   if g[0] not in excluded and 0 <= g[1] < num_classes]
    return frame_map(detections, groundtruth, num_classes, iou_threshold)


def parse_ava_csv_rows(
    rows: Iterable[Sequence],
    with_scores: bool,
    label_map: Optional[AVALabelMap] = None,
):
    """Convert AVA CSV rows (video_id, t, x1, y1, x2, y2, action_id[, score])
    to evaluator tuples with dense class indices.

    With `label_map`, sparse 1-based ids map through it and unmapped ids
    (non-evaluated classes) are dropped — the official whitelist behavior.
    Without, ids are assumed dense-contiguous (stored as id-1).
    """
    out = []
    for r in rows:
        key = (r[0], float(r[1]))
        box = [float(r[2]), float(r[3]), float(r[4]), float(r[5])]
        aid = int(r[6])
        cls = label_map.dense(aid) if label_map is not None else aid - 1
        if cls < 0:
            continue
        if with_scores:
            out.append((key, cls, float(r[7]), box))
        else:
            out.append((key, cls, box))
    return out
