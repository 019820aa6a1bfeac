"""The check's control and its planted faults, and the readings they give.

    python3 benchmark/controls.py --workload <cell> --seeds 1,2,3 \
        --variants program,control,unchanged,half,altered --seconds 2

runs, in one process and for each seed, the cell with the program (its
sound readings) and with each variant in the program's place, and prints
one JSON line of readings per run. The benchmark's own runs never run
these. Variants:

  control    the reference in the program's place, computed in the
             precision below the configuration's (float8 e4m3 for bfloat16)
  witness    the reference in the program's place in the configuration's
             own precision: what rounding alone reads
  unchanged  serving: the first refinement step returns its proposals
             unchanged; training: a step that leaves the state as it was
  half       serving: the second half of each batch answered with the
             first half's answers; training: every step on the first half
             of its batch, the mean taken over it (a cell of one clip a
             request has no half batch)
  altered    serving: one kept detection's score halved where the NMS
             surface is produced
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = os.path.dirname(HERE)

from benchmark import program  # noqa: E402
from benchmark.reference import detector as ref  # noqa: E402
from benchmark.reference import training as ref_train  # noqa: E402

LOWER = {"float64": "float32", "float32": "bfloat16", "bfloat16": "float8_e4m3fn",
         "float16": "float8_e4m3fn"}


class ReferenceServer:
    """The reference's detector, in `prec`, where the program's server
    stands."""

    def __init__(self, fields, weights, device, prec):
        self.cfg, self.weights, self.prec = ref.config(fields), weights, prec
        self.device = torch.device(device)

    def proposals(self, batch):
        tubes, mask = ref.initial_cuboids(self.cfg, self.device)
        return tubes[None].expand(batch, *tubes.shape), mask[None].expand(batch, -1)

    def detect(self, rgb, proposals, prop_mask):
        return ref.detect(self.weights, self.cfg, rgb, proposals, prop_mask, self.prec)


class ReferenceTrainer(program.Trainer):
    """The reference's train step, in `prec`, where the program's stands;
    the program's loader still feeds it."""

    def __init__(self, fields, weights, device, generator, prec):
        super().__init__(fields, weights, device, generator)
        self.reference = ref_train.Trainer(weights, ref.config(fields), generator, prec)

    def step(self, batch):
        value, positives, _ = self.reference.step(batch)
        return {"loss": value, "num_positive_per_step": positives}

    def first_moments(self):
        return dict(zip(self.reference.names, self.reference.state["mu"]))

    def weights(self):
        return self.reference.P


def _unchanged_server(fields, weights, device):
    server = program.Server(fields, weights, device)
    model = server.model
    step = model._step

    def first_step_unchanged(head, feat, tubes, *args):
        cls_logits, deltas, filled = step(head, feat, tubes, *args)
        return cls_logits, deltas, tubes if head is model.steps[0] else filled

    model._step = first_step_unchanged
    return server


class _HalfServer(program.Server):
    def detect(self, rgb, proposals, prop_mask):
        h = rgb.shape[0] // 2
        out = super().detect(rgb[:h], proposals[:h], prop_mask[:h])
        return {k: torch.cat([v, v[: rgb.shape[0] - h]]) for k, v in out.items()}


class _AlteredServer(program.Server):
    def detect(self, rgb, proposals, prop_mask):
        out = dict(super().detect(rgb, proposals, prop_mask))
        kept = out["frame_mask"].reshape(-1).nonzero()
        if len(kept):
            scores = out["frame_scores"].clone()
            scores.view(-1)[kept[0, 0]] *= 0.5
            out["frame_scores"] = scores
        return out


class _UnchangedTrainer(program.Trainer):
    def step(self, batch):
        zero = torch.zeros((), device=self.device)
        return {"loss": zero, "num_positive_per_step": zero.expand(self.cfg.num_steps)}


class _HalfTrainer(program.Trainer):
    def step(self, batch):
        h = batch["rgb"].shape[0] // 2
        return super().step({k: v[:h] for k, v in batch.items()})


def factory(entry: str, variant: str, fields: dict):
    """The server or trainer factory of `variant` for a cell of `entry`;
    None for the program itself."""
    if variant == "program":
        return None
    prec = ref.Precision(fields["compute_dtype"] if variant == "witness"
                         else LOWER[fields["compute_dtype"]])
    if variant == "witness":
        variant = "control"
    if entry == "serve":
        return {"control": lambda f, w, d: ReferenceServer(f, w, d, prec),
                "unchanged": _unchanged_server, "half": _HalfServer,
                "altered": _AlteredServer}[variant]
    return {"control": lambda f, w, d, g: ReferenceTrainer(f, w, d, g, prec),
            "unchanged": _UnchangedTrainer, "half": _HalfTrainer}[variant]


def main(argv=None) -> int:
    from benchmark.cell import run_cell
    from benchmark.run import load_json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--variants", default="program,control")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    workload = load_json(HERE, "workloads", f"{args.workload}.json")
    config = load_json(HERE, "configs", f"{workload['config']}.json")
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        for variant in args.variants.split(","):
            make = factory(workload["traffic"]["entry"], variant, config["config"])
            t0 = time.perf_counter()
            out = run_cell(workload, config, [], seed, args.seconds, False,
                           device, t0, program=make)
            print(json.dumps({"workload": args.workload, "seed": seed, "variant": variant,
                              "correct": out["correct"], "attempted": out["attempted"],
                              "seconds": round(time.perf_counter() - t0, 1),
                              "readings": {k: c["value"] for k, c in out["checks"].items()},
                              "notes": out.get("notes")}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
