"""The system under test, `step_tpu_torch`, reached only through its public
API. Nothing else in the benchmark imports the program.

Serving builds the main path that `step_tpu_torch.cli.serve` and the
program's own bench serve: `models/optimize.optimize_for_inference` of the
raw weights (BN folded, the Inception 1x1x1 convs fused), the tree in the
compute dtype, cuDNN convolutions, every max pool on a hand-written
channels-last kernel (K5 for the 3x3x3 stride-1 pools, the strided SAME
kernel for the others; `STEP_TPU_POOL3D`, set to "direct", matters only on
the CPU), kernels K1 (NMS) and K2 (ROI-align). Training builds the
preset's train state around the raw weights and steps it as `fit()` does:
the loader's next batch, `batch_to_device`, `train_step`.
"""

from __future__ import annotations

import dataclasses
import os

import torch


def step_config(fields: dict):
    """The program's `StepConfig` of a configuration file's fields."""
    from step_tpu_torch.config import StepConfig

    kinds = {f.name: f.type for f in dataclasses.fields(StepConfig)}
    return StepConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in fields.items() if k in kinds})


class Server:
    """The main path's detector and `detect_clip`."""

    def __init__(self, fields: dict, weights: dict, device):
        from step_tpu_torch.models.detector import STEPDetector
        from step_tpu_torch.models.optimize import optimize_for_inference

        os.environ["STEP_TPU_POOL3D"] = "direct"
        self.cfg = step_config(fields)
        cfg_run, state = optimize_for_inference(self.cfg, weights)
        with torch.device(device):
            model = STEPDetector(cfg_run)
        model.load_state_dict(state)
        self.model = model.to(dtype=getattr(torch, self.cfg.compute_dtype)).eval()
        self.device = torch.device(device)

    def proposals(self, batch: int):
        from step_tpu_torch.models.detector import STEPDetector

        return STEPDetector.initial_proposals(self.cfg, batch, device=self.device)

    def detect(self, rgb: torch.Tensor, proposals: torch.Tensor, prop_mask: torch.Tensor):
        from step_tpu_torch.inference import detect_clip

        return detect_clip(self.model, rgb, proposals, prop_mask)


class Trainer:
    """The preset's train state around the raw weights, its dropout masks
    drawn from `generator`, and its loader."""

    def __init__(self, fields: dict, weights: dict, device, generator: torch.Generator):
        from step_tpu_torch.models.detector import STEPDetector
        from step_tpu_torch.train.trainer import create_train_state

        self.cfg = step_config(fields)
        with torch.device(device):
            model = STEPDetector(self.cfg)
        model.load_state_dict(weights)
        self.state = create_train_state(self.cfg, 0, model=model, device=device)
        self.state.generator = generator
        self.model = model
        self.device = torch.device(device)

    def loader(self, dataset, batch: int, seed: int, workers: int):
        from step_tpu_torch.data.loader import DataLoader

        return DataLoader(dataset, self.cfg, batch_size=batch, shuffle=True, train=True,
                          seed=seed, num_workers=workers, emit_uint8=True)

    def to_device(self, batch: dict) -> dict:
        from step_tpu_torch.train.trainer import batch_to_device

        return batch_to_device(batch, self.device)

    def step(self, batch: dict) -> dict:
        from step_tpu_torch.train.trainer import train_step

        self.state, metrics = train_step(self.state, batch, self.cfg)
        return metrics

    def first_moments(self) -> dict:
        """The optimizer's first moment by parameter name."""
        return dict(zip(self.state.trainable_names(), self.state.opt_state["mu"]))

    def weights(self) -> dict:
        return self.model.state_dict()
