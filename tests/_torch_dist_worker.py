"""One rank of the port's two-process data-parallel test
(`tests/test_torch_port_distributed.py`): a gloo group on the CPU, one
torch thread, and nothing of JAX or of the JAX package imported.

    python tests/_torch_dist_worker.py <port> <rank> <world> <workdir>

It reads the initial weights (`init.pt`) and the global batch
(`batch.npz`) that the test wrote into `workdir`, and writes what the rank
computed to `rank<r>.pt`:
  - one parallel train step of each of `VARIANTS` on the rank's rows of
    the global batch (`process_shard`'s order): metrics and state;
  - `fit(mesh=...)` on `DataLoader(process_count=world, ...)` for
    `FIT_STEPS` steps with checkpoints, and again with SIGTERM raised in
    rank 1 only: its metrics, and where each run stopped;
  - `evaluate_ucf`, `collect_video_tubes` and the late-fusion
    `collect_detections` over the mesh on `MemoryUCF` windows whose count
    is odd, so that the last batch is padded.
"""

import os
import signal
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the training configuration, on `ucf_3step`: a global batch of 8, a step
# with lr > 0 from the first (warmup 0)
TRAIN = dict(backbone_depth="tiny", feature_stride=8, image_size=32, frames_per_chunk=2,
             compute_dtype="float32", batch_size=8, warmup_steps=0, total_steps=50,
             num_classes=4, max_gt_tubes=2, dropout_rate=0.0)
VARIANTS = {"plain": {}, "dropout": {"dropout_rate": 0.3}, "accum2": {"grad_accum_steps": 2}}
# fit: a global batch of 4 (2 a rank) over 12 clips
FIT_STEPS, FIT_CLIPS, FIT_SEED, FIT_LOADER_SEED = 3, 12, 4, 1
FIT = dict(TRAIN, batch_size=4, dropout_rate=0.3, total_steps=FIT_STEPS)
# evaluation: the tiny configuration of the evaluation tests, 3 videos of
# 10 frames = 15 windows: batches of 8 and 7, the 7 padded to 8
EVAL = dict(dataset="ucf101_24", num_classes=3, frames_per_chunk=2, num_chunks=3,
            num_steps=2, iou_thresholds=(0.4, 0.5), step_loss_weights=(1.0, 1.0),
            temporal_extension=True, image_size=32, backbone_depth="tiny",
            feature_stride=8, pooled_size=4, max_proposals=12, max_detections=4,
            compute_dtype="float32", max_gt_tubes=2, score_thresh=0.0)
EVAL_DATA = dict(videos=3, frames=10, resolution=(48, 64), seed=7)
EVAL_SEEDS = (3, 4)             # the RGB and the flow-stream detector's init


def train_cfg(variant: str):
    from step_tpu_torch import PRESETS

    return PRESETS["ucf_3step"].replace(**dict(TRAIN, **VARIANTS[variant]))


def fit_cfg():
    from step_tpu_torch import PRESETS

    return PRESETS["ucf_3step"].replace(**FIT)


def fit_loader(process_count: int, process_index: int, dataset=None):
    from step_tpu_torch.data.loader import DataLoader
    from step_tpu_torch.data.synthetic import SyntheticConfig
    from step_tpu_torch.train_eval_synth import SyntheticClips

    cfg = fit_cfg()
    syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=cfg.max_gt_tubes)
    return DataLoader(dataset or SyntheticClips(syn, FIT_CLIPS, 0), cfg,
                      batch_size=cfg.batch_size // process_count, seed=FIT_LOADER_SEED,
                      num_workers=1, process_count=process_count,
                      process_index=process_index)


def eval_models():
    """(the RGB detector, the flow-stream detector) of the evaluation."""
    from step_tpu_torch.config import StepConfig
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.utils.init import init_detector_

    cfg = StepConfig(**EVAL)
    return tuple(init_detector_(STEPDetector(c), s).eval() for c, s in
                 zip((cfg, cfg.replace(input_stream="flow")), EVAL_SEEDS))


def eval_data(with_flow: bool = False):
    from step_tpu_torch.config import StepConfig
    from step_tpu_torch.data.memory import MemoryUCF

    return MemoryUCF(StepConfig(**EVAL), **EVAL_DATA, with_flow=with_flow)


def _fit(cfg, loader, mesh, ckpt_dir, log_dir=None):
    from step_tpu_torch.train.fit import fit

    return fit(cfg, loader, device="cpu", seed=FIT_SEED, ckpt_dir=ckpt_dir,
               log_dir=log_dir, ckpt_every=2, mesh=mesh)


def main(port: int, rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from step_tpu_torch.evaluate import collect_detections, collect_video_tubes, evaluate_ucf
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.parallel import (create_mesh, init_distributed, make_global_batch,
                                         process_shard)
    from step_tpu_torch.train.trainer import create_train_state, make_parallel_train_step

    torch.set_num_threads(1)
    assert init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo") == (rank, world)
    mesh = create_mesh(device_type="cpu")
    init = torch.load(os.path.join(workdir, "init.pt"))
    batch = dict(np.load(os.path.join(workdir, "batch.npz")))
    local = {k: v[process_shard(len(v), world, rank)] for k, v in batch.items()}
    out = {}
    for variant in VARIANTS:
        cfg = train_cfg(variant)
        model = STEPDetector(cfg)
        model.load_state_dict(init)
        state = create_train_state(cfg, model=model, device="cpu")
        step = make_parallel_train_step(cfg, model, mesh)
        state, metrics = step(state, make_global_batch(local, mesh))
        out[variant] = {"metrics": metrics, "state": state.model.state_dict()}

    cfg = fit_cfg()
    log_dir = os.path.join(workdir, f"fit_log{rank}")
    state = _fit(cfg, fit_loader(world, rank), mesh, os.path.join(workdir, "fit"), log_dir)
    out["fit"] = {"step": state.step, "state": state.model.state_dict()}

    class Preempted:
        """Rank 1's clips; the second one raises SIGTERM in its process."""

        def __init__(self, clips):
            self.clips, self.loaded = clips, 0

        def __len__(self):
            return len(self.clips)

        def __getitem__(self, i):
            self.loaded += 1
            if rank == 1 and self.loaded == 2:
                signal.raise_signal(signal.SIGTERM)
            return self.clips[i]

    clips = fit_loader(world, rank).dataset
    state = _fit(cfg, fit_loader(world, rank, Preempted(clips)), mesh,
                 os.path.join(workdir, "fit_stop"))
    out["fit_stop"] = {"step": state.step}

    model, model_flow = eval_models()
    data = eval_data()
    out["evaluate_ucf"] = evaluate_ucf(model, data, mesh=mesh,
                                       dump_path=os.path.join(workdir, f"dets{rank}.pkl"))
    out["video_tubes"] = collect_video_tubes(model, data, mesh=mesh)
    out["late_fusion"] = collect_detections(model, eval_data(with_flow=True), mesh=mesh,
                                            model_flow=model_flow)
    out["imported"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "step_tpu"))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
