"""The epoch-level training loop.

Port of `step_tpu/train/fit.py` for one card: iterate the loader, run
`train_step` (a batch's flow, where the dataset reads it, goes with it to
the card), log the metrics, checkpoint every `ckpt_every` steps and at
the end, resume exactly mid-epoch (from the port's checkpoints or, where
`tensorstore` is installed, the JAX package's orbax ones), and on SIGTERM
or SIGINT write a last checkpoint and return. With a `log_dir` the
metrics also go to TensorBoard where `tensorboard` is installed
(`MetricsLogger`). The step's metrics stay on the card until a log
window closes (`MetricsLogger.print_every` steps), so the host runs ahead
of the card between windows. `pretrained_i3d` starts the backbone from a
Kinetics I3D checkpoint (`models/convert.py`) with fresh optimizer
moments, as the JAX package does (`step_tpu/train/fit.py:153-164`); a
resumed checkpoint wins over it.

With a `mesh` (`parallel.create_mesh`) every rank runs `fit` on its own
loader (`DataLoader(process_count=..., process_index=...)`, the rank's
share of the global batch `cfg.batch_size`) and steps through
`make_parallel_train_step`: rank 0's state is broadcast once after the
pretrained load or the resume, only rank 0 writes checkpoints and
metrics (the others wait for each checkpoint), every rank restores, and a
signal seen by any rank stops every rank after the same step (the flag is
agreed on at each step by a host-side all-reduce).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.distributed import ReduceOp

from step_tpu_torch.config import StepConfig
from step_tpu_torch.models.convert import pretrained_detector_variables
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.parallel.distributed import broadcast_tensors, host_all_reduce
from step_tpu_torch.parallel.mesh import mesh_device, mesh_group
from step_tpu_torch.train.trainer import (TrainState, batch_to_device,
                                          create_train_state, make_parallel_train_step,
                                          resolve_device, train_step)
from step_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint


class TensorBoardScalars:
    """Scalars in a TensorBoard event file in `path`, written with the
    `tensorboard` package's record writer and protos:
    `torch.utils.tensorboard.SummaryWriter` is not used, since importing it
    imports `tensorflow` where that is installed, and `tensorflow` imports
    JAX. The JAX package's `tensorflow` writer belongs to the TPU image and
    is not carried."""

    def __init__(self, path: str):
        from tensorboard.compat.proto import event_pb2, summary_pb2
        from tensorboard.summary.writer.record_writer import RecordWriter

        self._event_pb2, self._summary_pb2 = event_pb2, summary_pb2
        os.makedirs(path, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}"
        self._file = open(os.path.join(path, name), "wb")
        self._records = RecordWriter(self._file)
        self._write(file_version="brain.Event:2")

    def _write(self, **fields):
        event = self._event_pb2.Event(wall_time=time.time(), **fields)
        self._records.write(event.SerializeToString())

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        entry = self._summary_pb2.Summary.Value(tag=tag, simple_value=value)
        self._write(step=global_step, summary=self._summary_pb2.Summary(value=[entry]))

    def flush(self) -> None:
        self._records.flush()

    def close(self) -> None:
        self._records.close()


class MetricsLogger:
    """Console, JSONL (`<log_dir>/metrics.jsonl`, one record a step) and,
    with `tensorboard` where it is installed, TensorBoard scalars
    (`<log_dir>/tb`) under the JAX package's tags: each float of the record
    under its key, each list of floats as `key/i`."""

    def __init__(self, log_dir: Optional[str] = None, print_every: int = 20,
                 tensorboard: bool = True):
        self.print_every = print_every
        self.jsonl = None
        self.tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    self.tb = TensorBoardScalars(os.path.join(log_dir, "tb"))
                except ImportError:         # no `tensorboard` package
                    pass

    def log(self, step: int, metrics: dict, extra: Optional[dict] = None):
        record = {"step": step}
        for k, v in metrics.items():
            arr = np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
            record[k] = arr.tolist() if arr.ndim else float(arr)
        record.update(extra or {})
        if self.jsonl:
            self.jsonl.write(json.dumps(record) + "\n")
            self.jsonl.flush()
        if self.tb is not None:
            for k, v in record.items():
                if isinstance(v, float):
                    self.tb.add_scalar(k, v, global_step=step)
                elif isinstance(v, list) and v and isinstance(v[0], float):
                    for i, vi in enumerate(v):
                        self.tb.add_scalar(f"{k}/{i}", vi, global_step=step)
            self.tb.flush()
        if step % self.print_every == 0:
            print(f"step {step}: loss={record.get('loss', float('nan')):.4f} "
                  f"clips/s={record.get('clips_per_sec', 0.0):.1f}", flush=True)

    def close(self):
        if self.jsonl:
            self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


def _state_tensors(state: TrainState) -> list:
    """The tensors of the model (parameters, BatchNorm statistics) and of the
    optimizer state, in a fixed order."""
    out = list(state.model.state_dict().values())

    def walk(x):
        if torch.is_tensor(x):
            out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(state.opt_state)
    return out


def fit(cfg: StepConfig, loader, num_epochs: int = 1, ckpt_dir: Optional[str] = None,
        log_dir: Optional[str] = None, resume: bool = False, ckpt_every: int = 500,
        model: Optional[STEPDetector] = None, eval_fn: Optional[Callable] = None,
        eval_every_epochs: int = 1, seed: int = 0, handle_signals: bool = True,
        prefetch_upload: bool = False, device="cuda",
        pretrained_i3d: Optional[str] = None, mesh=None) -> TrainState:
    """Train `cfg` on `loader` (`data.loader.DataLoader`) for `num_epochs`
    or until `cfg.total_steps`, on `device` (the card unless the caller
    asks for the CPU). `model` is trained as given, else a new detector
    gets the training init from `seed`. With `resume` and a checkpoint in
    `ckpt_dir` the run continues from it. `eval_fn(state, epoch)` runs
    every `eval_every_epochs` epochs. `prefetch_upload` copies the next
    batch to the card (pinned, non-blocking) as soon as the current step
    is issued. `pretrained_i3d`, a torch I3D checkpoint file, loads the
    backbone (stems and every step's tail) before the first step and
    starts the optimizer moments anew on the loaded weights. `mesh`
    trains data-parallel on the mesh's ranks (the rank's card, or the CPU
    for a CPU mesh, in place of `device`); the global batch must divide
    over them. Returns the final state."""
    rank, group = 0, None
    if mesh is not None:
        group, rank, world = mesh_group(mesh)
        if cfg.batch_size % world:
            raise ValueError(f"global batch {cfg.batch_size} must divide over all "
                             f"{world} ranks")
        device = mesh_device(mesh)
    device = resolve_device(device)
    state = create_train_state(cfg, seed, model, device)
    if pretrained_i3d:
        loaded = pretrained_detector_variables(state.model.state_dict(), pretrained_i3d,
                                               cfg)
        # load_state_dict copies in place, so the derived caches (the BN
        # affine, K3's weight layout) see the new version and are remade
        state.model.load_state_dict(loaded)
        state.opt_state = state.optimizer.init(state.trainable(),
                                                  state.trainable_names())
        print(f"initialized backbone from {pretrained_i3d}", flush=True)
    start_epoch, start_batch = 0, 0
    if resume and ckpt_dir:
        try:
            state, data_iter = restore_checkpoint(ckpt_dir, state)
            start_epoch, start_batch = data_iter["epoch"], data_iter["batch_index"]
            print(f"resumed from step {state.step} (epoch {start_epoch}, "
                  f"batch {start_batch})", flush=True)
        except FileNotFoundError:
            pass

    def step_fn(state, batch):
        return train_step(state, batch, cfg)

    if mesh is not None:
        broadcast_tensors(_state_tensors(state), group)
        step_fn = make_parallel_train_step(cfg, state.model, mesh)
    logger = MetricsLogger(log_dir if rank == 0 else None)
    stop = {"signal": None}
    previous = {}
    if handle_signals and ckpt_dir:
        def on_signal(signum, frame):
            if stop["signal"] is not None:
                # a second signal: the loop is stuck short of a checkpoint;
                # restore the default action and let it act
                signal.signal(signum, previous.get(signum, signal.SIG_DFL))
                signal.raise_signal(signum)
                return
            stop["signal"] = signum

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, on_signal)
            except ValueError:          # not the main thread
                break

    pending: list = []
    t_window = time.time()

    def flush():
        # One host sync a window: the newest loss, read as a value, ends it.
        nonlocal t_window
        if pending:
            float(pending[-1][1]["loss"])
            cps = len(pending) * cfg.batch_size / max(time.time() - t_window, 1e-6)
            for s, m, extra in pending:
                logger.log(s, m, dict(extra, clips_per_sec=cps))
            pending.clear()
        t_window = time.time()

    def batches():
        for epoch in range(start_epoch, num_epochs):
            first = start_batch if epoch == start_epoch else 0
            for bi, batch in enumerate(loader.epoch(epoch, first), first):
                yield epoch, bi, batch

    def upload(item):
        return batch_to_device(item[2], device, non_blocking=prefetch_upload)

    def save(data_iter):
        # rank 0 writes; the others wait until the file is in place
        if rank == 0:
            save_checkpoint(ckpt_dir, state, data_iter)
        if group is not None:
            host_all_reduce([0], group)

    def epoch_end(epoch):
        flush()
        if eval_fn is not None and (epoch + 1) % eval_every_epochs == 0:
            print(f"epoch {epoch} eval: {eval_fn(state, epoch)}", flush=True)

    gen = batches()
    try:
        nxt = next(gen, None)
        nxt_dev = None
        while nxt is not None:
            epoch, bi, _ = nxt
            device_batch = nxt_dev if nxt_dev is not None else upload(nxt)
            state, metrics = step_fn(state, device_batch)
            nxt = next(gen, None)
            nxt_dev = upload(nxt) if (nxt is not None and prefetch_upload) else None
            pending.append((state.step, metrics, {"epoch": epoch, "batch_index": bi}))
            done = state.step >= cfg.total_steps
            preempted = stop["signal"] is not None
            if group is not None and handle_signals and ckpt_dir:
                # every rank stops after the same step, or the others would
                # wait forever in the next step's collectives
                seen = host_all_reduce([stop["signal"] or 0], group, ReduceOp.MAX)
                preempted = bool(seen[0])
                stop["signal"] = int(seen[0]) or None
            if len(pending) >= logger.print_every or done or preempted:
                flush()
            if preempted:
                save({"epoch": epoch, "batch_index": bi + 1})
                print(f"signal {stop['signal']}: checkpointed at step {state.step} "
                      f"(epoch {epoch}, batch {bi + 1}); resume with resume=True",
                      flush=True)
                return state
            if ckpt_dir and state.step % ckpt_every == 0:
                flush()
                save({"epoch": epoch, "batch_index": bi + 1})
            if done:
                epoch_end(epoch)
                break
            if nxt is None or nxt[0] != epoch:
                epoch_end(epoch)
        flush()
        if ckpt_dir:
            save({"epoch": num_epochs, "batch_index": 0})
    finally:
        gen.close()                     # stops the loader's prefetch thread
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        logger.close()
    return state
