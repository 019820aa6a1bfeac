"""Data parallelism: one process per card in a `torch.distributed` process
group, and a one-axis `DeviceMesh` ("data") over its ranks.

Port of `step_tpu/parallel/`. The JAX package shards one global batch over
a mesh of devices and lets GSPMD insert the collectives; here each rank
holds its rows of the global batch on its own card, and the collectives
are written out: the gradient all-reduce of the parallel train step
(`train/trainer.py::make_parallel_train_step`), BatchNorm's batch sums
(`models/i3d.py::BatchNorm`), the detections gathered in sharded
evaluation (`inference.make_parallel_detect_fn`). GSPMD's
`batch_sharding`, `replicated_sharding` and `shard_batch` name shardings
of one array over many devices, which a process-per-card runtime does not
have; they are not carried (ROADMAP M12).
"""

from step_tpu_torch.parallel.distributed import (  # noqa: F401
    init_distributed,
    make_global_batch,
    process_shard,
)
from step_tpu_torch.parallel.mesh import create_mesh, mesh_device  # noqa: F401
