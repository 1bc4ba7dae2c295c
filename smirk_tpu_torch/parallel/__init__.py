"""Data-parallel training over torch.distributed (port of
smirk_tpu/parallel): see `mesh`. `dryrun` is the CPU rehearsal of a
multi-process step (`python -m smirk_tpu_torch.parallel.dryrun N`)."""
from smirk_tpu_torch.parallel.mesh import (  # noqa: F401
    active, all_gather_rows, all_reduce_grads, all_sum, global_moments,
    initialize_distributed, is_main, local_rows, process_device, rank, record,
    reduce_metrics, replicate, share, shard_batch, shutdown, world_size,
)
