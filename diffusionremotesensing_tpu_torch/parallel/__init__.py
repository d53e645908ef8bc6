"""Data and tensor parallelism (port of ``diffusionremotesensing_tpu/parallel``)."""

from diffusionremotesensing_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    batch_sharding,
    global_replicated,
    initialize_distributed,
    is_main_process,
    make_mesh,
    replicated_sharding,
    shard_batch,
    spatial_sharding,
)
