"""Distribution substrate of the language models: the parallel config, the
sharding rules and the collectives the sharded blocks issue."""
from repro_torch.distributed.parallel import (
    AbstractMesh,
    ParallelConfig,
    single_device_parallel,
)

__all__ = ["AbstractMesh", "ParallelConfig", "single_device_parallel"]
