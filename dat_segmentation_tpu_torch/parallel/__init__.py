"""Scale-out: data parallelism and ZeRO (fsdp) over ``torch.distributed``."""

from .mesh import (
    destroy_distributed,
    init_distributed,
    local_batch_size,
    process_shard_info,
    resolve_mesh,
)
