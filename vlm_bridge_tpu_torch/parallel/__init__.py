"""The process group and the ("data", "model") mesh of data-parallel training
and eval (port of vlm_bridge_tpu.parallel over torch.distributed)."""

from vlm_bridge_tpu_torch.parallel.distributed import (  # noqa: F401
    init_multihost,
    process_info,
)
from vlm_bridge_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    auto_mesh,
    batch_sharding,
    param_shardings,
    replicate,
    shard_batch,
    shard_params,
)
