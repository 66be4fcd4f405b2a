"""Data-parallel and spatial-parallel training and inference on
torch.distributed (the port of ``tdrn_tpu/parallel``): the mesh and its
sharding (mesh.py), the multi-process bootstrap (distributed.py), the
H-split forward (spatial.py) and the multi-process dry run (dryrun.py)."""

from tdrn_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    all_reduce_sum_,
    batch_sharding,
    clip_batch_sharding,
    make_mesh,
    replicate_tree,
    replicated,
    shard_batch_tree,
)
from tdrn_tpu_torch.parallel.distributed import (  # noqa: F401
    global_batch_to_local,
    init_distributed,
    local_device,
    process_count,
    process_index,
)
