from senas_torch.parallel.collectives import (
    activate,
    active_mesh,
    all_reduce_sum,
    gather_batch,
)
from senas_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    batch_sharding,
    initialize_distributed,
    make_mesh,
    place_state,
    replicate,
    shard_batch,
    shard_train_step,
)
