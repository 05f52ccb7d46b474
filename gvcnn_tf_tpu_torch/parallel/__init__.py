"""Data parallelism of the port: one process per card (counterpart of
`gvcnn_tf_tpu/parallel/`, whose 1-D `data` mesh and XLA-inserted
collectives become a `World` of ranks and explicit all-reduces)."""

from gvcnn_tf_tpu_torch.parallel.mesh import (  # noqa: F401
    World,
    check_num_devices,
)
from gvcnn_tf_tpu_torch.parallel.multihost import (  # noqa: F401
    initialize_distributed,
    launch_env,
    rank_rows,
    shutdown,
    spawn,
)
