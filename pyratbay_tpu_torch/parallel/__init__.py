"""Several processes: the torch.distributed bootstrap (distributed.py),
the (chains, wave) mesh and the wave-sharded retrieval (sharded.py),
and the multi-process throughput probe (mp_probe.py)."""
from .sharded import (
    make_mesh,
    shard_model_tables,
    sharded_retrieval_step,
    build_flagship_sharded,
)
