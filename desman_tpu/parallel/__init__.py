"""Multi-device execution: chain x position sharding over a device mesh."""

from .mesh import make_mesh, shard_counts, shard_keys
from .sharded import (
    make_pallas_sweep_sharded, run_chain_pt_sharded,
    run_chain_pt_sharded_checkpointed, run_chain_sharded_checkpointed,
    run_chains_sharded, run_chains_sharded_checkpointed,
)

__all__ = [
    "make_mesh", "shard_counts", "shard_keys", "run_chains_sharded",
    "run_chain_pt_sharded", "run_chain_pt_sharded_checkpointed",
    "run_chain_sharded_checkpointed",
    "run_chains_sharded_checkpointed", "make_pallas_sweep_sharded",
]
