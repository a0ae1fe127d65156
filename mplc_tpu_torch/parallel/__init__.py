"""Scale-out across ranks and processes (port of `mplc_tpu/parallel/`).

`mesh` lays the launcher's world of ranks (one process a card, over
`torch.distributed`) out as the coalition x partner mesh (`make_mesh`,
`make_2d_mesh`, `make_multihost_mesh`, `CoalitionSharding`,
`coalition_sharding`), and `partner_shard` splits one coalition's
partners over a mesh axis (`PartnerShardedTrainer`); `launch` starts N
ranks on one host and runs the several-card self-check. `fleet` holds the
fleet sweep, one sweep cut into W coalition slices at the engine's
buckets, each run in its own worker process (on the card by default, each
its own CUDA context) with its own value ledger and crash journal, then
merged under a ledger-checked equality proof (`fleet.run_fleet`, the
worker and selfcheck CLI `python3 -m mplc_tpu_torch.parallel.fleet`), and
the fleet's state plane (each service process publishes its queue state
into a shared folder and reads the cluster's view back). Reach it as
`parallel.fleet`, as in the JAX package.
"""

from .mesh import (CoalitionSharding, coalition_sharding, make_2d_mesh, make_mesh,
                   make_multihost_mesh)
from .partner_shard import PartnerShardedTrainer

__all__ = ["CoalitionSharding", "coalition_sharding", "make_mesh",
           "make_2d_mesh", "make_multihost_mesh", "PartnerShardedTrainer"]
