"""Scale-out across processes (port of `mplc_tpu/parallel/`).

`fleet` holds the fleet sweep, one sweep cut into W coalition slices at
the engine's buckets, each run in its own worker process (on the card by
default, each its own CUDA context) with its own value ledger and crash
journal, then merged under a ledger-checked equality proof
(`fleet.run_fleet`, the worker and selfcheck CLI `python3 -m
mplc_tpu_torch.parallel.fleet`), and the fleet's state plane (each service
process publishes its queue state into a shared folder and reads the
cluster's view back). Reach it as `parallel.fleet`, as in the JAX package.

The JAX package's exports here, the coalition x partner mesh
(`make_mesh`, `make_2d_mesh`, `make_multihost_mesh`, `CoalitionSharding`,
`coalition_sharding`) and `PartnerShardedTrainer`, are the second half of
ROADMAP.md queue 1 item 10, so `__all__` is empty until that slice.
"""

__all__: list = []
