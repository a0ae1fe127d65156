"""Scale-out across processes. The port holds the fleet's state plane
(fleet.py: each service process publishes its queue state into a shared
folder and reads the cluster's view back); the JAX package's fleet sweeps
and mesh plumbing are ROADMAP.md queue 1 item 10."""
