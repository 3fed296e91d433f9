"""The executor-fleet cluster plane (port of the JAX package's
``cluster/``): rendezvous, per-node queue managers, compute supervision
and the driver's cluster API.  Nothing here imports ``torch`` at module
level: only the spawned compute process touches the GPU."""
