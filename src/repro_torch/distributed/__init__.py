"""Distribution of the port: the sharding rules (``sharding``) and the
one-controller collectives over per-shard tensors (``collectives``)."""
