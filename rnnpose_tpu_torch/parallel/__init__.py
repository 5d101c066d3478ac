"""Data parallelism over processes: the process group, batch sharding,
parameter replication, the gradient all-reduce and the metric gather."""
