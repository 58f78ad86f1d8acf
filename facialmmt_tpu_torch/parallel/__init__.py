"""Multi-device runs over torch.distributed (counterpart of
facialmmt_tpu/parallel/): the (data, model) mesh, batch sharding, the
tensor-parallel rules and ZeRO-1 (mesh.py), the collectives (comm.py), and
the data shard a forward runs under (context.py)."""
