"""Distribution on ``torch.distributed``: port of ``tssep_tpu/dist``
(``mesh``: the rank grid and the sharding rules; ``multihost``: the
process group, the collectives and the host-sharded data)."""
