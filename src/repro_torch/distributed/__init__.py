"""Distribution layer.  Only the fault-tolerance module is ported so far;
the sharding rules, collectives and elastic re-meshing are not."""
from repro_torch.distributed import fault  # noqa: F401
