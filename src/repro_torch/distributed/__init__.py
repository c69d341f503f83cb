"""Distribution layer: per-architecture sharding rules (DP/FSDP/TP/EP/SP)
and the mesh context models constrain against, collectives over the named
axes of a rank mesh (hierarchical and int8-compressed), fault tolerance,
elastic re-meshing and resharding."""
from repro_torch.distributed.sharding import (  # noqa: F401
    batch_shardings,
    cache_shardings,
    param_shardings,
)
from repro_torch.distributed import (  # noqa: F401
    api,
    collectives,
    elastic,
    fault,
)
