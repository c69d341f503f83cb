"""Distribution layer: collectives over the named axes of a rank mesh
(hierarchical and int8-compressed), elastic re-meshing, fault tolerance.
The per-architecture sharding rules (``sharding``) and the mesh context
(``api``) are ROADMAP Queue A item 12b, not ported yet."""
from repro_torch.distributed import collectives, elastic, fault  # noqa: F401
