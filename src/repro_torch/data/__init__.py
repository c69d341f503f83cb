"""Data pipeline: a synthetic bigram token stream drawn on the host, and
Dirichlet non-IID federated partitioning."""
from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLM,
    dirichlet_partition,
    federated_batches,
)
