"""Pure-tree optimizers, the counterpart of ``repro.optim``: AdamW,
SGD + momentum, cosine / linear-warmup schedules, global-norm clipping."""
from repro_torch.optim.optimizers import (  # noqa: F401
    OptState,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    linear_warmup_cosine,
    sgd,
)
