"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 -- parallel attention + mamba heads per block, sliding-window
attention with sparse global layers.  Meta tokens are omitted (stub note in
DESIGN.md).  [arXiv:2411.13676; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    attn_pattern="local_global",
    sliding_window=1024,
    global_every=16,       # sparse global layers
    ssm_state=16,
    ssm_conv=4,
    mlp_kind="swiglu",
)
