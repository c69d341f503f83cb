"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff_expert=8192 vocab=202048, MoE 128 routed top-1 + 1 shared, alternating
dense/MoE layers (dense d_ff=16384).  Early-fusion multimodal -- text backbone
only here per the brief.  [hf:meta-llama/Llama-4; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,           # dense (non-MoE) layers
    d_ff_expert=8192,     # routed + shared experts
    vocab_size=202_048,
    n_experts=128,
    n_experts_per_token=1,
    n_shared_experts=1,
    moe_every=2,          # alternate dense / MoE
    rope_theta=500_000.0,
    mlp_kind="swiglu",
)
