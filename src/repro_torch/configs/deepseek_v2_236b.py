"""deepseek-v2-236b [moe]: 60L d_model=5120 128H, MLA (kv_lora=512,
q_lora=1536, rope_head_dim=64, nope=128, v=128), d_ff_expert=1536,
vocab=102400, MoE 160 routed top-6 + 2 shared, 1 leading dense layer
(d_ff=12288).  [arXiv:2405.04434; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="mla_moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,          # nope qk dim
    rope_head_dim=64,
    v_head_dim=128,
    kv_lora_rank=512,
    q_lora_rank=1536,
    d_ff=12288,            # the leading dense layer
    d_ff_expert=1536,
    vocab_size=102_400,
    n_experts=160,
    n_experts_per_token=6,
    n_shared_experts=2,
    n_dense_leading=1,
    moe_every=1,
    capacity_factor=1.0,
    mlp_kind="swiglu",
)
