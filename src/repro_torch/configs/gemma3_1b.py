"""gemma3-1b [dense]: 26L d_model=1152 4H (MQA kv=1) d_ff=6912 vocab=262144.
5:1 local:global sliding-window interleave, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    attn_pattern="local_global",
    sliding_window=1024,
    global_every=6,          # 5 local : 1 global
    rope_theta=1_000_000.0,
    qk_norm=True,
    post_norm=True,
    embed_scale=True,
    mlp_kind="geglu",
)
