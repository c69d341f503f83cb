"""seamless-m4t-large-v2 [audio]: enc-dec, 24+24L d_model=1024 16H (MHA)
d_ff=8192 vocab=256206.  Audio frontend is a STUB (precomputed frame
embeddings); conformer convs live in the stubbed frontend (DESIGN.md §3).
[arXiv:2308.11596; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    frontend="audio",
    mlp_kind="gelu",
)
