"""xlstm-1.3b [ssm]: 48 blocks d_model=2048 4H vocab=50304, no FFN on mLSTM
blocks (pf=2 up-projection inside), 1 sLSTM block per 8 (7:1 m:s ratio).
The mLSTM cell works on d_inner = ssm_expand x d_model = 4096, so its heads
are 1024 wide; ``head_dim`` 512 is the sLSTM's (d_model / n_heads).
[arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50_304,
    ssm_expand=2,
    ssm_conv=4,
    slstm_every=8,
)
