"""Unified architecture configuration, the counterpart of
``repro.models.config``.

One dataclass parameterizes the dense / MoE / MLA / SSM / hybrid / enc-dec
families, field for field as in the JAX package, so a configuration reads
the same in both.  The dense and SSM (xLSTM) families are ported
(``check_ported`` raises for the others and for unported features).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

Family = Literal["dense", "moe", "mla_moe", "ssm", "hybrid", "encdec"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention flavour ---
    attn_pattern: str = "full"        # full | sliding | local_global
    sliding_window: int = 0
    global_every: int = 0             # local_global: 1 global per this many layers
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = ()   # Qwen2-VL M-RoPE half-dim sections
    qkv_bias: bool = False
    qk_norm: bool = False
    logit_softcap: float = 0.0
    parallel_block: bool = False      # Command-R style parallel attn+FFN

    # --- MLP flavour ---
    mlp_kind: str = "swiglu"          # swiglu | geglu | gelu

    # --- MoE ---
    n_experts: int = 0
    n_experts_per_token: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1                # MoE layer period (2 = alternate dense/MoE)
    n_dense_leading: int = 0          # DeepSeek: first k layers stay dense
    capacity_factor: float = 1.25

    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM / recurrent ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0              # xLSTM: 1 sLSTM block per this many blocks

    # --- hybrid (Hymba) ---
    n_ssm_heads: int = 0

    # --- enc-dec (Seamless) ---
    n_encoder_layers: int = 0

    # --- modality frontends (stub) ---
    frontend: str = "none"            # none | vision | audio

    # --- numerics / execution ---
    norm_eps: float = 1e-6
    post_norm: bool = False           # gemma3 sandwich norms
    embed_scale: bool = False         # gemma: embeddings scaled by sqrt(d)
    kv_cache_dtype: str = "compute"   # "compute" | "int8" (per-token/head scales)
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    remat: bool = True                # no counterpart: the port has no backward yet
    use_pallas: bool = False          # read nowhere, as in the JAX package

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def is_global_layer(self, i: int) -> bool:
        if self.attn_pattern == "full":
            return True
        if self.attn_pattern == "sliding":
            return False
        # local_global: every ``global_every``-th layer is global (gemma3: 6th)
        return (i % self.global_every) == (self.global_every - 1)

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0 or i < self.n_dense_leading:
            return False
        return ((i - self.n_dense_leading) % self.moe_every) == (self.moe_every - 1)

    def param_count(self) -> int:
        """Exact parameter count, from the port's own parameter shapes
        (``init`` on the meta device allocates nothing)."""
        from repro_torch.models import registry  # lazy: avoid cycle

        params = registry.build_model(self).init(0, device="meta")
        return sum(math.prod(x.shape) for x in _leaves(params))


PORTED_FAMILIES = ("dense", "ssm")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for the parts of the config this port does not run yet."""
    missing = []
    if cfg.family not in PORTED_FAMILIES:
        missing.append(f"family {cfg.family!r}")
    if cfg.n_experts:
        missing.append("MoE layers")
    if cfg.kv_cache_dtype != "compute":
        missing.append(f"kv_cache_dtype={cfg.kv_cache_dtype!r}")
    if cfg.mrope_sections:
        missing.append("M-RoPE")
    if cfg.logit_softcap > 0:
        missing.append("logit_softcap")
    if cfg.parallel_block:
        missing.append("parallel_block")
    if cfg.frontend != "none":
        missing.append(f"frontend {cfg.frontend!r}")
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not yet "
                                  f"ported")


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    else:
        yield tree


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized config of the same family (the JAX package's
    ``reduced``, field for field)."""
    small = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        n_experts_per_token=min(cfg.n_experts_per_token, 2),
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        q_lora_rank=48 if cfg.q_lora_rank else 0,
        rope_head_dim=16 if cfg.rope_head_dim else 0,
        v_head_dim=32 if cfg.v_head_dim else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        n_ssm_heads=2 if cfg.n_ssm_heads else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        mrope_sections=(8, 4, 4) if cfg.mrope_sections else (),
        capacity_factor=4.0 if cfg.n_experts else cfg.capacity_factor,
        dtype="float32",
        remat=False,
    )
    if cfg.global_every:
        small["global_every"] = min(cfg.global_every, 2)
    if cfg.slstm_every:
        small["slstm_every"] = min(cfg.slstm_every, 2)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
