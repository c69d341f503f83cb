"""Carry state across from the JAX reference package.

This system's parameters are its service sets, its network configuration,
the warm solver's dual state, the auction's bid books, the scenario
processes' states and the model zoo's weights; these helpers turn the
reference package's values, handed over as numpy arrays or plain dicts,
into this package's.  Nothing here imports the reference package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.auction import MultiBid
from repro_torch.core.network import NetworkConfig
from repro_torch.core.policy import WarmDualState
from repro_torch.core.types import ServiceSet
from repro_torch.models.config import ModelConfig


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def service_set_from_arrays(alpha, t_comp, mask, alpha_ul=None, *,
                            device) -> ServiceSet:
    """A reference ServiceSet given as numpy arrays -> this package's, with
    the values unchanged (float32 alpha/t_comp/alpha_ul, bool mask)."""
    return ServiceSet(
        alpha=_f32(alpha, device), t_comp=_f32(t_comp, device),
        mask=torch.as_tensor(np.array(mask, dtype=bool), device=device),
        alpha_ul=None if alpha_ul is None else _f32(alpha_ul, device))


def warm_state_from_arrays(lam, fallbacks, *, device) -> WarmDualState:
    """A reference ``WarmDualState`` (lam, fallbacks) -> this package's."""
    return WarmDualState(
        lam=torch.tensor(float(np.asarray(lam, dtype=np.float32)),
                         dtype=torch.float32, device=device),
        fallbacks=torch.tensor(int(np.asarray(fallbacks)), dtype=torch.int32,
                               device=device))


def network_config_from_dict(d: dict) -> NetworkConfig:
    """A reference ``NetworkConfig`` as ``dataclasses.asdict`` -> this
    package's.  Unknown or missing fields raise, so the two cannot drift
    apart silently."""
    names = {f.name for f in dataclasses.fields(NetworkConfig)}
    if set(d) != names:
        raise ValueError(
            f"NetworkConfig fields differ: unknown {sorted(set(d) - names)}, "
            f"missing {sorted(names - set(d))}")
    return NetworkConfig(**d)


def multibid_from_arrays(prices, demands, *, device) -> MultiBid:
    """A reference ``MultiBid`` (prices, demands), (N, M) each -> this
    package's, values unchanged."""
    return MultiBid(prices=_f32(prices, device), demands=_f32(demands, device))


def gauss_markov_state_from_arrays(z_s, z_c, *, device):
    """The ``gauss_markov`` channel state (z_s (N, 1), z_c (N, K))."""
    return _f32(z_s, device), _f32(z_c, device)


def rayleigh_state_from_arrays(h_re, h_im, z_s=None, z_c=None, *, device):
    """The ``rayleigh_block`` channel state (h_re, h_im (N, K)), with the
    shadowing pair (z_s, z_c) when ``shadowing_rho`` is set."""
    state = (_f32(h_re, device), _f32(h_im, device))
    if (z_s is None) != (z_c is None):
        raise ValueError("pass z_s and z_c together (or neither)")
    if z_s is None:
        return state
    return state + gauss_markov_state_from_arrays(z_s, z_c, device=device)


def gilbert_state_from_arrays(avail, *, device) -> torch.Tensor:
    """The ``gilbert`` churn state: the (N, K) bool availability."""
    return torch.as_tensor(np.array(avail, dtype=bool), device=device)


def _stacked_layers(sub: dict, n: int, device) -> list[dict]:
    """A JAX group of ``n`` layers stacked on axis 0 -> a list of ``n``
    per-layer dicts of float32 tensors."""
    def layer(tree, i):
        return {key: layer(x, i) if isinstance(x, dict) else _f32(x[i], device)
                for key, x in tree.items()}

    return [layer(sub, i) for i in range(n)]


def _n_stacked(sub: dict) -> int:
    return len(np.asarray(sub["ln1"]))


def causal_lm_params_from_arrays(tree: dict, cfg: ModelConfig, *,
                                 device) -> dict:
    """The JAX ``CausalLM.init`` tree, as numpy arrays -> this package's
    parameters, values unchanged (float32).  The JAX tree stacks layers on
    a leading axis: ``"blocks"`` (dense), ``"pairs"`` (``"dense"`` and
    ``"moe"`` stacks of the (dense, MoE) pairs, interleaved here) or
    ``"lead"`` dense layers then MoE ``"blocks"``; the port keeps one list
    of per-layer dicts.  Routed expert stacks, shared experts, MLA and SSM
    leaves come across as they are.  Other groups raise."""
    extra = set(tree) - {"embed", "ln_f", "unembed", "blocks", "pairs",
                         "lead"}
    if extra:
        raise ValueError(f"unknown parameter groups {sorted(extra)}")
    if "pairs" in tree:
        pairs = tree["pairs"]
        n = _n_stacked(pairs["dense"])
        dense = _stacked_layers(pairs["dense"], n, device)
        moe = _stacked_layers(pairs["moe"], n, device)
        blocks = [layer for pair in zip(dense, moe) for layer in pair]
    else:
        blocks = []
        if "lead" in tree:
            blocks += _stacked_layers(tree["lead"], _n_stacked(tree["lead"]),
                                      device)
        blocks += _stacked_layers(tree["blocks"], _n_stacked(tree["blocks"]),
                                  device)
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"tree has {len(blocks)} layers, config "
                         f"{cfg.n_layers}")
    params = {key: _f32(tree[key], device) for key in ("embed", "ln_f",
                                                       "unembed")
              if key in tree}
    params["blocks"] = blocks
    return params


def seq2seq_params_from_arrays(tree: dict, cfg: ModelConfig, *,
                               device) -> dict:
    """The JAX ``Seq2SeqLM.init`` tree, as numpy arrays -> this package's
    parameters, values unchanged (float32): ``"enc_blocks"`` and
    ``"dec_blocks"`` stacked on axis 0 there, lists here."""
    keys = {"embed", "ln_enc", "ln_f", "enc_blocks", "dec_blocks"}
    if set(tree) != keys:
        raise ValueError(f"parameter groups {sorted(tree)}, expected "
                         f"{sorted(keys)}")
    n_enc, n_dec = _n_stacked(tree["enc_blocks"]), _n_stacked(
        tree["dec_blocks"])
    if (n_enc, n_dec) != (cfg.n_encoder_layers, cfg.n_layers):
        raise ValueError(f"tree has {n_enc} + {n_dec} layers, config "
                         f"{cfg.n_encoder_layers} + {cfg.n_layers}")
    params = {key: _f32(tree[key], device) for key in ("embed", "ln_enc",
                                                       "ln_f")}
    params["enc_blocks"] = _stacked_layers(tree["enc_blocks"], n_enc, device)
    params["dec_blocks"] = _stacked_layers(tree["dec_blocks"], n_dec, device)
    return params


def xlstm_params_from_arrays(tree: dict, cfg: ModelConfig, *,
                             device) -> dict:
    """The JAX ``XLSTMLM.init`` tree, as numpy arrays -> this package's
    parameters, values unchanged (float32).  The JAX tree stacks
    ``"m_blocks"`` on (n_super, n_mlstm) and ``"s_blocks"`` on (n_super,);
    the port keeps a list of n_super lists of mLSTM block dicts and a list
    of n_super sLSTM block dicts."""
    extra = set(tree) - {"embed", "ln_f", "unembed", "m_blocks", "s_blocks"}
    if extra:
        raise ValueError(f"unknown parameter groups {sorted(extra)}")

    def leaf(x):
        return _f32(x, device)

    def block(sub, index):
        return {key: block(x, index) if isinstance(x, dict) else leaf(x[index])
                for key, x in sub.items()}

    n_super, n_m = np.asarray(tree["m_blocks"]["ln"]).shape[:2]
    want_m = (cfg.n_layers // cfg.slstm_every if cfg.slstm_every > 0 else 1,
              cfg.slstm_every - 1 if cfg.slstm_every > 0 else cfg.n_layers)
    if (n_super, n_m) != want_m or ("s_blocks" in tree) != (cfg.slstm_every > 0):
        raise ValueError(f"tree has {n_super} x {n_m} mLSTM blocks and "
                         f"{'an' if 's_blocks' in tree else 'no'} sLSTM stack; "
                         f"config {cfg.name!r} wants {want_m[0]} x {want_m[1]}")
    params = {key: leaf(tree[key]) for key in ("embed", "ln_f", "unembed")
              if key in tree}
    params["m_blocks"] = [[block(tree["m_blocks"], (si, li))
                           for li in range(n_m)] for si in range(n_super)]
    if "s_blocks" in tree:
        params["s_blocks"] = [block(tree["s_blocks"], si)
                              for si in range(n_super)]
    return params
