"""Carry state across from the JAX reference package.

This system's parameters are its service sets, its network configuration
and the warm solver's dual state; these helpers turn the reference
package's values, handed over as numpy arrays or plain dicts, into this
package's.  Nothing here imports the reference package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.network import NetworkConfig
from repro_torch.core.policy import WarmDualState
from repro_torch.core.types import ServiceSet


def service_set_from_arrays(alpha, t_comp, mask, alpha_ul=None, *,
                            device) -> ServiceSet:
    """A reference ServiceSet given as numpy arrays -> this package's, with
    the values unchanged (float32 alpha/t_comp/alpha_ul, bool mask)."""

    def f32(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    return ServiceSet(
        alpha=f32(alpha), t_comp=f32(t_comp),
        mask=torch.as_tensor(np.array(mask, dtype=bool), device=device),
        alpha_ul=None if alpha_ul is None else f32(alpha_ul))


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
