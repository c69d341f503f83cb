"""Channel scenario processes: how per-period wireless state evolves.

The paper's §VI setup redraws every channel i.i.d. each period; the
correlated processes rebuild the period's ServiceSet from the period's raw
draws (``network.ServiceDraws``), swapping only the path-loss normals and
adding a fading term, so every non-channel draw (model sizes, powers,
compute times) is the i.i.d. period's:

* ``iid`` -- the identity (state ``()``): keeps the period's sample;
* ``gauss_markov`` -- AR(1) Gauss-Markov shadowing on the path-loss
  normals, z' = rho z + sqrt(1 - rho^2) eps, with eps the very normals the
  i.i.d. draw holds; rho = 0 reproduces the i.i.d. set;
* ``rayleigh_block`` -- a complex Gaussian tap h per client with AR(1)
  coherence, adding the fading margin -10 log10 |h|^2 dB to the
  (optionally also correlated) shadowing.  E|h|^2 = 1.

Random numbers beyond the period's raw draws come from the source's
``"fade_re"``/``"fade_im"`` streams and, for the initial states, the
``"init_*"`` streams (``base.STREAMS``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import network
from repro_torch.scenarios.base import Process, register

_ONE_OVER_LOG10 = 0.4342944819032518


def _validate_rho(rho: float, name: str) -> float:
    rho = float(rho)
    if not 0.0 <= rho < 1.0:
        raise ValueError(f"{name} must be in [0, 1), got {rho}")
    return rho


@register("channel", "iid")
def iid():
    """Identity: keep the period's i.i.d. base sample (paper default)."""

    def init(source, n, k):
        return ()

    def step(source, state, svc):
        return state, svc

    return Process(init, step)


def _ar1(z: torch.Tensor, eps: torch.Tensor, rho: float) -> torch.Tensor:
    """rho z + sqrt(1 - rho^2) eps, the root taken in float32 as the
    reference takes it (a float32 value, so exact as a Python float)."""
    c = float(torch.sqrt(torch.tensor(1.0 - rho * rho, dtype=torch.float32)))
    return rho * z + c * eps


def fading_margin_db(h_re: torch.Tensor, h_im: torch.Tensor,
                     gain_floor: float) -> torch.Tensor:
    """Rayleigh fading margin -10 log10 |h|^2 in dB, deep fades clamped at
    -10 log10(gain_floor).  log10 is log(x) times 1/log(10) in float32,
    as the reference computes it."""
    power = torch.clamp(h_re * h_re + h_im * h_im, min=gain_floor)
    return -10.0 * (torch.log(power) * _ONE_OVER_LOG10)


def _shadowing_init(source, n, k):
    return (source.normal("init_shadow_service", (n, 1)),
            source.normal("init_shadow_client", (n, k)))


@register("channel", "gauss_markov")
def gauss_markov(net, rho: float = 0.95, rho_service: float | None = None):
    """Gauss-Markov shadowing: AR(1) on the path-loss innovations.

    ``rho`` correlates the per-client spread, ``rho_service`` the
    across-service mean path loss (default ``rho``).  Stationary N(0, 1)
    in both, so every period is distributed as in §VI.A.
    """
    rho_c = _validate_rho(rho, "rho")
    rho_s = _validate_rho(rho if rho_service is None else rho_service,
                          "rho_service")

    def step(source, state, draws: network.ServiceDraws):
        z_s = _ar1(state[0], draws.eps_service, rho_s)
        z_c = _ar1(state[1], draws.eps_client, rho_c)
        svc, _ = network.services_from_draws(
            *draws._replace(eps_service=z_s, eps_client=z_c), net)
        return (z_s, z_c), svc

    return Process(_shadowing_init, step, rebuilds=True)


@register("channel", "rayleigh_block")
def rayleigh_block(net, rho: float = 0.9, shadowing_rho: float | None = None,
                   floor_db: float = -40.0):
    """Correlated Rayleigh fast fading on top of (optionally AR(1))
    shadowing: h' = rho h + sqrt(1 - rho^2) w, w ~ CN(0, 1); the path loss
    gains -10 log10 |h|^2 dB, clamped at ``floor_db``.  ``shadowing_rho``
    also threads the Gauss-Markov shadowing state; None keeps shadowing
    i.i.d."""
    rho_h = _validate_rho(rho, "rho")
    rho_sh = None if shadowing_rho is None else _validate_rho(
        shadowing_rho, "shadowing_rho")
    gain_floor = 10.0 ** (float(floor_db) / 10.0)
    inv = math.sqrt(0.5)

    def init(source, n, k):
        h = (inv * source.normal("init_fade_re", (n, k)),
             inv * source.normal("init_fade_im", (n, k)))
        return h if rho_sh is None else h + _shadowing_init(source, n, k)

    def step(source, state, draws: network.ServiceDraws):
        shape = tuple(state[0].shape)
        h_re = _ar1(state[0], inv * source.normal("fade_re", shape), rho_h)
        h_im = _ar1(state[1], inv * source.normal("fade_im", shape), rho_h)
        state2 = (h_re, h_im)
        if rho_sh is not None:
            z_s = _ar1(state[2], draws.eps_service, rho_sh)
            z_c = _ar1(state[3], draws.eps_client, rho_sh)
            draws = draws._replace(eps_service=z_s, eps_client=z_c)
            state2 = state2 + (z_s, z_c)
        svc, _ = network.services_from_draws(
            *draws, net,
            extra_pathloss_db=fading_margin_db(h_re, h_im, gain_floor))
        return state2, svc

    return Process(init, step, rebuilds=True)
