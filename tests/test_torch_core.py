"""Differential tests of the port's allocation core against the JAX package.

The same inputs, made with numpy from a seed, go through ``repro`` and
``repro_torch`` (on the CPU); outputs agree at the tolerances the JAX
package uses between its kernels and ``kernels/ref.py``: t* rtol 1e-4,
splits and b rtol 1e-3 / atol 1e-4, f rtol 1e-3 / atol 1e-5.

Also the import guard: neither the port nor ``chip_smoke.py`` may import
``jax`` or the reference package.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as j_baselines
from repro.core import intra as j_intra
from repro.core import network as j_network
from repro.core import types as j_types
from repro_torch import interop
from repro_torch.core import baselines, intra, network, types

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _arrays(seed, n=6, k=11, inactive=True):
    """Ragged masked set as numpy arrays; masked slots carry alpha = t^C = 0
    (the convention of mask_inactive / mask_clients)."""
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0.01, 0.3, size=(n, k)).astype(np.float32)
    t_comp = rng.uniform(0.01, 0.06, size=(n, k)).astype(np.float32)
    mask = np.zeros((n, k), dtype=bool)
    for i in range(n):
        mask[i, : rng.integers(2, k + 1)] = True
    if inactive:
        mask[rng.integers(0, n)] = False
    return (np.where(mask, alpha, 0.0).astype(np.float32),
            np.where(mask, t_comp, 0.0).astype(np.float32), mask)


def _pair(seed, **kw):
    a, t, m = _arrays(seed, **kw)
    j = j_types.ServiceSet(alpha=jnp.asarray(a), t_comp=jnp.asarray(t),
                           mask=jnp.asarray(m))
    return j, interop.service_set_from_arrays(a, t, m, device=CPU)


def _close(port, ref, rtol, atol=0.0):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------

def test_service_set_reductions_match():
    j, t = _pair(0)
    _close(t.alpha_sum(), j.alpha_sum(), rtol=1e-6)
    _close(t.t_comp_max(), j.t_comp_max(), rtol=0)
    assert np.array_equal(t.client_counts().numpy(), np.asarray(j.client_counts()))
    assert np.array_equal(t.service_active().numpy(),
                          np.asarray(j.service_active()))


def test_make_service_set_and_masks_match():
    a, tc, m = _arrays(1)
    aul = 0.5 * a
    j = j_types.make_service_set(a, tc, m, alpha_ul=aul)
    t = types.make_service_set(a, tc, m, alpha_ul=aul, device=CPU)
    active = np.array([True, False, True, True, False, True])
    avail = np.random.default_rng(2).uniform(size=a.shape) > 0.3
    for jj, tt in [(j, t),
                   (j_types.mask_inactive(j, jnp.asarray(active)),
                    types.mask_inactive(t, torch.as_tensor(active))),
                   (j_types.mask_clients(j, jnp.asarray(avail)),
                    types.mask_clients(t, torch.as_tensor(avail))),
                   (j_types.scale_uplink(j, jnp.linspace(0.2, 1.0, 6)),
                    types.scale_uplink(t, torch.linspace(0.2, 1.0, 6)))]:
        for field in ("alpha", "t_comp", "mask", "alpha_ul"):
            _close(getattr(tt, field), getattr(jj, field), rtol=1e-6)


def test_stack_services_and_round_time_match():
    rng = np.random.default_rng(3)
    raws_j, raws_t = [], []
    for k in (3, 5, 4):
        r_dl, r_ul = rng.uniform(4, 9, k), rng.uniform(4, 9, k)
        t_loc = rng.uniform(0.01, 0.05, k)
        raws_j.append(j_types.RawServiceParams(
            0.3, 0.3, jnp.asarray(r_dl, jnp.float32),
            jnp.asarray(r_ul, jnp.float32), jnp.asarray(t_loc, jnp.float32), 1e-5))
        raws_t.append(types.RawServiceParams(
            0.3, 0.3, torch.tensor(r_dl, dtype=torch.float32),
            torch.tensor(r_ul, dtype=torch.float32),
            torch.tensor(t_loc, dtype=torch.float32), 1e-5))
    j = j_types.stack_services(raws_j, k_max=6)
    t = types.stack_services(raws_t, k_max=6)
    for field in ("alpha", "t_comp", "mask", "alpha_ul"):
        _close(getattr(t, field), getattr(j, field), rtol=1e-6)
    b_cl = np.where(np.asarray(j.mask), 0.4, 0.0).astype(np.float32)
    _close(types.round_time_given_alloc(t, torch.as_tensor(b_cl)),
           j_types.round_time_given_alloc(j, jnp.asarray(b_cl)), rtol=1e-6)


# ---------------------------------------------------------------------------
# network: the post-draw arithmetic fed the reference's own draws
# ---------------------------------------------------------------------------

def _jax_draws(key, n, k, cfg):
    """The draws ``repro.core.network.sample_services`` consumes, from its
    own key split (network.py:99-123)."""
    keys = jax.random.split(key, 8)
    eps_s, eps_c = j_network.channel_innovations(key, n, k)
    size = jax.random.uniform(keys[3], (n, 1), minval=cfg.model_mbit_lo,
                              maxval=cfg.model_mbit_hi)
    p_ul = jax.random.uniform(keys[4], (n, k), minval=cfg.p_ul_lo,
                              maxval=cfg.p_ul_hi)
    p_dl = jax.random.uniform(keys[5], (n, 1), minval=cfg.p_dl_lo,
                              maxval=cfg.p_dl_hi)
    t_loc = jax.random.uniform(keys[6], (n, k), minval=cfg.t_local_lo,
                               maxval=cfg.t_local_hi)
    return [torch.as_tensor(np.array(x)) for x in (eps_s, eps_c, size, p_ul,
                                                     p_dl, t_loc)]


@pytest.mark.parametrize("seed", [0, 1])
def test_services_from_draws_matches_sample_services(seed):
    n, k = 7, 45
    j_cfg = j_network.NetworkConfig()
    cfg = interop.network_config_from_dict(dataclasses.asdict(j_cfg))
    counts = np.random.default_rng(seed).integers(2, k + 1, size=n)
    key = jax.random.key(seed)
    j_svc, j_meta = j_network.sample_services(
        key, n, j_cfg, k_max=k, client_counts=jnp.asarray(counts))
    t_svc, t_meta = network.services_from_draws(
        torch.as_tensor(counts), k, *_jax_draws(key, n, k, j_cfg), cfg)
    for field in ("alpha", "t_comp", "alpha_ul"):
        _close(getattr(t_svc, field), getattr(j_svc, field), rtol=1e-5)
    assert np.array_equal(t_svc.mask.numpy(), np.asarray(j_svc.mask))
    _close(t_meta["r_ul"], j_meta["r_ul"], rtol=1e-5)


def test_sample_services_shapes_and_masking():
    gen = torch.Generator().manual_seed(0)
    counts = torch.tensor([2, 30, 45, 17], dtype=torch.int32)
    svc, meta = network.sample_services(gen, 4, k_max=45, client_counts=counts)
    assert svc.alpha.shape == (4, 45) and svc.alpha.dtype == torch.float32
    assert torch.equal(svc.client_counts(), counts.to(torch.int64))
    assert bool(torch.all(svc.alpha[svc.mask] > 0))
    assert bool(torch.all(svc.alpha[~svc.mask] == 0))
    assert bool(torch.all(svc.t_comp[~svc.mask] == 0))
    drawn = network.sample_client_counts(gen, 1000, network.NetworkConfig())
    assert int(drawn.min()) >= 2 and abs(float(drawn.float().mean()) - 25) < 1


def test_base_rate_matches():
    p = np.linspace(0.05, 0.3, 12).astype(np.float32)
    pl = np.linspace(70, 100, 12).astype(np.float32)
    _close(network.base_rate(torch.as_tensor(p), torch.as_tensor(pl)),
           j_network.base_rate(jnp.asarray(p), jnp.asarray(pl)), rtol=1e-5)


def test_interop_network_config_round_trip():
    j_cfg = j_network.NetworkConfig(total_bandwidth_mhz=7.0, mean_clients=12.0)
    cfg = interop.network_config_from_dict(dataclasses.asdict(j_cfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    with pytest.raises(ValueError, match="unknown"):
        interop.network_config_from_dict({**dataclasses.asdict(j_cfg), "x": 1})


# ---------------------------------------------------------------------------
# intra
# ---------------------------------------------------------------------------

B_VEC = np.array([0.3, 1.0, 2.5, 4.0, 0.8, 1.7], np.float32)


@pytest.mark.parametrize("fn,rtol,atol", [
    ("solve_round_time", 1e-4, 0.0),
    ("client_allocation", 1e-3, 1e-4),
    ("freq", 1e-3, 1e-5),
])
def test_intra_solves_match(fn, rtol, atol):
    j, t = _pair(4)
    b = np.where(np.asarray(j.service_active()), B_VEC, 0.0).astype(np.float32)
    ref = getattr(j_intra, fn)(j, jnp.asarray(b))
    got = getattr(intra, fn)(t, torch.as_tensor(b))
    finite = np.isfinite(np.asarray(ref))
    assert np.array_equal(np.isfinite(got.numpy()), finite)
    _close(got[torch.as_tensor(finite)], np.asarray(ref)[finite], rtol, atol)


@pytest.mark.parametrize("fn", ["freq_from_price", "demand"])
@pytest.mark.parametrize("lam_scale", [0.05, 0.4, 1.5])
def test_intra_price_solves_match(fn, lam_scale):
    j, t = _pair(5)
    lam = lam_scale * float(jnp.max(j_intra.p_max(j)))
    rtol, atol = (1e-3, 1e-5) if fn == "freq_from_price" else (1e-3, 1e-4)
    _close(getattr(intra, fn)(t, lam), getattr(j_intra, fn)(j, lam), rtol, atol)


@pytest.mark.parametrize("fn", ["freq_prime_at_f", "freq_second_at_f",
                                "bandwidth_from_freq", "price_at_freq"])
def test_intra_lemma1_terms_match(fn):
    j, t = _pair(6)
    f = np.array(j_intra.freq(j, jnp.asarray(B_VEC)))
    _close(getattr(intra, fn)(t, torch.as_tensor(f)),
           getattr(j_intra, fn)(j, jnp.asarray(f)), rtol=1e-4, atol=1e-6)


def test_intra_bracket_terms_match():
    j, t = _pair(7)
    _close(intra.p_max(t), j_intra.p_max(j), rtol=1e-6)
    _close(intra.f_max(t), j_intra.f_max(j), rtol=1e-6)


def test_padding_invariance_under_the_masking_convention():
    """Extra padded client slots change nothing.  Unlike
    test_core_intra::test_padding_invariance, the padded slots carry
    t^C = 0: with t^C = 99 at a masked slot, (1 - t^C f) clamps to 1e-30,
    its square underflows to 0 in float32 and the reference's
    freq_from_price sums 0/0 = NaN (ROADMAP item C2).  The engines never
    build such sets (mask_inactive / mask_clients zero t^C), so that case is
    a reference fault and is left out here."""
    _, t = _pair(8, n=3, k=6, inactive=False)
    pad = torch.zeros((3, 5))
    t_pad = types.ServiceSet(
        alpha=torch.cat([t.alpha, pad], 1), t_comp=torch.cat([t.t_comp, pad], 1),
        mask=torch.cat([t.mask, pad.bool()], 1))
    b = torch.tensor([1.0, 2.0, 3.0])
    _close(intra.freq(t_pad, b), intra.freq(t, b).numpy(), rtol=1e-6)
    _close(intra.demand(t_pad, 0.5), intra.demand(t, 0.5).numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["equal_client", "equal_service", "proportional"])
def test_baselines_match(fn):
    j, t = _pair(9)
    jb, jf = getattr(j_baselines, fn)(j, 10.0)
    tb, tf = getattr(baselines, fn)(t, 10.0)
    _close(tb, jb, rtol=1e-3, atol=1e-4)
    _close(tf, jf, rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# Import guard
# ---------------------------------------------------------------------------

def _forbidden_imports(path: Path) -> list[str]:
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    return bad


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    names = {str(f.relative_to(ROOT)) for f in files}
    for module in ("core/fairness.py", "core/auction.py", "kernels/ops.py",
                   "kernels/market_clear.py", "scenarios/base.py",
                   "scenarios/arrival.py", "scenarios/channel.py",
                   "scenarios/churn.py", "fl/simulator.py", "interop.py",
                   "kernels/mlstm_chunk.py", "models/ssm.py",
                   "models/xlstm.py", "configs/xlstm_1_3b.py"):
        assert f"src/repro_torch/{module}" in names, module
    bad = [b for f in files for b in _forbidden_imports(f)]
    assert not bad, bad
