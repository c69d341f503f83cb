"""The port's scenario processes against the JAX package's.

Torch's generators cannot replay JAX's threefry stream, so each process is
fed the reference's own draws through an ``ArraySource``: the uniforms,
normals and exponentials that ``jax.random`` gives on the keys the
reference derives (``fold_in`` of the period key with ``FADING_SALT`` /
``CHURN_SALT``, ``split`` of the episode key folded with ``INIT_SALT``),
and, for a channel process that rebuilds the period's set, the raw draws
``network.sample_services`` makes on the period key.  Given the same draws
and state, states, masks and arrival periods must be exactly equal; a
rebuilt ServiceSet agrees to rtol 1e-5 (``tests/test_torch_core.py``'s
bound for ``services_from_draws``).

The helpers at the top (the reference's draws as port draws, and a
sampler built from them) are also what ``tests/test_torch_simulator.py``
feeds its scenario episodes and ``run_batch``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as j_scenarios
from repro.core import network as j_network
from repro_torch import interop, scenarios
from repro_torch.core import network
from repro_torch.fl import simulator
from repro_torch.scenarios import channel as t_channel

CPU = torch.device("cpu")
J_NET = j_network.NetworkConfig()
NET = network.NetworkConfig()


def _t(x, dtype=np.float32):
    return torch.as_tensor(np.array(x, dtype=dtype))


def _raw_fn(n, k, net):
    @jax.jit
    def raw(key_p, counts):
        eps_s, eps_c = j_network.channel_innovations(key_p, n, k)
        _, meta = j_network.sample_services(key_p, n, net, k_max=k,
                                            client_counts=counts)
        return (eps_s, eps_c, meta["size_mbit"], meta["p_ul"], meta["p_dl"],
                meta["t_local"])

    return raw


def _period_fn(n, k):
    @jax.jit
    def period(key_p):
        kr, ki = jax.random.split(
            jax.random.fold_in(key_p, j_scenarios.base.FADING_SALT))
        return {"fade_re": jax.random.normal(kr, (n, k)),
                "fade_im": jax.random.normal(ki, (n, k)),
                "churn": jax.random.uniform(
                    jax.random.fold_in(key_p, j_scenarios.base.CHURN_SALT),
                    (n, k))}

    return period


def jax_init_source(key, n, k, channel_name):
    """The reference's initial-state draws of episode ``key``."""
    base = j_scenarios.base
    d = {"init_churn": jax.random.uniform(
        jax.random.fold_in(key, base.CHURN_SALT), (n, k))}
    init = jax.random.fold_in(key, base.INIT_SALT)
    if channel_name == "gauss_markov":
        ks, kc = jax.random.split(init)
        d.update(init_shadow_service=jax.random.normal(ks, (n, 1)),
                 init_shadow_client=jax.random.normal(kc, (n, k)))
    elif channel_name == "rayleigh_block":
        kr, ki, ks, kc = jax.random.split(init, 4)
        d.update(init_fade_re=jax.random.normal(kr, (n, k)),
                 init_fade_im=jax.random.normal(ki, (n, k)),
                 init_shadow_service=jax.random.normal(ks, (n, 1)),
                 init_shadow_client=jax.random.normal(kc, (n, k)))
    return scenarios.ArraySource({s: np.array(v) for s, v in d.items()}, CPU)


def jax_sampler(key, counts, n, k, channel_name, net=J_NET):
    """A port sampler serving the reference's draws of episode ``key``:
    period p's raw service draws and scenario draws on fold_in(key, p),
    and at period 0 the initial-state draws."""
    raw_fn, period_fn = _raw_fn(n, k, net), _period_fn(n, k)
    counts_j = jnp.asarray(counts, jnp.int32)
    cache = {}

    def sampler(p):
        if p not in cache:
            key_p = jax.random.fold_in(key, p)
            raw = [_t(x) for x in raw_fn(key_p, counts_j)]
            draws = network.ServiceDraws(_t(counts, np.int32), k, *raw)
            source = scenarios.ArraySource(
                {s: np.array(v) for s, v in period_fn(key_p).items()}, CPU)
            init = jax_init_source(key, n, k, channel_name) if p == 0 else None
            cache[p] = simulator.PeriodDraws(draws, source, init)
        return cache[p]

    return sampler


def _shell(counts, k):
    mask = jnp.arange(k)[None, :] < jnp.asarray(counts)[:, None]
    z = jnp.zeros(mask.shape, jnp.float32)
    return j_network.ServiceSet(alpha=z, t_comp=z, mask=mask)


def _same_svc(svc, j_svc):
    for field in ("alpha", "t_comp", "alpha_ul"):
        np.testing.assert_allclose(getattr(svc, field).numpy(),
                                   np.asarray(getattr(j_svc, field)),
                                   rtol=1e-5)
    assert np.array_equal(svc.mask.numpy(), np.asarray(j_svc.mask))


def _same_state(state, j_state):
    if isinstance(state, tuple):
        assert len(state) == len(j_state)
        for s, js in zip(state, j_state):
            _same_state(s, js)
    else:
        assert np.array_equal(state.numpy(), np.asarray(j_state))


# ---------------------------------------------------------------------------
# Channel processes.
# ---------------------------------------------------------------------------

CHANNELS = [
    j_scenarios.spec("gauss_markov", rho=0.9, rho_service=0.6),
    j_scenarios.spec("gauss_markov", rho=0.0),
    j_scenarios.spec("rayleigh_block", rho=0.8),
    j_scenarios.spec("rayleigh_block", rho=0.7, shadowing_rho=0.95,
                     floor_db=-20.0),
]


@pytest.mark.parametrize("spec", CHANNELS, ids=str)
def test_channel_transitions_match(spec):
    n, k = 6, 13
    counts = np.array([2, 13, 7, 0, 5, 9])
    key = jax.random.key(4)
    j_proc = j_scenarios.get_channel(spec, J_NET)
    proc = scenarios.get_channel(scenarios.spec(spec.name, **spec.kwargs()),
                                 NET)
    assert proc.rebuilds == j_proc.rebuilds is True
    sampler = jax_sampler(key, counts, n, k, spec.name)
    j_state = j_proc.init(key, n, k)
    state = proc.init(sampler(0).init, n, k)
    _same_state(state, j_state)
    for p in range(3):
        key_p = jax.random.fold_in(key, p)
        j_state, j_svc = j_proc.step(key_p, j_state, _shell(counts, k))
        draws = sampler(p)
        state, svc = proc.step(draws.source, state, draws.services)
        _same_state(state, j_state)
        _same_svc(svc, j_svc)
    if spec.kwargs().get("rho") == 0.0:
        # correlation 0 reproduces the period's i.i.d. set
        iid, _ = network.services_from_draws(*draws.services, NET)
        assert torch.equal(svc.alpha, iid.alpha)


def test_channel_helpers_match():
    rng = np.random.default_rng(0)
    z, eps = (rng.standard_normal((5, 7)).astype(np.float32) for _ in "ab")
    for rho in (0.0, 0.3, 0.95):
        assert np.array_equal(
            t_channel._ar1(_t(z), _t(eps), rho).numpy(),
            np.asarray(j_scenarios.channel._ar1(jnp.asarray(z),
                                                jnp.asarray(eps), rho)))
    h_re, h_im = z * 1e-3, eps
    h_re[0, 0] = h_im[0, 0] = 0.0                 # a fade below the floor
    for floor in (1e-4, 10.0 ** (-40.0 / 10.0)):
        got = t_channel.fading_margin_db(_t(h_re), _t(h_im), floor).numpy()
        want = np.asarray(j_scenarios.channel.fading_margin_db(
            jnp.asarray(h_re), jnp.asarray(h_im), floor))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    key = jax.random.key(3)
    eps_s, eps_c = j_network.channel_innovations(key, 4, 9)
    gen = torch.Generator().manual_seed(1)
    a = network.channel_innovations(gen, 4, 9)
    draws = network.sample_draws(torch.Generator().manual_seed(1), 4, NET,
                                 k_max=9, client_counts=torch.full((4,), 9))
    assert a[0].shape == eps_s.shape and a[1].shape == eps_c.shape
    assert torch.equal(a[0], draws.eps_service)
    assert torch.equal(a[1], draws.eps_client)


def test_sample_services_hooks_perturb_only_the_channel():
    counts = torch.tensor([3, 9, 6])
    base, meta = network.sample_services(torch.Generator().manual_seed(2), 3,
                                         k_max=9, client_counts=counts)
    z = (torch.zeros(3, 1), torch.zeros(3, 9))
    fade = torch.full((3, 9), 6.0)
    svc, meta2 = network.sample_services(
        torch.Generator().manual_seed(2), 3, k_max=9, client_counts=counts,
        channel_normals=z, extra_pathloss_db=fade)
    assert torch.equal(meta2["size_mbit"], meta["size_mbit"])
    assert torch.equal(meta2["t_local"], meta["t_local"])
    assert torch.equal(svc.t_comp, base.t_comp)
    want = NET.mean_pathloss_db + 6.0
    assert torch.allclose(meta2["pathloss_db"][svc.mask],
                          torch.tensor(want))


# ---------------------------------------------------------------------------
# Churn processes.
# ---------------------------------------------------------------------------

CHURNS = [
    j_scenarios.spec("bernoulli", p_drop=0.3),
    j_scenarios.spec("bernoulli", p_drop=0.5, always_keep=2),
    j_scenarios.spec("gilbert", p_drop=0.2, p_return=0.3),
    j_scenarios.spec("gilbert", p_drop=0.4, p_return=0.1, always_keep=3),
    j_scenarios.spec("gilbert", p_drop=0.0, p_return=0.0),
]


@pytest.mark.parametrize("spec", CHURNS, ids=str)
def test_churn_transitions_match(spec):
    n, k = 5, 11
    counts = np.array([11, 4, 0, 8, 2])
    key = jax.random.key(9)
    j_proc = j_scenarios.get_churn(spec, J_NET)
    proc = scenarios.get_churn(scenarios.spec(spec.name, **spec.kwargs()),
                               NET)
    sampler = jax_sampler(key, counts, n, k, "iid")
    j_state = j_proc.init(key, n, k)
    state = proc.init(sampler(0).init, n, k)
    _same_state(state, j_state)
    for p in range(4):
        key_p = jax.random.fold_in(key, p)
        j_svc, _ = j_network.sample_services(key_p, n, J_NET, k_max=k,
                                             client_counts=counts)
        svc = interop.service_set_from_arrays(
            *(np.asarray(x) for x in j_svc), device=CPU)
        j_state, j_out = j_proc.step(key_p, j_state, j_svc)
        state, out = proc.step(sampler(p).source, state, svc)
        _same_state(state, j_state)
        assert np.array_equal(out.mask.numpy(), np.asarray(j_out.mask))
        assert np.array_equal(out.alpha.numpy(), np.asarray(j_out.alpha))
        assert np.array_equal(out.t_comp.numpy(), np.asarray(j_out.t_comp))


def test_gilbert_state_interop_and_chain():
    avail = np.random.default_rng(1).uniform(size=(3, 6)) < 0.5
    state = interop.gilbert_state_from_arrays(avail, device=CPU)
    assert state.dtype == torch.bool and np.array_equal(state.numpy(), avail)
    u = _t(np.random.default_rng(2).uniform(size=(3, 6)))
    from repro_torch.scenarios.churn import gilbert_avail

    got = gilbert_avail(state, u, 0.2, 0.3, 1).numpy()
    want = np.where(avail, u.numpy() >= 0.2, u.numpy() < 0.3)
    want[:, 0] = True
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# Arrival processes.
# ---------------------------------------------------------------------------

def _jax_arrival_draws(name, key, n, group=3):
    if name == "mmpp":
        key_s0, key_steps = jax.random.split(key)
        subkeys = jax.random.split(key_steps, n)
        pairs = jax.vmap(jax.random.split)(subkeys)
        return {"state0": np.array(jax.random.uniform(key_s0, ())),
                "gaps": np.array(jax.vmap(
                    lambda k: jax.random.exponential(k, dtype=jnp.float32))(
                        pairs[:, 0])),
                "flips": np.array(jax.vmap(jax.random.uniform)(pairs[:, 1]))}
    if name == "batched":
        return {"gaps": np.array(jax.random.exponential(
            key, (-(-n // group),), jnp.float32))}
    if name == "poisson":
        return {"gaps": np.array(jax.random.exponential(key, (n,),
                                                        jnp.float32))}
    return {}


ARRIVALS = [j_scenarios.spec("poisson"), j_scenarios.spec("periodic"),
            j_scenarios.spec("batched"), j_scenarios.spec("batched", group=4),
            j_scenarios.spec("mmpp"), j_scenarios.spec("mmpp", burst=3.0,
                                                       stay=0.2)]


@pytest.mark.parametrize("spec", ARRIVALS, ids=str)
@pytest.mark.parametrize("n,mean", [(1, 5.0), (17, 2.5), (300, 0.7)])
def test_arrival_draws_match(spec, n, mean):
    key = jax.random.key(n)
    want = np.asarray(j_scenarios.get_arrival(spec)(key, n, mean))
    draws = _jax_arrival_draws(spec.name, key, n,
                               spec.kwargs().get("group", 3))
    draw = scenarios.get_arrival(scenarios.spec(spec.name, **spec.kwargs()))
    got = draw(scenarios.ArraySource(draws, CPU), n, mean)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Registry, validation, sources.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,name,params", [
    ("channel", "gauss_markov", dict(rho=1.0)),
    ("channel", "gauss_markov", dict(rho_service=-0.1)),
    ("channel", "rayleigh_block", dict(shadowing_rho=1.5)),
    ("churn", "bernoulli", dict(p_drop=1.2)),
    ("churn", "gilbert", dict(p_return=-0.5)),
    ("arrival", "batched", dict(group=0)),
    ("arrival", "mmpp", dict(burst=0.5)),
    ("arrival", "mmpp", dict(stay=1.0)),
])
def test_parameter_validation_matches(kind, name, params):
    context = {} if kind == "arrival" else {"net": NET}
    j_context = {} if kind == "arrival" else {"net": J_NET}
    with pytest.raises(ValueError) as j_err:
        j_scenarios.get_process(kind, j_scenarios.spec(name, **params),
                                **j_context)
    with pytest.raises(ValueError) as err:
        scenarios.get_process(kind, scenarios.spec(name, **params), **context)
    assert str(err.value) == str(j_err.value)


def test_sources_and_salts():
    assert (scenarios.INIT_SALT, scenarios.FADING_SALT, scenarios.CHURN_SALT) \
        == (j_scenarios.base.INIT_SALT, j_scenarios.base.FADING_SALT,
            j_scenarios.base.CHURN_SALT)
    src = scenarios.GeneratorSource(CPU, 3, 4)
    assert torch.equal(src.normal("fade_re", (2, 3)),
                       src.normal("fade_re", (2, 3)))
    assert not torch.equal(src.normal("fade_re", (2, 3)),
                           src.normal("fade_im", (2, 3)))
    assert bool((src.exponential("gaps", (100,)) > 0).all())
    with pytest.raises(ValueError, match="unknown draw stream"):
        src.uniform("chrun", (2,))
    arr = scenarios.ArraySource({"churn": np.zeros((2, 3))}, CPU)
    with pytest.raises(ValueError, match="shape"):
        arr.uniform("churn", (3, 2))
    with pytest.raises(KeyError):
        arr.normal("fade_re", (2, 3))
    h = interop.rayleigh_state_from_arrays(np.ones((2, 3)), np.zeros((2, 3)),
                                           np.ones((2, 1)), np.ones((2, 3)),
                                           device=CPU)
    assert len(h) == 4 and h[2].shape == (2, 1)
    z = interop.gauss_markov_state_from_arrays(np.ones((2, 1)),
                                               np.ones((2, 3)), device=CPU)
    assert z[1].dtype == torch.float32
    with pytest.raises(ValueError, match="together"):
        interop.rayleigh_state_from_arrays(np.ones((2, 3)), np.ones((2, 3)),
                                           z_s=np.ones((2, 1)), device=CPU)
