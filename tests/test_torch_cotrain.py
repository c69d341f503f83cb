"""The port's co-trained episode (``fl.cotrain``) against the JAX package's.

Torch cannot replay threefry, so the port is fed the reference's own
draws: the arrivals and counts of ``simulator._static_draws``, every
period's ServiceSet of ``sample_services(fold_in(key(seed + 7), p), ...)``
(or the raw and scenario draws of ``test_torch_scenarios.jax_sampler`` for
stateful processes), the reference ``SyntheticLM``'s batches (``RefData``)
and the reference's initial tables.  Both sides run in this process, on
one threefry setting.

Exact: durations, periods, trained and clipped rounds, and the history's
rounds, trained, participants, comp_id and active.  Within tolerance: b
(rtol 1e-3 / atol 1e-4), f (rtol 1e-3 / atol 1e-5), loss and train_loss
(rtol 1e-4 / atol 1e-5), final params (atol 1e-4), acc within one eval
token (1 / (eval_batch x seq_len)).

The kernel backends run their plain versions here and are held to the
reference backend's episode.  Their t* and split are within rtol 1e-4 of
it, not bitwise, so the deadline compare ``lat <= deadline_x * t_round``
and the adaptive switch ``b < comp_threshold * fair`` are exact only
where the reference's margin exceeds that: at ``deadline_x`` = 3 every
admitted latency is about a third of the deadline, and the adaptive case
runs on "reference".
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as j_network
from repro.data import SyntheticLM as JSyntheticLM
from repro.fl import cotrain as j_cotrain
from repro.fl import server as j_server
from repro.fl import simulator as j_sim
from repro_torch import interop
from repro_torch.core import network
from repro_torch.fl import cotrain, server, simulator
from test_torch_scenarios import jax_sampler

CPU = torch.device("cpu")
J_NET = j_network.NetworkConfig(period_s=1.0, mean_clients=5.0,
                                var_clients=2.0)
NET = network.NetworkConfig(period_s=1.0, mean_clients=5.0, var_clients=2.0)
BASE = dict(n_services_total=3, rounds_required=30, p_arrive=2.0,
            max_periods=24, k_max=12, mean_clients=5.0, var_clients=2.0)
TRAIN = dict(vocab=16, seq_len=6, batch_size=2, eval_batch=8, rounds_cap=2)


class RefData:
    """The reference ``SyntheticLM``'s batches behind the port's data
    interface: one jitted, vmapped call per ``batches``."""

    def __init__(self, train):
        self.data = JSyntheticLM(vocab_size=train.vocab,
                                 seq_len=train.seq_len, seed=train.data_seed,
                                 temperature=train.data_temperature)
        self._fns = {}

    def batches(self, step, batch_size, client_ids):
        ids = np.asarray(client_ids)
        steps = np.broadcast_to(np.asarray(step), ids.shape)
        if batch_size not in self._fns:
            self._fns[batch_size] = jax.jit(jax.vmap(
                lambda s, c: self.data.batch(s, batch_size, c)))
        out = self._fns[batch_size](
            jnp.asarray(steps.reshape(-1), jnp.int32),
            jnp.asarray(ids.reshape(-1), jnp.int32))
        return {k: np.asarray(v).reshape(ids.shape + v.shape[1:])
                for k, v in out.items()}

    def batch(self, step, batch_size, client_id=0):
        out = self.batches(step, batch_size, np.array([client_id]))
        return {k: v[0] for k, v in out.items()}


def ref_init(cfg, train):
    """The reference episode's (N, V, V) initial tables."""
    task = j_cotrain._build_task(train, cfg.k_max)
    k_init = jax.random.fold_in(jax.random.key(cfg.seed + 7),
                                j_cotrain.COTRAIN_SALT)
    return np.asarray(jax.vmap(
        lambda i: task.init(jax.random.fold_in(k_init, i)))(
        jnp.arange(cfg.n_services_total, dtype=jnp.int32)))


def set_sampler(cfg, net, counts):
    """Every period's reference ServiceSet (i.i.d. channels), cached."""
    key = jax.random.key(cfg.seed + 7)
    draw = jax.jit(lambda p: j_network.sample_services(
        jax.random.fold_in(key, p), cfg.n_services_total, net,
        k_max=j_sim._k_cap(cfg), client_counts=counts)[0])
    cache = {}

    def sampler(period):
        if period not in cache:
            cache[period] = interop.service_set_from_arrays(
                *(np.array(x) for x in draw(period)), device=CPU)
        return cache[period]

    return sampler


def ref_inputs(opts: dict, train_kw: dict, seed: int = 0):
    """(reference cfg, port cfg, both TrainSpecs, and the port's injection
    kwargs) for one episode."""
    j_cfg = j_sim.SimConfig(**{**BASE, **opts}, seed=seed)
    cfg = simulator.SimConfig(**{**BASE, **opts}, seed=seed)
    j_train = j_cotrain.TrainSpec(**{**TRAIN, **train_kw})
    train = cotrain.TrainSpec(**{**TRAIN, **train_kw})
    arrivals, counts = j_sim._static_draws(j_cfg, J_NET)
    stateful = any(k in opts for k in ("channel_process", "churn_process"))
    sampler = (jax_sampler(jax.random.key(seed + 7), counts,
                           cfg.n_services_total, cfg.k_max,
                           opts.get("channel_process", "iid").name
                           if "channel_process" in opts else "iid",
                           net=J_NET)
               if stateful else set_sampler(j_cfg, J_NET, counts))
    inject = dict(arrivals=arrivals, counts=counts, sampler=sampler,
                  data=RefData(j_train), init_params=ref_init(j_cfg, j_train),
                  device=CPU)
    return j_cfg, cfg, j_train, train, inject


_REF_CACHE = {}


def reference(j_cfg, j_train):
    key = (repr(j_cfg), j_train)
    if key not in _REF_CACHE:
        _REF_CACHE[key] = j_cotrain.run_cotrain_scan(j_cfg, j_train, J_NET)
    return _REF_CACHE[key]


def assert_matches(got: dict, ref: dict, train) -> None:
    for key in ("durations", "periods", "trained_rounds", "clipped_rounds",
                "finished"):
        assert got[key] == ref[key], key
    h, rh = got["history"], ref["history"]
    for key in ("rounds", "trained", "participants", "comp_id", "active"):
        assert np.array_equal(h[key], np.asarray(rh[key])), key
    np.testing.assert_allclose(h["b"], rh["b"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(h["f"], rh["f"], rtol=1e-3, atol=1e-5)
    for key in ("loss", "train_loss"):
        np.testing.assert_allclose(h[key], rh[key], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h["ul_mult"], rh["ul_mult"], rtol=1e-6)
    one_token = 1.0 / (train.eval_batch * train.seq_len)
    assert np.max(np.abs(h["acc"] - np.asarray(rh["acc"]))) <= (
        one_token + 1e-6)
    np.testing.assert_allclose(got["params"], np.asarray(ref["params"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["time_s"], ref["time_s"])
    assert [dataclasses.astuple(s) for s in got["services"]] == [
        dataclasses.astuple(s) for s in ref["services"]]


# (policy, warm, backends the port runs against the reference's episode)
# (pp and ec: tests/test_torch_cotrain_baselines.py)
POLICY_CASES = [("coop", True, ("reference", "pallas", "megakernel")),
                ("coop", False, ("reference",)),
                ("es", False, ("reference", "pallas")),
                ("selfish", False, ("reference", "pallas"))]


@pytest.mark.parametrize("policy,warm,backends", POLICY_CASES)
def test_cotrain_matches_reference(policy, warm, backends):
    opts = dict(policy=policy, warm_start=warm)
    j_cfg, cfg, j_train, train, inject = ref_inputs(opts, {})
    ref = reference(j_cfg, j_train)
    assert ref["clipped_rounds"] > 0      # rounds_cap 2 clips
    for backend in backends:
        got = cotrain.run_cotrain_scan(
            dataclasses.replace(cfg, intra_backend=backend), train, NET,
            **inject)
        assert_matches(got, ref, train)


@pytest.mark.parametrize("policy,warm", [("coop", True), ("coop", False),
                                         ("es", False), ("pp", False),
                                         ("ec", False), ("selfish", False)])
def test_durations_bitwise_equal_own_run_scan(policy, warm):
    """Training reads the allocation and writes nothing back: the port's
    co-trained durations and allocation are bitwise its run_scan's (on
    the kernel backends' plain versions; cold coop on "megakernel", its
    fused clear)."""
    backend = "pallas" if warm or policy != "coop" else "megakernel"
    cfg = simulator.SimConfig(**BASE, policy=policy, warm_start=warm,
                              intra_backend=backend, collect_alloc=True)
    train = cotrain.TrainSpec(**TRAIN)
    co = cotrain.run_cotrain_scan(cfg, train, NET, device=CPU)
    ref = simulator.run_scan(cfg, NET, device=CPU)
    assert co["durations"] == ref["durations"]
    assert co["periods"] == ref["periods"]
    for key in ("b", "f", "freq_sum", "objective", "active"):
        np.testing.assert_array_equal(co["history"][key],
                                      ref["history"][key])
    # the history's rounds are those that count (clamped at the
    # requirement), run_scan's those the allocation granted
    assert np.all(co["history"]["rounds"] <= ref["history"]["rounds"])


def test_batch_is_scan_per_seed_and_fleet_is_batch():
    cfg = simulator.SimConfig(**BASE, policy="pp")
    train = cotrain.TrainSpec(**TRAIN, compression="topk", topk_frac=0.05,
                              comp_policy="adaptive", comp_threshold=1.5)
    seeds = [0, 1, 2]
    batch = cotrain.run_cotrain_batch(cfg, train, seeds, NET, device=CPU)
    for i, seed in enumerate(seeds):
        one = cotrain.run_cotrain_scan(dataclasses.replace(cfg, seed=seed),
                                       train, NET, device=CPU)
        p = one["periods"]
        assert batch["periods"][i] == p
        assert list(batch["durations"][i]) == one["durations"]
        assert list(batch["trained_rounds"][i]) == one["trained_rounds"]
        assert batch["clipped_rounds"][i] == one["clipped_rounds"]
        for key in cotrain._CURVE_KEYS:
            np.testing.assert_array_equal(batch["history"][key][i][:p],
                                          one["history"][key])
        np.testing.assert_array_equal(batch["params"][i], one["params"])
        # the periods after the episode stopped: nothing active or trained
        tail = {k: v[i][p:] for k, v in batch["history"].items()}
        assert not tail["active"].any() and not tail["trained"].any()
        assert np.all(tail["loss"] == one["history"]["loss"][-1])
    for chunk in (1, 2, 3):
        fleet = cotrain.run_cotrain_fleet(cfg, train, seeds, NET,
                                          chunk_size=chunk, device=CPU)
        assert fleet["fleet"]["chunk"] == chunk
        for key in ("durations", "periods", "trained_rounds",
                    "clipped_rounds", "params", "time_s"):
            np.testing.assert_array_equal(fleet[key], batch[key])
        for key in cotrain._CURVE_KEYS:
            np.testing.assert_array_equal(fleet["history"][key],
                                          batch["history"][key])
        assert fleet["services"] == batch["services"]
    assert cotrain.run_cotrain_fleet(cfg, train, seeds, NET, chunk_size=2,
                                     device=CPU)["fleet"] == {
        "n_devices": 1, "mesh_axis": "seeds", "chunk": 2, "n_chunks": 2,
        "padded_to": 4}


def test_unported_options_raise():
    cfg = simulator.SimConfig(**BASE)
    with pytest.raises(NotImplementedError, match="item 13"):
        cotrain.run_cotrain_scan(cfg, cotrain.TrainSpec(task="zoo"), NET,
                                 device=CPU)
    # attack= is ported: anything but a chaos.clients.AttackSpec raises
    with pytest.raises(TypeError, match="AttackSpec"):
        cotrain.run_cotrain_scan(cfg, cotrain.TrainSpec(**TRAIN), NET,
                                 attack=object(), device=CPU)
    with pytest.raises(TypeError, match="AttackSpec"):
        server.make_fl_round_step(cotrain.bigram_loss, attack=object())
    with pytest.raises(NotImplementedError, match="item 12"):
        cotrain.run_cotrain_fleet(cfg, cotrain.TrainSpec(**TRAIN), [0], NET,
                                  mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="unknown train task"):
        cotrain.run_cotrain_scan(cfg, cotrain.TrainSpec(task="nope"), NET,
                                 device=CPU)


def test_train_spec_validation_mirrors_reference():
    assert ({f.name: f.default for f in dataclasses.fields(cotrain.TrainSpec)}
            == {f.name: f.default
                for f in dataclasses.fields(j_cotrain.TrainSpec)})
    bad = [(dict(rounds_cap=0), "rounds_cap"),
           (dict(local_steps=0), "local_steps"),
           (dict(deadline_x=0.0), "deadline_x"),
           (dict(aggregator="mean"), "aggregator"),
           (dict(comp_levels=()), "comp_levels"),
           (dict(comp_levels=["topk"]), "comp_levels"),
           (dict(comp_levels=("topk", "gzip")), "compression"),
           (dict(comp_policy="sometimes"), "comp_policy"),
           (dict(topk_frac=0.0), "topk_frac"),
           (dict(comp_threshold=0.0), "comp_threshold")]
    for kw, match in bad:
        with pytest.raises(ValueError, match=match):
            j_cotrain.TrainSpec(**kw)
        with pytest.raises(ValueError, match=match):
            cotrain.TrainSpec(**kw)


def test_infinite_deadline_recovers_plain_fedavg():
    """With straggler drop off, the rounds the co-simulation executes are
    plain FedAvg: a hand-rolled loop of make_fl_round_step on the same
    batches reproduces the tables and per-period training losses."""
    cfg = simulator.SimConfig(policy="coop", n_services_total=1,
                              rounds_required=10, p_arrive=2.0,
                              max_periods=30, k_max=8, mean_clients=4.0,
                              var_clients=1.0)
    net = network.NetworkConfig(mean_clients=4.0, var_clients=1.0)
    train = cotrain.TrainSpec(**{**TRAIN, "rounds_cap": 10},
                              deadline_x=float("inf"))
    co = cotrain.run_cotrain_scan(cfg, train, net, device=CPU)
    assert co["finished"] and co["clipped_rounds"] == 0
    assert sum(co["trained_rounds"]) == cfg.rounds_required

    _, counts = simulator._static_draws(cfg, net)
    data = cotrain.default_data(train)
    step = server.make_fl_round_step(
        cotrain.bigram_loss, client_lr=train.client_lr,
        server_lr=train.server_lr)
    params = torch.as_tensor(
        cotrain.default_init_params(cfg.seed, train, 1)[0])
    weights = torch.as_tensor(
        (np.arange(cfg.k_max) < int(counts[0])).astype(np.float32))
    h = co["history"]
    ran = h["trained"][:, 0] > 0
    assert np.all(h["participants"][ran, 0] == int(counts[0]))
    r = 0
    for p in range(co["periods"]):
        losses = []
        for _ in range(int(h["rounds"][p, 0])):
            batches = data.batches(r, train.batch_size,
                                   np.arange(cfg.k_max)[:, None])
            params, metrics = step(params, batches, weights)
            losses.append(float(metrics["loss"]))
            r += 1
        if losses:
            np.testing.assert_allclose(float(h["train_loss"][p, 0]),
                                       np.mean(losses), rtol=1e-5)
    assert r == cfg.rounds_required
    np.testing.assert_allclose(co["params"][0], params.numpy(), rtol=1e-5,
                               atol=1e-6)
    # real signal: the eval loss fell below the initial tables'
    assert h["loss"][co["periods"] - 1, 0] < h["loss"][0, 0] - 0.05


def test_reference_round_step_matches_port_round_step():
    """One bigram round of make_fl_round_step, the port's against the
    reference's, on the same tables, batches and weights."""
    train = cotrain.TrainSpec(**TRAIN)
    data = RefData(j_cotrain.TrainSpec(**TRAIN))
    batches = data.batches(3, train.batch_size,
                           np.arange(6)[:, None])
    rng = np.random.default_rng(0)
    table = (0.3 * rng.standard_normal((16, 16))).astype(np.float32)
    weights = np.array([1, 1, 0, 1, 0, 1], np.float32)
    j_step = j_server.make_fl_round_step(_j_bigram_loss, client_lr=0.5)
    want, wm = j_step(jnp.asarray(table), jax.tree.map(jnp.asarray, batches),
                      jnp.asarray(weights))
    got, gm = server.make_fl_round_step(cotrain.bigram_loss, client_lr=0.5)(
        torch.as_tensor(table),
        {k: torch.from_numpy(np.array(v)) for k, v in batches.items()},
        torch.as_tensor(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                               rtol=1e-5)


def _j_bigram_loss(table, batch):
    logits = table[batch["tokens"]]
    logp = jax.nn.log_softmax(logits)
    ll = jnp.take_along_axis(logp, batch["labels"][..., None], axis=-1)[..., 0]
    return -jnp.mean(ll)
