"""The port's training driver (``repro_torch.launch.train``) and
co-training's ``zoo`` task, on the CPU.

Mirrors ``tests/test_train_launch.py`` (the ``--reduced`` flag both ways,
one ``--topk-frac`` feeding the pricing and the round step) and
``tests/test_cotrain.py``'s zoo task and its encoder-decoder refusal; then
one run of the driver at reduced width, resumed from its checkpoint, equal
bit for bit to the run without the interruption.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import network
from repro_torch.fl import compression as fl_comp
from repro_torch.fl import cotrain, simulator
from repro_torch.launch import train

CPU = torch.device("cpu")


# -- the --reduced flag ------------------------------------------------------

def test_reduced_flag_defaults_on():
    assert train.build_parser().parse_args([]).reduced is True


def test_reduced_flag_can_be_disabled():
    assert train.build_parser().parse_args(["--no-reduced"]).reduced is False
    assert train.build_parser().parse_args(["--reduced"]).reduced is True


def test_resolve_config_reaches_both_branches(monkeypatch):
    from repro_torch import configs
    monkeypatch.setattr(configs, "get_smoke_config", lambda arch: "smoke")
    monkeypatch.setattr(configs, "get_config", lambda arch: "full")
    assert train.resolve_config("any", reduced=True) == "smoke"
    assert train.resolve_config("any", reduced=False) == "full"


# -- k_frac agreement between pricing and round step -------------------------

def test_topk_frac_flag_parses():
    args = train.build_parser().parse_args(
        ["--compression", "topk", "--topk-frac", "0.25"])
    assert args.compression == "topk" and args.topk_frac == 0.25
    assert train.build_parser().parse_args([]).topk_frac == 0.01


def test_compression_setup_prices_and_transmits_same_k_frac():
    args = train.build_parser().parse_args(
        ["--compression", "topk", "--topk-frac", "0.25", "--error-feedback"])
    comp = train.compression_setup(args)
    assert comp["ratio"] == pytest.approx(
        fl_comp.compression_ratio("topk", k_frac=0.25))
    rs = comp["round_step_kwargs"]
    assert rs["compression"] == "topk"
    assert rs["topk_frac"] == 0.25
    assert rs["error_feedback"] is True
    dense = train.compression_setup(train.build_parser().parse_args([]))
    assert dense["ratio"] == 1.0
    assert dense["round_step_kwargs"]["compression"] == "none"
    assert dense["round_step_kwargs"]["error_feedback"] is False


def test_round_step_kwargs_reach_the_sparsifier():
    from repro_torch.fl import server

    args = train.build_parser().parse_args(
        ["--compression", "topk", "--topk-frac", "0.5"])
    kwargs = train.compression_setup(args)["round_step_kwargs"]

    def loss_fn(p, batch):
        return torch.sum(p["w"] * batch["g"])   # grad == batch["g"]

    step = server.make_fl_round_step(loss_fn, local_steps=1, client_lr=1.0,
                                     server_lr=1.0, **kwargs)
    params = {"w": torch.zeros((4,))}
    batches = {"g": torch.tensor([[[0.1, 0.2, 0.3, 0.4]]])}
    new_params, _ = step(params, batches, torch.ones((1,)))
    got = new_params["w"].numpy()
    np.testing.assert_allclose(got, [0.0, 0.0, -0.3, -0.4], rtol=1e-6)
    assert int(np.sum(got != 0.0)) == 2


def test_parser_mirrors_jax_flags():
    """The JAX driver's flags, defaults and choices, plus --device and
    --period-s (the paper's T by default)."""
    from repro.launch import train as j_train

    def actions(parser):
        return {a.dest: (a.default, tuple(a.choices or ()))
                for a in parser._actions if a.dest != "help"}

    ours, theirs = actions(train.build_parser()), actions(
        j_train.build_parser())
    assert ours.pop("device") == ("cuda", ())
    assert ours.pop("period_s") == (20.0, ())
    assert ours == theirs


# -- co-training's zoo task --------------------------------------------------

def test_zoo_task_trains_with_duration_parity():
    net = network.NetworkConfig(mean_clients=3.0, var_clients=1.0)
    cfg = simulator.SimConfig(policy="es", n_services_total=2,
                              rounds_required=4, p_arrive=2.0,
                              max_periods=16, k_max=5, mean_clients=3.0,
                              var_clients=1.0)
    spec = cotrain.TrainSpec(task="zoo", arch="gemma3-1b", seq_len=8,
                             batch_size=2, eval_batch=2, rounds_cap=2,
                             client_lr=0.1)
    co = cotrain.run_cotrain_scan(cfg, spec, net, device=CPU)
    ref = simulator.run_scan(cfg, net, device=CPU)
    assert co["durations"] == ref["durations"]
    h = co["history"]
    assert np.all(np.isfinite(h["loss"]))
    assert np.all((h["acc"] >= 0.0) & (h["acc"] <= 1.0))
    assert sum(co["trained_rounds"]) > 0
    # the final params: the model's tree, stacked on the service axis
    embed = co["params"]["embed"]
    assert embed.shape[0] == 2 and np.all(np.isfinite(embed))
    # the loss moved where a round ran
    trained = np.asarray(co["trained_rounds"]) > 0
    assert np.any(h["loss"][-1][trained] != h["loss"][0][trained])


def test_zoo_task_validation():
    with pytest.raises(ValueError, match="unknown train task"):
        cotrain._build_task(cotrain.TrainSpec(task="nope"))
    with pytest.raises(ValueError, match="encoder-decoder"):
        cotrain._build_task(
            cotrain.TrainSpec(task="zoo", arch="seamless-m4t-large-v2"))
    from repro_torch import configs
    task = cotrain._build_task(cotrain.TrainSpec(task="zoo",
                                                 arch="xlstm-1.3b"))
    assert task.data.vocab_size == configs.get_smoke_config(
        "xlstm-1.3b").vocab_size


def test_zoo_init_is_seeded_per_service():
    """Service i draws from generator(seed + 7, COTRAIN_SALT, i): two
    services differ, one seed repeats."""
    task = cotrain._build_task(cotrain.TrainSpec(task="zoo"))
    a, b = task.init(0, 2), task.init(0, 2)
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"][0], a["embed"][1])
    assert not torch.equal(task.init(1, 2)["embed"], a["embed"])


# -- one run of the driver ---------------------------------------------------

ARGV = ["--device", "cpu", "--services", "gemma3-1b,llama4-maverick-400b-a17b",
        "--clients", "2", "--local-steps", "1", "--batch", "2", "--seq",
        "16", "--max-rounds-per-period", "2", "--policy", "es"]


def test_driver_trains_and_resumes_bitwise(tmp_path):
    whole = train.main(ARGV + ["--periods", "2"])
    assert len(whole["periods"]) == 2
    for svc, name in zip(whole["services"], ("gemma3-1b",
                                             "llama4-maverick-400b-a17b")):
        assert svc["name"] == name
        want = sum(p["rounds"][whole["services"].index(svc)]
                   for p in whole["periods"])
        assert svc["rounds_done"] == want == len(svc["losses"]) > 0
        assert np.all(np.isfinite(svc["losses"]))
    assert whole["peak_bytes"] is None     # the CPU reports none
    ckpt = str(tmp_path / "ckpt")
    train.main(ARGV + ["--periods", "1", "--checkpoint-dir", ckpt])
    resumed = train.main(ARGV + ["--periods", "2", "--checkpoint-dir", ckpt])
    assert len(resumed["periods"]) == 1 and resumed["periods"][0]["period"] == 1
    assert resumed["rounds_done"] == whole["rounds_done"]
    from repro_torch.tree import leaves_with_names
    for name in whole["params"]:
        got = leaves_with_names(resumed["params"][name])
        want = leaves_with_names(whole["params"][name])
        assert [n for n, _ in got] == [n for n, _ in want]
        for (leaf, x), (_, y) in zip(got, want):
            assert torch.equal(x, y), (name, leaf)
