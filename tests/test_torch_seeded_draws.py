"""One seed gives the port the same draws on every device.

The port seeds ``torch.Generator``s, and a generator on the card (Philox)
gives another stream than one on the CPU (mt19937) from the same seed.
So every seeded draw -- the episodes' per-period and scenario draws, the
models' initial weights, serving's prompts and sampling noise -- is made
by a CPU generator and then moved to its device.  These tests spy on
``torch.Generator`` while the entry points run for a device other than the
CPU: "cuda" where the call makes its generator before its first copy to the
card, "meta" (shapes only, on any machine) where an engine must get as far
as its first period to make it.  They also pin values of seed 0 on the CPU,
whose draws did not change.  No card is needed.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs, scenarios
from repro_torch.core import network
from repro_torch.fl import simulator
from repro_torch.launch import serve
from repro_torch.models import registry

_REAL_GENERATOR = torch.Generator


@pytest.fixture
def generators_made(monkeypatch):
    """The devices of every ``torch.Generator`` made while the test runs;
    each is handed back as a CPU generator, so the run goes on."""
    made = []

    class Spy:
        def __new__(cls, device="cpu"):
            made.append(torch.device(device))
            return _REAL_GENERATOR()

    monkeypatch.setattr(torch, "Generator", Spy)
    return made


def _no_card_error(fn):
    """Run ``fn``; on a machine without a card, its first copy to "cuda"
    raises, after the generators it makes first were made."""
    if torch.cuda.is_available():
        return fn()
    with pytest.raises((AssertionError, RuntimeError)):
        fn()


@pytest.mark.parametrize("engine", ["run_scan", "run_batch"])
def test_engines_make_only_cpu_generators(generators_made, engine):
    """The episode-static draws, period 0's service draws and the scenario
    processes' initial states all come from CPU generators; on "meta" the
    engine stops at its first host read of the period's result."""
    cfg = simulator.SimConfig(
        n_services_total=4, max_periods=3,
        channel_process=scenarios.spec("gauss_markov"),
        churn_process=scenarios.spec("gilbert"), arrival_process="mmpp")
    run = (simulator.run_scan if engine == "run_scan"
           else lambda c, device: simulator.run_batch(c, [0, 1],
                                                      device=device))
    with pytest.raises(RuntimeError, match="meta"):
        run(cfg, device="meta")
    # arrivals (gaps, state0, flips), counts, period 0's draws, the
    # gauss_markov and gilbert initial states
    assert len(generators_made) >= 7
    assert {d.type for d in generators_made} == {"cpu"}


@pytest.mark.parametrize("arch", ["gemma3-1b", "xlstm-1.3b"])
def test_model_init_makes_a_cpu_generator_for_the_card(generators_made, arch):
    model = registry.build_model(configs.get_smoke_config(arch))
    _no_card_error(lambda: model.init(0, device="cuda"))
    assert [d.type for d in generators_made] == ["cpu"]


def test_serve_makes_a_cpu_generator_for_the_card(generators_made,
                                                  monkeypatch):
    """serve.main's prompt and sampling generator, past a model whose
    init draws nothing."""
    class Model:
        def init(self, seed, *, device, dtype=None):
            return {}

    monkeypatch.setattr(registry, "build_model", lambda cfg: Model())
    _no_card_error(lambda: serve.main(["--device", "cuda", "--gen", "1"]))
    assert [d.type for d in generators_made] == ["cpu"]


def test_generator_source_draws_on_the_cpu_for_any_device():
    src = scenarios.GeneratorSource("cuda", 3, 4)
    for stream in scenarios.STREAMS:
        assert src._gen(stream).device.type == "cpu"
    meta = scenarios.GeneratorSource("meta", 3, 4)
    cpu = scenarios.GeneratorSource("cpu", 3, 4)
    assert meta.normal("fade_re", (2, 3)).device.type == "meta"
    assert torch.equal(cpu.normal("fade_re", (2, 3)),
                       scenarios.GeneratorSource("cpu", 3, 4).normal(
                           "fade_re", (2, 3)))


def test_init_on_meta_draws_nothing(generators_made):
    model = registry.build_model(configs.get_smoke_config("xlstm-1.3b"))
    params = model.init(0, device="meta")
    assert params["embed"].device.type == "meta"
    assert [d.type for d in generators_made] == ["cpu"]


# ---------------------------------------------------------------------------
# Seed 0 on the CPU: the draws are bitwise what they were before the draws
# moved to CPU generators for every device.
# ---------------------------------------------------------------------------

def _f32(values):
    return torch.tensor(values, dtype=torch.float32)


def test_cpu_episode_draws_of_seed_0_are_pinned():
    cfg = simulator.SimConfig()
    net = simulator._default_net(cfg)
    arrivals, counts = simulator._static_draws(cfg, net)
    assert arrivals[:5].tolist() == [7, 9, 24, 30, 31]
    # the counts' own generator since the C4 repair (they shared the
    # arrival gaps' stream before: [26, 22, 31, 23, 29])
    assert counts[:5].tolist() == [26, 26, 35, 24, 27]
    sampler = simulator.default_sampler(cfg, net, counts, "cpu")
    draws = sampler(3)
    raw = draws.services
    assert isinstance(raw, network.ServiceDraws)
    assert torch.equal(raw.eps_client[0, :3], _f32(
        [0.06057475879788399, -0.07181244343519211, -2.0023586750030518]))
    assert torch.equal(raw.p_ul[1, :2], _f32(
        [0.09348950535058975, 0.11211585998535156]))
    assert torch.equal(raw.size_mbit[2], _f32([0.3275477886199951]))
    assert torch.equal(draws.source.uniform("churn", (2, 2)).flatten(), _f32(
        [0.5694994330406189, 0.21035969257354736, 0.8801799416542053,
         0.8947965502738953]))
    assert torch.equal(
        sampler(0).init.normal("init_shadow_service", (3,)),
        _f32([1.6746679544448853, 2.166746139526367, -0.08186504989862442]))


@pytest.mark.parametrize("stream,normal,uniform,exponential", [
    ("init_shadow_service", [0.13992758095264435, -1.0733311176300049],
     0.09632903337478638, 1.472428798675537),
    ("fade_re", [1.8411152362823486, -0.013125333935022354],
     0.7498581409454346, 6.7814764976501465),
    ("churn", [-0.9986135959625244, -0.8271618485450745],
     0.4512622356414795, 0.941860020160675),
    ("gaps", [0.8435521125793457, 1.344171166419983],
     0.14510035514831543, 0.17530998587608337),
])
def test_cpu_stream_draws_of_seed_0_are_pinned(stream, normal, uniform,
                                               exponential):
    src = scenarios.GeneratorSource("cpu", 0, 1)
    assert torch.equal(src.normal(stream, (2,)), _f32(normal))
    assert torch.equal(src.uniform(stream, (1,)), _f32([uniform]))
    assert torch.equal(src.exponential(stream, (1,)), _f32([exponential]))


def test_cpu_model_init_of_seed_0_is_pinned():
    gemma = registry.build_model(configs.get_smoke_config("gemma3-1b"))
    p = gemma.init(0, device="cpu")
    embed_first = _f32([-0.017667515203356743, -0.008378269150853157,
                        -0.016096530482172966])
    assert torch.equal(p["embed"][1, :3], embed_first)
    assert torch.equal(p["blocks"][0]["attn"]["wq"][0, :2], _f32(
        [0.0017056543147191405, 0.03614165261387825]))
    assert torch.equal(p["blocks"][-1]["ffn"]["w_down"][-1, -2:], _f32(
        [-0.09682456403970718, 0.013847648166120052]))
    xl = registry.build_model(configs.get_smoke_config("xlstm-1.3b"))
    p = xl.init(0, device="cpu")
    assert torch.equal(p["embed"][1, :3], embed_first)
    block = p["m_blocks"][0][0]
    assert torch.equal(block["cell"]["w_qkv"][0, 1, :2], _f32(
        [-0.049684200435876846, -0.03059329092502594]))
    assert torch.equal(block["conv_w"][0, :2], _f32(
        [0.3110826313495636, 0.5609446167945862]))
    assert torch.equal(p["s_blocks"][0]["cell"]["r_zifo"][0, 0, :2], _f32(
        [-0.21051426231861115, -0.16897326707839966]))
    assert torch.equal(p["m_blocks"][-1][-1]["w_down"][-1, -2:], _f32(
        [-0.010942949913442135, 0.07754140347242355]))


def test_cpu_sampling_of_seed_0_is_pinned():
    """The exponential race is ``torch.multinomial``'s draw for one sample:
    the CPU's tokens are unchanged."""
    prompts = torch.randint(0, 262144, (2, 5),
                            generator=torch.Generator().manual_seed(1))
    assert prompts.tolist() == [[128037, 229611, 208780, 5192, 229119],
                                [50057, 109259, 73349, 117583, 21440]]
    logits = torch.randn((3, 1, 50), generator=torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(4)
    got = [serve.sample_token(gen, logits, 1.3).flatten().tolist()
           for _ in range(3)]
    assert got == [[13, 33, 12], [18, 40, 36], [22, 44, 37]]
    for seed in range(8):
        probs = torch.softmax(logits[:, -1] / 0.7, dim=-1)
        want = torch.multinomial(probs, 1,
                                 generator=torch.Generator().manual_seed(seed))
        assert torch.equal(serve.sample_token(
            torch.Generator().manual_seed(seed), logits, 0.7), want)
    assert np.array_equal(serve.sample_token(None, logits, 0.0).numpy(),
                          logits[:, -1].argmax(-1, keepdim=True).numpy())


def test_client_counts_and_arrivals_draw_from_separate_streams(monkeypatch):
    """ROADMAP C4: the client counts drew from generator(seed + 7, salt),
    the arrival source's zero-padded "gaps" stream, so each seed's counts
    and gaps came from one sequence of uniforms (per-seed mean count and
    mean arrival correlated, |r| 0.10-0.13; the reference's: 0.01).  No
    two generators of the static draws may share a seed, and over 2000
    seeds the two means are uncorrelated (|r| < 0.06, over 4 standard
    errors short of the fault's)."""
    from repro_torch.scenarios import base

    made = []
    real = base.generator

    def spy(*words):
        made.append(words)
        return real(*words)

    monkeypatch.setattr(base, "generator", spy)
    monkeypatch.setattr(simulator, "generator", spy)
    for process in ("poisson", "mmpp"):
        cfg = simulator.SimConfig(arrival_process=process)
        made.clear()
        simulator._static_draws(cfg, simulator._default_net(cfg))
        seeds = {tuple(np.random.SeedSequence(list(words)).generate_state(4))
                 for words in made}
        assert len(made) >= 2 and len(seeds) == len(made), made
    monkeypatch.undo()
    net = simulator._default_net(simulator.SimConfig())
    arrivals, counts = zip(*(simulator._static_draws(
        simulator.SimConfig(seed=seed), net) for seed in range(2000)))
    r = np.corrcoef(np.mean(arrivals, axis=1), np.mean(counts, axis=1))[0, 1]
    assert abs(r) < 0.06, r
