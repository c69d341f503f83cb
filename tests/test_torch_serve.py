"""The port's serving entry point (``repro_torch.launch.serve``): the
regressions of ``tests/test_serve.py`` mirrored with a stub model, and the
reduced gemma3-1b served end to end on the CPU.

The two bugs the JAX serve loop shipped with stay pinned here: ``--reduced``
must be switchable off, and the first generated token must go through the
temperature path (sampled, not argmax) with exactly ``gen`` tokens
emitted after ``gen - 1`` decode launches.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch import serve

_V = 11


class _StubModel:
    """Deterministic toy model: prefill logits ramp up to token _V-1 (the
    argmax), decode logits ramp down to token 0.  The cache carries a length
    counter so decode launches are countable."""

    def prefill(self, params, batch, max_len):
        b, length = batch["tokens"].shape
        logits = (torch.arange(_V, dtype=torch.float32) * 0.1).expand(
            b, length, _V)
        return logits, {"len": length}

    def decode_step(self, params, cache, tok):
        b = tok.shape[0]
        logits = (-torch.arange(_V, dtype=torch.float32) * 0.1).expand(b, 1, _V)
        return logits, {"len": cache["len"] + 1}


# -- the flags ---------------------------------------------------------------

def test_reduced_flag_defaults_on():
    assert serve.build_parser().parse_args([]).reduced is True


def test_reduced_flag_can_be_disabled():
    assert serve.build_parser().parse_args(["--no-reduced"]).reduced is False
    assert serve.build_parser().parse_args(["--reduced"]).reduced is True


def test_device_defaults_to_the_card():
    assert serve.build_parser().parse_args([]).device == "cuda"
    assert serve.build_parser().parse_args(["--device", "cpu"]).device == "cpu"


def test_resolve_config_reaches_both_branches(monkeypatch):
    from repro_torch import configs
    monkeypatch.setattr(configs, "get_smoke_config", lambda arch: "smoke")
    monkeypatch.setattr(configs, "get_config", lambda arch: "full")
    assert serve.resolve_config("any", reduced=True) == "smoke"
    assert serve.resolve_config("any", reduced=False) == "full"


# -- sampling + token count --------------------------------------------------

def _generate(gen, temperature, seed=0, batch_size=2, prompt_len=3):
    batch = {"tokens": torch.zeros((batch_size, prompt_len), dtype=torch.long)}
    return serve.generate(
        _StubModel(), {}, batch, max_len=prompt_len + gen, gen=gen,
        temperature=temperature,
        generator=torch.Generator().manual_seed(seed))


def test_first_token_uses_temperature_path():
    """The first token comes from the same categorical sampler as the rest,
    not argmax.  With seed 0 / temperature 3 on the stub's ramp logits the
    sampled token (6) differs from argmax (10)."""
    out, _ = _generate(gen=3, temperature=3.0, seed=0)
    logits = _StubModel().prefill(
        {}, {"tokens": torch.zeros((2, 3), dtype=torch.long)}, max_len=6)[0]
    expected = serve.sample_token(torch.Generator().manual_seed(0), logits, 3.0)
    assert torch.equal(out[:, :1], expected)
    assert int(expected[0, 0]) != _V - 1, (
        "chosen seed must distinguish sampling from argmax")


def test_first_token_greedy_at_temperature_zero():
    out, _ = _generate(gen=2, temperature=0.0)
    assert int(out[0, 0]) == _V - 1          # prefill argmax
    assert int(out[0, 1]) == 0               # decode argmax


def test_emits_exactly_gen_tokens():
    for gen in (1, 4):
        out, info = _generate(gen=gen, temperature=1.0)
        assert out.shape == (2, gen)
        assert info["decode_steps"] == gen - 1
        # cache counter: prompt_len + one bump per decode launch
        assert int(info["cache"]["len"]) == 3 + (gen - 1)


def test_gen_must_be_positive():
    with pytest.raises(ValueError, match="gen"):
        _generate(gen=0, temperature=1.0)


def test_prefill_timing_measured():
    _, info = _generate(gen=1, temperature=1.0)
    assert info["t_prefill"] > 0.0
    assert info["decode_steps"] == 0


def test_sampling_is_reproducible_from_the_generator():
    a, _ = _generate(gen=5, temperature=1.0, seed=7)
    b, _ = _generate(gen=5, temperature=1.0, seed=7)
    assert torch.equal(a, b)


# -- the reduced gemma3-1b end to end on the CPU -----------------------------

def test_main_serves_reduced_gemma3_on_cpu(capsys):
    """Prompt 20 > the reduced window of 16, 6 tokens greedy: tokens in the
    vocabulary, the cache filled to prompt + gen - 1, finite logits, and no
    kernel launched on the CPU."""
    ops.reset_launches()
    res = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "20",
                      "--gen", "6", "--temperature", "0"])
    tokens, info = res["tokens"], res["info"]
    assert tokens.shape == (2, 6) and tokens.dtype == torch.long
    assert bool(((tokens >= 0) & (tokens < res["config"].vocab_size)).all())
    assert info["cache"]["len"] == 25 and info["decode_steps"] == 5
    assert bool(torch.isfinite(info["logits"]).all())
    assert ops.LAUNCHES == {name: 0 for name in ops.KERNEL_NAMES}
    out = capsys.readouterr().out
    assert "[prefill] 2x20" in out and "[cache]  len=25" in out
    again = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                        "20", "--gen", "6", "--temperature", "0"])
    assert torch.equal(again["tokens"], tokens)
