"""Batched serving: prefill + decode loop with a cache, the counterpart of
``repro.launch.serve``.

Serves a (reduced by default; ``--no-reduced`` selects the full public
config) architecture on the card, or on the CPU with ``--device cpu``:
gemma3-1b (a KV cache) or xlstm-1.3b (a recurrent state cache), through the
same ``generate``.
Prefill time is read after the device has finished the logits, and every
generated token -- including the first, sampled from the prefill logits --
goes through the same ``--temperature`` path, so the loop emits exactly
``--gen`` sampled tokens with ``gen - 1`` decode launches.

Parameters are drawn in float32 and cast once to the compute dtype before
serving (the model's ``cast_params``; the float32 tree is then dropped):
the same values the JAX model casts at every use, without re-reading the
float32 weights at every decode step.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --batch 4 --prompt-len 64 --gen 32 [--no-reduced] [--device cpu]
  (--arch xlstm-1.3b serves the xLSTM)
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.models import registry


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the smoke-reduced config (default); "
                         "--no-reduced serves the full public config")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def resolve_config(arch: str, reduced: bool):
    """The config branch ``--reduced`` selects (both directions reachable)."""
    return configs.get_smoke_config(arch) if reduced else configs.get_config(arch)


def sample_token(gen: torch.Generator, logits: torch.Tensor,
                 temperature: float) -> torch.Tensor:
    """(B, 1) next token from final-position logits: categorical at
    ``temperature`` > 0, greedy argmax at 0.  Used for EVERY generated
    token, including the first one off the prefill logits.

    The categorical draw is ``argmax(p / q)`` with q ~ Exp(1) per (row,
    token), the exponential race that ``torch.multinomial`` runs for one
    sample: q comes from ``gen`` (a CPU generator) and is moved to the
    logits' device, so one seed samples the same noise on every device,
    and on the CPU the tokens are ``multinomial``'s bit for bit."""
    last = logits[:, -1].float()
    if temperature > 0:
        probs = torch.softmax(last / temperature, dim=-1)
        q = torch.empty(probs.shape, dtype=probs.dtype,
                        device=gen.device).exponential_(generator=gen)
        return torch.argmax(probs / q.to(probs.device), dim=-1, keepdim=True)
    return torch.argmax(last, dim=-1, keepdim=True)


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def generate(model, params, batch: dict, *, max_len: int, gen: int,
             temperature: float, generator: torch.Generator):
    """Prefill then decode ``gen`` tokens.  Returns (tokens (B, gen), info).

    ``info`` carries wall-clock timings measured on finished device work:
    ``t_prefill`` waits for the prefill logits before reading the clock,
    and ``decode_steps`` counts the ``gen - 1`` decode launches that follow
    the first token (sampled from the prefill logits through the same
    temperature path as the rest); ``prefill_logits`` and ``logits`` are
    the first and the last step's.
    """
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_len=max_len)
    _sync(logits)
    t_prefill = time.perf_counter() - t0

    prefill_logits = logits
    tok = sample_token(generator, logits, temperature)
    generated = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = model.decode_step(params, cache, tok)
        tok = sample_token(generator, logits, temperature)
        generated.append(tok)
    _sync(tok)
    t_decode = time.perf_counter() - t0
    out = torch.cat(generated, dim=1)
    info = {"t_prefill": t_prefill, "t_decode": t_decode,
            "decode_steps": gen - 1, "cache": cache, "logits": logits,
            "prefill_logits": prefill_logits}
    return out, info


def main(argv: list[str] | None = None) -> dict:
    """Serve one batch of random prompts; prints a summary and returns
    ``{"tokens", "info", "config", "model", "params", "prompts"}``."""
    args = build_parser().parse_args(argv)
    cfg = resolve_config(args.arch, args.reduced)
    model = registry.build_model(cfg)
    params = model.cast_params(model.init(args.seed, device=args.device))
    max_len = args.prompt_len + args.gen

    # A CPU generator: the prompts and the sampling noise are the same for
    # one seed on every device.
    generator = torch.Generator().manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=generator).to(args.device)
    out, info = generate(model, params, {"tokens": prompts}, max_len=max_len,
                         gen=args.gen, temperature=args.temperature,
                         generator=generator)
    steps = max(info["decode_steps"], 1)
    print(f"[prefill] {args.batch}x{args.prompt_len} in "
          f"{info['t_prefill']:.3f}s")
    print(f"[decode] {info['decode_steps']} steps in {info['t_decode']:.3f}s "
          f"({1000 * info['t_decode'] / steps:.1f} ms/tok/batch)")
    print(f"[tokens] {out.shape[1]} generated; first sequence: "
          f"{out[0][:16].tolist()} ...")
    print(f"[cache]  len={int(info['cache']['len'])}")
    return {"tokens": out, "info": info, "config": cfg, "model": model,
            "params": params, "prompts": prompts}


if __name__ == "__main__":
    main()
