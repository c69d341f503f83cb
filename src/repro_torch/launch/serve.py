"""Batched serving: prefill + decode loop with a cache, the counterpart of
``repro.launch.serve``.

Serves a (reduced by default; ``--no-reduced`` selects the full public
config) architecture on the card, or on the CPU with ``--device cpu``:
any of the zoo's names through the same ``generate`` -- a KV cache (dense,
MoE, int8), MLA's latent cache, the hybrid's KV and SSM states, the
xLSTM's recurrent states, or the enc-dec's self and cross caches (its
source is the stub frontend's frames: standard normals x 0.1, drawn on a
CPU generator seeded 2, as the JAX serve draws them from a fixed key).
M-RoPE configs (qwen2-vl-7b) need (3, B, S) positions, which this driver
does not build, so they raise here as in the JAX serve; drive them through
``generate`` with the positions in the batch and ``decode_kw``.
Prefill time is read after the device has finished the logits, and every
generated token -- including the first, sampled from the prefill logits --
goes through the same ``--temperature`` path, so the loop emits exactly
``--gen`` sampled tokens with ``gen - 1`` decode launches.

Parameters are drawn in the compute dtype (``init(dtype=...)``: each
matrix cast as soon as it is drawn, bit for bit ``cast_params`` of the
float32 tree, which is never held whole): the same values the JAX model
casts at every use, without re-reading float32 weights at every decode
step.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --batch 4 --prompt-len 64 --gen 32 [--no-reduced] [--device cpu]
  (--arch takes any name of repro_torch.configs.ARCH_NAMES but
  qwen2-vl-7b, whose M-RoPE positions this driver does not build)
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
             temperature: float, generator: torch.Generator,
             decode_kw=None):
    """Prefill then decode ``gen`` tokens.  Returns (tokens (B, gen), info).

    ``decode_kw(pos)``, where given, returns the keyword arguments of the
    decode step that feeds the token at position ``pos`` (tensors, moved to
    the logits' device): M-RoPE's (3, B, 1) positions.

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
    prompt_len = batch["tokens"].shape[1]
    t0 = time.perf_counter()
    for step in range(gen - 1):
        kw = decode_kw(prompt_len + step) if decode_kw else {}
        logits, cache = model.decode_step(
            params, cache, tok,
            **{k: x.to(logits.device) for k, x in kw.items()})
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
    ``{"tokens", "info", "config", "model", "params", "prompts",
    "batch"}``."""
    args = build_parser().parse_args(argv)
    cfg = resolve_config(args.arch, args.reduced)
    model = registry.build_model(cfg)
    params = model.init(args.seed, device=args.device,
                        dtype=cfg.compute_dtype)
    max_len = args.prompt_len + args.gen

    # A CPU generator: the prompts and the sampling noise are the same for
    # one seed on every device.
    generator = torch.Generator().manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=generator).to(args.device)
    batch = {"tokens": prompts}
    if cfg.family == "encdec":
        frames = torch.randn((args.batch, args.prompt_len, cfg.d_model),
                             generator=torch.Generator().manual_seed(2))
        batch["frontend_embeds"] = (frames * 0.1).to(args.device)
    out, info = generate(model, params, batch, max_len=max_len,
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
            "params": params, "prompts": prompts, "batch": batch}


if __name__ == "__main__":
    main()
