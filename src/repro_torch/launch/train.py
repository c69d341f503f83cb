"""End-to-end multi-service FL training driver, the counterpart of
``repro.launch.train`` (deliverable b's main entry).

N FL services, each an architecture of the zoo (reduced by default, so
the driver runs on the CPU too), train for real while the allocator paces
their rounds: every period the policy (DISBA / auction / baseline) splits
the band, the intra-service solver splits each share across clients, the
round-time model turns the split into wall-clock time, and each service
runs as many real FedAvg rounds as fit in the period (at most
``--max-rounds-per-period``), with straggler deadlines, optional uplink
compression (priced into s^UT as well) and step-atomic checkpoints.

A round is ``fl.server.make_fl_round_step``: ``torch.func.vmap`` over the
clients of ``grad_and_value(model.loss)``.  On the card the attention of
every transformer layer runs B5 forward and its backward kernels, and
every mLSTM layer of xLSTM B7 forward and its backward kernels, once a
layer a local step with the clients folded into one launch (the sLSTM is
PyTorch ops, as in the JAX model); the service set and the allocations
live on the card too, so ``--intra-backend pallas`` / ``megakernel``
launch B1-B4 there.  ``cfg.remat`` (``jax.checkpoint`` in the JAX
package) is not ported: ``torch.utils.checkpoint`` does not compose with
``torch.func``.

Two additions to the JAX driver's flags and data, both for the full
configs: ``--period-s`` (default the paper's T = 20 s) and a synthetic
chain of at most ``DATA_VOCAB_MAX`` tokens.  A full-width service rarely
fits a round in 20 s (gemma3-1b's 32 Gbit of float32 weights over 10 MHz
take t* = 1514 s), and ``SyntheticLM``'s (V, V) chain at V = 262144 would
hold 275 GB; the smoke configs' vocabularies (512) are far below the cap,
so reduced runs draw exactly the JAX driver's kind of stream.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --services \\
      gemma3-1b,llama4-maverick-400b-a17b --policy coop --periods 4 \\
      --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import intra, network
from repro_torch.core import policy as policy_mod
from repro_torch.core.types import stack_services
from repro_torch.data import SyntheticLM
from repro_torch.fl import compression as fl_comp
from repro_torch.fl import server as fl_server
from repro_torch.fl.service import arch_service_tuple
from repro_torch.models import registry

DATA_VOCAB_MAX = 8192   # tokens of the synthetic chain (a (V, V) table)


def allocate(policy, svc, b_total, n_bids=5, alpha_fair=0.5,
             intra_backend="reference"):
    """Inter-service split through the AllocationPolicy registry."""
    b, _ = policy_mod.allocate(policy, svc, b_total, n_bids=n_bids,
                               alpha_fair=alpha_fair,
                               intra_backend=intra_backend)
    return b


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--services", default="gemma-2b,xlstm-1.3b")
    # "ec" is excluded: the driver applies the optimal per-client split to
    # the service totals, which would mislabel Equal-Client (whose defining
    # property is the uniform per-client split) as something better.
    ap.add_argument("--policy", default="coop",
                    choices=sorted(set(policy_mod.available()) - {"ec"}))
    ap.add_argument("--intra-backend", default="reference",
                    choices=list(policy_mod.INTRA_BACKENDS),
                    help="intra-service solver: the reference bisection or "
                         "the bisect_alloc / market_clear kernels")
    ap.add_argument("--periods", type=int, default=3)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="train the smoke-reduced configs (default); "
                         "--no-reduced trains the full public configs")
    ap.add_argument("--compression", default="none",
                    choices=list(fl_comp.METHODS))
    ap.add_argument("--topk-frac", type=float, default=0.01,
                    help="kept fraction for topk/topk_int8 -- one value "
                         "feeds BOTH the s^UT pricing (compression_ratio) "
                         "and the round step's sparsifier")
    ap.add_argument("--error-feedback", action="store_true", default=False,
                    help="carry client-held compression residuals across "
                         "rounds (Karimireddy-style EF)")
    ap.add_argument("--straggler-deadline-x", type=float, default=3.0,
                    help="deadline = x * optimal round time")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-rounds-per-period", type=int, default=6)
    ap.add_argument("--period-s", type=float,
                    default=network.NetworkConfig().period_s,
                    help="allocation period T in seconds (the paper's 20 s "
                         "by default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def resolve_config(arch: str, reduced: bool):
    """The config branch ``--reduced`` selects (both directions reachable)."""
    return configs.get_smoke_config(arch) if reduced else configs.get_config(arch)


def compression_setup(args) -> dict:
    """The driver's compression knobs from one source: ``ratio``, the s^UT
    multiplier priced into every service tuple, and ``round_step_kwargs``,
    the matching ``make_fl_round_step`` settings.  Both read the same
    ``--topk-frac``, so the allocator never prices a sparsity the round
    step does not transmit."""
    ratio = fl_comp.compression_ratio(args.compression,
                                      k_frac=args.topk_frac)
    return dict(
        ratio=ratio,
        round_step_kwargs=dict(
            compression=args.compression,
            topk_frac=args.topk_frac,
            error_feedback=args.error_feedback,
        ),
    )


def _loss_fn(model, cfg):
    """The service's loss; an enc-dec gets zero frontend embeddings (the
    driver has no modality frontend), as in the JAX package."""
    if cfg.family != "encdec":
        return model.loss

    def loss_fn(p, b):
        b = dict(b)
        b["frontend_embeds"] = torch.zeros(
            (*b["tokens"].shape, cfg.d_model), device=b["tokens"].device)
        return model.loss(p, b)
    return loss_fn


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> dict:
    """Train; prints the JAX driver's lines and returns a summary:
    ``services`` (per service its name, losses per round, rounds done and
    seconds per round), ``periods`` (per period b, t_round and the rounds
    run), ``rounds_done``, ``params`` (per service name), and on the card
    ``peak_bytes`` (``max_memory_allocated`` over the run)."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    arch_names = args.services.split(",")
    rng = np.random.default_rng(args.seed)
    net = network.NetworkConfig(period_s=args.period_s)
    comp = compression_setup(args)
    f32 = dict(dtype=torch.float32, device=device)

    # ---- one FL service per arch: model + data + round step + tuple
    services = []
    for i, name in enumerate(arch_names):
        cfg = resolve_config(name, args.reduced)
        model = registry.build_model(cfg)
        params = model.init(args.seed + i, device=device)
        data = SyntheticLM(vocab_size=min(cfg.vocab_size, DATA_VOCAB_MAX),
                           seq_len=args.seq, seed=args.seed + i,
                           temperature=0.3)
        k = args.clients
        pl_db = torch.as_tensor(85.0 + rng.normal(0, 2.0, size=k), **f32)
        raw = arch_service_tuple(
            cfg,
            r_dl=network.base_rate(torch.tensor(0.2, **f32), pl_db),
            r_ul=network.base_rate(torch.tensor(0.1, **f32), pl_db),
            client_flops=torch.as_tensor(rng.uniform(2e11, 8e11, size=k),
                                         **f32),
            tokens_per_round=args.batch * args.seq,
            uplink_compression=comp["ratio"],
        )
        round_step = fl_server.make_fl_round_step(
            _loss_fn(model, cfg), local_steps=args.local_steps,
            client_lr=1.0, **comp["round_step_kwargs"])
        residuals = (fl_server.init_residuals(params, args.clients)
                     if args.error_feedback else None)
        services.append(dict(name=name, cfg=cfg, model=model, params=params,
                             data=data, raw=raw, round_step=round_step,
                             residuals=residuals, rounds_done=0, losses=[],
                             round_s=[]))

    svc_set = stack_services([s["raw"] for s in services])
    mgr = None
    start_period = 0
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir, keep=2)
        like = {s["name"]: s["params"] for s in services}
        step, restored, extra = mgr.restore_latest(like)
        if step is not None:
            start_period = step
            for s in services:
                s["params"] = restored[s["name"]]
                s["rounds_done"] = extra["rounds_done"][s["name"]]
            print(f"[resume] from period {start_period}")

    # ---- the period loop: allocate -> time rounds -> really train
    client_split = policy_mod.client_split_fn(args.intra_backend)
    clients = np.broadcast_to(np.arange(args.clients)[:, None],
                              (args.clients, args.local_steps))
    periods = []
    for period in range(start_period, args.periods):
        b_alloc = allocate(args.policy, svc_set, net.total_bandwidth_mhz,
                           intra_backend=args.intra_backend)
        t_round = intra.solve_round_time(svc_set, b_alloc)
        client_alloc = client_split(svc_set, b_alloc)
        t_host = t_round.cpu().numpy()
        n_rounds = np.minimum(np.floor(net.period_s / t_host).astype(int),
                              args.max_rounds_per_period)
        b_host = b_alloc.cpu().numpy()
        print(f"\n[period {period}] policy={args.policy} "
              f"b={np.round(b_host, 3)} MHz "
              f"t_round={np.round(t_host, 3)} s rounds={n_rounds}")
        periods.append({"period": period, "b": b_host.tolist(),
                        "t_round": t_host.tolist(),
                        "rounds": n_rounds.tolist()})
        for si, s in enumerate(services):
            # per-client realized latency -> straggler weights
            lat = svc_set.t_comp[si] + svc_set.alpha[si] / torch.clamp(
                client_alloc[si], min=1e-30)
            lat = torch.where(svc_set.mask[si], lat, 0.0)[:args.clients]
            deadline = float(t_host[si]) * args.straggler_deadline_x
            weights = fl_server.straggler_weights(lat, deadline)
            for _ in range(int(n_rounds[si])):
                steps = (s["rounds_done"] * 97
                         + np.arange(args.local_steps)[None, :])
                host = s["data"].batches(np.broadcast_to(steps, clients.shape),
                                         args.batch, clients)
                batches = {key: x.to(device) for key, x in host.items()}
                t0 = time.perf_counter()
                if args.error_feedback:
                    s["params"], metrics, s["residuals"] = s["round_step"](
                        s["params"], batches, weights, s["residuals"])
                else:
                    s["params"], metrics = s["round_step"](
                        s["params"], batches, weights)
                s["losses"].append(float(metrics["loss"]))
                _sync(device)
                s["round_s"].append(time.perf_counter() - t0)
                s["rounds_done"] += 1
            if int(n_rounds[si]):
                print(f"  {s['name']:26s} rounds+={int(n_rounds[si])} "
                      f"loss={s['losses'][-1]:.4f} "
                      f"participants={int(torch.sum(weights))}"
                      f"/{args.clients}")
        if mgr is not None:
            mgr.save(period + 1,
                     {s["name"]: s["params"] for s in services},
                     extra={"rounds_done": {s["name"]: s["rounds_done"]
                                            for s in services}})

    print("\n[summary]")
    for s in services:
        l0 = s["losses"][0] if s["losses"] else float("nan")
        l1 = s["losses"][-1] if s["losses"] else float("nan")
        print(f"  {s['name']:26s} rounds={s['rounds_done']:3d} "
              f"loss {l0:.4f} -> {l1:.4f}")
    return {
        "services": [{"name": s["name"], "losses": s["losses"],
                      "rounds_done": s["rounds_done"],
                      "round_s": s["round_s"]} for s in services],
        "periods": periods,
        "rounds_done": {s["name"]: s["rounds_done"] for s in services},
        "params": {s["name"]: s["params"] for s in services},
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
    }


if __name__ == "__main__":
    main()
