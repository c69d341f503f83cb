"""Training-in-the-loop co-simulation: allocation-paced FedAvg.

The paper compares allocation policies by what they do to learning: FL
accuracy against wall-clock time (Figs. 16-17).  Every period of a
co-trained episode

  1. runs the same allocation step as ``simulator.run_scan``
     (``simulator._period_step``: the same draws, scenario carries and
     policy, warm starts included), then
  2. turns the allocation into training pace: the allocated per-client
     split gives each client a DT+LC+UT latency, clients past
     ``deadline_x`` times the optimal round time are dropped as
     stragglers (churn has already masked its clients out of the set),
     and each active service runs its simulated number of FedAvg rounds,
     at most ``rounds_cap`` (the shortfall is counted in
     ``clipped_rounds``), and
  3. evaluates every service's model: per-service loss and accuracy
     against the cumulative allocated wall-clock.

With compression off, training only reads what the allocation step
computed, so a co-trained episode's durations are bitwise those of
``run_scan`` on the same draws.  With compression on
(``TrainSpec.compression`` / ``comp_levels`` / ``comp_policy="adaptive"``)
each service's level prices a smaller s^UT into the allocator through the
period step's ``ul_comp`` hook, and the round step applies the same
level's lossy operator to the uploads.

The training is batched as the reference's vmapped scan batches it: per
executed round, one ``torch.func.vmap`` call over services (and, inside
the round step, over clients), with ``r < n_train`` as the mask; the one
host sync a period reads the rounds to execute and the stopping test.
Batches come from ``data.SyntheticLM``'s host stream (one vectorised draw
per round) and are copied to the device; the eval batches are drawn once
per episode.

Train task: ``task="bigram"``, a (V, V) bigram-logit table fit by
cross-entropy to ``SyntheticLM`` sequences (next-token argmax accuracy).
``task="zoo"`` (an architecture of the zoo) is not ported yet and raises.
Service i's initial table comes from ``generator(seed + 7, COTRAIN_SALT,
i)``, a stream no other draw reads.

``attack=`` (a ``chaos.clients.AttackSpec``) turns a seeded fraction of
client slots Byzantine: the (T, N, K) plan of ``ClientChaos`` is drawn on
the host once an episode (shared across seeds, as the reference's) and
copied to the device, and each executed round of period t hands every
service its (K,) row of plan[t].  The attack changes only the uploads, so
the allocation stream, and the durations, stay those of ``run_scan``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import vmap

from repro_torch import scenarios
from repro_torch.core import network, policy as policy_mod
from repro_torch.core.types import default_device
from repro_torch.data import SyntheticLM
from repro_torch.fl import aggregation as fl_agg
from repro_torch.fl import compression as fl_comp
from repro_torch.fl import server as fl_server
from repro_torch.fl import service as fl_service
from repro_torch.fl import simulator
from repro_torch.scenarios import COTRAIN_SALT, generator

# Disjoint client-id stripes per service slot inside one SyntheticLM
# stream; the eval stream uses the top id of each stripe.
_SVC_STRIDE = 1 << 20
_EVAL_CLIENT = _SVC_STRIDE - 1
# Eval batches sit at a step no training round reaches.
_EVAL_STEP = (1 << 30) + 7

_ZOO_ITEM = ("task='zoo' trains a zoo architecture, which needs a backward "
             "through the port's models and kernels (ROADMAP Queue A item "
             "13)")


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """What trains during an episode (the reference's fields, defaults
    and validation).

    ``rounds_cap`` bounds the executed rounds a period (the simulated
    rounds are never altered; the shortfall goes to ``clipped_rounds``).
    ``deadline_x`` scales the straggler deadline off the optimal round
    time (``inf`` admits everyone; the optimal split equalizes admitted
    latencies, so values >= 1 admit every churn survivor and values < 1
    drop everyone).  ``compression`` sets one level for every service,
    ``comp_levels`` (a tuple cycled over the slots) one per service;
    ``comp_policy="adaptive"`` starts every service dense and switches it
    to its level while its share is below ``comp_threshold`` times the fair
    share.  ``error_feedback`` carries client-held residuals through the
    episode; ``index_bits`` is the index width priced into top-k ratios.
    """

    task: str = "bigram"              # "bigram" | "zoo" (not ported)
    arch: str = "gemma3-1b"           # zoo entry for task="zoo"
    vocab: int = 32                   # bigram table / data vocab
    seq_len: int = 8
    batch_size: int = 4
    local_steps: int = 1
    eval_batch: int = 16
    client_lr: float = 0.5
    server_lr: float = 1.0
    prox_mu: float = 0.0
    compression: str = "none"         # fl.compression key
    topk_frac: float = 0.01
    index_bits: int = 32              # index width priced into topk ratios
    comp_levels: tuple | None = None  # per-service levels, cycled over slots
    comp_policy: str = "static"       # "static" | "adaptive"
    comp_threshold: float = 0.5       # adaptive: compress when b < thr*fair
    error_feedback: bool = False      # client-held EF residuals
    deadline_x: float = 3.0
    rounds_cap: int = 4
    data_seed: int = 0
    data_temperature: float = 0.3
    aggregator: str = "fedavg"        # fl.aggregation registry key
    trim_frac: float = 0.1            # trimmed_mean tail fraction per side
    clip_norm: float | None = None    # norm_clip radius (None = median norm)
    byz_f: int = 1                    # krum/multi_krum assumed Byzantine count
    weight_cap: float | None = None   # server.sanitize_weights clip

    def __post_init__(self):
        if self.rounds_cap < 1:
            raise ValueError(f"rounds_cap must be >= 1, got {self.rounds_cap}")
        if self.local_steps < 1:
            raise ValueError(
                f"local_steps must be >= 1, got {self.local_steps}")
        if not self.deadline_x > 0:
            raise ValueError(
                f"deadline_x must be positive, got {self.deadline_x}")
        if self.aggregator not in fl_agg.available():
            raise ValueError(
                f"unknown aggregator {self.aggregator!r}; "
                f"available: {list(fl_agg.available())}")
        if self.comp_levels is not None and (
                not isinstance(self.comp_levels, tuple)
                or not self.comp_levels):
            raise ValueError(
                f"comp_levels must be a non-empty tuple of method names "
                f"(hashable: TrainSpec is a jit static), got "
                f"{self.comp_levels!r}")
        for level in (self.compression,) + (self.comp_levels or ()):
            if level not in fl_comp.METHODS:
                raise ValueError(
                    f"unknown compression level {level!r}; "
                    f"available: {fl_comp.METHODS}")
        if self.comp_policy not in ("static", "adaptive"):
            raise ValueError(
                f"comp_policy must be 'static' or 'adaptive', got "
                f"{self.comp_policy!r}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(
                f"topk_frac must be in (0, 1], got {self.topk_frac}")
        if not self.comp_threshold > 0:
            raise ValueError(
                f"comp_threshold must be positive, got {self.comp_threshold}")


class _CompPlan:
    """Per-service compression plan of one episode.

    ``methods``: the distinct branch methods, ``methods[0] == "none"``;
    ``level_ids``: (N,) each service's target branch; ``ratios``: each
    branch's s^UT multiplier; ``adaptive``: whether the applied level is
    the per-period control (0 or the target) rather than the target.
    """

    def __init__(self, methods, level_ids, ratios, adaptive):
        self.methods = methods
        self.level_ids = level_ids
        self.ratios = ratios
        self.adaptive = adaptive
        # one distinct non-none static level needs no per-service dispatch
        self.multi = adaptive or len(set(level_ids.tolist())) > 1
        self.branch_methods = (
            methods if self.multi else (methods[int(level_ids[0])],))


def _comp_plan(spec: TrainSpec, n_total: int) -> _CompPlan | None:
    """The spec's compression knobs for ``n_total`` slots; None when
    compression is off everywhere."""
    levels = (spec.comp_levels if spec.comp_levels is not None
              else (spec.compression,))
    levels = tuple(levels[i % len(levels)] for i in range(n_total))
    if all(m == "none" for m in levels):
        return None
    methods = ("none",) + tuple(
        dict.fromkeys(m for m in levels if m != "none"))
    level_ids = np.array([methods.index(m) for m in levels], np.int32)
    ratios = np.array(
        [fl_comp.compression_ratio(m, spec.topk_frac,
                                   index_bits=spec.index_bits)
         for m in methods], np.float32)
    return _CompPlan(methods, level_ids, ratios,
                     spec.comp_policy == "adaptive")


def _log_likelihood(logits: torch.Tensor, labels: torch.Tensor):
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(logp, -1, labels[..., None])[..., 0]


def bigram_loss(table: torch.Tensor, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of a (V, V) bigram-logit table.  The
    rows are looked up as a one-hot product: the same values as indexing,
    and a backward without scattered adds, whose atomics on the card
    would make two runs' tables differ in their last bits."""
    vocab = torch.arange(table.shape[0], device=table.device)
    one_hot = (batch["tokens"][..., None] == vocab).to(table.dtype)
    return -torch.mean(_log_likelihood(one_hot @ table, batch["labels"]))


def _eval_metrics(logits: torch.Tensor, labels: torch.Tensor):
    """(loss, accuracy) over every axis after the first (the service)."""
    dims = tuple(range(1, labels.dim()))
    loss = -torch.mean(_log_likelihood(logits, labels), dim=dims)
    hit = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
    return loss, torch.mean(hit, dim=dims)


def _round_steps(spec: TrainSpec, methods, attack=None) -> list[Callable]:
    """One round step per branch method, alike but for ``compression``."""
    kwargs = dict(local_steps=spec.local_steps, client_lr=spec.client_lr,
                  server_lr=spec.server_lr, prox_mu=spec.prox_mu,
                  topk_frac=spec.topk_frac,
                  error_feedback=spec.error_feedback,
                  aggregator=spec.aggregator, trim_frac=spec.trim_frac,
                  clip_norm=spec.clip_norm, byz_f=spec.byz_f,
                  weight_cap=spec.weight_cap, attack=attack)
    return [fl_server.make_fl_round_step(bigram_loss, compression=m,
                                         **kwargs) for m in methods]


def default_data(spec: TrainSpec) -> SyntheticLM:
    """The episode's data stream: ``SyntheticLM`` at the spec's vocab,
    sequence length, seed and temperature."""
    return SyntheticLM(vocab_size=spec.vocab, seq_len=spec.seq_len,
                       seed=spec.data_seed,
                       temperature=spec.data_temperature)


def default_init_params(seed: int, spec: TrainSpec,
                        n_total: int) -> np.ndarray:
    """(N, V, V) float32 initial tables: service i's 0.01 x normal from
    generator(seed + 7, COTRAIN_SALT, i), drawn on the CPU."""
    return np.stack([
        0.01 * torch.randn((spec.vocab, spec.vocab), generator=generator(
            seed + 7, COTRAIN_SALT, i)).numpy()
        for i in range(n_total)])


def _tokens(x, device) -> torch.Tensor:
    """A batch stream's token array (a tensor or array-like) as int64 on
    ``device``."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x, dtype=np.int64))
    return x.to(device=device, dtype=torch.int64)


def _check_spec(spec: TrainSpec, attack) -> None:
    if attack is not None:
        from repro_torch.chaos.clients import AttackSpec
        if not isinstance(attack, AttackSpec):
            raise TypeError(f"attack must be a chaos.clients.AttackSpec, "
                            f"got {type(attack).__name__}")
    if spec.task == "zoo":
        raise NotImplementedError(_ZOO_ITEM)
    if spec.task != "bigram":
        raise ValueError(
            f"unknown train task {spec.task!r}; expected 'bigram' or 'zoo'")


@dataclasses.dataclass
class _CotrainEpisode:
    rounds_done: np.ndarray     # (N,) int32
    duration: np.ndarray        # (N,) int32
    trained: np.ndarray         # (N,) int32 executed rounds
    clipped: int                # simulated rounds past rounds_cap
    params: np.ndarray          # (N, V, V) float32 final tables
    history: dict               # key -> (periods run, ...) numpy stack
    next_comp: np.ndarray       # (N,) int32 applied level after the last
    fallbacks: int


def _train_rounds(steps: list, applied_ids, params, resid, weights,
                  n_train, n_train_host: np.ndarray,
                  trained_host: np.ndarray, data, spec: TrainSpec,
                  k_max: int, device, byz=None):
    """Run max(n_train) rounds for every service at once: round r is one
    vmapped step over services, applied where r < n_train.  With several
    branch steps (a per-service or adaptive compression plan) every
    branch runs for every service, as the reference's vmapped switch
    does, and each service keeps its applied branch's result.  ``byz``
    (N, K): the period's Byzantine clients, the same every round.
    Returns (params, resid, mean training loss per service)."""
    n, e, ef = len(n_train_host), spec.local_steps, spec.error_feedback
    clients = (np.arange(n, dtype=np.int64)[:, None, None] * _SVC_STRIDE
               + np.arange(k_max, dtype=np.int64)[None, :, None])
    clients = np.broadcast_to(clients, (n, k_max, e))
    loss_sum = torch.zeros((n,), dtype=torch.float32, device=device)

    def pick(branches: list) -> torch.Tensor:
        out = branches[0]
        for j, x in enumerate(branches[1:], start=1):
            sel = (applied_ids == j).reshape((-1,) + (1,) * (x.dim() - 1))
            out = torch.where(sel, x, out)
        return out

    for r in range(int(n_train_host.max(initial=0))):
        step_ids = (((trained_host + r) * e)[:, None, None]
                    + np.arange(e, dtype=np.int64)[None, None, :])
        host = data.batches(np.broadcast_to(step_ids, clients.shape),
                            spec.batch_size, clients)
        batches = {k: _tokens(v, device) for k, v in host.items()}
        args = ((params, batches, weights) + ((resid,) if ef else ())
                + (() if byz is None else (byz,)))
        outs = [vmap(step)(*args) for step in steps]
        do = r < n_train
        params = torch.where(do[:, None, None],
                             pick([o[0] for o in outs]), params)
        if ef:
            resid = torch.where(do[:, None, None, None],
                                pick([o[2] for o in outs]), resid)
        loss_sum = loss_sum + torch.where(
            do, pick([o[1]["loss"] for o in outs]), 0.0)
    return params, resid, loss_sum / torch.clamp(n_train, min=1)


def _run_cotrain_episode(cfg: simulator.SimConfig, spec: TrainSpec,
                         net: network.NetworkConfig, arrivals, counts,
                         sampler, data, init_params, device, attack=None
                         ) -> _CotrainEpisode:
    """The period loop of one co-trained episode, up to and including the
    period in which every service finished (or ``max_periods``)."""
    n, k_max = cfg.n_services_total, simulator._k_cap(cfg)
    pol = policy_mod.get_stateful_policy(
        cfg.policy, warm_start=cfg.warm_start, n_bids=cfg.n_bids,
        alpha_fair=cfg.alpha_fair, intra_backend=cfg.intra_backend)
    chan = scenarios.get_channel(cfg.channel_process, net)
    churn = scenarios.get_churn(cfg.churn_process, net)
    pol_state = pol.init_state(n, device)
    split_fn = policy_mod.client_split_fn(cfg.intra_backend)
    time_fn = policy_mod.round_time_fn(cfg.intra_backend)

    plan = _comp_plan(spec, n)
    steps = _round_steps(spec, plan.branch_methods if plan is not None
                         else ("none",), attack)
    byz_plan = None
    if attack is not None:
        from repro_torch.chaos.clients import ClientChaos
        byz_plan = torch.from_numpy(ClientChaos(attack).plan(
            cfg.max_periods, n, k_max)).to(device)
    if plan is not None:
        level_ids = torch.as_tensor(plan.level_ids, device=device)
        ratios = torch.as_tensor(plan.ratios, device=device)
    zeros_n = torch.zeros((n,), dtype=torch.int32, device=device)
    comp_ids = zeros_n

    init_params = np.array(init_params, np.float32)
    want = (n, spec.vocab, spec.vocab)
    if init_params.shape != want:
        raise ValueError(f"init_params must be (n_services_total, vocab, "
                         f"vocab) = {want}, got {init_params.shape}")
    params = torch.from_numpy(init_params).to(device)
    resid = (torch.zeros((n, k_max) + want[1:], dtype=torch.float32,
                         device=device) if spec.error_feedback else None)
    ev = data.batches(_EVAL_STEP, spec.eval_batch,
                      np.arange(n, dtype=np.int64) * _SVC_STRIDE
                      + _EVAL_CLIENT)
    ev_tokens, ev_labels = (_tokens(ev[k], device)
                            for k in ("tokens", "labels"))
    svc_ids = torch.arange(n, device=device)[:, None, None]

    arrivals_t = torch.as_tensor(np.array(arrivals), dtype=torch.int32,
                                 device=device)
    rounds_done = torch.zeros((n,), dtype=torch.int32, device=device)
    duration = torch.zeros((n,), dtype=torch.int32, device=device)
    trained = torch.zeros((n,), dtype=torch.int32, device=device)
    trained_host = np.zeros((n,), np.int64)
    clipped = torch.zeros((), dtype=torch.int32, device=device)
    history = []
    sampler, own = simulator._episode_sampler(cfg, net, counts, sampler,
                                              device)
    try:
        for period in range(cfg.max_periods):
            draws = simulator._period_draws(sampler, period, cfg, device,
                                            chan)
            if period == 0:
                init = draws.init or scenarios.GeneratorSource(
                    device, cfg.seed + 7)
                chan_state = chan.init(init, n, k_max)
                churn_state = churn.init(init, n, k_max)
            prev_rounds = rounds_done
            # the levels applied THIS period (allocation and training
            # agree on what each service transmits)
            if plan is None:
                applied_ids, ul_comp = zeros_n, None
            else:
                applied_ids = comp_ids if plan.adaptive else level_ids
                ul_comp = ratios[applied_ids]
            (rounds_done, duration, chan_state, churn_state, pol_state,
             stats, ex) = simulator._period_step(
                rounds_done, duration, chan_state, churn_state, pol_state,
                period, arrivals_t, draws, None, ul_comp,
                policy_fn=pol.step, chan_step=chan.step,
                churn_step=churn.step, chan_rebuilds=chan.rebuilds,
                net=net, rounds_required=cfg.rounds_required)
            svc, b, f, active = ex["svc"], ex["b"], ex["f"], ex["active"]
            # the rounds that count toward the episode, then the executed
            eff = torch.where(active, torch.minimum(
                ex["rounds"], cfg.rounds_required - prev_rounds), 0)
            n_train = torch.clamp(eff, max=spec.rounds_cap)
            clipped = clipped + torch.sum(eff - n_train)
            # allocated per-client latency against the deadline
            t_round = time_fn(svc, b)
            b_clients = split_fn(svc, b)
            lat = svc.t_comp + svc.alpha / torch.clamp(b_clients, min=1e-30)
            admitted = torch.logical_and(
                svc.mask, torch.where(svc.mask, lat, torch.inf)
                <= spec.deadline_x * t_round[:, None])
            weights = admitted.to(torch.float32)
            # the period's one host sync: the rounds to run and the stop
            sync = torch.cat([n_train, stats["all_done"].to(
                torch.int32).reshape(1)]).cpu().numpy()
            n_train_host = sync[:-1].astype(np.int64)
            params, resid, train_loss = _train_rounds(
                steps, applied_ids, params, resid, weights, n_train,
                n_train_host, trained_host, data, spec, k_max, device,
                None if byz_plan is None else byz_plan[period])
            trained = trained + n_train
            trained_host += n_train_host
            ev_loss, ev_acc = _eval_metrics(params[svc_ids, ev_tokens],
                                            ev_labels)
            if plan is not None and plan.adaptive:
                # the control for the NEXT period, from this period's split
                n_active = torch.sum(active.to(torch.float32))
                fair = net.total_bandwidth_mhz / torch.clamp(n_active,
                                                             min=1.0)
                tight = torch.logical_and(active,
                                          b < spec.comp_threshold * fair)
                comp_ids = torch.where(tight, level_ids, 0).to(torch.int32)
            history.append({
                "loss": ev_loss, "acc": ev_acc, "train_loss": train_loss,
                "b": b, "f": f, "active": active, "rounds": eff,
                "trained": n_train,
                # clients that trained this period: 0 when no round ran
                "participants": torch.where(
                    n_train > 0,
                    torch.sum(weights, dim=-1).to(torch.int32), 0),
                "comp_id": applied_ids,
                "ul_mult": (ul_comp if ul_comp is not None
                            else torch.ones((n,), dtype=torch.float32,
                                            device=device)),
                "freq_sum": stats["freq_sum"],
                "objective": stats["objective"],
                "all_done": stats["all_done"]})
            if sync[-1]:
                break
    finally:
        if own is not None:
            own.close()
    stacked = {k: torch.stack([h[k] for h in history]).cpu().numpy()
               .astype(_HISTORY_DTYPES[k]) for k in history[0]}
    return _CotrainEpisode(
        rounds_done=rounds_done.cpu().numpy(),
        duration=duration.cpu().numpy(), trained=trained.cpu().numpy(),
        clipped=int(clipped), params=params.cpu().numpy(), history=stacked,
        next_comp=comp_ids.cpu().numpy(),
        fallbacks=policy_mod.fallback_count(pol_state))


_CURVE_KEYS = ("loss", "acc", "train_loss", "b", "f", "active", "rounds",
               "trained", "participants", "comp_id", "ul_mult",
               "freq_sum", "objective")
# The dtypes of the reference's history.
_HISTORY_DTYPES = {"loss": np.float32, "acc": np.float32,
                   "train_loss": np.float32, "b": np.float32,
                   "f": np.float32, "active": np.bool_, "rounds": np.int32,
                   "trained": np.int32, "participants": np.int32,
                   "comp_id": np.int32, "ul_mult": np.float32,
                   "freq_sum": np.float32, "objective": np.float32,
                   "all_done": np.bool_}


def _pad_history(ep: _CotrainEpisode, spec: TrainSpec, n: int,
                 max_periods: int) -> dict:
    """An episode's curves extended to ``max_periods`` with what the
    reference's scan computes after every service finished: nothing
    active, allocated or trained; the eval curves flat at their last
    value (the tables no longer change); the applied level the control
    last chose, then dense (or the static levels)."""
    hist = ep.history
    pad = max_periods - len(hist["all_done"])
    if pad == 0:
        return dict(hist)
    plan = _comp_plan(spec, n)
    if plan is None:
        comp = np.zeros((pad, n), np.int32)
    elif plan.adaptive:
        comp = np.zeros((pad, n), np.int32)
        comp[0] = ep.next_comp
    else:
        comp = np.broadcast_to(plan.level_ids, (pad, n)).astype(np.int32)
    ul = (np.ones((pad, n), np.float32) if plan is None
          else plan.ratios[comp].astype(np.float32))
    fill = {"loss": np.repeat(hist["loss"][-1:], pad, axis=0),
            "acc": np.repeat(hist["acc"][-1:], pad, axis=0),
            "comp_id": comp, "ul_mult": ul,
            "all_done": np.ones((pad,), np.bool_)}
    out = {}
    for key, x in hist.items():
        tail = fill.get(key)
        if tail is None:
            tail = np.zeros((pad,) + x.shape[1:], x.dtype)
        out[key] = np.concatenate([x, tail.astype(x.dtype)])
    return out


def _inputs(cfg, net, arrivals, counts, device):
    device = torch.device(device) if device is not None else default_device()
    net = net or simulator._default_net(cfg)
    simulator._check_run_inputs(cfg, arrivals, counts)
    return device, net


def run_cotrain_scan(cfg: simulator.SimConfig, train: TrainSpec | None = None,
                     net: network.NetworkConfig | None = None, *,
                     arrivals=None, counts=None,
                     sampler: Callable | None = None, data=None,
                     init_params=None, device=None, attack=None) -> dict:
    """Co-train one episode.

    Returns ``run_scan``'s summary keys (durations bitwise those of
    ``run_scan`` on the same draws) and the learning record: per-period
    ``history`` curves (eval ``loss``/``acc``, ``train_loss``, simulated
    and executed rounds, participants, applied levels, the allocation), the
    ``time_s`` wall-clock axis, ``trained_rounds`` and ``clipped_rounds``,
    the final (N, V, V) tables ``params`` (host numpy) and ``services``,
    the episode's ``FLService`` records.

    ``arrivals``/``counts``/``sampler`` replace the draws as in
    ``run_scan``; ``data`` the batch stream (any object with
    ``batches(step, batch_size, client_ids)``, ``step`` an int or an array
    of the ids' shape); ``init_params`` the (N, V, V) initial tables;
    ``attack`` a ``chaos.clients.AttackSpec`` (Byzantine clients, see the
    module docstring).  The episode runs on ``device`` (default: the
    card).
    """
    train = train or TrainSpec()
    _check_spec(train, attack)
    device, net = _inputs(cfg, net, arrivals, counts, device)
    if arrivals is None:
        arrivals, counts = simulator._static_draws(cfg, net)
    if init_params is None:
        init_params = default_init_params(cfg.seed, train,
                                          cfg.n_services_total)
    ep = _run_cotrain_episode(cfg, train, net, arrivals, counts, sampler,
                              data or default_data(train), init_params,
                              device, attack)
    periods = len(ep.history["all_done"])
    return {
        "avg_duration": float(np.mean(ep.duration)),
        "std_duration": float(np.std(ep.duration)),
        "durations": [int(d) for d in ep.duration],
        "periods": periods,
        "finished": bool(np.all(ep.rounds_done >= cfg.rounds_required)),
        "fallbacks": ep.fallbacks,
        "trained_rounds": [int(t) for t in ep.trained],
        "clipped_rounds": ep.clipped,
        "time_s": np.arange(1, periods + 1) * net.period_s,
        "history": {k: ep.history[k] for k in _CURVE_KEYS},
        "services": fl_service.episode_services(
            np.asarray(arrivals), np.asarray(counts), ep.rounds_done,
            ep.duration, cfg.rounds_required),
        "params": ep.params,
    }


def run_cotrain_batch(cfg: simulator.SimConfig,
                      train: TrainSpec | None = None, seeds=(0,),
                      net: network.NetworkConfig | None = None, *,
                      arrivals=None, counts=None, samplers=None, data=None,
                      init_params=None, device=None, attack=None) -> dict:
    """One co-trained episode per seed (``cfg`` with ``seed`` replaced),
    stacked as the reference's vmapped batch: durations (S, N), periods
    (S,), trained_rounds (S, N), clipped_rounds (S,), history curves
    (S, max_periods, N) (the periods after an episode stopped hold what
    the reference's scan computes there), params (S, N, V, V).  Seed i is
    bitwise its own ``run_cotrain_scan``.  ``arrivals``/``counts`` are
    (S, N), ``samplers`` one per seed, ``init_params`` (S, N, V, V)."""
    train = train or TrainSpec()
    _check_spec(train, attack)
    device, net = _inputs(cfg, net, arrivals, counts, device)
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("run_cotrain_batch needs at least one seed")
    if samplers is not None and len(samplers) != len(seeds):
        raise ValueError(f"got {len(samplers)} samplers for {len(seeds)} "
                         f"seeds")
    data = data or default_data(train)
    n = cfg.n_services_total
    episodes, statics = [], []
    for i, seed in enumerate(seeds):
        cfg_i = dataclasses.replace(cfg, seed=seed)
        arr, cnt = ((np.asarray(arrivals)[i], np.asarray(counts)[i])
                    if arrivals is not None
                    else simulator._static_draws(cfg_i, net))
        init = (np.asarray(init_params)[i] if init_params is not None
                else default_init_params(seed, train, n))
        episodes.append(_run_cotrain_episode(
            cfg_i, train, net, arr, cnt,
            None if samplers is None else samplers[i], data, init, device,
            attack))
        statics.append((arr, cnt))
    duration = np.stack([ep.duration for ep in episodes]).astype(np.int32)
    rounds_done = np.stack([ep.rounds_done for ep in episodes])
    padded = [_pad_history(ep, train, n, cfg.max_periods) for ep in episodes]
    return {
        "seeds": seeds,
        "avg_duration": duration.mean(axis=1),
        "std_duration": duration.std(axis=1),
        "durations": duration,
        "periods": np.array([len(ep.history["all_done"])
                             for ep in episodes]),
        "finished": np.all(rounds_done >= cfg.rounds_required, axis=1),
        "fallbacks": np.array([ep.fallbacks for ep in episodes]),
        "trained_rounds": np.stack([ep.trained for ep in episodes]),
        "clipped_rounds": np.array([ep.clipped for ep in episodes],
                                   np.int32),
        "time_s": np.arange(1, cfg.max_periods + 1) * net.period_s,
        "history": {k: np.stack([h[k] for h in padded])
                    for k in _CURVE_KEYS},
        "services": [
            fl_service.episode_services(arr, cnt, ep.rounds_done,
                                        ep.duration, cfg.rounds_required)
            for (arr, cnt), ep in zip(statics, episodes)],
        "params": np.stack([ep.params for ep in episodes]),
    }


def run_cotrain_fleet(cfg: simulator.SimConfig,
                      train: TrainSpec | None = None, seeds=(0,),
                      net: network.NetworkConfig | None = None, *,
                      mesh=None, chunk_size: int | None = None, data=None,
                      device=None, attack=None) -> dict:
    """A co-trained Monte-Carlo sweep over ``seeds`` in chunks of
    ``chunk_size`` (``simulator.fleet_geometry``), each chunk as
    ``run_cotrain_batch`` runs it, its outputs on the host before the next
    starts.  Per seed bitwise ``run_cotrain_batch``'s; plus a ``"fleet"``
    record of the geometry."""
    train = train or TrainSpec()
    _check_spec(train, attack)
    seeds = [int(s) for s in seeds]
    _, axis, n_dev, chunk, n_chunks, padded = simulator.fleet_geometry(
        seeds, mesh, chunk_size)
    parts = [run_cotrain_batch(cfg, train, part, net, data=data,
                               device=device, attack=attack)
             for part in simulator.fleet_chunks(seeds, chunk)]
    out = simulator._concat([{k: v for k, v in p.items() if k != "time_s"}
                             for p in parts])
    out["time_s"] = parts[0]["time_s"]
    out["fleet"] = {"n_devices": n_dev, "mesh_axis": axis, "chunk": chunk,
                    "n_chunks": n_chunks, "padded_to": len(padded)}
    return out
