"""Run one job of the port's multi-rank tests on N gloo ranks of this host.

    PYTHONPATH=src python tests/torch_ranks.py JOB N DIR

spawns N processes that join a gloo world through a ``FileStore`` in DIR
(no TCP port, so concurrent runs cannot collide), each on one intra-op
thread.  Rank r runs ``JOBS[JOB](inputs)`` on the pickled inputs in
``DIR/inputs.pkl`` and writes its result (or its traceback) to
``DIR/rank<r>.pkl``.  ``launch(job, n, inputs)`` does all of that from a
test, in a subprocess under a timeout, and returns the ranks' results in
rank order.  The jobs import only the port (no JAX): the tests compare
their results with the JAX package in their own process.  The file's
name keeps it out of pytest's collection.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# Jobs: each runs on every rank, with the same inputs, and returns a
# picklable result (numpy arrays, dicts, lists, strings).
# ---------------------------------------------------------------------------

def disba_sharded_job(inputs: dict) -> dict:
    """Every case of ``inputs`` (name -> {"svc": (alpha, t_comp, mask),
    "mesh": None or (sizes, names), "B", "kw"}) through
    ``disba.disba_sharded`` on the CPU: (b, f, lam), or the message of the
    ``ValueError`` it raised."""
    from repro_torch import interop
    from repro_torch.core import disba
    from repro_torch.launch import mesh as mesh_lib

    out = {}
    for name, case in inputs.items():
        svc = interop.service_set_from_arrays(*case["svc"],
                                              device=torch.device("cpu"))
        mesh = (None if case["mesh"] is None
                else mesh_lib.make_mesh(*case["mesh"]))
        try:
            res = disba.disba_sharded(mesh, svc, case["B"], **case["kw"])
        except ValueError as err:
            out[name] = {"raises": str(err)}
            continue
        out[name] = {k: getattr(res, k).numpy() for k in ("b", "f", "lam")}
    return out


def distributed_job(inputs: dict) -> dict:
    """The collectives on a (pod 2, data 4) mesh, each rank holding its
    block of rows of ``inputs["x"]``; the mesh constructors' refusals; and
    ``inputs["fleets"]`` (name -> (engine, args, kwargs)) through
    ``run_fleet`` / ``run_cotrain_fleet`` on the CPU."""
    from repro_torch.distributed import collectives
    from repro_torch.fl import cotrain, simulator
    from repro_torch.launch import mesh as mesh_lib

    out = {"world": mesh_lib.world_size()}
    mesh = mesh_lib.make_mesh((2, 4), ("pod", "data"))
    block = mesh.coordinate("pod") * 4 + mesh.coordinate("data")
    x = torch.as_tensor(inputs["x"])
    rows = x.shape[0] // mesh.size
    local = x[block * rows:(block + 1) * rows]
    out["block"] = block
    out["hierarchical"] = collectives.hierarchical_psum(
        local, "data", "pod", mesh=mesh).numpy()
    out["made"] = collectives.make_hierarchical_allreduce(mesh)(local).numpy()
    full, resid = collectives.compressed_psum_int8(local, "data", "pod",
                                                   mesh=mesh)
    out["compressed"] = (full.numpy(), resid.numpy())
    refusals = {}
    for name, make in (("fleet_4", lambda: mesh_lib.make_fleet_mesh(4)),
                       ("production", mesh_lib.make_production_mesh),
                       ("elastic_16", lambda: mesh_lib.make_elastic_mesh(16))):
        try:
            make()
            refusals[name] = None
        except ValueError as err:
            refusals[name] = str(err)
    out["refusals"] = refusals
    out["elastic"] = mesh_lib.make_elastic_mesh(mesh_lib.world_size(),
                                                4).shape
    engines = {"run_fleet": simulator.run_fleet,
               "run_cotrain_fleet": cotrain.run_cotrain_fleet}
    out["fleets"] = {}
    for name, (engine, args, kwargs) in inputs.get("fleets", {}).items():
        if kwargs.pop("explicit_mesh", False):
            kwargs["mesh"] = mesh_lib.make_fleet_mesh(mesh_lib.world_size())
        out["fleets"][name] = engines[engine](*args, **kwargs,
                                              device=torch.device("cpu"))
    return out


def _named(tree) -> dict:
    from repro_torch.tree import leaves_with_names

    return dict(leaves_with_names(tree))


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (differentiably), a plain tensor itself."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _numpy(x) -> np.ndarray:
    return _whole(x).detach().numpy()


def ep_moe_job(inputs: dict) -> dict:
    """The expert-parallel MoE per case of ``inputs["cases"]`` (name ->
    {"mesh": (sizes, names), "cfg": ModelConfig fields, "p": the layer's
    parameters as numpy, "x"}): ``moe.apply_moe`` (which dispatches to
    ``_apply_moe_ep``) on the whole values held by every rank, then on
    ``elastic.reshard``'s DTensors and x split over the data axes, with
    FSDP off and on.  Each run's out, aux and the gradients of
    sum(out ** 2) + AUX_WEIGHT aux, each resharded leaf's local block and
    this rank's mesh coordinates; and ``api.constrain`` of one DTensor
    (``inputs["constrain"]``, replicated on the first case's mesh) to
    ("batch", None, "vocab") and to ("batch", "vocab", None), and of a
    plain tensor."""
    from repro_torch.distributed import api, elastic, specs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    from repro_torch.tree import tree_map

    def run(p, x, cfg):
        leaves = _named(p)
        for leaf in leaves.values():
            leaf.requires_grad_()
        x.requires_grad_()
        o, aux = moe.apply_moe(p, x, cfg)
        ((_whole(o) ** 2).sum()
         + inputs["aux_weight"] * _whole(aux)).backward()
        return {"type": type(o).__name__, "out": _numpy(o),
                "aux": float(_numpy(aux)), "x_grad": _numpy(x.grad),
                "grads": {k: _numpy(v.grad) for k, v in leaves.items()}}

    out = {}
    for name, case in inputs["cases"].items():
        mesh = mesh_lib.make_mesh(*case["mesh"])
        data = tuple(ax for ax in mesh.axis_names if ax != "model")
        data = data if len(data) > 1 else data[0]
        cfg = ModelConfig(**case["cfg"])
        full = tree_map(torch.as_tensor, case["p"])
        x = torch.as_tensor(case["x"])
        api.set_mesh(mesh)
        try:
            res = {"coords": tuple(mesh.coordinate(ax)
                                   for ax in mesh.axis_names),
                   "plain": run(tree_map(torch.clone, full), x.clone(), cfg)}
            for fsdp in (False, True):
                placed = elastic.reshard(cfg, full, mesh, fsdp=fsdp)
                local = {k: v.to_local().numpy()
                         for k, v in _named(placed).items()}
                xd = specs.place(x, (data, None, None), mesh)
                res[f"fsdp={fsdp}"] = {**run(placed, xd, cfg),
                                       "local": local}
            if not out:
                t = torch.as_tensor(inputs["constrain"])
                whole = specs.place(t, (), mesh)
                out["constrain"] = {
                    "coords": res["coords"],
                    "vocab_last": api.constrain(
                        whole, "batch", None, "vocab").to_local().numpy(),
                    "vocab_middle": api.constrain(
                        whole, "batch", "vocab", None).to_local().numpy(),
                    "plain_unchanged": api.constrain(
                        t, "batch", None, "vocab") is t}
        finally:
            api.set_mesh(None)
        out[name] = res
    return out


JOBS = {"disba_sharded": disba_sharded_job, "distributed": distributed_job,
        "ep_moe": ep_moe_job}


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------

def _rank(job: str, rank: int, world: int, run_dir: str) -> None:
    torch.set_num_threads(1)
    path = Path(run_dir)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(path / "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=120))
        try:
            with open(path / "inputs.pkl", "rb") as fh:
                inputs = pickle.load(fh)
            result = {"ok": True, "result": JOBS[job](inputs)}
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the test through the result file
        result = {"ok": False, "error": traceback.format_exc()}
    with open(path / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(result, fh)


def main(argv: list[str]) -> int:
    job, world, run_dir = argv[0], int(argv[1]), argv[2]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(job, r, world, run_dir))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + 170
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [proc for proc in procs if proc.is_alive()]
    for proc in hung:
        proc.terminate()
        proc.join(10)
    return 1 if hung or any(p.exitcode for p in procs) else 0


def launch(job: str, n_ranks: int, inputs: dict, timeout: float = 180):
    """``job`` on ``n_ranks`` gloo ranks in a subprocess: the ranks'
    results in rank order.  Raises with the failing ranks' tracebacks."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    with tempfile.TemporaryDirectory() as run_dir:
        with open(Path(run_dir) / "inputs.pkl", "wb") as fh:
            pickle.dump(inputs, fh)
        proc = subprocess.run(
            [sys.executable, __file__, job, str(n_ranks), run_dir],
            capture_output=True, text=True, env=env, timeout=timeout)
        results = []
        for rank in range(n_ranks):
            path = Path(run_dir) / f"rank{rank}.pkl"
            if not path.exists():
                raise AssertionError(f"rank {rank} wrote no result (exit "
                                     f"{proc.returncode}):\n"
                                     f"{proc.stderr[-3000:]}")
            with open(path, "rb") as fh:
                results.append(pickle.load(fh))
    errors = [r["error"] for r in results if not r["ok"]]
    if errors or proc.returncode:
        raise AssertionError("\n".join(errors) or proc.stderr[-3000:])
    return [r["result"] for r in results]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
