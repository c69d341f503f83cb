"""PyTorch + CUDA port of the multi-service FL bandwidth allocator.

The package mirrors ``repro`` module for module (``repro_torch.core.intra``
is the counterpart of ``repro.core.intra``) and imports only ``torch`` and
numpy.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` or CPU tensors; the device of the tensors decides whether a
hand-written CUDA kernel (``repro_torch.kernels``) or its plain PyTorch
version runs.

Layers, from the entry points down:

* ``launch.serve``: the serving entry point over ``models`` (gemma3-1b,
  xlstm-1.3b), whose attention and mLSTM kernels live in ``kernels``;
* ``launch.allocd``: the live allocation daemon over ``fl.control_plane``
  (online admission into a fixed-capacity slot set, the period step of
  ``fl.simulator`` each tick), checkpointed through
  ``distributed.fault``; ``chaos`` drives it through seeded fault storms
  and turns co-training clients Byzantine;
* ``fl.cotrain``: the co-simulation, which paces FedAvg training of
  bigram models (``data``, ``fl.server``, ``fl.client``,
  ``fl.compression``, ``fl.aggregation``) by each period's allocation;
* ``fl.simulator``: the episode engines (``run_scan``, ``run_batch``,
  ``run_fleet``, the checkpointable ``run``) over ``scenarios`` and the
  allocation ``core`` (``core.policy``), whose solvers launch the
  allocation kernels;
* ``launch.mesh`` and ``distributed``: meshes over the ranks of a
  ``torch.distributed`` world, the collectives over their axes, elastic
  re-meshing; ``run_fleet`` and ``core.disba.disba_sharded`` split their
  seeds or services over such a mesh;
* ``checkpoint``: crash-safe tree checkpoints, in the reference's layout.
"""
from repro_torch import checkpoint, data, fl  # noqa: F401
from repro_torch.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.data import SyntheticLM  # noqa: F401
from repro_torch.fl.cotrain import (TrainSpec, run_cotrain_batch,  # noqa: F401
                                    run_cotrain_fleet, run_cotrain_scan)
from repro_torch.fl.simulator import (SimConfig, run, run_batch,  # noqa: F401
                                      run_fleet, run_scan)
