"""Federated-learning runtime: services (the paper's tuple abstraction),
client local training, FedAvg and robust servers with straggler drop,
uplink compression with error feedback, the multi-period simulator
(``simulator``: ``run_scan``, ``run_batch``, ``run_fleet``, the legacy
``run``) and the training-in-the-loop co-simulation (``cotrain``)."""
from repro_torch.fl.service import (FLService, arch_service_tuple,  # noqa: F401
                                    episode_services)
from repro_torch.fl.client import local_update  # noqa: F401
from repro_torch.fl.server import (fedavg_round, init_residuals,  # noqa: F401
                                   make_fl_round_step)
from repro_torch.fl import (aggregation, compression, cotrain,  # noqa: F401
                            simulator)
