"""The FL mechanism of the paper, ported to PyTorch: aggregation server,
workers, warehouse and pointers, aggregation algorithms (eqs 2.1-2.7),
worker selection (Algorithms 1 & 2), eq-3.4 time estimation, the
deterministic event-driven sync/async runtime and the wire-aware
transport layer (with its per-link auto codec and lossy links),
hierarchical multi-server topologies, pod-level federated training of the
LMs and the update compression it uses."""
from . import (aggregation, autotune, compression, estimator, events,
               federated, flatbuf, population, selection, server, server_opt,
               topology, transport, warehouse, worker)
from .experiment import (TABLE_4_1, TABLE_4_2, FLSetup, build_experiment,
                         heterogeneous_profiles, make_setup,
                         repartition_setup, run_fl, run_sequential_baseline,
                         time_to_accuracy)
