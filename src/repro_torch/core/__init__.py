"""The paper's algorithms and their decentralized machinery, in PyTorch.

The port of ``repro.core`` (main-path subset):

  graphs     — time-varying b-connected doubly-stochastic mixing schedules
  schedules  — K_s growth, DSPG decaying steps, LR schedules
  prox       — closed-form proximal operators (the whole registry)
  svrg       — variance-reduced gradient estimator + snapshot state
  gossip     — dense consensus over stacked node parameters
  transport  — the dense gossip backend, "auto" selection, wire bytes
  algorithm  — the Algorithm protocol, DPSVRG and DSPG with fused twins
  exec_spec  — ``ExecSpec``: path / kernel / transport / device
  runner     — the generic driver: host loop and the resident path
  dpsvrg     — hyper-parameters + centralized prox-GD reference
"""

from . import (algorithm, dpsvrg, exec_spec, gossip, graphs, prox, runner,
               schedules, svrg, transport)
from .exec_spec import ExecSpec

__all__ = ["algorithm", "dpsvrg", "exec_spec", "ExecSpec", "gossip",
           "graphs", "prox", "runner", "schedules", "svrg", "transport"]
