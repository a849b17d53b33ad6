"""The paper's algorithms and their decentralized machinery, in PyTorch.

The port of ``repro.core`` on one device:

  graphs     — time-varying b-connected doubly-stochastic mixing schedules
  schedules  — K_s growth, DSPG decaying steps, LR schedules
  prox       — closed-form proximal operators (the whole registry)
  svrg       — variance-reduced gradient estimator + snapshot state
  gossip     — dense and banded consensus over stacked node parameters
  compression — int-quantized gossip with error feedback
  transport  — dense / banded / compressed backends, "auto", wire bytes
  algorithm  — the Algorithm protocol and the reference's whole registry
               (DPSVRG, DSPG, DPG, GT-SVRG, loopless DPSVRG, DVR), with
               fused twins
  exec_spec  — ``ExecSpec``: path / sampling / kernel / transport / device
  runner     — the generic driver: host loop, scan chunks, resident path
  device_sampling — the counter-based minibatch stream of
               ``sampling="device"``
  sweep      — batched sweeps: a hyperparameter grid as one resident run
  dpsvrg     — hyper-parameters + centralized prox-GD reference
  inexact    — Algorithm 2 (inexact Prox-SVRG) and an executable Theorem 1
"""

from . import (algorithm, compression, device_sampling, dpsvrg, exec_spec,
               gossip, graphs, inexact, prox, runner, schedules, svrg,
               sweep, transport)
from .exec_spec import ExecSpec

__all__ = ["algorithm", "compression", "device_sampling", "dpsvrg",
           "exec_spec", "ExecSpec",
           "gossip", "graphs", "inexact", "prox", "runner", "schedules",
           "svrg", "sweep", "transport"]
