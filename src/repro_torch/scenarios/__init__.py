"""Composable, seeded network-event scenarios over the core contracts: the
port of ``repro.scenarios``.

``models`` declares the event processes (link failures, node churn, stale
gossip, stragglers) and composes them onto a ``(schedule, gossip)`` pair
via :func:`apply`; ``transports`` implements the delay/staleness transport
as a :class:`~repro_torch.core.transport.GossipBackend` wrapper; ``matrix``
runs {topology x failure x compression x algorithm} grids as batched
resident sweeps and reports the convergence-vs-wire-bytes frontier.
"""

from .models import (LinkFailures, NodeChurn, ScenarioSchedule, StaleGossip,
                     Stragglers, apply, transport_spec, wrap_schedule)
from .transports import ScenarioBackend, ScenarioMixState, ScenarioPhi
from .matrix import (MatrixResult, MatrixRow, format_table, pareto_frontier,
                     run_matrix)

__all__ = [
    "LinkFailures", "NodeChurn", "StaleGossip", "Stragglers",
    "ScenarioSchedule", "wrap_schedule", "transport_spec", "apply",
    "ScenarioBackend", "ScenarioMixState", "ScenarioPhi",
    "MatrixRow", "MatrixResult", "run_matrix", "pareto_frontier",
    "format_table",
]
