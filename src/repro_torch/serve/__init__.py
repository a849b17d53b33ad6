"""Serving of the port (``repro.serve``): continuous batching over the
decode path.

* :mod:`.scheduler` — host-loop ``ContinuousBatcher`` (reference
  semantics; one host round trip per token),
* :mod:`.engine` — device-resident ``ResidentEngine`` (slot state and KV
  cache on the device, one pull per decode chunk),
* :mod:`.stream` / :mod:`.metrics` — seeded synthetic traffic and
  TTFT/TPOT/tokens-per-second summaries,
* :mod:`.consensus` — the training -> serving bridge: the node average of
  a trainer checkpoint's replicas.
"""

from . import consensus, engine, metrics, scheduler, stream

__all__ = ["consensus", "engine", "metrics", "scheduler", "stream"]
