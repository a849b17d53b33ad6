"""Serving of the port (``repro.serve``): continuous batching over the
decode path.

* :mod:`.scheduler` — host-loop ``ContinuousBatcher`` (reference
  semantics; one host round trip per token),
* :mod:`.engine` — device-resident ``ResidentEngine`` (slot state and KV
  cache on the device, one pull per decode chunk),
* :mod:`.stream` / :mod:`.metrics` — seeded synthetic traffic and
  TTFT/TPOT/tokens-per-second summaries.

The training -> serving bridge (``repro.serve.consensus``) waits for the
checkpoint port (ROADMAP Queue 1 item 11).
"""

from . import engine, metrics, scheduler, stream

__all__ = ["engine", "metrics", "scheduler", "stream"]
