"""Scenario transport: stale/async gossip, stragglers, and failure-aware
wire accounting as a ``GossipBackend`` wrapper.  The port of
``repro.scenarios.transports``.

:class:`ScenarioBackend` wraps an inner stateless transport (dense /
banded / ppermute) in the style of ``transport.CompressedBackend``:

* **Staleness pipeline** (when ``delay > 0`` or ``straggler_p > 0``): the
  per-step phi is wrapped in a :class:`ScenarioPhi` and the mix routes
  through :func:`scenario_mix`, which threads a :class:`ScenarioMixState`
  through the algorithm's mix-state slot (``Algorithm.init_mix_state``,
  exactly like compressed gossip's error-feedback residual).  Per step:

      sent        = where(fresh_mask, x, last_sent)      # stragglers
      transmitted = delay_buffer.pop(); push(sent)       # bounded delay
      mixed       = inner mix of `transmitted`           # incl. quantization
      out_i       = mixed_i + W_ii * (x_i - transmitted_i)

  The last line keeps each node's OWN contribution current — only remote
  payloads are stale (an asynchronous node never waits for itself).  With
  delay=0 and no stragglers the correction term is exactly zero and the
  pipeline is bit-for-bit the inner mix.  Everything is tensor arithmetic
  in the step, with no in-place write, so the resident path (CUDA graphs
  of its pieces, whose state buffers take the new FIFO at the end of each
  step) and batched sweeps (the step under ``torch.func.vmap`` over the
  cells) keep their one staging step and one history pull.  Over
  node-sharded state (the ``ppermute`` inner, or ``shard="nodes"``) each
  rank keeps its rows of the pipeline: its rows of the straggler mask and
  of the self-weight column.

* **Quantization** (``compress_bits``): the inner transport is wrapped in
  a ``CompressedBackend`` INSIDE the scenario (compression is the
  innermost wire stage — what actually moves is quantized stale payloads).

* **Failure-aware accounting** (always): ``bytes_per_step`` /
  ``bytes_per_link`` count the REALIZED support of the step's mixing
  matrix — links that a failure model dropped carry no mass and are not
  charged.  The model is point-to-point (one param payload per nonzero
  off-diagonal entry, scaled ``bits/32`` under quantization with the
  rounding remainder distributed so per-link maps sum EXACTLY to
  ``bytes_per_step``).  This differs from ``DenseBackend``'s all-gather
  model by design: a frontier over failure scenarios needs counts that
  respond to dropped links.  Staleness does not change byte counts — late
  payloads still move.  The accounting runs on the host, on the plan's
  numpy phis, and gives the reference's integers.

Algorithms must thread a mix state to ride the staleness pipeline
(DPSVRG, GT-SVRG, loopless DPSVRG, DVR do); ``dspg``/``dpg`` mix through
the stateless ``gossip.mix_stacked`` and get a clear error — the same
restriction they have for compressed gossip.  They still run under
schedule-level models (link failures / churn) and the accounting wrapper,
where ``phi_for`` returns the inner dense matrix unwrapped, so the fused
resident step (``kernel="fused"``) lowers it as any dense phi.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import compression, gossip, transport

__all__ = ["ScenarioPhi", "ScenarioMixState", "ScenarioBackend",
           "scenario_mix"]

_TOL = 1e-12
_STRAGGLER_SALT = 0x33


# ---------------------------------------------------------------------------
# Wire representation
# ---------------------------------------------------------------------------

class ScenarioPhi:
    """A phi whose mixing runs the staleness pipeline.

    ``inner`` is any wire representation ``compression.mix_with_state``
    accepts (dense matrix, ``BandedPhi``, ``CompressedPhi``); ``mask`` is
    the per-node fresh-this-slot indicator (float32 0/1, so it rides the
    runner's float32 phi staging; None when no straggler model is active);
    ``delay`` is the pytree context (it sets the buffer length of the
    state)."""

    __slots__ = ("inner", "mask", "delay")

    def __init__(self, inner, mask, delay: int):
        self.inner = inner
        self.mask = mask
        self.delay = int(delay)

    def __repr__(self):
        return (f"ScenarioPhi(delay={self.delay}, "
                f"mask={'set' if self.mask is not None else None}, "
                f"inner={self.inner!r})")


pytree.register_pytree_node(
    ScenarioPhi,
    lambda phi: ([phi.inner, phi.mask], phi.delay),
    lambda children, delay: ScenarioPhi(*list(children), delay))


class ScenarioMixState(NamedTuple):
    """Per-quantity transport state threaded through the algorithm state.

    buffer: delay FIFO, leaves ``(delay,) + leaf.shape`` (None if delay=0)
    sent:   last transmitted value per node (None if no stragglers)
    inner:  the inner transport's own state (compression error feedback)
    """
    buffer: Any
    sent: Any
    inner: Any


def _per_node(vec: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast an (m,) vector over a stacked leaf's trailing dims."""
    return vec.reshape(vec.shape[:1] + (1,) * (leaf.ndim - 1))


def _phi_diag(phi, like: torch.Tensor) -> torch.Tensor:
    """Self-weight column W_ii of a wire representation: a float32 (m,)
    tensor on ``like``'s device."""
    if isinstance(phi, (compression.CompressedPhi, gossip.GatheredPhi)):
        return _phi_diag(phi.inner, like)
    if isinstance(phi, (gossip.BandedPhi, gossip.PermutePhi)):
        coeffs = gossip.as_mix_tensor(phi.coeffs, like)
        for b, d in enumerate(phi.offsets):
            if d == 0:
                return coeffs[b]
        return torch.zeros(coeffs.shape[-1], dtype=torch.float32,
                           device=like.device)
    return torch.diagonal(gossip.as_mix_tensor(phi, like))


def scenario_mix(phi: ScenarioPhi, tree, state: ScenarioMixState | None):
    """The staleness pipeline (see module docstring).  Registered as the
    ``mix_with_state`` handler for :class:`ScenarioPhi`."""
    if state is None:
        raise ValueError(
            "scenario gossip (stale/straggler) threads a delay buffer "
            "through the algorithm state; the driven algorithm must "
            "support Algorithm.init_mix_state (dspg/dpg do not)")
    x = tree
    # node-sharded state: this rank's rows of the per-node columns
    ax = gossip.phi_node_axis(phi.inner)
    rows = slice(None) if ax is None else ax.rows

    if phi.mask is not None:
        mask = gossip.as_mix_tensor(phi.mask, pytree.tree_leaves(x)[0])[rows]
        sent = pytree.tree_map(
            lambda l, c: torch.where(_per_node(mask, l) >= 0.5, l, c),
            x, state.sent)
        new_sent = sent
    else:
        sent = x
        new_sent = state.sent

    if phi.delay > 0:
        transmitted = pytree.tree_map(lambda b: b[0], state.buffer)
        new_buffer = pytree.tree_map(
            lambda b, s: torch.cat([b[1:], s[None].to(b.dtype)], 0),
            state.buffer, sent)
    else:
        transmitted = sent
        new_buffer = state.buffer

    mixed, inner_state = compression.mix_with_state(phi.inner, transmitted,
                                                    state.inner)
    # keep each node's own contribution current: replace W_ii * stale_i by
    # W_ii * x_i (exactly zero when nothing is stale, so the zero-intensity
    # pipeline reproduces the inner mix bit for bit; under quantization the
    # self term rides uncompressed — a node needn't quantize to itself)
    diag = _phi_diag(phi.inner, pytree.tree_leaves(x)[0])[rows]
    out = pytree.tree_map(
        lambda mx, xc, tc: mx + (_per_node(diag, mx) * (xc - tc)).to(
            mx.dtype),
        mixed, x, transmitted)
    return out, ScenarioMixState(new_buffer, new_sent, inner_state)


compression.register_mix_handler(ScenarioPhi, scenario_mix)


# ---------------------------------------------------------------------------
# Backend
# ---------------------------------------------------------------------------

class _ScenarioAux(NamedTuple):
    inner_backend: transport.GossipBackend
    inner_aux: Any
    schedule: Any
    m: int
    cache: dict


def _host(phi) -> np.ndarray:
    """A dense phi (numpy or tensor) as a host array, for the accounting."""
    if isinstance(phi, torch.Tensor):
        return phi.detach().cpu().numpy()
    return np.asarray(phi)


@dataclasses.dataclass(frozen=True)
class ScenarioBackend(transport.GossipBackend):
    """Scenario wrapper over an inner transport (see module docstring).

    inner:          inner backend name or instance ("dense"/"banded"/
                    "ppermute"; not "compressed" — pass ``compress_bits``)
    delay:          bounded gossip delay in slots (:class:`StaleGossip`)
    straggler_p:    per-slot probability a node misses the gossip deadline
                    (:class:`Stragglers`; ``1 - 1/slowdown``)
    seed:           straggler-mask stream seed (folded with the wrapped
                    schedule's scenario seed, so schedule-axis sweep cells
                    draw diverging masks)
    compress_bits:  int width for error-feedback quantized payloads
                    (wraps the inner transport in a ``CompressedBackend``)

    With ``delay=0, straggler_p=0`` the backend is a pure accounting
    wrapper: ``phi_for`` returns the inner representation UNWRAPPED, the
    mix is bit-for-bit the inner backend's, and only the byte counting
    switches to the realized-support model.
    """

    inner: Any = "dense"
    delay: int = 0
    straggler_p: float = 0.0
    seed: int = 0
    compress_bits: int | None = None

    name = "scenario"
    scenario_transport = True

    def __post_init__(self):
        if self.delay < 0:
            raise ValueError(f"delay must be >= 0, got {self.delay}")
        if not 0.0 <= self.straggler_p < 1.0:
            raise ValueError(f"straggler_p must be in [0, 1), got "
                             f"{self.straggler_p}")
        self._inner_backend()   # validate inner/compress_bits eagerly

    def _stateful_wrap(self) -> bool:
        return self.delay > 0 or self.straggler_p > 0.0

    @property
    def needs_mix_state(self) -> bool:
        return self._stateful_wrap() or self.compress_bits is not None

    def _inner_backend(self) -> transport.GossipBackend:
        ib = self.inner
        if isinstance(ib, str):
            if ib in ("compressed", "scenario"):
                raise ValueError(
                    f"ScenarioBackend cannot wrap {ib!r} directly: pass "
                    f"compress_bits= for quantization; scenarios do not "
                    f"nest")
            if ib == "auto":
                raise ValueError("ScenarioBackend needs an explicit inner "
                                 "wire format ('dense' or 'banded')")
            ib = transport.resolve_backend(ib, None, None)
        if getattr(ib, "scenario_transport", False):
            raise ValueError("scenario transports do not nest; compose all "
                             "models in one apply() call")
        if self.compress_bits is not None:
            if isinstance(ib, transport.CompressedBackend):
                raise ValueError("pass quantization via compress_bits=, not "
                                 "a CompressedBackend inner")
            ib = transport.CompressedBackend(inner=ib,
                                             bits=self.compress_bits)
        return ib

    def prepare(self, schedule, meta, *, mesh=None):
        ib = self._inner_backend()
        return _ScenarioAux(ib, ib.prepare(schedule, meta, mesh=mesh),
                            schedule, schedule.m, {})

    def phi_for(self, aux, slot, rounds):
        inner_phi = aux.inner_backend.phi_for(aux.inner_aux, slot, rounds)
        if not self._stateful_wrap():
            return inner_phi
        # straggler masks are a fresh draw per ABSOLUTE slot — caching on
        # the schedule's periodic key would freeze one mask into every
        # step (the same nodes straggling forever pin the network at x0)
        key = ((slot, rounds) if self.straggler_p > 0.0
               else transport._phi_key(aux.schedule, slot, rounds))
        phi = aux.cache.get(key)
        if phi is None:
            mask = None
            if self.straggler_p > 0.0:
                sched_seed = getattr(aux.schedule, "seed", 0)
                rng = np.random.default_rng(
                    [self.seed, _STRAGGLER_SALT, sched_seed, slot])
                mask = (rng.random(aux.m) >= self.straggler_p).astype(
                    np.float32)
            phi = aux.cache[key] = ScenarioPhi(inner_phi, mask, self.delay)
        return phi

    def init_mix_state(self, aux, x0):
        inner = (aux.inner_backend.init_mix_state(aux.inner_aux, x0)
                 if aux.inner_backend.needs_mix_state else None)
        if not self._stateful_wrap():
            return inner
        buffer = None
        if self.delay > 0:
            # FIFO pre-filled at x0: the first `delay` mixes see the start
            # point, exactly what a network that was quiescent before t=0
            # would deliver
            buffer = pytree.tree_map(
                lambda l: l[None].expand((self.delay,) + l.shape).clone(),
                x0)
        sent = (pytree.tree_map(torch.as_tensor, x0)
                if self.straggler_p > 0.0 else None)
        return ScenarioMixState(buffer, sent, inner)

    def mix(self, aux, phi, tree, mix_state=None):
        """Stateful mix: returns ``(mixed, new_state)`` when the scenario
        wraps state, else the plain inner mix."""
        if not self.needs_mix_state:
            return gossip.mix_stacked(phi, tree)
        return compression.mix_with_state(phi, tree, mix_state)

    # -- accounting: realized support, point-to-point ----------------------

    def _links(self, phi, m: int) -> list:
        """Directed links (src, dst) that carry mass this step."""
        if isinstance(phi, ScenarioPhi):
            phi = phi.inner
        if isinstance(phi, compression.CompressedPhi):
            phi = phi.inner
        if isinstance(phi, (gossip.BandedPhi, gossip.PermutePhi)):
            return [((i + d) % m, i) for d, i in transport._active_entries(
                phi.offsets, _host(phi.coeffs), m)]
        w = _host(phi)
        src, dst = [], []
        for i in range(m):
            for j in range(m):
                if i != j and abs(w[i, j]) > _TOL:
                    src.append(j)
                    dst.append(i)
        return list(zip(src, dst))

    def _bits(self, phi) -> int | None:
        if isinstance(phi, ScenarioPhi):
            phi = phi.inner
        if isinstance(phi, compression.CompressedPhi):
            return phi.bits
        return None

    def bytes_per_step(self, aux, phi, param_count):
        n = len(self._links(phi, aux.m))
        total = n * param_count * transport.F32_BYTES
        bits = self._bits(phi)
        if bits is not None:
            total = total * bits // 32
        return total

    def bytes_per_link(self, aux, phi, param_count):
        links = self._links(phi, aux.m)
        per = param_count * transport.F32_BYTES
        bits = self._bits(phi)
        if bits is None:
            return {link: per for link in links}
        out = {link: per * bits // 32 for link in links}
        remainder = (self.bytes_per_step(aux, phi, param_count)
                     - sum(out.values()))
        for link in sorted(out):
            if remainder <= 0:
                break
            out[link] += 1
            remainder -= 1
        return out
