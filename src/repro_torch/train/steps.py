"""Step builders of the decentralized LM trainer (DPSVRG / DSPG) and of
serving (prefill / decode).  The port of ``repro.train.steps`` on one
device.

This is where the paper's algorithm becomes the data-parallel training
rule for the model zoo:

  * parameters are *stacked* per node (leading axis m); the per-node loss
    and gradient are ``torch.func.vmap(torch.func.grad_and_value(loss))``
    over that axis, the counterpart of the reference's
    ``jax.vmap(jax.value_and_grad(loss))``: each node's gradient is its
    own, computed by one batched program for all m nodes,
  * the SVRG correction uses the per-node snapshot + large-batch "full"
    gradient state,
  * gossip is the host-precomputed multi-consensus matrix, applied by the
    transport's wire format (``compression.mix_with_state``),
  * the prox step is the regularizer's closed form.

The step runs the plain model path: the RMSNorm and flash attention
kernels have no backward (the reference cannot differentiate its Pallas
kernels either), so ``train_loop`` refuses configs that turn them on.
Sharded state (``plan``/``mesh``) is multi-device work (ROADMAP Queue 1
item 14 (b)) and raises.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from ..core import algorithm as algo_lib, compression, prox as prox_lib, \
    svrg
from ..models import transformer
from ..models.api import ModelConfig

__all__ = ["TrainBundle", "ServeBundle", "build_train_step",
           "build_serve_steps", "make_stacked_init", "TrainState"]


class TrainState(NamedTuple):
    """The reference's five fields, so checkpoint keys match
    (``state/.params/...``, ``state/.step``)."""
    params: Any            # stacked (m, ...)
    snapshot: Any          # stacked (m, ...)
    full_grad: Any         # stacked (m, ...)
    step: torch.Tensor     # int32 scalar
    # transport state for stateful gossip (compressed error feedback);
    # None for stateless wire formats
    mix_state: Any = None


class TrainBundle(NamedTuple):
    train_step: Callable     # (state, batch, phi, alpha) -> (state, metrics)
    snapshot_step: Callable  # (state, big_batch) -> state
    init_state: Callable     # (seed, device) -> state
    loss_fn: Callable


class ServeBundle(NamedTuple):
    prefill_step: Callable
    decode_step: Callable
    init_params: Callable    # (seed, device) -> params


def _no_mesh(plan, mesh) -> None:
    if plan is not None or mesh is not None:
        raise NotImplementedError(
            "sharded state (plan=/mesh=) is multi-device work, not ported "
            "to PyTorch yet (ROADMAP Queue 1 item 14 (b))")


# ---------------------------------------------------------------------------
# Decentralized training
# ---------------------------------------------------------------------------

def make_stacked_init(cfg: ModelConfig, m: int):
    """All nodes start from the same point (Algorithm 1 line 2).  Returns
    ``init(seed, device)`` -> params stacked (m, ...), each node's copy its
    own memory."""

    def init(seed, device="cuda"):
        params = transformer.init_params(cfg, seed, device=device)
        return pytree.tree_map(
            lambda x: x[None].expand((m,) + x.shape).clone(), params)

    return init


# Rebuilt bundles with identical (cfg, prox, m, rule) are served from this
# cache, so their step identities stay stable across train_loop calls, as
# the reference's are.  Keyed on the frozen-dataclass equality of cfg/prox.
_BUNDLE_CACHE: "collections.OrderedDict[tuple, TrainBundle]" = \
    collections.OrderedDict()
_BUNDLE_CACHE_MAX = 16


def build_train_step(cfg: ModelConfig,
                     prox: prox_lib.Prox,
                     m: int,
                     plan=None,
                     mesh=None,
                     algorithm: "str | algo_lib.UpdateRule" = "dpsvrg"
                     ) -> TrainBundle:
    """``algorithm``: an ``UpdateRule`` from ``repro_torch.core.algorithm``
    (or its registry name: dpsvrg | dspg).  The LM train step is the SAME
    prox-gossip update the logistic-regression runner executes
    (``algo_lib.prox_gossip_update`` with the rule's gradient direction).

    The train step's ``phi`` is any wire format the transports produce: a
    dense ``(m, m)`` matrix, a ``gossip.BandedPhi`` or a
    ``compression.CompressedPhi`` (whose error feedback threads through
    ``TrainState.mix_state``), its leaves on the state's device."""
    _no_mesh(plan, mesh)
    rule = (algo_lib.UPDATE_RULES[algorithm] if isinstance(algorithm, str)
            else algorithm)
    try:
        cache_key = (cfg, prox, m, rule)
        cached = _BUNDLE_CACHE.get(cache_key)
    except TypeError:                # unhashable custom cfg/prox: just build
        cache_key, cached = None, None
    if cached is not None:
        _BUNDLE_CACHE.move_to_end(cache_key)
        return cached
    bundle = _build_train_step(cfg, prox, m, rule)
    if cache_key is not None:
        _BUNDLE_CACHE[cache_key] = bundle
        while len(_BUNDLE_CACHE) > _BUNDLE_CACHE_MAX:
            _BUNDLE_CACHE.popitem(last=False)
    return bundle


def _build_train_step(cfg, prox, m, rule) -> TrainBundle:
    loss = transformer.loss_fn(cfg)
    grad_and_loss = torch.func.vmap(torch.func.grad_and_value(loss))
    grad_only = torch.func.vmap(torch.func.grad(loss))

    def train_step(state: TrainState, batch, phi, alpha):
        g_now, losses = grad_and_loss(state.params, batch)
        g_snap = grad_only(state.snapshot, batch) if rule.needs_snapshot \
            else None
        v = rule.direction(g_now, g_snap, state.full_grad)
        del g_now, g_snap          # free the gradients before the update
        v_norm = svrg.tree_norm(v)

        # the mix threads the transport state (compressed error feedback)
        # via the dispatching mix_with_state; for stateless wire formats it
        # is gossip.mix_stacked and the state (None) passes through
        mix_out = {}

        def mix_fn(phi_, tree):
            mixed, mix_out["state"] = compression.mix_with_state(
                phi_, tree, state.mix_state)
            return mixed

        new_params = algo_lib.prox_gossip_update(state.params, v, phi, alpha,
                                                 prox, mix_fn=mix_fn)
        metrics = {"loss": torch.mean(losses), "v_norm": v_norm}
        return state._replace(params=new_params, step=state.step + 1,
                              mix_state=mix_out["state"]), metrics

    def snapshot_step(state: TrainState, big_batch):
        """Outer loop: refresh snapshot + (large-batch) full local gradient."""
        mu = grad_only(state.params, big_batch)
        return state._replace(snapshot=state.params, full_grad=mu)

    def init_state(seed, device="cuda"):
        params = make_stacked_init(cfg, m)(seed, device)
        zeros = pytree.tree_map(torch.zeros_like, params)
        step = torch.zeros((), dtype=torch.int32,
                           device=pytree.tree_leaves(params)[0].device)
        return TrainState(params=params, snapshot=params, full_grad=zeros,
                          step=step)

    return TrainBundle(train_step=train_step, snapshot_step=snapshot_step,
                       init_state=init_state, loss_fn=loss)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def build_serve_steps(cfg: ModelConfig, plan=None, mesh=None) -> ServeBundle:
    _no_mesh(plan, mesh)

    def prefill_step(params, tokens, image_embeds=None, audio_frames=None,
                     max_len=None):
        return transformer.prefill(cfg, params, tokens,
                                   image_embeds=image_embeds,
                                   audio_frames=audio_frames, max_len=max_len)

    def decode_step(params, cache, token):
        return transformer.decode_step(cfg, params, cache, token)

    def init_params(seed, device="cuda"):
        return transformer.init_params(cfg, seed, device=device)

    return ServeBundle(prefill_step=prefill_step, decode_step=decode_step,
                       init_params=init_params)
