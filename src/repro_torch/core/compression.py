"""Compressed gossip with error feedback: the port of
``repro.core.compression``.

Node i transmits an int-quantized view of its iterate and keeps the
quantization residual in an error-feedback accumulator (CHOCO-SGD style),
so the compression error is compensated over time instead of accumulating:

    q_send   = Q(q + e)          # symmetric per-node-row int quantization
    e_next   = (q + e) - q_send  # residual carried forward
    mix over q_send as usual.

On one process the mix over ``q_send`` goes through
``gossip.mix_stacked``, so the quantized payload rides either wire format,
dense or :class:`~repro_torch.core.gossip.BandedPhi`.  Over node-sharded
state (:class:`~repro_torch.core.gossip.PermutePhi`,
:class:`~repro_torch.core.gossip.GatheredPhi`) each rank quantizes its own
rows BEFORE the wire, ships the integer codes and the per-row scales, and
dequantizes what it receives (:func:`compressed_mix_permute`,
:func:`compressed_mix_gathered`): the payload crosses the wire as
integers, and the residual never leaves its rank.  :class:`CompressedPhi`
marks a phi whose transport is compressed (the ``compressed`` backend in
:mod:`repro_torch.core.transport`); :func:`mix_with_state` is the
dispatching mix for algorithm steps that thread an error-feedback state.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from . import gossip, spmd

__all__ = ["CompressionState", "init_state", "quantize_leaf",
           "quantize_int_leaf", "compressed_mix", "compressed_mix_permute",
           "compressed_mix_gathered", "CompressedPhi", "mix_with_state",
           "register_mix_handler"]

# Phi types beyond CompressedPhi with their own stateful mix:
# {phi_type: handler(phi, tree, state) -> (mixed, new_state)}.  A registered
# type is also marked stateful-only, so gossip.mix_stacked refuses it.
_MIX_HANDLERS: dict = {}


def register_mix_handler(phi_type: type, handler) -> None:
    """Route ``mix_with_state`` calls on ``phi_type`` phis to ``handler``
    (``handler(phi, tree, state) -> (mixed, new_state)``)."""
    _MIX_HANDLERS[phi_type] = handler
    gossip.mark_stateful(phi_type)


class CompressionState(NamedTuple):
    error: Any   # residual tree, same structure as params


def init_state(tree) -> CompressionState:
    return CompressionState(error=pytree.tree_map(torch.zeros_like, tree))


def quantize_int_leaf(x: torch.Tensor, bits: int = 8):
    """Symmetric per-node-row quantization, returned as the wire payload:
    the integer code (int8 for bits <= 8, int16 above) plus the per-row
    float32 scale.  ``code.float() * scale`` is exactly what
    :func:`quantize_leaf` returns.

    The max-abs scale is reduced over everything except the leading node
    axis (node i only knows its own row); a 1-D stacked leaf has one scale
    per element, i.e. per node.  Codes round half to even, as ``jnp.round``
    does."""
    levels = float(2 ** (bits - 1) - 1)
    if x.ndim <= 1:
        peak = torch.abs(x)
    else:
        peak = torch.amax(torch.abs(x), dim=tuple(range(1, x.ndim)),
                          keepdim=True)
    scale = torch.clamp_min(peak / levels, 1e-12).to(torch.float32)
    q = torch.clamp(torch.round(x / scale), -levels, levels)
    code_dtype = torch.int8 if bits <= 8 else torch.int16
    return q.to(code_dtype), scale


def quantize_leaf(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Dequantized view of :func:`quantize_int_leaf` (what the receiver
    reconstructs)."""
    code, scale = quantize_int_leaf(x, bits)
    return code.to(scale.dtype) * scale


def compressed_mix(phi, tree, state: CompressionState,
                   bits: int = 8) -> tuple[Any, CompressionState]:
    """Gossip over quantized iterates with error feedback.  Returns (mixed
    tree, new compression state).  The consensus mean is not preserved per
    step; the error accumulator restores it asymptotically."""
    if isinstance(phi, gossip.PermutePhi):
        return compressed_mix_permute(phi, tree, state, bits=bits)
    if isinstance(phi, gossip.GatheredPhi):
        return compressed_mix_gathered(phi, tree, state, bits=bits)
    compensated = pytree.tree_map(torch.add, tree, state.error)
    sent = pytree.tree_map(lambda leaf: quantize_leaf(leaf, bits),
                           compensated)
    new_error = pytree.tree_map(torch.sub, compensated, sent)
    return gossip.mix_stacked(phi, sent), CompressionState(error=new_error)


def _quantized_mix(tree, state: CompressionState, bits: int, mix_rows):
    """Quantize each leaf's local rows to (code, scale), mix through
    ``mix_rows(code, scale, leaf) -> mixed rows`` (which ships the integer
    payload), and keep the residual local."""
    compensated = pytree.tree_map(torch.add, tree, state.error)
    leaves, spec = pytree.tree_flatten(compensated)
    mixed, sent = [], []
    for x in leaves:
        code, scale = quantize_int_leaf(x, bits)
        sent.append(code.to(scale.dtype) * scale)
        mixed.append(mix_rows(code, scale, x))
    new_error = pytree.tree_map(torch.sub, compensated,
                                pytree.tree_unflatten(sent, spec))
    return pytree.tree_unflatten(mixed, spec), \
        CompressionState(error=new_error)


def compressed_mix_permute(phi: "gossip.PermutePhi", tree,
                           state: CompressionState,
                           bits: int = 8) -> tuple[Any, CompressionState]:
    """CHOCO over a node axis of ranks, quantizing BEFORE the wire: each
    rank quantizes its row to the integer code and per-row scale, the
    band exchanges move the code (plus the scale, one float a row,
    uncharged) and receivers dequantize.  Numerically the composed path
    (quantize, then :func:`gossip.mix_stacked_permute` of the
    reconstruction): dequantization is per row and the exchange moves
    whole rows."""
    j = gossip._permute_axis(phi).index

    def mix_rows(code, scale, like):
        codes, scales = gossip.permute_exchange(phi, [code, scale])
        coeffs = gossip.as_mix_tensor(phi.coeffs, like)
        out = None
        for b, (c_r, s_r) in enumerate(zip(codes, scales)):
            recv = c_r.to(s_r.dtype) * s_r
            term = gossip._coeff(coeffs, b, j, recv) * recv
            out = term if out is None else out + term
        return out

    return _quantized_mix(tree, state, bits, mix_rows)


def compressed_mix_gathered(phi: "gossip.GatheredPhi", tree,
                            state: CompressionState,
                            bits: int = 8) -> tuple[Any, CompressionState]:
    """CHOCO over node-sharded state with a dense or banded mix: each rank
    quantizes its rows, the codes and scales are all-gathered, and every
    rank dequantizes the whole stack and applies its rows of the mix."""
    ax = spmd.node_axis(phi.mesh, phi.axis, phi.m)

    def mix_rows(code, scale, like):
        full = (spmd.all_gather_rows(code, ax).to(scale.dtype)
                * spmd.all_gather_rows(scale, ax))
        return gossip.gathered_rows_mix(phi.inner, full, ax.rows, like)

    return _quantized_mix(tree, state, bits, mix_rows)


class CompressedPhi:
    """Marks a mixing matrix whose payload rides the wire int-quantized with
    error feedback.  ``inner`` is any phi ``mix_stacked`` accepts (dense, or
    ``BandedPhi``); ``bits`` is the pytree context, so the inner phi's
    leaves stage and slice as usual."""

    __slots__ = ("inner", "bits")

    def __init__(self, inner, bits: int = 8):
        self.inner = inner
        self.bits = int(bits)

    def __repr__(self):
        return f"CompressedPhi(bits={self.bits}, inner={self.inner!r})"


pytree.register_pytree_node(
    CompressedPhi,
    lambda phi: ([phi.inner], phi.bits),
    lambda children, bits: CompressedPhi(list(children)[0], bits))
# gossip.mix_stacked refuses it: its mix goes through mix_with_state
gossip.mark_stateful(CompressedPhi)


def mix_with_state(phi, tree, state: CompressionState | None):
    """Transport-dispatching mix for steps that thread a mix state.

    Stateless phis pass straight through ``gossip.mix_stacked`` (the state
    is returned untouched and may be None); a :class:`CompressedPhi` routes
    to :func:`compressed_mix` with its inner wire format.  Types added with
    :func:`register_mix_handler` (the scenario pipeline) dispatch first."""
    handler = _MIX_HANDLERS.get(type(phi))
    if handler is not None:
        return handler(phi, tree, state)
    if isinstance(phi, CompressedPhi):
        if state is None:
            raise ValueError(
                "compressed gossip needs an error-feedback CompressionState; "
                "the driven algorithm must thread a mix state "
                "(see Algorithm.init_mix_state)")
        return compressed_mix(phi.inner, tree, state, bits=phi.bits)
    return gossip.mix_stacked(phi, tree), state
