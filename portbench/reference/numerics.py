"""Products at a stated precision, for the references and their controls.

``"tf32"`` rounds both operands of every product to TF32 (8 exponent
bits, 10 mantissa bits, round to nearest) and accumulates in float32, as
the card's tensor cores do when float32 products are allowed to run in
TF32.  Rounding in software gives the same numbers on the CPU and on the
card, so the control is the same everywhere."""

from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``op(a, b)`` on TF32-rounded operands, its backward's products on
    TF32-rounded operands too (the gradient flowing in is rounded, and the
    product's own backward is taken on the rounded values)."""

    @staticmethod
    def forward(ctx, op, a, b):
        a_r, b_r = tf32_round(a), tf32_round(b)
        ctx.op = op
        ctx.save_for_backward(a_r, b_r)
        return op(a_r, b_r)

    @staticmethod
    def backward(ctx, g):
        a_r, b_r = ctx.saved_tensors
        with torch.enable_grad():
            a_ = a_r.detach().requires_grad_(True)
            b_ = b_r.detach().requires_grad_(True)
            out = ctx.op(a_, b_)
            ga, gb = torch.autograd.grad(out, (a_, b_), tf32_round(g))
        return None, ga, gb


class Precision:
    """``exact`` (products in the operands' own type, TF32 off) or
    ``tf32``."""

    def __init__(self, mode: str = "exact"):
        if mode not in ("exact", "tf32"):
            raise ValueError(f"precision {mode!r}: 'exact' or 'tf32'")
        self.mode = mode

    def _product(self, op, a, b):
        if self.mode == "tf32" and a.dtype == torch.float32:
            return _TF32Product.apply(op, a, b)
        return op(a, b)

    def einsum(self, eq: str, a, b):
        return self._product(lambda x, y: torch.einsum(eq, x, y), a, b)

    def matmul(self, a, b):
        return self._product(torch.matmul, a, b)


def no_tf32() -> None:
    """Float32 products in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
