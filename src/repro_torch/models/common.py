"""Shared model building blocks: initializers, norms, RoPE, softcap.

The port of ``repro.models.common``.  Models are plain functions over
nested-dict parameter trees with the same keys and nesting as the JAX
package's, so ``repro_torch.convert.params_from_numpy`` carries JAX
parameters across leaf by leaf.  Initializers draw from an explicit
``torch.Generator`` (the JAX package's ``KeyGen``): the distributions match
the JAX ones, the values do not.  On the ``meta`` device, which has no
generator, ``make_generator`` gives a ``MetaGenerator`` and the
initializers make shape-only tensors without drawing: ``init_params(cfg,
0, "meta")`` is the tree's shapes and dtypes (the counterpart of the
reference's ``jax.eval_shape`` of its init).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "embed_init", "zeros_init", "ones_init", "rms_norm",
           "layer_norm", "apply_rope", "rope_angles", "softcap", "gelu",
           "make_generator", "resolve_device", "MetaGenerator"]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` without a CUDA device
    raises: the port never carries on on the CPU unless asked to."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on the CUDA device by default, and none is "
                "available; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        # float32 products run in full float32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


class MetaGenerator:
    """The stand-in generator of a shape-only init: it has a device and
    draws nothing."""
    device = torch.device("meta")


def make_generator(seed_or_generator, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device``: an int seeds a new one, a
    generator passes through (it must live on ``device``).  On the meta
    device, a ``MetaGenerator``."""
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    if torch.device(device).type == "meta":
        return MetaGenerator()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed_or_generator))
    return gen


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               scale: float | None = None, device=None):
    """Truncated-normal fan-in init: N(0, 1) cut to [-2, 2], times
    ``scale`` or 1/sqrt(fan_in)."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if isinstance(gen, MetaGenerator):
        return torch.empty(shape, dtype=dtype, device="meta")
    out = torch.empty(shape, dtype=torch.float32, device=device or gen.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (out * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32, device=None):
    if isinstance(gen, MetaGenerator):
        return torch.empty((vocab, dim), dtype=dtype, device="meta")
    out = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                      device=device or gen.device)
    return (out * (1.0 / math.sqrt(dim))).to(dtype)


def zeros_init(shape, dtype=torch.float32, device=None):
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones_init(shape, dtype=torch.float32, device=None):
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + weight.to(torch.float32))
    return out.to(dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps)
    out = out * weight.to(torch.float32) + bias.to(torch.float32)
    return out.to(dtype)


def rope_angles(positions, head_dim: int, theta: float = 10000.0):
    """positions: (..., S) int -> (cos, sin) of shape (..., S, head_dim/2),
    angles in float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # theta enters as a scalar operand (float32 in the op): a tensor made
    # from it on the card would be a host-to-device copy, which synchronises
    freqs = torch.pow(float(theta), exps)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, head_dim); cos/sin: (..., S, half) broadcast over H.
    Half-split layout (not interleaved); computed in float32 and cast back
    to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def softcap(logits, cap: float | None):
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")
