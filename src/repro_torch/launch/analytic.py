"""Analytic FLOPs / HBM-bytes models per (architecture x input shape).

The port of ``repro.launch.analytic``: the same arithmetic in the same
order, so every count equals the reference's float for float.  It is the
napkin-math model of a step (the MaxText / Megatron MFU accounting) that
the roofline's compute and memory terms come from.  The port needs it
because its counted FLOPs (``torch.utils.flop_counter.FlopCounterMode``
in ``launch/dryrun.py``) see only the plain path's products, and the
CUDA kernels not at all (they are reached through ``ctypes``).

All counts are GLOBAL (whole step across all chips); divide by chips for
per-device.  A matmul (m, k) x (k, n) counts 2*m*k*n FLOPs.  Parameter
counts come from a shape-only init (``transformer.init_params(cfg, 0,
"meta")``), the counterpart of the reference's ``jax.eval_shape``: the
same tree, nothing allocated.
"""

from __future__ import annotations

import functools

from torch.utils import _pytree as pytree

from ..models.api import ModelConfig, layer_plan

__all__ = ["forward_flops", "step_flops", "step_bytes",
           "param_count_analytic", "active_param_count"]


def _attn_layer_flops(cfg: ModelConfig, plan_attn, tokens: int,
                      context: float) -> float:
    """Per-layer attention FLOPs for `tokens` query tokens with average
    attended context length `context`."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    proj = 2 * tokens * d * (h * hd + 2 * kv * hd) + 2 * tokens * h * hd * d
    scores = 2 * tokens * h * hd * context * 2       # qk^T and p@v
    return proj + scores


def _avg_context(spec, seq_len: int, kind: str) -> float:
    """Average attended context per query token."""
    if kind == "decode":
        ctx = float(seq_len)
        if spec.sliding_window is not None:
            ctx = min(ctx, spec.sliding_window)
        if spec.chunk is not None:
            ctx = min(ctx, spec.chunk)
        return ctx
    # train/prefill causal average = S/2 (bounded by window/chunk)
    ctx = seq_len / 2.0
    if spec.sliding_window is not None:
        ctx = min(ctx, float(spec.sliding_window))
    if spec.chunk is not None:
        ctx = min(ctx, spec.chunk / 2.0)
    return ctx


def _ffn_flops(cfg: ModelConfig, tokens: int) -> float:
    if cfg.ffn_kind in ("swiglu", "geglu"):
        return 2 * tokens * cfg.d_model * cfg.d_ff * 3
    return 2 * tokens * cfg.d_model * cfg.d_ff * 2


def _moe_flops(cfg: ModelConfig, plan_moe, tokens: int) -> float:
    router = 2 * tokens * cfg.d_model * cfg.moe_experts
    expert = 2 * tokens * cfg.moe_top_k * cfg.d_model * cfg.d_ff * 3
    shared = 2 * tokens * cfg.d_model * cfg.d_ff * 3 \
        if cfg.moe_shared_expert else 0
    return router + expert + shared


def _mamba_flops(cfg: ModelConfig, plan_m, tokens: int) -> float:
    d = cfg.d_model
    di = plan_m.expand * d
    ds = plan_m.d_state
    r = plan_m.rank
    proj = 2 * tokens * d * 2 * di + 2 * tokens * di * (r + 2 * ds) \
        + 2 * tokens * r * di + 2 * tokens * di * d
    conv = 2 * tokens * plan_m.d_conv * di
    scan = tokens * di * ds * 9                       # da, h update, y contraction
    return proj + conv + scan


def _mlstm_flops(cfg: ModelConfig, plan, tokens: int) -> float:
    d = cfg.d_model
    di = plan.d_inner
    hd = plan.head_dim
    proj = 2 * tokens * d * 2 * di + 3 * 2 * tokens * di * di \
        + 2 * tokens * di * d
    cell = tokens * plan.num_heads * hd * hd * 8      # C update + Cq readout
    return proj + cell


def _slstm_flops(cfg: ModelConfig, plan, tokens: int) -> float:
    d = cfg.d_model
    hd = plan.head_dim
    dff = int(plan.ffn_factor * d)
    gates = 2 * tokens * d * 4 * d
    rec = 4 * 2 * tokens * d * hd
    ffn = 2 * tokens * d * 2 * dff + 2 * tokens * dff * d
    return gates + rec + ffn


def forward_flops(cfg: ModelConfig, seq_len: int, batch: int,
                  kind: str) -> float:
    """One forward pass, global."""
    tokens = batch * (1 if kind == "decode" else seq_len)
    if cfg.frontend == "vision_stub":
        tokens_dec = tokens + (0 if kind == "decode"
                               else batch * cfg.image_tokens)
    else:
        tokens_dec = tokens
    total = 0.0
    for plan in layer_plan(cfg):
        if plan.mixer == "attn":
            ctx = _avg_context(plan.attn, seq_len, kind)
            total += _attn_layer_flops(cfg, plan.attn, tokens_dec, ctx)
        elif plan.mixer == "mamba":
            total += _mamba_flops(cfg, plan.mamba, tokens_dec)
        elif plan.mixer == "mlstm":
            total += _mlstm_flops(cfg, plan.mlstm, tokens_dec)
        else:
            total += _slstm_flops(cfg, plan.slstm, tokens_dec)
        if plan.ffn == "moe":
            total += _moe_flops(cfg, plan.moe, tokens_dec)
        elif plan.ffn != "none":
            total += _ffn_flops(cfg, tokens_dec)
    # encoder (whisper): bidirectional attention + gelu ffn over frames
    if cfg.encoder_layers > 0 and kind != "decode":
        frames = batch * cfg.encoder_seq
        for _ in range(cfg.encoder_layers):
            total += _attn_layer_flops(cfg, None, frames, cfg.encoder_seq)
            total += 2 * frames * cfg.d_model * cfg.d_ff * 2
        # cross attention in every decoder layer
        total += cfg.num_layers * (
            2 * tokens_dec * cfg.d_model * cfg.num_heads * cfg.hd * 2
            + 2 * tokens_dec * cfg.num_heads * cfg.hd * cfg.encoder_seq * 2)
    # lm head
    total += 2 * tokens * cfg.d_model * cfg.vocab_size
    return total


def step_flops(cfg: ModelConfig, shape, algorithm: str = "dpsvrg") -> float:
    """Global FLOPs for one step of the given kind.

    train: fwd(1) + bwd(2) + remat-refwd(1) = 4x fwd under full remat, 3.5x
    under the "dots" policy (matmul outputs saved, only elementwise
    recomputed — ~half a forward of recompute remains); DPSVRG evaluates the
    gradient at BOTH the iterate and the snapshot on the same batch -> 2x.
    (The once-per-K_s snapshot full gradient is amortized and excluded.)
    The port's trainer does not rematerialize; the model keeps the
    reference's multiplier so the two packages' counts stay one number.
    """
    kind = shape.kind
    fwd = forward_flops(cfg, shape.seq_len, shape.global_batch, kind)
    if kind == "train":
        per_grad = 3.5 if cfg.remat_policy == "dots" else 4.0
        mult = per_grad * (2.0 if algorithm == "dpsvrg" else 1.0)
        return mult * fwd
    return fwd


@functools.lru_cache(maxsize=64)
def _meta_leaves(cfg: ModelConfig) -> tuple:
    """((key names, shape) for every leaf of the parameter tree), from a
    shape-only init on the meta device."""
    from ..models import transformer
    params = transformer.init_params(cfg, 0, "meta")
    flat = pytree.tree_flatten_with_path(params)[0]
    return tuple(([str(getattr(e, "key", "")) for e in path],
                  tuple(leaf.shape)) for path, leaf in flat)


def param_count_analytic(cfg: ModelConfig) -> int:
    return sum(int(_size(shape)) for _, shape in _meta_leaves(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    total = 0
    for names, shape in _meta_leaves(cfg):
        size = _size(shape)
        if "moe" in names and len(shape) == 3:
            size = size // cfg.moe_experts * cfg.moe_top_k
        total += size
    return total


def _size(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def step_bytes(cfg: ModelConfig, shape, m_nodes: int, dtype_bytes: int = 2,
               algorithm: str = "dpsvrg") -> float:
    """Global HBM traffic estimate for one step.

    train  : params(2 fwd reads x2 grads) + grad writes/reads + SVRG state
             reads + gossip read/write + activations (~remat'd working set)
    prefill: params + activations + cache writes
    decode : params read once + full cache read + tiny activations — the
             classic bandwidth-bound regime.
    """
    p = param_count_analytic(cfg)
    act_factor = 14  # bytes/token/d_model-unit with remat, empirical constant
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        param_traffic = p * dtype_bytes * m_nodes * (
            (4 if algorithm == "dpsvrg" else 2)   # fwd reads (x2 grads)
            + 2                                   # grad write+read
            + (3 if algorithm == "dpsvrg" else 0)  # snapshot+mu reads, q write
            + 2)                                  # gossip read + prox write
        act_traffic = tokens * cfg.d_model * cfg.num_layers * act_factor
        return param_traffic + act_traffic
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        cache = _cache_bytes(cfg, shape, dtype_bytes)
        return p * dtype_bytes + tokens * cfg.d_model * cfg.num_layers * 6 \
            + cache
    # decode
    cache = _cache_bytes(cfg, shape, dtype_bytes)
    return p * dtype_bytes + cache + \
        shape.global_batch * cfg.d_model * cfg.num_layers * 8 * dtype_bytes


def _cache_bytes(cfg: ModelConfig, shape, dtype_bytes: int) -> float:
    total = 0.0
    for plan in layer_plan(cfg):
        if plan.mixer == "attn":
            alloc = shape.seq_len
            if plan.attn.sliding_window is not None:
                alloc = min(alloc, plan.attn.sliding_window)
            if plan.attn.chunk is not None:
                alloc = min(alloc, plan.attn.chunk)
            total += (shape.global_batch * alloc * cfg.num_kv_heads
                      * cfg.hd * 2 * dtype_bytes)
        elif plan.mixer == "mamba":
            total += (shape.global_batch * plan.mamba.d_inner
                      * plan.mamba.d_state * 4)
        elif plan.mixer == "mlstm":
            total += (shape.global_batch * plan.mlstm.num_heads
                      * plan.mlstm.head_dim ** 2 * 4)
        else:
            total += shape.global_batch * cfg.d_model * 4 * 4
    return total
