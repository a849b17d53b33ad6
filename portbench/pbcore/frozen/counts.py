"""Operations and bytes of each unit of work, counted from its shapes.

A product (m, k) x (k, n) counts 2mkn operations.  Bytes count each input
read once and each output written once, whatever a kernel reads again;
work that several cells share (a dataset every cell reads at the same
boundary) is counted once, since one pass could serve them all.  Only
work that the algorithm needs is counted, so every share built on these
counts is a lower bound on time and stays below 100%.

The dense-transformer arithmetic is that of the program's
``launch/analytic.py`` (the MaxText / Megatron accounting), with the
causal context counted exactly instead of as S/2."""

from __future__ import annotations

from .peaks import least_seconds

F32 = 4


# ---------------------------------------------------------------------------
# l1-regularized logistic regression, DPSVRG over B cells
# ---------------------------------------------------------------------------

def logreg_step(B: int, m: int, d: int, bsz: int):
    """One inner step of every cell: each node's stochastic gradients at
    the iterate and the snapshot (a dot and an axpy a sample each), the
    mix of the stacked (m, d) buffer and the prox.  -> (flops, bytes)."""
    flops = B * m * (8 * bsz * d + 2 * m * d)
    nbytes = (B * m * bsz * (d + 1) * F32    # the minibatch rows, labels
              + B * m * 6 * d * F32          # x, x~, mu, sum in; x, sum out
              + m * m * F32)                 # the mixing product
    return flops, nbytes


def logreg_refresh(B: int, m: int, n: int, d: int):
    """Every cell's full local gradient at its anchor: one pass over the
    shared dataset."""
    flops = B * m * n * 4 * d
    nbytes = m * n * (d + 1) * F32 + 2 * B * m * d * F32
    return flops, nbytes


def logreg_record(B: int, m: int, n: int, d: int):
    """Every cell's objective F(x_bar) over the whole dataset."""
    flops = B * m * n * 2 * d
    nbytes = m * n * (d + 1) * F32 + B * m * d * F32
    return flops, nbytes


def logreg_grid(B: int, m: int, n: int, d: int, bsz: int,
                outer_lengths, records: int):
    """The least seconds a whole grid of resident DPSVRG needs, a unit of
    work at a time."""
    units = [(logreg_step(B, m, d, bsz), sum(outer_lengths)),
             (logreg_refresh(B, m, n, d), len(outer_lengths)),
             (logreg_record(B, m, n, d), records)]
    return sum(least_seconds(f, b) * k for (f, b), k in units)


def fused_step_bytes(B: int, m: int, d: int) -> int:
    """The fused resident step prox(W (x - alpha v)) of B cells, v the svrg
    rule's g - g~ + mu: x and the three gradient terms in, the mixing
    product in, the new x out."""
    return (B * m * d * 5 + B * m * m) * F32


# ---------------------------------------------------------------------------
# Dense decoder-only transformer (attention with GQA and a window, SwiGLU)
# ---------------------------------------------------------------------------

def lm_params(c: dict) -> int:
    """Parameters of the model: per layer the q, k, v, o projections, the
    SwiGLU FFN and two norms; the embedding, the head where it is not
    tied, and the final norm."""
    d, h, kv, hd, ff = (c["d_model"], c["num_heads"], c["num_kv_heads"],
                        c["head_dim"], c["d_ff"])
    layer = d * (h * hd + 2 * kv * hd) + h * hd * d + 3 * d * ff + 2 * d
    heads = 1 if c["tie_embeddings"] else 2
    return c["num_layers"] * layer + heads * c["vocab_size"] * d + d


def _proj_flops_per_token(c: dict) -> int:
    d, h, kv, hd, ff = (c["d_model"], c["num_heads"], c["num_kv_heads"],
                        c["head_dim"], c["d_ff"])
    return c["num_layers"] * (2 * d * (h * hd + 2 * kv * hd)
                              + 2 * h * hd * d + 6 * d * ff)


def causal_context(T: int, window) -> int:
    """Keys each query attends to, summed over a causal sequence of T
    (q attends to min(q, window) positions, itself included)."""
    if window is None or window >= T:
        return T * (T + 1) // 2
    return window * (window + 1) // 2 + (T - window) * window


def attention_core_flops(c: dict, T: int) -> int:
    """q k^T and p v of a causal sequence of T over every layer."""
    return c["num_layers"] * 4 * c["num_heads"] * c["head_dim"] \
        * causal_context(T, c.get("sliding_window"))


def attention_core_bytes(c: dict, T: int) -> int:
    """q, k, v in and the output out, every layer."""
    h, kv, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    return c["num_layers"] * T * (2 * h * hd + 2 * kv * hd) * F32


def lm_forward_flops(c: dict, batch: int, T: int) -> int:
    """The training forward of ``batch`` sequences of T: every position's
    logits."""
    per_tok = _proj_flops_per_token(c) + 2 * c["d_model"] * c["vocab_size"]
    return batch * (T * per_tok + attention_core_flops(c, T))


def lm_grad(c: dict, batch: int, T: int):
    """One gradient of the loss over ``batch`` sequences of T (backward =
    2x forward): -> (flops, bytes); the weights read once, the gradient
    written once."""
    p = lm_params(c)
    return 3 * lm_forward_flops(c, batch, T), 2 * p * F32


def lm_dpsvrg_step(c: dict, m: int, batch: int, T: int):
    """One DPSVRG step of m nodes: each node's gradients at its iterate and
    its snapshot on one minibatch, then the update of the stacked
    parameters (x, snapshot, mu in; x out)."""
    f, _ = lm_grad(c, batch, T)
    return 2 * m * f, 4 * m * lm_params(c) * F32


def lm_refresh(c: dict, m: int, batch: int, T: int):
    """The snapshot refresh: each node's gradient over its large batch."""
    f, _ = lm_grad(c, batch, T)
    return m * f, 2 * m * lm_params(c) * F32


def lm_prefill(c: dict, T: int):
    """A batch-1 prefill of T tokens: every position through the layers,
    the logits of the last, the cache written."""
    d, V = c["d_model"], c["vocab_size"]
    flops = T * _proj_flops_per_token(c) + 2 * d * V \
        + attention_core_flops(c, T)
    kv_written = c["num_layers"] * min(T, c.get("sliding_window") or T) \
        * 2 * c["num_kv_heads"] * c["head_dim"] * F32
    return flops, lm_params(c) * F32 + kv_written


def lm_decode(c: dict, positions):
    """One decode step of the active slots at ``positions`` (each the
    number of positions already in its cache): weights read once, each
    slot's cached keys and values read, the logits written."""
    L, h, kv, hd = (c["num_layers"], c["num_heads"], c["num_kv_heads"],
                    c["head_dim"])
    w = c.get("sliding_window")
    ctx = [min(p + 1, w) if w else p + 1 for p in positions]
    A = len(positions)
    flops = A * (_proj_flops_per_token(c) + 2 * c["d_model"]
                 * c["vocab_size"]) + L * 4 * h * hd * sum(ctx)
    nbytes = (lm_params(c) * F32 + L * sum(ctx) * 2 * kv * hd * F32
              + A * c["vocab_size"] * F32)
    return flops, nbytes
