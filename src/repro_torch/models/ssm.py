"""State-space and recurrent blocks: Mamba (S6), mLSTM, sLSTM.

The port of ``repro.models.ssm``: the sub-quadratic token mixers of the
jamba (hybrid) and xlstm (ssm) architectures, with the JAX package's
parameter trees, key names and initial distributions.  Each mixer has
three entry points:

  forward(params, spec, x)          -- full-sequence path (training, prefill)
  init_state(spec, batch, ...)      -- zero recurrent state for decoding
  step(params, spec, x_t, state)    -- single-token decode

The reference computes the time recurrences with ``lax.scan`` in XLA (no
Pallas kernel); the port runs them as Python loops over the sequence that
stack their outputs out of place, so they run under ``torch.func.vmap``
over nodes (the trainer's per-node gradients) and under autograd.  The
recurrent states (Mamba's h, mLSTM's C, n, m and sLSTM's c, n, h, m) are
float32 in every model dtype; the scans take float32 inputs and cast their
outputs back to the activation dtype.  The inner norms of mLSTM and sLSTM
are the plain ``common.rms_norm``, as in the reference, whatever the
config's ``use_fused_norm`` says.

Mamba and mLSTM also run on a slice of their channels (a sharded step's
local region, ``models.placed.channel_call``): their few steps that cross
channels go through a ``ch`` argument, :class:`Whole` on one device
(``halves`` splits an up-projection into its two halves, ``psum`` sums a
product over the channel slices, ``gather`` makes a channel dim whole and
``rms_norm`` normalizes over every channel), and the sizes of the states
and loops are read from the tensors, so that the same code runs on the
rank's channels with the rank's weights.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from . import common

__all__ = ["MambaSpec", "init_mamba", "mamba_forward", "mamba_init_state",
           "mamba_step", "MLstmSpec", "init_mlstm", "mlstm_forward",
           "mlstm_init_state", "mlstm_step", "SLstmSpec", "init_slstm",
           "slstm_forward", "slstm_init_state", "slstm_step"]

F32 = torch.float32


class Whole:
    """The cross-channel steps of Mamba and mLSTM on every channel: the
    plain code, as the reference writes it."""

    @staticmethod
    def halves(t):
        return torch.chunk(t, 2, dim=-1)

    @staticmethod
    def psum(t):
        return t

    @staticmethod
    def gather(t):
        return t

    @staticmethod
    def rms_norm(h, weight):
        return common.rms_norm(h, weight)


WHOLE = Whole()


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
    at every input (``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(params, d_conv: int, inner, conv_state):
    """Depthwise causal conv over time of ``inner`` (B, L, di) after the
    ``d_conv - 1`` positions of ``conv_state`` (zeros when None), summed
    tap by tap in the reference's order.  Returns (conv, new_conv_state):
    the state is the last ``d_conv - 1`` padded positions, the zero pad
    included for a prompt shorter than that."""
    b, l, di = inner.shape
    if conv_state is None:
        pad = torch.zeros((b, d_conv - 1, di), dtype=inner.dtype,
                          device=inner.device)
    else:
        pad = conv_state
    padded = torch.cat([pad, inner], dim=1)
    new_state = padded[:, -(d_conv - 1):] if d_conv > 1 else pad
    conv = padded[:, :l] * params["conv_w"][0][None, None]
    for i in range(1, d_conv):
        conv = conv + padded[:, i:i + l] * params["conv_w"][i][None, None]
    return conv, new_state


# ---------------------------------------------------------------------------
# Mamba (S6 selective state space)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    expand: int = 2
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int | None = None          # default max(d_model // 16, 1)
    # the reference's remat granularity of its scan (``jax.checkpoint`` per
    # chunk), which changes no number; the port runs one loop over the
    # whole length and keeps it as data
    chunk_size: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or max(self.d_model // 16, 1)


def init_mamba(gen: torch.Generator, spec: MambaSpec, dtype=F32):
    d, di, ds, r = spec.d_model, spec.d_inner, spec.d_state, spec.rank
    dev = gen.device
    # S4D-real initialization of A
    a_init = torch.arange(1, ds + 1, dtype=F32, device=dev)[None].repeat(
        di, 1)
    return {
        "in_proj": common.dense_init(gen, (d, 2 * di), dtype),
        "conv_w": common.dense_init(gen, (spec.d_conv, di), dtype,
                                    scale=1.0 / math.sqrt(spec.d_conv)),
        "conv_b": common.zeros_init((di,), dtype, dev),
        "x_proj": common.dense_init(gen, (di, r + 2 * ds), dtype),
        "dt_proj": common.dense_init(gen, (r, di), dtype),
        "dt_bias": common.zeros_init((di,), dtype, dev),
        "a_log": torch.log(a_init).to(dtype),
        "d_skip": common.ones_init((di,), dtype, dev),
        "out_proj": common.dense_init(gen, (di, d), dtype),
    }


def _mamba_inputs(params, spec: MambaSpec, x, conv_state=None, ch=WHOLE):
    """Shared pre-scan computation.  x: (B, L, d).

    Returns (u, z, dt, b_mat, c_mat, new_conv_state)."""
    ds, r = spec.d_state, spec.rank
    xz = x @ params["in_proj"]
    u, z = ch.halves(xz)                                 # (B, L, di) each
    conv, new_conv_state = _causal_conv(params, spec.d_conv, u, conv_state)
    u = F.silu(conv + params["conv_b"])
    proj = ch.psum(u @ params["x_proj"])                 # (B, L, r + 2 ds)
    dt_in, b_mat, c_mat = torch.split(proj, [r, ds, ds], dim=-1)
    dt = _softplus(dt_in @ params["dt_proj"] + params["dt_bias"])
    return u, z, dt, b_mat, c_mat, new_conv_state


def _mamba_scan_chunk(params, u, dt, b_mat, c_mat, h0):
    """Scan a stretch of time.  u/dt: (B, C, di); b/c: (B, C, ds); h0:
    (B, di, ds), all float32.  Returns (h_final, ys (B, C, di))."""
    a = -torch.exp(params["a_log"].to(F32))              # (di, ds)
    h, ys = h0, []
    for t in range(u.shape[1]):
        dt_t, u_t = dt[:, t], u[:, t]
        da = torch.exp(dt_t[..., None] * a[None])        # (B, di, ds)
        h = da * h + (dt_t * u_t)[..., None] * b_mat[:, t][:, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, c_mat[:, t]))
    return h, torch.stack(ys, dim=1)


def _mamba_scan(spec: MambaSpec, params, u, dt, b_mat, c_mat):
    """The Mamba recurrence over the whole length from the zero state, on
    float32 casts of the inputs: (h_final, ys).  One loop: the reference's
    chunks (``spec.chunk_size``) are remat boundaries of its scan and give
    the same numbers."""
    h0 = torch.zeros((u.shape[0], u.shape[-1], spec.d_state), dtype=F32,
                     device=u.device)
    return _mamba_scan_chunk(params, u.to(F32), dt.to(F32), b_mat.to(F32),
                             c_mat.to(F32), h0)


def _mamba_out(params, x, u, z, ys):
    y = ys.to(x.dtype) + u * params["d_skip"]
    y = y * F.silu(z)
    return y @ params["out_proj"]


def mamba_forward(params, spec: MambaSpec, x, ch=WHOLE):
    """Training forward.  x: (B, L, d) -> (B, L, d)."""
    u, z, dt, b_mat, c_mat, _ = _mamba_inputs(params, spec, x, ch=ch)
    _, ys = _mamba_scan(spec, params, u, dt, b_mat, c_mat)
    return _mamba_out(params, x, u, z, ys)


def mamba_init_state(spec: MambaSpec, batch: int, dtype=F32, device=None):
    return {
        "h": torch.zeros((batch, spec.d_inner, spec.d_state), dtype=F32,
                         device=device),
        "conv": torch.zeros((batch, spec.d_conv - 1, spec.d_inner),
                            dtype=dtype, device=device),
    }


def mamba_step(params, spec: MambaSpec, x_t, state, ch=WHOLE):
    """x_t: (B, 1, d) -> (y, new_state)."""
    u, z, dt, b_mat, c_mat, new_conv = _mamba_inputs(
        params, spec, x_t, conv_state=state["conv"], ch=ch)
    a = -torch.exp(params["a_log"].to(F32))
    dt_t = dt[:, 0].to(F32)
    u_t = u[:, 0].to(F32)
    da = torch.exp(dt_t[..., None] * a[None])
    h = da * state["h"] + (dt_t * u_t)[..., None] * \
        b_mat[:, 0][:, None, :].to(F32)
    y = torch.einsum("bds,bs->bd", h, c_mat[:, 0].to(F32))[:, None, :]
    y = y.to(x_t.dtype) + u * params["d_skip"]
    y = y * F.silu(z)
    return y @ params["out_proj"], {"h": h, "conv": new_conv}


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM, xLSTM paper)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLstmSpec:
    d_model: int
    num_heads: int
    proj_factor: float = 2.0
    d_conv: int = 4

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.d_model)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.num_heads


def init_mlstm(gen: torch.Generator, spec: MLstmSpec, dtype=F32):
    d, di, nh = spec.d_model, spec.d_inner, spec.num_heads
    dev = gen.device
    return {
        "up_proj": common.dense_init(gen, (d, 2 * di), dtype),
        "conv_w": common.dense_init(gen, (spec.d_conv, di), dtype),
        "conv_b": common.zeros_init((di,), dtype, dev),
        "wq": common.dense_init(gen, (di, di), dtype),
        "wk": common.dense_init(gen, (di, di), dtype),
        "wv": common.dense_init(gen, (di, di), dtype),
        "w_if": common.dense_init(gen, (di, 2 * nh), dtype, scale=0.02),
        "b_i": common.zeros_init((nh,), dtype, dev),
        # forget-gate bias init positive => long memory at init
        "b_f": (torch.ones((nh,), dtype=F32, device=dev) * 3.0).to(dtype),
        "skip_w": common.ones_init((di,), dtype, dev),
        "norm_w": common.zeros_init((di,), dtype, dev),
        "down_proj": common.dense_init(gen, (di, d), dtype),
    }


def _mlstm_cell(q, k, v, i_tilde, f_tilde, state):
    """One time step of the stabilized mLSTM recurrence.

    q,k,v: (B, H, hd); i_tilde,f_tilde: (B, H); state: (C, n, m).
    C: (B, H, hd, hd), n: (B, H, hd), m: (B, H).
    """
    c_prev, n_prev, m_prev = state
    m_t = torch.maximum(f_tilde + m_prev, i_tilde)
    i_p = torch.exp(i_tilde - m_t)
    f_p = torch.exp(f_tilde + m_prev - m_t)
    c_t = f_p[..., None, None] * c_prev + i_p[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n_t = f_p[..., None] * n_prev + i_p[..., None] * k
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n_t, q)),
                          torch.exp(-m_t))
    h = torch.einsum("bhij,bhj->bhi", c_t, q) / denom[..., None]
    return (c_t, n_t, m_t), h


def _mlstm_qkvif(params, spec: MLstmSpec, x, conv_state=None, ch=WHOLE):
    """q, k and v of the heads whose channels ``inner`` holds: every head
    on one device; on a channel slice, ``wq``/``wk``/``wv`` hold the
    slice's columns and ``w_if``/``b_i``/``b_f`` its heads' gates."""
    b, l, _ = x.shape
    hd = spec.head_dim
    up = x @ params["up_proj"]
    inner, gate = ch.halves(up)
    nh = inner.shape[-1] // hd
    conv, new_conv = _causal_conv(params, spec.d_conv, inner, conv_state)
    conv = F.silu(conv + params["conv_b"])
    conv_all, inner_all = ch.gather(conv), ch.gather(inner)
    q = (conv_all @ params["wq"]).reshape(b, l, nh, hd) / math.sqrt(hd)
    k = (conv_all @ params["wk"]).reshape(b, l, nh, hd)
    v = (inner_all @ params["wv"]).reshape(b, l, nh, hd)
    if_g = conv_all @ params["w_if"]
    i_tilde = if_g[..., :nh] + params["b_i"]
    f_tilde = if_g[..., nh:] + params["b_f"]
    return inner, gate, q, k, v, i_tilde, f_tilde, new_conv


def _mlstm_scan(spec: MLstmSpec, q, k, v, i_t, f_t):
    """The mLSTM recurrence over time from the zero state, on float32 casts
    of (B, L, ...) inputs.  Returns ((C, n, m) final, hs (B, L, H, hd))."""
    b, _, nh, hd = q.shape
    q, k, v, i_t, f_t = (t.to(F32) for t in (q, k, v, i_t, f_t))
    state = (torch.zeros((b, nh, hd, hd), dtype=F32, device=q.device),
             torch.zeros((b, nh, hd), dtype=F32, device=q.device),
             torch.zeros((b, nh), dtype=F32, device=q.device))
    hs = []
    for t in range(q.shape[1]):
        state, h = _mlstm_cell(q[:, t], k[:, t], v[:, t], i_t[:, t],
                               f_t[:, t], state)
        hs.append(h)
    return state, torch.stack(hs, dim=1)


def _mlstm_out(params, spec: MLstmSpec, x, inner, gate, hs, ch=WHOLE):
    b, l = hs.shape[:2]
    h = hs.reshape(b, l, inner.shape[-1]).to(x.dtype)
    h = ch.rms_norm(h, params["norm_w"]) + inner * params["skip_w"]
    h = h * F.silu(gate)
    return h @ params["down_proj"]


def mlstm_forward(params, spec: MLstmSpec, x, ch=WHOLE):
    inner, gate, q, k, v, i_t, f_t, _ = _mlstm_qkvif(params, spec, x, ch=ch)
    _, hs = _mlstm_scan(spec, q, k, v, i_t, f_t)
    return _mlstm_out(params, spec, x, inner, gate, hs, ch)


def mlstm_init_state(spec: MLstmSpec, batch: int, dtype=F32, device=None):
    nh, hd = spec.num_heads, spec.head_dim
    return {
        "c": torch.zeros((batch, nh, hd, hd), dtype=F32, device=device),
        "n": torch.zeros((batch, nh, hd), dtype=F32, device=device),
        "m": torch.zeros((batch, nh), dtype=F32, device=device),
        "conv": torch.zeros((batch, spec.d_conv - 1, spec.d_inner),
                            dtype=dtype, device=device),
    }


def mlstm_step(params, spec: MLstmSpec, x_t, state, ch=WHOLE):
    inner, gate, q, k, v, i_t, f_t, new_conv = _mlstm_qkvif(
        params, spec, x_t, conv_state=state["conv"], ch=ch)
    st = (state["c"], state["n"], state["m"])
    st, h = _mlstm_cell(q[:, 0].to(F32), k[:, 0].to(F32), v[:, 0].to(F32),
                        i_t[:, 0].to(F32), f_t[:, 0].to(F32), st)
    out = _mlstm_out(params, spec, x_t, inner, gate, h[:, None], ch)
    return out, {"c": st[0], "n": st[1], "m": st[2], "conv": new_conv}


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with exponential gating + head-wise state mixing)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLstmSpec:
    d_model: int
    num_heads: int
    ffn_factor: float = 4.0 / 3.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def init_slstm(gen: torch.Generator, spec: SLstmSpec, dtype=F32):
    d, nh, hd = spec.d_model, spec.num_heads, spec.head_dim
    dff = int(spec.ffn_factor * d)
    dev = gen.device
    return {
        "w_gates": common.dense_init(gen, (d, 4 * d), dtype),
        # block-diagonal recurrent mixing: per-head (hd, hd) for each gate
        "r_gates": common.dense_init(gen, (4, nh, hd, hd), dtype,
                                     scale=1.0 / math.sqrt(hd)),
        "b_gates": common.zeros_init((4 * d,), dtype, dev),
        "norm_w": common.zeros_init((d,), dtype, dev),
        "ffn_up": common.dense_init(gen, (d, 2 * dff), dtype),
        "ffn_down": common.dense_init(gen, (dff, d), dtype),
    }


def _slstm_cell(params, spec: SLstmSpec, gates_x, state):
    """gates_x: (B, 4d) input contribution; state: (c, n, h, m) each (B, d).
    The recurrent mix is one per-head product a gate, stacked in the gate
    order i, f, z, o."""
    nh, hd = spec.num_heads, spec.head_dim
    c, n, h, m = state
    hh = h.reshape(-1, nh, hd)
    rec = torch.stack([
        torch.einsum("bhi,hij->bhj", hh,
                     params["r_gates"][g].to(F32)).reshape(h.shape)
        for g in range(4)], dim=-2)                      # (B, 4, d)
    gx = gates_x.reshape(-1, 4, h.shape[-1]) + rec + \
        params["b_gates"].to(F32).reshape(4, -1)
    i_t, f_t, z_t, o_t = gx[:, 0], gx[:, 1], gx[:, 2], gx[:, 3]
    m_t = torch.maximum(f_t + m, i_t)
    i_p = torch.exp(i_t - m_t)
    f_p = torch.exp(f_t + m - m_t)
    c_t = f_p * c + i_p * torch.tanh(z_t)
    n_t = f_p * n + i_p
    h_t = torch.sigmoid(o_t) * c_t / torch.clamp(n_t, min=1.0)
    return (c_t, n_t, h_t, m_t), h_t


def _slstm_scan(params, spec: SLstmSpec, x):
    """The sLSTM recurrence over x (B, L, d) from the zero state.  Returns
    ((c, n, h, m) final, hs (B, L, d) float32)."""
    b, _, d = x.shape
    gates_x = (x @ params["w_gates"]).to(F32)
    z = torch.zeros((b, d), dtype=F32, device=x.device)
    state, hs = (z, z, z, z), []
    for t in range(gates_x.shape[1]):
        state, h = _slstm_cell(params, spec, gates_x[:, t], state)
        hs.append(h)
    return state, torch.stack(hs, dim=1)


def _slstm_out(params, x, hs):
    h = common.rms_norm(hs.to(x.dtype), params["norm_w"])
    up = h @ params["ffn_up"]
    a, g = torch.chunk(up, 2, dim=-1)
    return (common.gelu(a) * g) @ params["ffn_down"]


def slstm_forward(params, spec: SLstmSpec, x):
    _, hs = _slstm_scan(params, spec, x)
    return _slstm_out(params, x, hs)


def slstm_init_state(spec: SLstmSpec, batch: int, dtype=F32, device=None):
    """The four (B, d) float32 states; ``dtype`` is the model's, which no
    sLSTM state takes (kept for the other mixers' signature)."""
    return {k: torch.zeros((batch, spec.d_model), dtype=F32, device=device)
            for k in ("c", "n", "h", "m")}


def slstm_step(params, spec: SLstmSpec, x_t, state):
    gx = (x_t[:, 0] @ params["w_gates"]).to(F32)
    st = (state["c"], state["n"], state["h"], state["m"])
    st, h = _slstm_cell(params, spec, gx, st)
    out = _slstm_out(params, x_t, h[:, None, :])
    return out, {"c": st[0], "n": st[1], "h": st[2], "m": st[3]}
