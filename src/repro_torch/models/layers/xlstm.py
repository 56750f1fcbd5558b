"""xLSTM layers: mLSTM (chunkwise-parallel) and sLSTM (sequential).

The PyTorch counterpart of the reference's ``models/layers/xlstm.py``.
mLSTM is a matrix-memory linear recurrence — the same blocked-scan shape
as Mamba2's SSD: within-chunk ``cumsum(log f)`` (prefix sum), across-chunk
affine carry of the matrix state ``S`` and normalizer ``n`` through
``core.scan``. sLSTM has a true hidden-to-gate recurrence (nonlinear), so
it cannot be scanned in parallel: it runs as a loop over time, with the
exp-gate max stabilizer carried as in the xLSTM paper. (The reference's
rematerialized chunking of that loop only shapes its backward's memory;
the values are the loop's.)

Numerics: the chunked mLSTM path runs the gate algebra in float32 without
the max stabilizer (``logsigmoid`` forget gates decay at most 1 and the
input gates stay bounded near init); the sequential sLSTM keeps it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import scan as scanlib
from repro_torch.dist import shard
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.common import (compute_dtype, const,
                                              dense_init, softplus)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _m_dims(cfg: ModelConfig):
    inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.ssm_heads or cfg.num_heads
    return inner, heads, inner // heads


class MLSTM(nn.Module):
    """The mLSTM block's projections, conv, gates and output norm."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
        d = cfg.d_model
        inner, H, _ = _m_dims(cfg)
        kw = dict(generator=generator, device=device)
        self.w_up = dense_init((d, 2 * inner), d, dt, **kw)
        self.conv_w = dense_init((cfg.conv_kernel, inner), cfg.conv_kernel,
                                 dt, **kw)
        self.conv_b = const(0.0, (inner,), device)
        self.w_q = dense_init((inner, inner), inner, dt, **kw)
        self.w_k = dense_init((inner, inner), inner, dt, **kw)
        self.w_v = dense_init((inner, inner), inner, dt, **kw)
        self.w_i = dense_init((inner, H), inner, torch.float32, **kw)
        self.w_f = dense_init((inner, H), inner, torch.float32, **kw)
        self.b_i = const(0.0, (H,), device)
        # positive forget bias: sigmoid(f) ~ 1 at init (long memory)
        self.b_f = const(3.0, (H,), device)
        self.norm_w = const(1.0, (inner,), device)
        self.w_out = dense_init((inner, d), inner, dt, **kw)

    def forward(self, x, **kw):
        return apply_mlstm(self, x, self.cfg, **kw)


def init_mlstm_cache(cfg: ModelConfig, batch: int, *, device="cuda"):
    inner, H, dh = _m_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, inner),
                            dtype=compute_dtype(cfg), device=device),
        "S": torch.zeros((batch, H, dh, dh), **f32),
        "n": torch.zeros((batch, H, dh), **f32),
    }


def _conv_silu(xm, w, b, tail):
    K = w.shape[0]
    if tail is None:
        tail = xm.new_zeros((xm.shape[0], K - 1, xm.shape[-1]))
    xfull = torch.cat([tail.to(xm.dtype), xm], dim=1)
    T = xm.shape[1]
    y = sum(xfull[:, k: k + T].float() * w[k].float() for k in range(K))
    return F.silu(y + b).to(xm.dtype), xfull[:, -(K - 1):]


def _headwise_norm(h, w, H, eps):
    """GroupNorm over each head's channels (f32)."""
    B, T, inner = h.shape
    hh = h.reshape(B, T, H, inner // H)
    mu = hh.mean(-1, keepdim=True)
    var = hh.var(-1, keepdim=True, unbiased=False)
    out = ((hh - mu) / torch.sqrt(var + eps)).reshape(B, T, inner)
    return out * w


def apply_mlstm(params, x, cfg: ModelConfig, *,
                cache: Optional[dict] = None):
    """mLSTM block over (B, T, D) -> (y, new_cache). Includes the block's
    own up/down projection (pf=2) and output skip gate (xLSTM wiring)."""
    B, T, D = x.shape
    inner, H, dh = _m_dims(cfg)
    up = x @ params.w_up
    xm, zg = up[..., :inner], up[..., inner:]
    xm = shard(xm, "batch", "seq", "ssm_inner")
    xc, new_tail = _conv_silu(xm, params.conv_w, params.conv_b,
                              None if cache is None else cache["conv"])
    q = (xc @ params.w_q).reshape(B, T, H, dh)
    k = (xc @ params.w_k).reshape(B, T, H, dh)
    v = (xm @ params.w_v).reshape(B, T, H, dh)
    i_raw = xc.float() @ params.w_i + params.b_i
    f_raw = xc.float() @ params.w_f + params.b_f
    log_f = F.logsigmoid(f_raw)                        # (B,T,H) <= 0
    log_i = -softplus(-i_raw) - 3.0                    # bounded input gate

    S_prev = n_prev = None
    if cache is not None:
        S_prev, n_prev = cache["S"], cache["n"]
    if T == 1 and cache is not None:
        h, S_new, n_new = _mlstm_step(q, k, v, log_i, log_f, S_prev, n_prev)
    else:
        h, S_new, n_new = _mlstm_chunked(q, k, v, log_i, log_f,
                                         cfg.ssm_chunk, S_prev, n_prev)
    h = h.reshape(B, T, inner)
    h = _headwise_norm(h, params.norm_w, H, cfg.norm_eps)
    h = h * F.silu(zg.float())
    h = shard(h.to(x.dtype), "batch", "seq", "ssm_inner")
    y = shard(h @ params.w_out, "batch", "seq", "embed")
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_tail, "S": S_new, "n": n_new}
    return y, new_cache


def _mlstm_step(q, k, v, log_i, log_f, S_prev, n_prev):
    B, _, H, dh = q.shape
    if S_prev is None:
        S_prev = q.new_zeros((B, H, dh, dh), dtype=torch.float32)
        n_prev = q.new_zeros((B, H, dh), dtype=torch.float32)
    scale = dh ** -0.5
    f = torch.exp(log_f[:, 0])[:, :, None, None]
    i = torch.exp(log_i[:, 0])[:, :, None, None]
    kv = torch.einsum("bhk,bhv->bhkv", k[:, 0].float(), v[:, 0].float())
    S = f * S_prev + i * kv
    n = f[..., 0] * n_prev + i[..., 0] * k[:, 0].float()
    qf = q[:, 0].float() * scale
    num = torch.einsum("bhk,bhkv->bhv", qf, S)
    den = torch.einsum("bhk,bhk->bh", qf, n).abs()
    h = num / den.clamp_min(1.0)[..., None]
    return h[:, None], S, n


def _mlstm_chunked(q, k, v, log_i, log_f, chunk, S_prev, n_prev):
    """Chunkwise-parallel mLSTM: the paper's partitioned two-pass scan with
    the (decay, [S;n]) affine monoid across chunks."""
    B, T, H, dh = q.shape
    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:
        q, k, v = (F.pad(u, (0, 0, 0, 0, 0, pad)) for u in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-1e30)  # exp -> 0
        log_f = F.pad(log_f, (0, 0, 0, pad))
    Tp = T + pad
    nc = Tp // Q
    scale = dh ** -0.5

    qc = (q.reshape(B, nc, Q, H, dh) * scale).float()
    kc = k.reshape(B, nc, Q, H, dh).float()
    vc = v.reshape(B, nc, Q, H, dh).float()
    ic = log_i.reshape(B, nc, Q, H)
    fc = log_f.reshape(B, nc, Q, H)

    # (1) prefix sum of log-forget within each chunk.
    Fc = scanlib.cumsum(fc, axis=2, algorithm="ref")   # (B,nc,Q,H)
    F_tot = Fc[:, :, -1]

    # Intra-chunk: W[i,j] = exp(F_i - F_j + i_j) (q_i . k_j), j <= i.
    rel = Fc[:, :, :, None, :] - Fc[:, :, None, :, :] + ic[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    G = torch.where(causal[None, None, :, :, None], torch.exp(rel), 0.0)
    qk = torch.einsum("bcihd,bcjhd->bcijh", qc, kc)
    W = qk * G                                         # (B,nc,Q,Q,H)
    num_intra = torch.einsum("bcijh,bcjhd->bcihd", W, vc)
    den_intra = W.sum(3)                               # (B,nc,Q,H)

    # (2) chunk totals (accumulate-first, Fig 1b) + affine scan across
    # chunks for matrix state S and normalizer n.
    w_out = torch.exp(F_tot[:, :, None] - Fc + ic)     # (B,nc,Q,H)
    S_tot = torch.einsum("bcjh,bcjhk,bcjhv->bchkv", w_out, kc, vc)
    n_tot = torch.einsum("bcjh,bcjhk->bchk", w_out, kc)
    a_chunk = torch.exp(F_tot)                         # (B,nc,H)
    aS = a_chunk[..., None, None].expand(S_tot.shape)
    an = a_chunk[..., None].expand(n_tot.shape)
    _, S_inc = scanlib.scan((aS, S_tot), op="affine", axis=1,
                            algorithm="ref")
    _, n_inc = scanlib.scan((an, n_tot), op="affine", axis=1,
                            algorithm="ref")
    if S_prev is None:
        S_prev = qc.new_zeros((B, H, dh, dh))
        n_prev = qc.new_zeros((B, H, dh))
    cum = torch.cumprod(a_chunk, dim=1)
    S_inc = S_inc + cum[..., None, None] * S_prev[:, None]
    n_inc = n_inc + cum[..., None] * n_prev[:, None]
    S_in = torch.cat([S_prev[:, None], S_inc[:, :-1]], dim=1)
    n_in = torch.cat([n_prev[:, None], n_inc[:, :-1]], dim=1)

    # (3) pass 2: fold the exclusive carry into per-position outputs.
    qd = qc * torch.exp(Fc)[..., None]
    num_inter = torch.einsum("bcihk,bchkv->bcihv", qd, S_in)
    den_inter = torch.einsum("bcihk,bchk->bcih", qd, n_in)
    num = num_intra + num_inter
    den = (den_intra + den_inter).abs().clamp_min(1.0)
    h = (num / den[..., None]).reshape(B, Tp, H, dh)[:, :T]
    return h, S_inc[:, -1], n_inc[:, -1]


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """sLSTM at model width with block-diagonal recurrence over heads:
    ``w_{i,f,o,z}`` (D, D), ``r_{i,f,o,z}`` (H, dh, dh), ``b_{i,f,o,z}``
    (H, dh), ``norm_w`` and ``w_out``."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        H = cfg.ssm_heads or cfg.num_heads
        dh = d // H
        kw = dict(generator=generator, device=device)
        for g in "ifoz":
            setattr(self, f"w_{g}",
                    dense_init((d, d), d, torch.float32, **kw))
            setattr(self, f"r_{g}",
                    dense_init((H, dh, dh), dh, torch.float32, **kw))
            setattr(self, f"b_{g}",
                    const(3.0 if g == "f" else 0.0, (H, dh), device))
        self.norm_w = const(1.0, (d,), device)
        self.w_out = dense_init((d, d), d, compute_dtype(cfg), **kw)

    def forward(self, x, **kw):
        return apply_slstm(self, x, self.cfg, **kw)


def init_slstm_cache(cfg: ModelConfig, batch: int, *, device="cuda"):
    H = cfg.ssm_heads or cfg.num_heads
    dh = cfg.d_model // H
    z = torch.zeros((batch, H, dh), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z + 1.0, "m": z.clone()}


def apply_slstm(params, x, cfg: ModelConfig, *,
                cache: Optional[dict] = None):
    """Sequential sLSTM over (B, T, D), stabilized exp gates."""
    B, T, D = x.shape
    H = cfg.ssm_heads or cfg.num_heads
    dh = D // H
    xf = x.float()
    # input contributions of all gates: (B, T, H, dh) each
    pre = {g: (xf @ getattr(params, f"w_{g}")).reshape(B, T, H, dh)
           + getattr(params, f"b_{g}") for g in "ifoz"}
    s = init_slstm_cache(cfg, B, device=x.device) if cache is None \
        else cache
    r = {g: getattr(params, f"r_{g}") for g in "ifoz"}
    hs = []
    for t in range(T):
        rec = {g: torch.einsum("bhe,hde->bhd", s["h"], r[g]) for g in "ifoz"}
        i_t = pre["i"][:, t] + rec["i"]
        f_t = pre["f"][:, t] + rec["f"]
        o_t = torch.sigmoid(pre["o"][:, t] + rec["o"])
        z_t = torch.tanh(pre["z"][:, t] + rec["z"])
        log_f = F.logsigmoid(f_t)
        m_new = torch.maximum(log_f + s["m"], i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(log_f + s["m"] - m_new)
        c = f_p * s["c"] + i_p * z_t
        n = (f_p * s["n"] + i_p).clamp_min(1e-6)
        h = o_t * c / n
        s = {"h": h, "c": c, "n": n, "m": m_new}
        hs.append(h)
    h = torch.stack(hs, 1).reshape(B, T, D)
    h = _headwise_norm(h, params.norm_w, H, cfg.norm_eps)
    y = shard(h.to(x.dtype) @ params.w_out, "batch", "seq", "embed")
    return y, (s if cache is not None else None)
