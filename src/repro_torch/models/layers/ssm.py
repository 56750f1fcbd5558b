"""Mamba2 (SSD) layer — the paper's blocked scan generalized to matrix state.

The PyTorch counterpart of the reference's ``models/layers/ssm.py``. The
chunked SSD algorithm is the paper's §2.2 cache-friendly partitioned scan,
instantiated twice:

  1. WITHIN a chunk: ``cumsum(log decay)`` — a plain prefix sum
     (``repro_torch.core.scan``), used to build the intra-chunk decay
     kernel.
  2. ACROSS chunks: the matrix-valued state ``S_c`` carries through the
     affine monoid ``h_c = a_c · h_{c-1} + S_c`` — pass 1 reduces each
     chunk to a total (``S_c``), the carry exchange is the scan over chunk
     totals, pass 2 combines the exclusive prefix back into each chunk's
     outputs.

``impl="auto"`` routes the SERVE path (a cache present: prefill into a
slot) of a CUDA tensor through the affine scan kernels
(``kernels.ssm_scan``, with ``schedule="auto"``), where the reference
routes it on a TPU; elsewhere, and on the training path, the chunked
reference scan runs. ``impl="kernel"`` forces the kernel route on any
device: on the CPU the kernels' plain versions run. The kernel route is
differentiable (its backward is one more engine scan).
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


def _dims(cfg: ModelConfig):
    inner = cfg.ssm_heads * cfg.ssm_head_dim
    conv_dim = inner + 2 * cfg.ssm_state
    return inner, conv_dim


class SSM(nn.Module):
    """Mamba2 parameters. ``in_proj`` emits [z | x | B | C | dt]."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
        d = cfg.d_model
        inner, conv_dim = _dims(cfg)
        kw = dict(generator=generator, device=device)
        proj_out = 2 * inner + 2 * cfg.ssm_state + cfg.ssm_heads
        # dt bias initialized so softplus(dt_bias) spans ~[1e-3, 1e-1].
        u = torch.rand(cfg.ssm_heads, generator=generator, device=device)
        lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(0.1))
        dt_init = torch.exp(u * (hi - lo).item() + lo.item())
        dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inv softplus
        self.in_proj = dense_init((d, proj_out), d, dt, **kw)
        self.conv_w = dense_init((cfg.conv_kernel, conv_dim),
                                 cfg.conv_kernel, dt, **kw)
        self.conv_b = const(0.0, (conv_dim,), device)
        self.a_log = nn.Parameter(torch.log(torch.arange(
            1, cfg.ssm_heads + 1, dtype=torch.float32, device=device)))
        self.dt_bias = nn.Parameter(dt_bias)
        self.d_skip = const(1.0, (cfg.ssm_heads,), device)
        self.norm_w = const(1.0, (inner,), device)
        self.out_proj = dense_init((inner, d), inner, dt, **kw)

    def forward(self, x, **kw):
        return apply_ssm(self, x, self.cfg, **kw)


def init_ssm_cache(cfg: ModelConfig, batch: int, *, device="cuda"):
    """Decode-time cache: depthwise-conv tail + SSM state (f32)."""
    _, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=compute_dtype(cfg), device=device),
        "h": torch.zeros(
            (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=torch.float32, device=device),
    }


def _split_proj(zxbcdt, cfg: ModelConfig):
    inner, _ = _dims(cfg)
    N = cfg.ssm_state
    z = zxbcdt[..., :inner]
    xBC = zxbcdt[..., inner: 2 * inner + 2 * N]
    dt_raw = zxbcdt[..., 2 * inner + 2 * N:]
    return z, xBC, dt_raw


def _causal_conv(xBC, params, cfg: ModelConfig, tail):
    """Depthwise causal conv over (B, T, conv_dim); ``tail`` is the cached
    last (K-1) inputs for decode continuity. Returns (y, new_tail)."""
    K = cfg.conv_kernel
    w = params.conv_w.float()  # (K, C)
    if tail is None:
        tail = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[-1]))
    xfull = torch.cat([tail.to(xBC.dtype), xBC], dim=1)  # (B, K-1+T, C)
    T = xBC.shape[1]
    y = sum(xfull[:, k: k + T].float() * w[k] for k in range(K))
    y = y + params.conv_b
    new_tail = xfull[:, -(K - 1):]
    return F.silu(y).to(xBC.dtype), new_tail


def _gated_norm(y, z, norm_w, eps):
    """Mamba2's RMSNorm(y * silu(z)) output gate (computed in f32)."""
    g = y.float() * F.silu(z.float())
    ms = g.square().mean(-1, keepdim=True)
    return (g / torch.sqrt(ms + eps)) * norm_w


def _kernel_ready(x: torch.Tensor) -> bool:
    """A CUDA tensor and a kernel library that builds: the route the
    reference takes on a TPU. On the card, a library that fails to build
    raises its own error here."""
    if not x.is_cuda:
        return False
    from repro_torch.kernels.scan_engine import cuda
    cuda.build()
    return True


def apply_ssm(
    params,
    x,
    cfg: ModelConfig,
    *,
    cache: Optional[dict] = None,
    impl: str = "auto",
):
    """Mamba2 over (B, T, D) -> (y, new_cache).

    Training / prefill: ``cache=None`` (or a prior state to continue from),
    chunked SSD path. Decode: ``T == 1`` recurrent update. ``impl``:
    "auto" (the kernel for a CUDA tensor's serve path, else chunked),
    "kernel" or "chunked".
    """
    if impl == "auto":
        serve = cache is not None and _kernel_ready(x)
        impl = "kernel" if serve else "chunked"
    B, T, D = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    inner, _ = _dims(cfg)

    zxbcdt = x @ params.in_proj
    z, xBC, dt_raw = _split_proj(zxbcdt, cfg)
    xBC, new_tail = _causal_conv(
        xBC, params, cfg, None if cache is None else cache["conv"])
    xs = xBC[..., :inner].reshape(B, T, H, P)
    Bm = xBC[..., inner: inner + N]          # (B, T, N) one state group
    Cm = xBC[..., inner + N:]                # (B, T, N)
    dt = softplus(dt_raw.float() + params.dt_bias)   # (B, T, H)
    a = -torch.exp(params.a_log)             # (H,) negative decay rates
    da = dt * a                              # (B, T, H) log decay <= 0

    h_prev = None if cache is None else cache["h"]
    if T == 1 and cache is not None:
        y, h_new = _ssm_step(xs, Bm, Cm, dt, da, h_prev)
    else:
        y, h_new = _ssd_chunked(xs, Bm, Cm, dt, da, cfg.ssm_chunk, h_prev,
                                impl)

    y = y + params.d_skip[:, None] * xs.float()   # (B, T, H, P) skip
    y = y.reshape(B, T, inner)
    y = _gated_norm(y, z, params.norm_w, cfg.norm_eps)
    y = shard(y.to(x.dtype), "batch", "seq", "ssm_inner")
    out = shard(y @ params.out_proj, "batch", "seq", "embed")
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_tail, "h": h_new}
    return out, new_cache


def _ssm_step(xs, Bm, Cm, dt, da, h_prev):
    """One-token recurrent update. h: (B, H, P, N)."""
    B, _, H, P = xs.shape
    N = Bm.shape[-1]
    if h_prev is None:
        h_prev = xs.new_zeros((B, H, P, N), dtype=torch.float32)
    decay = torch.exp(da[:, 0])[:, :, None, None]             # (B,H,1,1)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bm[:, 0].float(),
                       xs[:, 0].float())
    h = decay * h_prev + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h)
    return y[:, None], h                                       # (B,1,H,P)


def _ssd_chunked(xs, Bm, Cm, dt, da, chunk, h_prev, impl):
    """Chunked SSD: intra-chunk quadratic + inter-chunk affine scan."""
    B, T, H, P = xs.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bm, Cm, dt, da = (F.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm, dt, da))
    Tp = T + pad
    nc = Tp // Q

    xs = xs.reshape(B, nc, Q, H, P).float()
    Bc = Bm.reshape(B, nc, Q, N).float()
    Cc = Cm.reshape(B, nc, Q, N).float()
    dtc = dt.reshape(B, nc, Q, H)
    dac = da.reshape(B, nc, Q, H)

    # (1) WITHIN-chunk prefix sum of log-decays — the paper's primitive.
    A = scanlib.cumsum(dac, axis=2, algorithm="ref")  # (B,nc,Q,H) inclusive
    A_tot = A[:, :, -1]                               # (B,nc,H)

    # Intra-chunk (causal masked) contribution, L[i,j] = exp(A_i - A_j).
    # The mask goes on before the exp (the reference's after it): above the
    # diagonal A_i - A_j is a sum of decay magnitudes, whose exp overflows
    # past 88 and then gives a NaN gradient (inf x 0); exp(-inf) = 0 gives
    # the same forward bits.
    rel = A[:, :, :, None, :] - A[:, :, None, :, :]   # (B,nc,Q,Q,H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xs.device).tril()
    L = torch.exp(torch.where(causal[None, None, :, :, None], rel,
                              float("-inf")))
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)      # (B,nc,Q,Q)
    W = CB[..., None] * L * dtc[:, :, None, :, :]     # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, xs)

    # (2) ACROSS-chunk carry — chunk totals + affine scan (paper Fig. 1b:
    # accumulate-first). S_c = sum_j exp(A_tot - A_j) dt_j B_j (x) x_j.
    decay_out = torch.exp(A_tot[:, :, None] - A)      # (B,nc,Q,H)
    S = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_out * dtc, Bc, xs)
    a_chunk = torch.exp(A_tot)                        # (B,nc,H)
    if impl == "kernel":
        from repro_torch.kernels.ssm_scan import ops as kops
        flatS = S.reshape(B, nc, H * P * N)
        flata = a_chunk[..., None, None].expand(S.shape).reshape(
            B, nc, H * P * N)
        states = kops.ssm_scan(flata, flatS).reshape(S.shape)
    else:
        ab = a_chunk[..., None, None].expand(S.shape)
        _, states = scanlib.scan((ab, S), op="affine", axis=1,
                                 algorithm="ref")     # inclusive over chunks
    # Fold a non-zero entering state through every chunk's inclusive state
    # (affine identity: states_c += (prod_{c'<=c} a_c') · h_prev).
    if h_prev is None:
        h_prev = xs.new_zeros((B, H, P, N))
    cumdecay = torch.cumprod(a_chunk, dim=1)          # (B,nc,H)
    states = states + cumdecay[..., None, None] * h_prev[:, None]
    # Exclusive prefix: the state ENTERING each chunk.
    h_in = torch.cat([h_prev[:, None], states[:, :-1]], dim=1)

    # (3) Pass 2: combine exclusive carry into chunk outputs.
    decay_in = torch.exp(A)                           # (B,nc,Q,H)
    # (the reference scales h_in by decay_in before contracting over N;
    # scaling after leaves out a (B, nc, Q, H, P, N) intermediate)
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, h_in) * \
        decay_in[..., None]
    y = (y_intra + y_inter).reshape(B, Tp, H, P)[:, :T]
    return y, states[:, -1]
