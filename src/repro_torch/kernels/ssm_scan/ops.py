"""Affine (SSM-recurrence) scan: the affine registration of the engine.

The PyTorch counterpart of the reference's ``kernels/ssm_scan/ops.py``.
Computes ``h_t = a_t * h_{t-1} + b_t`` along the time axis of (B, T, D)
inputs — the inclusive scan of ``core/scan/assoc.AFFINE_KERNEL`` run
through the engine on the ``Channels`` layout: through the CUDA kernels
for CUDA tensors, through their plain versions for CPU tensors.

Pads T to a block multiple with the identity element (a=1, b=0), which
keeps the carried state unchanged, so results are exact after the slice,
and pads the channels the same way. ``schedule`` picks the grid
organization (see ``core/scan/policy``): carry walks time sequentially
per (batch, channel block) stripe; decoupled/fused spread time chunks
across the SMs — the B=1 long-context shape; tree runs the Blelloch
sweep inside each time tile. Channel blocks count as batch for the
policy rule.

Differentiable: the adjoint of the recurrence is itself an affine
recurrence run backward, ``λ_t = g_t + a_{t+1} · λ_{t+1}``; after
flipping time it is the same scan with the gates flipped and rolled one
step, so the backward is one more engine scan under the same schedule,
and ``db_t = λ_t``, ``da_t = λ_t · h_{t-1}``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.scan import policy
from repro_torch.kernels import scan_engine
from repro_torch.kernels.scan_engine import monoids, resolve_schedule


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _blocks(shape, block_t, block_d):
    _, T, D = shape
    return min(block_t, _round_up(T, 8)), min(block_d, _round_up(D, 128))


def _impl(a, b, block_t, block_d, schedule):
    B, T, D = a.shape
    bt, bd = _blocks(a.shape, block_t, block_d)
    pad_t = (-T) % bt
    pad_d = (-D) % bd
    if pad_t or pad_d:
        a = F.pad(a, (0, pad_d, 0, pad_t), value=1)
        b = F.pad(b, (0, pad_d, 0, pad_t))
    layout = scan_engine.Channels(B, T + pad_t, D + pad_d, bt, bd)
    out, = scan_engine.scan((a.contiguous(), b.contiguous()), monoids.AFFINE,
                            layout, schedule=schedule)
    return out[:, :T, :D]


def resolved_schedule(shape, block_t: int = 256, block_d: int = 512,
                      schedule: str = "auto",
                      cores: int = policy.NUM_CORES) -> str:
    """The schedule a (B, T, D) affine scan will actually run.

    Mirrors ``ssm_scan``'s tiling: the carry grid already parallelizes
    (B, D-blocks) stripes, so the policy's "batch" is the number of
    independent carry chains and its chunk length is the real time
    block. ``cores``: the SMs (or CPU cores) a launch spreads over.
    """
    B, T, D = shape
    bt, bd = _blocks(shape, block_t, block_d)
    batch = B * max(-(-D // bd), 1)
    return resolve_schedule(schedule, batch, T, bt, cores)


class _SSMScan(torch.autograd.Function):
    """The backward is one more engine scan: the flipped cotangent
    through the flipped gates rolled one step."""

    @staticmethod
    def forward(ctx, a, b, block_t, block_d, schedule):
        h = _impl(a, b, block_t, block_d, schedule)
        # residuals: the gates (the backward's coefficients) and the
        # forward states (da needs h_{t-1})
        ctx.save_for_backward(a, h)
        ctx.statics = (block_t, block_d, schedule)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        block_t, block_d, schedule = ctx.statics
        # λ'_k = gate'_k · λ'_{k-1} + g'_k with gate' = flip(a) rolled one
        # step right; the zero fill multiplies λ'_{-1} = 0.
        gate = torch.cat([torch.zeros_like(a[:, :1]),
                          torch.flip(a, (1,))[:, :-1]], dim=1)
        lam = torch.flip(_impl(gate, torch.flip(g, (1,)), block_t, block_d,
                               schedule), (1,))
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        da = (lam * h_prev).to(a.dtype)
        return da, lam.to(g.dtype), None, None, None


def ssm_scan(a: torch.Tensor, b: torch.Tensor, block_t: int = 256,
             block_d: int = 512, schedule: str = "auto") -> torch.Tensor:
    """Kernel-backed h_t = a_t ⊙ h_{t-1} + b_t over (B, T, D), on the
    inputs' device.

    ``schedule`` picks the organization (carry|decoupled|fused|tree|auto).
    Differentiable: the backward runs as another engine affine scan.
    """
    if a.numel() == 0:
        # T, B or D == 0: the recurrence over nothing is nothing, and the
        # block rounding cannot tile an empty axis.
        return b
    schedule = resolved_schedule(a.shape, block_t, block_d, schedule,
                                 policy.cores_of(a))
    return _SSMScan.apply(a, b, block_t, block_d, schedule)


# ---------------------------------------------------------------------------
# Back-compat kernel entry points (3D, pre-padded)
# ---------------------------------------------------------------------------


def _ssm_3d(a, b, block_t, block_d, schedule):
    if a.shape != b.shape or a.dim() != 3:
        raise ValueError(f"expect matching (B, T, D) inputs, got "
                         f"{tuple(a.shape)} {tuple(b.shape)}")
    B, T, D = a.shape
    layout = scan_engine.Channels(B, T, D, block_t, block_d)
    out, = scan_engine.scan((a.contiguous(), b.contiguous()), monoids.AFFINE,
                            layout, schedule=schedule)
    return out


def ssm_scan_kernel(a, b, *, block_t=256, block_d=512):
    """Carry-schedule affine scan of pre-padded (B, T, D) inputs."""
    return _ssm_3d(a, b, block_t, block_d, "carry")


def ssm_scan_decoupled(a, b, *, block_t=256, block_d=512):
    """Decoupled-schedule affine scan of pre-padded (B, T, D) inputs."""
    return _ssm_3d(a, b, block_t, block_d, "decoupled")
