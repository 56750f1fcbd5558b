"""Adversarial operands for the chunk-totals tests (numpy, from a seed).

Shared by ``test_torch_totals_tree.py`` (the plain tree against the
plain network and the JAX reference, on the CPU),
``test_torch_chan_network.py`` (the affine pair on ``Channels``) and
``test_torch_cuda_kernels.py`` (``totals_reduce_kernel`` on the card).
"""

import numpy as np
import torch

# The block sizes the totals tests sweep: single elements, runs shorter
# and longer than a 128-lane segment, lane-divisible tiles (the two-level
# network) and the largest tile the kernels take.
BLOCKS = (1, 2, 3, 5, 64, 127, 128, 129, 200, 256, 384, 640, 2048, 2176,
          16384)
# The operand kinds: the sum in six dtypes, and the compact mask.
KINDS = ("float32", "bfloat16", "float16", "int32", "int16", "int8", "mask")
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int32": torch.int32,
                "int16": torch.int16, "int8": torch.int8,
                "mask": torch.int32}


def operands(kind, rows, n, bn, seed):
    """A (rows, n) torch tensor of ``kind`` tiled by ``bn``. Floats: normal
    values, a signed zero at every tile start (alternating -0.0 / +0.0),
    the first tile all -0.0, subnormals (one tile of nothing else), large
    values that cancel, +inf in one tile, ±inf in another and a NaN in a
    third. Integers span their dtype (int32 sums wrap); the mask is mostly
    0 / 1 with a few extreme int32 values."""
    rng = np.random.default_rng(seed)
    if kind == "mask":
        x = rng.integers(0, 2, (rows, n)).astype(np.int32)
        hot = rng.random((rows, n)) < 0.01
        x[hot] = rng.choice([2 ** 31 - 1, -2 ** 31, -5], hot.sum())
        return torch.from_numpy(x)
    dtype = TORCH_DTYPES[kind]
    if not dtype.is_floating_point:
        info = np.iinfo(kind)
        return torch.from_numpy(
            rng.integers(info.min, info.max + 1, (rows, n)).astype(kind))
    big, tiny = (3.0e4, 1.0e-6) if kind == "float16" else (1.0e30, 1.0e-40)
    x = rng.standard_normal((rows, n)).astype(np.float32) * 4
    sub = rng.random((rows, n)) < 0.05
    x[sub] = tiny * rng.standard_normal(sub.sum())
    pairs = np.nonzero(rng.random((rows, n - 1)) < 0.02)
    x[pairs] = big
    x[pairs[0], pairs[1] + 1] = -big
    starts = np.arange(0, n, bn)
    x[:, starts] = np.where(np.arange(starts.size) % 2 == 0, -0.0, 0.0)
    x[0, :bn] = -0.0
    tiles = n // bn
    if rows > 1 and tiles > 2:
        x[1, bn:2 * bn] = tiny * rng.standard_normal(bn)
        x[1, rng.integers(bn)] = np.inf
        x[1, 2 * bn + rng.integers(bn)] = -np.inf
        x[1, 2 * bn + rng.integers(bn)] = np.inf
        x[0, (tiles - 1) * bn + rng.integers(bn)] = np.nan
    return torch.from_numpy(x).to(dtype)


def affine_channels(bt, seed, exact=False, shape=None):
    """Affine (a, b) of (B, T, D) = (2, 2 bt, 6) (or ``shape``): gates
    with negative values, ±0.0 and ±1, offsets with −0.0 at every tile
    start and scattered; ``exact``: every value (and every product and sum
    of the scan) exact in float32 — gates ±1, ±0.0 and a few halves,
    offsets small integers."""
    rng = np.random.default_rng(seed)
    shape = shape or (2, 2 * bt, 6)
    if exact:
        a = rng.choice(np.float32([1, -1, 1, 1, 0.5, -0.0, 0.0]), shape,
                       p=[0.45, 0.3, 0.1, 0.1, 0.01, 0.02, 0.02])
        b = rng.integers(-3, 4, shape).astype(np.float32)
    else:
        a = rng.uniform(0.5, 1.0, shape).astype(np.float32)
        a[rng.random(shape) < 0.1] *= -1
        a[rng.random(shape) < 0.02] = 1.0
        a[rng.random(shape) < 0.02] = -0.0
        b = rng.standard_normal(shape).astype(np.float32)
    b[rng.random(shape) < 0.1] = -0.0
    b[:, ::bt] = -0.0
    return torch.from_numpy(a), torch.from_numpy(b)


def same_bits(a, b):
    """Bitwise equality of two tensors, any NaN equal to any NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = a[~nan], b[~nan]
        view = {4: torch.int32, 2: torch.int16}[a.element_size()]
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)
