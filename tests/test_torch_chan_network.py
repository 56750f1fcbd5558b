"""``tile_scan_chan_warps``: the affine pair's Channels network as the
CUDA register carry organizes it.

``carry_chan_reg_kernel`` (``csrc/scan_sum.cu``) runs ``tile_scan`` on
``Channels`` tiles of 128, 256 and 512 time steps in registers: a warp
holds a few adjacent channels, lane l their steps l + 32 s; Hillis–Steele
steps below 32 take step i − k from lane l − k by a shuffle (from the
slot below for l < k, the identity in slot 0), steps 32 m come from slot
s − m of the same lane. ``schedules.tile_scan_chan_warps`` states that
organization in torch ops. It must be bitwise equal to the port's
``tile_scan`` along time (and its exclusive shift) and to the
reference's, signed zeros included: the identity combine (1, 0) ⊕ (a, b)
= (a, a·0 + b) is done, and turns b = −0.0 into +0.0 where a ≥ 0. The
reference runs op by op, not under ``jax.jit`` (XLA folds 0.0 + x into x
and contracts the affine combine into an FMA there), on exact-valued
data. The kernel itself is held against ``carry_plain`` on the card in
``tests/test_torch_cuda_kernels.py``; which network each wrapper
launches is chosen by shape in ``cuda.tile_network``, tested here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_totals_data import same_bits
from repro.kernels.scan_engine import monoids as jax_monoids
from repro.kernels.scan_engine import schedules as jax_schedules
from repro_torch.kernels import scan_engine
from repro_torch.kernels.scan_engine import cuda, monoids, schedules

AFFINE = monoids.AFFINE
TILES = (8, 32, 64, 256, 512)


def _operands(bt, seed, exact=False, shape=None):
    """Affine (a, b) of (B, T, D) = (2, 2 bt, 6): gates with negative
    values, ±0.0 and ±1, offsets with −0.0 at every tile start and
    scattered; ``exact``: every value (and every product and sum of the
    scan) exact in float32 — gates ±1, ±0.0 and a few halves, offsets
    small integers."""
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


def _tiles(ops, bt):
    lay = scan_engine.Channels(*ops[0].shape, bt, ops[0].shape[2])
    return lay, schedules._tiles(AFFINE, ops, lay)


def _all_same(got, want):
    return len(got) == len(want) and all(same_bits(g, w)
                                         for g, w in zip(got, want))


@pytest.mark.parametrize("exact", (False, True), ids=("normal", "exact"))
@pytest.mark.parametrize("bt", TILES)
def test_tile_scan_chan_warps_bitwise_vs_tile_scan(bt, exact):
    _, tiles = _tiles(_operands(bt, bt, exact), bt)
    want = schedules.tile_scan(AFFINE, tiles, 2)
    assert _all_same(schedules.tile_scan_chan_warps(AFFINE, tiles), want)
    assert _all_same(schedules.tile_scan_chan_warps(AFFINE, tiles, True),
                     schedules.shift_one(AFFINE, want, 2))


@pytest.mark.parametrize("bt", TILES)
def test_tile_scan_chan_warps_bitwise_vs_reference(bt):
    """The reference's ``tile_scan`` along the time axis (axis 2 of the
    (B, chunks, bt, D) tiles, never the lane axis), op by op, on exact
    data: the emulation and the port's ``tile_scan`` give its bits, the
    +0.0 of the identity combine included."""
    _, tiles = _tiles(_operands(bt, bt + 1, exact=True), bt)
    want = jax_schedules.tile_scan(
        jax_monoids.AFFINE, tuple(jnp.asarray(t.numpy()) for t in tiles),
        axis=2)
    want = tuple(torch.from_numpy(np.array(w)) for w in want)
    assert _all_same(schedules.tile_scan_chan_warps(AFFINE, tiles), want)
    assert _all_same(schedules.tile_scan(AFFINE, tiles, 2), want)
    # the identity combine did turn a leading -0.0 into +0.0 somewhere
    b0 = tiles[1][:, :, 0]
    assert bool(torch.signbit(b0).any())
    assert not bool(torch.signbit(want[1][:, :, 0][tiles[0][:, :, 0] > 0])
                    .any())


@pytest.mark.parametrize("exclusive", (False, True))
@pytest.mark.parametrize("bt", (32, 128, 256, 512))
def test_chan_network_gives_carry_plain(bt, exclusive):
    """The emulation's network put through carry's running carry (the
    carry the LEFT operand, carry = carry ⊕ last) and emission gives
    ``carry_plain``'s outputs and running totals, and decoupled's and
    fused's plain versions agree."""
    ops = _operands(bt, 3 * bt, shape=(2, 3 * bt, 8))
    lay, tiles = _tiles(ops, bt)
    scanned = schedules.tile_scan_chan_warps(AFFINE, tiles)
    sel = (schedules.tile_scan_chan_warps(AFFINE, tiles, True) if exclusive
           else scanned)
    lasts = schedules._last(scanned)
    carries = schedules.exclusive_chain(AFFINE, lasts)
    got = schedules._emit(AFFINE, ops, lay, tiles,
                          schedules._offset(AFFINE, carries, sel))
    running = AFFINE.combine(carries, lasts)
    want, w_run = schedules.carry_plain(ops, AFFINE, lay, exclusive, True)
    assert _all_same(got, want) and _all_same(running, w_run)
    for s in ("decoupled", "fused"):
        assert _all_same(schedules.PLAIN[s](ops, AFFINE, lay, exclusive),
                         want), s


CHANNEL_NETWORKS = [
    # (name, layout, the carry's network)
    ("bt128-w32", scan_engine.Channels(1, 512, 64, 128, 64), "register"),
    ("bt256-w16", scan_engine.Channels(1, 1024, 458752, 256, 512),
     "register"),
    ("bt512-w8", scan_engine.Channels(2, 1024, 24, 512, 24), "register"),
    ("bt256-w4", scan_engine.Channels(1, 512, 4, 256, 4), "register"),
    ("bt64", scan_engine.Channels(1, 512, 64, 64, 64), "shared"),
    ("bt1024", scan_engine.Channels(1, 2048, 64, 1024, 64), "shared"),
    ("bt256-w2", scan_engine.Channels(1, 512, 2, 256, 2), "shared"),
    ("bt256-w1", scan_engine.Channels(1, 512, 7, 256, 7), "shared"),
]


@pytest.mark.parametrize("name,layout,network", CHANNEL_NETWORKS,
                         ids=[c[0] for c in CHANNEL_NETWORKS])
def test_tile_network_affine_channels(name, layout, network):
    """The affine carry on Channels takes the register network at 128,
    256 and 512 steps over strips of a multiple of four channels; apply,
    fused and tree keep the shared network, and so does the sum on
    Channels."""
    assert cuda.tile_network(AFFINE, layout, "carry") == network
    for kernel in ("apply", "fused", "tree"):
        assert cuda.tile_network(AFFINE, layout, kernel) == "shared"
        assert cuda.tile_network(monoids.SUM, layout, kernel) == "shared"
    assert cuda.tile_network(monoids.SUM, layout, "carry") == "shared"


def test_tile_network_refuses_other_kernels():
    with pytest.raises(ValueError, match="no tile network"):
        cuda.tile_network(AFFINE, CHANNEL_NETWORKS[0][1], "totals")


@pytest.mark.parametrize("network", (None, "register", "shared"))
@pytest.mark.parametrize("name,layout,_", CHANNEL_NETWORKS[:4],
                         ids=[c[0] for c in CHANNEL_NETWORKS[:4]])
def test_carry_launches_the_network(monkeypatch, name, layout, _, network):
    """``cuda.carry`` passes the kernel ``tile_network``'s choice, or the
    network it is asked for (to time the two at one shape), and totals,
    the chain, apply, fused and tree of the affine pair pass theirs; the
    launch is intercepted, so this runs on CPU tensors."""
    nets = []
    monkeypatch.setattr(cuda, "_on_cuda", lambda t: None)
    lib = type("Lib", (), {f"scan_{k}": None for k in cuda.KERNELS})
    monkeypatch.setattr(cuda, "build", lambda: lib)
    monkeypatch.setattr(cuda, "_launch",
                        lambda spec_, k, fn, device, *args: nets.append(
                            (k, args[-1])))
    small = scan_engine.Channels(1, 2 * layout.bt, layout.d % 64 or 64,
                                 layout.bt, layout.d % 64 or 64)
    x = torch.ones(small.shape)
    cuda.carry(AFFINE, (x, x), small, network=network)
    want = network or cuda.tile_network(AFFINE, small, "carry")
    assert want == "register" or network == "shared"
    offs = cuda._new_leaves(AFFINE, x, x, small.chain_shape)
    cuda.apply(AFFINE, (x, x), offs, small)
    cuda.fused(AFFINE, (x, x), small)
    cuda.tree(AFFINE, (x, x), small)
    assert nets == [("carry", int(want == "register")), ("apply", 0),
                    ("fused", 0), ("tree", 0)]
    with pytest.raises(ValueError, match="unknown tile network"):
        cuda.carry(AFFINE, (x, x), small, network="warp")
