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
data. ``fused_chan_reg_kernel`` runs the same network on one tile a
block and takes each tile's offset by a look-back: the tile folds, left
to right, the nearest published inclusive prefix and the aggregates after
it; that organization in torch ops must give ``fused_plain``'s,
``carry_plain``'s and the reference's bits whichever prefix the look-back
finds. ``apply_chan_reg_kernel`` runs the same network with the chain's
offset of each tile on the left, the chain folded over the totals that
``totals_chan_reduce_kernel`` builds as each channel's balanced tree
(``totals_tree_plain``); that organization must give ``apply_plain``'s,
``carry_plain``'s and the reference's decoupled bits. The kernels
themselves are held against the plain versions on the card in
``tests/test_torch_cuda_kernels.py``; which network each wrapper launches
is chosen by shape in ``cuda.tile_network``, tested here.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_totals_data import affine_channels, same_bits
from repro.kernels.scan_engine import monoids as jax_monoids
from repro.kernels.scan_engine import schedules as jax_schedules
from repro_torch.kernels import scan_engine
from repro_torch.kernels.scan_engine import cuda, monoids, schedules

AFFINE = monoids.AFFINE
TILES = (8, 32, 64, 256, 512)


# Affine (a, b) on Channels from a seed (gates with negative values and
# ±0.0, offsets with −0.0 at every tile start; exact-valued on request).
_operands = affine_channels


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
    """The affine carry, apply, fused and tree on Channels take the
    register network at 128, 256 and 512 steps over strips of a multiple
    of four channels, and the shared one elsewhere; the affine totals take
    the reduction (``"register"``) at those tiles whatever the strip,
    since it does not run in strips; the sum on Channels keeps the shared
    network, its totals included."""
    for kernel in ("carry", "apply", "fused", "tree"):
        assert cuda.tile_network(AFFINE, layout, kernel) == network
    reduced = layout.bt in cuda.CHAN_REG_TILES
    assert cuda.tile_network(AFFINE, layout, "totals") == (
        "register" if reduced else "shared")
    for kernel in ("carry", "totals", "apply", "fused", "tree"):
        assert cuda.tile_network(monoids.SUM, layout, kernel) == "shared"


@pytest.mark.parametrize("layout", [
    scan_engine.Channels(1, 32, 458752, 32, 512),   # a 4096-token prefill
    scan_engine.Channels(2, 96, 48, 32, 48),
    scan_engine.Channels(1, 64, 4, 32, 4)], ids=("ssd", "w16", "w4"))
def test_tile_network_carry_alone_at_bt32(layout):
    """Tiles of 32 steps: the affine carry takes the register network
    (``CHAN_CARRY_TILES``: a thread a channel), while apply, fused, tree
    and the totals keep the shared network (``CHAN_REG_TILES`` stays 128,
    256 and 512); at 64 steps the carry is shared too; strips of two
    channels keep the shared carry, as at the other tiles."""
    assert 32 in cuda.CHAN_CARRY_TILES and 32 not in cuda.CHAN_REG_TILES
    assert cuda.tile_network(AFFINE, layout, "carry") == "register"
    for kernel in ("apply", "fused", "tree", "totals"):
        assert cuda.tile_network(AFFINE, layout, kernel) == "shared"
    for other in (dataclasses.replace(layout, t=2 * layout.t, bt=64),
                  scan_engine.Channels(1, 64, 6, 32, 6)):
        assert cuda.tile_network(AFFINE, other, "carry") == "shared"


def test_wrappers_launch_the_networks_at_bt32(monkeypatch):
    """At tiles of 32 steps ``cuda.carry`` passes its kernel the register
    network and apply, fused and tree the shared one (the launch
    intercepted, so this runs on CPU tensors)."""
    nets = []
    monkeypatch.setattr(cuda, "_on_cuda", lambda t: None)
    lib = type("Lib", (), {f"scan_{k}": None for k in cuda.KERNELS})
    monkeypatch.setattr(cuda, "build", lambda: lib)
    monkeypatch.setattr(cuda, "_launch",
                        lambda spec_, k, fn, device, *args: nets.append(
                            (k, args[-1])))
    small = scan_engine.Channels(1, 64, 64, 32, 64)
    x = torch.ones(small.shape)
    cuda.carry(AFFINE, (x, x), small)
    offs = cuda._new_leaves(AFFINE, x, x, small.chain_shape)
    cuda.apply(AFFINE, (x, x), offs, small)
    cuda.fused(AFFINE, (x, x), small)
    cuda.tree(AFFINE, (x, x), small)
    assert nets == [("carry", 1), ("apply", 0), ("fused", 0), ("tree", 0)]


SHORT_TILES = (8, 16, 24)


@pytest.mark.parametrize("layout", [
    (1, 458752, 512),   # the SSD carry's width, 16-channel strips
    (2, 48, 48),
    (1, 4, 4)], ids=("ssd", "w16", "w4"))
@pytest.mark.parametrize("bt", SHORT_TILES)
def test_tile_network_carry_alone_at_short_tiles(bt, layout):
    """Tiles of 8, 16 and 24 steps (the SSD carry of a 1024-token training
    row and of a 2500-token prefill, 24 chunks after ``ssm_scan`` rounds
    20 up to 8) take the register carry as 32 does (``CHAN_CARRY_TILES``:
    a thread a channel), while apply, fused, tree and the totals keep the
    shared network; tiles of 40 steps, and strips of two channels, keep
    the shared carry."""
    b, d, width = layout
    lay = scan_engine.Channels(b, 3 * bt, d, bt, width)
    assert bt in cuda.CHAN_CARRY_TILES and bt not in cuda.CHAN_REG_TILES
    assert cuda.tile_network(AFFINE, lay, "carry") == "register"
    for kernel in ("apply", "fused", "tree", "totals"):
        assert cuda.tile_network(AFFINE, lay, kernel) == "shared"
    for other in (scan_engine.Channels(b, 120, d, 40, width),
                  scan_engine.Channels(1, 3 * bt, 6, bt, 6)):
        assert cuda.tile_network(AFFINE, other, "carry") == "shared"


@pytest.mark.parametrize("bt", SHORT_TILES)
def test_wrappers_launch_the_networks_at_short_tiles(monkeypatch, bt):
    """At tiles of 8, 16 and 24 steps ``cuda.carry`` passes its kernel the
    register network and apply, fused and tree the shared one (the launch
    intercepted, so this runs on CPU tensors), with the tile's steps as
    the block the C interface gets."""
    nets = []
    monkeypatch.setattr(cuda, "_on_cuda", lambda t: None)
    lib = type("Lib", (), {f"scan_{k}": None for k in cuda.KERNELS})
    monkeypatch.setattr(cuda, "build", lambda: lib)
    monkeypatch.setattr(cuda, "_launch",
                        lambda spec_, k, fn, device, *args: nets.append(
                            (k, args[-1], args[-4])))
    small = scan_engine.Channels(1, 2 * bt, 64, bt, 64)
    x = torch.ones(small.shape)
    cuda.carry(AFFINE, (x, x), small)
    offs = cuda._new_leaves(AFFINE, x, x, small.chain_shape)
    cuda.apply(AFFINE, (x, x), offs, small)
    cuda.fused(AFFINE, (x, x), small)
    cuda.tree(AFFINE, (x, x), small)
    assert [(k, net) for k, net, _ in nets] == [
        ("carry", 1), ("apply", 0), ("fused", 0), ("tree", 0)]
    assert nets[0][2] == bt


def _thread_a_channel_carry(ops, bt, exclusive):
    """``carry_chan_reg_kernel`` at NS = 1 in torch ops: each channel's
    tile of ``bt`` steps in a thread's registers, round k (1, 2, 4, ...
    below bt) x[i] = x[i - k] (+) x[i] from the top, the identity on the
    left below k; the emission combine(carry, x[i]) (exclusive: x[i - 1],
    the identity at i = 0); carry = carry (+) x[bt - 1] after each tile,
    from the identity, stored as the tile's running total."""
    a, b = ops
    B, T, D = a.shape
    one, zero = torch.ones(B, D), torch.zeros(B, D)
    carry, outs, running = (one, zero), ([], []), ([], [])
    for j in range(T // bt):
        x = [(a[:, j * bt + i], b[:, j * bt + i]) for i in range(bt)]
        k = 1
        while k < bt:
            for i in range(bt - 1, -1, -1):
                x[i] = AFFINE.combine(x[i - k] if i >= k else (one, zero),
                                      x[i])
            k *= 2
        for i in range(bt):
            sel = (x[i - 1] if i > 0 else (one, zero)) if exclusive else x[i]
            for o, v in zip(outs, AFFINE.combine(carry, sel)):
                o.append(v)
        carry = AFFINE.combine(carry, x[bt - 1])
        for r, v in zip(running, carry):
            r.append(v)
    return ((torch.stack(outs[1], 1),),    # the output: the offset leaf
            tuple(torch.stack(r, 1) for r in running))


@pytest.mark.parametrize("exact", (False, True), ids=("normal", "exact"))
@pytest.mark.parametrize("exclusive", (False, True))
@pytest.mark.parametrize("bt", SHORT_TILES + (32,))
def test_thread_a_channel_carry_gives_carry_plain(bt, exclusive, exact):
    """The register carry's organization at tiles of 8 to 32 steps (a
    thread a channel) gives ``carry_plain``'s outputs and running totals
    bit for bit, signed zeros included (-0.0 at every tile start, the
    identity combine's +0.0), inclusive and exclusive; the kernel itself
    is held so on the card (``tests/test_torch_cuda_kernels.py -k
    carry_channels_short``)."""
    ops = _operands(bt, 3 * bt + 1, exact, shape=(2, 3 * bt, 8))
    lay = scan_engine.Channels(2, 3 * bt, 8, bt, 8)
    got, run = _thread_a_channel_carry(ops, bt, exclusive)
    want, w_run = schedules.carry_plain(ops, AFFINE, lay, exclusive, True)
    assert _all_same(got, want) and _all_same(run, w_run)
    assert bool(torch.signbit(ops[1][:, ::bt]).all())


def test_tile_network_refuses_other_kernels():
    with pytest.raises(ValueError, match="no tile network"):
        cuda.tile_network(AFFINE, CHANNEL_NETWORKS[0][1], "chain")


@pytest.mark.parametrize("network", (None, "register", "shared"))
@pytest.mark.parametrize("name,layout,_", CHANNEL_NETWORKS[:4],
                         ids=[c[0] for c in CHANNEL_NETWORKS[:4]])
def test_carry_launches_the_network(monkeypatch, name, layout, _, network):
    """``cuda.carry`` passes the kernel ``tile_network``'s choice, or the
    network it is asked for (to time the two at one shape), and apply,
    fused and tree of the affine pair pass theirs (the register network,
    as carry); the launch is intercepted, so this runs on CPU tensors."""
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
    assert nets == [("carry", int(want == "register")), ("apply", 1),
                    ("fused", 1), ("tree", 1)]
    with pytest.raises(ValueError, match="unknown tile network"):
        cuda.carry(AFFINE, (x, x), small, network="warp")


@pytest.mark.parametrize("network", (None, "register", "shared"))
@pytest.mark.parametrize("name,layout,_", CHANNEL_NETWORKS[:4],
                         ids=[c[0] for c in CHANNEL_NETWORKS[:4]])
def test_fused_launches_the_network(monkeypatch, name, layout, _, network):
    """``cuda.fused`` passes the kernel the network ``tile_network``
    chooses, or the one it is asked for, with that network's strip width
    (``chan_reg_width`` for the register fused, ``channel_width`` for the
    shared one) and one state word per tile of those strips; the launch
    is intercepted, so this runs on CPU tensors."""
    seen = []
    monkeypatch.setattr(cuda, "_on_cuda", lambda t: None)
    lib = type("Lib", (), {f"scan_{k}": None for k in cuda.KERNELS})
    monkeypatch.setattr(cuda, "build", lambda: lib)
    monkeypatch.setattr(cuda, "_launch",
                        lambda spec_, k, fn, device, *args: seen.append(
                            (k, args)))
    zeros = torch.zeros
    states = []

    def counted_zeros(*shape, **kw):
        z = zeros(*shape, **kw)
        states.append(z.numel())
        return z

    monkeypatch.setattr(torch, "zeros", counted_zeros)
    d = layout.d % 64 or 64
    small = scan_engine.Channels(1, 4 * layout.bt, d, layout.bt, d)
    x = torch.ones(small.shape)
    cuda.fused(AFFINE, (x, x), small, network=network)
    want = network or cuda.tile_network(AFFINE, small, "fused")
    assert want == "register" or network == "shared"
    width = (cuda.chan_reg_width(small) if want == "register"
             else cuda.channel_width(small))
    ((kernel, args),) = seen
    assert kernel == "fused"
    # (..., b, n, d, width, bn, exclusive, sentinel, net)
    assert args[-8:-3] == (1, 4 * small.bt, d, width, small.bt)
    assert args[-1] == int(want == "register")
    assert states == [1 + (d // width) * 4]
    with pytest.raises(ValueError, match="unknown tile network"):
        cuda.fused(AFFINE, (x, x), small, network="warp")


@pytest.mark.parametrize("network", (None, "register", "shared"))
@pytest.mark.parametrize("name,layout,carry_net", CHANNEL_NETWORKS,
                         ids=[c[0] for c in CHANNEL_NETWORKS])
def test_totals_apply_launch_the_network(monkeypatch, name, layout,
                                         carry_net, network):
    """``cuda.totals`` and ``cuda.apply`` pass the kernel the network
    ``tile_network`` chooses (the register apply on the register shapes,
    the shared one elsewhere; the reduced totals at every tile of
    ``CHAN_REG_TILES``), or the one they are asked for, with that
    network's strip width (``chan_reg_width`` for the register kernels,
    ``channel_width`` for the shared ones); the launch is intercepted, so
    this runs on CPU tensors."""
    seen = []
    monkeypatch.setattr(cuda, "_on_cuda", lambda t: None)
    lib = type("Lib", (), {f"scan_{k}": None for k in cuda.KERNELS})
    monkeypatch.setattr(cuda, "build", lambda: lib)
    monkeypatch.setattr(cuda, "_launch",
                        lambda spec_, k, fn, device, *args: seen.append(
                            (k, args)))
    d = layout.d % 64 or 64
    small = scan_engine.Channels(1, 2 * layout.bt, d, layout.bt, d)
    x = torch.ones(small.shape)
    offs = cuda._new_leaves(AFFINE, x, x, small.chain_shape)
    cuda.totals(AFFINE, (x, x), small, network=network)
    cuda.apply(AFFINE, (x, x), offs, small, exclusive=True, network=network)
    assert [k for k, _ in seen] == ["totals", "apply"]
    reduced = "register" if small.bt in cuda.CHAN_REG_TILES else "shared"
    for kernel, args in seen:
        want = network or cuda.tile_network(AFFINE, small, kernel)
        assert network or want == (reduced if kernel == "totals"
                                   else carry_net)
        width = (cuda.chan_reg_width(small) if want == "register"
                 else cuda.channel_width(small))
        geo = (1, 2 * small.bt, d, width, small.bt)
        if kernel == "totals":   # (..., b, n, d, width, bn, net)
            assert args[-6:-1] == geo
        else:   # (..., b, n, d, width, bn, exclusive, sentinel, net)
            assert args[-8:-3] == geo and args[-3] == 1
        assert args[-1] == int(want == "register")
    for call in (lambda: cuda.totals(AFFINE, (x, x), small, network="warp"),
                 lambda: cuda.apply(AFFINE, (x, x), offs, small,
                                    network="warp")):
        with pytest.raises(ValueError, match="unknown tile network"):
            call()


def _register_fused(ops, lay, exclusive, pick):
    """``fused_chan_reg_kernel``'s organization in torch ops: each tile
    scanned as ``tile_scan_chan_warps``; its aggregate (the last step) and
    inclusive prefix published; its offset the look-back's fold, LEFT TO
    RIGHT from the inclusive prefix of tile ``pick(j)`` < j over the
    aggregates after it (the identity for tile 0); the output offset ⊕ x,
    the offset the earlier operand."""
    tiles = schedules._tiles(AFFINE, ops, lay)
    scanned = schedules.tile_scan_chan_warps(AFFINE, tiles)
    sel = (schedules.tile_scan_chan_warps(AFFINE, tiles, True) if exclusive
           else scanned)
    lasts = schedules._last(scanned)
    agg = [tuple(t[:, j] for t in lasts) for j in range(lay.num_seq_blocks)]
    incl, offs = [], []
    for j in range(lay.num_seq_blocks):
        if j == 0:
            pre = tuple(torch.full_like(t, f)
                        for t, f in zip(agg[0], AFFINE.fills))
        else:
            k = pick(j)
            pre = incl[k]
            for i in range(k + 1, j):
                pre = AFFINE.combine(pre, agg[i])
        offs.append(pre)
        incl.append(AFFINE.combine(pre, agg[j]))
    offsets = tuple(torch.stack([o[i] for o in offs], 1) for i in range(2))
    return schedules._emit(AFFINE, ops, lay, tiles,
                           schedules._offset(AFFINE, offsets, sel))


def _reference_chain(ops, bt, exclusive):
    """The reference's organization, op by op: its ``tile_scan`` along
    time of each tile, the chunk offsets folded left to right from the
    identity with its combine, each offset combined on the LEFT."""
    a, b = (jnp.asarray(o.numpy()) for o in ops)
    B, T, D = a.shape
    tiles = tuple(v.reshape(B, T // bt, bt, D) for v in (a, b))
    scanned = jax_schedules.tile_scan(jax_monoids.AFFINE, tiles, axis=2)
    sel = (jax_schedules.shift_one(jax_monoids.AFFINE, scanned, 2)
           if exclusive else scanned)
    pre = tuple(jnp.full_like(t[:, 0, 0], f)
                for t, f in zip(tiles, jax_monoids.AFFINE.fills))
    outs = []
    for j in range(T // bt):
        outs.append(jax_monoids.AFFINE.combine(
            tuple(p[:, None] for p in pre), tuple(s[:, j] for s in sel))[1])
        pre = jax_monoids.AFFINE.combine(
            pre, tuple(s[:, j, -1] for s in scanned))
    return torch.from_numpy(np.array(jnp.stack(outs, 1).reshape(B, T, D)))


PICKS = {"nearest": lambda j: j - 1, "first": lambda j: 0,
         "middle": lambda j: j // 2}


@pytest.mark.parametrize("pick", tuple(PICKS))
@pytest.mark.parametrize("exclusive", (False, True))
@pytest.mark.parametrize("bt", cuda.CHAN_REG_TILES)
def test_register_fused_bitwise(bt, exclusive, pick):
    """The register fused's organization (the network a tile, the
    look-back's left fold from whichever inclusive prefix it finds) is
    bitwise ``fused_plain``, ``carry_plain`` and the reference's chain,
    signed zeros included, on exact data with -0.0 at every tile start."""
    ops = _operands(bt, 7 * bt + len(pick), exact=True, shape=(2, 6 * bt, 8))
    lay = scan_engine.Channels(*ops[0].shape, bt, 8)
    assert cuda.tile_network(AFFINE, lay, "fused") == "register"
    (got,) = _register_fused(ops, lay, exclusive, PICKS[pick])
    (want,) = schedules.fused_plain(ops, AFFINE, lay, exclusive)
    assert same_bits(got, want)
    assert same_bits(got, schedules.carry_plain(ops, AFFINE, lay,
                                                exclusive)[0])
    assert same_bits(got, _reference_chain(ops, bt, exclusive))
    # tile 0's identity offset turns b = -0.0 at step 0 into +0.0 where
    # a > 0: the combine is done, not skipped
    assert bool(torch.signbit(ops[1][:, 0]).all())
    if not exclusive:
        z = got[:, 0][ops[0][:, 0] > 0]
        assert z.numel() and bool((z == 0).all())
        assert not bool(torch.signbit(z).any())


def _register_apply(ops, lay, exclusive):
    """decoupled on Channels as the CUDA kernels organize it: the totals
    as each channel's balanced tree over the tile (``totals_tree_plain``,
    ``totals_chan_reduce_kernel``), the chain's left fold
    (``exclusive_chain``), then ``apply_chan_reg_kernel``: each tile
    scanned as ``tile_scan_chan_warps`` (or its exclusive neighbour) with
    its chunk offset combined on the LEFT (``_offset``)."""
    tiles = schedules._tiles(AFFINE, ops, lay)
    offsets = schedules.exclusive_chain(
        AFFINE, schedules.totals_tree_plain(ops, AFFINE, lay))
    sel = schedules.tile_scan_chan_warps(AFFINE, tiles, exclusive)
    return schedules._emit(AFFINE, ops, lay, tiles,
                           schedules._offset(AFFINE, offsets, sel))


@pytest.mark.parametrize("exact", (False, True), ids=("normal", "exact"))
@pytest.mark.parametrize("exclusive", (False, True))
@pytest.mark.parametrize("bt", cuda.CHAN_REG_TILES)
def test_register_apply_bitwise(bt, exclusive, exact):
    """The register decoupled's organization (the reduced totals, the
    chain, the register network a tile with the chain's offset on the
    left) is bitwise ``apply_plain`` given the plain chain's offsets,
    ``carry_plain`` and, on exact data, the reference's decoupled run op
    by op (its ``tile_scan`` along time, each tile's last element, the
    offsets folded left to right with its combine, each on the LEFT),
    signed zeros included, with -0.0 at every tile start."""
    ops = _operands(bt, 11 * bt + exact, exact=exact, shape=(2, 4 * bt, 8))
    lay = scan_engine.Channels(*ops[0].shape, bt, 8)
    assert all(cuda.tile_network(AFFINE, lay, k) == "register"
               for k in ("totals", "apply"))
    (got,) = _register_apply(ops, lay, exclusive)
    offsets = schedules.exclusive_chain(
        AFFINE, schedules.totals_plain(ops, AFFINE, lay))
    (want,) = schedules.apply_plain(ops, offsets, AFFINE, lay, exclusive)
    assert same_bits(got, want)
    assert same_bits(got, schedules.carry_plain(ops, AFFINE, lay,
                                                exclusive)[0])
    assert same_bits(got, schedules.decoupled_plain(ops, AFFINE, lay,
                                                    exclusive)[0])
    if exact:
        assert same_bits(got, _reference_chain(ops, bt, exclusive))
    # tile 0's identity offset turns b = -0.0 at step 0 into +0.0 where
    # a > 0: the combine is done, not skipped
    assert bool(torch.signbit(ops[1][:, 0]).all())
    if not exclusive:
        z = got[:, 0][ops[0][:, 0] > 0]
        assert z.numel() and bool((z == 0).all())
        assert not bool(torch.signbit(z).any())
