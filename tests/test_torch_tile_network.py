"""``tile_scan_warps``: the in-tile network as the CUDA register kernels
organize it.

``carry_reg_kernel`` and ``fused_reg_kernel`` (``csrc/scan_sum.cu``) run
``tile_scan`` on ``Rows`` tiles of 128·r elements in registers: a warp a
128-element segment, lane l holding elements 4l .. 4l + 3, Hillis–Steele
by shifts across lanes with the identity padded in by segment position,
the segment totals' Hillis–Steele in rounds of 16 segments, the
broadcast combine and the exclusive form's neighbour from the lane
below. ``schedules.tile_scan_warps`` states that organization in torch
ops. It must be bitwise equal to the port's ``tile_scan`` (and its
exclusive shift), whatever the number of warps a round, and to the
reference's ``tile_scan``. XLA's CPU runtime flushes subnormals, so the
comparison with the reference runs torch in flush mode on one thread, as
``test_torch_totals_tree.py`` does. The kernels themselves are held
against the plain versions on the card in
``tests/test_torch_cuda_kernels.py``; which network a launch of carry,
apply (``apply_reg_kernel``: one round over the whole tile), fused or
tree takes is chosen by shape in ``cuda.tile_network``, tested here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_totals_data import operands, same_bits
from repro.kernels.scan_engine import monoids as jax_monoids
from repro.kernels.scan_engine import schedules as jax_schedules
from repro_torch.kernels import scan_engine
from repro_torch.kernels.scan_engine import cuda, monoids, schedules

KINDS = ("float32", "bfloat16", "int32", "segsum", "mask")
BLOCKS = (128, 256, 2048, 2176, 16384)
CASES = [(k, bn) for k in KINDS for bn in BLOCKS]
IDS = [f"{k}-bn{bn}" for k, bn in CASES]


def _leaves(kind, bn, seed):
    """(spec, jax spec, accumulation-dtype leaves) of two rows of two
    tiles, as (4, bn) tiles: adversarial values (signed zeros at tile
    starts, subnormals, cancelling pairs), segmented flags that are
    negative or not 0/1."""
    n = 2 * bn
    if kind == "segsum":
        x = operands("float32", 2, n, bn, seed)
        rng = np.random.default_rng(seed + 1)
        f = np.where(rng.random((2, n)) < 0.03, rng.choice([-3, 1, 2], (2, n)),
                     0).astype(np.int32)
        f[:, ::bn] = 0           # a tile starting with -0.0 and no flag
        ops = (x, torch.from_numpy(f))
        spec, jspec = monoids.SEGMENTED_SUM, jax_monoids.SEGMENTED_SUM
    else:
        ops = (operands(kind, 2, n, bn, seed),)
        if kind == "mask":
            spec, jspec = monoids.mask(n), jax_monoids.mask(n)
        else:
            spec, jspec = monoids.SUM, jax_monoids.SUM
    lay = scan_engine.Rows(2, n, 1, bn)
    tiles = schedules._tiles(spec, ops, lay)
    return spec, jspec, tuple(t.reshape(-1, bn) for t in tiles)


def _all_same(got, want):
    return len(got) == len(want) and all(same_bits(g, w)
                                         for g, w in zip(got, want))


@pytest.mark.parametrize("kind,bn", CASES, ids=IDS)
def test_tile_scan_warps_bitwise_vs_tile_scan(kind, bn):
    spec, _, leaves = _leaves(kind, bn, 80)
    want = schedules.tile_scan(spec, leaves)
    assert _all_same(schedules.tile_scan_warps(spec, leaves), want)
    assert _all_same(schedules.tile_scan_warps(spec, leaves, exclusive=True),
                     schedules.shift_one(spec, want))


@pytest.mark.parametrize("round_segs", (1, 3, 8))
@pytest.mark.parametrize("bn", (2176, 16384))
def test_tile_scan_warps_rounds_give_the_same_bits(bn, round_segs):
    """A round sees only the totals up to its own segments: rounds of any
    number of segments give the bits of one round over all of them."""
    for kind in ("float32", "segsum"):
        spec, _, leaves = _leaves(kind, bn, 81)
        want = schedules.tile_scan(spec, leaves)
        assert _all_same(schedules.tile_scan_warps(
            spec, leaves, round_segs=round_segs), want), kind
        assert _all_same(schedules.tile_scan_warps(
            spec, leaves, True, round_segs=round_segs),
            schedules.shift_one(spec, want)), kind


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bn", (2176, 16384))
def test_tile_scan_warps_apply_round(kind, bn):
    """``apply_reg_kernel``'s organization: one round over all r segment
    totals (a block a tile), then each chunk offset on the LEFT, gives
    ``apply_plain``'s outputs, inclusive and exclusive."""
    spec, _, leaves = _leaves(kind, bn, 83)
    r = bn // 128
    want = schedules.tile_scan(spec, leaves)
    assert _all_same(schedules.tile_scan_warps(spec, leaves, round_segs=r),
                     want)
    n = 2 * bn
    x = operands("float32" if kind == "segsum" else kind, 2, n, bn, 83)
    ops = (x,) if kind != "segsum" else (x, (torch.arange(n) % 301 == 7)
                                         .to(torch.int32).expand(2, n))
    lay = scan_engine.Rows(2, n, 1, bn)
    elems = schedules._tiles(spec, ops, lay)
    offsets = schedules.exclusive_chain(spec,
                                        schedules.totals_plain(ops, spec, lay))
    for exclusive in ((False, True) if spec.supports_exclusive else (False,)):
        sel = schedules.tile_scan_warps(
            spec, tuple(t.reshape(-1, bn) for t in elems), exclusive,
            round_segs=r)
        sel = tuple(t.reshape(elems[0].shape) for t in sel)
        got = schedules._emit(spec, ops, lay, elems,
                              schedules._offset(spec, offsets, sel))
        want = schedules.apply_plain(ops, offsets, spec, lay, exclusive)
        assert _all_same(got, want), exclusive


@pytest.fixture
def flush_denormals():
    """torch's CPU ops in XLA's CPU mode: subnormals read and written as
    zero, on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kind,bn", CASES, ids=IDS)
def test_tile_scan_warps_bitwise_vs_reference(kind, bn, flush_denormals):
    spec, jspec, leaves = _leaves(kind, bn, 82)
    jl = tuple(jnp.asarray(t.numpy()) for t in leaves)
    want = jax.jit(lambda *t: jax_schedules.tile_scan(jspec, t, axis=1))(*jl)
    want = tuple(torch.from_numpy(np.array(w)) for w in want)
    assert _all_same(schedules.tile_scan_warps(spec, leaves), want)
    assert _all_same(schedules.tile_scan(spec, leaves), want)


NETWORKS = [
    # (name, spec, layout, network)
    ("sum-rows-bn128", monoids.SUM, scan_engine.Rows(2, 256, 1, 128),
     "register"),
    ("sum-rows-bn2048", monoids.SUM, scan_engine.Rows(8, 32768, 8, 2048),
     "register"),
    ("sum-rows-bn2176", monoids.SUM, scan_engine.Rows(1, 4352, 1, 2176),
     "register"),
    ("sum-rows-bn16384", monoids.SUM, scan_engine.Rows(1, 32768, 1, 16384),
     "register"),
    ("segsum-rows-bn2048", monoids.SEGMENTED_SUM,
     scan_engine.Rows(4, 4096, 4, 2048), "register"),
    ("mask-rows-bn2048", monoids.mask(4096), scan_engine.Rows(1, 4096, 1, 2048),
     "register"),
    ("sum-rows-bn96", monoids.SUM, scan_engine.Rows(3, 960, 1, 96), "shared"),
    ("sum-rows-bn200", monoids.SUM, scan_engine.Rows(2, 600, 1, 200),
     "shared"),
    ("segsum-rows-bn64", monoids.SEGMENTED_SUM, scan_engine.Rows(2, 128, 1, 64),
     "shared"),
    ("affine-rows-bn256", monoids.AFFINE, scan_engine.Rows(2, 512, 1, 256),
     "shared"),
    ("sum-channels-bt256", monoids.SUM, scan_engine.Channels(2, 512, 4, 256, 4),
     "shared"),
    # the affine carry, apply, fused and tree on Channels tiles of 256
    # steps: the register kernels (carry_chan_reg_kernel,
    # apply_chan_reg_kernel, fused_chan_reg_kernel, tree_chan_reg_kernel)
    ("affine-channels-bt256", monoids.AFFINE,
     scan_engine.Channels(1, 1024, 64, 256, 64),
     {"carry": "register", "apply": "register", "fused": "register",
      "tree": "register"}),
    ("affine-channels-bt64", monoids.AFFINE,
     scan_engine.Channels(1, 1024, 64, 64, 64), "shared"),
]


def _network(network, kernel):
    """A case's network for ``kernel``: one for all four, or by kernel."""
    return network if isinstance(network, str) else network[kernel]


@pytest.mark.parametrize("name,spec,layout,network", NETWORKS,
                         ids=[c[0] for c in NETWORKS])
def test_tile_network_by_shape(name, spec, layout, network):
    """Rows tiles of 128·r elements take the register network for every
    spec but the affine pair; other tile lengths keep the shared-memory
    ``tile_scan``, and so does Channels but for the affine carry, apply,
    fused and tree (``tests/test_torch_chan_network.py``)."""
    for kernel in ("carry", "apply", "fused", "tree"):
        assert cuda.tile_network(spec, layout, kernel) == _network(network,
                                                                   kernel)


def _wrapper_operands(spec, layout):
    """CPU operands of ``layout.shape`` that the wrappers' checks take."""
    x = torch.ones(layout.shape)
    if spec.name == "mask":
        return (x.to(torch.int32),)
    if spec.name == "segsum":
        return (x, torch.zeros(layout.shape, dtype=torch.int32))
    return (x, x) if spec.name == "affine" else (x,)


@pytest.mark.parametrize("kernel", ("carry", "apply", "fused", "tree"))
@pytest.mark.parametrize("name,spec,layout,network", NETWORKS,
                         ids=[c[0] for c in NETWORKS])
def test_wrappers_launch_the_tile_network(monkeypatch, kernel, name, spec,
                                          layout, network):
    """Each of carry, apply, fused and tree passes the kernel the network
    ``tile_network`` chose (the C interface's last argument before the
    stream: 1 register, 0 shared), and chooses it nowhere else. The launch
    is intercepted, so this runs on CPU tensors."""
    nets = []
    monkeypatch.setattr(cuda, "_on_cuda", lambda t: None)
    lib = type("Lib", (), {f"scan_{k}": None for k in cuda.KERNELS})
    monkeypatch.setattr(cuda, "build", lambda: lib)
    monkeypatch.setattr(cuda, "_launch",
                        lambda spec_, k, fn, device, *args: nets.append(
                            (k, args[-1])))
    ops_ = _wrapper_operands(spec, layout)
    if kernel == "apply":
        code, x, y = cuda._operands(spec, ops_, layout)
        offsets = cuda._new_leaves(spec, x, y, layout.chain_shape)
        cuda.apply(spec, ops_, offsets, layout)
    else:
        getattr(cuda, kernel)(spec, ops_, layout)
    assert nets == [(kernel, int(_network(network, kernel) == "register"))]


# The totals of each NETWORKS case: the reduction without the scan
# ("register": totals_reduce_kernel for the sum, the segmented sum and the
# mask on Rows at any tile length, totals_chan_reduce_kernel for the
# affine pair on Channels tiles of 128, 256 and 512 steps) or the
# network's totals_kernel.
TOTALS = {"sum-rows-bn128": "register", "sum-rows-bn2048": "register",
          "sum-rows-bn2176": "register", "sum-rows-bn16384": "register",
          "segsum-rows-bn2048": "register", "mask-rows-bn2048": "register",
          "sum-rows-bn96": "register", "sum-rows-bn200": "register",
          "segsum-rows-bn64": "register", "affine-rows-bn256": "shared",
          "sum-channels-bt256": "shared", "affine-channels-bt256": "register",
          "affine-channels-bt64": "shared"}


@pytest.mark.parametrize("name,spec,layout,network", NETWORKS,
                         ids=[c[0] for c in NETWORKS])
def test_tile_network_totals_by_shape(monkeypatch, name, spec, layout,
                                      network):
    """``tile_network(..., "totals")`` chooses the reduction where a
    kernel of it exists, and ``cuda.totals`` passes that choice (the C
    interface's last argument before the stream), or the network it is
    asked for; the launch is intercepted, so this runs on CPU tensors."""
    assert set(TOTALS) == {c[0] for c in NETWORKS}
    assert cuda.tile_network(spec, layout, "totals") == TOTALS[name]
    nets = []
    monkeypatch.setattr(cuda, "_on_cuda", lambda t: None)
    lib = type("Lib", (), {f"scan_{k}": None for k in cuda.KERNELS})
    monkeypatch.setattr(cuda, "build", lambda: lib)
    monkeypatch.setattr(cuda, "_launch",
                        lambda spec_, k, fn, device, *args: nets.append(
                            (k, args[-1])))
    ops_ = _wrapper_operands(spec, layout)
    for asked in (None, "shared", "register"):
        cuda.totals(spec, ops_, layout, network=asked)
    assert nets == [("totals", int(TOTALS[name] == "register")),
                    ("totals", 0), ("totals", 1)]


def test_tile_network_follows_the_wrappers_tiling():
    """The wrappers tile a row with min(block_n, round_up(n, 128)), so the
    main path's Rows launches always take the register network."""
    for n in (1, 127, 517, 4096, 1 << 20):
        for block_n in (128, 512, 2048, 16384):
            bn = min(block_n, -(-n // 128) * 128)
            lay = scan_engine.Rows(1, -(-n // bn) * bn, 1, bn)
            for kernel in ("carry", "apply", "fused", "tree"):
                assert cuda.tile_network(monoids.SUM, lay,
                                         kernel) == "register", (n, bn)
