"""The choice between the SIMT and tensor-core forms of the attention-fold
kernels, and the tensor-core forms' tiling, on the CPU.

``cuda_fold.fold_form`` picks the kernel from dtype, head dim and block
sizes; ``cuda_fold.tc_tiling`` is the block layout of
``csrc/attn_fold_tc.cu`` (the kernel refuses a launch whose shared memory
disagrees with it); ``cuda_fold.tc_tile_rows`` is the forward's packing of
a GQA group's q rows into 64-row tiles, held here against the plain fold.
The kernels themselves run only on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.flash_attention import forward_fold
from repro_torch.kernels.scan_engine import cuda_fold, schedules

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("kernel,dtype,d,bq,bk,form", [
    ("fold_fwd", BF16, 128, 128, 128, "fold_fwd_tc"),
    ("fold_fwd", BF16, 256, 128, 128, "fold_fwd_tc"),
    ("fold_fwd", BF16, 64, 64, 64, "fold_fwd_tc"),
    ("fold_fwd", BF16, 128, 8, 128, "fold_fwd_tc"),     # a decode step
    ("fold_fwd", BF16, 256, 16, 64, "fold_fwd_tc"),
    ("fold_dkv", BF16, 256, 128, 128, "fold_dkv_tc"),
    ("fold_dkv", BF16, 64, 64, 64, "fold_dkv_tc"),
    ("fold_fwd", F32, 128, 128, 128, "fold_fwd_tf32"),  # phi3 prefill
    ("fold_fwd", F32, 256, 128, 128, "fold_fwd_tf32"),  # gemma2 training
    ("fold_fwd", F32, 64, 128, 128, "fold_fwd_tf32"),
    ("fold_fwd", F32, 64, 64, 64, "fold_fwd_tf32"),
    ("fold_fwd", F32, 128, 64, 128, "fold_fwd_tf32"),
    ("fold_fwd", F32, 256, 128, 64, "fold_fwd_tf32"),
    ("fold_fwd", F32, 256, 64, 64, "fold_fwd_tf32"),
    ("fold_fwd", F32, 128, 8, 128, "fold_fwd"),         # decode: bq 8
    ("fold_fwd", F32, 256, 32, 64, "fold_fwd"),         # bq 32
    ("fold_fwd", F32, 32, 128, 128, "fold_fwd"),        # d not 64/128/256
    ("fold_fwd", F32, 128, 128, 32, "fold_fwd"),        # bk 32
    ("fold_dkv", F32, 256, 128, 128, "fold_dkv_tf32"),  # gemma2 training
    ("fold_dkv", F32, 256, 64, 64, "fold_dkv_tf32"),
    ("fold_dkv", F32, 128, 128, 128, "fold_dkv_tf32"),  # phi3 prefill
    ("fold_dkv", F32, 64, 64, 64, "fold_dkv_tf32"),
    ("fold_dkv", F32, 128, 64, 128, "fold_dkv_tf32"),
    ("fold_dkv", F32, 64, 128, 64, "fold_dkv_tf32"),
    ("fold_dkv", F32, 32, 128, 128, "fold_dkv"),        # d not 64/128/256
    ("fold_dkv", F32, 128, 8, 128, "fold_dkv"),         # bq 8
    ("fold_dkv", F32, 128, 128, 256, "fold_dkv"),       # bk 256
    ("fold_dq", BF16, 128, 128, 128, "fold_dq_tc"),
    ("fold_dq", BF16, 64, 128, 128, "fold_dq_tc"),
    ("fold_dq", BF16, 256, 128, 128, "fold_dq_tc"),
    ("fold_dq", BF16, 128, 64, 64, "fold_dq_tc"),
    ("fold_dq", F32, 128, 128, 128, "fold_dq_tf32"),    # phi3 prefill
    ("fold_dq", F32, 64, 128, 128, "fold_dq_tf32"),
    ("fold_dq", F32, 256, 128, 128, "fold_dq_tf32"),    # gemma2 training
    ("fold_dq", F32, 64, 64, 64, "fold_dq_tf32"),
    ("fold_dq", F32, 128, 64, 128, "fold_dq_tf32"),
    ("fold_dq", F32, 256, 128, 64, "fold_dq_tf32"),
    ("fold_dq", F32, 32, 128, 128, "fold_dq"),          # d not 64/128/256
    ("fold_dq", F32, 128, 8, 128, "fold_dq"),           # bq 8
    ("fold_dq", F32, 256, 32, 64, "fold_dq"),           # bq 32
    ("fold_dq", BF16, 128, 8, 128, "fold_dq"),          # dq: bq 64/128
    ("fold_fwd", BF16, 32, 128, 128, "fold_fwd"),       # d not 64/128/256
    ("fold_fwd", BF16, 128, 128, 32, "fold_fwd"),       # bk not 64/128
    ("fold_fwd", BF16, 128, 104, 128, "fold_fwd"),      # bq 104
    ("fold_dkv", BF16, 128, 8, 128, "fold_dkv"),        # dk/dv: bq 64/128
    ("fold_dkv", BF16, 128, 128, 256, "fold_dkv"),      # dk/dv takes bk 256
])
def test_fold_form(kernel, dtype, d, bq, bk, form):
    assert cuda_fold.fold_form(kernel, dtype, d, bq, bk) == form
    assert form in cuda_fold.KERNELS


@pytest.mark.parametrize("kernel,d,bk", [
    ("fold_fwd", 320, 128), ("fold_dkv", 512, 64), ("fold_fwd", 128, 256),
    ("fold_dq", 64, 192)])
def test_fold_form_refuses_out_of_range(kernel, d, bk):
    with pytest.raises(ValueError, match="head dim"):
        cuda_fold.fold_form(kernel, BF16, d, 128, bk)


def test_fold_form_refuses_float16():
    with pytest.raises(TypeError, match="no CUDA fold kernel"):
        cuda_fold.fold_form("fold_fwd", torch.float16, 128, 128, 128)


def _accepted():
    """Every (form, d, bq, bk) the tensor-core forms take."""
    for kernel, form in (("fold_fwd", "fold_fwd_tc"),
                         ("fold_dq", "fold_dq_tc"),
                         ("fold_dkv", "fold_dkv_tc")):
        for d in cuda_fold.TC_DIMS:
            for bk in cuda_fold.TC_BK:
                for bq in cuda_fold.TC_BQ[kernel]:
                    assert cuda_fold.fold_form(kernel, BF16, d, bq, bk) == form
                    yield form, d, bq, bk


@pytest.mark.parametrize("form,d,bq,bk", list(_accepted()))
def test_tc_tiling_fits_shared_memory(form, d, bq, bk):
    t = cuda_fold.tc_tiling(form, d, bq)
    assert t["stages"] >= 2                      # a ring, not one buffer
    assert t["stages"] * t["stage_bytes"] <= cuda_fold.SMEM_LIMIT
    assert t["smem"] <= cuda_fold.SMEM_LIMIT
    # the forward: a producer warp beside one consumer warpgroup, a
    # producer warpgroup (whose registers setmaxnreg hands over) beside
    # two; dq and dk/dv: two warpgroups, one thread of which loads
    assert t["threads"] == {("fold_fwd_tc", 1): 160, ("fold_fwd_tc", 2): 384,
                            ("fold_dq_tc", 2): 256,
                            ("fold_dkv_tc", 2): 256}[form, t["warpgroups"]]
    tile = d // 64 * cuda_fold.PANEL_BYTES       # 64 rows x d bf16
    assert tile == 64 * d * 2
    if form == "fold_fwd_tc":
        # a cell's k and v (bk / 64 tiles each) fit the ring at once
        assert t["stages"] >= 2 * bk // 64
        assert t["stage_bytes"] == tile
        assert t["warpgroups"] == (2 if bq == 128 and d <= 128 else 1)
    elif form == "fold_dq_tc":
        # one warpgroup forms p·g, the other ds, over one 64-row q tile:
        # its q and dO stay resident, a cell's v and k tiles fit the ring
        assert t["warpgroups"] == 2
        assert t["stages"] >= 2 * bk // 64
        assert t["stage_bytes"] == tile
        assert t["smem"] == (1024 + 2 * tile + 4 * cuda_fold.PANEL_BYTES
                             + t["stages"] * tile + 8 * (2 * t["stages"] + 1))
    else:
        # one warpgroup forms dv, the other dk, over one ring of q / dO
        # chunks and their rows' (m, l, delta)
        assert t["warpgroups"] == 2
        assert t["stage_bytes"] == 2 * tile + 3 * 64 * 4


@pytest.mark.parametrize("d", cuda_fold.TF32_DIMS)
@pytest.mark.parametrize("bq", cuda_fold.TC_BK)
def test_tf32_tiling_fits_shared_memory(d, bq):
    """``fold_dkv_tf32``'s block (``Tf32DkvTiles``) fits the 227 KB a
    block may use: k and v (64 rows x d float32), the four [64 kv][32 q]
    tiles of pᵀ and p·g / dsᵀ as TF32 hi and lo, and a ring of at least
    two stages, each a 32-row chunk of q and dO as hi and lo (the whole d
    up to 128, 64 of its columns at d = 256) beside the rows' (m, l,
    delta), with its mbarriers."""
    t = cuda_fold.tc_tiling("fold_dkv_tf32", d, bq)
    rows = cuda_fold.TF32_ROWS
    chunk = d if d <= 128 else 64
    assert bq % rows == 0
    assert t["warpgroups"] == 2 and t["threads"] == 256
    assert t["stages"] >= 2
    assert t["stage_bytes"] == 4 * rows * chunk * 4 + 3 * rows * 4
    assert t["smem"] == (1024 + 2 * 64 * d * 4 + 4 * 64 * rows * 4
                         + t["stages"] * t["stage_bytes"]
                         + 8 * (2 * t["stages"] + 1))
    assert t["smem"] <= cuda_fold.SMEM_LIMIT
    # one stage more would not fit at d = 128 and 256
    if d >= 128:
        assert t["smem"] + t["stage_bytes"] + 16 > cuda_fold.SMEM_LIMIT


@pytest.mark.parametrize("d", cuda_fold.TF32_DIMS)
@pytest.mark.parametrize("bq", cuda_fold.TC_BK)
def test_tf32_dq_tiling_fits_shared_memory(d, bq):
    """``fold_dq_tf32``'s block (``Tf32DqTiles``) fits the 227 KB a block
    may use: the 64-row q and dO tiles in float32, ds as TF32 hi and lo
    ([64 q][64 kv] each), and a ring of as many 32 KB stages as fit, at
    least two (a stage: 32 columns of a 64-row kv tile's k and of its v,
    each as hi and lo, or 64 columns of k for each warpgroup's dqᵀ
    tile), with its mbarriers."""
    t = cuda_fold.tc_tiling("fold_dq_tf32", d, bq)
    assert t["warpgroups"] == 2 and t["threads"] == 256
    assert t["stages"] >= 2
    assert t["stage_bytes"] == 4 * 64 * 32 * 4 == 2 * 64 * 64 * 4
    assert t["smem"] == (1024 + 2 * 64 * d * 4 + 2 * 64 * 64 * 4
                         + t["stages"] * t["stage_bytes"]
                         + 8 * (2 * t["stages"] + 1))
    assert t["smem"] <= cuda_fold.SMEM_LIMIT
    assert t["smem"] + t["stage_bytes"] + 16 > cuda_fold.SMEM_LIMIT


@pytest.mark.parametrize("d", cuda_fold.TF32_DIMS)
@pytest.mark.parametrize("bq", cuda_fold.TC_BK)
def test_tf32_fwd_tiling_fits_shared_memory(d, bq):
    """``fold_fwd_tf32``'s block (``Tf32FwdTiles``) fits the 227 KB a
    block may use: the 64-row q tile in float32, p as TF32 hi and lo
    ([64 q][128 kv] each, the widest cell), the rows' statistics, and a
    ring of as many 32 KB stages as fit, at least three (a stage: 32
    columns of k for each of the cell's two 64-row kv tiles, each as hi
    and lo, or 64 columns of a kv tile's v for each warpgroup's accᵀ
    tile), with its mbarriers."""
    t = cuda_fold.tc_tiling("fold_fwd_tf32", d, bq)
    assert t["warpgroups"] == 2 and t["threads"] == 256
    assert t["stages"] >= 3
    assert t["stage_bytes"] == 4 * 64 * 32 * 4 == 2 * 64 * 64 * 4
    assert t["smem"] == (1024 + 64 * d * 4 + 2 * 64 * 128 * 4
                         + cuda_fold.TF32_FWD_STATS
                         + t["stages"] * t["stage_bytes"]
                         + 8 * (2 * t["stages"] + 1))
    assert t["smem"] <= cuda_fold.SMEM_LIMIT
    # one stage more would not fit
    assert t["smem"] + t["stage_bytes"] + 16 > cuda_fold.SMEM_LIMIT


@pytest.mark.parametrize("form", ("fold_fwd_tf32", "fold_dq_tf32",
                                  "fold_dkv_tf32"))
def test_tf32_tiling_refuses_other_dims(form):
    with pytest.raises(ValueError, match=form):
        cuda_fold.tc_tiling(form, 32, 128)


def test_tc_tiling_refuses_other_kernels():
    with pytest.raises(ValueError, match="tensor-core"):
        cuda_fold.tc_tiling("fold_chain", 128, 128)


def _tiles(bq, group):
    return -(-group * bq // 64)


@pytest.mark.parametrize("bq,group", [
    (8, 1), (8, 4), (8, 8), (16, 8), (32, 3), (64, 2), (128, 1), (128, 4)])
def test_tc_tile_rows_cover_each_row_once(bq, group):
    """Every (head of the group, q row) lands in exactly one stored tile
    row; a tile row past the group is never stored."""
    seen = []
    for t in range(_tiles(bq, group)):
        head, row, stored = cuda_fold.tc_tile_rows(bq, group, t)
        assert bool((head[~stored] >= group).all())
        seen += list(zip(head[stored].tolist(), row[stored].tolist()))
    assert sorted(seen) == [(h, r) for h in range(group) for r in range(bq)]


@pytest.mark.parametrize("bq,group,tk,kv_len", [
    (8, 4, 512, 500), (16, 8, 256, 256), (32, 3, 384, 300), (8, 1, 256, 97)])
def test_decode_packing_matches_plain_fold(bq, group, tk, kv_len):
    """The packed tiles, each folded as one 64-row q block against its kv
    head, give the plain fold's rows back (non-causal, as at decode: a
    row's mask then does not depend on its position)."""
    hkv, d = 2, 16
    rng = np.random.default_rng(bq * 100 + group)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((hkv * group, bq, d), (hkv, tk, d), (hkv, tk, d)))
    kw = dict(scale=d ** -0.5, causal=False, kv_len=kv_len, block_k=128)
    spec, lay = forward_fold(q.shape, k.shape, group=group, block_q=bq, **kw)
    (want,) = schedules.fold_carry_plain((q, k, v), spec, lay)
    nt = _tiles(bq, group)
    # what a producer's TMA box loads: rows of the group's heads, then of
    # the next heads (zeros past the last head)
    qz = torch.cat([q, torch.zeros(64, bq, d)])
    packed = torch.stack([
        qz[hk * group + cuda_fold.tc_tile_rows(bq, group, t)[0],
           cuda_fold.tc_tile_rows(bq, group, t)[1]]
        for hk in range(hkv) for t in range(nt)])
    spec_p, lay_p = forward_fold(packed.shape, k.shape, group=nt,
                                 block_q=64, **kw)
    (got_p,) = schedules.fold_carry_plain((packed, k, v), spec_p, lay_p)
    got = torch.full_like(want, float("nan"))
    for hk in range(hkv):
        for t in range(nt):
            head, row, stored = cuda_fold.tc_tile_rows(bq, group, t)
            got[hk * group + head[stored], row[stored]] = \
                got_p[hk * nt + t][stored]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
