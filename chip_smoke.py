#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which passes or raises (the script exits non-zero on the
first failure and prints no result):

  1. environment and build: the card's name and power limit, torch/CUDA/
     nvcc versions, and the builds of ``src/repro_torch/csrc/scan_sum.cu``,
     ``attn_fold.cu`` and ``attn_fold_tc.cu`` with ``nvcc`` for ``sm_90a``,
     one process each, together (their seconds and ptxas reports; the
     tensor-core kernels one by one, and none may spill: fold_dq_tc's,
     fold_fwd_tf32's, fold_dq_tf32's and fold_dkv_tf32's three
     instantiations each, d = 64, 128 and 256, among them; the 104 kernels
     of the register network, carry_reg_kernel, apply_reg_kernel,
     fused_reg_kernel and tree_reg_kernel by spec and vector form, the 13
     of totals_reduce_kernel by spec, and the 18 each of the affine carry,
     apply, fused and tree on Channels, carry_chan_reg_kernel,
     apply_chan_reg_kernel, fused_chan_reg_kernel and
     tree_chan_reg_kernel, by dtype, tile and vector form, and of the
     affine totals there, totals_chan_reduce_kernel, by dtype, tile and
     channels a thread, none may spill either);
  2. every sum kernel against its plain PyTorch version on the card,
     bitwise: the four schedules (fused: the one-launch look-back kernel)
     x {inclusive, exclusive} x {f32, bf16, int32} on (3, 517), (64, 2^18)
     and (1, 2^24) with block_n 512, 2048, 8192 and 16384 (the largest
     tile the kernels take), with carry == decoupled == fused bitwise;
     then the same sweep for the segmented-sum kernels (f32/bf16/int32
     values, int32 flags with negative and non-unit values) and the mask
     kernels, outputs and running chunk totals (fused with running totals
     runs decoupled, as in the reference) and the fused kernel without
     them; messy flags (negative, fractional, leading) through
     ``segmented_cumsum``; and the affine kernels on Channels (f32, bf16,
     f16; 1- to 32-channel strips; time tiles 64 to 8192), every schedule,
     inclusive and exclusive, outputs and running totals; the Rows totals
     of the sum, the segmented sum and the mask (``totals_reduce_kernel``:
     the network's last element built as its tree, no scan) bitwise
     against ``totals_plain`` and ``totals_tree_plain`` at block_n 128,
     200, 384, 2048, 2176 and 16384 for the six sum dtypes, the mask and
     the segmented sum in the six dtypes with flags on every tile's ends
     or dense (and against the shared ``totals_kernel``), signed zeros at
     tile starts, from an aligned base and one element off; and, by the
     profiler's kernel names, that those launch it, the affine pair on
     Channels tiles of 128, 256 and 512 steps
     ``totals_chan_reduce_kernel``, while the sum on Channels and the
     affine pair on Rows and on other Channels tiles take the network's
     ``totals_kernel``; carry,
     apply, fused and tree on Rows in the register network
     (``carry_reg_kernel``, ``apply_reg_kernel``, ``fused_reg_kernel``,
     ``tree_reg_kernel``: a warp a 128-element segment, Hillis-Steele or
     the Blelloch sweep by warp shuffles) at block_n 128, 2048, 2176 and
     16384 for the six sum dtypes, the segmented sum (f32, bf16, int32)
     and the mask, outputs and carry's and tree's running totals bitwise
     equal to the plain versions, decoupled == carry == fused, inclusive
     and exclusive, aligned and one element off, on signed zeros at every
     segment start, subnormals and cancelling pairs; every schedule at
     block_n 200 bitwise equal to the plain versions; and, by the
     profiler's names, that each of the register shapes launches the
     register kernels while block_n 200 and Channels launch
     ``carry_kernel`` / ``apply_kernel`` / ``fused_kernel`` /
     ``tree_kernel`` (the networks in shared memory), but the affine
     carry, apply, fused and tree on Channels, which launch
     ``carry_chan_reg_kernel``, ``apply_chan_reg_kernel``,
     ``fused_chan_reg_kernel`` and ``tree_chan_reg_kernel``; and those
     kernels and ``totals_chan_reduce_kernel`` at time tiles of 128, 256
     and 512 steps over three shapes and three dtypes, outputs and
     running totals bitwise equal to ``carry_plain``, the totals to
     ``totals_plain``, ``totals_tree_plain`` and the shared
     ``totals_kernel``, the chain's offsets to ``exclusive_chain``, apply
     to ``apply_plain`` and the shared ``apply_kernel``, decoupled ==
     carry == fused == the shared-memory ``fused_kernel`` launched by
     name, the tree (outputs and running totals) to ``tree_plain`` and the
     shared ``tree_kernel``, inclusive and exclusive, aligned and one
     element off; and the paper's Observation 5 at the (b) batch, (8192,
     32768): its library oracles ``scan(algorithm="vertical",
     variant=1|2)`` and ``"tree"`` on the card beside ``"horizontal"`` and
     ``"kernel"``, int32 bitwise equal to ``torch.cumsum`` and float32
     within 1e-4 of float64, each timed on the host clock beside the
     card's name and power limit;
  3. the prefix-sum main path through ``repro_torch.core.scan.cumsum`` at
     a column store's size — (a) one column of 2^28 float32 (auto: kernel,
     fused: ONE launch of the fused kernel, shown by the launch counters
     and the one ``kernel.launch`` event), and under schedule="fused" and
     "decoupled", (b) a (8192, 32768) float32 batch through
     algorithm="kernel" (schedule auto: carry) and with schedule="fused",
     (c) the batch with schedule="tree", block_n=8192 — and its backward
     at (1, 2^24); the launch counters are zeroed before and read after,
     and every sum kernel must have launched. Then the outputs are
     checked: fused == decoupled == carry == ``fused_plain`` bitwise on
     (a), also exclusive at block_n 16384, and on five repeated fused
     runs of (a) (a race in the look-back would show as other bits);
     fused == carry == ``fused_plain`` on (b); tree and the batch within a
     stated tolerance of a float64 ``torch.cumsum``, a 2^28 int32 column
     exact under all four schedules, and the gradient bitwise equal to the
     plain flip(cumsum(flip(g)));
  4. the relational main path at column-store scale: TPC-H v3.0.1 at
     SF 10 generated on the card from ``--seed`` (§4.2.3: 15,000,000
     ORDERS, 1-7 LINEITEM rows each), then Q6 (``filter_compact`` +
     sum), Q1 (``filter_compact`` + ``group_by`` sum/mean/count of four
     value columns on returnflag x linestatus), a Q3-shaped ``hash_join``
     (radix-sorted build side), and per-row-group (2^18 rows) mask
     compaction and a per-order running window sum (``mask_compact``,
     ``segmented_cumsum``: carry, tree at block_n 8192, and decoupled),
     and Q6's mask through ``mask_compact_kernel`` with schedule="fused"
     (no running totals: the fused kernel), all else under the policy's
     own choices (Q1's ``group_by`` runs the segmented-sum fused kernel);
     the launch counters are zeroed before and read after, and every
     segmented-sum and mask kernel must have launched. Every result is
     checked against a float64/int64 PyTorch computation on the card:
     counts, group counts and join pairs exact, float sums within 1e-4
     relative;
  5. times (CUDA events, median after warm-up) of each sum schedule on
     (a) and (b), and of every kernel at its main-path shape, beside the
     device-memory bound (for the float chains, which fold on one thread,
     also the latency floor of their dependent combines at the card's
     maximum SM clock), its plain version and, where one exists, the
     one-call PyTorch function (a yardstick only: the port never calls
     it), the chains, the sum and mask totals, every apply and tree row
     and the (a) fused and (b) carry kernels also from CUDA graph replays
     (printed: no host launch cost in them); before they are
     timed, the fused kernel at Q1's (4, ~59M)
     segmented sum and Q6's ~60M-row mask is held bitwise against
     decoupled and ``fused_plain`` (the segmented sum exclusive at
     block_n 16384 too), as every kernel is against its plain version;
     Q1's segmented-sum totals, ``totals_reduce_kernel``, also beside the
     network's ``totals_kernel`` it replaced, in turns and from graph
     replays;
  6. the affine SSM path at zamba2-7b's width: the Mamba2 SSD
     across-chunk carry of zamba2-7b (``repro_torch.configs``: 112 heads
     x head_dim 64 x state 64 = 458,752 channels; ``ssm_chunk`` 128) for a
     131,072-token prefill, (1, 1024, 458752) float32 with per-(chunk,
     head) gates in (0.5, 1] and random chunk states from ``--seed``,
     through ``repro_torch.kernels.ssm_scan.ssm_scan``: auto (carry),
     each of the four schedules, and the backward through autograd; the
     launch counters are zeroed before and read after, and every affine
     kernel must have launched. Each schedule's output and the gradients
     are bitwise equal to the plain versions, the forward within 2e-4 of
     a float64 sequential recurrence; then each affine kernel's time
     (the carry, ``carry_chan_reg_kernel``, also from a CUDA graph replay,
     beside the shared-memory ``carry_kernel`` it replaced; decoupled's
     totals and apply, ``totals_chan_reduce_kernel`` and
     ``apply_chan_reg_kernel``, beside the shared ``totals_kernel`` and
     ``apply_kernel``, in turns and from graph replays; the fused,
     ``fused_chan_reg_kernel``, beside the shared-memory ``fused_kernel``;
     and the tree, ``tree_chan_reg_kernel``, beside the shared-memory
     ``tree_kernel``, in turns and from graph replays; each timed at the
     same shape in the same run and held bitwise against it; the chain,
     ``chain_chan_kernel``, also from a graph replay, and its offsets
     bitwise against its first form's loop, a thread a channel);
  7. the attention fold (``src/repro_torch/csrc/attn_fold.cu``: fold_fwd,
     fold_dq, fold_dkv, and fold_chain, whose softmax-pair and sum
     forms are counted apart as fold_chain and fold_chain_sum; and
     ``attn_fold_tc.cu``: fold_fwd_tc, fold_dq_tc and fold_dkv_tc, the
     tensor-core forms bf16 takes, and fold_fwd_tf32, fold_dq_tf32 and
     fold_dkv_tf32, the 3xTF32 forms float32 takes) through
     ``repro_torch.kernels.flash_attention.flash_attention`` and autograd,
     at two models' full attention widths with random bf16 inputs:
     (f) gemma2-9b training, B 1 x T 8192, 16 q / 8 kv heads of 256,
     softcap 50, its global (causal) and local (4096-window) layers under
     auto (carry) and decoupled, forward and backward; (g) phi3-medium-14b
     decode, q (4, 40, 1, 128) against a 131,072-token cache of 10 kv
     heads (auto: decoupled, split-KV); (h) phi3-medium-14b causal
     prefill, T 4096, forward and backward (auto: carry), and once more in
     float32, and (f)'s global layer once more in float32. The launch
     counters are zeroed before and read after, and all eight counters of
     the path must have moved: each bf16 call through the tensor-core
     forms, the float32 ones through the 3xTF32 ``fold_fwd_tf32``,
     ``fold_dq_tf32`` and ``fold_dkv_tf32`` (d = 128 at (h), 256 at
     (f)); the SIMT forward, dq and dk/dv, off the path now, must not
     have. The
     folds' specs and layouts come from the entry points' own builders
     (``forward_fold``, ``backward_folds``,
     ``ops.kernel_inputs``). Gates: each kernel, each chain per spec
     included, against its plain version in float32 at the (f), (g) and
     (h) shapes (1e-5 forward, 1e-4 gradients: the reference tests'
     tolerances; the float32 forward, dq and dk/dv under the carry fold
     and the split pass at (f) and (h): the forward's split pass by its
     chunks' (m, l) and, through the chain, its outputs against the plain
     folds, and its chunk payloads, acc included, against float64 on two
     heads) and in bf16 at the timed shapes (atol
     1e-3, rtol two
     bf16 ulps); the (f) forward within 2e-3 of a float64 dense
     attention on two heads; carry == decoupled within 1e-5 (float32)
     and two bf16 ulps (bf16); use_kv_bounds
     on and off, and a page-permuted cache through kv_block_map against
     the contiguous one, bitwise (at (f) in bf16 and (g); the float32
     ``fold_fwd_tf32`` at (h) and (f)); count_cells equal to the analytic
     live
     cells; fully masked rows exactly 0 with zero gradients; the bf16
     forward, dq and dk/dv at zamba2-7b's head dim 112 (``fold_fwd_tc``,
     ``fold_dq_tc`` and ``fold_dkv_tc`` at D 128), 32 heads on a ragged
     2500-token prompt, under carry and through the split pass (its
     payloads at stride 112) and the chain, against the plain folds;
     then each
     fold kernel's time beside its bound, its plain version and, where
     one PyTorch call computes the same function,
     ``scaled_dot_product_attention`` (not for gemma2's softcap); in
     float32 ``fold_fwd_tf32``, ``fold_dq_tf32`` and ``fold_dkv_tf32``
     are timed at (h) and (f), the 3xTF32 forms at (h) also from a CUDA
     graph replay, each beside the SIMT kernel it replaced, launched by
     name at the same shape in the same run; the softmax pair's chain,
     ``fold_chain``, at (g) and at (f)'s local layer (16 splits, bf16
     out with the statistics), bitwise equal to its plain version and to
     its first form's loop (a thread a (row, column)), also from CUDA
     graph replays; one ``torch.profiler``
     trace (host and device) of the (h) bf16 forward call shows where its
     host time goes beyond ``fold_fwd_tc``.

  8. zamba2-7b (cell (i)) at full width, all 81 layers, bf16, random
     weights from ``--seed``, serving two requests on the card through the
     port's models (``repro_torch.models``) and paged KV cache
     (``repro_torch.serve.paging``, ``serve.decode``): the parameter count, weight bytes and
     peak memory; each prompt (4096 and 2500 tokens from ``--seed``)
     prefilled alone into a 4352-position cache with
     ``attn_impl="flash"`` and the SSD carry on the kernels, 27 fold
     launches (``fold_fwd_tc``: bf16 at head dim 112 runs at D 128, the
     columns past 112 read as zeros; none of the SIMT ``fold_fwd``) and
     54 affine carry launches a prefill, checked, the 4096-token
     prefill's carries (tiles of 32 chunks) and the 2500-token one's
     (tiles of 24) on the register network (``carry_chan_reg_kernel``, a
     thread a channel); the first
     shared-attention fold of the first prefill and the first Mamba2
     carry of each captured as the engine gets them and held against
     their plain versions (the fold to bf16's (atol, rtol), the carries
     bitwise), with their rows in the kernels line (their launches the
     two prefills'), each beside the first form it replaced at the same
     shape (the SIMT ``fold_fwd`` by name, the shared ``carry_kernel``
     in turns); every fold and
     carry call of both prefills held against its plain version on its
     own operands, in a prefill of its own; the whole prefill again on the
     plain routes, the last logits' relative L2 error
     under ``SERVE_L2_BOUND``; 16 greedy steps of both requests together
     with a per-row ``cache_len``, through the rows' caches side by side
     and through page pools from ``PageAllocator`` / ``PageTable`` /
     ``scatter_prefix``, tokens and logits bitwise equal; host-clock
     medians of prefill and decode, and one ``torch.profiler`` window per
     stage (prefill, contiguous and paged decode step) with device busy
     and the top kernels, the prefill's naming ``fold_fwd_tc_kernel`` and
     ``carry_chan_reg_kernel`` and neither first form.

  9. zamba2-7b training (cell (j)) at full width, cut to 6 layers (two
     periods of mamba, mamba, shared_attn; all 81 would need ~89 GB for
     weights, gradients, masters and moments), bf16, random weights from
     ``--seed``: four AdamW steps of ``repro_torch.train.make_train_step``
     on ``SyntheticDataset`` batches of 2 x 4096 tokens, flash attention
     and the SSM kernel, remat, two microbatches. Each step's launches are
     counted and checked (``fold_fwd_tc`` 8, ``fold_dq_tc`` and
     ``fold_dkv_tc`` 4 each, all at D 128 for head dim 112, none of the
     SIMT forms; the affine carry 24 on ``carry_chan_reg_kernel``:
     forward, remat's recomputation and the backward's scan); the first
     fold forward, dq, dk/dv and the first carry of each direction are
     captured as the engine gets them and held against their plain
     versions (bf16's bar; the carries bitwise; dq and dk/dv with dO
     and delta scaled by a power of two to unit RMS, and each output
     also within 2^-6 of its max |plain|), with their rows in the
     kernels line beside their bounds and SDPA's forward and backward,
     dq and dk/dv also beside the SIMT ``fold_dq`` and ``fold_dkv`` they
     replaced, launched by name (0 launches); step 0's loss and gradients
     on the plain routes (blockwise attention, the chunked SSD) within
     ``TRAIN_L2_BOUND`` / ``TRAIN_LOSS_BOUND`` of the kernel routes';
     every step's loss finite, batch 0's loss lower after the steps, and
     every float32 master with a gradient or a decay moved; the host-clock
     step time, tokens/s, peak memory and one profiler window of a step
     (device busy, top kernels), naming ``fold_dq_tc_kernel`` and
     ``fold_dkv_tc_kernel`` and neither SIMT backward kernel. Then
     ``Trainer`` on zamba2-7b's SMOKE config: 8 steps with checkpoints
     every 4 into a temporary directory, a restart from step 4 reaching
     step 8 with the uninterrupted run's bits.

The line before the last is one JSON object with a row per kernel (the
shared-memory kernels timed beside the kernels that replaced them in rows
of their own, ``<name>_shared``, with 0 launches); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
CU_SOURCE = "src/repro_torch/csrc/scan_sum.cu"
ATTN_SOURCE = "src/repro_torch/csrc/attn_fold.cu"
ATTN_TC_SOURCE = "src/repro_torch/csrc/attn_fold_tc.cu"

# Device-memory rate (bytes/s) and float32 non-tensor-core peak (ops/s)
# of the H100 variants, from NVIDIA's data sheets.
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12}
F32_RATE = {"H100 PCIe": 51e12, "H100 NVL": 60e12, "H100": 67e12}
# Dense bf16 and TF32 tensor-core peaks (ops/s), the data sheets' rates
# without sparsity.
BF16_RATE = {"H100 PCIe": 756e12, "H100 NVL": 835e12, "H100": 989e12}
TF32_RATE = {"H100 PCIe": 378e12, "H100 NVL": 417.5e12, "H100": 495e12}

SCHEDULES = ("carry", "decoupled", "fused", "tree")
KERNELS = ("carry", "totals", "chain", "apply", "fused", "tree")
USES = {"carry": ("carry",), "decoupled": ("totals", "chain", "apply"),
        "fused": ("fused",), "tree": ("tree",)}
REPLACES = {
    "carry": "src/repro/kernels/scan_engine/schedules.py:335",
    "totals": "src/repro/kernels/scan_engine/schedules.py:390",
    "chain": "src/repro/kernels/scan_engine/schedules.py:248",
    "apply": "src/repro/kernels/scan_engine/schedules.py:405",
    "fused": "src/repro/kernels/scan_engine/schedules.py:527",
    "tree": "src/repro/kernels/scan_engine/schedules.py:605",
}
# Tolerance of a float32 prefix sum against float64, relative to the
# largest prefix magnitude: rounding walks ~sqrt(n) half-ulps along the
# carry chain, ~1e-5 of the range at these sizes; 1e-4 leaves a 10x margin.
REL_TOL = 1e-4

# TPC-H v3.0.1 at SF 10 (§4.2.3), dates as days since 1992-01-01.
SF = 10
N_ORDERS = 1_500_000 * SF
ORDERDATE_MAX = 2405          # ENDDATE (1998-12-31) - 151 days
CURRENTDATE = 1263            # 1995-06-17
Q6_FROM, Q6_TO = 731, 1096    # [1994-01-01, 1995-01-01)
Q1_SHIP_MAX = 2436            # 1998-12-01 - 90 days = 1998-09-02
Q3_DATE = 1169                # 1995-03-15
ROW_GROUP = 1 << 18           # rows of one column-store row group
# zamba2-7b's Mamba2 SSD across-chunk carry for a 131,072-token prefill:
# (B, chunks, H * P * N) (model_cells).
SSD_PREFILL = 131072
# The reference tests' tolerance of a float32 affine scan
# (tests/test_kernels.py::test_ssm_scan_shapes_dtypes).
AFFINE_TOL = 2e-4
# Float sums of the relational phase against float64: float32 rounding
# along a chain of ~10^4 chunk totals stays near 1e-6 relative.
REL_SUM_TOL = 1e-4
# phi3-medium-14b: a batch of 4 decoding against a cache of its
# max_seq_len, and a 4096-token prefill (model_cells).
PHI3_BATCH, PHI3_PREFILL = 4, 4096
# Attention tolerances, (atol, rtol) of an allclose. float32: the reference
# tests' own, carry vs decoupled forward (tests/test_flash_engine.py:99),
# gradients (tests/test_flash_backward.py:102), the fold against dense
# attention (tests/test_flash_engine.py:80); kernel and plain version
# associate their dot products differently. bf16: both sides take the same
# bf16 inputs and compute in float32, so they differ by the last rounding
# to bf16, one ulp (2^-7 of the value at most); the bar is two ulps, with
# an atol for the float32 differences of near-zero sums.
FWD_TOL, GRAD_TOL, DENSE_TOL = (1e-5, 1e-5), (1e-4, 1e-4), (2e-3, 2e-3)
BF16_TOL = (1e-3, 2 ** -6)
# (i) zamba2-7b serving: two prompts of 4096 and 2500 tokens prefilled
# alone into caches of 4352 positions (a multiple of the engine's page of
# 16 tokens), then 16 greedy steps of both. The bound on the relative L2
# error of the prefill's last logits, kernel routes against plain routes
# (PERF.md §4): both round bf16 activations alike and differ by the
# float32 association inside attention and the SSD carry, one bf16
# rounding (2^-9 relative) of each differing output, a random walk over
# the 81 layers' residual additions, about four such outputs a layer:
# sqrt(81 x 4) x 2^-9 = 0.035. The card reads 0.038 at seed 0; the bound
# 2^-4 leaves a margin of 1.6 over it. A fault in one layer's kernel call
# moves these logits by little more than that noise
# (tools/serve_fault_l2.py), so the phase also holds every kernel call of
# the prefill against its plain version.
SERVE_PROMPTS, SERVE_MAX_LEN, SERVE_PAGE, SERVE_STEPS = (4096, 2500), 4352, \
    16, 16
SERVE_L2_BOUND = 2.0 ** -4
# (j) zamba2-7b training: 6 layers (two periods) at full width, two
# sequences of 4096 tokens a step in two microbatches, four steps. The
# bounds on the kernel routes against the plain routes at step 0 (PERF.md
# §4): both round the same bf16 activations and gradients at the same
# places and differ by the float32 association inside attention (flash
# against blockwise) and the SSD carry (kernel against chunked), one bf16
# rounding (2^-9 relative) of each differing output, a random walk over
# about four such outputs a layer forward and four backward in 6 layers:
# sqrt(6 x 4 x 2) x 2^-9 = 0.0135 for the gradients' relative L2 (all
# leaves concatenated); the bound 2^-4 leaves a margin of 4.6. The loss,
# a mean over 8192 tokens of the logits' cross-entropy, moves by at most
# the forward's half of that walk, sqrt(6 x 4) x 2^-9 = 0.0096 relative;
# the bound 2^-6 leaves 1.6.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = \
    6, 4096, 2, 2, 4
TRAIN_L2_BOUND, TRAIN_LOSS_BOUND = 2.0 ** -4, 2.0 ** -6
ATTN_REPLACES = {
    "carry": "src/repro/kernels/scan_engine/schedules.py:722",
    "split": "src/repro/kernels/scan_engine/schedules.py:778",
    "chain": "src/repro/kernels/scan_engine/schedules.py:631",
}


class SmokeFailure(AssertionError):
    pass


def spilled(line):
    """Whether a ptxas "N bytes spill stores, M bytes spill loads" line
    reports a spill (a test for the whole numbers: "40 bytes spill stores"
    contains "0 bytes spill stores")."""
    found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
    return bool(found) and (int(found[1]) > 0 or int(found[2]) > 0)


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def rate(table, name):
    for key, value in table.items():
        if key in name:
            return value
    raise SmokeFailure(f"no data-sheet rate for {name!r}")


def model_cells():
    """The (e)-(h) cells' widths, from ``repro_torch.configs``: zamba2-7b's
    SSD carry (ssm_heads 112 x ssm_head_dim 64 x ssm_state 64 channels,
    ssm_chunk 128), gemma2-9b's attention (16 q / 8 kv heads of 256, logit
    softcap 50, local layers' window 4096, at a training sequence of its
    max_seq_len 8192) and phi3-medium-14b's (40 q / 10 kv heads of 128, no
    softcap or window, a cache of its max_seq_len 131,072)."""
    from repro_torch import configs
    z = configs.get_config("zamba2-7b")
    g = configs.get_config("gemma2-9b")
    p = configs.get_config("phi3-medium-14b")
    ssd = (1, SSD_PREFILL // z.ssm_chunk,
           z.ssm_heads * z.ssm_head_dim * z.ssm_state)
    gemma = dict(hq=g.num_heads, hkv=g.num_kv_heads, d=g.head_dim,
                 softcap=g.attn_softcap, window=g.sliding_window,
                 t=g.max_seq_len)
    phi3 = dict(hq=p.num_heads, hkv=p.num_kv_heads, d=p.head_dim,
                batch=PHI3_BATCH, cache=p.max_seq_len, prefill=PHI3_PREFILL)
    return ssd, gemma, phi3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    # float32 products in full float32 everywhere (the plain versions'
    # torch.matmul included), before any check
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 must be off")

    from repro_torch import relational as rel
    from repro_torch.core.scan import api, assoc, policy
    from repro_torch.kernels.compact import ops as kc_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.flash_attention import (
        backward_folds, flash_attention_bwd_kernel, flash_attention_kernel,
        forward_fold)
    from repro_torch.kernels.scan_engine import (Channels, Rows, cuda,
                                                 cuda_fold, monoids,
                                                 schedules)
    from repro_torch.kernels.segscan import ops as seg_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.obs import trace
    from repro_torch.relational import compact as rel_compact
    from repro_torch.relational import groupby as rel_groupby
    from repro_torch.relational.partition import apply_plan

    SSD_SHAPE, GEMMA, PHI3 = model_cells()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    bw, f32_peak = rate(MEM_RATE, name), rate(F32_RATE, name)
    bf16_peak, tf32_peak = rate(BF16_RATE, name), rate(TF32_RATE, name)
    SUM, SEGSUM, AFFINE = monoids.SUM, monoids.SEGMENTED_SUM, monoids.AFFINE

    def sync():
        torch.cuda.synchronize(dev)

    def normals(shape, dtype=torch.float32):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    def randint(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, device=dev, generator=gen,
                             dtype=dtype)

    def bits(t):
        return t.view({4: torch.int32, 2: torch.int16,
                       1: torch.int8}[t.element_size()])

    def same_bits(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and \
            torch.equal(bits(a), bits(b))

    def launched():
        return {k for k, v in cuda.LAUNCHES.items() if v}

    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for item in x for t in flat(item)]

    def all_same_bits(xs, ys):
        xs, ys = flat(xs), flat(ys)
        return len(xs) == len(ys) and all(same_bits(a, b)
                                          for a, b in zip(xs, ys))

    def time_ms(fn, reps, warmup=1):
        for _ in range(warmup):
            fn()
        sync()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def graph_ms(fn, calls=20, reps=5):
        """The device time of one call of fn, replayed from a CUDA graph
        that holds ``calls`` calls back to back: no host launch cost in
        it (a single call's CUDA events also bracket the wrapper's host
        time, which is most of a kernel of a few microseconds). None, with
        the reason printed, where fn cannot be captured."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                for _ in range(calls):
                    fn()
        except RuntimeError as e:
            print(f"  graph capture failed: {str(e).splitlines()[0]}")
            return None
        return time_ms(graph.replay, reps) / calls

    def wall_ms(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def bound_ms(nbytes, ops):
        t_bytes, t_ops = nbytes / bw * 1e3, ops / f32_peak * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")

    def close_to_f64(y, x, what, axis=-1):
        ref = torch.cumsum(x.double(), dim=axis)
        check(y.shape == x.shape and y.dtype == x.dtype, f"{what}: shape")
        check(bool(torch.isfinite(y).all()), f"{what}: non-finite output")
        err = (y.double() - ref).abs().max().item()
        tol = REL_TOL * ref.abs().max().item()
        check(err <= tol, f"{what}: max err {err} > tol {tol}")
        return err

    def rel_err(got, want):
        got, want = got.double(), want.double()
        return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()

    # -- 1. environment and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    try:   # the dependent-combine floor of the float chains (phase 5)
        sm_hz = float(clk.stdout.strip().splitlines()[0]) * 1e6
    except ValueError:
        sm_hz = None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  SMs {sms}")
    nvcc = subprocess.run([cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    builds = (cuda.build, cuda_fold.build, cuda_fold.build_tc)
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc per source
        for fut in [pool.submit(b) for b in builds]:
            fut.result()
    sources = (cuda.SOURCE, cuda_fold.SOURCE, cuda_fold.TC_SOURCE)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          + ", ".join(os.path.relpath(src, ROOT) for src in sources)
          + " (in parallel)")
    logs = (cuda.build_log, cuda_fold.build_log, cuda_fold.build_log_tc)
    for src, log in zip(sources, logs):
        log = log.splitlines()
        regs = [int(line.split("Used")[1].split("registers")[0])
                for line in log if "Used" in line and "registers" in line]
        spills = sum(spilled(line) for line in log)
        if regs:
            print(f"  ptxas {src.name}: {len(regs)} kernels, "
                  f"{min(regs)}-{max(regs)} registers, {spills} with spills")
    # the totals reduction of the sum, the segmented sum and the mask, by
    # spec: registers, spills
    entry, red, red_spills = None, [], 0
    for line in cuda.build_log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"totals_reduce_kernelI(.+?)EEv\w*?7Tensors",
                              line)
            entry = found and re.sub(r"NS_\d+|E+$", "", found[1])
        elif entry and "spill stores" in line:
            red_spills += spilled(line)
        elif entry and "Used" in line and "registers" in line:
            red.append(f"{entry} "
                       f"{line.split('Used')[1].split('registers')[0].strip()}")
            entry = None
    if red:   # a cached build in build/ prints no report
        print(f"  ptxas totals_reduce_kernel registers: {', '.join(red)}; "
              f"{red_spills} with spills")
        check(len(red) == 13 and red_spills == 0,
              f"ptxas: totals_reduce_kernel {red}, {red_spills} spill")
    # the register network (carry_reg_kernel, apply_reg_kernel,
    # fused_reg_kernel, tree_reg_kernel) by spec and vector form (1: vector
    # accesses): registers, then stack frame and spill bytes where not 0
    entry, regk, reg_spills, frame = None, [], [], ""
    for line in cuda.build_log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(
                r"(carry|apply|fused|tree)_reg_kernelI(.+?)ELb([01])E+v", line)
            if found:
                spec_of = re.sub(r"NS_\d+|E+$", "", found[2])
                entry = f"{found[1]}<{spec_of}, {found[3]}>"
            else:
                entry = None
        elif entry and "spill stores" in line:
            if spilled(line):
                reg_spills.append(entry)
            frame = "" if line.strip().startswith("0 bytes stack frame, 0 "
                                                  "bytes spill stores, 0 "
                                                  "bytes spill loads") \
                else f" ({line.strip()})"
        elif entry and "Used" in line and "registers" in line:
            regk.append(f"{entry} "
                        f"{line.split('Used')[1].split('registers')[0].strip()}"
                        f"{frame}")
            entry, frame = None, ""
    if regk:   # a cached build in build/ prints no report
        print(f"  ptxas register network ({len(regk)} kernels): "
              f"{', '.join(regk)}; with spills: {reg_spills or 'none'}")
        check(len(regk) == 104 and not reg_spills,
              f"ptxas: register network {len(regk)} kernels, spills in "
              f"{reg_spills}")
    # the affine carry, apply, fused and tree on Channels in registers
    # (carry_chan_reg_kernel, apply_chan_reg_kernel, fused_chan_reg_kernel,
    # tree_chan_reg_kernel) by dtype, slots a lane (bt / 32) and vector
    # form, and the affine totals there (totals_chan_reduce_kernel) by
    # dtype, tile and channels a thread: registers, spills; the carry also
    # at bt 8, 16, 24 and 32, a thread a channel (one vector form: twelve
    # more kernels, the tile after the vector form)
    for kname, form, count in (
            ("carry_chan_reg_kernel", "dtype, bt / 32, vector form, bt",
             30),
            ("apply_chan_reg_kernel", "dtype, bt / 32, vector form", 18),
            ("fused_chan_reg_kernel", "dtype, bt / 32, vector form", 18),
            ("tree_chan_reg_kernel", "dtype, bt / 32, vector form", 18),
            ("totals_chan_reduce_kernel", "dtype, bt, channels a thread",
             18)):
        entry, chan, chan_spills = None, [], []
        for line in cuda.build_log.splitlines():
            if "Compiling entry function" in line:
                found = re.search(kname + r"I(f|13__nv_bfloat16|"
                                  r"6__half)Li(\d+)EL[bi](\d+)E(?:Li(\d+)E)?",
                                  line)
                dt = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}
                entry = found and "<" + ", ".join(
                    [dt[found[1]], found[2], found[3]]
                    + ([found[4]] if found[4] else [])) + ">"
            elif entry and "spill stores" in line:
                if spilled(line):
                    chan_spills.append(entry)
            elif entry and "Used" in line and "registers" in line:
                used = line.split('Used')[1].split('registers')[0].strip()
                chan.append(f"{entry} {used}")
                entry = None
        if chan:   # a cached build in build/ prints no report
            print(f"  ptxas {kname} ({len(chan)} kernels: {form}): "
                  f"{', '.join(chan)}; with spills: {chan_spills or 'none'}")
            check(len(chan) == count and not chan_spills,
                  f"ptxas: {kname} {len(chan)} kernels, spills in "
                  f"{chan_spills}")
    # the tensor-core forms, kernel by kernel: registers, stack, spills
    entry, tc_spills, tc_entries = None, 0, []
    for line in cuda_fold.build_log_tc.splitlines():
        if "Compiling entry function" in line:
            # _ZN..fold_fwd_tc_kernelILi128ELi2EEEv.. -> fold_fwd_tc_kernel<128, 2>
            found = re.search(r"\d(fold_[a-z0-9_]+?_kernel)I(.*?)EEv", line)
            entry = found and (found[1] + "<" + ", ".join(
                re.findall(r"Li(\d+)E", found[2] + "E")) + ">")
        elif entry and "spill stores" in line:
            stack = line.strip()
            tc_spills += spilled(line)
        elif entry and "Used" in line and "registers" in line:
            print(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}; "
                  f"{stack}")
            tc_entries.append(entry)
            entry = None
    print(f"  tensor-core forms' shared memory (cuda_fold.tc_tiling): "
          + ", ".join(f"{form} d={d} bq={bq}: "
                      f"{cuda_fold.tc_tiling(form, d, bq)['smem']} B"
                      for form, d, bq in (
                          ("fold_fwd_tc", 64, 128), ("fold_fwd_tc", 128, 128),
                          ("fold_fwd_tc", 128, 8), ("fold_fwd_tc", 256, 128),
                          ("fold_dq_tc", 64, 128), ("fold_dq_tc", 128, 128),
                          ("fold_dq_tc", 256, 128),
                          ("fold_dkv_tc", 128, 128),
                          ("fold_dkv_tc", 256, 128),
                          ("fold_fwd_tf32", 64, 128),
                          ("fold_fwd_tf32", 128, 128),
                          ("fold_fwd_tf32", 256, 128),
                          ("fold_dq_tf32", 64, 128),
                          ("fold_dq_tf32", 128, 128),
                          ("fold_dq_tf32", 256, 128),
                          ("fold_dkv_tf32", 64, 128),
                          ("fold_dkv_tf32", 128, 128),
                          ("fold_dkv_tf32", 256, 128))))
    check(tc_spills == 0, f"ptxas: {tc_spills} tensor-core kernels spill")
    dq_entries = sorted(e for e in tc_entries if e.startswith("fold_dq_tc"))
    if tc_entries:   # a cached build in build/ prints no report
        check(dq_entries == ["fold_dq_tc_kernel<128>",
                             "fold_dq_tc_kernel<256>",
                             "fold_dq_tc_kernel<64>"],
              f"ptxas reported fold_dq_tc as {dq_entries}")
        tf32_entries = sorted(e for e in tc_entries if "_tf32_" in e)
        check(tf32_entries == ["fold_dkv_tf32_kernel<128>",
                               "fold_dkv_tf32_kernel<256>",
                               "fold_dkv_tf32_kernel<64>",
                               "fold_dq_tf32_kernel<128>",
                               "fold_dq_tf32_kernel<256>",
                               "fold_dq_tf32_kernel<64>",
                               "fold_fwd_tf32_kernel<128>",
                               "fold_fwd_tf32_kernel<256>",
                               "fold_fwd_tf32_kernel<64>"],
              f"ptxas reported the 3xTF32 forms as {tf32_entries}")
        print(f"  ptxas: {len(tc_entries)} tensor-core kernels, "
              f"{', '.join(dq_entries + tf32_entries)} among them, none "
              "spills")
    # the two chains (chain_chan_kernel, fold_chain_softmax_kernel):
    # registers of each instantiation, and no spill
    for kname, log in (("chain_chan_kernel", cuda.build_log),
                       ("fold_chain_softmax_kernel", cuda_fold.build_log)):
        entry, used, spills = None, [], 0
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = kname in line
            elif entry and "spill stores" in line:
                spills += spilled(line)
            elif entry and "Used" in line and "registers" in line:
                used.append(int(line.split("Used")[1].split("registers")[0]))
                entry = None
        if used:   # a cached build prints no report
            print(f"  ptxas {kname}: {len(used)} kernels, "
                  f"{min(used)}-{max(used)} registers, {spills} with spills")
            check(spills == 0, f"ptxas: {kname} spills")

    # -- 2. every kernel vs its plain version, bitwise ---------------------
    kernel = {"carry": schedules.scan_carry,
              "decoupled": schedules.scan_decoupled,
              "fused": schedules.scan_fused, "tree": schedules.scan_tree}
    plain = schedules.PLAIN
    grid = ((3, 517), (64, 1 << 18), (1, 1 << 24))

    def blocks(n):
        # the blocks the wrappers tile with: min(block_n, round_up(n, 128))
        return sorted({min(b, -(-n // 128) * 128)
                       for b in (512, 2048, 8192, 16384)})

    n_checks = 0
    for rows, n in grid:
        for bn in blocks(n):
            pad = (-n) % bn
            for dtype in (torch.float32, torch.bfloat16, torch.int32):
                if dtype == torch.int32:
                    x = randint(-9, 9, (rows, n), dtype)
                else:
                    x = normals((rows, n), dtype)
                x = F.pad(x, (0, pad)).contiguous()
                lay = Rows(rows, n + pad, 1, bn)
                for exclusive in (False, True):
                    got = {}
                    for s in SCHEDULES:
                        cuda.reset_launches()
                        (got[s],) = kernel[s]((x,), SUM, lay,
                                              exclusive=exclusive)
                        sync()
                        check(launched() == set(USES[s]),
                              f"{s} launched {launched()}")
                        (want,) = plain[s]((x,), SUM, lay, exclusive)
                        check(same_bits(got[s], want),
                              f"kernel != plain: {s} excl={exclusive} "
                              f"{dtype} ({rows}, {n}) bn={bn}")
                        n_checks += 1
                    check(same_bits(got["fused"], got["decoupled"])
                          and same_bits(got["fused"], got["carry"]),
                          f"fused != decoupled / carry: excl={exclusive} "
                          f"{dtype} ({rows}, {n}) bn={bn}")
            print(f"sum kernel == plain bitwise, carry == decoupled == "
                  f"fused: ({rows}, {n}) bn={bn} x 3 dtypes x 4 schedules "
                  "x 2 modes")
    print(f"phase 2 (sum): {n_checks} kernel-vs-plain checks, all bitwise "
          "equal")

    def spec_sweep(spec, operands, lay, what, exclusive=False):
        """Each schedule's kernel vs its plain version (outputs and running
        totals: fused with running totals runs decoupled), the fused
        kernel without them, and carry == decoupled == fused; returns the
        schedule runs."""
        results = {}
        for s in SCHEDULES:
            cuda.reset_launches()
            outs, tot = kernel[s](operands, spec, lay, exclusive=exclusive,
                                  return_totals=True)
            sync()
            uses = USES["decoupled" if s == "fused" else s]
            check(launched() == {cuda.kernel_name(spec.name, k)
                                 for k in uses},
                  f"{spec.name} {s} launched {launched()}")
            w_outs, w_tot = plain[s](operands, spec, lay, exclusive,
                                     return_totals=True)
            check(all_same_bits(outs, w_outs) and all_same_bits(tot, w_tot),
                  f"{spec.name} kernel != plain: {s} {what}")
            results[s] = outs + tot
        for s in ("decoupled", "fused"):
            check(all_same_bits(results[s], results["carry"]),
                  f"{spec.name} {s} != carry bitwise: {what}")
        cuda.reset_launches()
        fo = kernel["fused"](operands, spec, lay, exclusive=exclusive)
        sync()
        check(launched() == {cuda.kernel_name(spec.name, "fused")},
              f"{spec.name} fused launched {launched()}")
        check(all_same_bits(fo, plain["fused"](operands, spec, lay,
                                                exclusive))
              and all_same_bits(fo, results["carry"][:1]),
              f"{spec.name} fused kernel != plain / carry: {what}")
        return len(SCHEDULES) + 1

    n_seg = n_mask = 0
    for rows, n in grid:
        for bn in blocks(n):
            pad = (-n) % bn
            lay = Rows(rows, n + pad, 1, bn)
            # engine-level flags: nonzero values other than 1 (negative,
            # 2) must act as boundaries too
            fl = randint(0, 100, (rows, n))
            fl = torch.where(fl == 0, -3, torch.where(fl == 1, 2, 0))
            fl = F.pad(fl.to(torch.int32), (0, pad)).contiguous()
            for dtype in (torch.float32, torch.bfloat16, torch.int32):
                if dtype == torch.int32:
                    x = randint(-9, 9, (rows, n), dtype)
                else:
                    x = normals((rows, n), dtype)
                x = F.pad(x, (0, pad)).contiguous()
                n_seg += spec_sweep(SEGSUM, (x, fl), lay,
                                    f"{dtype} ({rows}, {n}) bn={bn}")
            m = F.pad((randint(0, 2, (rows, n))), (0, pad)).contiguous()
            n_mask += spec_sweep(monoids.mask(n + pad), (m,), lay,
                                 f"({rows}, {n}) bn={bn}")
            print(f"segsum (3 dtypes) and mask kernels == plain bitwise, "
                  f"carry == decoupled == fused: ({rows}, {n}) bn={bn}")
    v8 = torch.ones(8, device=dev)
    for flags in ([0, 0, 0.5, 0, 0.5, 0, 0, 0], [0, 0, -1, 0, -3, 0, 0, 0],
                  [-2, 0, 0, 0.25, 0, 0, 0, 7]):
        ft = torch.tensor(flags, device=dev)
        for s in SCHEDULES:
            got = seg_ops.segmented_cumsum(v8, ft, schedule=s)
            want = seg_ops.segmented_cumsum(v8.cpu(), ft.cpu(), schedule=s)
            check(torch.equal(got.cpu(), want),
                  f"messy flags {flags} under {s}: {got.tolist()}")
    print(f"phase 2 (segsum, mask): {n_seg} + {n_mask} schedule runs, "
          "outputs and running totals bitwise equal to the plain versions; "
          "messy flags (negative, fractional, leading) equal to the CPU")

    def offset_view(t, offset):
        """A copy of t whose base lies ``offset`` elements past an
        aligned allocation."""
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
        view = buf[offset:].view(t.shape)
        view.copy_(t)
        return view

    # the Rows totals of the sum, the segmented sum and the mask
    # (totals_reduce_kernel): bitwise against the network's last element
    # and its tree, every dtype, signed zeros at tile starts, cancelling
    # pairs and subnormals, the segmented sum's flags sparse (negative and
    # non-unit among them) with one on every tile's first and last element,
    # or dense, and against the network's totals_kernel
    # (network="shared"), from an aligned base and one element off (a
    # generator of its own, so the later phases' data stay as they were)
    g_red = torch.Generator(device=dev)
    g_red.manual_seed(args.seed + 1)
    n_red = 0
    dtypes = ("float32", "bfloat16", "float16", "int32", "int16", "int8")
    for bn in (128, 200, 384, 2048, 2176, 16384):
        n = -(-(1 << 20) // bn) * bn
        for kind in dtypes + ("mask",) + tuple(
                f"segsum-{f}-{d}" for d in dtypes for f in ("ends", "dense")):
            dt = getattr(torch, kind.split("-")[-1]) if kind != "mask" \
                else torch.int32
            if kind == "mask":
                x = torch.randint(0, 2, (1, n), device=dev, generator=g_red,
                                  dtype=torch.int32)
            elif not dt.is_floating_point:
                info = torch.iinfo(dt)
                x = torch.randint(info.min, info.max + 1, (1, n), device=dev,
                                  generator=g_red).to(dt)
            else:
                x = torch.randn((1, n), device=dev, generator=g_red) * 4
                x[:, 1::97] = 1e-40 if dt != torch.float16 else 1e-6
                x[:, 5::89] = 3e4
                x[:, 6::89] = -3e4
                x[:, ::bn] = -0.0
                x[:, bn::2 * bn] = 0.0
                x[:, :bn] = -0.0
                x = x.to(dt)
            ops_r = (x,)
            spec = monoids.mask(n) if kind == "mask" else SUM
            if kind.startswith("segsum"):
                spec, r = SEGSUM, torch.rand((1, n), device=dev,
                                             generator=g_red)
                if "dense" in kind:
                    fl = torch.where(r < 0.25, -3, torch.where(r < 0.5, 1, 0))
                else:
                    fl = torch.where(r < 0.005, -3,
                                     torch.where(r < 0.01, 2, 0))
                    fl[:, ::bn] = 1
                    fl[:, bn - 1::bn] = 7
                ops_r = (x, fl.to(torch.int32))
            lay = Rows(1, n, 1, bn)
            want = schedules.totals_plain(ops_r, spec, lay)
            tree = schedules.totals_tree_plain(ops_r, spec, lay)
            check(all_same_bits(tree, want), f"totals_tree_plain != "
                  f"totals_plain: {kind} bn={bn}")
            for offset in (0, 1):
                ops_o = tuple(offset_view(o, offset) for o in ops_r)
                cuda.reset_launches()
                got = cuda.totals(spec, ops_o, lay)
                sync()
                check(launched() == {cuda.kernel_name(spec.name, "totals")},
                      f"{kind} totals launched {launched()}")
                check(all_same_bits(got, want), f"totals_reduce_kernel != "
                      f"totals_plain: {kind} bn={bn} offset {offset}")
                if spec is SEGSUM:
                    check(all_same_bits(got, cuda.totals(
                        spec, ops_o, lay, network="shared")),
                        f"totals_reduce_kernel != shared totals_kernel: "
                        f"{kind} bn={bn} offset {offset}")
                n_red += 1
            del x, ops_r, ops_o, want, tree, got
    print(f"phase 2 (totals_reduce_kernel): {n_red} launches (bn 128, 200, "
          "384, 2048, 2176, 16384 x 6 sum dtypes, the mask and the "
          "segmented sum in 6 dtypes x 2 flag patterns x base aligned / one "
          "element off) bitwise equal to totals_plain and totals_tree_plain, "
          "the segmented sum's to the shared totals_kernel too")
    # which kernel each spec's totals launch, by the profiler's names
    ones = torch.ones((2, 4096), device=dev)
    zeros_i = torch.zeros((2, 4096), dtype=torch.int32, device=dev)
    chan = Channels(2, 1024, 8, 256, 8)
    ones_c = torch.ones(chan.shape, device=dev)
    for spec, ops, lay, want in (
            (SUM, (ones,), Rows(2, 4096, 1, 2048), "totals_reduce_kernel"),
            (SUM, (zeros_i.to(torch.int8),), Rows(2, 4096, 1, 2048),
             "totals_reduce_kernel"),
            (monoids.mask(4096), (zeros_i,), Rows(2, 4096, 1, 2048),
             "totals_reduce_kernel"),
            (SEGSUM, (ones, zeros_i), Rows(2, 4096, 1, 2048),
             "totals_reduce_kernel"),
            (SEGSUM, (ones[:, :600].contiguous(),
                      zeros_i[:, :600].contiguous()), Rows(2, 600, 1, 200),
             "totals_reduce_kernel"),
            (SUM, (ones_c,), chan, "totals_kernel"),
            (AFFINE, (ones_c, ones_c), Channels(2, 1024, 8, 128, 8),
             "totals_chan_reduce_kernel"),
            (AFFINE, (ones_c, ones_c), chan, "totals_chan_reduce_kernel"),
            (AFFINE, (ones_c, ones_c), Channels(2, 1024, 8, 512, 8),
             "totals_chan_reduce_kernel"),
            (AFFINE, (ones_c, ones_c), Channels(2, 1024, 8, 64, 8),
             "totals_kernel"),
            (AFFINE, (ones, ones), Rows(2, 4096, 1, 2048), "totals_kernel")):
        # the window opens with a kernel that is not counted, and one that
        # recorded no totals kernel is taken again, three times at most, as
        # launched_names does (this is the run's first profiler window, and
        # the first launch after the profiler starts has gone unrecorded)
        for _ in range(3):
            sync()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.ones(1, device=dev).add_(1)
                sync()
                cuda.totals(spec, ops, lay)
                sync()
            names = [e.key for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "totals" in e.key]
            if names:
                break
        check(len(names) == 1 and want + "<" in names[0],
              f"{spec.name} {type(lay).__name__} totals launched {names}")
        check(cuda.tile_network(spec, lay, "totals") == (
            "shared" if want == "totals_kernel" else "register"),
            f"tile_network totals {spec.name} {lay}")
    print("totals kernels by the profiler: sum (f32, int8), segsum (bn 2048, "
          "200) and mask on Rows -> totals_reduce_kernel; affine on Channels "
          "bt 128, 256, 512 -> totals_chan_reduce_kernel; sum on Channels, "
          "affine on Channels bt 64 and on Rows -> totals_kernel")

    # carry, apply, fused and tree on Rows: the register network
    # (carry_reg_kernel, apply_reg_kernel, fused_reg_kernel,
    # tree_reg_kernel) on every tile of 128 r elements, bitwise against
    # carry_plain / fused_plain / tree_plain (outputs and carry's and
    # tree's running totals) and decoupled (totals, chain and
    # apply_reg_kernel) == carry == fused, inclusive and exclusive, from an
    # aligned base and one element off, on data with a signed zero at every
    # segment start, a first tile of -0.0, subnormals and cancelling pairs
    # (g_red's generator); the profiler's kernel names show which network
    # each (spec, block_n) launched
    def reg_operands(kind, n, bn):
        if kind == "mask":
            return monoids.mask(n), (torch.randint(
                0, 2, (2, n), device=dev, generator=g_red, dtype=torch.int32),)
        dt = getattr(torch, kind.split("-")[-1])
        if not dt.is_floating_point:
            info = torch.iinfo(dt)
            x = torch.randint(info.min, info.max + 1, (2, n), device=dev,
                              generator=g_red).to(dt)
        else:
            x = torch.randn((2, n), device=dev, generator=g_red) * 4
            x[:, 1::97] = 1e-40 if dt != torch.float16 else 1e-6
            x[:, 5::89] = 3e4
            x[:, 6::89] = -3e4
            x[:, ::128] = -0.0
            x[:, bn::2 * bn] = 0.0
            x[:, :bn] = -0.0
            x = x.to(dt)
        if not kind.startswith("segsum"):
            return SUM, (x,)
        fl = torch.randint(0, 100, (2, n), device=dev, generator=g_red)
        fl = torch.where(fl == 0, -3, torch.where(fl == 1, 2, 0))
        return SEGSUM, (x, fl.to(torch.int32))

    NET_KERNELS = ("carry", "apply", "fused", "tree")

    def launched_names(calls):
        """The carry, apply, fused and tree kernels the calls launch (apply
        through decoupled), by the profiler: {kernel: its launches}. The
        window opens with a kernel that is not counted (the first launch
        after the profiler starts went unrecorded at block_n 128, three
        profiles in a row); a profile that recorded fewer launches than
        the calls made (CUPTI drops a record now and then) is taken
        again, three times at most."""
        for _ in range(3):
            sync()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.ones(1, device=dev).add_(1)
                sync()
                for spec, ops_, lay in calls:
                    cuda.carry(spec, ops_, lay)
                    cuda.fused(spec, ops_, lay)
                    schedules.scan_decoupled(ops_, spec, lay)
                    cuda.tree(spec, ops_, lay)
                sync()
            names = {}
            for e in prof.key_averages():
                found = re.search(
                    r"((carry_chan|apply_chan|fused_chan|tree_chan|carry|"
                    r"apply|fused|tree)(_reg)?_kernel)<", e.key)
                if e.device_type == torch.autograd.DeviceType.CUDA and found:
                    names[found[1]] = names.get(found[1], 0) + e.count
            if sum(names.values()) >= len(NET_KERNELS) * len(calls):
                break
        return names

    n_reg = 0
    reg_kinds = ("float32", "bfloat16", "float16", "int32", "int16", "int8",
                 "segsum-float32", "segsum-bfloat16", "segsum-int32", "mask")
    for bn in (128, 2048, 2176, 16384):
        n = -(-(1 << 18) // bn) * bn
        lay = Rows(2, n, 1, bn)
        check(all(cuda.tile_network(SUM, lay, k) == "register"
                  for k in ("carry", "apply", "fused", "tree")),
              f"tile_network at bn={bn}")
        calls = []
        for kind in reg_kinds:
            spec, ops_r = reg_operands(kind, n, bn)
            calls.append((spec, ops_r, lay))
            what = f"{kind} bn={bn}"
            for exclusive in ((False, True) if spec.supports_exclusive
                              else (False,)):
                (w_out,), w_run = schedules.carry_plain(
                    ops_r, spec, lay, exclusive, return_totals=True)
                (w_fused,) = schedules.fused_plain(ops_r, spec, lay,
                                                   exclusive)
                (w_tree,), w_trun = schedules.tree_plain(
                    ops_r, spec, lay, exclusive, return_totals=True)
                for offset in (0, 1):
                    ops_o = tuple(offset_view(o, offset) for o in ops_r)
                    cuda.reset_launches()
                    (got,), run = cuda.carry(spec, ops_o, lay, exclusive, True)
                    (fo,) = cuda.fused(spec, ops_o, lay, exclusive)
                    (tr,), trun = cuda.tree(spec, ops_o, lay, exclusive, True)
                    sync()
                    check(launched() == {cuda.kernel_name(spec.name, k)
                                         for k in ("carry", "fused", "tree")},
                          f"register network {what} launched {launched()}")
                    cuda.reset_launches()
                    (dec,) = schedules.scan_decoupled(ops_o, spec, lay,
                                                      exclusive=exclusive)
                    sync()
                    check(launched() == {cuda.kernel_name(spec.name, k)
                                         for k in USES["decoupled"]},
                          f"decoupled {what} launched {launched()}")
                    mode = f"{what} excl={exclusive} offset {offset}"
                    check(same_bits(got, w_out)
                          and all_same_bits(run, w_run),
                          f"carry_reg_kernel != carry_plain: {mode}")
                    check(same_bits(fo, w_fused),
                          f"fused_reg_kernel != fused_plain: {mode}")
                    check(same_bits(dec, got) and same_bits(fo, got),
                          f"carry / decoupled (apply_reg_kernel) / fused "
                          f"differ: {mode}")
                    check(same_bits(tr, w_tree)
                          and all_same_bits(trun, w_trun),
                          f"tree_reg_kernel != tree_plain: {mode}")
                    n_reg += 1
                    del ops_o, got, run, fo, dec, tr, trun
            del ops_r, w_out, w_run, w_fused, w_tree, w_trun
        names = launched_names(calls)
        want = {f"{k}_reg_kernel": len(reg_kinds) for k in NET_KERNELS}
        check(names == want, f"bn={bn}: carry, apply, fused and tree of the "
              f"{len(calls)} kinds launched {names}, not {want}")
        del calls
        print(f"register network bn={bn}: carry and tree (outputs, running "
              f"totals), fused and decoupled (apply) == plain bitwise, "
              f"carry == decoupled == fused, 6 sum dtypes, segsum (3 "
              f"dtypes), mask; by the profiler {names}")
    # the shared-memory kernels: Rows tiles of 200 elements bitwise against
    # the plain versions (every schedule), and by the profiler's names with
    # Channels (the affine pair's kernels are held bitwise below): every
    # Channels launch but the affine carry, apply, fused and tree, which
    # take carry_chan_reg_kernel, apply_chan_reg_kernel,
    # fused_chan_reg_kernel and tree_chan_reg_kernel
    calls = ((SUM, (ones[:, :600].contiguous(),), Rows(2, 600, 1, 200)),
             (SEGSUM, (ones[:, :600].contiguous(),
                       zeros_i[:, :600].contiguous()), Rows(2, 600, 1, 200)),
             (SUM, (ones_c,), chan), (AFFINE, (ones_c, ones_c), chan))
    for spec, _, lay in calls:
        for k in NET_KERNELS:
            net = "register" if spec is AFFINE else "shared"
            check(cuda.tile_network(spec, lay, k) == net,
                  f"tile_network {spec.name} {lay} {k}")
    lay200 = Rows(2, 600, 1, 200)
    for exclusive in (False, True):
        x200 = torch.randn((2, 600), device=dev, generator=g_red)
        x200[:, ::200] = -0.0
        f200 = (torch.rand((2, 600), device=dev, generator=g_red)
                < 0.05).to(torch.int32)
        n_reg += spec_sweep(SUM, (x200,), lay200, f"bn 200 excl={exclusive}",
                            exclusive)
        n_reg += spec_sweep(SEGSUM, (x200, f200), lay200,
                            f"bn 200 excl={exclusive}", exclusive)
    names = launched_names(calls)
    want = {f"{k}_kernel": len(calls) for k in NET_KERNELS}
    want.update(carry_kernel=len(calls) - 1, carry_chan_reg_kernel=1,
                apply_kernel=len(calls) - 1, apply_chan_reg_kernel=1,
                fused_kernel=len(calls) - 1, fused_chan_reg_kernel=1,
                tree_kernel=len(calls) - 1, tree_chan_reg_kernel=1)
    check(names == want, f"bn 200 and Channels launched {names}, not {want}")
    print(f"phase 2 (register network): {n_reg} checks (carry + fused + "
          "tree + decoupled launch sets at bn 128, 2048, 2176, 16384, "
          "aligned and one element off; every schedule at bn 200) bitwise "
          "equal to the plain versions, carry == decoupled == fused; by the "
          "profiler, bn 200 on Rows (sum, segsum) and Channels (sum, affine) "
          "launch carry_kernel / apply_kernel / fused_kernel / tree_kernel "
          "(the networks in shared memory), but the affine carry, apply, "
          "fused and tree on Channels, carry_chan_reg_kernel, "
          "apply_chan_reg_kernel, fused_chan_reg_kernel and "
          "tree_chan_reg_kernel")
    del ones, zeros_i, ones_c

    n_aff = 0
    for shape, bt in (((2, 4096, 48), 64), ((1, 8192, 1024), 256),
                      ((1, 2048, 40), 2048), ((3, 8192, 64), 8192)):
        lay = Channels(*shape, bt, shape[2])
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            a = (0.7 + 0.3 * torch.rand(shape, device=dev,
                                        generator=gen)).to(dtype)
            b = normals(shape, dtype)
            for exclusive in (False, True):
                n_aff += spec_sweep(AFFINE, (a, b), lay,
                                    f"{dtype} {shape} bt={bt} "
                                    f"excl={exclusive}", exclusive)
        print(f"affine kernels == plain bitwise (3 dtypes, 2 modes), carry "
              f"== decoupled == fused: {shape} bt={bt}, "
              f"{cuda.channel_width(lay)}-channel strips")
    print(f"phase 2 (affine): {n_aff} schedule runs, outputs and running "
          "totals bitwise equal to the plain versions")

    # the affine carry, fused, totals, apply and tree on Channels in
    # registers (carry_chan_reg_kernel, fused_chan_reg_kernel,
    # totals_chan_reduce_kernel, apply_chan_reg_kernel,
    # tree_chan_reg_kernel) at time tiles of 128, 256 and 512 steps:
    # outputs and running totals bitwise equal to carry_plain, the totals to
    # totals_plain, totals_tree_plain and the shared totals_kernel, the
    # chain's offsets to exclusive_chain, apply to apply_plain and the
    # shared apply_kernel, and decoupled == carry == fused == the
    # shared-memory fused_kernel launched by name; the tree's outputs and
    # running totals to tree_plain and the shared tree_kernel; inclusive
    # and exclusive, from aligned bases and one element off, on gates with
    # negative and signed-zero values and offsets with -0.0 at every tile
    # start (g_red's generator); the profiler names the kernels
    n_chan = 0
    for bt in cuda.CHAN_REG_TILES:
        for shape in ((2, 8 * bt, 48), (1, 4 * bt, 1024), (1, 2 * bt, 4)):
            lay = Channels(*shape, bt, shape[2])
            check(all(cuda.tile_network(AFFINE, lay, k) == "register"
                      for k in ("carry", "totals", "apply", "fused", "tree")),
                  f"tile_network affine carry / totals / apply / fused / "
                  f"tree {lay}")
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                a = 0.6 + 0.4 * torch.rand(shape, device=dev, generator=g_red)
                a[torch.rand(shape, device=dev, generator=g_red) < 0.05] *= -1
                a[torch.rand(shape, device=dev, generator=g_red) < 0.01] = -0.0
                b = torch.randn(shape, device=dev, generator=g_red)
                b[torch.rand(shape, device=dev, generator=g_red) < 0.05] = -0.0
                b[:, ::bt] = -0.0
                a, b = a.to(dtype), b.to(dtype)
                w_tot = schedules.totals_plain((a, b), AFFINE, lay)
                check(all_same_bits(schedules.totals_tree_plain(
                    (a, b), AFFINE, lay), w_tot),
                    f"totals_tree_plain != totals_plain: {dtype} {shape}")
                w_off = schedules.exclusive_chain(AFFINE, w_tot)
                for exclusive in (False, True):
                    (w_out,), w_run = schedules.carry_plain(
                        (a, b), AFFINE, lay, exclusive, return_totals=True)
                    (w_ap,) = schedules.apply_plain((a, b), w_off, AFFINE,
                                                    lay, exclusive)
                    (w_tr,), w_trun = schedules.tree_plain(
                        (a, b), AFFINE, lay, exclusive, return_totals=True)
                    for offset in (0, 1):
                        ops_o = (offset_view(a, offset),
                                 offset_view(b, offset))
                        what = (f"{dtype} {shape} bt={bt} excl={exclusive} "
                                f"offset {offset}")
                        cuda.reset_launches()
                        (got,), run = cuda.carry(AFFINE, ops_o, lay,
                                                 exclusive, True)
                        (fo,) = cuda.fused(AFFINE, ops_o, lay, exclusive)
                        (dec,) = schedules.scan_decoupled(
                            ops_o, AFFINE, lay, exclusive=exclusive)
                        sync()
                        check(all(cuda.LAUNCHES[f"affine_{k}"] == 1
                                  for k in ("carry", "fused", "totals",
                                            "chain", "apply")),
                              f"affine carry / fused / decoupled {what}: "
                              f"{launched()}")
                        (fs,) = cuda.fused(AFFINE, ops_o, lay, exclusive,
                                           network="shared")
                        tot = cuda.totals(AFFINE, ops_o, lay)
                        tsh = cuda.totals(AFFINE, ops_o, lay,
                                          network="shared")
                        offs, _ = cuda.chain(AFFINE, tot)
                        (ap,) = cuda.apply(AFFINE, ops_o, offs, lay,
                                           exclusive)
                        (ash,) = cuda.apply(AFFINE, ops_o, offs, lay,
                                            exclusive, network="shared")
                        check(all_same_bits(tot, w_tot)
                              and all_same_bits(tsh, w_tot),
                              f"totals_chan_reduce_kernel != totals_plain / "
                              f"shared totals_kernel: {what}")
                        check(all_same_bits(offs, w_off),
                              f"affine chain != exclusive_chain: {what}")
                        check(same_bits(ap, w_ap) and same_bits(ash, ap),
                              f"apply_chan_reg_kernel != apply_plain / "
                              f"shared apply_kernel: {what}")
                        check(same_bits(got, w_out)
                              and all_same_bits(run, w_run),
                              f"carry_chan_reg_kernel != carry_plain: {what}")
                        check(same_bits(fo, got) and same_bits(dec, got)
                              and same_bits(fs, got),
                              f"affine carry / decoupled / fused (register, "
                              f"shared) differ: {what}")
                        cuda.reset_launches()
                        (tr,), trun = cuda.tree(AFFINE, ops_o, lay,
                                                exclusive, True)
                        sync()
                        check(cuda.LAUNCHES["affine_tree"] == 1,
                              f"affine tree {what}: {launched()}")
                        (tsh_o,), tsh_run = cuda.tree(AFFINE, ops_o, lay,
                                                      exclusive, True,
                                                      network="shared")
                        check(same_bits(tr, w_tr)
                              and all_same_bits(trun, w_trun),
                              f"tree_chan_reg_kernel != tree_plain: {what}")
                        check(same_bits(tsh_o, tr)
                              and all_same_bits(tsh_run, trun),
                              f"tree_chan_reg_kernel != shared tree_kernel: "
                              f"{what}")
                        n_chan += 1
                        del ops_o, got, run, fo, dec, fs, tot, tsh, offs, \
                            ap, ash, tr, trun, tsh_o, tsh_run
                    del w_out, w_run, w_ap, w_tr, w_trun
                del w_tot, w_off
        names = launched_names(((AFFINE, (a, b), lay),))
        check(names.get("carry_chan_reg_kernel") == 1
              and names.get("apply_chan_reg_kernel") == 1
              and names.get("fused_chan_reg_kernel") == 1
              and names.get("tree_chan_reg_kernel") == 1,
              f"affine carry / apply / fused / tree bt={bt} launched {names}")
        widths = [cuda.chan_reg_width(Channels(*sh, bt, sh[2]))
                  for sh in ((2, 8 * bt, 48), (1, 4 * bt, 1024),
                             (1, 2 * bt, 4))]
        print(f"affine carry, apply, fused and tree on Channels bt={bt} "
              "(carry_chan_reg_kernel, apply_chan_reg_kernel, "
              "fused_chan_reg_kernel and tree_chan_reg_kernel by the "
              f"profiler; strips of {widths} channels): == carry_plain "
              "bitwise, carry == decoupled == fused == shared fused_kernel; "
              "totals (totals_chan_reduce_kernel) == totals_plain == "
              "totals_tree_plain == shared totals_kernel, apply == "
              "apply_plain == shared apply_kernel, tree == tree_plain == "
              "shared tree_kernel (outputs, running totals)")
    print(f"phase 2 (affine register carry, fused, totals, apply and tree): "
          f"{n_chan} checks (bt 128, 256, 512 x 3 shapes x 3 dtypes x "
          "inclusive / exclusive x aligned / one element off), outputs and "
          "running totals bitwise equal to carry_plain and tree_plain, "
          "totals, offsets and apply to the plain versions, each to the "
          "shared kernel it replaced")

    # the paper's Observation 5 at the (b) batch: its library oracles,
    # vertical (V1, V2) and tree, beside horizontal and the kernel, on the
    # card (one PyTorch op a step): int32 bitwise against torch.cumsum,
    # float32 within REL_TOL of float64; host clock around one call
    xo = normals((8192, 32768))
    xi = randint(-1000, 1000, (8192, 32768))
    want_i = torch.cumsum(xi, -1, dtype=torch.int32)
    obs5 = []
    for label, kw in (("vertical V1", dict(algorithm="vertical", variant=1)),
                      ("vertical V2", dict(algorithm="vertical", variant=2)),
                      ("tree", dict(algorithm="tree")),
                      ("horizontal", dict(algorithm="horizontal")),
                      ("kernel", dict(algorithm="kernel"))):
        check(same_bits(api.cumsum(xi, **kw), want_i),
              f"(b) int32 {label} != torch.cumsum")
        y, ms = wall_ms(lambda: api.cumsum(xo, **kw))
        check(y.is_cuda, f"(b) {label} left the card")
        err = close_to_f64(y, xo, f"(b) float32 {label}")
        obs5.append(f"{label} {ms:.2f} ms (max err {err:.3g})")
        del y
    del xo, xi, want_i
    torch.cuda.empty_cache()   # the oracles' many small steps' blocks
    print(f"(b) 8192 x 32768, {card}: the oracles on the card, int32 == "
          f"torch.cumsum bitwise, float32 within {REL_TOL} of float64 (of "
          f"the largest prefix); host clock around one call: "
          + "; ".join(obs5))

    # -- 3. the prefix-sum main path, with launch counts -------------------
    na = 1 << 28
    xa = normals((na,))
    xb = normals((8192, 32768))
    ng = 1 << 24
    xg = normals((1, ng)).requires_grad_()
    g = normals((1, ng))
    sched_g = schedules.resolve_schedule("auto", 1, ng, 2048, sms)
    choice_a = policy.choose(na, 4, batch=1, cores=sms)
    choice_b = policy.choose(32768, 4, batch=8192, cores=sms)
    print(f"policy (a) (2^28,): {choice_a.algorithm}/{choice_a.schedule} "
          f"— {choice_a.reason}")
    print(f"policy (b) (8192, 32768): {choice_b.algorithm}/"
          f"{choice_b.schedule} — {choice_b.reason}")
    check((choice_a.algorithm, choice_a.schedule) == ("kernel", "fused"),
          "(a) should be kernel/fused")
    # choose() sizes the data by one row (n * itemsize, as the reference
    # does), so auto sends the 1 GiB batch to the library's horizontal
    # network; the batch is driven through the kernel route below, where
    # the schedule rule picks carry.
    check(choice_b.schedule == "carry", "(b) schedule should be carry")

    sync()
    trace.enable()
    trace.get().clear()
    cuda.reset_launches()
    ya = api.cumsum(xa)
    sync()
    one_call = {k: v for k, v in cuda.LAUNCHES.items() if v}
    events_a = [e["args"] for e in trace.get().events()
                if e["name"] == "kernel.launch"]
    trace.disable()
    check(one_call == {"fused": 1}, f"(a) auto launched {one_call}")
    check(len(events_a) == 1 and events_a[0]["schedule"] == "fused"
          and events_a[0]["hbm_read_bytes_est"] == 4 * na,
          f"(a) kernel.launch events {events_a}")
    print(f"(a) auto: launches {one_call}; kernel.launch: schedule "
          f"{events_a[0]['schedule']}, grid {events_a[0]['grid']}, reads "
          f"{events_a[0]['hbm_read_bytes_est']} B (one pass)")
    yf = api.cumsum(xa, algorithm="kernel", schedule="fused")
    yd = api.cumsum(xa, algorithm="kernel", schedule="decoupled")
    yb = api.cumsum(xb, algorithm="kernel")
    ybf = api.cumsum(xb, algorithm="kernel", schedule="fused")
    yc = api.cumsum(xb, algorithm="kernel", schedule="tree", block_n=8192)
    yg = api.cumsum(xg)
    fwd = dict(cuda.LAUNCHES)
    (dx,) = torch.autograd.grad(yg, xg, g)
    sync()
    launches = {k: cuda.LAUNCHES[k] for k in KERNELS}
    print(f"sum main-path launches: {launches} (before the backward: "
          f"{ {k: fwd[k] for k in KERNELS} })")
    for k in KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the main path")
    for k in USES[sched_g]:
        check(launches[k] > fwd[k], f"backward did not launch {k}")

    err_a = close_to_f64(ya, xa, "(a) fused")
    err_b = close_to_f64(yb, xb, "(b) carry")
    err_c = close_to_f64(yc, xb, "(c) tree")
    xa2, lay_a = xa.view(1, na), Rows(1, na, 1, 2048)
    check(same_bits(yf, ya) and same_bits(yd, ya),
          "(a) auto / fused / decoupled not bitwise equal")
    del yf, yd
    yk = api.cumsum(xa, algorithm="kernel", schedule="carry")
    check(same_bits(yk, ya), "(a) carry != fused bitwise")
    del yk
    (want,) = schedules.fused_plain((xa2,), SUM, lay_a)
    check(same_bits(want.view(na), ya), "(a) fused kernel != fused_plain")
    del want
    for rep in range(5):
        check(same_bits(api.cumsum(xa, algorithm="kernel", schedule="fused"),
                        ya), f"(a) fused repeat {rep} changed bits")
    lay_b = Rows(8192, 32768, 8, 2048)
    (want,) = schedules.fused_plain((xb,), SUM, lay_b)
    check(same_bits(ybf, yb) and same_bits(ybf, want),
          "(b) fused != carry / fused_plain")
    del ybf, yc, want
    ye = api.cumsum(xa, exclusive=True, algorithm="kernel", schedule="fused",
                    block_n=16384)
    ye_d = api.cumsum(xa, exclusive=True, algorithm="kernel",
                      schedule="decoupled", block_n=16384)
    (want,) = schedules.fused_plain((xa2,), SUM, Rows(1, na, 1, 16384), True)
    check(same_bits(ye, ye_d) and same_bits(ye, want.view(na)),
          "(a) exclusive bn 16384: fused != decoupled / fused_plain")
    del ye, ye_d, want
    yt = api.cumsum(xa, algorithm="kernel", schedule="tree")
    err_t = close_to_f64(yt, xa, "(a) tree")
    del yt, ya, yb
    print(f"(a) fused (auto) == fused == decoupled == carry == fused_plain "
          f"bitwise, five repeats the same bits, exclusive at block_n "
          f"16384 == decoupled == fused_plain; (b) fused == carry == "
          f"fused_plain; max |err| vs float64 (tolerance {REL_TOL} x "
          f"max|prefix|): (a) fused {err_a:.4g}, tree {err_t:.4g}; (b) "
          f"carry {err_b:.4g}; (c) tree {err_c:.4g}")

    xi = randint(-4, 5, (na,))
    ref_i = torch.cumsum(xi.long(), 0)
    cuda.reset_launches()
    for s in SCHEDULES:
        yi = api.cumsum(xi, algorithm="kernel", schedule=s)
        check(yi.dtype == torch.int32 and torch.equal(yi.long(), ref_i),
              f"int32 2^28 column not exact under {s}")
    # the int32 chain (the parallel form) launched by decoupled here
    int_launches = {"chain_int32": cuda.LAUNCHES["chain"]}
    check(int_launches["chain_int32"] > 0, "int32 decoupled ran no chain")
    del xi, ref_i, yi
    print("int32 2^28 column: all four schedules == torch.cumsum(int64); "
          f"launches {dict(cuda.LAUNCHES)}")

    lay_g = Rows(1, ng, 1, 2048)
    (want,) = plain[sched_g]((torch.flip(g, (1,)),), SUM, lay_g, False)
    check(same_bits(dx, torch.flip(want, (1,))),
          "grad != plain flip(cumsum(flip(g)))")
    print(f"backward (1, 2^24), {sched_g}: grad == plain "
          "flip(cumsum(flip(g))) bitwise")
    del xg, g, dx, want, yg

    # -- 4. the relational main path: TPC-H SF 10 on the card --------------
    t0 = time.perf_counter()
    o_idx = torch.arange(1, N_ORDERS + 1, device=dev, dtype=torch.int64)
    o_orderkey = ((o_idx >> 3) << 5) + (o_idx & 7)    # dbgen's sparse keys
    o_orderkey = o_orderkey.to(torch.int32)
    o_orderdate = randint(0, ORDERDATE_MAX + 1, (N_ORDERS,))
    lines = randint(1, 8, (N_ORDERS,), torch.int64)
    order_of = torch.repeat_interleave(
        torch.arange(N_ORDERS, device=dev), lines)
    T = order_of.numel()
    l_orderkey = o_orderkey[order_of]
    l_quantity = randint(1, 51, (T,))
    partkey = randint(1, SF * 200_000 + 1, (T,), torch.int64)
    retail_cents = (90_000 + (partkey // 10) % 20_001
                    + 100 * (partkey % 1000))
    l_extendedprice = (l_quantity.double() * retail_cents.double()
                       / 100).float()
    disc_cents = randint(0, 11, (T,))
    l_discount = disc_cents.float() / 100
    l_tax = randint(0, 9, (T,)).float() / 100
    l_shipdate = o_orderdate[order_of] + randint(1, 122, (T,))
    receipt = l_shipdate + randint(1, 31, (T,))
    # A = 0, N = 1, R = 2; F = 0, O = 1
    l_returnflag = torch.where(receipt <= CURRENTDATE,
                               2 * randint(0, 2, (T,)), 1)
    l_linestatus = (l_shipdate > CURRENTDATE).to(torch.int32)
    del partkey, retail_cents, receipt, lines
    sync()
    print(f"TPC-H SF {SF} on the card (seed {args.seed}): {N_ORDERS} orders,"
          f" {T} lineitems, generated in "
          f"{time.perf_counter() - t0:.1f} s")

    route_mask = (rel_compact._resolve("auto", l_quantity),
                  schedules.resolve_schedule("auto", 1, T, 2048, sms))
    trace.enable()
    trace.get().clear()
    sync()
    cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)

    # Q6: revenue of one year's mid-discount, small-quantity lines
    q6_mask = ((l_shipdate >= Q6_FROM) & (l_shipdate < Q6_TO)
               & (disc_cents >= 5) & (disc_cents <= 7) & (l_quantity < 24))
    rev = l_extendedprice * l_discount
    (q6_rows, q6_count), ms_q6 = wall_ms(
        lambda: rel.filter_compact(rev, q6_mask))
    q6_rev = q6_rows[:int(q6_count)].sum()

    # Q1: pricing summary after the shipdate filter
    q1_mask = l_shipdate <= Q1_SHIP_MAX
    disc_price = l_extendedprice * (1 - l_discount)
    q1_vals = torch.stack([l_quantity.float(), l_extendedprice, disc_price,
                           disc_price * (1 + l_tax)], dim=1)
    q1_ids_all = (l_returnflag * 2 + l_linestatus).to(torch.int32)
    ((v1, q1_count), (ids1, _)), ms_q1f = wall_ms(lambda: (
        rel.filter_compact(q1_vals, q1_mask),
        rel.filter_compact(q1_ids_all, q1_mask)))
    T1 = int(q1_count)
    v1, ids1 = v1[:T1], ids1[:T1]
    q1_sum, ms_q1s = wall_ms(lambda: rel.group_by(ids1, v1, 6, "sum"))
    q1_mean, ms_q1m = wall_ms(lambda: rel.group_by(ids1, v1, 6, "mean"))
    q1_cnt, ms_q1c = wall_ms(lambda: rel.group_by(ids1, v1, 6, "count"))
    route_seg = (rel_groupby._seg_algorithm("auto", "sum", T1, 4, True),
                 schedules.resolve_schedule("auto", 4, T1, 2048, sms))

    # Q3-shaped join: lines shipped after the date with orders placed
    # before it (build side: the orders, radix-sorted)
    probe = l_orderkey[l_shipdate > Q3_DATE]
    build = o_orderkey[o_orderdate < Q3_DATE]
    (join, ms_join) = wall_ms(lambda: rel.hash_join(probe, build,
                                                    max_matches=None))
    join_peak = torch.cuda.max_memory_allocated(dev)

    # per-row-group compaction and a per-order running window sum
    R = T // ROW_GROUP
    pred_rows = q6_mask[:R * ROW_GROUP].view(R, ROW_GROUP)
    (rg_dest, rg_cnt), ms_rgc = wall_ms(lambda: kc_ops.mask_compact(
        pred_rows))
    (rg_dest_t, rg_cnt_t), ms_rgt = wall_ms(lambda: kc_ops.mask_compact(
        pred_rows, block_n=8192))
    price_rows = l_extendedprice[:R * ROW_GROUP].view(R, ROW_GROUP)
    keys_rows = l_orderkey[:R * ROW_GROUP].view(R, ROW_GROUP)
    win_flags = torch.ones_like(keys_rows)
    win_flags[:, 1:] = (keys_rows[:, 1:] != keys_rows[:, :-1]).to(
        torch.int32)
    win, ms_win = wall_ms(lambda: seg_ops.segmented_cumsum(price_rows,
                                                           win_flags))
    win_t, ms_wint = wall_ms(lambda: seg_ops.segmented_cumsum(
        price_rows, win_flags, block_n=8192))
    win_d, ms_wind = wall_ms(lambda: seg_ops.segmented_cumsum(
        price_rows, win_flags, schedule="decoupled"))
    # Q6's mask as one padded row through the back-compat entry point
    # with schedule="fused": no running totals, so the fused kernel
    pad6 = (-T) % 2048
    m6 = F.pad((q6_mask != 0).to(torch.int32), (0, pad6)).view(1, T + pad6)
    (m6_dest, m6_cnt), ms_m6f = wall_ms(lambda: kc_ops.mask_compact_kernel(
        m6, block_b=1, schedule="fused"))
    sync()
    rel_launches = dict(cuda.LAUNCHES)
    events = [e for e in trace.get().events() if e["name"] == "kernel.launch"]
    by_monoid = {}
    for e in events:
        key = (e["args"]["monoid"], e["args"]["schedule"])
        by_monoid[key] = by_monoid.get(key, 0) + 1
    trace.disable()
    route_rg = (schedules.resolve_schedule("auto", R, ROW_GROUP, 2048, sms),
                schedules.resolve_schedule("auto", R, ROW_GROUP, 8192, sms))
    route_sort = schedules.resolve_schedule("auto", 256, build.numel(), 2048,
                                            sms)
    print(f"relational launches: "
          f"{ {k: v for k, v in rel_launches.items() if v} }")
    print("kernel.launch events (monoid, schedule): "
          + ", ".join(f"{k[0]}/{k[1]} x{v}" for k, v in
                      sorted(by_monoid.items())))
    for spec_name in ("segsum", "mask"):
        for k in KERNELS:
            kn = cuda.kernel_name(spec_name, k)
            check(rel_launches[kn] > 0,
                  f"kernel {kn} never launched on the relational path")
        check(any(m == spec_name for m, _ in by_monoid),
              f"no kernel.launch event with monoid={spec_name}")
    print(f"route Q6 filter_compact: {route_mask[0]} / {route_mask[1]} "
          f"(T = {T}); {ms_q6:.1f} ms")
    print(f"route Q1 filter_compact x2: {route_mask[0]} / fused; "
          f"{ms_q1f:.1f} ms; group_by sum/mean: {route_seg[0]} / "
          f"{route_seg[1]} (T = {T1}, 4 columns); sum {ms_q1s:.1f} ms, "
          f"mean {ms_q1m:.1f} ms, count (partition only) {ms_q1c:.1f} ms")
    print(f"route Q3 hash_join: radix_sort of {build.numel()} build keys "
          f"(4 passes of 256 buckets; their one-hot scans {route_sort}), "
          f"probe of {probe.numel()} rows (offsets: kernel cumsum); "
          f"{ms_join:.1f} ms; peak memory of the phase "
          f"{join_peak / 2**30:.2f} GiB (the join at SF {SF}, not cut)")
    print(f"route row groups ({R} x {ROW_GROUP}): mask_compact "
          f"{route_rg[0]} {ms_rgc:.1f} ms, block_n 8192 {route_rg[1]} "
          f"{ms_rgt:.1f} ms; segmented_cumsum {route_rg[0]} "
          f"{ms_win:.1f} ms, block_n 8192 {route_rg[1]} {ms_wint:.1f} ms, "
          f"decoupled {ms_wind:.1f} ms; Q6 mask_compact_kernel fused "
          f"{ms_m6f:.1f} ms")
    check(route_mask == ("kernel", "fused") and route_seg == ("kernel",
                                                              "fused")
          and route_rg == ("carry", "tree"), "unexpected routes")

    # checks against float64/int64 on the card
    want_q6 = int(q6_mask.sum())
    check(int(q6_count) == want_q6, f"Q6 count {int(q6_count)} != {want_q6}")
    check(torch.equal(q6_rows[:want_q6], rev[q6_mask]),
          "Q6 compacted rows != rev[mask]")
    want_rev = (l_extendedprice.double() * l_discount.double())[q6_mask].sum()
    err_q6 = abs(q6_rev.item() - want_rev.item()) / abs(want_rev.item())
    check(err_q6 <= REL_SUM_TOL, f"Q6 revenue rel err {err_q6}")
    check(T1 == int(q1_mask.sum()), "Q1 filter count")
    want_cnt = torch.bincount(q1_ids_all[q1_mask].long(), minlength=6)
    check(torch.equal(q1_cnt.long(), want_cnt), "Q1 group counts")
    want_sum = torch.zeros((6, 4), dtype=torch.float64, device=dev)
    want_sum.index_add_(0, q1_ids_all[q1_mask].long(),
                        q1_vals[q1_mask].double())
    err_q1 = rel_err(q1_sum, want_sum)
    want_mean = want_sum / want_cnt.clamp_min(1)[:, None].double()
    err_q1m = rel_err(q1_mean, want_mean)
    check(err_q1 <= REL_SUM_TOL and err_q1m <= REL_SUM_TOL,
          f"Q1 rel err sum {err_q1} mean {err_q1m}")
    sorted_b, perm_b = torch.sort(build)
    pos = torch.searchsorted(sorted_b, probe).clamp_max(build.numel() - 1)
    hit = sorted_b[pos] == probe
    want_l = torch.nonzero(hit).flatten()
    want_r = perm_b[pos[hit]]
    c = int(join.count)
    check(c == want_l.numel() and join.left_index.numel() == c,
          f"join count {c} != {want_l.numel()}")
    check(torch.equal(join.left_index.long(), want_l)
          and torch.equal(join.right_index.long(), want_r),
          "join pairs != the torch.sort/searchsorted join")
    rg_want = torch.cumsum(pred_rows.long(), 1) - pred_rows.long()
    rg_want = torch.where(pred_rows, rg_want, ROW_GROUP)
    check(torch.equal(rg_dest.long(), rg_want) and torch.equal(
        rg_cnt.long(), pred_rows.sum(1)), "row-group compaction")
    check(torch.equal(rg_dest_t, rg_dest) and torch.equal(rg_cnt_t, rg_cnt),
          "row-group compaction: tree != carry")
    c64 = torch.cumsum(price_rows.double(), 1)
    seg = torch.cumsum(win_flags.flatten().long(), 0) - 1
    starts = torch.nonzero(win_flags.flatten()).flatten()
    base = (c64.flatten() - price_rows.flatten().double())[starts]
    win_want = c64.flatten() - base[seg]
    err_win = max(rel_err(win.flatten(), win_want),
                  rel_err(win_t.flatten(), win_want))
    check(err_win <= REL_SUM_TOL, f"window sum rel err {err_win}")
    check(same_bits(win_d, win), "window sums: decoupled != carry bitwise")
    del c64, seg, base, win_want, win_d
    m6_want = torch.cumsum(m6.long(), 1) - m6.long()
    m6_want = torch.where(m6 != 0, m6_want, T + pad6)
    check(torch.equal(m6_dest.long(), m6_want)
          and int(m6_cnt) == want_q6, "Q6 fused mask compaction")
    del m6_want, m6_dest
    print(f"Q6: {want_q6} rows, revenue {q6_rev.item():.6e} (float64 "
          f"{want_rev.item():.6e}, rel err {err_q6:.3g}); Q1: {T1} rows, "
          f"group counts exact {want_cnt.tolist()}, sums rel err "
          f"{err_q1:.3g}, means {err_q1m:.3g}; join: {c} pairs == "
          f"torch.sort/searchsorted join; row groups: compaction exact "
          f"(carry == tree), window sums rel err {err_win:.3g} "
          f"(tolerance {REL_SUM_TOL}, decoupled == carry bitwise); Q6's "
          "fused mask compaction exact")

    # where each operator's device time goes (one profiled call each)
    def short(kname):
        for k in ("carry_kernel", "carry_reg_kernel", "totals_kernel",
                  "totals_reduce_kernel", "chain_seq_kernel",
                  "chain_scan_kernel", "apply_kernel", "apply_reg_kernel",
                  "fused_kernel", "fused_reg_kernel", "tree_kernel",
                  "tree_reg_kernel"):
            if k in kname:
                spec = ("segsum" if "SegSum" in kname else "mask"
                        if "Mask" in kname else "affine"
                        if "Affine" in kname else "sum")
                # the reduction is decoupled's totals pass too
                return f"{spec}.{'totals' if 'totals' in k else k[:-7]}"
        return kname[:40]

    for label, fn in (
            ("Q6 filter_compact", lambda: rel.filter_compact(rev, q6_mask)),
            ("Q1 group_by sum", lambda: rel.group_by(ids1, v1, 6, "sum")),
            ("Q3 hash_join", lambda: rel.hash_join(probe, build,
                                                   max_matches=None))):
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = wall_ms(fn)
        kern = {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue  # host-side ops: their device time is their kernels'
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            kern[short(ev.key)] = kern.get(short(ev.key), 0) + dev_us
        busy = sum(kern.values()) / 1e3
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
        if busy > 0:
            print(f"profile {label}: wall {wall:.1f} ms, device busy "
                  f"{busy:.1f} ms (idle share {1 - busy / wall:.2f}); top: "
                  + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in top))
        else:
            print(f"profile {label}: wall {wall:.1f} ms, device time not "
                  "measured (the profiler recorded none)")

    # -- 5. times ----------------------------------------------------------
    nb = xb.numel()
    lib_a = time_ms(lambda: torch.cumsum(xa, 0), 5)
    lib_b = time_ms(lambda: torch.cumsum(xb, 1), 5)
    for tag, x, n_el, lib, reps in (("(a) 2^28", xa, na, lib_a, 3),
                                    ("(b) 8192x32768", xb, nb, lib_b, 5)):
        for s in SCHEDULES:
            ms = time_ms(lambda: api.cumsum(x, algorithm="kernel",
                                            schedule=s), reps)
            traffic = 12 * n_el if s == "decoupled" else 8 * n_el
            print(f"time {tag} {s:9s}: {ms:9.3f} ms  "
                  f"{8 * n_el / ms / 1e6:7.1f} GB/s  bound "
                  f"{traffic / bw * 1e3:.3f} ms ({traffic / 2**30:.0f} GiB)"
                  f"  torch.cumsum {lib:.3f} ms")
    ms = time_ms(lambda: api.cumsum(xb), 3)
    print(f"time (b) 8192x32768 auto -> {choice_b.algorithm}: {ms:9.3f} ms "
          "(the reference's per-row size rule)")

    rows = []

    def kernel_row(kname, run, run_plain, nbytes, ops, reps, library,
                   shape, counts, floor_steps=None, graph=False, base=None):
        """Time kernel ``kname`` against its plain version (bitwise
        first); ``floor_steps``: the dependent combines of a chain that
        folds on one thread, printed as a latency floor of ~4 SM cycles
        each (a float add's) at the card's maximum SM clock; ``graph``:
        also print the kernel's and the library call's times from CUDA
        graph replays (``graph_ms``), for kernels of a few microseconds (an
        int: the calls a graph holds, 20 for True); ``base``: the kernel
        (a ``REPLACES`` key) where the row's name does not end in it."""
        got, want = flat(run()), flat(run_plain())
        sync()
        check(all_same_bits(got, want), f"{kname}: kernel != plain at the "
              "main-path shape")
        err = max((a.double() - b.double()).abs().max().item()
                  for a, b in zip(got, want))
        del got, want
        ms = time_ms(run, reps)
        plain_ms = time_ms(run_plain, 1, warmup=0)
        lib_ms = None if library is None else time_ms(library, reps)
        b_ms, b_by = bound_ms(nbytes, ops)
        base = base or ("chain" if kname == "chain_int32"
                        else kname.split("_")[-1])
        rows.append({
            "name": kname, "route": "cuda", "source": CU_SOURCE,
            "replaces": REPLACES[base], "launches": counts[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        floor = ""
        if floor_steps is not None:
            floor = ("  latency floor not measured (no SM clock)"
                     if sm_hz is None else
                     f"  latency floor {4 * floor_steps / sm_hz * 1e3:.4f} ms "
                     f"({floor_steps} dependent combines x 4 cycles at "
                     f"{sm_hz / 1e6:.0f} MHz)")
        print(f"kernel {kname:14s} {shape:24s}: {ms:9.3f} ms  plain "
              f"{plain_ms:10.3f} ms  bound {b_ms:.4f} ms ({b_by})  library "
              f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'}{floor}")
        if graph:
            calls = 20 if graph is True else graph
            g_ms = graph_ms(run, calls)
            g_lib = None if library is None else graph_ms(library, calls)
            print(f"  {kname} from a CUDA graph replay ({calls} calls, no "
                  f"host launch cost): kernel "
                  f"{'not measured' if g_ms is None else f'{g_ms:.4f} ms'}"
                  f", library "
                  f"{'none' if g_lib is None else f'{g_lib:.4f} ms'} a call")

    def beside_shared(label, run, shape, calls=5):
        """The kernel of the row kernel_row added last (``run(None)``)
        beside the shared-memory kernel it replaced (``run("shared")``),
        at the same shape in the same run (a comparison: these launches
        come after the main path's): bitwise equal, then CUDA-event
        medians in turns (shared, register, register, shared) and a CUDA
        graph replay of each. The shared kernel gets a row of its own,
        ``<name>_shared``: 0 launches, since the main path took the one
        that replaced it."""
        row = rows[-1]
        check(all_same_bits(flat(run("shared")), flat(run(None))),
              f"{label}: register != shared network at {shape}")
        turns = [time_ms(lambda: run(net), 5)
                 for net in ("shared", None, None, "shared")]
        g_reg = graph_ms(lambda: run(None), calls=calls)
        g_sh = graph_ms(lambda: run("shared"), calls=calls)
        rows.append({**row, "name": row["name"] + "_shared", "launches": 0,
                     "ms": statistics.median((turns[0], turns[3]))})
        print(f"  {label} at {shape} in the same run: "
              f"{row['ms']:.3f} / {turns[1]:.3f} / {turns[2]:.3f} ms "
              f"(graph replay "
              f"{'not measured' if g_reg is None else f'{g_reg:.4f} ms'}), "
              f"the shared-memory kernel {turns[0]:.3f} / {turns[3]:.3f} ms "
              f"(graph replay "
              f"{'not measured' if g_sh is None else f'{g_sh:.4f} ms'}); "
              f"bound {row['bound_ms']:.4f} ms; the two bitwise equal")

    # sum kernels at the prefix-sum main path's shapes
    lay_c = Rows(8192, 32768, 8, 8192)
    (tot,) = cuda.totals(SUM, (xa2,), lay_a)
    (offs,), _ = cuda.chain(SUM, (tot,))
    n_chunks = tot.numel()
    kernel_row("carry", lambda: cuda.carry(SUM, (xb,), lay_b)[0],
               lambda: schedules.carry_plain((xb,), SUM, lay_b),
               8 * nb, nb, 5, lambda: torch.cumsum(xb, 1),
               "(8192, 32768) bn 2048", launches, graph=True)
    kernel_row("totals", lambda: cuda.totals(SUM, (xa2,), lay_a),
               lambda: schedules.totals_plain((xa2,), SUM, lay_a),
               4 * na + 4 * n_chunks, na, 5,
               lambda: xa2.view(1, n_chunks, 2048).sum(-1),
               "(1, 2^28) bn 2048", launches, graph=True)
    kernel_row("chain", lambda: cuda.chain(SUM, (tot,))[0],
               lambda: schedules.exclusive_chain(SUM, (tot,)),
               8 * n_chunks, n_chunks, 5, lambda: torch.cumsum(tot, 1),
               f"(1, {n_chunks}) totals", launches, floor_steps=n_chunks,
               graph=True)
    # the int32 chain (the parallel form) at the int32 column's totals:
    # one (1, 2^28 / 2048) row of chunk sums of values in [-4, 5)
    (tot_i,) = cuda.totals(SUM, (randint(-4, 5, (1, na)),), lay_a)
    kernel_row("chain_int32", lambda: cuda.chain(SUM, (tot_i,))[0],
               lambda: schedules.exclusive_chain(SUM, (tot_i,)),
               8 * n_chunks, n_chunks, 5, lambda: torch.cumsum(tot_i, 1),
               f"(1, {n_chunks}) int32 totals", int_launches, graph=True)
    del tot_i
    kernel_row("apply", lambda: cuda.apply(SUM, (xa2,), (offs,), lay_a),
               lambda: schedules.apply_plain((xa2,), (offs,), SUM, lay_a),
               8 * na + 4 * n_chunks, na, 5, None,
               "(1, 2^28) bn 2048", launches, graph=True)
    kernel_row("tree", lambda: cuda.tree(SUM, (xb,), lay_c)[0],
               lambda: schedules.tree_plain((xb,), SUM, lay_c),
               8 * nb, nb, 5, lambda: torch.cumsum(xb, 1),
               "(8192, 32768) bn 8192", launches, graph=True)
    kernel_row("fused", lambda: cuda.fused(SUM, (xa2,), lay_a),
               lambda: schedules.fused_plain((xa2,), SUM, lay_a),
               8 * na, na, 5, lambda: torch.cumsum(xa, 0),
               "(1, 2^28) bn 2048", launches, graph=True)
    del xa, xb, xa2, tot, offs

    # mask kernels: decoupled and fused at Q6's column (m6, built in
    # phase 4), carry/tree at the row groups
    pad = pad6
    lay6 = Rows(1, T + pad, 1, 2048)
    mspec = monoids.mask(T + pad)
    (mt,) = cuda.totals(mspec, (m6,), lay6)
    (mo,), _ = cuda.chain(mspec, (mt,), True)
    c6 = mt.numel()
    kernel_row("mask_totals", lambda: cuda.totals(mspec, (m6,), lay6),
               lambda: schedules.totals_plain((m6,), mspec, lay6),
               4 * (T + pad) + 4 * c6, T + pad, 5,
               lambda: m6.view(1, c6, 2048).sum(-1, dtype=torch.int32),
               f"(1, {T + pad}) bn 2048", rel_launches, graph=True)
    kernel_row("mask_chain", lambda: cuda.chain(mspec, (mt,), True),
               lambda: (schedules.exclusive_chain(mspec, (mt,)),
                        (schedules.exclusive_chain(mspec, (mt,))[0] + mt,)),
               12 * c6, c6, 5, lambda: torch.cumsum(mt, 1),
               f"(1, {c6}) totals", rel_launches, graph=True)
    kernel_row("mask_apply",
               lambda: cuda.apply(mspec, (m6,), (mo,), lay6),
               lambda: schedules.apply_plain((m6,), (mo,), mspec, lay6),
               8 * (T + pad) + 4 * c6, T + pad, 5, None,
               f"(1, {T + pad}) bn 2048", rel_launches, graph=True)
    (md,) = cuda.apply(mspec, (m6,), (mo,), lay6)
    check(same_bits(cuda.fused(mspec, (m6,), lay6)[0], md),
          "Q6 mask: fused kernel != decoupled")
    del md
    kernel_row("mask_fused", lambda: cuda.fused(mspec, (m6,), lay6),
               lambda: schedules.fused_plain((m6,), mspec, lay6),
               8 * (T + pad), T + pad, 5, None,
               f"(1, {T + pad}) bn 2048", rel_launches)
    rg = pred_rows.to(torch.int32).contiguous()
    nrg = rg.numel()
    rspec = monoids.mask(ROW_GROUP)
    for kname, fn, plain_fn, bn in (
            ("mask_carry", cuda.carry, schedules.carry_plain, 2048),
            ("mask_tree", cuda.tree, schedules.tree_plain, 8192)):
        lay = Rows(R, ROW_GROUP, 1, bn)
        kernel_row(kname,
                   lambda: fn(rspec, (rg,), lay, return_totals=True),
                   lambda: plain_fn((rg,), rspec, lay, return_totals=True),
                   8 * nrg + 4 * R * (ROW_GROUP // bn), nrg, 5, None,
                   f"({R}, {ROW_GROUP}) bn {bn}", rel_launches, graph=True)
    del m6, mt, mo, rg
    print(f"mask decoupled at ({T + pad},): bound "
          f"{12 * (T + pad) / bw * 1e3:.4f} ms (12 B per element)")

    # segmented-sum kernels: decoupled at Q1's group_by, carry/tree at
    # the row-group window
    plan = rel.partition_plan(ids1, 6)
    (sv,) = apply_plan(plan, v1)
    sflags = torch.zeros((T1 + 1,), dtype=torch.int32, device=dev)
    sflags[plan.offsets.long()] = 1
    pad = (-T1) % 2048
    sv = F.pad(sv.t(), (0, pad)).contiguous()
    sflags = F.pad(sflags[:T1].expand(4, T1), (0, pad)).contiguous()
    lay1 = Rows(4, T1 + pad, 4, 2048)
    (st_v, st_f) = cuda.totals(SEGSUM, (sv, sflags), lay1)
    (so_v, so_f), _ = cuda.chain(SEGSUM, (st_v, st_f))
    c1 = st_v.numel()
    n1 = sv.numel()
    check(cuda.tile_network(SEGSUM, lay1, "totals") == "register",
          "Q1's segmented-sum totals should take totals_reduce_kernel")
    kernel_row("segsum_totals",
               lambda: cuda.totals(SEGSUM, (sv, sflags), lay1),
               lambda: schedules.totals_plain((sv, sflags), SEGSUM, lay1),
               8 * n1 + 8 * c1, n1, 5, None,
               f"(4, {T1 + pad}) bn 2048", rel_launches, graph=5)
    beside_shared("segsum_totals (totals_reduce_kernel; shared: "
                  "totals_kernel)",
                  lambda net: cuda.totals(SEGSUM, (sv, sflags), lay1,
                                          network=net),
                  f"(4, {T1 + pad}) bn 2048")
    kernel_row("segsum_chain",
               lambda: cuda.chain(SEGSUM, (st_v, st_f))[0],
               lambda: schedules.exclusive_chain(SEGSUM, (st_v, st_f)),
               16 * c1, c1, 5, None, f"(4, {c1 // 4}) totals",
               rel_launches, floor_steps=c1 // 4, graph=True)
    kernel_row("segsum_apply",
               lambda: cuda.apply(SEGSUM, (sv, sflags), (so_v, so_f), lay1),
               lambda: schedules.apply_plain((sv, sflags), (so_v, so_f),
                                             SEGSUM, lay1),
               12 * n1 + 8 * c1, n1, 5, None,
               f"(4, {T1 + pad}) bn 2048", rel_launches, graph=True)
    (sd,) = cuda.apply(SEGSUM, (sv, sflags), (so_v, so_f), lay1)
    check(same_bits(cuda.fused(SEGSUM, (sv, sflags), lay1)[0], sd),
          "Q1 segsum: fused kernel != decoupled")
    del sd
    kernel_row("segsum_fused",
               lambda: cuda.fused(SEGSUM, (sv, sflags), lay1),
               lambda: schedules.fused_plain((sv, sflags), SEGSUM, lay1),
               12 * n1, n1, 5, None, f"(4, {T1 + pad}) bn 2048",
               rel_launches)
    pad16 = (-T1) % 16384
    sv16 = F.pad(sv[:, :T1], (0, pad16)).contiguous()
    sf16 = F.pad(sflags[:, :T1], (0, pad16)).contiguous()
    lay16 = Rows(4, T1 + pad16, 4, 16384)
    (e_f,) = cuda.fused(SEGSUM, (sv16, sf16), lay16, exclusive=True)
    (e_d,) = schedules.scan_decoupled((sv16, sf16), SEGSUM, lay16,
                                      exclusive=True)
    (e_p,) = schedules.fused_plain((sv16, sf16), SEGSUM, lay16, True)
    check(same_bits(e_f, e_d) and same_bits(e_f, e_p),
          "Q1 segsum exclusive bn 16384: fused != decoupled / fused_plain")
    print(f"fused at Q6's ({T + pad},) mask and Q1's (4, {T1 + pad}) "
          "segmented sum (and exclusive at block_n 16384) == decoupled == "
          "fused_plain bitwise")
    del sv, sflags, st_v, st_f, so_v, so_f, sv16, sf16, e_f, e_d, e_p
    print(f"segsum decoupled at (4, {T1 + pad}): bound "
          f"{20 * n1 / bw * 1e3:.4f} ms (20 B per element)")
    wf = win_flags.contiguous()
    for kname, fn, plain_fn, bn in (
            ("segsum_carry", cuda.carry, schedules.carry_plain, 2048),
            ("segsum_tree", cuda.tree, schedules.tree_plain, 8192)):
        lay = Rows(R, ROW_GROUP, 1, bn)
        kernel_row(kname, lambda: fn(SEGSUM, (price_rows, wf), lay)[0],
                   lambda: plain_fn((price_rows, wf), SEGSUM, lay),
                   12 * nrg, nrg, 5, None, f"({R}, {ROW_GROUP}) bn {bn}",
                   rel_launches, graph=True)
    del (price_rows, wf, win, win_t, pred_rows, q1_vals, v1, ids1, rev,
         disc_price)
    torch.cuda.empty_cache()

    # -- 6. the affine SSM path at zamba2-7b's width ------------------------
    bsz, nc, ch = SSD_SHAPE
    heads = 112
    n_ssd = bsz * nc * ch
    # gates exp(A_tot) in (0.5, 1], one per (chunk, head), broadcast over
    # head_dim x state as the SSD carry does; chunk states S
    gate = 0.5 + 0.5 * torch.rand((bsz, nc, heads, 1), device=dev,
                                  generator=gen)
    a = gate.expand(bsz, nc, heads, ch // heads).reshape(SSD_SHAPE)
    b = 0.1 * normals(SSD_SHAPE)
    gh = normals(SSD_SHAPE)
    del gate
    route_ssd = ssm_ops.resolved_schedule(SSD_SHAPE, cores=sms)
    lay_s = Channels(*SSD_SHAPE, 256, 512)
    print(f"SSD carry {SSD_SHAPE} float32 ({4 * n_ssd / 1e9:.2f} GB per "
          f"operand): auto -> {route_ssd}; time tiles of 256, the carry in "
          f"{cuda.chan_reg_width(lay_s)}-channel strips "
          "(carry_chan_reg_kernel; apply_chan_reg_kernel and "
          "fused_chan_reg_kernel too, the totals a reduction, "
          "totals_chan_reduce_kernel, and tree_chan_reg_kernel)")
    check(route_ssd == "carry", "zamba2 SSD carry should route to carry")
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    trace.enable()
    trace.get().clear()
    cuda.reset_launches()
    h, ms_auto = wall_ms(lambda: ssm_ops.ssm_scan(a, b))
    hs, ms_s = {}, {}
    for s in SCHEDULES:
        hs[s], ms_s[s] = wall_ms(lambda: ssm_ops.ssm_scan(a, b, schedule=s))
    ag, bg = a.clone().requires_grad_(), b.clone().requires_grad_()
    hg = ssm_ops.ssm_scan(ag, bg)
    (da, db), ms_bwd = wall_ms(lambda: torch.autograd.grad(hg, (ag, bg), gh))
    sync()
    aff_launches = dict(cuda.LAUNCHES)
    aff_events = [e["args"]["schedule"] for e in trace.get().events()
                  if e["name"] == "kernel.launch"
                  and e["args"]["monoid"] == "affine"]
    trace.disable()
    ssd_peak = torch.cuda.max_memory_allocated(dev)
    del ag, bg, hg
    print(f"affine launches: "
          f"{ {k: v for k, v in aff_launches.items() if k.startswith('affine_') and v} }"
          f"; kernel.launch schedules {aff_events}; wall ms: auto "
          f"{ms_auto:.1f}, " + ", ".join(f"{s} {ms_s[s]:.1f}"
                                         for s in SCHEDULES)
          + f", backward {ms_bwd:.1f}; peak memory {ssd_peak / 2**30:.2f} "
          "GiB")
    for k in KERNELS:
        check(aff_launches[cuda.kernel_name("affine", k)] > 0,
              f"affine_{k} never launched on the SSM path")
    check(same_bits(hs["carry"], h), "auto != carry")
    for s in SCHEDULES:
        (want,) = plain[s]((a, b), AFFINE, lay_s)
        check(same_bits(hs[s], want), f"SSD {s}: kernel != plain")
        if s in ("decoupled", "fused"):
            check(same_bits(hs[s], h), f"SSD {s} != carry bitwise")
        del want
    err_tree = (hs["tree"] - h).abs().max().item()
    del hs
    # the gradient: the same schedule's plain scan of the flipped
    # cotangent through the flipped gates rolled one step
    gate_b = torch.cat([torch.zeros_like(a[:, :1]),
                        torch.flip(a, (1,))[:, :-1]], dim=1)
    (lam,) = plain[route_ssd]((gate_b, torch.flip(gh, (1,)).contiguous()),
                              AFFINE, lay_s)
    del gate_b
    lam = torch.flip(lam, (1,))
    check(same_bits(db, lam), "SSD backward: db != plain")
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    check(same_bits(da, lam * h_prev), "SSD backward: da != plain")
    del lam, h_prev, da, db, gh
    h64 = torch.empty(SSD_SHAPE, dtype=torch.float64, device=dev)
    state = torch.zeros((bsz, ch), dtype=torch.float64, device=dev)
    for t in range(nc):
        state = a[:, t].double() * state + b[:, t].double()
        h64[:, t] = state
    check(bool(torch.isfinite(h).all()), "SSD: non-finite output")
    excess = ((h.double() - h64).abs()
              - AFFINE_TOL * (1 + h64.abs())).max().item()
    err_64 = (h.double() - h64).abs().max().item()
    check(excess <= 0, f"SSD vs float64: max err {err_64} beyond "
          f"{AFFINE_TOL} (1 + |h|)")
    del h64, state
    print(f"SSD: every schedule's output and the gradients bitwise equal "
          f"to the plain versions; carry == decoupled == fused; tree max "
          f"|diff| {err_tree:.3g}; max |err| vs a float64 recurrence "
          f"{err_64:.3g} (tolerance {AFFINE_TOL} x (1 + |h|))")
    del h

    (at_, bt_) = cuda.totals(AFFINE, (a, b), lay_s)
    (ao, bo), _ = cuda.chain(AFFINE, (at_, bt_))
    n_sc = at_.numel()
    check(cuda.tile_network(AFFINE, lay_s, "carry") == "register",
          "the SSD carry should take carry_chan_reg_kernel")
    kernel_row("affine_carry", lambda: cuda.carry(AFFINE, (a, b), lay_s)[0],
               lambda: schedules.carry_plain((a, b), AFFINE, lay_s),
               12 * n_ssd, 3 * n_ssd, 5, None, f"{SSD_SHAPE} bt 256",
               aff_launches, graph=5)
    # the shared-memory carry_kernel it replaced, at the same shape in the
    # same run (a comparison: these launches come after the main path's)
    (sh,), sh_run = cuda.carry(AFFINE, (a, b), lay_s, return_totals=True,
                               network="shared")
    (rg,), rg_run = cuda.carry(AFFINE, (a, b), lay_s, return_totals=True)
    check(same_bits(sh, rg) and all_same_bits(sh_run, rg_run),
          "SSD carry: register != shared network")
    del sh, sh_run, rg, rg_run
    sh_ms = [time_ms(lambda: cuda.carry(AFFINE, (a, b), lay_s,
                                        network="shared"), 5),
             time_ms(lambda: cuda.carry(AFFINE, (a, b), lay_s), 5)]
    sh_g = graph_ms(lambda: cuda.carry(AFFINE, (a, b), lay_s,
                                       network="shared"), calls=5)
    print(f"  affine_carry at {SSD_SHAPE} bt 256 in the same run: "
          f"carry_chan_reg_kernel {rows[-1]['ms']:.3f} / {sh_ms[1]:.3f} ms, "
          f"shared-memory carry_kernel {sh_ms[0]:.3f} ms (graph replay "
          f"{'not measured' if sh_g is None else f'{sh_g:.4f} ms'}); bound "
          f"{rows[-1]['bound_ms']:.4f} ms; the two bitwise equal, outputs "
          "and running totals")
    check(cuda.tile_network(AFFINE, lay_s, "totals") == "register"
          and cuda.tile_network(AFFINE, lay_s, "apply") == "register",
          "the SSD decoupled should take totals_chan_reduce_kernel and "
          "apply_chan_reg_kernel")

    kernel_row("affine_totals", lambda: cuda.totals(AFFINE, (a, b), lay_s),
               lambda: schedules.totals_plain((a, b), AFFINE, lay_s),
               8 * n_ssd + 8 * n_sc, 3 * n_ssd, 5, None,
               f"{SSD_SHAPE} bt 256", aff_launches, graph=5)
    beside_shared("affine_totals (totals_chan_reduce_kernel; "
                  "shared: totals_kernel)",
                  lambda net: cuda.totals(AFFINE, (a, b), lay_s,
                                          network=net),
                  f"{SSD_SHAPE} bt 256")
    kernel_row("affine_chain", lambda: cuda.chain(AFFINE, (at_, bt_))[0],
               lambda: schedules.exclusive_chain(AFFINE, (at_, bt_)),
               16 * n_sc, 3 * n_sc, 5, None,
               f"{tuple(at_.shape)} totals", aff_launches, graph=True)
    # the first form's loop (a thread a (batch, channel), chunk by
    # chunk), transcribed: chain_chan_kernel keeps its bits
    acc_a, acc_b = torch.ones_like(at_[:, 0]), torch.zeros_like(bt_[:, 0])
    for c in range(at_.shape[1]):
        check(same_bits(ao[:, c], acc_a) and same_bits(bo[:, c], acc_b),
              f"affine_chain != its first form at chunk {c}")
        acc_a, acc_b = acc_a * at_[:, c], at_[:, c] * acc_b + bt_[:, c]
    del acc_a, acc_b
    kernel_row("affine_apply",
               lambda: cuda.apply(AFFINE, (a, b), (ao, bo), lay_s),
               lambda: schedules.apply_plain((a, b), (ao, bo), AFFINE, lay_s),
               12 * n_ssd + 8 * n_sc, 3 * n_ssd, 5, None,
               f"{SSD_SHAPE} bt 256", aff_launches, graph=5)
    beside_shared("affine_apply (apply_chan_reg_kernel; shared: "
                  "apply_kernel)",
                  lambda net: cuda.apply(AFFINE, (a, b), (ao, bo), lay_s,
                                         network=net),
                  f"{SSD_SHAPE} bt 256")
    check(cuda.tile_network(AFFINE, lay_s, "fused") == "register",
          "the SSD fused should take fused_chan_reg_kernel")
    kernel_row("affine_fused", lambda: cuda.fused(AFFINE, (a, b), lay_s),
               lambda: schedules.fused_plain((a, b), AFFINE, lay_s),
               12 * n_ssd, 3 * n_ssd, 5, None, f"{SSD_SHAPE} bt 256",
               aff_launches, graph=5)
    # the shared-memory fused_kernel it replaced, at the same shape in the
    # same run (a comparison: these launches come after the main path's),
    # in turns: shared, register, register, shared
    (fs,) = cuda.fused(AFFINE, (a, b), lay_s, network="shared")
    (fr,) = cuda.fused(AFFINE, (a, b), lay_s)
    (fc,), _ = cuda.carry(AFFINE, (a, b), lay_s)
    check(same_bits(fs, fr) and same_bits(fr, fc),
          "SSD fused: register != shared network / carry")
    del fs, fr, fc
    fu_ms = [time_ms(lambda: cuda.fused(AFFINE, (a, b), lay_s, network=net),
                     5) for net in ("shared", None, None, "shared")]
    carry_ms = next(r["ms"] for r in rows if r["name"] == "affine_carry")
    print(f"  affine_fused at {SSD_SHAPE} bt 256 in the same run: "
          f"fused_chan_reg_kernel ({cuda.chan_reg_width(lay_s)}-channel "
          f"strips) {rows[-1]['ms']:.3f} / {fu_ms[1]:.3f} / {fu_ms[2]:.3f} "
          f"ms, shared-memory fused_kernel ({cuda.channel_width(lay_s)}-"
          f"channel strips) {fu_ms[0]:.3f} / {fu_ms[3]:.3f} ms, "
          f"carry_chan_reg_kernel {carry_ms:.3f} ms; bound "
          f"{rows[-1]['bound_ms']:.4f} ms; register == shared == carry "
          "bitwise")
    check(cuda.tile_network(AFFINE, lay_s, "tree") == "register",
          "the SSD tree should take tree_chan_reg_kernel")
    kernel_row("affine_tree", lambda: cuda.tree(AFFINE, (a, b), lay_s)[0],
               lambda: schedules.tree_plain((a, b), AFFINE, lay_s),
               12 * n_ssd, 3 * n_ssd, 5, None, f"{SSD_SHAPE} bt 256",
               aff_launches, graph=5)
    beside_shared("affine_tree (tree_chan_reg_kernel; shared: tree_kernel)",
                  lambda net: cuda.tree(AFFINE, (a, b), lay_s,
                                        network=net)[0],
                  f"{SSD_SHAPE} bt 256")
    del a, b, at_, bt_, ao, bo

    # -- 7. the attention fold: gemma2-9b and phi3-medium-14b --------------
    torch.cuda.empty_cache()
    bf16 = torch.bfloat16
    g_t, g_d, g_hq, g_hkv = GEMMA["t"], GEMMA["d"], GEMMA["hq"], GEMMA["hkv"]
    cap, win = GEMMA["softcap"], GEMMA["window"]
    p_hq, p_hkv, p_d = PHI3["hq"], PHI3["hkv"], PHI3["d"]
    nb_, cache, t_h = PHI3["batch"], PHI3["cache"], PHI3["prefill"]

    def allclose(got, want, tol):
        """assert_allclose(atol, rtol) with tol = (atol, rtol): (within,
        max |got - want|)."""
        got, want = flat(got), flat(want)
        (atol, rtol), ok, err = tol, True, 0.0
        for a, b in zip(got, want):
            diff = (a.double() - b.double()).abs()
            ok &= bool((diff <= atol + rtol * b.double().abs()).all())
            err = max(err, diff.max().item())
        return ok and len(got) == len(want), err

    def bwd_operands(q, k, v, out, m, l):
        """(q, k, v, dO, m, l, delta) with a random cotangent dO."""
        do = normals(q.shape, q.dtype)
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        return (q, k, v, do, m, l, delta)

    # the main path: counters zeroed just before, read just after
    qf = normals((1, g_hq, g_t, g_d), bf16).requires_grad_()
    kf = normals((1, g_hkv, g_t, g_d), bf16).requires_grad_()
    vf = normals((1, g_hkv, g_t, g_d), bf16).requires_grad_()
    gof = normals((1, g_hq, g_t, g_d), bf16)
    qg = normals((nb_, p_hq, 1, p_d), bf16)
    kg = normals((nb_, p_hkv, cache, p_d), bf16)
    vg = normals((nb_, p_hkv, cache, p_d), bf16)
    qh = normals((1, p_hq, t_h, p_d), bf16).requires_grad_()
    kh = normals((1, p_hkv, t_h, p_d), bf16).requires_grad_()
    vh = normals((1, p_hkv, t_h, p_d), bf16).requires_grad_()
    goh = normals((1, p_hq, t_h, p_d), bf16)
    # (h) and (f)'s global layer in float32 too: a float32 caller takes the
    # 3xTF32 forward, dq and dk/dv (fold_fwd_tf32, fold_dq_tf32,
    # fold_dkv_tf32) at d = 128 and 256
    qh32, kh32, vh32 = (t.detach().float().requires_grad_()
                        for t in (qh, kh, vh))
    qf32m, kf32m, vf32m = (t.detach().float().requires_grad_()
                           for t in (qf, kf, vf))
    routes = {
        "f": fa_ops.resolved_attention_schedule(qf.shape, g_t, cores=sms),
        "g": fa_ops.resolved_attention_schedule(qg.shape, cache, cores=sms),
        "h": fa_ops.resolved_attention_schedule(qh.shape, t_h, cores=sms)}
    print(f"attention routes (auto, {sms} SMs): (f) gemma2-9b training "
          f"{routes['f']}, (g) phi3 decode {routes['g']}, (h) phi3 prefill "
          f"{routes['h']}")
    check(routes == {"f": "carry", "g": "decoupled", "h": "carry"},
          f"attention routes {routes}")
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    trace.enable()
    trace.get().clear()
    cuda_fold.reset_launches()
    main, used = {}, {}

    def counted(what, fn):
        """fn's result and host time; the fold launches it made go to
        used[what]."""
        before = dict(cuda_fold.LAUNCHES)
        out = wall_ms(fn)
        used[what] = {k for k, n in cuda_fold.LAUNCHES.items()
                      if n > before[k]}
        return out

    for layer, window in (("global", None), ("local", win)):
        for sched in ("auto", "decoupled"):
            o, ms_f = counted(f"(f) {layer} {sched} forward",
                              lambda: fa_ops.flash_attention(
                                  qf, kf, vf, softcap=cap, window=window,
                                  schedule=sched))
            grads, ms_b = counted(f"(f) {layer} {sched} backward",
                                  lambda: torch.autograd.grad(
                                      o, (qf, kf, vf), gof))
            main[layer, sched] = (o.detach(),) + grads, ms_f, ms_b
    og, ms_g = counted("(g) forward", lambda: fa_ops.flash_attention(
        qg, kg, vg, causal=False))
    oh, ms_hf = counted("(h) forward",
                        lambda: fa_ops.flash_attention(qh, kh, vh))
    gh, ms_hb = counted("(h) backward", lambda: torch.autograd.grad(
        oh, (qh, kh, vh), goh))
    oh32, ms_h32f = counted("(h) float32 forward",
                            lambda: fa_ops.flash_attention(qh32, kh32, vh32))
    gh32, ms_h32b = counted("(h) float32 backward",
                            lambda: torch.autograd.grad(
                                oh32, (qh32, kh32, vh32), goh.float()))
    of32, ms_f32f = counted("(f) global float32 forward",
                            lambda: fa_ops.flash_attention(
                                qf32m, kf32m, vf32m, softcap=cap))
    gf32, ms_f32b = counted("(f) global float32 backward",
                            lambda: torch.autograd.grad(
                                of32, (qf32m, kf32m, vf32m), gof.float()))
    sync()
    attn_launches = dict(cuda_fold.LAUNCHES)
    attn_events = {}
    for e in trace.get().events():
        if e["name"] == "kernel.launch" and e["args"]["fold"]:
            key = (e["args"]["monoid"], e["args"]["schedule"])
            attn_events[key] = attn_events.get(key, 0) + 1
    trace.disable()
    attn_peak = torch.cuda.max_memory_allocated(dev)
    print(f"attention launches: {attn_launches}; kernel.launch events "
          + ", ".join(f"{m}/{s} x{n}" for (m, s), n in
                      sorted(attn_events.items()))
          + f"; peak memory {attn_peak / 2**30:.2f} GiB")
    # the SIMT forward, dq and dk/dv lie off the main path (float32 takes
    # the 3xTF32 forms at d 128 and 256): they are launched by name below,
    # to be timed beside those forms
    simt_only = ("fold_fwd", "fold_dq", "fold_dkv")
    for k_ in cuda_fold.KERNELS:
        check((attn_launches[k_] > 0) != (k_ in simt_only),
              f"kernel {k_} launched {attn_launches[k_]} times on the "
              "attention path")
    # bf16 calls run the tensor-core forms, float32 calls the 3xTF32
    # forward, dq and dk/dv
    for what, kernels in used.items():
        f32 = "float32" in what
        fwd, dq, dkv = (("fold_fwd_tf32", "fold_dq_tf32", "fold_dkv_tf32")
                        if f32 else ("fold_fwd_tc", "fold_dq_tc",
                                     "fold_dkv_tc"))
        want = {fwd} if "forward" in what else {dq, dkv}
        others = {"fold_fwd", "fold_dq", "fold_dkv", "fold_fwd_tc",
                  "fold_dq_tc", "fold_dkv_tc", "fold_fwd_tf32",
                  "fold_dq_tf32", "fold_dkv_tf32"}
        check(want <= kernels and not (kernels & others) - want,
              f"{what} launched {sorted(kernels)}, wants {sorted(want)}")
    print("fold kernels by call: " + "; ".join(
        f"{what} {'+'.join(sorted(k))}" for what, k in used.items()))
    # the (h) bf16 forward call on the host clock: the main path's call,
    # three calls more, and one under torch.profiler (host and device),
    # before any other attention call of this phase: where the time beyond
    # fold_fwd_tc goes (its CUDA-event median is the fold_fwd_tc_prefill
    # row below)
    again = [wall_ms(lambda: fa_ops.flash_attention(qh, kh, vh))[1]
             for _ in range(3)]
    nograd = [wall_ms(lambda: fa_ops.flash_attention(
        qh.detach(), kh.detach(), vh.detach()))[1] for _ in range(3)]
    sync()
    # the window opens with a spin kernel of its own, left out: the
    # profiler has missed the first launch of its window
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        sync()
        _, traced = wall_ms(lambda: fa_ops.flash_attention(qh, kh, vh))
    host, kern = [], []
    for ev in prof.key_averages():
        if "spin" in ev.key or "_sleep" in ev.key:
            continue
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            kern.append((dev_us / 1e3, ev.key[:48], ev.count))
        else:
            host.append((ev.self_cpu_time_total / 1e3, ev.key[:48],
                         ev.count))
    busy = sum(k[0] for k in kern)
    print(f"(h) bf16 forward on the host clock: main path {ms_hf:.2f} ms, "
          f"then {', '.join(f'{t:.2f}' for t in again)} ms; without "
          f"autograd {', '.join(f'{t:.2f}' for t in nograd)} ms; under the "
          f"profiler {traced:.2f} ms, device busy {busy:.3f} ms (kernels: "
          + ", ".join(f"{n} {t:.3f} ms x{c}" for t, n, c in
                      sorted(kern, reverse=True)[:4])
          + "); host self time by op: "
          + ", ".join(f"{n} {t:.3f} ms x{c}" for t, n, c in
                      sorted(host, reverse=True)[:8]))
    for (layer, sched), (res, ms_f, ms_b) in main.items():
        print(f"(f) gemma2-9b {layer:6s} {sched:9s}: forward {ms_f:8.2f} ms,"
              f" backward {ms_b:8.2f} ms (host clock, one call)")
    print(f"(g) phi3 decode (4 x 40 heads vs 131072 keys), decoupled: "
          f"{ms_g:.2f} ms; (h) phi3 prefill 4096, carry: forward "
          f"{ms_hf:.2f} ms, backward {ms_hb:.2f} ms; in float32 forward "
          f"{ms_h32f:.2f} ms, backward {ms_h32b:.2f} ms; (f) global in "
          f"float32 forward {ms_f32f:.2f} ms, backward {ms_f32b:.2f} ms")
    check(all(bool(torch.isfinite(t).all()) for t in (of32,) + gf32),
          "(f) float32 non-finite output or gradient")
    _, e_f32 = allclose(main["global", "auto"][0], (of32,) + gf32, BF16_TOL)
    print(f"(f) global bf16 (tensor-core forms) vs float32 (its forms) "
          f"through flash_attention: max |diff| {e_f32:.3g} (not gated: the "
          "bf16 inputs' rounding is in it)")
    del of32, gf32, qf32m, kf32m, vf32m
    for res, _, _ in main.values():
        check(all(bool(torch.isfinite(t).all()) for t in res),
              "(f) non-finite output or gradient")
    check(og.shape == qg.shape and bool(torch.isfinite(og).all())
          and bool(torch.isfinite(oh).all())
          and all(bool(torch.isfinite(t).all()) for t in gh),
          "(g)/(h) non-finite output")
    _, e_h32 = allclose((oh,) + gh, (oh32,) + gh32, BF16_TOL)
    print(f"(h) bf16 (tensor-core forms) vs float32 (its forms) through"
          f" flash_attention: max |diff| {e_h32:.3g} (not gated: the bf16 "
          "inputs' rounding is in it)")
    del oh32, gh32
    for layer in ("global", "local"):
        ok, err = allclose(main[layer, "decoupled"][0],
                           main[layer, "auto"][0], BF16_TOL)
        check(ok, f"(f) {layer} bf16 decoupled vs carry: {err}")
        print(f"(f) {layer} bf16: decoupled vs carry (forward and "
              f"gradients) max |diff| {err:.3g} (tolerance {BF16_TOL})")

    # use_kv_bounds on and off, bitwise (forward and gradients)
    o_off = fa_ops.flash_attention(qf, kf, vf, softcap=cap,
                                   use_kv_bounds=False)
    g_off = torch.autograd.grad(o_off, (qf, kf, vf), gof)
    check(all_same_bits((o_off.detach(),) + g_off, main["global", "auto"][0]),
          "(f) use_kv_bounds off != on bitwise")
    del o_off, g_off
    # count_cells against the analytic live cells
    flat_f = [t.detach().reshape(-1, g_t, g_d) for t in (qf, kf, vf)]
    shapes_f = (flat_f[0].shape, flat_f[1].shape)
    # flash_attention_kernel's keywords at (f): those flash_attention uses
    kw_f = dict(group=g_hq // g_hkv, scale=g_d ** -0.5, causal=True,
                softcap=cap)
    for layer, window, want_cells in (("global", None, 2080),
                                      ("local", win, 1584)):
        _, lay = forward_fold(*shapes_f, window=window, **kw_f)
        out_c, counts = flash_attention_kernel(
            *flat_f, window=window, count_cells=True, **kw_f)
        out_n = flash_attention_kernel(*flat_f, window=window, **kw_f)
        check(lay.active_cells() == want_cells
              and int(counts.sum()) == g_hq * want_cells
              and torch.equal(counts.sum(1).cpu(), torch.full(
                  (g_hq,), want_cells, dtype=torch.int64)),
              f"(f) {layer} count_cells {int(counts.sum())} != "
              f"{g_hq} x {want_cells}")
        check(same_bits(out_c, out_n), "count_cells changed the output")
        print(f"(f) {layer}: count_cells {int(counts.sum())} = {g_hq} x "
              f"{lay.active_cells()} live of {lay.nq * lay.nk} cells per "
              "head (_active_cell_count); output bitwise unchanged")
    del out_c, out_n, counts
    # a page-permuted decode cache through kv_block_map, bitwise
    # the decode's flattened, padded operands and kernel keywords, as
    # flash_attention builds them (q padded to 8 rows)
    (qg8, kgf, vgf), dec = fa_ops.kernel_inputs(qg, kg, vg, fa_ops.FlashConfig(
        scale=p_d ** -0.5, causal=False, window=None, softcap=None,
        block_q=128, block_k=128, schedule="decoupled", kv_splits=None,
        use_kv_bounds=True))
    nkb = cache // 128
    perm = torch.randperm(nkb, device=dev, generator=gen)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(nkb, device=dev)
    kgp = kgf.view(-1, nkb, 128, p_d)[:, inv].reshape(kgf.shape)
    vgp = vgf.view(-1, nkb, 128, p_d)[:, inv].reshape(vgf.shape)
    o_c = flash_attention_kernel(qg8, kgf, vgf, **dec)
    o_p = flash_attention_kernel(qg8, kgp, vgp, kv_block_map=perm, **dec)
    check(same_bits(o_c, o_p), "(g) kv_block_map != contiguous bitwise")
    check(same_bits(o_c[:, :1].reshape(og.shape), og),
          "(g) kernel entry point != flash_attention")
    del kgp, vgp, o_p, o_c
    print("(f) use_kv_bounds off == on bitwise (forward, dq, dk, dv); (g) "
          f"a random permutation of the {nkb} cache pages through "
          "kv_block_map == the contiguous cache bitwise")
    # the bf16 forward, dq and dk/dv at zamba2-7b's head dim 112
    # (fold_fwd_tc, fold_dq_tc and fold_dkv_tc at D 128, the columns past
    # 112 read as zeros) on a ragged 2500-token prompt, as its second
    # request has: the carry fold, and the split pass (payloads against
    # the plain split pass, at stride 112) then the chain, each against
    # the plain folds (these launches are not the main path's); dq and
    # dk/dv on the plain forward's (out, m, l) and a random dO
    z_h, z_d, z_t = 32, 112, 2500
    qz, kz, vz = (normals((1, z_h, z_t, z_d), bf16) for _ in range(3))
    e_z = {}
    for sched in ("carry", "decoupled"):
        ops_zt, kw_zt = fa_ops.kernel_inputs(qz, kz, vz, fa_ops.FlashConfig(
            scale=z_d ** -0.5, causal=True, window=None, softcap=None,
            block_q=128, block_k=128, schedule=sched, kv_splits=None,
            use_kv_bounds=True))
        spec_zt, lay_zt = forward_fold(ops_zt[0].shape, ops_zt[1].shape,
                                       return_stats=True, **kw_zt)
        check(cuda_fold.fold_form("fold_fwd", bf16, z_d, lay_zt.bq,
                                  lay_zt.bk) == "fold_fwd_tc"
              and (lay_zt.splits > 1) == (sched == "decoupled"),
              f"d 112 {sched}: form or splits ({lay_zt.splits})")
        want = schedules.fold_carry_plain(ops_zt, spec_zt, lay_zt)
        before = cuda_fold.LAUNCHES["fold_fwd_tc"]
        if sched == "carry":
            got = cuda_fold.fold(spec_zt, ops_zt, lay_zt)[0]
        else:
            tot = cuda_fold.fold_totals(spec_zt, ops_zt, lay_zt)
            ok, e_z["split"] = allclose(tot, schedules.fold_totals_plain(
                ops_zt, spec_zt, lay_zt), BF16_TOL)
            check(ok, f"d 112 split pass vs plain: {e_z['split']}")
            got = cuda_fold.chain(spec_zt, tot, lay_zt,
                                  (bf16, torch.float32, torch.float32))
            del tot
        sync()
        check(cuda_fold.LAUNCHES["fold_fwd_tc"] == before + 1,
              f"d 112 {sched}: fold_fwd_tc not launched once")
        ok, e_z[sched] = allclose(got, want, BF16_TOL)
        check(ok, f"d 112 {sched} vs plain: {e_z[sched]}")
        ops_zb = bwd_operands(*ops_zt, *want)
        del got, want
        for kern, (spec_b, lay_b) in zip(
                ("fold_dq", "fold_dkv"),
                backward_folds(ops_zt[0].shape, ops_zt[1].shape, **kw_zt)):
            form = kern + "_tc"
            check(cuda_fold.fold_form(kern, bf16, z_d, lay_b.bq, lay_b.bk)
                  == form and (lay_b.splits > 1) == (sched == "decoupled"),
                  f"d 112 {sched} {kern}: form or splits ({lay_b.splits})")
            want = schedules.fold_carry_plain(ops_zb, spec_b, lay_b)
            before = dict(cuda_fold.LAUNCHES)
            if sched == "carry":
                got = cuda_fold.fold(spec_b, ops_zb, lay_b)[0]
            else:
                tot = cuda_fold.fold_totals(spec_b, ops_zb, lay_b)
                ok, e_z[form, "split"] = allclose(
                    tot, schedules.fold_totals_plain(ops_zb, spec_b, lay_b),
                    BF16_TOL)
                check(ok, f"d 112 {form} split pass vs plain: "
                      f"{e_z[form, 'split']}")
                got = cuda_fold.chain(spec_b, tot, lay_b,
                                      (bf16,) * len(lay_b.out_dims))
                del tot
            sync()
            check(cuda_fold.LAUNCHES[form] == before[form] + 1
                  and cuda_fold.LAUNCHES[kern] == before[kern],
                  f"d 112 {sched}: {form} not launched once, or {kern} "
                  "launched")
            ok, e_z[form, sched] = allclose(got, want, BF16_TOL)
            check(ok, f"d 112 {form} {sched} vs plain: {e_z[form, sched]}")
            del got, want
        del ops_zt, ops_zb
    del qz, kz, vz
    print(f"(i)-width attention, bf16 at d 112 ({z_h} heads, ragged Tq "
          f"{z_t}, causal) through fold_fwd_tc, fold_dq_tc and fold_dkv_tc "
          f"at D 128 against the plain folds (max |diff|; (atol, rtol) "
          f"{BF16_TOL}): forward carry {e_z['carry']:.3g}, decoupled split "
          f"pass {e_z['split']:.3g}, through the chain "
          f"{e_z['decoupled']:.3g}; " + "; ".join(
              f"{f} carry {e_z[f, 'carry']:.3g}, split pass "
              f"{e_z[f, 'split']:.3g}, through the chain "
              f"{e_z[f, 'decoupled']:.3g}"
              for f in ("fold_dq_tc", "fold_dkv_tc")))
    # fully masked rows (q past kv_len + window): exactly 0, zero grads
    qm, km, vm = (normals((g_hq if i == 0 else g_hkv, 1024, g_d), bf16)
                  for i in range(3))
    mk = dict(group=2, scale=g_d ** -0.5, causal=True, window=128,
              kv_len=256)
    for sched in ("carry", "decoupled"):
        om, mm_, lm = flash_attention_kernel(qm, km, vm, schedule=sched,
                                             return_stats=True, **mk)
        gm = torch.zeros_like(om)
        gm[:, 384:] = om[:, 384:] * 2 + 1
        dm = (gm.float() * om.float()).sum(-1, keepdim=True)
        dqm, dkm, dvm = flash_attention_bwd_kernel(
            qm, km, vm, gm, mm_, lm, dm, schedule=sched, **mk)
        check(not bool(om[:, 384:].any()) and bool(om[:, :384].any())
              and not any(bool(t.any()) for t in (dqm, dkm, dvm))
              and all(bool(torch.isfinite(t).all())
                      for t in (om, dqm, dkm, dvm)),
              f"fully masked rows ({sched}): output or gradients not 0")
    del qm, km, vm, om, gm, dqm, dkm, dvm
    print("fully masked rows (kv_len 256, window 128: rows >= 384): output "
          "exactly 0, dq = dk = dv = 0 under carry and decoupled")

    # kernels vs plain versions in float32 at the (f) and (g) shapes
    qf32, kf32, vf32 = (t.float() for t in flat_f)
    spec_c, lay_c = forward_fold(*shapes_f, return_stats=True, **kw_f)
    ops_c = (qf32, kf32, vf32)
    got, _ = cuda_fold.fold(spec_c, ops_c, lay_c)
    want = schedules.fold_carry_plain(ops_c, spec_c, lay_c)
    ok, e_fwd = allclose(got, want, FWD_TOL)
    check(ok, f"fold_fwd f32 vs plain: {e_fwd}")

    def fwd_split(spec, ops, lay, tag):
        """The float32 forward's split pass: the chunks' (m, l) against the
        plain split pass, and through the chain kernel (out, m, l) against
        the plain decoupled fold, within FWD_TOL. The chunks' acc,
        unnormalized and relative to each chunk's max, is held to float64
        (fwd_split_f64): against the plain float32 products it measures
        their rounding as well (on the card the plain payload lies
        further from float64 than the 3xTF32 one). Returns the totals and
        the two max |err|."""
        tot = cuda_fold.fold_totals(spec, ops, lay)
        w_tot = schedules.fold_totals_plain(ops, spec, lay)
        ok, e_ml = allclose(tot[:2], w_tot[:2], FWD_TOL)
        check(ok, f"{tag} split pass (m, l) vs plain: {e_ml}")
        dts = (torch.float32,) * 3
        ok, e_out = allclose(cuda_fold.chain(spec, tot, lay, dts),
                             schedules.fold_finalize_plain(spec, lay, w_tot,
                                                           dts), FWD_TOL)
        check(ok, f"{tag} split pass + chain vs plain decoupled: {e_out}")
        return tot, e_ml, e_out

    def fwd_split_f64(ops, kw, tag):
        """The split pass's chunk payloads (m, l, acc) of two q heads of
        the first kv head against float64 within FWD_TOL; the plain
        version's max |err| against float64 beside."""
        q2, k1, v1 = ops[0][:2], ops[1][:1], ops[2][:1]
        spec2, lay2 = forward_fold(q2.shape, k1.shape, schedule="decoupled",
                                   return_stats=True, **dict(kw, group=2))
        # rounded to float32: a fully masked chunk's m is NEG_INF there
        want = tuple(w.float() for w in fa_ref.split_payload_ref(
            q2.double(), k1.double(), v1.double(), spec2, lay2))
        ok, e_k = allclose(cuda_fold.fold_totals(spec2, (q2, k1, v1), lay2),
                           want, FWD_TOL)
        check(ok, f"{tag} split payload vs float64: {e_k}")
        _, e_p = allclose(schedules.fold_totals_plain((q2, k1, v1), spec2,
                                                      lay2), want, FWD_TOL)
        return e_k, e_p

    # the global layer's split pass (16 chunks), and bounds on / off and a
    # page-permuted pool through kv_block_map, bitwise
    spec_gs, lay_gs = forward_fold(*shapes_f, schedule="decoupled",
                                   return_stats=True, **kw_f)
    _, e_fgs, e_fgo = fwd_split(spec_gs, ops_c, lay_gs, "(f) global f32")
    e_fg64 = fwd_split_f64(ops_c, kw_f, "(f) global f32")

    def fwd_invariants(spec, ops, lay, out, tag):
        """The forward fold with bounds off, and through a random
        permutation of the kv pages (kv_block_map), gives ``out``'s bits."""
        lay_off = dataclasses.replace(lay, kv_bounds=None)
        check(all_same_bits(cuda_fold.fold(spec, ops, lay_off)[0], out),
              f"{tag}: bounds off != on bitwise")
        pages = lay.nk
        perm = torch.randperm(pages, device=dev, generator=gen)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(pages, device=dev)
        paged = tuple(t.view(t.shape[0], pages, lay.bk, t.shape[2])[:, inv]
                      .reshape(t.shape) for t in ops[1:])
        lay_pg = dataclasses.replace(lay, kv_block_map=perm.to(torch.int32))
        check(all_same_bits(cuda_fold.fold(spec, (ops[0],) + paged,
                                           lay_pg)[0], out),
              f"{tag}: kv_block_map != contiguous bitwise")

    fwd_invariants(spec_c, ops_c, lay_c, got, "(f) global float32 forward")
    out32, m32, l32 = got
    ops_b = bwd_operands(qf32, kf32, vf32, out32, m32, l32)
    (sq, lq), (sk, lk) = backward_folds(*shapes_f, **kw_f)
    ok, e_dq = allclose(cuda_fold.fold(sq, ops_b, lq)[0],
                        schedules.fold_carry_plain(ops_b, sq, lq), GRAD_TOL)
    check(ok, f"fold_dq f32 vs plain: {e_dq}")
    ok, e_dkv = allclose(cuda_fold.fold(sk, ops_b, lk)[0],
                         schedules.fold_carry_plain(ops_b, sk, lk), GRAD_TOL)
    check(ok, f"fold_dkv f32 vs plain: {e_dkv}")
    # carry vs decoupled (float32), forward and gradients
    o_cy = flash_attention_kernel(*ops_c, **kw_f)
    o_dc = flash_attention_kernel(*ops_c, schedule="decoupled", **kw_f)
    g_cy = flash_attention_bwd_kernel(*ops_b, **kw_f)
    g_dc = flash_attention_bwd_kernel(*ops_b, schedule="decoupled", **kw_f)
    ok, e_cd = allclose((o_dc,) + g_dc, (o_cy,) + g_cy, FWD_TOL)
    check(ok, f"(f) f32 carry vs decoupled: {e_cd}")
    check(same_bits(o_cy, out32), "flash_attention_kernel != fold kernel")
    del o_dc, g_cy, g_dc
    # the split pass and chain of the local layer, float32
    spec_s, lay_s = forward_fold(*shapes_f, window=win, schedule="decoupled",
                                 return_stats=True, **kw_f)
    tot, e_tot, e_too = fwd_split(spec_s, ops_c, lay_s, "(f) local f32")
    out_dts = (torch.float32,) * 3
    ok, e_ch = allclose(cuda_fold.chain(spec_s, tot, lay_s, out_dts),
                        schedules.fold_finalize_plain(spec_s, lay_s, tot,
                                                      out_dts), FWD_TOL)
    check(ok, f"fold_chain f32 vs plain: {e_ch}")
    o_loc = cuda_fold.chain(spec_s, tot, lay_s, out_dts)
    ops_bl = bwd_operands(qf32, kf32, vf32, *o_loc)
    (sq_s, lq_s), (sk_s, lk_s) = backward_folds(
        *shapes_f, window=win, schedule="decoupled", **kw_f)
    e_bwd = {}
    for what, sp, ly in (("dq", sq_s, lq_s), ("dkv", sk_s, lk_s)):
        tot_b = cuda_fold.fold_totals(sp, ops_bl, ly)
        ok, e_bwd[what] = allclose(
            tot_b, schedules.fold_totals_plain(ops_bl, sp, ly), GRAD_TOL)
        check(ok, f"fold_{what} split pass f32 vs plain: {e_bwd[what]}")
        # the chain of the sum specs (fold_chain_sum)
        dts = (torch.float32,) * len(tot_b)
        ok, e_bwd[what + " chain"] = allclose(
            cuda_fold.chain(sp, tot_b, ly, dts),
            schedules.fold_finalize_plain(sp, ly, tot_b, dts), GRAD_TOL)
        check(ok, f"fold_chain ({what}) f32 vs plain: "
              f"{e_bwd[what + ' chain']}")
        del tot_b
    del tot, o_loc, ops_bl
    # the forward against float64 dense attention, two heads
    o2 = flash_attention_kernel(qf32[:2], kf32[:1], vf32[:1], **kw_f)
    ref64 = fa_ref.mha_ref(qf32[:2].double(), kf32[:1].double(),
                           vf32[:1].double(), **kw_f)
    ok, e_64 = allclose(o2, ref64, DENSE_TOL)
    check(ok, f"(f) vs float64 dense: {e_64}")
    del o2, ref64, ops_b, got, want
    # the decode shape, float32: the split pass and the chain
    qg32, kg32, vg32 = qg8.float(), kgf.float(), vgf.float()
    spec_g, lay_g = forward_fold(qg8.shape, kgf.shape, **dec)
    ops_g = (qg32, kg32, vg32)
    tot_g = cuda_fold.fold_totals(spec_g, ops_g, lay_g)
    ok, e_gt = allclose(tot_g, schedules.fold_totals_plain(ops_g, spec_g,
                                                           lay_g), FWD_TOL)
    check(ok, f"(g) fold_fwd split pass f32 vs plain: {e_gt}")
    ok, e_gc = allclose(
        cuda_fold.chain(spec_g, tot_g, lay_g, (torch.float32,)),
        schedules.fold_finalize_plain(spec_g, lay_g, tot_g,
                                      (torch.float32,)), FWD_TOL)
    check(ok, f"(g) fold_chain f32 vs plain: {e_gc}")
    del qg32, kg32, vg32, tot_g, ops_g
    # the (h) shape in float32: the kernels' d = 128 tiling
    ops_h32 = tuple(t.detach().reshape(-1, t_h, p_d).float()
                    for t in (qh, kh, vh))
    shapes_h = (ops_h32[0].shape, ops_h32[1].shape)
    kw_h = dict(group=p_hq // p_hkv, scale=p_d ** -0.5, causal=True)
    spec_h, lay_h = forward_fold(*shapes_h, return_stats=True, **kw_h)
    got_h, _ = cuda_fold.fold(spec_h, ops_h32, lay_h)
    ok, e_h = allclose(got_h, schedules.fold_carry_plain(ops_h32, spec_h,
                                                         lay_h), FWD_TOL)
    check(ok, f"(h) fold_fwd f32 vs plain: {e_h}")
    spec_hs, lay_hs = forward_fold(*shapes_h, schedule="decoupled",
                                   return_stats=True, **kw_h)
    _, e_hs, e_hso = fwd_split(spec_hs, ops_h32, lay_hs, "(h) f32")
    e_h64 = fwd_split_f64(ops_h32, kw_h, "(h) f32")
    fwd_invariants(spec_h, ops_h32, lay_h, got_h, "(h) float32 forward")
    ops_bh32 = bwd_operands(*ops_h32, *got_h)
    e_hb = {}
    for what, (sp, ly) in zip(("dq", "dkv"),
                              backward_folds(*shapes_h, **kw_h)):
        ok, e_hb[what] = allclose(
            cuda_fold.fold(sp, ops_bh32, ly)[0],
            schedules.fold_carry_plain(ops_bh32, sp, ly), GRAD_TOL)
        check(ok, f"(h) fold_{what} f32 vs plain: {e_hb[what]}")
    # and the split pass of the decoupled schedule at (h)
    for what, (sp, ly) in zip(("dq", "dkv"), backward_folds(
            *shapes_h, schedule="decoupled", **kw_h)):
        ok, e_hb[what + " split"] = allclose(
            cuda_fold.fold_totals(sp, ops_bh32, ly),
            schedules.fold_totals_plain(ops_bh32, sp, ly), GRAD_TOL)
        check(ok, f"(h) fold_{what} split pass f32 vs plain: "
              f"{e_hb[what + ' split']}")
    del ops_h32, got_h, ops_bh32
    f32_fwd, f32_dq, f32_dkv = (
        cuda_fold.fold_form(k_, torch.float32, g_d, 128, 128)
        for k_ in ("fold_fwd", "fold_dq", "fold_dkv"))
    print(f"float32 kernels vs plain (max |diff|; (atol, rtol) {FWD_TOL} "
          f"forward, {GRAD_TOL} gradients): (f) {f32_fwd} "
          f"{e_fwd:.3g} (global split pass: (m, l) {e_fgs:.3g}, through "
          f"the chain {e_fgo:.3g}, payload of two heads vs float64 "
          f"{e_fg64[0]:.3g} (the plain version's {e_fg64[1]:.3g}); bounds "
          f"off and kv_block_map bitwise), {f32_dq} {e_dq:.3g}, {f32_dkv} "
          f"{e_dkv:.3g}; local "
          f"split passes fwd (m, l) {e_tot:.3g} (through the chain "
          f"{e_too:.3g}), dq {e_bwd['dq']:.3g}, dkv "
          f"{e_bwd['dkv']:.3g}; chains fwd {e_ch:.3g}, dq "
          f"{e_bwd['dq chain']:.3g}, dkv {e_bwd['dkv chain']:.3g}; (g) split "
          f"pass (SIMT, bq 8) {e_gt:.3g}, chain {e_gc:.3g}; (h) fwd "
          f"{e_h:.3g} (split pass: (m, l) {e_hs:.3g}, through the chain "
          f"{e_hso:.3g}, payload of two heads vs float64 {e_h64[0]:.3g} (the "
          f"plain version's {e_h64[1]:.3g}); bounds off and kv_block_map "
          f"bitwise), "
          f"dq {e_hb['dq']:.3g} (split pass {e_hb['dq split']:.3g}), dkv "
          f"{e_hb['dkv']:.3g} (split pass {e_hb['dkv split']:.3g}); carry vs "
          f"decoupled {e_cd:.3g}; (f) vs float64 dense attention (2 heads) "
          f"{e_64:.3g} ((atol, rtol) {DENSE_TOL})")
    torch.cuda.empty_cache()

    def sdpa_backend(fn):
        """The SDPA backend a default call takes: the first whose forced
        call gives the default's bits."""
        from torch.nn.attention import SDPBackend, sdpa_kernel
        want = fn()
        for b in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                  SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel([b]):
                    got = fn()
            except RuntimeError:   # this backend refuses the inputs
                continue
            if same_bits(got, want):
                return b.name
        return "not identified"

    # each fold kernel's time at its main-path shape (bf16; float32 for
    # the SIMT forward, dq and dk/dv, which bf16 no longer reaches there)
    def attn_row(rname, kernel, replaces, run, run_plain, nbytes, flops,
                 library, shape, reps=3, tol=BF16_TOL, bitwise=False,
                 graph=False, launches=None, rel=None):
        """``bitwise``: the kernel also gives the plain version's bits;
        ``graph``: also the kernel's time from a CUDA graph replay;
        ``launches``: the kernel's launches on its main path where that is
        not the attention phase's; ``rel``: also hold each output's
        max |got - want| within rel x its max |want|, a bar that scales
        with the outputs."""
        got, want = flat(run()), flat(run_plain())
        sync()
        ok, err = allclose(got, want, tol)
        check(ok, f"{rname}: kernel vs plain at the main-path shape: {err}")
        for i, (a, b) in enumerate(zip(got, want) if rel else ()):
            w_max = b.double().abs().max().item()
            d_max = (a.double() - b.double()).abs().max().item()
            print(f"  {rname} output {i}: max |kernel - plain| {d_max:.4g}, "
                  f"max |plain| {w_max:.4g} (bar {rel:.4g} x max |plain|)")
            check(w_max > 0 and d_max <= rel * w_max,
                  f"{rname} output {i}: max |diff| {d_max} against max "
                  f"|plain| {w_max}")
        check(not bitwise or all_same_bits(got, want),
              f"{rname}: kernel != plain bitwise at the main-path shape")
        del got, want
        ms = time_ms(run, reps)
        plain_ms = time_ms(run_plain, 1, warmup=0)
        lib_ms = None if library is None else time_ms(library, reps)
        # the peak of the products' type: bf16 on the tensor cores, float32
        # (the SIMT kernels' type) on the CUDA cores, and for the 3xTF32
        # form three TF32 products a product on the tensor cores
        if kernel in cuda_fold.TF32_FORMS:
            t_ops = 3 * flops / tf32_peak * 1e3
        else:
            t_ops = flops / (f32_peak if tol != BF16_TOL else bf16_peak) * 1e3
        t_bytes = nbytes / bw * 1e3
        b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (
            t_bytes, "bytes")
        source = ATTN_TC_SOURCE if kernel in cuda_fold.TC_FORMS else \
            ATTN_SOURCE
        rows.append({
            "name": rname, "route": "cuda", "source": source,
            "replaces": ATTN_REPLACES[replaces],
            "launches": (attn_launches[kernel] if launches is None
                         else launches), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms})
        print(f"kernel {rname:20s} {shape:30s}: {ms:9.3f} ms  plain "
              f"{plain_ms:10.3f} ms  bound {b_ms:.4f} ms ({b_by}; float32 "
              f"non-tensor {flops / f32_peak * 1e3:.3f} ms)  library "
              f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'}")
        if graph:
            g_ms = graph_ms(run)
            print(f"  {rname} from a CUDA graph replay (20 calls, no host "
                  f"launch cost): "
                  f"{'not measured' if g_ms is None else f'{g_ms:.4f} ms'} "
                  "a call")

    def softmax_chain_first_form(tot, lay, out_dts):
        """fold_chain_softmax_kernel's first form (a thread a (row,
        column)), transcribed: from (NEG_INF, 0, 0), mn = max(m,
        m2), the weights exp(m - mn), exp(m2 - mn), l and acc folded split
        by split, then acc / l (l == 0 guarded) and the row's (m, l)."""
        m2, l2, a2 = tot
        m = torch.full_like(m2[:, 0], assoc.NEG_INF)
        l, acc = torch.zeros_like(l2[:, 0]), torch.zeros_like(a2[:, 0])
        for s_ in range(m2.shape[1]):
            mn = torch.maximum(m, m2[:, s_])
            w1, w2 = torch.exp(m - mn), torch.exp(m2[:, s_] - mn)
            l = l * w1 + l2[:, s_] * w2
            acc = acc * w1 + a2[:, s_] * w2
            m = mn
        outs = (acc / torch.where(l == 0.0, 1.0, l), m, l)[:len(out_dts)]
        return tuple(lay.unchain_out(o).to(dt)
                     for o, dt in zip(outs, out_dts))

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    cell = 128 * 128
    ops_f = tuple(flat_f)
    for layer, window, splits in (("global", None, 1), ("local", win, 16)):
        tag = "" if splits == 1 else "_split"
        which = "carry" if splits == 1 else "split"
        sched = "carry" if splits == 1 else "decoupled"
        spec, lay = forward_fold(*shapes_f, window=window, schedule=sched,
                                 return_stats=True, **kw_f)
        check(lay.splits == splits, f"(f) {layer}: {lay.splits} splits")
        live = g_hq * lay.active_cells()
        outs = (cuda_fold.fold(spec, ops_f, lay)[0] if splits == 1 else
                cuda_fold.chain(spec, cuda_fold.fold_totals(spec, ops_f, lay),
                                lay, (bf16, torch.float32, torch.float32)))
        ops_bf = bwd_operands(*ops_f, *outs)
        (sq, lq), (sk, lk) = backward_folds(*shapes_f, window=window,
                                            schedule=sched, **kw_f)
        shape = f"(f) {layer} 16x8192x256"
        if splits == 1:
            fwd = (lambda: cuda_fold.fold(spec, ops_f, lay)[0],
                   lambda: schedules.fold_carry_plain(ops_f, spec, lay))
            dq = (lambda: cuda_fold.fold(sq, ops_bf, lq)[0],
                  lambda: schedules.fold_carry_plain(ops_bf, sq, lq))
            dkv = (lambda: cuda_fold.fold(sk, ops_bf, lk)[0],
                   lambda: schedules.fold_carry_plain(ops_bf, sk, lk))
            out_b = nbytes(*outs)
            dq_b, dkv_b = nbytes(ops_f[0]), nbytes(*ops_f[1:])
        else:
            fwd = (lambda: cuda_fold.fold_totals(spec, ops_f, lay),
                   lambda: schedules.fold_totals_plain(ops_f, spec, lay))
            dq = (lambda: cuda_fold.fold_totals(sq, ops_bf, lq),
                  lambda: schedules.fold_totals_plain(ops_bf, sq, lq))
            dkv = (lambda: cuda_fold.fold_totals(sk, ops_bf, lk),
                   lambda: schedules.fold_totals_plain(ops_bf, sk, lk))
            out_b = 4 * lay.bh * lay.nq * splits * 128 * (g_d + 2)
            dq_b = 4 * lq.bh * lq.nq * splits * 128 * g_d
            dkv_b = 8 * lk.bh_kv * lk.nk * splits * 128 * g_d
        attn_row(f"fold_fwd_tc{tag}", "fold_fwd_tc", which, *fwd,
                 nbytes(*ops_f) + out_b, 4 * cell * g_d * live, None, shape)
        attn_row(f"fold_dq_tc{tag}", "fold_dq_tc", which, *dq,
                 nbytes(*ops_bf) + dq_b, 6 * cell * g_d * live, None, shape)
        attn_row(f"fold_dkv_tc{tag}", "fold_dkv_tc", which, *dkv,
                 nbytes(*ops_bf) + dkv_b, 8 * cell * g_d * live, None, shape)
        if splits > 1:   # the chain of the sum specs (fold_chain_sum)
            for rname, (sp, ly) in (("fold_chain_dq", (sq, lq)),
                                    ("fold_chain_dkv", (sk, lk))):
                tot_b = cuda_fold.fold_totals(sp, ops_bf, ly)
                dts = (bf16,) * len(tot_b)
                out_b = sum(2 * torch.Size(ly.out_shape_for(i)).numel()
                            for i in range(len(tot_b)))
                attn_row(rname, "fold_chain_sum", "chain",
                         lambda: cuda_fold.chain(sp, tot_b, ly, dts),
                         lambda: schedules.fold_finalize_plain(sp, ly, tot_b,
                                                               dts),
                         nbytes(*tot_b) + out_b, nbytes(*tot_b) // 4, None,
                         f"{shape}, 16 splits")
                del tot_b
            # the forward's chain and finalize (fold_chain), with the
            # statistics, as the decoupled forward runs it
            tot_f = cuda_fold.fold_totals(spec, ops_f, lay)
            dts = (bf16, torch.float32, torch.float32)
            attn_row("fold_chain_local", "fold_chain", "chain",
                     lambda: cuda_fold.chain(spec, tot_f, lay, dts),
                     lambda: schedules.fold_finalize_plain(spec, lay, tot_f,
                                                           dts),
                     nbytes(*tot_f, *outs), 6 * tot_f[2].numel(), None,
                     f"{shape}, 16 splits", bitwise=True, graph=True)
            check(all_same_bits(cuda_fold.chain(spec, tot_f, lay, dts),
                                softmax_chain_first_form(tot_f, lay, dts)),
                  "(f) local fold_chain != its first form")
            del tot_f
        if splits == 1:
            fold_ms = sum(r["ms"] for r in rows[-3:])

            def train_step():
                o = fa_ops.flash_attention(qf, kf, vf, softcap=cap)
                return torch.autograd.grad(o, (qf, kf, vf), gof)

            step_ms = statistics.median(wall_ms(train_step)[1]
                                        for _ in range(3))
            print(f"(f) global forward + backward: {step_ms:.1f} ms host "
                  f"clock (median of 3), of which the three fold kernels' "
                  f"medians {fold_ms:.1f} ms: device idle share at most "
                  f"{1 - fold_ms / step_ms:.3f}")
        del outs, ops_bf
    # (g) the decode's split pass and chain; SDPA on the whole forward
    spec_g, lay_g = forward_fold(qg8.shape, kgf.shape, **dec)
    ops_g = (qg8, kgf, vgf)
    tot_g = cuda_fold.fold_totals(spec_g, ops_g, lay_g)
    lib_g = time_ms(lambda: F.scaled_dot_product_attention(
        qg, kg, vg, enable_gqa=True), 5)
    backend_g = sdpa_backend(lambda: F.scaled_dot_product_attention(
        qg, kg, vg, enable_gqa=True))
    split_b = nbytes(*tot_g)
    attn_row("fold_fwd_tc_decode", "fold_fwd_tc", "split",
             lambda: cuda_fold.fold_totals(spec_g, ops_g, lay_g),
             lambda: schedules.fold_totals_plain(ops_g, spec_g, lay_g),
             nbytes(*ops_g) + split_b, 4 * nb_ * p_hq * cache * p_d, None,
             "(g) 160x1(8) vs 40x131072x128", reps=5)
    attn_row("fold_chain", "fold_chain", "chain",
             lambda: cuda_fold.chain(spec_g, tot_g, lay_g, (bf16,)),
             lambda: schedules.fold_finalize_plain(spec_g, lay_g, tot_g,
                                                   (bf16,)),
             split_b + nb_ * p_hq * 8 * p_d * 2, 6 * split_b // 4, None,
             "(g) 160x8 rows x 16 splits", reps=5, bitwise=True, graph=True)
    check(all_same_bits(cuda_fold.chain(spec_g, tot_g, lay_g, (bf16,)),
                        softmax_chain_first_form(tot_g, lay_g, (bf16,))),
          "(g) fold_chain != its first form")
    dec_ms = rows[-2]["ms"] + rows[-1]["ms"]
    print(f"(g) decode: split pass + chain {dec_ms:.3f} ms; "
          f"scaled_dot_product_attention(enable_gqa=True) {lib_g:.3f} ms "
          f"({backend_g} backend); "
          f"bound {2 * nbytes(kgf) / bw * 1e3:.3f} ms (reading the cache)")
    del tot_g, ops_g, kg, vg, kgf, vgf
    # (h) the prefill's carry folds; SDPA forward and backward
    ops_h = tuple(t.detach().reshape(-1, t_h, p_d) for t in (qh, kh, vh))
    spec_h, lay_h = forward_fold(*shapes_h, return_stats=True, **kw_h)
    live_h = p_hq * lay_h.active_cells()
    outs_h, _ = cuda_fold.fold(spec_h, ops_h, lay_h)
    ops_bh = bwd_operands(*ops_h, *outs_h)
    (sq, lq), (sk, lk) = backward_folds(*shapes_h, **kw_h)
    qs, ks, vs = (t.detach().requires_grad_() for t in (qh, kh, vh))
    o_s = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                         enable_gqa=True)
    lib_hf = time_ms(lambda: F.scaled_dot_product_attention(
        qh.detach(), kh.detach(), vh.detach(), is_causal=True,
        enable_gqa=True), 5)
    lib_hb = time_ms(lambda: torch.autograd.grad(
        o_s, (qs, ks, vs), goh, retain_graph=True), 5)
    backend_h = sdpa_backend(lambda: F.scaled_dot_product_attention(
        qh.detach(), kh.detach(), vh.detach(), is_causal=True,
        enable_gqa=True))
    shape = "(h) 40x4096x128 causal"
    attn_row("fold_fwd_tc_prefill", "fold_fwd_tc", "carry",
             lambda: cuda_fold.fold(spec_h, ops_h, lay_h)[0],
             lambda: schedules.fold_carry_plain(ops_h, spec_h, lay_h),
             nbytes(*ops_h, *outs_h), 4 * cell * p_d * live_h,
             lambda: F.scaled_dot_product_attention(
                 qh.detach(), kh.detach(), vh.detach(), is_causal=True,
                 enable_gqa=True), shape, reps=5)
    for rname, kernel, (sp, ly), fl in (
            ("fold_dq_tc_prefill", "fold_dq_tc", (sq, lq), 6),
            ("fold_dkv_tc_prefill", "fold_dkv_tc", (sk, lk), 8)):
        outs_k = cuda_fold.fold(sp, ops_bh, ly)[0]
        attn_row(rname, kernel, "carry",
                 lambda: cuda_fold.fold(sp, ops_bh, ly)[0],
                 lambda: schedules.fold_carry_plain(ops_bh, sp, ly),
                 nbytes(*ops_bh, *outs_k), fl * cell * p_d * live_h,
                 lambda: torch.autograd.grad(o_s, (qs, ks, vs), goh,
                                             retain_graph=True),
                 shape, reps=5)
    print(f"(h) prefill: SDPA ({backend_h} backend) forward "
          f"{lib_hf:.3f} ms, backward (dq, dk, "
          f"dv together; the library time of the dq and dkv rows) "
          f"{lib_hb:.3f} ms; fold_dq_tc + fold_dkv_tc "
          f"{rows[-2]['ms'] + rows[-1]['ms']:.3f} ms")
    del outs_h, ops_bh
    # (h) in float32: the SIMT forward, the 3xTF32 dq and dk/dv, SDPA in
    # float32 beside; then, launched by name after the main path (a
    # comparison: no launch of theirs on the main path), the SIMT dq and
    # dk/dv those forms replaced, at the same shape in the same run
    ops_h32 = tuple(t.float() for t in ops_h)
    outs_h32, _ = cuda_fold.fold(spec_h, ops_h32, lay_h)
    ops_bh32 = bwd_operands(*ops_h32, *outs_h32)
    qs32, ks32, vs32 = (t.detach().requires_grad_() for t in (qh32, kh32,
                                                              vh32))
    o_s32 = F.scaled_dot_product_attention(qs32, ks32, vs32, is_causal=True,
                                           enable_gqa=True)

    def sdpa_bwd32():
        return torch.autograd.grad(o_s32, (qs32, ks32, vs32), goh.float(),
                                   retain_graph=True)

    shape = "(h) 40x4096x128 causal, f32"

    def sdpa_fwd32():
        return F.scaled_dot_product_attention(
            qh32.detach(), kh32.detach(), vh32.detach(), is_causal=True,
            enable_gqa=True)

    check(cuda_fold.fold_form("fold_fwd", torch.float32, p_d, lay_h.bq,
                              lay_h.bk) == "fold_fwd_tf32",
          "(h) float32 forward should take fold_fwd_tf32")
    flops_hf = 4 * cell * p_d * live_h
    attn_row("fold_fwd_tf32_prefill", "fold_fwd_tf32", "carry",
             lambda: cuda_fold.fold(spec_h, ops_h32, lay_h)[0],
             lambda: schedules.fold_carry_plain(ops_h32, spec_h, lay_h),
             nbytes(*ops_h32, *outs_h32), flops_hf, sdpa_fwd32, shape,
             reps=5, tol=FWD_TOL)
    tf32_row = rows[-1]
    tf32_g = graph_ms(lambda: cuda_fold.fold(spec_h, ops_h32, lay_h)[0],
                      calls=5)
    attn_row("fold_fwd_f32_prefill", "fold_fwd", "carry",
             lambda: cuda_fold.fold(spec_h, ops_h32, lay_h,
                                    form="fold_fwd")[0],
             lambda: schedules.fold_carry_plain(ops_h32, spec_h, lay_h),
             nbytes(*ops_h32, *outs_h32), flops_hf, sdpa_fwd32, shape,
             tol=FWD_TOL)
    simt = cuda_fold.fold(spec_h, ops_h32, lay_h, form="fold_fwd")[0]
    _, e_ts = allclose(outs_h32, simt, FWD_TOL)
    del simt
    tf32_again = time_ms(lambda: cuda_fold.fold(spec_h, ops_h32, lay_h)[0],
                         5)
    print(f"  (h) float32 forward in the same run: fold_fwd_tf32 "
          f"{tf32_row['ms']:.3f} / {tf32_again:.3f} ms (graph replay "
          f"{'not measured' if tf32_g is None else f'{tf32_g:.4f} ms'}), "
          f"SIMT fold_fwd {rows[-1]['ms']:.3f} ms, SDPA float32 forward "
          f"{tf32_row['library_ms']:.3f} ms; bounds: 3xTF32 "
          f"{3 * flops_hf / tf32_peak * 1e3:.4f} ms, float32 SIMT "
          f"{flops_hf / f32_peak * 1e3:.4f} ms; max |tf32 - plain| "
          f"{tf32_row['max_abs_err']:.3g}, |SIMT - plain| "
          f"{rows[-1]['max_abs_err']:.3g}, |tf32 - SIMT| {e_ts:.3g} (bar "
          f"(atol, rtol) {FWD_TOL})")
    for kernel, (sp, ly), fl in (("fold_dq", (sq, lq), 6),
                                 ("fold_dkv", (sk, lk), 8)):
        form = kernel + "_tf32"
        check(cuda_fold.fold_form(kernel, torch.float32, p_d, ly.bq, ly.bk)
              == form, f"(h) float32 {kernel} should take {form}")
        outs_k = cuda_fold.fold(sp, ops_bh32, ly)[0]
        flops_h = fl * cell * p_d * live_h
        attn_row(f"{form}_prefill", form, "carry",
                 lambda: cuda_fold.fold(sp, ops_bh32, ly)[0],
                 lambda: schedules.fold_carry_plain(ops_bh32, sp, ly),
                 nbytes(*ops_bh32, *outs_k), flops_h, sdpa_bwd32, shape,
                 reps=5, tol=GRAD_TOL)
        tf32_row = rows[-1]
        tf32_g = graph_ms(lambda: cuda_fold.fold(sp, ops_bh32, ly)[0],
                          calls=5)
        attn_row(f"{kernel}_f32_prefill", kernel, "carry",
                 lambda: cuda_fold.fold(sp, ops_bh32, ly, form=kernel)[0],
                 lambda: schedules.fold_carry_plain(ops_bh32, sp, ly),
                 nbytes(*ops_bh32, *outs_k), flops_h, sdpa_bwd32, shape,
                 tol=GRAD_TOL)
        simt = cuda_fold.fold(sp, ops_bh32, ly, form=kernel)[0]
        _, e_ts = allclose(outs_k, simt, GRAD_TOL)
        del simt, outs_k
        tf32_again = time_ms(lambda: cuda_fold.fold(sp, ops_bh32, ly)[0], 5)
        print(f"  (h) float32 {kernel[5:]} in the same run: {form} "
              f"{tf32_row['ms']:.3f} / {tf32_again:.3f} ms (graph replay "
              f"{'not measured' if tf32_g is None else f'{tf32_g:.4f} ms'}), "
              f"SIMT {kernel} {rows[-1]['ms']:.3f} ms, SDPA float32 backward "
              f"(dq, dk, dv) {tf32_row['library_ms']:.3f} ms; bounds: 3xTF32 "
              f"{3 * flops_h / tf32_peak * 1e3:.4f} ms, float32 SIMT "
              f"{flops_h / f32_peak * 1e3:.4f} ms; max |tf32 - plain| "
              f"{tf32_row['max_abs_err']:.3g}, |SIMT - plain| "
              f"{rows[-1]['max_abs_err']:.3g}, |tf32 - SIMT| {e_ts:.3g} (bar "
              f"(atol, rtol) {GRAD_TOL})")
    del ops_h, ops_h32, outs_h32, ops_bh32, o_s32, qs, ks, vs, o_s
    # (f) global in float32 at its main-path shape: the 3xTF32 forward, dq
    # and dk/dv (d = 256), and beside them, by name, the SIMT kernels they
    # replaced; no library call (softcap)
    ops_f32 = tuple(t.float() for t in flat_f)
    spec_f32, lay_f32 = forward_fold(*shapes_f, return_stats=True, **kw_f)
    live_f = g_hq * lay_f32.active_cells()
    shape = "(f) global 16x8192x256, f32"
    outs_f32, _ = cuda_fold.fold(spec_f32, ops_f32, lay_f32)
    check(cuda_fold.fold_form("fold_fwd", torch.float32, g_d, lay_f32.bq,
                              lay_f32.bk) == "fold_fwd_tf32",
          "(f) float32 forward (d = 256) should take fold_fwd_tf32")
    flops_ff = 4 * cell * g_d * live_f
    attn_row("fold_fwd_tf32_training", "fold_fwd_tf32", "carry",
             lambda: cuda_fold.fold(spec_f32, ops_f32, lay_f32)[0],
             lambda: schedules.fold_carry_plain(ops_f32, spec_f32, lay_f32),
             nbytes(*ops_f32, *outs_f32), flops_ff, None, shape, tol=FWD_TOL)
    tf32_row = rows[-1]
    attn_row("fold_fwd_f32_training", "fold_fwd", "carry",
             lambda: cuda_fold.fold(spec_f32, ops_f32, lay_f32,
                                    form="fold_fwd")[0],
             lambda: schedules.fold_carry_plain(ops_f32, spec_f32, lay_f32),
             nbytes(*ops_f32, *outs_f32), flops_ff, None, shape, reps=2,
             tol=FWD_TOL)
    print(f"  (f) float32 forward in the same run: fold_fwd_tf32 "
          f"{tf32_row['ms']:.3f} ms, SIMT fold_fwd {rows[-1]['ms']:.3f} ms; "
          f"bounds: 3xTF32 {3 * flops_ff / tf32_peak * 1e3:.4f} ms, float32 "
          f"SIMT {flops_ff / f32_peak * 1e3:.4f} ms; max |tf32 - plain| "
          f"{tf32_row['max_abs_err']:.3g}, |SIMT - plain| "
          f"{rows[-1]['max_abs_err']:.3g}")
    ops_bf32 = bwd_operands(*ops_f32, *outs_f32)
    for kernel, (sp, ly), fl in zip(("fold_dq", "fold_dkv"), backward_folds(
            *shapes_f, **kw_f), (6, 8)):
        form = kernel + "_tf32"
        check(cuda_fold.fold_form(kernel, torch.float32, g_d, ly.bq, ly.bk)
              == form, f"(f) float32 {kernel} (d = 256) should take {form}")
        outs_k = cuda_fold.fold(sp, ops_bf32, ly)[0]
        flops_f = fl * cell * g_d * live_f
        attn_row(f"{form}_training", form, "carry",
                 lambda: cuda_fold.fold(sp, ops_bf32, ly)[0],
                 lambda: schedules.fold_carry_plain(ops_bf32, sp, ly),
                 nbytes(*ops_bf32, *outs_k), flops_f, None, shape,
                 tol=GRAD_TOL)
        tf32_row = rows[-1]
        attn_row(f"{kernel}_f32_training", kernel, "carry",
                 lambda: cuda_fold.fold(sp, ops_bf32, ly, form=kernel)[0],
                 lambda: schedules.fold_carry_plain(ops_bf32, sp, ly),
                 nbytes(*ops_bf32, *outs_k), flops_f, None, shape, reps=2,
                 tol=GRAD_TOL)
        del outs_k
        print(f"  (f) float32 {kernel[5:]} in the same run: {form} "
              f"{tf32_row['ms']:.3f} ms, SIMT {kernel} {rows[-1]['ms']:.3f} "
              f"ms; bounds: 3xTF32 {3 * flops_f / tf32_peak * 1e3:.4f} ms, "
              f"float32 SIMT {flops_f / f32_peak * 1e3:.4f} ms; max |tf32 - "
              f"plain| {tf32_row['max_abs_err']:.3g}, |SIMT - plain| "
              f"{rows[-1]['max_abs_err']:.3g}")
    del ops_f32, outs_f32, ops_bf32

    # -- 8. zamba2-7b serves two requests (cell (i)) -----------------------
    torch.cuda.empty_cache()
    from repro_torch.serve import decode as serving
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.kernels import scan_engine

    zcfg = configs.get_config("zamba2-7b")
    z_periods = zcfg.num_layers // len(zcfg.layer_pattern)
    n_mamba = z_periods * zcfg.layer_pattern.count("mamba")
    n_shared = z_periods * zcfg.layer_pattern.count("shared_attn")
    check((zcfg.num_layers, zcfg.d_model, zcfg.num_heads, zcfg.head_dim,
           zcfg.dtype, n_mamba, n_shared) == (81, 3584, 32, 112, "bfloat16",
                                              54, 27),
          f"zamba2-7b's config is not the full model: {zcfg}")
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    zgen = torch.Generator(device=dev)
    zgen.manual_seed(args.seed)
    t0 = time.perf_counter()
    with torch.no_grad():
        model = lm.init_lm(zcfg, generator=zgen, device=dev)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"(i) zamba2-7b on {card}: {n_params} parameters "
          f"(ModelConfig.param_count {zcfg.param_count()}, which counts no "
          f"norm weight), {w_bytes / 2**30:.2f} GiB of weights (bf16 and "
          f"float32), random init from --seed in {init_s:.1f} s, peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
          " GiB")
    lens = torch.tensor(SERVE_PROMPTS, device=dev)
    prompts = [torch.randint(0, zcfg.vocab_size, (n,), device=dev,
                             generator=zgen) for n in SERVE_PROMPTS]
    # the routes the prefill will take at each prompt's shape
    attn_sched = [fa_ops.resolved_attention_schedule(
        (1, zcfg.num_heads, n, zcfg.head_dim), n, cores=sms)
        for n in SERVE_PROMPTS]
    fold_kernel = cuda_fold.fold_form("fold_fwd", torch.bfloat16,
                                      zcfg.head_dim, 128, 128)
    ssd_width = zcfg.ssm_heads * zcfg.ssm_head_dim * zcfg.ssm_state
    ssd_sched = [ssm_ops.resolved_schedule(
        (1, -(-n // zcfg.ssm_chunk), ssd_width), cores=sms)
        for n in SERVE_PROMPTS]
    print(f"(i) routes: attention {attn_sched} -> {fold_kernel} (bf16 at "
          f"head dim {zcfg.head_dim}, run at D "
          f"{cuda_fold.tc_dim(zcfg.head_dim)}, the columns past "
          f"{zcfg.head_dim} read as zeros), SSD carry over {ssd_width} "
          f"channels {ssd_sched}")
    check(attn_sched == ["carry"] * 2 and ssd_sched == ["carry"] * 2,
          f"(i) prefill routes {attn_sched} / {ssd_sched}, want carry")
    check(fold_kernel == "fold_fwd_tc",
          f"(i) the bf16 forward at d {zcfg.head_dim} takes {fold_kernel}")

    # the main path: each request prefilled alone (each one's first
    # shared-attention fold and Mamba2 carry captured as the engine gets
    # them: operands, spec, layout; the in-tile network of every carry
    # noted), with the launches of each prefill counted
    captured, carry_nets = {}, []
    real_scan = scan_engine.scan

    def engine_spy(operands, spec, layout, **kw):
        key = "fold" if spec.attn is not None else spec.name
        captured.setdefault((key, len(pre)), (operands, spec, layout))
        if spec.name == "affine":
            carry_nets.append((len(pre), layout.bt, cuda.tile_network(
                AFFINE, layout, "carry")))
        return real_scan(operands, spec, layout, **kw)

    scan_key = cuda.kernel_name("affine", "carry")
    pre, pre_launches = [], []
    scan_engine.scan = engine_spy
    try:
        for p in prompts:
            cuda.reset_launches()
            cuda_fold.reset_launches()
            with torch.no_grad():
                pre.append(wall_ms(lambda: lm.prefill(
                    model, p[None], zcfg, SERVE_MAX_LEN, attn_impl="flash")))
            sync()
            pre_launches.append((
                {k: v for k, v in cuda_fold.LAUNCHES.items() if v},
                {k: v for k, v in cuda.LAUNCHES.items() if v}))
    finally:
        scan_engine.scan = real_scan
    for n, (folds, scans) in zip(SERVE_PROMPTS, pre_launches):
        print(f"(i) prefill {n}: fold launches {folds}, scan launches "
              f"{scans}")
        check(folds == {fold_kernel: n_shared},
              f"(i) prefill {n}: fold launches {folds}, want {n_shared} of "
              f"{fold_kernel}")
        check(scans == {scan_key: n_mamba},
              f"(i) prefill {n}: scan launches {scans}, want {n_mamba} of "
              f"{scan_key}")
    serve_launches = {fold_kernel: 2 * n_shared, scan_key: 2 * n_mamba}
    peak_pre = torch.cuda.max_memory_allocated(dev)
    # the carry's network by prefill: tiles of 32 chunks (4096 tokens)
    # and of 24 (2500 tokens: 20 chunks, rounded to 8 by ssm_scan) take
    # the register carry, a thread a channel; no shared carry is left
    by_net = {}
    for i, bt, net in carry_nets:
        by_net[i, bt, net] = by_net.get((i, bt, net), 0) + 1
    print(f"(i) SSD carries by (prefill, tile, network): {by_net}")
    check(by_net == {(0, 32, "register"): n_mamba,
                     (1, 24, "register"): n_mamba},
          f"(i) carries by (prefill, tile, network) {by_net}")
    carry_launches = {"affine_carry_zamba2_prefill": n_mamba,
                      "affine_carry_zamba2_prefill2500": n_mamba}

    # the captured kernel calls against their plain versions
    ops_z, spec_z, lay_z = captured["fold", 0]
    check(cuda_fold.fold_form("fold_fwd", ops_z[0].dtype, lay_z.d, lay_z.bq,
                              lay_z.bk) == fold_kernel,
          "(i) the captured attention fold takes another kernel")
    out_z = cuda_fold.fold(spec_z, ops_z, lay_z)[0]
    flops_z = 4 * lay_z.bq * lay_z.bk * lay_z.d * lay_z.bh * \
        lay_z.active_cells()
    shape_z = f"(i) {lay_z.bh}x{lay_z.tq}x{lay_z.d} bf16"
    at = spec_z.attn
    qs, ks, vs = (t[None] for t in ops_z)   # kv heads == heads here
    check(lay_z.group == 1, "(i) zamba2's attention has no kv groups")
    sdpa_z = (lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=at.causal, scale=at.scale))
    attn_row("fold_fwd_zamba2_prefill", fold_kernel, "carry",
             lambda: cuda_fold.fold(spec_z, ops_z, lay_z)[0],
             lambda: schedules.fold_carry_plain(ops_z, spec_z, lay_z),
             nbytes(*ops_z, *out_z), flops_z, sdpa_z, shape_z, reps=5,
             launches=serve_launches[fold_kernel])
    tc_row = rows[-1]
    # the SIMT forward it replaced, by name at the same shape (0 launches
    # on the main path), then the tensor-core form again: in turns
    attn_row("fold_fwd_simt_zamba2_prefill", "fold_fwd", "carry",
             lambda: cuda_fold.fold(spec_z, ops_z, lay_z,
                                    form="fold_fwd")[0],
             lambda: schedules.fold_carry_plain(ops_z, spec_z, lay_z),
             nbytes(*ops_z, *out_z), flops_z, sdpa_z, shape_z, launches=0)
    tc_again = time_ms(lambda: cuda_fold.fold(spec_z, ops_z, lay_z)[0], 5)
    print(f"  (i) bf16 forward at d {lay_z.d} in the same run: {fold_kernel} "
          f"{tc_row['ms']:.3f} / {tc_again:.3f} ms, SIMT fold_fwd "
          f"{rows[-1]['ms']:.3f} ms, SDPA {tc_row['library_ms']:.3f} ms; "
          f"bound {tc_row['bound_ms']:.4f} ms; max |tc - plain| "
          f"{tc_row['max_abs_err']:.3g}, |SIMT - plain| "
          f"{rows[-1]['max_abs_err']:.3g}")
    del out_z, qs, ks, vs
    for i, rname in enumerate(carry_launches):
        ops_c, _, lay_c = captured["affine", i]
        net_c = cuda.tile_network(AFFINE, lay_c, "carry")
        print(f"(i) prefill {SERVE_PROMPTS[i]}: the SSD carry's tiles of "
              f"{lay_c.bt} chunks take the {net_c} network (" +
              ("carry_chan_reg_kernel" if net_c == "register"
               else "carry_kernel") + ")")
        n_z = ops_c[0].numel()
        shape_c = f"{tuple(ops_c[0].shape)} bt {lay_c.bt}"
        kernel_row(rname, lambda: cuda.carry(AFFINE, ops_c, lay_c)[0],
                   lambda: schedules.carry_plain(ops_c, AFFINE, lay_c),
                   12 * n_z, 3 * n_z, 5, None, shape_c, carry_launches,
                   base="carry")
        if net_c == "register":   # the shared carry_kernel it replaced
            beside_shared(f"(i) {rname}",
                          lambda net: cuda.carry(AFFINE, ops_c, lay_c,
                                                 network=net)[0], shape_c)
    del captured, ops_z, ops_c

    # every fold and carry call of each prefill held against its plain
    # version on the operands the engine gets, as the rows above hold the
    # first ones: a faulty call in one layer of 81 moves the last logits
    # by little more than bf16's noise (PERF.md §4), so the whole
    # prefill's L2 below cannot stand for these checks (their launches
    # are not the main path's)
    def engine_check(operands, spec, layout, **kw):
        out = real_scan(operands, spec, layout, **kw)
        if spec.attn is not None:
            ok, err = allclose(out, schedules.fold_carry_plain(
                operands, spec, layout), BF16_TOL)
            checked.append(("fold", err))
            check(ok, f"(i) fold call {len(checked)}: kernel vs plain {err}")
        elif spec.name == "affine":
            plain = schedules.carry_plain(operands, AFFINE, layout)
            checked.append(("affine", 0.0))
            check(all_same_bits(out, plain),
                  f"(i) carry call {len(checked)}: kernel != plain bitwise")
        return out

    scan_engine.scan = engine_check
    try:
        for n, p in zip(SERVE_PROMPTS, prompts):
            checked = []
            with torch.no_grad():
                lm.prefill(model, p[None], zcfg, SERVE_MAX_LEN,
                           attn_impl="flash")
            kinds = [k for k, _ in checked]
            check((kinds.count("fold"), kinds.count("affine")) ==
                  (n_shared, n_mamba), f"(i) prefill {n}: checked {kinds}")
            print(f"(i) prefill {n}: all {n_shared} fold calls within "
                  f"{BF16_TOL} of their plain versions (max |diff| "
                  f"{max(e for k, e in checked if k == 'fold'):.3g}), all "
                  f"{n_mamba} carry calls bitwise equal to theirs")
    finally:
        scan_engine.scan = real_scan
    del checked

    # the whole prefill again on the plain routes (dense attention, the
    # chunked SSD): the relative L2 error of the last position's logits
    plain_ms, l2 = [], []
    for p, (lg, _) in zip(prompts, (r for r, _ in pre)):
        with torch.no_grad():
            (lp, _), ms = wall_ms(lambda: lm.prefill(
                model, p[None], zcfg, SERVE_MAX_LEN, ssm_impl="chunked"))
        plain_ms.append(ms)
        l2.append(((lg - lp).norm() / lp.norm()).item())
        del lp
    torch.cuda.empty_cache()
    print(f"(i) prefill logits, kernel routes vs plain routes: relative L2 "
          f"{', '.join(f'{e:.4g}' for e in l2)} (bound {SERVE_L2_BOUND}); "
          f"plain prefill {', '.join(f'{t:.0f}' for t in plain_ms)} ms")
    check(all(e <= SERVE_L2_BOUND for e in l2),
          f"(i) prefill logits: relative L2 {l2} past {SERVE_L2_BOUND}")

    # prefill times: the main path's call and two more of each request
    pre_ms = []
    for p, (_, ms0) in zip(prompts, pre):
        more = []
        for _ in range(2):
            with torch.no_grad():
                _, ms = wall_ms(lambda: lm.prefill(
                    model, p[None], zcfg, SERVE_MAX_LEN, attn_impl="flash"))
            more.append(ms)
        pre_ms.append(statistics.median([ms0] + more))

    # 16 greedy steps of both requests together, per-row lengths: (a)
    # through the rows' caches side by side, (b) through page pools
    caches = [c for (_, c), _ in pre]
    first = torch.cat([lg.argmax(-1) for (lg, _), _ in pre])

    def timed(step_ms):
        def run(fn):
            out, ms = wall_ms(fn)
            step_ms.append(ms)
            return out
        return run

    ms_a, ms_b = [], []
    cuda.reset_launches()
    with torch.no_grad():
        contig = serving.contiguous_cache(caches)
        tok_a, lg_a = serving.greedy_decode(model, zcfg, contig, lens, first,
                                            SERVE_STEPS, run=timed(ms_a))
        del contig
        paged, alloc, table = serving.paged_cache(
            zcfg, caches, lens, SERVE_MAX_LEN, SERVE_PAGE, SERVE_STEPS)
        alloc_launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        tok_b, lg_b = serving.greedy_decode(model, zcfg, paged, lens, first,
                                            SERVE_STEPS, run=timed(ms_b))
    print(f"(i) paged install: {alloc.in_use} pages of {SERVE_PAGE} "
          f"tokens for lengths {SERVE_PROMPTS} + {SERVE_STEPS} steps "
          f"(table {table.table.shape}), the allocator's scans on "
          f"{alloc.device}: launches {alloc_launches}")
    check(torch.equal(tok_a, tok_b) and same_bits(lg_a, lg_b),
          "(i) paged decode != contiguous decode bitwise")
    check(bool(torch.isfinite(lg_a).all()) and lg_a.shape == (
        SERVE_STEPS, 2, zcfg.vocab_size), "(i) decode logits")
    print(f"(i) decode: {SERVE_STEPS} greedy steps of 2 requests, tokens "
          f"and logits bitwise equal through the contiguous cache and the "
          f"pages; tokens {tok_a.tolist()}")

    # one profiler window per stage: device busy and the top kernels
    def stage_profile(label, fn, cell="(i)"):
        """{kernel: device ms} of one call of ``fn`` under torch.profiler
        (CPU and CUDA activities)."""
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        names = {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            names[ev.key] = names.get(ev.key, 0.0) + us / 1e3
        top = sorted(names.items(), key=lambda kv: -kv[1])[:5]
        print(f"{cell} profile {label}: device busy {sum(names.values()):.3f} "
              "ms; top: " + ", ".join(f"{n[:48]} {t:.3f} ms" for n, t in top))
        return names

    with torch.no_grad():
        prof_pre = stage_profile("prefill 4096", lambda: lm.prefill(
            model, prompts[0][None], zcfg, SERVE_MAX_LEN, attn_impl="flash"))
        step_in = (first[:, None], serving.contiguous_cache(caches), lens)
        stage_profile("decode step (contiguous)", lambda: lm.decode_step(
            model, step_in[0], step_in[1], step_in[2], zcfg))
        stage_profile("decode step (paged)", lambda: lm.decode_step(
            model, step_in[0], paged, step_in[2], zcfg))
    fold_ms = sum(t for n, t in prof_pre.items() if "fold_fwd" in n)
    check(fold_ms > 0, "(i) the prefill profile names no fold kernel with "
          "device time")
    carry_ms = sum(t for n, t in prof_pre.items()
                   if "carry_chan_reg_kernel" in n)
    check(any("fold_fwd_tc_kernel" in n for n in prof_pre) and carry_ms > 0
          and not any("carry_kernel<" in n or "fold_fwd_kernel" in n
                      for n in prof_pre),
          "(i) the 4096-token prefill profile should name fold_fwd_tc_kernel "
          "and carry_chan_reg_kernel and neither first form: "
          f"{sorted(n for n in prof_pre if 'fold' in n or 'carry' in n)}")
    print(f"(i) prefill 4096 profile: fold_fwd_tc_kernel {fold_ms:.3f} ms, "
          f"carry_chan_reg_kernel {carry_ms:.3f} ms")
    step_a, step_b = statistics.median(ms_a), statistics.median(ms_b)
    print(f"(i) zamba2-7b serve on {card}: prefill "
          + ", ".join(f"{n} tokens {t:.1f} ms" for n, t in
                      zip(SERVE_PROMPTS, pre_ms))
          + f" (host clock, median of 3); decode step {step_a:.2f} ms "
          f"contiguous, {step_b:.2f} ms paged (median of {SERVE_STEPS}), "
          f"{2e3 / step_a:.1f} / {2e3 / step_b:.1f} tokens/s; fold kernels "
          f"in the prefill profile {fold_ms:.3f} ms; peak device memory "
          f"{peak_pre / 2**30:.2f} GiB (prefill), "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (all)")
    del model, pre, caches, paged, step_in, lg_a, lg_b
    torch.cuda.empty_cache()

    # -- 9. zamba2-7b trains (cell (j)) ------------------------------------
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.models import convert
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_step
    from repro_torch.train import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    jcfg = dataclasses.replace(zcfg, num_layers=TRAIN_LAYERS)
    j_periods = jcfg.num_layers // len(jcfg.layer_pattern)
    j_width = jcfg.ssm_heads * jcfg.ssm_head_dim * jcfg.ssm_state
    check((jcfg.d_model, jcfg.num_heads, jcfg.head_dim, jcfg.d_ff, j_width,
           jcfg.vocab_size, jcfg.dtype, j_periods) == (
               3584, 32, 112, 14336, 458752, 32000, "bfloat16", 2),
          f"(j) zamba2-7b's training config is not at full width: {jcfg}")
    full_n = sum(p.numel() for p in lm.LM(zcfg, device="meta").parameters())
    j_n = sum(p.numel() for p in lm.LM(jcfg, device="meta").parameters())
    print(f"(j) zamba2-7b training on {card}: full width, depth cut from "
          f"{zcfg.num_layers} to {jcfg.num_layers} layers ({j_periods} "
          f"periods of {jcfg.layer_pattern}): {j_n} parameters; all "
          f"{zcfg.num_layers} layers hold {full_n} parameters, x 16 bytes "
          f"(bf16 weight and gradient, float32 master, mu and nu) = "
          f"{full_n * 16 / 1e9:.0f} GB, past one card's 80 GB")
    torch.cuda.empty_cache()
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    jgen = torch.Generator(device=dev)
    jgen.manual_seed(args.seed)
    params = train_step.init_params(jcfg, generator=jgen, device=dev)
    opt = adamw.adamw_init(params)
    check(sum(t.numel() for t in adamw.tree_leaves(params)) == j_n,
          "(j) the train step's tree holds another parameter count")
    ds = SyntheticDataset(DataConfig(
        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        vocab_size=jcfg.vocab_size, seed=args.seed), device=dev)
    tcfg_j = train_step.TrainStepConfig(
        attn_impl="flash", ssm_impl="kernel", remat=True,
        microbatches=TRAIN_MICRO, warmup_steps=1, total_steps=TRAIN_STEPS)
    fn_j = train_step.make_train_step(jcfg, tcfg_j)
    # the routes at the microbatch's shape
    micro = TRAIN_BATCH // TRAIN_MICRO
    j_attn = fa_ops.resolved_attention_schedule(
        (micro, jcfg.num_heads, TRAIN_SEQ, jcfg.head_dim), TRAIN_SEQ,
        cores=sms)
    j_chunks = TRAIN_SEQ // jcfg.ssm_chunk
    j_ssd = ssm_ops.resolved_schedule((micro, j_chunks, j_width), cores=sms)
    j_forms = {k: cuda_fold.fold_form(k, torch.bfloat16, jcfg.head_dim,
                                      128, 128)
               for k in ("fold_fwd", "fold_dq", "fold_dkv")}
    print(f"(j) routes at ({micro}, {TRAIN_SEQ}): attention {j_attn} -> "
          f"{j_forms}, SSD carry over {j_width} channels {j_ssd} (tiles "
          f"of {j_chunks} chunks)")
    check(j_attn == "carry" and j_ssd == "carry"
          and j_forms == {"fold_fwd": "fold_fwd_tc", "fold_dq": "fold_dq_tc",
                          "fold_dkv": "fold_dkv_tc"},
          f"(j) routes {j_attn} / {j_ssd} / {j_forms}")
    # a step's launches: per microbatch and period the shared block's
    # forward fold twice (remat recomputes it), dq and dk/dv once, each
    # Mamba2 layer's carry three times (forward, recomputation, backward)
    calls = TRAIN_MICRO * j_periods
    j_mamba = calls * jcfg.layer_pattern.count("mamba")
    want_folds = {"fold_fwd_tc": 2 * calls, "fold_dq_tc": calls,
                  "fold_dkv_tc": calls}
    want_scans = {scan_key: 3 * j_mamba}

    def batch_loss(tree, batch):
        """Batch's loss under ``tree`` (no gradient), through an LM whose
        parameters are views of the tree's leaves."""
        skel = lm.LM(jcfg, device="meta")
        skel.load_state_dict(convert.flat_params(tree), assign=True)
        with torch.no_grad():
            return lm.lm_loss(skel, batch, jcfg, attn_impl="flash",
                              ssm_impl="kernel")[0].item()

    batch0 = ds.batch_at(0)
    loss_before = batch_loss(params, batch0)

    # the main path: four steps, each one's launches counted; the engine's
    # first fold forward, dq and dk/dv and first carry of each direction
    # captured as it gets them (the direction by the SSM scan's backward),
    # the network of every carry noted
    captured, j_nets, in_bwd = {}, {}, [0]
    real_ssm_bwd = ssm_ops._SSMScan.backward

    def ssm_bwd(ctx, g):
        in_bwd[0] += 1
        try:
            return real_ssm_bwd(ctx, g)
        finally:
            in_bwd[0] -= 1

    def train_spy(operands, spec, layout, **kw):
        role = spec.name
        if spec.name == "affine":
            role = "affine_bwd" if in_bwd[0] else "affine_fwd"
            net = (role, layout.bt, cuda.tile_network(AFFINE, layout,
                                                      "carry"))
            j_nets[net] = j_nets.get(net, 0) + 1
        captured.setdefault(role, (operands, spec, layout))
        return real_scan(operands, spec, layout, **kw)

    params0, losses, step_ms, step_launches = params, [], [], []
    scan_engine.scan = train_spy
    ssm_ops._SSMScan.backward = staticmethod(ssm_bwd)
    try:
        for i in range(TRAIN_STEPS):
            batch = ds.batch_at(i)
            cuda.reset_launches()
            cuda_fold.reset_launches()
            (params, opt, metrics), ms = wall_ms(
                lambda: fn_j(params, opt, batch, torch.tensor(i)))
            step_launches.append((
                {k: v for k, v in cuda_fold.LAUNCHES.items() if v},
                {k: v for k, v in cuda.LAUNCHES.items() if v}))
            losses.append(metrics["loss"].item())
            step_ms.append(ms)
            print(f"(j) step {i}: loss {losses[-1]:.5f}, grad norm "
                  f"{metrics['grad_norm'].item():.4g}, lr "
                  f"{metrics['lr'].item():.3g}, {ms:.0f} ms; launches "
                  f"{step_launches[-1]}")
    finally:
        scan_engine.scan = real_scan
        ssm_ops._SSMScan.backward = staticmethod(real_ssm_bwd)
    peak_train = torch.cuda.max_memory_allocated(dev)
    del metrics
    for i, (folds, scans) in enumerate(step_launches):
        check(folds == want_folds and scans == want_scans,
              f"(j) step {i}: launches {folds} / {scans}, want {want_folds}"
              f" / {want_scans}")
    print(f"(j) carries by (direction, tile, network) over the "
          f"{TRAIN_STEPS} steps: {j_nets}")
    check(j_nets == {("affine_fwd", j_chunks, "register"):
                     2 * j_mamba * TRAIN_STEPS,
                     ("affine_bwd", j_chunks, "register"):
                     j_mamba * TRAIN_STEPS},
          f"(j) carries by (direction, tile, network) {j_nets}")
    check(all(math.isfinite(x) for x in losses), f"(j) losses {losses}")
    train_launches = {k: v * TRAIN_STEPS for k, v in want_folds.items()}

    # training works: batch 0's loss fell, and every parameter with a
    # gradient (mu != 0) or a decay (a leaf of 2 dimensions or more,
    # nonzero) moved: its float32 master left the initial weights (the
    # elements that came back to their initial bits, where the updates of
    # a noisy gradient cancelled, are counted)
    loss_after = batch_loss(params, batch0)
    print(f"(j) batch 0's loss: {loss_before:.5f} before the steps, "
          f"{loss_after:.5f} after")
    check(loss_after < loss_before, f"(j) batch 0's loss {loss_before} -> "
          f"{loss_after} did not fall")
    unmoved, n_need, back = [], 0, 0
    for i, (w0, w, mu) in enumerate(zip(adamw.tree_leaves(params0),
                                        adamw.tree_leaves(opt.master),
                                        adamw.tree_leaves(opt.mu))):
        need = mu != 0
        if w0.dim() >= 2:
            need |= w0 != 0
        if bool(need.any()):
            n_need += 1
            same = need & (w == w0.float())
            back += int(same.sum())
            if bool(same.all()):
                unmoved.append(i)
    print(f"(j) {n_need - len(unmoved)} of {n_need} parameters with a "
          f"gradient or a decay moved ({back} of their elements are back "
          f"at their initial bits)")
    check(not unmoved, f"(j) parameters {unmoved} did not move")

    # step 0 again on both routes (the plain: blockwise attention, the
    # chunked SSD, the reference's training defaults): loss and gradients
    module_j = train_step._LossAndGrad(jcfg, lm.lm_loss)
    cuda.reset_launches()
    cuda_fold.reset_launches()
    l_k, _, g_k = train_step._accumulate_grads(module_j, params0, batch0,
                                               tcfg_j)
    l_p, _, g_p = train_step._accumulate_grads(
        module_j, params0, batch0, dataclasses.replace(
            tcfg_j, attn_impl=None, ssm_impl="chunked"))
    sync()
    num = sum(((a - b).double() ** 2).sum() for a, b in zip(
        adamw.tree_leaves(g_k), adamw.tree_leaves(g_p)))
    den = sum((b.double() ** 2).sum() for b in adamw.tree_leaves(g_p))
    g_l2 = (num / den).sqrt().item()
    l_rel = abs(l_k.item() - l_p.item()) / abs(l_p.item())
    print(f"(j) step 0, kernel routes vs plain routes (blockwise "
          f"attention, chunked SSD): loss {l_k.item():.6f} / "
          f"{l_p.item():.6f} (relative {l_rel:.3g}, bound "
          f"{TRAIN_LOSS_BOUND}), gradients' relative L2 {g_l2:.4g} (bound "
          f"{TRAIN_L2_BOUND}); the kernel route's loss again "
          f"{'==' if l_k.item() == losses[0] else '!='} step 0's")
    check(l_rel <= TRAIN_LOSS_BOUND and g_l2 <= TRAIN_L2_BOUND,
          f"(j) kernel vs plain routes: loss {l_rel}, gradients {g_l2}")
    del g_k, g_p, module_j, params0

    # one more step in a profiler window: device busy and the top kernels
    batch = ds.batch_at(TRAIN_STEPS)
    prof_j = stage_profile("train step", lambda: fn_j(
        params, opt, batch, torch.tensor(TRAIN_STEPS)), cell="(j)")
    busy_j = sum(prof_j.values())
    check(any("fold_dq_tc_kernel" in n for n in prof_j)
          and any("fold_dkv_tc_kernel" in n for n in prof_j)
          and not any("fold_dq_kernel" in n or "fold_dkv_kernel" in n
                      for n in prof_j),
          "(j) the train step's profile should name fold_dq_tc_kernel and "
          "fold_dkv_tc_kernel and neither SIMT backward kernel: "
          f"{sorted(n for n in prof_j if 'fold' in n)}")
    del params, opt, batch, batch0
    torch.cuda.empty_cache()

    # the captured kernel calls against their plain versions, and their
    # rows: the forward fold beside SDPA's forward, dq and dk/dv beside
    # SDPA's backward (dq, dk, dv) at the same shape, bf16, causal, and
    # beside the SIMT forms they replaced, by name (0 launches)
    ops_f, spec_f, lay_f = captured["softmax_pair"]
    at = spec_f.attn
    check(lay_f.group == 1, "(j) zamba2's attention has no kv groups")
    live_j = lay_f.bh * lay_f.active_cells()
    cell_j = lay_f.bq * lay_f.bk
    shape_j = f"(j) {lay_f.bh}x{lay_f.tq}x{lay_f.d} bf16 causal"
    qs, ks, vs = (t[None].detach().requires_grad_(True)
                  for t in ops_f[:3])
    o_s = F.scaled_dot_product_attention(qs, ks, vs, is_causal=at.causal,
                                         scale=at.scale)
    out_f = cuda_fold.fold(spec_f, ops_f, lay_f)[0]
    attn_row("fold_fwd_tc_zamba2_train", "fold_fwd_tc", "carry",
             lambda: cuda_fold.fold(spec_f, ops_f, lay_f)[0],
             lambda: schedules.fold_carry_plain(ops_f, spec_f, lay_f),
             nbytes(*ops_f, *out_f), 4 * cell_j * lay_f.d * live_j,
             lambda: F.scaled_dot_product_attention(
                 qs.detach(), ks.detach(), vs.detach(), is_causal=at.causal,
                 scale=at.scale), shape_j, reps=5,
             launches=train_launches["fold_fwd_tc"])
    del out_f
    bwd_ms = {}
    for kernel, fl in (("fold_dq", 6), ("fold_dkv", 8)):
        ops_b, spec_b, lay_b = captured["softmax_bwd_" + kernel[5:]]
        form = kernel + "_tc"
        check(cuda_fold.fold_form(kernel, ops_b[0].dtype, lay_b.d, lay_b.bq,
                                  lay_b.bk) == form,
              f"(j) the captured {kernel} takes another form")
        do_s = ops_b[3][None]
        # dq, dk and dv are linear in (dO, delta). The captured cotangent
        # gives gradients of about 1e-6, below BF16_TOL's atol; dO and
        # delta scaled by a power of two that brings dO to unit RMS give
        # the captured call's outputs times that power, bit for bit, at
        # values the bar tells apart. Each output is also held within
        # 2^-6 of its max |plain| (one bf16 ulp is 2^-7 of it).
        rms = ops_b[3].float().pow(2).mean().sqrt().item()
        check(rms > 0, f"(j) the captured {kernel}'s dO is zero")
        unit = 2.0 ** -round(math.log2(rms))
        ops_b = ops_b[:3] + (ops_b[3] * unit,) + ops_b[4:6] + (
            ops_b[6] * unit,)
        out_b = cuda_fold.fold(spec_b, ops_b, lay_b)[0]
        for f_, launches in ((form, train_launches[form]), (kernel, 0)):
            attn_row(f"{f_}_zamba2_train", f_, "carry",
                     lambda: cuda_fold.fold(spec_b, ops_b, lay_b,
                                            form=f_)[0],
                     lambda: schedules.fold_carry_plain(ops_b, spec_b,
                                                        lay_b),
                     nbytes(*ops_b, *out_b), fl * cell_j * lay_b.d * live_j,
                     lambda: torch.autograd.grad(o_s, (qs, ks, vs), do_s,
                                                 retain_graph=True),
                     shape_j, launches=launches, rel=2 ** -6)
            bwd_ms[f_] = rows[-1]
        del out_b, ops_b
    del o_s, qs, ks, vs, ops_f
    carry_rows = {}
    for role, rname in (("affine_fwd", "affine_carry_zamba2_train"),
                        ("affine_bwd", "affine_carry_zamba2_train_bwd")):
        ops_c, _, lay_c = captured[role]
        n_c = ops_c[0].numel()
        kernel_row(rname, lambda: cuda.carry(AFFINE, ops_c, lay_c)[0],
                   lambda: schedules.carry_plain(ops_c, AFFINE, lay_c),
                   nbytes(*ops_c) + n_c * ops_c[1].element_size(), 3 * n_c,
                   5, None, f"{tuple(ops_c[0].shape)} bt {lay_c.bt}",
                   {rname: j_nets[role, j_chunks, "register"]},
                   graph=True, base="carry")
        carry_rows[role] = rows[-1]
        del ops_c
    del captured
    torch.cuda.empty_cache()

    # the Trainer on zamba2-7b's SMOKE config: 8 steps with checkpoints
    # every 4, then a restart from step 4 to step 8, bitwise (attention
    # under carry, as at (j): these few rows alone would take split-KV)
    scfg = configs.get_smoke_config("zamba2-7b")
    fn_s = train_step.make_train_step(scfg, dataclasses.replace(
        tcfg_j, attn_schedule="carry", total_steps=8))
    ds_s = SyntheticDataset(DataConfig(
        seq_len=256, global_batch=2, vocab_size=scfg.vocab_size,
        seed=args.seed), device=dev)

    def smoke_state():
        sgen = torch.Generator(device=dev)
        sgen.manual_seed(args.seed)
        p = train_step.init_params(scfg, generator=sgen, device=dev)
        return p, adamw.adamw_init(p)

    with tempfile.TemporaryDirectory() as ckdir:
        run_a = Trainer(fn_s, ds_s, TrainerConfig(
            total_steps=8, checkpoint_every=4, log_every=100,
            checkpoint_dir=os.path.join(ckdir, "a")))
        p_a, o_a = run_a.run(*smoke_state())
        like_p, like_o = smoke_state()
        bundle = restore_checkpoint(os.path.join(ckdir, "a"), 4,
                                    {"params": like_p, "opt": like_o})
        run_b = Trainer(fn_s, ds_s, TrainerConfig(
            total_steps=8, checkpoint_every=100, log_every=100,
            checkpoint_dir=os.path.join(ckdir, "b")))
        p_b, o_b = run_b.run(bundle["params"], bundle["opt"], start_step=4)
        start, p_r, _ = run_a.maybe_restore(like_p, like_o)
    differ = [i for i, (a, b) in enumerate(zip(
        adamw.tree_leaves({"p": p_a, **o_a._asdict()}),
        adamw.tree_leaves({"p": p_b, **o_b._asdict()})))
        if not same_bits(a, b)]
    print(f"(j) SMOKE Trainer: losses "
          f"{[round(h['loss'], 5) for h in run_a.history]}; restarted "
          f"from step 4: steps {[h['step'] for h in run_b.history]}, "
          f"{len(differ)} leaves of parameters and state differ from the "
          f"uninterrupted run's bits; the latest commit is step {start}")
    check(not differ and start == 8 and all_same_bits(
        adamw.tree_leaves(p_r), adamw.tree_leaves(p_a)),
          f"(j) restart from step 4: leaves {differ} differ")
    check([h["step"] for h in run_b.history] == [4, 5, 6, 7],
          f"(j) the restarted run's steps {run_b.history}")
    del p_a, o_a, p_b, o_b, p_r, like_p, like_o, bundle

    step_j = statistics.median(step_ms[1:])
    dq_row, dkv_row = bwd_ms["fold_dq_tc"], bwd_ms["fold_dkv_tc"]
    print(f"(j) zamba2-7b training ({TRAIN_LAYERS} layers at full width, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in {TRAIN_MICRO} "
          f"microbatches, remat) on {card}: step {step_j:.0f} ms (host "
          f"clock, median of steps 1-{TRAIN_STEPS - 1}), "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_j * 1e3:.0f} tokens/s; device "
          f"busy {busy_j:.1f} ms in the profiled step; peak device memory "
          f"{peak_train / 2**30:.2f} GiB over the steps, "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB in the "
          f"phase; bf16 backward at d {jcfg.head_dim} (D 128): fold_dq_tc "
          f"{dq_row['ms']:.3f} ms (SIMT fold_dq "
          f"{bwd_ms['fold_dq']['ms']:.3f}; bound "
          f"{dq_row['bound_ms']:.4f}), fold_dkv_tc {dkv_row['ms']:.3f} ms "
          f"(SIMT fold_dkv {bwd_ms['fold_dkv']['ms']:.3f}; bound "
          f"{dkv_row['bound_ms']:.4f}), SDPA backward (dq, dk, dv) "
          f"{dq_row['library_ms']:.3f} ms; the SSD carry at bt "
          f"{j_chunks}: forward {carry_rows['affine_fwd']['ms']:.4f} ms, "
          f"backward {carry_rows['affine_bwd']['ms']:.4f} ms (bound "
          f"{carry_rows['affine_bwd']['bound_ms']:.4f}); phase "
          f"{time.perf_counter() - t_phase:.0f} s")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
