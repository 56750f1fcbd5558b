"""Algorithm selection policy — the paper's §5 observations, codified.

The PyTorch counterpart of the reference's ``core/scan/policy.py``, with
the same decision structure, branches and reasons:

  Obs 1  Dilation factors are fragile → never auto-pick dilated variants.
  Obs 2  Partition only when bandwidth-bound → inputs that fit in fast
         memory skip the blocked machinery.
  Obs 3  Accumulate-first + partitioning is the most robust organization.
  Obs 5  Tree/vertical lose on memory access → never auto-picked.

Kernel SCHEDULE rule (``choose_schedule``, surfaced as
``Choice.schedule``): the kernel-backed scan runs one of four
organizations, executed by ``repro_torch.kernels.scan_engine``:

  'carry'      one block per row walks the row's chunks with the running
               total in a register: read n + write n, parallelism ==
               rows. Chosen when ``batch >= cores``.
  'decoupled'  reduce-then-scan: a parallel totals pass, a tiny
               sequential chain over chunk totals, a parallel apply pass
               (read 2n + write n) — spreads ONE row over the card.
  'fused'      the single-launch form of decoupled: one kernel whose
               chunks chain their prefixes through a look-back
               (read n + write n).
  'tree'       carry's loop with the work-efficient Blelloch sweep as the
               in-tile network; chosen over carry for long tiles
               (``block_elems >= TREE_BLOCK_ELEMS``).

Attention FOLD rule (``choose_attention_schedule``): two-way, carry
(the flash forward's (head, q-block) rows in parallel, KV sequential) or
decoupled (split-KV / flash-decoding) for rows that leave cores idle or
KV chains that dominate a row's latency.

The thresholds are the reference's TPU guesses and count as unmeasured on
the GPU. ``NUM_CORES`` stays the default so that CPU callers reach the
reference's decisions; ``core.scan.api``, ``ssm_scan`` and
``flash_attention`` pass the card's SM count (``cores_of``) for CUDA
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.obs import trace


# The reference's TPU v5e planning numbers (unmeasured on the GPU).
VMEM_BYTES = 64 * 1024 * 1024
VMEM_BLOCK_BUDGET = VMEM_BYTES // 8  # working set <= 1/8 VMEM: in+out+slack

# Cores one kernel launch can spread over (the paper's thread count).
NUM_CORES = 8

# In-tile element count above which the work-efficient tree network pays
# for its strided sweep passes (the paper's Observation 5 tradeoff).
TREE_BLOCK_ELEMS = 8192


def cores_of(x: torch.Tensor) -> int:
    """Cores a launch on ``x``'s device spreads over: the SM count of a
    CUDA device, ``NUM_CORES`` elsewhere."""
    if x.is_cuda:
        return torch.cuda.get_device_properties(
            x.device).multi_processor_count
    return NUM_CORES


@dataclasses.dataclass(frozen=True)
class Choice:
    algorithm: str  # 'horizontal' | 'blocked' | 'two_pass' | 'kernel'
    block_size: int
    variant: int  # two-pass organization (1 = scan-first, 2 = reduce-first)
    carry_exchange: str  # distributed sums exchange
    reason: str
    schedule: str = "carry"  # grid org: 'carry'|'decoupled'|'fused'|'tree'
    # The inputs the choice was made from; excluded from equality.
    inputs: Dict = dataclasses.field(default_factory=dict, compare=False)


@dataclasses.dataclass(frozen=True)
class Decision:
    """A policy decision plus why. ``inputs`` echoes every argument the
    rule consumed."""

    what: str        # which rule decided ('schedule' | 'choose')
    value: str       # the decision itself
    reason: str      # human-readable rationale
    inputs: Dict = dataclasses.field(default_factory=dict, compare=False)

    def emit(self) -> "Decision":
        """Record the decision as a trace instant event (no-op when
        tracing is disabled) and return self."""
        trace.instant(f"policy.{self.what}", value=self.value,
                      reason=self.reason, **self.inputs)
        return self


def explain_schedule(
    batch: int,
    n: int,
    cores: int = NUM_CORES,
    block_elems: int = 2048,
    prefer_fused: bool = True,
) -> Decision:
    """``choose_schedule`` with its working shown: the decision, the
    branch of the four-way rule that fired, and the inputs — emitted as
    a ``policy.schedule`` trace event."""
    batch = max(int(batch), 1)
    chunks = -(-n // max(block_elems, 1))
    spare = cores // batch  # cores idle under the carry chain
    inputs = dict(batch=batch, n=n, cores=cores, block_elems=block_elems,
                  chunks=chunks, spare=spare, prefer_fused=prefer_fused)
    if batch >= cores:
        if block_elems >= TREE_BLOCK_ELEMS:
            return Decision(
                "schedule", "tree",
                f"batch {batch} >= cores {cores} and block_elems "
                f"{block_elems} >= {TREE_BLOCK_ELEMS}: rows fill every "
                f"core and the tile is long enough that the "
                f"work-efficient tree sweep beats the log network",
                inputs).emit()
        return Decision(
            "schedule", "carry",
            f"batch {batch} >= cores {cores}: rows alone fill every core; "
            f"carry chain has the cheapest HBM traffic", inputs).emit()
    # A parallel-sequence schedule costs extra machinery (a second read,
    # or the semaphore chain); only worth it when the idle cores can
    # actually be fed — at least ``spare`` chunks per row (a row inside
    # one block has nothing to parallelize).
    if spare >= 2 and chunks >= spare:
        value = "fused" if prefer_fused else "decoupled"
        return Decision(
            "schedule", value,
            f"batch {batch} < cores {cores} with {chunks} chunks >= "
            f"{spare} spare cores: spread the row "
            f"({'single-launch fused' if prefer_fused else 'two-launch decoupled'})",
            inputs).emit()
    return Decision(
        "schedule", "carry",
        f"batch {batch} < cores {cores} but only {chunks} chunk(s) for "
        f"{spare} spare core(s): nothing to spread, keep the carry chain",
        inputs).emit()


def choose_schedule(
    batch: int,
    n: int,
    cores: int = NUM_CORES,
    block_elems: int = 2048,
    prefer_fused: bool = True,
) -> str:
    """Kernel grid organization for a (batch, n) scan — see module doc.

    ``block_elems`` must be the chunk length the kernel will actually
    tile with — the chunks-per-spare-core test is meaningless against
    any other block size. ``prefer_fused=False`` picks the two-launch
    decoupled form over the single-launch fused one for parallel-sequence
    shapes.
    ``explain_schedule`` returns the same decision with its rationale.
    """
    return explain_schedule(batch, n, cores, block_elems, prefer_fused).value


# Attention (carried-payload fold) thresholds. SPLIT_KV_CHUNKS is the KV
# chain length past which the fold's serial latency dominates a row's
# cost and the split-KV form pays for its chain traffic — 256 chunks is
# 32k context at the default 128-wide KV block, the serve long-context
# class. SPLIT_KV_ROW_CAP bounds it to decode/scoring shapes (few query
# rows): when (head, q-block) rows already oversubscribe every core by
# this factor, splitting KV buys no throughput and only adds traffic.
SPLIT_KV_CHUNKS = 256
SPLIT_KV_ROW_CAP = 8


def explain_attention_schedule(
    batch_rows: int,
    kv_len: int,
    cores: int = NUM_CORES,
    block_elems: int = 128,
    split_kv_chunks: int = SPLIT_KV_CHUNKS,
    split_kv_row_cap: int = SPLIT_KV_ROW_CAP,
) -> Decision:
    """``choose_attention_schedule`` with its working shown — emitted as
    a ``policy.attention_schedule`` trace event."""
    batch_rows = max(int(batch_rows), 1)
    chunks = -(-kv_len // max(block_elems, 1))
    spare = cores // batch_rows
    inputs = dict(batch_rows=batch_rows, kv_len=kv_len, cores=cores,
                  block_elems=block_elems, chunks=chunks, spare=spare,
                  split_kv_chunks=split_kv_chunks,
                  split_kv_row_cap=split_kv_row_cap)
    if batch_rows < cores and spare >= 2 and chunks >= spare:
        return Decision(
            "attention_schedule", "decoupled",
            f"{batch_rows} fold row(s) leave {spare} cores idle and the "
            f"KV chain has {chunks} chunks to spread: split-KV "
            f"(flash-decoding)", inputs).emit()
    if chunks >= split_kv_chunks and batch_rows < cores * split_kv_row_cap:
        return Decision(
            "attention_schedule", "decoupled",
            f"KV chain of {chunks} chunks >= {split_kv_chunks} dominates "
            f"a row's latency and {batch_rows} rows < "
            f"{cores * split_kv_row_cap} saturation cap: split-KV",
            inputs).emit()
    return Decision(
        "attention_schedule", "carry",
        f"{batch_rows} rows fill the machine (or the {chunks}-chunk KV "
        f"chain is short): classic flash carry accumulate", inputs).emit()


def choose_attention_schedule(
    batch_rows: int,
    kv_len: int,
    cores: int = NUM_CORES,
    block_elems: int = 128,
    split_kv_chunks: int = SPLIT_KV_CHUNKS,
    split_kv_row_cap: int = SPLIT_KV_ROW_CAP,
) -> str:
    """Grid organization for the attention fold (softmax pair + payload).

    Two-way (attention has no fused form — the output is the fold, so
    there is no per-element writeback to chain a prefix into):

      carry      the flash forward: (head, q-block) rows parallel, KV
                 blocks a sequential accumulate. Right whenever the rows
                 fill the machine and the KV chain is short — training
                 and ordinary prefill shapes.
      decoupled  split-KV / flash-decoding: KV chunks parallel, partial
                 (m, l, acc) payloads combined in a tiny second step.
                 Chosen when rows leave cores idle (decode: one q block,
                 ``batch_rows == B·H``), or when the KV chain is long
                 (the 32k/500k-context prefill and padded-cache scoring
                 class) while rows stay within ``SPLIT_KV_ROW_CAP·cores``
                 — fully saturated rows keep the carry form, where
                 splitting adds chain traffic and returns nothing.

    ``batch_rows`` is the number of independent fold chains the carry
    grid already parallelizes (B·H_q·q_blocks); ``block_elems`` the KV
    chunk length actually tiled. ``explain_attention_schedule`` returns
    the same decision with its rationale.
    """
    return explain_attention_schedule(
        batch_rows, kv_len, cores, block_elems, split_kv_chunks,
        split_kv_row_cap).value


def choose(
    n: int,
    itemsize: int = 4,
    n_devices: int = 1,
    bandwidth_abundant: bool = False,
    carry_bytes: int = 4,
    kernel_available: bool = True,
    batch: int = NUM_CORES,
    cores: int = NUM_CORES,
) -> Choice:
    """Pick a scan algorithm for ``n`` elements of ``itemsize`` bytes.

    ``batch`` is the number of independent rows scanned together (defaults
    to "plenty" so shape-oblivious callers keep the carry-chain default);
    it only affects ``Choice.schedule``. Every call emits a
    ``policy.choose`` trace event carrying the inputs and reason.
    """
    bytes_total = n * itemsize
    block = max(1024, min(VMEM_BLOCK_BUDGET // max(itemsize, 1), n))
    schedule = choose_schedule(batch, n, cores)
    inputs = dict(n=n, itemsize=itemsize, n_devices=n_devices,
                  bandwidth_abundant=bandwidth_abundant,
                  carry_bytes=carry_bytes,
                  kernel_available=kernel_available, batch=batch,
                  cores=cores, bytes_total=bytes_total)

    def _emit(choice: Choice) -> Choice:
        Decision("choose", choice.algorithm, choice.reason,
                 dict(inputs, schedule=choice.schedule,
                      block_size=choice.block_size)).emit()
        return choice

    if bytes_total <= VMEM_BLOCK_BUDGET:
        # Fits in fast memory: one horizontal pass, no partitioning (Obs 2).
        return _emit(Choice(
            "horizontal", n, 2, "all_gather",
            "input fits in VMEM; in-register log-step scan only",
            inputs=inputs,
        ))

    if bandwidth_abundant:
        # The KNL/HBM finding: when bandwidth is abundant, partitioning's
        # overhead is pure cost (Obs 2) — plain two-pass, reduce-first.
        return _emit(Choice(
            "two_pass", block, 2, "all_gather",
            "bandwidth abundant: skip partitioning (paper Fig 13)",
            schedule, inputs=inputs,
        ))

    algo = "kernel" if kernel_available else "blocked"
    # Large carries (e.g. SSM matrix states) across many devices favor the
    # log-step permute exchange over all-gather.
    exchange = "all_gather"
    if n_devices > 1 and carry_bytes * n_devices > 1 << 20:
        exchange = "hillis_permute"
    reason = "bandwidth-bound: cache/VMEM partitioning, reduce-first (SIMD2-P)"
    if schedule in ("decoupled", "fused"):
        reason += f"; {schedule} grid (batch < cores, long row)"
    return _emit(Choice(algo, block, 2, exchange, reason, schedule,
                        inputs=inputs))
