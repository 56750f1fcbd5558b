"""The port's policy reaches the reference's decisions, branch for branch.

``choose``, ``choose_schedule`` and ``explain_schedule`` of
``repro_torch.core.scan.policy`` are compared with the reference's on a
grid of (batch, n, block_elems, cores, itemsize) that contains every
boundary the reference's tests pin (batch == cores, one row short of
it, single-block rows, exactly ``spare`` chunks, the tree block
threshold and one under it, the fast-memory budget across itemsizes).
"""

import dataclasses
import itertools

import pytest
import torch

from repro.core.scan import policy as jpolicy
from repro_torch.core.scan import policy
from repro_torch.obs import trace

CORES = (8, 132)
BATCHES = (1, 2, 4, 7, 8, 9, 64, 131, 132, 133, 8192)
NS = (1, 1024, 2048, 4096, 8192, 8 * 2048, 132 * 2048, 1 << 21, 1 << 22,
      1 << 28)
BLOCKS = (128, 2048, 4096, 8191, 8192, 16384)


def _same_decision(got, want):
    assert (got.what, got.value, got.reason) == \
        (want.what, want.value, want.reason)
    assert got.inputs == want.inputs


@pytest.mark.parametrize("cores", CORES)
@pytest.mark.parametrize("block_elems", BLOCKS)
def test_explain_schedule_matches_reference(block_elems, cores):
    for batch, n, prefer in itertools.product(BATCHES, NS, (True, False)):
        got = policy.explain_schedule(batch, n, cores, block_elems, prefer)
        want = jpolicy.explain_schedule(batch, n, cores, block_elems, prefer)
        _same_decision(got, want)
        assert policy.choose_schedule(batch, n, cores, block_elems,
                                      prefer) == want.value


@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
@pytest.mark.parametrize("cores", CORES)
def test_choose_matches_reference(itemsize, cores):
    for batch, n, abundant, kernel_ok, n_devices in itertools.product(
            (1, 7, 8, 132, 8192), NS + (1 << 20, (1 << 21) + 1),
            (False, True), (True, False), (1, 512)):
        got = policy.choose(n, itemsize, n_devices, abundant, 4096,
                            kernel_ok, batch, cores)
        want = jpolicy.choose(n, itemsize, n_devices, abundant, 4096,
                              kernel_ok, batch, cores)
        assert dataclasses.astuple(got)[:6] == dataclasses.astuple(want)[:6]
        assert got.inputs == want.inputs


def test_constants_match_reference():
    for name in ("VMEM_BYTES", "VMEM_BLOCK_BUDGET", "NUM_CORES",
                 "TREE_BLOCK_ELEMS"):
        assert getattr(policy, name) == getattr(jpolicy, name), name


def test_default_cores_on_cpu():
    assert policy.cores_of(torch.zeros(3)) == policy.NUM_CORES


def test_decisions_emit_trace_events():
    tracer = trace.enable()
    try:
        tracer.clear()
        policy.explain_schedule(1, 1 << 20)
        policy.choose(1 << 22)
        names = [e["name"] for e in tracer.events()]
        assert "policy.schedule" in names and "policy.choose" in names
        ev = next(e for e in tracer.events()
                  if e["name"] == "policy.schedule")
        assert ev["args"]["value"] == "fused" and ev["args"]["batch"] == 1
    finally:
        trace.disable()


def test_choice_inputs_excluded_from_equality():
    a = policy.choose(1 << 22)
    b = dataclasses.replace(a, inputs={})
    assert a == b
    assert a.inputs["n"] == 1 << 22 and "schedule" not in a.inputs


# ---------------------------------------------------------------------------
# The two-way attention fold rule
# ---------------------------------------------------------------------------

ROWS = (1, 2, 4, 7, 8, 9, 16, 63, 64, 65, 131, 132, 160, 1055, 1056, 1057,
        4096)
KV_LENS = (1, 128, 1024, 2048, 32767, 1 << 15, (1 << 15) + 1, 131072)


@pytest.mark.parametrize("cores", CORES)
@pytest.mark.parametrize("block_elems", [64, 128, 512])
def test_explain_attention_schedule_matches_reference(block_elems, cores):
    """Every branch of the reference's rule: idle cores with chunks to
    spread, a long KV chain under the row cap, the carry default."""
    for rows, kv in itertools.product(ROWS, KV_LENS):
        got = policy.explain_attention_schedule(rows, kv, cores,
                                                block_elems)
        want = jpolicy.explain_attention_schedule(rows, kv, cores,
                                                  block_elems)
        _same_decision(got, want)
        assert policy.choose_attention_schedule(
            rows, kv, cores, block_elems) == want.value


def test_attention_constants_and_cases_match_reference():
    assert policy.SPLIT_KV_CHUNKS == jpolicy.SPLIT_KV_CHUNKS == 256
    assert policy.SPLIT_KV_ROW_CAP == jpolicy.SPLIT_KV_ROW_CAP == 8
    cores = policy.NUM_CORES
    assert policy.choose_attention_schedule(cores // 2, 1 << 15) \
        == "decoupled"
    assert policy.choose_attention_schedule(4 * cores, 1 << 15) \
        == "decoupled"
    assert policy.choose_attention_schedule(
        cores * policy.SPLIT_KV_ROW_CAP, 1 << 15) == "carry"
    assert policy.choose_attention_schedule(cores * 4, 2048) == "carry"
    # the H100 cells: phi3 decode (160 rows, 1024 chunks) splits KV,
    # gemma2-9b training (16 heads x 64 q blocks) keeps the carry
    assert policy.choose_attention_schedule(160, 131072, 132) == "decoupled"
    assert policy.choose_attention_schedule(1024, 8192, 132) == "carry"


def test_attention_decision_emits_trace_event():
    tracer = trace.enable()
    try:
        tracer.clear()
        policy.explain_attention_schedule(4, 1 << 15)
        ev = next(e for e in tracer.events()
                  if e["name"] == "policy.attention_schedule")
        assert ev["args"]["value"] == "decoupled"
        assert ev["args"]["batch_rows"] == 4
    finally:
        trace.disable()
