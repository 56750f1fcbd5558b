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
