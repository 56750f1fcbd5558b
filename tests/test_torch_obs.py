"""The port's observability copies: the reference's trace and metrics
cases that need no serve stack, plus the port's kernel-launch event.

``repro_torch.obs`` is a copy of ``repro.obs`` with the same API, so the
same calls must give the same documents; the histogram is also compared
with the reference's value for value.
"""

import json
import math
import threading

import numpy as np
import pytest
import torch

from repro.obs.metrics import Histogram as JaxHistogram
from repro_torch.kernels.scan_blocked import ops
from repro_torch.obs import Registry, trace
from repro_torch.obs.metrics import Histogram


@pytest.fixture
def tracer():
    """A live tracer, guaranteed disabled again afterwards."""
    t = trace.enable()
    t.clear()
    yield t
    trace.disable()


def test_span_nesting_and_chrome_schema(tracer, tmp_path):
    with trace.span("outer", depth=0):
        with trace.span("inner", depth=1):
            trace.instant("marker", k="v")
        trace.counter("queue", depth=3)
    path = tmp_path / "t.json"
    doc = trace.export(str(path))

    assert json.loads(path.read_text()) == doc
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    by_name = {e["name"]: e for e in evs}
    assert set(by_name) == {"outer", "inner", "marker", "queue"}
    for e in evs:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(e)
        assert isinstance(e["ts"], float) and e["ts"] >= 0
    assert by_name["outer"]["ph"] == "X" and by_name["inner"]["ph"] == "X"
    assert by_name["marker"]["ph"] == "i" and by_name["marker"]["s"] == "t"
    assert by_name["queue"]["ph"] == "C"
    assert by_name["queue"]["args"] == {"depth": 3}
    outer, inner, marker = (by_name[k] for k in ("outer", "inner", "marker"))
    assert outer["tid"] == inner["tid"] == threading.get_ident() % 1_000_000
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert inner["ts"] <= marker["ts"] <= inner["ts"] + inner["dur"]
    assert inner["args"] == {"depth": 1}


def test_span_records_even_when_body_raises(tracer):
    with pytest.raises(RuntimeError):
        with trace.span("doomed"):
            raise RuntimeError("boom")
    assert [e["name"] for e in tracer.events()] == ["doomed"]


def test_ring_buffer_bounds_memory():
    t = trace.enable(capacity=8)
    try:
        for i in range(50):
            trace.instant("e", i=i)
        evs = t.events()
        assert len(evs) == 8
        assert [e["args"]["i"] for e in evs] == list(range(42, 50))
    finally:
        trace.disable()


def test_disabled_tracer_is_noop():
    trace.disable()
    assert not trace.enabled()
    s1, s2 = trace.span("a", x=1), trace.span("b")
    assert s1 is s2
    trace.instant("a")
    trace.counter("a", v=1)
    assert trace.export()["traceEvents"] == []


def test_jsonable_coerces_exotic_args(tracer):
    trace.instant("e", arr=np.int64(3), tup=(1, "a"), d={"k": np.float32(2)},
                  t=torch.tensor(1.5))
    args = tracer.events()[0]["args"]
    assert json.loads(json.dumps(args)) == args
    assert args["tup"] == [1, "a"]


def test_histogram_matches_reference_and_numpy():
    rng = np.random.default_rng(0)
    samples = rng.lognormal(mean=-3.0, sigma=1.2, size=5000)
    h, hj = Histogram(), JaxHistogram()
    for s in samples:
        h.record(float(s))
        hj.record(float(s))
    assert h.summary() == hj.summary()
    for q in (50.0, 90.0, 99.0):
        want = float(np.percentile(samples, q))
        assert abs(h.percentile(q) - want) / want < 0.10


def test_histogram_edge_cases():
    h = Histogram()
    assert np.isnan(h.percentile(50))
    h.record(0.0)
    h.record(2.5)
    assert h.count == 2 and h.min == 0.0 and h.max == 2.5
    assert h.percentile(0) <= h.percentile(100) == 2.5


def test_histogram_non_positive_observations_never_reach_log():
    h = Histogram()
    for v in (0.0, -1.0, -1e-9, -math.inf):
        h.record(v)
    assert h.count == 4 and h._underflow == 4 and h._buckets == {}
    assert h.percentile(50.0) == h.min == -math.inf
    h2 = Histogram()
    for v in (-2.0, 0.0, 1.0, 4.0):
        h2.record(v)
    s = h2.summary()
    assert s["count"] == 4 and s["min"] == -2.0 and s["max"] == 4.0
    assert s["mean"] == pytest.approx(0.75)
    qs = [h2.percentile(q) for q in (0, 25, 50, 75, 100)]
    assert qs == sorted(qs)


def test_registry_snapshot_and_reset():
    reg = Registry()
    reg.counter("c").inc(3)
    reg.gauge("g").set(1.5)
    reg.histogram("h").record(0.25)
    snap = reg.snapshot()
    assert snap["counters"]["c"] == 3
    assert snap["gauges"]["g"] == 1.5
    assert snap["histograms"]["h"]["count"] == 1
    assert json.loads(json.dumps(snap)) == snap
    assert reg.names() == ["c", "g", "h"]
    reg.reset()
    assert reg.names() == []


def test_kernel_launch_event_per_call(tracer):
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 2048)).astype(
            np.float32))
    ops.cumsum(x, schedule="decoupled", block_n=512)
    ops.cumsum(x, schedule="decoupled", block_n=512)
    evs = [e for e in tracer.events() if e["name"] == "kernel.launch"]
    assert len(evs) == 2, "eager: one event per call"
    args = evs[0]["args"]
    assert args["monoid"] == "sum" and args["schedule"] == "decoupled"
    assert args["grid"][-1] == 4 and len(args["grid"]) == 2
    # Decoupled reads the data twice (reduce pass + rescan pass).
    assert args["hbm_read_bytes_est"] == 2 * args["hbm_write_bytes_est"]
    assert args["vmem_block_bytes_est"] > 0
