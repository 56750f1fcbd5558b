"""Host-side tracer: spans, instant events, counters — Perfetto-openable.

A copy of the reference package's ``obs/trace.py`` with the same API: a
lightweight tracer every layer of the stack can call unconditionally.
The design contract is that tracing must be FREE when disabled and
INVISIBLE when enabled — it never touches device values, never forces a
sync, and never changes control flow, so results are bitwise identical
with tracing on or off.

  * ``span(name, **args)`` — a context manager recording one Chrome
    ``"X"`` (complete) event with microsecond ``ts``/``dur``. Nesting is
    reconstructed by the viewer from containment per thread track.
  * ``instant(name, **args)`` — a ``"i"`` event: request lifecycle
    transitions, policy decisions, kernel launches.
  * ``counter(name, **series)`` — a ``"C"`` event: queue depth, tokens.

Events land in a thread-safe ring buffer (bounded memory: a long
run keeps the most recent ``capacity`` events). ``export()`` writes the
Chrome ``trace_event`` JSON object format — load the file in
``ui.perfetto.dev`` or ``chrome://tracing``.

The module-level singleton is DISABLED by default: ``span`` hands back a
shared no-op context manager and ``instant``/``counter`` return before
touching the clock, so instrumented hot paths (kernel launches,
policy decisions) pay one attribute check. ``enable()``
swaps in a live ``Tracer``; library code uses the module-level functions
and never holds a tracer reference across an enable/disable.

PyTorch runs eagerly, so kernel-launch events and policy decisions fire
once per CALL (the reference, under ``jit``, records them once per
compilation).
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Dict, List, Optional

# Chrome trace_event phases we emit.
_PH_COMPLETE = "X"
_PH_INSTANT = "i"
_PH_COUNTER = "C"


def _now_us() -> float:
    return time.perf_counter_ns() / 1e3


def _jsonable(v: Any) -> Any:
    """Coerce event args to JSON-safe values."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


class _NoopSpan:
    """Shared, allocation-free context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = _now_us()
        return self

    def __exit__(self, *exc):
        t1 = _now_us()
        self._tracer._record({
            "name": self._name, "ph": _PH_COMPLETE, "ts": self._t0,
            "dur": t1 - self._t0, "pid": 0,
            "tid": threading.get_ident() % 1_000_000,
            "args": _jsonable(self._args),
        })
        return False


class Tracer:
    """Thread-safe ring-buffered event collector (see module doc)."""

    def __init__(self, capacity: int = 1 << 16):
        self.enabled = True
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()

    # -- recording ------------------------------------------------------
    def _record(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, **args):
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self._record({
            "name": name, "ph": _PH_INSTANT, "ts": _now_us(), "pid": 0,
            "tid": threading.get_ident() % 1_000_000, "s": "t",
            "args": _jsonable(args),
        })

    def counter(self, name: str, **series) -> None:
        if not self.enabled:
            return
        self._record({
            "name": name, "ph": _PH_COUNTER, "ts": _now_us(), "pid": 0,
            "tid": threading.get_ident() % 1_000_000,
            "args": _jsonable(series),
        })

    # -- inspection / export --------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def export(self, path: Optional[str] = None) -> dict:
        """Chrome trace_event JSON (object format). Writes ``path`` when
        given; always returns the document."""
        doc = {"traceEvents": self.events(), "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


class _DisabledTracer(Tracer):
    """The default singleton: every entry point is a guaranteed no-op."""

    def __init__(self):
        super().__init__(capacity=1)
        self.enabled = False

    def _record(self, ev: dict) -> None:  # pragma: no cover — guarded
        pass


_DISABLED = _DisabledTracer()
_tracer: Tracer = _DISABLED
_state_lock = threading.Lock()


def get() -> Tracer:
    """The active tracer (the disabled singleton unless ``enable``d)."""
    return _tracer


def enabled() -> bool:
    return _tracer.enabled


def enable(capacity: int = 1 << 16) -> Tracer:
    """Install (and return) a live tracer; idempotent per process state."""
    global _tracer
    with _state_lock:
        if not _tracer.enabled:
            _tracer = Tracer(capacity=capacity)
        return _tracer


def disable() -> None:
    """Swap the disabled singleton back in (recorded events are dropped)."""
    global _tracer
    with _state_lock:
        _tracer = _DISABLED


# Module-level conveniences — what instrumented code actually calls.
def span(name: str, **args):
    return _tracer.span(name, **args)


def instant(name: str, **args) -> None:
    _tracer.instant(name, **args)


def counter(name: str, **series) -> None:
    _tracer.counter(name, **series)


def export(path: Optional[str] = None) -> dict:
    return _tracer.export(path)
