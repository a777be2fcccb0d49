"""Process-wide performance counters.

Code paths that launch device work add their call counts and the host
wall time until the result is back on the host (the np.asarray() that
forces the transfer), plus work counts: segment jobs per tier, swept
cells, escalations. These are host-clock counters, not device busy
time; that comes from a profiler trace.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counters: dict[str, float] = {}


def add(key: str, value: float) -> None:
    with _lock:
        _counters[key] = _counters.get(key, 0.0) + value


def get(key: str) -> float:
    with _lock:
        return _counters.get(key, 0.0)


def snapshot() -> dict[str, float]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _counters.clear()
