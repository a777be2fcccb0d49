"""Shared worker pool for host-side WFA work.

Thread pool, not fork pool. The pooled workloads (host WFA leaves,
inversion rev-tries, anchor planning) are dominated by native C++
(wfmash_tpu/native/_wfa.so via ctypes, which releases the GIL for the
duration of the call) and large numpy kernels (which release it too),
so threads parallelize them fully — and, unlike fork(), they cannot
deadlock on mutexes held by JAX/PJRT background threads at fork time.
That deadlock was observed once: a cold all-vs-all run forked the pool
after the device client had spun up its threads, and the children hung
inside inherited locks (os.fork() + multithreaded JAX).

``WFMASH_TPU_POOL=fork`` restores the old fork pool (useful only if the
native WFA library cannot be built and the pure-Python fallback needs
process-level parallelism).
"""

from __future__ import annotations

import atexit
import os

_pool = None
_size = 0
_kind = None


def get_pool(threads: int):
    """Return a shared worker pool with `threads` workers (or None when
    threads <= 1 or pools are unavailable)."""
    global _pool, _size, _kind
    if threads <= 1:
        return None
    want = os.environ.get("WFMASH_TPU_POOL", "thread")
    if _pool is not None and _size == threads and _kind == want:
        return _pool
    close_pool()
    try:
        if want == "fork":
            import multiprocessing as mp

            _pool = mp.get_context("fork").Pool(processes=threads)
        else:
            from multiprocessing.pool import ThreadPool

            _pool = ThreadPool(processes=threads)
        _size = threads
        _kind = want
        atexit.register(close_pool)
    except Exception:   # pragma: no cover - platform-specific
        _pool = None
        _size = 0
        _kind = None
    return _pool


def close_pool() -> None:
    global _pool, _size, _kind
    if _pool is not None:
        try:
            _pool.terminate()
            _pool.join()
        except Exception:   # pragma: no cover
            pass
        _pool = None
        _size = 0
        _kind = None
