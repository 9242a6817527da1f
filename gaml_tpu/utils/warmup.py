"""Background device warm-up threads (shared by the short-read and
PacBio cost-model routers).

A COLD device executable must not block the anneal: the caller serves
the batch natively (bit-identical) and hands the same batch to a daemon
thread whose dispatch performs the synchronous XLA compile; once the
thread finishes, the executable is warm and later batches route to the
device.  A warm-up that raises is a broken device route, not a reason to
serve natively for good: the next ``device_ready`` call for that key
raises it.  Threads are joined at interpreter exit."""
from __future__ import annotations

import atexit
import threading
from typing import Callable, Dict, Tuple

_THREADS: list = []
# key -> True (warm) | Thread (in flight) | BaseException (warm-up failed)
_STATE: Dict[Tuple, object] = {}


class WarmupError(RuntimeError):
    """A device executable failed to compile or run during warm-up."""


def _join_all() -> None:
    for th in _THREADS:
        if th.is_alive():
            th.join(timeout=120)
    _THREADS.clear()


atexit.register(_join_all)


def mark_ready(key: Tuple) -> None:
    """Record ``key``'s executable as warm without a thread — used by
    explicit prewarm paths that compiled it synchronously."""
    _STATE[key] = True


def mark_failed(key: Tuple, exc: BaseException) -> None:
    """Record that warming ``key`` raised ``exc``; the next device_ready
    call for the key raises it."""
    _STATE[key] = exc


def register_inflight(key: Tuple, thread) -> None:
    """Attach ``key`` to an externally managed warm thread (e.g. the
    PacBio prewarm) so concurrent device_ready callers route native
    instead of spawning DUPLICATE compiles of the same executable.
    No-op if the key is already warm."""
    if _STATE.get(key) is not True:
        _STATE[key] = thread


def _start(key: Tuple, warm_fn: Callable[[], None]) -> None:
    def run():
        try:
            warm_fn()
        except Exception as e:  # handed to the caller by device_ready
            _STATE[key] = e

    th = threading.Thread(target=run, daemon=True, name="gaml-dev-warmup")
    _STATE[key] = th
    _THREADS.append(th)
    th.start()


def device_ready(key: Tuple, warm_fn: Callable[[], None]) -> bool:
    """True once the executable behind ``key`` is warm.  On first call
    (cold), starts a daemon thread running ``warm_fn`` (which should
    dispatch the compile and skip result fetches) and returns False;
    while the thread runs, keeps returning False.  Raises WarmupError
    once a warm-up for the key has failed."""
    st = _STATE.get(key)
    if st is True:
        return True
    if isinstance(st, BaseException):
        raise WarmupError(f"device warm-up of {key} failed: "
                          f"{type(st).__name__}: {st}") from st
    if st is not None:  # a Thread
        if st.is_alive():
            return False
        if _STATE.get(key) is st:  # finished without recording a failure
            _STATE[key] = True
            return True
        return device_ready(key, warm_fn)
    _start(key, warm_fn)
    return False
