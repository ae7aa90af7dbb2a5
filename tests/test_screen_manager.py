"""_ScreenManager behavior under stalled / failing compiles.

The manager must (a) never block a concurrent dispatcher behind a
warm-up caller's long wait (the lock is released around future waits),
(b) bound every caller's wait by its own budget even when the compile
never finishes, (c) adopt a compile that lands after the budget, and
(d) raise — never degrade without a word — when a compile fails or
hangs past HARD_ABANDON_S.
"""

import threading
import time
from concurrent.futures import Future

import pytest

from lofreq_tpu.ops import screen as S


class _StubManager(S._ScreenManager):
    """Manager whose submits return a controllable Future instead of
    launching a real jit compile."""

    def __init__(self):
        super().__init__()
        self.futures = []

    def _submit(self, key):
        fut = Future()
        self.futures.append(fut)
        self._inflight = (key, fut, time.time())
        return fut


def test_never_finishing_compile_bounds_the_wait():
    m = _StubManager()
    t0 = time.time()
    assert m.get(256, 32, wait_s=0.3) is None
    assert time.time() - t0 < 2.0
    # subsequent non-blocking polls return immediately, still None
    t0 = time.time()
    assert m.get(256, 32) is None
    assert time.time() - t0 < 0.2


def test_concurrent_poll_not_blocked_by_long_wait():
    m = _StubManager()
    started = threading.Event()
    waited = []

    def warmer():
        started.set()
        m.get(256, 32, wait_s=3.0)

    th = threading.Thread(target=warmer, daemon=True)
    th.start()
    started.wait()
    time.sleep(0.1)  # warmer is inside its future wait, lock released
    t0 = time.time()
    assert m.get(256, 32) is None  # dispatcher poll: instant host path
    waited.append(time.time() - t0)
    assert waited[0] < 0.5, "dispatcher blocked behind warm-up wait"
    m.futures[0].set_result(lambda *a, **k: None)
    th.join(timeout=5)
    assert m.get(256, 32) is not None


def test_late_adoption_after_budget_miss():
    m = _StubManager()
    assert m.get(256, 32, wait_s=0.1) is None
    m.futures[0].set_result(lambda *a, **k: "fn")
    assert m.get(256, 32)(None) == "fn"


def test_hard_abandon_degrades_without_memo_write():
    """A compile still pending after HARD_ABANDON_S raises instead of
    leaving the screen dark; nothing is remembered between processes,
    so the next get() starts a fresh compile."""
    m = _StubManager()
    m.HARD_ABANDON_S = 0.05
    assert m.get(256, 32, wait_s=0.01) is None
    time.sleep(0.1)
    with pytest.raises(TimeoutError):
        m.get(256, 32)
    assert m._inflight is None
    assert m.get(256, 32, wait_s=0.01) is None
    assert len(m.futures) == 2


def test_failed_compile_degrades_and_memoizes():
    """A compile that fails raises its own error to the caller that
    adopts it; the manager keeps no degraded state, so a later get()
    compiles again."""
    m = _StubManager()
    assert m.get(256, 32, wait_s=0.05) is None
    m.futures[0].set_exception(RuntimeError("boom"))
    with pytest.raises(RuntimeError, match="boom"):
        m.get(256, 32)
    assert m._inflight is None and not m._fns
    m.get(256, 32, wait_s=0.01)
    assert len(m.futures) == 2


def test_other_shape_compile_does_not_block_adoption():
    """At most one compile in flight: a second shape polls as None until
    the first lands, then gets its own compile."""
    m = _StubManager()
    assert m.get(256, 32, wait_s=0.01) is None
    assert m.get(512, 32) is None
    assert len(m.futures) == 1
    m.futures[0].set_result(lambda *a, **k: "a")
    assert m.get(512, 32, wait_s=0.01) is None  # adopts (256, 32) first
    assert m.get(256, 32)(None) == "a"
    assert m.get(512, 32, wait_s=0.01) is None
    assert len(m.futures) == 2
