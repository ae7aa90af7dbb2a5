"""bench.py must terminate with a JSON line even when the device compile
never returns (a stalled compile must not consume the harness budget
with nothing printed).

The test runs the real bench script in a subprocess with (a) a tiny
workload, (b) the screen manager's _submit stubbed to a never-completing
future, and (c) the engine selection forced to the device screen — so
the bench takes the "device path" decision, hits the dead compile, and
must still emit its JSON with engine.compile_pending=true inside the
bounded budget.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = r"""
import time
import jax
jax.config.update("jax_platforms", "cpu")  # deterministic test backend
from concurrent.futures import Future

import lofreq_tpu.ops.screen as S

S.device_screen_default = lambda: True


def _dead_submit(self, key):
    fut = Future()  # never completes: a hung compile
    self._inflight = (key, fut, time.time())
    return fut


S._ScreenManager._submit = _dead_submit

import runpy

runpy.run_path("bench.py", run_name="__main__")
"""


def test_bench_terminates_under_dead_compile_service():
    env = dict(
        os.environ,
        LOFREQ_BENCH_GENOME="4000",
        LOFREQ_BENCH_DEPTH="30",
        LOFREQ_BENCH_RUNS="2",
        LOFREQ_BENCH_COMPILE_WAIT="2",
        LOFREQ_BENCH_WALL_BUDGET="60",
    )
    t0 = time.time()
    out = subprocess.run([sys.executable, "-c", _PRELUDE], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=420)
    wall = time.time() - t0
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.strip().splitlines()
             if ln.startswith("{")]
    assert lines, (out.stdout, out.stderr[-2000:])
    rec = json.loads(lines[-1])
    assert rec["metric"] == "end_to_end_call_columns_per_sec"
    assert rec["value"] > 0, rec
    assert rec["engine"]["compile_pending"] is True
    assert rec["engine"]["screen_dispatches"] == 0
    assert rec["engine"]["backend"] == "cpu"
    # the dead service must not have eaten the budget: the bench's own
    # caps (compile wait 2s + wall budget) bound the whole thing
    assert wall < 400, wall
