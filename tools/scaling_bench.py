#!/usr/bin/env python3
"""Scaling-efficiency harness for the sharded column-calling step.

Runs build_sharded_column_call on a 1/2/4/.../N-device mesh of virtual
CPU devices and reports columns/sec per mesh size plus efficiency vs the
1-device run.

NB: on a virtual CPU mesh all "devices" share the host's physical cores,
so ideal scaling is impossible past the core count; the harness's job
there is measuring shard_map/psum overhead (efficiency >= 0.8 at N <=
cores is the BASELINE.json target; on real chips each device brings its
own silicon).

Usage: python tools/scaling_bench.py [max_devices] [B_per_dev] [D]
"""

import json
import os
import sys
import time


def main():
    max_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    b_per_dev = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    D = int(sys.argv[3]) if len(sys.argv) > 3 else 512

    if "xla_force_host_platform_device_count" not in os.environ.get(
            "XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") +
            f" --xla_force_host_platform_device_count={max_dev}")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np

    import jax

    if max_dev > 1:
        # the harness measures the virtual CPU mesh (must happen before
        # any backend is initialized)
        jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import __graft_entry__ as ge
    from jax.sharding import NamedSharding, PartitionSpec as P
    from lofreq_tpu.ops.device_call import build_sharded_column_call

    rows = []
    base_rate = None
    n = 1
    while n <= max_dev and n <= len(jax.devices()):
        mesh = Mesh(np.array(jax.devices()[:n]), ("cols",))
        fn, _ = build_sharded_column_call(mesh=mesh, use_baq=True)
        B = b_per_dev * n
        # pre-place the batch with the mesh sharding: the timed section
        # measures the sharded step (compute + psum), not host->device
        # staging — production overlaps the staging with the next
        # window's ingest (pipelines/call_pipeline.py)
        sh = NamedSharding(mesh, P("cols"))
        args = tuple(jax.device_put(a, sh)
                     for a in ge._example_batch(B=B, D=D))
        out = fn(*args)  # compile + warm
        _ = int(out["num_tested"])
        times = []
        for _i in range(3):
            t0 = time.perf_counter()
            out = fn(*args)
            _ = int(out["num_tested"])  # host fetch = full sync
            times.append(time.perf_counter() - t0)
        rate = B / min(times)
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * n)
        rows.append(dict(devices=n, cols_per_sec=round(rate, 1),
                         efficiency=round(eff, 3)))
        print(json.dumps(rows[-1]), flush=True)
        n *= 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
