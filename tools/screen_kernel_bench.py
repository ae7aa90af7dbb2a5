#!/usr/bin/env python3
"""Screen kernel variants on one GPU, in turns, at the production shape.

Variants of the (4096, 128) u8 significance screen:
  xla_unroll16    ops/screen.py as shipped (lax.scan, unroll=16)
  xla_unroll_full the same scan fully unrolled

For each: (a) device time per dispatch from a jax.profiler trace (sum of
the device-stream event durations over K dispatches, divided by K);
(b) dispatch-to-fetch latency through the production path
(screen_dispatch_codes + screen_fetch); (c) end-to-end wall of the
default `call` on 200 kb @ 800x (tests/simulate_fast.py, seed 3), the
variants run in turns for --rounds rounds.  Every call's VCF must equal
the first one's.  Last, one default call runs under the profiler and its
device busy share (union of device-stream events over the call's wall)
is reported.

Usage: python tools/screen_kernel_bench.py [--rounds 5] [--iters 200]
Prints one JSON object as the last line (also chiprun_out/).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

B, S_ROWS = 4096, 128


def build_variants():
    from lofreq_tpu.ops import screen as S

    out = {}
    for name, unroll in (("xla_unroll16", 16), ("xla_unroll_full", True)):
        S.SCAN_UNROLL = unroll
        fn = S._build_screen_fn(mesh=None)
        warm(fn)  # traces now, while SCAN_UNROLL holds this variant
        out[name] = fn
    S.SCAN_UNROLL = 16
    return out


def warm(fn):
    import jax.numpy as jnp

    z = jnp.zeros(B, jnp.int32)
    np.asarray(fn(jnp.full((B, S_ROWS), 255, jnp.uint8), z + S_ROWS, z + 1,
                  jnp.zeros(B, jnp.float32), s=S_ROWS))


def device_events(trace_dir):
    """(name, start_ns, duration_ns) of every device-stream event."""
    import jax

    paths = [os.path.join(d, f) for d, _s, fs in os.walk(trace_dir)
             for f in fs if f.endswith(".xplane.pb")]
    pd = jax.profiler.ProfileData.from_file(paths[0])
    evs = [(ev.name, ev.start_ns, ev.duration_ns)
           for plane in pd.planes if plane.name.startswith("/device:GPU")
           for line in plane.lines if "stream" in line.name.lower()
           for ev in line.events]
    return pd, evs


def device_time(fn, args, iters, trace_dir):
    """Seconds of device-stream events per dispatch, from a trace."""
    import jax

    jax.block_until_ready(fn(*args, s=S_ROWS))
    with jax.profiler.trace(trace_dir):
        for _ in range(iters):
            out = fn(*args, s=S_ROWS)
        jax.block_until_ready(out)
    pd, evs = device_events(trace_dir)
    total, names = 0, {}
    for name, _t, dur in evs:
        total += dur
        names[name] = names.get(name, 0) + dur
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    if not total:  # no device stream found: say what the trace holds
        top = {p.name: [ln.name for ln in p.lines][:8] for p in pd.planes}
        return 0.0, top
    return total / iters / 1e9, {k: v / iters / 1e9 for k, v in top}


def latency(fn, codes, ks, bonf, iters):
    from lofreq_tpu.ops import screen as S

    S._manager._fns[(B, S_ROWS)] = fn
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        S.screen_fetch(S.screen_dispatch_codes(codes, ks, bonf, 0.01))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.min(ts)), float(np.max(ts))


def call_wall(fn, art, out):
    from lofreq_tpu.cli import main
    from lofreq_tpu.ops import screen as S

    if fn is not None:
        S._manager._fns[(B, S_ROWS)] = fn
    S.DISPATCH_STATS.update(dispatched=0, unavailable=0)
    if os.path.exists(out):
        os.unlink(out)
    t0 = time.perf_counter()
    assert main(["call", "-f", art["fa"], "-o", out, art["bam"]]) == 0
    wall = time.perf_counter() - t0
    assert S.DISPATCH_STATS["dispatched"] > 0
    assert S.DISPATCH_STATS["unavailable"] == 0
    with open(out) as fh:
        body = [ln for ln in fh if not ln.startswith("##fileDate")]
    return wall, body


def busy_share(art, out, trace_dir):
    """One default call under the profiler: device busy seconds (union of
    device-stream event intervals) over the call's wall."""
    import jax

    with jax.profiler.trace(trace_dir):
        wall, _body = call_wall(None, art, out)
    _pd, evs = device_events(trace_dir)
    busy, end = 0, None
    for _n, t, d in sorted((e for e in evs), key=lambda e: e[1]):
        if end is None or t >= end:
            busy, end = busy + d, t + d
        elif t + d > end:
            busy, end = busy + (t + d - end), t + d
    return dict(call_wall_s=wall, device_busy_s=busy / 1e9,
                device_busy_share=busy / 1e9 / wall, events=len(evs))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=200)
    opts = ap.parse_args()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX's platform is {dev.platform}")
    from lofreq_tpu.ops import ensure_jax_cache

    ensure_jax_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import jax.numpy as jnp
    from chip_smoke import random_codes
    from lofreq_tpu.ops import screen as S
    from simulate_fast import simulate_fast

    rng = np.random.default_rng(0)
    codes, ks, bonf = random_codes(rng, B)
    lt = np.log(0.01 * S.MARGIN / bonf).astype(np.float32)
    args = (jnp.asarray(codes), jnp.full(B, S_ROWS, jnp.int32),
            jnp.asarray(ks.astype(np.int32)), jnp.asarray(lt))
    variants = build_variants()
    masks = {k: np.asarray(f(*args, s=S_ROWS)) for k, f in variants.items()}
    ref = masks["xla_unroll16"]
    res = dict(card=card, device_kind=dev.device_kind, shape=[B, S_ROWS],
               variants={})
    with tempfile.TemporaryDirectory() as td:
        for name, fn in variants.items():
            dt, top = device_time(fn, args, opts.iters,
                                  os.path.join(td, name))
            med, lo, hi = latency(fn, codes, ks, bonf, opts.iters)
            res["variants"][name] = dict(
                mask_diff_vs_unroll16=int((masks[name] != ref).sum()),
                device_s_per_dispatch=dt, device_top_events_s=top,
                latency_median_s=med, latency_min_s=lo, latency_max_s=hi)
            print(f"{name}: {json.dumps(res['variants'][name])}",
                  flush=True)
        art = simulate_fast(td, genome_len=200_000, depth=800, seed=3)
        out = os.path.join(td, "out.vcf")
        _w, want = call_wall(variants["xla_unroll16"], art, out)  # warm
        walls = {k: [] for k in variants}
        for r in range(opts.rounds):
            order = list(variants) if r % 2 == 0 else list(variants)[::-1]
            for name in order:
                w, body = call_wall(variants[name], art, out)
                assert body == want, f"{name}: VCF differs"
                walls[name].append(w)
        for name, ws in walls.items():
            v = res["variants"][name]
            v.update(call_walls_s=ws, call_median_s=statistics.median(ws),
                     call_min_s=min(ws), call_max_s=max(ws))
            print(f"{name}: call median {v['call_median_s']:.4f} s "
                  f"(min {min(ws):.4f}, max {max(ws):.4f}) [{card}]",
                  flush=True)
        S._manager._fns[(B, S_ROWS)] = variants["xla_unroll16"]
        res["traced_call"] = busy_share(art, out,
                                        os.path.join(td, "call_trace"))
        print(f"traced call: {json.dumps(res['traced_call'])} [{card}]",
              flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out",
                           "screen_kernel_bench.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
