#!/usr/bin/env python3
"""Roofline measurement for the production device kernels.

Measures per-call kernel time by iterating the kernel K times inside
one jitted fori_loop with genuinely varying inputs, timed to
block_until_ready, and reports achieved device-memory GB/s and GFLOP/s
against the card's published peaks (PEAKS, keyed by device_kind; an
unknown device is an error), per the bytes/FLOPs models documented in
docs/ROOFLINE.md.

Kernels:
  screen  — the (4096, 128) u8 top-S significance screen
            (ops/screen.py screen_body, XLA scan formulation)
  colcall — the [B, D] column-call step (ops/device_call.py)

Usage: python tools/roofline_bench.py [K]
Prints one JSON object.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

# published peaks per device_kind (NVIDIA H100 Tensor Core GPU data
# sheet; dense, without sparsity, at the full power limit): device
# memory GB/s and float32 TFLOP/s outside the tensor cores — both
# kernels here are elementwise f32 with no matrix product
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(mem_GBs=3350.0, f32_TFLOPs=67.0),
    "NVIDIA H100 PCIe": dict(mem_GBs=2000.0, f32_TFLOPs=51.0),
}


def peaks_for(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise SystemExit(f"no published peaks for device {device_kind!r}; "
                         "add it to PEAKS with its source") from None


def _per_call(jax, loop, args, K, reps):
    jax.block_until_ready(loop(*args))  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(*args))
        ts.append(time.perf_counter() - t0)
    wall = float(np.median(ts))
    return wall, wall / K


def measure_screen(jax, jnp, K, peaks):
    from functools import partial

    from lofreq_tpu.ops.screen import KMAX, SCREEN_S, TOP_S, _build_screen_fn

    B, s = 4096, TOP_S
    rng = np.random.default_rng(0)
    codes0 = rng.integers(0, 255, (B, s)).astype(np.uint8)
    depths = np.full(B, s, np.int32)
    ks = rng.integers(1, 5, B).astype(np.int32)
    lt = np.full(B, -30.0, np.float32)
    # vary the input per iteration so XLA can't hoist the body out of
    # the loop; one u8 xor per element is noise vs the DP itself
    salt = rng.integers(0, 7, K).astype(np.uint8)

    fn = _build_screen_fn(mesh=None)

    def once(codes):
        return fn(codes, jnp.asarray(depths), jnp.asarray(ks),
                  jnp.asarray(lt), s=s)

    @jax.jit
    def loop(codes, salt):
        def body(i, acc):
            c = codes ^ salt[i]
            return acc + once(c).sum()
        return jax.lax.fori_loop(0, K, body, jnp.int32(0))

    wall, per_call = _per_call(
        jax, loop, (jnp.asarray(codes0), jnp.asarray(salt)), K, 5)
    # model (docs/ROOFLINE.md): bytes/col = codes in (s) + decoded f32
    # materialize+read (2*4s) + depth/ks/thresh (12) + mask out (1);
    # flops/col = s steps x (KMAX+1) cells x 6 ops
    bytes_col = s + 8 * s + 12 + 1
    flops_col = s * (KMAX + 1) * 6
    return dict(
        kernel="screen", shape=[B, s], per_call_s=per_call,
        cols_per_s=B / per_call,
        model_bytes_per_col=bytes_col, model_flops_per_col=flops_col,
        achieved_GBs=B * bytes_col / per_call / 1e9,
        achieved_GFLOPs=B * flops_col / per_call / 1e9,
        mem_frac=B * bytes_col / per_call / 1e9 / peaks["mem_GBs"],
        f32_frac=B * flops_col / per_call / 1e9 / (peaks["f32_TFLOPs"]
                                                    * 1e3),
        loop_wall_s=wall, iters=K,
    )


def measure_colcall(jax, jnp, K, peaks):
    from __graft_entry__ import _example_batch
    from lofreq_tpu.ops.device_call import build_column_call

    B, Dd = 16384, 2016
    nt4, bq, baq, mq, sq, valid, ref_nt4, bonf = _example_batch(B, Dd)
    fn = build_column_call()
    args0 = [jnp.asarray(a) for a in
             (nt4, bq, baq, mq, sq, valid, ref_nt4, bonf)]
    salt = jnp.asarray(np.random.default_rng(1).integers(
        0, 3, K).astype(np.int16))

    @jax.jit
    def loop(nt4, bq, baq, mq, sq, valid, ref_nt4, bonf, salt):
        def body(i, acc):
            out = fn(nt4, (bq + salt[i]).astype(bq.dtype), baq, mq, sq,
                     valid, ref_nt4, bonf)
            leaves = jax.tree_util.tree_leaves(out)
            return acc + sum(jnp.sum(l.astype(jnp.float32)) for l in leaves)
        return jax.lax.fori_loop(0, K, body, jnp.float32(0))

    wall, per_call = _per_call(jax, loop, (*args0, salt), K, 3)
    # bytes/col: nt4 1 + bq/baq/mq/sq 2 each + valid 1 per read-slot,
    # read >= once -> 10*D; outputs are per-column scalars (negligible)
    bytes_col = 10 * Dd
    # flops/col: merge ~12 ops + filters/counts ~10 ops per slot, DP
    # 17 cells x 6 ops per slot
    flops_col = Dd * (22 + 17 * 6)
    return dict(
        kernel="colcall", shape=[B, Dd], per_call_s=per_call,
        cols_per_s=B / per_call,
        model_bytes_per_col=bytes_col, model_flops_per_col=flops_col,
        achieved_GBs=B * bytes_col / per_call / 1e9,
        achieved_GFLOPs=B * flops_col / per_call / 1e9,
        mem_frac=B * bytes_col / per_call / 1e9 / peaks["mem_GBs"],
        f32_frac=B * flops_col / per_call / 1e9 / (peaks["f32_TFLOPs"]
                                                    * 1e3),
        loop_wall_s=wall, iters=K,
    )


def main():
    K = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    peaks = peaks_for(dev.device_kind)
    out = dict(platform=dev.platform, device_kind=dev.device_kind,
               count=len(jax.devices()), peaks=peaks)
    out["screen"] = measure_screen(jax, jnp, K, peaks)
    out["colcall"] = measure_colcall(jax, jnp, max(K // 5, 3), peaks)
    print(json.dumps(out))
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
