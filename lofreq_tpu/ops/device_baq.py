"""Production device-BAQ runner: batches eligible reads through the JAX
banded glocal HMM (ops/baq_jax.py) and extracts final BAQ values in-kernel.

This is the device engine for the call pipeline's read rescoring
(--device-baq): f32 device posteriors are *approximate* (within a few
phred of the exact C kernel, csrc/baq.c); the caller treats them as a
screening signal only — candidate columns are re-scored with the exact C
BAQ before any variant is emitted (call/caller.py:confirm_snv_candidates),
so the final VCF is identical to the all-exact path.  See
kprobaln_ext.c:80 / bam_md_ext.c:260 for the original kernels this
re-architects.

Host<->device traffic is kept small: reads ship as int8/uint8, the
reference window ships once per ingest window and is gathered on device,
and the BAQ extraction (MAP-state diagonal check + ext smoothing) runs
in-kernel so only the final uint8 BAQ matrix returns.

A compile that fails raises: the user asked for this engine, so it never
turns itself off without a word.
"""

from __future__ import annotations

import numpy as np

TILE_B = 32768  # reads per device batch
TILE_B_CPU = 1024  # CPU backend (tests): keep per-batch work small
BW = 7          # band width: matches realn_one's M-only window (baq.c:422)
# reference-window compile size: FIXED so the kernel compiles once per
# read length (the call pipeline's ingest windows are 100 kb; reads that
# span a wider range are chunked into segments rebased to their own
# window).  The shape must not depend on the data, or every new window
# width would be a fresh compile.
W_PAD = 131072


def _tile_b() -> int:
    import jax

    return TILE_B_CPU if jax.default_backend() == "cpu" else TILE_B


def _build_step(L: int, Lr_pad: int, W_pad: int, tile: int, ext: bool):
    """Fused jitted step: window gather + glocal fwd/bwd + MAP + extract.

    Inputs (device): refwin u8 [W_pad] (codes, 4=N), q2p f32 [256],
    query i8 [tile, L], qual u8 [tile, L], xbrel i32 [tile] (xb - window
    base), l_ref i32 [tile], diag0 i32 [tile] (pos - xb).
    Returns final BAQ u8 [tile, L] (0..93, ext-smoothed when ext)."""
    from . import ensure_jax_cache

    ensure_jax_cache()
    import jax
    import jax.numpy as jnp

    from .baq_jax import _build

    run = _build(L, Lr_pad, BW)

    @jax.jit
    def step(refwin, q2p, query, qual, xbrel, l_ref, diag0):
        lane = jnp.arange(Lr_pad, dtype=jnp.int32)
        gidx = xbrel[:, None] + lane[None, :]
        refw = jnp.take(refwin, jnp.clip(gidx, 0, W_pad - 1)).astype(
            jnp.int32)
        refw = jnp.where(lane[None, :] < l_ref[:, None], refw, 4)
        qualp = jnp.take(q2p, qual.astype(jnp.int32))
        q, st, _a, _b, _c = run(refw, query.astype(jnp.int32), qualp, l_ref)
        if ext:
            diag = diag0[:, None] + jnp.arange(L, dtype=jnp.int32)[None, :]
            ok = ((st & 3) == 0) & ((st >> 2) == diag)
            bq = jnp.where(ok, q, 0)
            left = jax.lax.cummax(bq, axis=1)
            right = jax.lax.cummax(bq[:, ::-1], axis=1)[:, ::-1]
            bq = jnp.minimum(left, right)
        else:
            # non-ext: raw posterior, no state masking — the reference's
            # compiled build dead-codes the zeroing (bam_md_ext.c:417-421)
            bq = q
        return jnp.minimum(bq, 93).astype(jnp.uint8)

    return step


_RUNNERS: dict = {}


def get_runner(ext_baq: bool = True) -> "DeviceBaqRunner":
    """Process-wide runner cache: compiled step kernels survive across
    run_call invocations (a fresh runner per call would recompile every
    run)."""
    r = _RUNNERS.get(ext_baq)
    if r is None:
        r = _RUNNERS[ext_baq] = DeviceBaqRunner(ext_baq=ext_baq)
    return r


class DeviceBaqRunner:
    """Compiles per-(L, Lr, W) BAQ step kernels.  Use get_runner() —
    per-process caching matters (see above); the pipeline's single
    prefetch worker drives it."""

    def __init__(self, ext_baq: bool = True):
        self.ext_baq = ext_baq
        self._fns = {}
        self._tile = None
        self._q2p_dev = None

    def _get_fn(self, L: int, Lr_pad: int, W_pad: int):
        key = (L, Lr_pad, W_pad)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = _build_step(L, Lr_pad, W_pad, self._tile,
                                              self.ext_baq)
        return fn

    def run(self, ref: bytes, codes, quals, pos, xb, xe):
        """codes/quals [N, L] uint8, pos/xb/xe [N] int64 (from
        lfq_extract_reads).  Returns final BAQ [N, L] uint8 (0..93), or
        None when the reads span more than one window can hold (the C
        kernel then covers the window)."""
        import jax.numpy as jnp

        from .baq_jax import _Q2P

        N, L = codes.shape
        if self._tile is None:
            self._tile = _tile_b()
        tile = self._tile
        Lr = int((xe - xb).max())
        Lr_pad = -(-max(Lr, 1) // 128) * 128
        base = int(xb.min())
        wlen = int(xe.max()) - base
        if wlen > W_PAD:
            # reads span more than one ref-window compile size: split by
            # position (xb ascending from the extract order) and recurse,
            # each segment rebased to its own fixed-size window
            cut = np.searchsorted(xb, base + W_PAD - Lr, side="left")
            if cut == 0 or cut >= N:
                return None
            a = self.run(ref, codes[:cut], quals[:cut], pos[:cut],
                         xb[:cut], xe[:cut])
            b = self.run(ref, codes[cut:], quals[cut:], pos[cut:],
                         xb[cut:], xe[cut:])
            if a is None or b is None:
                return None
            return np.concatenate([a, b])
        fn = self._get_fn(L, Lr_pad, W_PAD)
        if self._q2p_dev is None:
            self._q2p_dev = jnp.asarray(_Q2P)
        # per-window reference slice, shipped once for all batches
        from .baq_jax import _BASECODE

        refwin = np.full(W_PAD, 4, np.uint8)
        hi = min(base + W_PAD, len(ref))
        refwin[: hi - base] = _BASECODE[
            np.frombuffer(ref, np.uint8)[base:hi]]
        refwin_dev = jnp.asarray(refwin)

        xbrel = (xb - base).astype(np.int32)
        diag0 = (pos - xb).astype(np.int32)
        l_ref = (xe - xb).astype(np.int32)
        codes_i8 = codes.astype(np.int8)
        out = np.empty((N, L), np.uint8)
        # enqueue every batch before fetching any result: transfers and
        # compute overlap across batches
        pending = []
        for lo in range(0, N, tile):
            hi2 = min(lo + tile, N)
            n = hi2 - lo
            q8 = codes_i8[lo:hi2]
            qu = quals[lo:hi2]
            xr = xbrel[lo:hi2]
            lr = l_ref[lo:hi2]
            d0 = diag0[lo:hi2]
            if n < tile:  # pad the tail batch to the compiled shape
                pad = tile - n
                q8 = np.concatenate([q8, np.repeat(q8[:1], pad, 0)])
                qu = np.concatenate([qu, np.repeat(qu[:1], pad, 0)])
                xr = np.concatenate([xr, np.repeat(xr[:1], pad)])
                lr = np.concatenate([lr, np.repeat(lr[:1], pad)])
                d0 = np.concatenate([d0, np.repeat(d0[:1], pad)])
            res = fn(refwin_dev, self._q2p_dev, jnp.asarray(q8),
                     jnp.asarray(qu), jnp.asarray(xr), jnp.asarray(lr),
                     jnp.asarray(d0))
            pending.append((lo, hi2, n, res))
        for lo, hi2, n, res in pending:
            out[lo:hi2] = np.asarray(res)[:n]
        return out
