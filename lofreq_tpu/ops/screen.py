"""Device (JAX) significance screening for the Poisson-binomial test.

The reference prunes per column with a data-dependent early exit
(snpcaller.c:950): with ascending-sorted error probs, the running tail
P(X >= K) only grows, so once the partial tail exceeds sig/bonf the column
is insignificant.  On the device we make this compiler-friendly: a
fixed-length linear-space f32 DP over the (bucket-padded) sorted probs
yields a lower bound of the tail; columns whose bound already exceeds
(sig * MARGIN) / bonf can never be called and are screened out.
Everything else is confirmed by the exact native DP.

The screen is conservative by construction (lower bound + f32 margin), so
final output is identical to running the exact DP everywhere.
"""

from __future__ import annotations

import logging
import os
from functools import partial

import numpy as np

SCREEN_S = 32  # DP prefix length
# max probs shipped/scanned per column: deep columns are screened from
# their top-S largest err probs (subset tail = lower bound of full tail)
TOP_S = 128
KMAX = 16  # clipped tail cell (tail at smaller k bounds tail at k)
MARGIN = 1e3  # screening slack for f32 drift + running-bonf growth
# scan unroll: over TOP_S = 128 rows, 16 gives an 8-trip device loop
SCAN_UNROLL = 16
NEG = -1e30

log = logging.getLogger("lofreq_tpu")


def _get_jax():
    from . import ensure_jax_cache

    ensure_jax_cache()
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _local_mesh():
    """Mesh over all local devices ('cols' axis), or None single-device.

    Production multi-chip: the screen's column batches are data-parallel
    over every local device (SURVEY §2.3 'per-chip batches of pileup
    columns'); bucketed batch sizes are powers of two >= 256, so they
    divide any power-of-two device count."""
    jax, _ = _get_jax()
    devs = jax.devices()
    n = len(devs)
    if n <= 1:
        return None
    # largest power of two <= n: keeps bucketed batches divisible
    p = 1
    while p * 2 <= n:
        p *= 2
    from jax.sharding import Mesh

    return Mesh(np.array(devs[:p]), ("cols",))


def _build_screen_fn(mesh=None):
    jax, jnp = _get_jax()

    def screen_body(codes, depths, ks, log_thresh, s=SCREEN_S,
                    kmax=KMAX):
        """codes [B, s] u8 log-quantized err probs (255 = padding/zero);
        depths [B]; ks [B] (>=1); log_thresh [B] = log(sig*MARGIN/bonf).
        Returns candidate mask [B] (True = needs exact confirmation).

        Linear f32 space: each step is pure multiply-add; a p=0 read
        multiplies every cell by (1-p)=1, so padding and rows beyond a
        column's depth map to an exact identity (masked to 0 up front).
        Underflow only shrinks the partial tail, which only adds
        candidates — the safe, conservative direction."""
        B = codes.shape[0]
        kc = jnp.minimum(ks, kmax)
        cell = jnp.arange(kmax + 1)[None, :]
        is_tail = (cell == kc[:, None]).astype(jnp.float32)
        not_beyond = (cell <= kc[:, None]).astype(jnp.float32)
        state0 = jnp.where(cell == 0, 1.0, 0.0).astype(jnp.float32)
        state0 = jnp.broadcast_to(state0, (B, kmax + 1))
        in_depth = jnp.arange(s)[None, :] < depths[:, None]
        # u8 code c decodes to 2^(-c/8) (255 = 0.0, the DP identity).  The
        # host encodes with ceil(), so decode <= p: smaller probs shrink
        # the tail lower bound, which only ADDS candidates.  The decode is
        # arithmetic (exp2), so it stays elementwise instead of becoming
        # a 256-entry table gather; f32 exp2 rounds within ~1 ulp of the
        # f64 value, which MARGIN absorbs.  Shipping u8 instead of
        # f32 cuts the per-column transfer 4x.
        cf = codes.astype(jnp.float32)
        probs = jnp.where(codes == 255, 0.0, jnp.exp2(-cf / 8.0))
        p_all = jnp.where(in_depth, probs, 0.0)
        # tie the scan carry to a batch-varying input so shard_map's
        # varying-axis tracking accepts it (same trick as
        # device_call.py's column step)
        state0 = state0 + 0.0 * p_all[:, :1]

        def step(state, p):
            shifted = jnp.concatenate(
                [state[:, :1] * 0.0, state[:, :-1]], axis=1)
            adv = shifted * p[:, None]
            std = state * (1.0 - p)[:, None] + adv
            tail = state + adv
            new = (is_tail * tail + (1.0 - is_tail) * std) * not_beyond
            return new, None

        state, _ = jax.lax.scan(step, state0, p_all.T, unroll=SCAN_UNROLL)
        lin_tail = jnp.take_along_axis(state, kc[:, None], axis=1)[:, 0]
        tail_val = jnp.log(jnp.maximum(lin_tail, jnp.float32(1e-37)))
        # candidate if the lower bound is below the (slackened) threshold;
        # K beyond the clipped tail cell can't be ruled out (clipped tail
        # is an upper bound there)
        return (tail_val < log_thresh) | (ks > kmax)

    if mesh is None:
        return partial(jax.jit, static_argnames=("s", "kmax"))(screen_body)

    # multi-device: columns data-parallel over the mesh via shard_map
    # (each shard runs the single-device program on its B/n slice; the
    # mask is per-column, so there is no cross-device communication)
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def build(s=SCREEN_S, kmax=KMAX):
        body = partial(screen_body, s=s, kmax=kmax)
        sm = shard_map(body, mesh=mesh,
                       in_specs=(P("cols"), P("cols"), P("cols"),
                                 P("cols")),
                       out_specs=P("cols"))
        return jax.jit(sm)

    cache = {}

    def screen_sharded(codes, depths, ks, log_thresh, s=SCREEN_S,
                       kmax=KMAX):
        fn = cache.get((s, kmax))
        if fn is None:
            fn = cache[(s, kmax)] = build(s, kmax)
        return fn(codes, depths, ks, log_thresh)

    return screen_sharded


def _bucket(n: int) -> int:
    """Round depth up to a power of two (bounds jit recompiles)."""
    b = 32
    while b < n:
        b *= 2
    return b


def _bucket_b(n: int) -> int:
    """Round batch up to a power of two >= 256 (bounds jit recompiles;
    production chunks are a fixed 4096 so steady state is one shape)."""
    b = 256
    while b < n:
        b *= 2
    return b


def device_screen_default() -> bool:
    """The engine, decided in this process from JAX's default backend.

    On a GPU the device screen runs.  On a CPU-only host the host engine
    runs the same clipped-K DP in numpy f64 (host_screen_tail), which is
    a legitimate engine for CPU users and gives the same VCF; the choice
    is logged once.  No other process is started to decide: a second
    JAX process would reserve the card's memory."""
    global _SCREEN_DEFAULT
    if _SCREEN_DEFAULT is None:
        jax, _ = _get_jax()
        backend = jax.default_backend()
        _SCREEN_DEFAULT = backend == "gpu"
        if not _SCREEN_DEFAULT:
            log.info("device screen off: the JAX backend is %s; the host "
                     "engine screens the columns", backend)
    return _SCREEN_DEFAULT


_SCREEN_DEFAULT = None


class _ScreenManager:
    """Compiles the screen once per (B, s) bucket.

    A fresh compile gets FIRST_WAIT_S; one still running after that is
    kept, the host engine covers those columns for now, and every later
    get() polls it and adopts it the moment it lands (column batches are
    independent, so late adoption changes no output).  At most one
    compile is in flight.  A compile that fails, or that is still running
    after HARD_ABANDON_S, raises: a broken screen is a fault, not an
    engine choice, and the run must not go on without saying so."""

    FIRST_WAIT_S = 10.0
    HARD_ABANDON_S = 900.0

    def __init__(self):
        import threading

        self._fns = {}  # (B, s) -> jitted fn
        self._inflight = None  # (key, future, t0)
        self._lock = threading.Lock()

    def _submit(self, key):
        """Start compiling `key` on a worker thread (no wait)."""
        import time
        from concurrent.futures import ThreadPoolExecutor

        B, s = key
        _jax, jnp = _get_jax()
        fn = _build_screen_fn(mesh=_local_mesh())

        def _warm():
            # dtypes MUST match screen_dispatch's real call exactly: a
            # signature mismatch would retrace on the dispatch path
            codes = jnp.full((B, s), 255, jnp.uint8)
            depths = jnp.zeros(B, jnp.int32)
            ks = jnp.ones(B, jnp.int32)
            lt = jnp.zeros(B, jnp.float32)
            np.asarray(fn(codes, depths, ks, lt, s=s))
            return fn

        ex = ThreadPoolExecutor(1)
        fut = ex.submit(_warm)
        ex.shutdown(wait=False)
        self._inflight = (key, fut, time.time())
        return fut

    def get(self, B: int, s: int, wait_s: float = None):
        """Compiled screen fn for (B, s), or None while its compile is
        still running (the host engine covers those columns).

        wait_s: block up to this long for the compile (warm-up callers
        pass a generous budget so timed runs start with a live screen);
        None = FIRST_WAIT_S for a fresh submit, a non-blocking poll for
        an in-flight one.  The lock guards only state transitions; the
        wait happens outside it, so a concurrent dispatcher polling get()
        falls straight through to the host engine."""
        import time
        from concurrent.futures import wait

        with self._lock:
            fn = self._fns.get((B, s))
            if fn is not None:
                return fn
            fresh = self._inflight is None
            if fresh:
                self._submit((B, s))
            key, fut, t0 = self._inflight
        budget = wait_s if wait_s else (self.FIRST_WAIT_S if fresh else 0.0)
        if budget and not wait([fut], timeout=budget).done and fresh:
            log.warning("device screen: compile for shape %s still running "
                        "after %.0fs; the host engine covers its columns "
                        "until it lands", key, budget)
        with self._lock:
            if self._inflight is not None and self._inflight[1] is fut:
                if fut.done():
                    self._inflight = None
                    self._fns[key] = fut.result()  # a failure raises here
                elif time.time() - t0 > self.HARD_ABANDON_S:
                    self._inflight = None
                    raise TimeoutError(
                        f"device screen: compile for shape {key} still "
                        f"running after {self.HARD_ABANDON_S:.0f}s")
            return self._fns.get((B, s))


_manager = _ScreenManager()

# real dispatch accounting: "did the device screen actually run during
# this process" — the stage timer can't tell (the stage wraps the call
# even when it returns None instantly).  bench.py reports these.
DISPATCH_STATS = {"dispatched": 0, "unavailable": 0}


def screen_ready(B: int = 4096, s: int = None, wait_s: float = None) -> bool:
    """True when the production screen shape is compiled and live (the
    manager compiles it on first ask; a failed compile raises).

    wait_s: warm-up callers (bench, chip_smoke) pass a generous blocking
    budget so their timed runs start with a live screen; otherwise a
    compile that outlasts the first wait just means the first windows
    run the host engine (late adoption)."""
    jax, _ = _get_jax()

    if s is None:
        s = TOP_S
    if jax.default_backend() == "cpu":
        B = _bucket_b(min(B, 1024))
        s = min(s, TOP_S)
    return _manager.get(B, s, wait_s=wait_s) is not None


def screen_dispatch(probs, depths, ks, bonf, sig):
    """Pack + quantize + ISSUE the device screen for one chunk; returns
    an opaque handle for screen_fetch, or None (screen unavailable —
    treat every column as candidate).

    JAX dispatch is asynchronous: the returned mask is a device array
    whose transfer/compute overlaps whatever the host does next — the
    call pipeline issues chunk N+1's screen before fetching chunk N's
    (call_snvs_batch), so device latency hides behind the exact DP.

    Deep columns are screened from their TOP-S largest err probs only:
    the Poisson-binomial tail over ANY subset of a column's reads is a
    lower bound of the full tail, so a subset bound that already exceeds
    the threshold proves insignificance — and the largest probs carry
    virtually all of the tail mass, so the bound stays sharp.  This keeps
    the host->device transfer at S u8 codes per column regardless of
    depth; the codes are log-quantized with conservative rounding (see
    _build_screen_fn).  B and S are padded to buckets so jit compiles
    are bounded; while the bucket's compile is still running this
    returns None and the caller runs the host engine."""
    _jax, jnp = _get_jax()
    B, D = probs.shape
    s = min(_bucket(D), TOP_S)
    Bp = _bucket_b(B)
    if _jax.default_backend() != "cpu":
        # one compile shape total on an accelerator: each new shape is
        # a compile, padding costs microseconds (top-S rows are 128 B)
        s = TOP_S
        Bp = max(Bp, 4096)
    fn = _manager.get(Bp, s)
    if fn is None:
        DISPATCH_STATS["unavailable"] += 1
        return None
    DISPATCH_STATS["dispatched"] += 1
    prefix = np.full((Bp, s), 2.0, dtype=np.float64)
    depths_p = np.zeros(Bp, dtype=np.int32)
    if D > s:
        # top-S per row; padding/invalid (>1.0) mapped to 0.0 first (an
        # exact DP identity) so it can never crowd out real probs.  The
        # selected row order is arbitrary, so every slot is "in depth"
        # (zeros are identities).
        in_depth = np.arange(D)[None, :] < np.asarray(depths)[:, None]
        arr = np.where((probs <= 1.0) & in_depth, probs, 0.0)
        prefix[:B] = np.partition(arr, D - s, axis=1)[:, D - s:]
        depths_p[:B] = s
    else:
        prefix[:B, :D] = probs
        depths_p[:B] = depths
    # u8 log-quantization (see _build_screen_fn): ceil rounds the code up
    # so its decode is <= p — the conservative direction; p<=0, the 2.0
    # padding AND probs below the smallest representable code (clipping
    # them up to code 254 would OVERstate them) all map to the identity
    # code 255 (= 0.0, which only understates)
    with np.errstate(divide="ignore", invalid="ignore"):
        lg = np.ceil(-np.log2(np.maximum(prefix, 1e-300)) * 8.0)
    codes = np.where((prefix <= 0.0) | (prefix > 1.0) | (lg > 254), 255,
                     np.clip(lg, 0, 254)).astype(np.uint8)
    ks_p = np.ones(Bp, dtype=np.int32)
    ks_p[:B] = np.maximum(np.asarray(ks, dtype=np.int32), 1)
    bonf = np.broadcast_to(np.asarray(bonf, dtype=np.float64), (B,))
    log_thresh = np.full(Bp, np.float32(np.log(sig * MARGIN)))
    log_thresh[:B] = np.log(sig * MARGIN / bonf).astype(np.float32)
    mask = fn(
        jnp.asarray(codes), jnp.asarray(depths_p), jnp.asarray(ks_p),
        jnp.asarray(log_thresh), s=s,
    )
    return (mask, B)


def screen_fetch(handle) -> np.ndarray:
    """Blocking fetch of a screen_dispatch handle's candidate mask."""
    mask, B = handle
    return np.asarray(mask)[:B]


def host_screen_tail(probs, depths, ks, bonf, sig) -> np.ndarray:
    """Host (numpy f64) mirror of the device screen's clipped-K partial
    tail DP: True = candidate (needs the exact DP).  Same semantics as
    screen_body — top-S largest err probs per row (subset tail = lower
    bound of the full tail), K clipped to KMAX (a clipped tail can rule
    nothing out beyond it), same MARGIN slack — minus the u8
    quantization (f64 here, and no link to cross).

    This is the host engine: on a CPU-only host, in call-parallel
    workers, and while the device compile is still in flight.  Without it,
    every top-k-prescreen survivor lands on the exact confirm pass
    (measured 10x confirm blow-up on a dark-screen bench run).  It only
    ever sees prescreen survivors, so B is small."""
    probs = np.asarray(probs, dtype=np.float64)
    B, D = probs.shape
    if B == 0:
        return np.ones(0, dtype=bool)
    ks = np.asarray(ks, dtype=np.int64)
    kc = np.minimum(np.maximum(ks, 1), KMAX)
    in_depth = np.arange(D)[None, :] < np.asarray(depths)[:, None]
    arr = np.where((probs <= 1.0) & in_depth, probs, 0.0)
    s = min(D, TOP_S)
    if D > s:
        arr = np.partition(arr, D - s, axis=1)[:, D - s:]
    cell = np.arange(KMAX + 1)[None, :]
    is_tail = cell == kc[:, None]
    not_beyond = cell <= kc[:, None]
    state = np.zeros((B, KMAX + 1))
    state[:, 0] = 1.0
    for j in range(arr.shape[1]):
        p = arr[:, j][:, None]
        shifted = np.concatenate([np.zeros((B, 1)), state[:, :-1]], axis=1)
        adv = shifted * p
        tail = state + adv
        state = np.where(is_tail, tail, state * (1.0 - p) + adv)
        state *= not_beyond
    lin_tail = state[np.arange(B), kc]
    thresh = np.float64(sig) * MARGIN / np.asarray(bonf, dtype=np.float64)
    return (lin_tail < thresh) | (ks > KMAX)


def screen_candidates(probs, depths, ks, bonf, sig) -> np.ndarray:
    """Synchronous wrapper: dispatch + fetch in one call."""
    handle = screen_dispatch(probs, depths, ks, bonf, sig)
    if handle is None:
        return np.ones(probs.shape[0], dtype=bool)
    return screen_fetch(handle)


# -- code-native screening (csrc/screen_pack.c) -------------------------
#
# The fused sweep's CSR f32 probs are quantized/top-S-selected in C —
# per column, sorted ascending, 255-padded — so the whole screening
# front-end (prescreen bound + device/host sub-screen) runs on u8 codes
# with no per-chunk numpy partition/quantize pass at all.

LN2_8 = float(np.log(2.0)) / 8.0


def screen_codes_for(flat_probs, starts, cols) -> np.ndarray | None:
    """[len(cols), TOP_S] u8 top-S codes via the native kernel, or None
    when the native lib is unavailable (callers use the prob path).

    flat_probs may be f32 probs (quantize + counting select) or a
    pre-quantized u8 code CSR straight from the fused sweep
    (screen_flat==2 — pure counting select, the cheapest path)."""
    import ctypes

    if flat_probs.dtype not in (np.float32, np.uint8):
        return None
    try:
        from .._native_build import get_native_lib

        lib = get_native_lib()
    except Exception:
        return None
    n = len(cols)
    out = np.empty((n, TOP_S), np.uint8)
    if n == 0:
        return out
    flat = np.ascontiguousarray(flat_probs)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    nthreads = int(os.environ.get("LOFREQ_NATIVE_THREADS",
                                  min(4, os.cpu_count() or 1)))
    i64p = ctypes.POINTER(ctypes.c_int64)
    if flat.dtype == np.uint8:
        lib.lfq_screen_codes_u8(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            starts.ctypes.data_as(i64p), cols.ctypes.data_as(i64p),
            ctypes.c_int64(n), ctypes.c_int32(TOP_S),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int32(nthreads))
    else:
        lib.lfq_screen_codes(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            starts.ctypes.data_as(i64p), cols.ctypes.data_as(i64p),
            ctypes.c_int64(n), ctypes.c_int32(TOP_S),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int32(nthreads))
    return out


def prescreen_codes(codes, ks, bonf, sig,
                    topk_max: int = 64) -> np.ndarray:
    """Top-k product lower bound straight from the codes: the product of
    the k largest decoded probs is exp(-(ln2/8) * sum of the k smallest
    codes) — an integer cumsum instead of a partition+log pass.  Decodes
    are <= the true probs, so the bound is a lower bound of the true
    top-k product, itself a lower bound of the Poisson-binomial tail:
    discarding on (bound * bonf > sig) is provably output-identical
    (same argument as caller._topk_prescreen; the 0.5 slack is kept for
    uniformity although the code sum is exact integer math).  Rows with
    ks outside [1, topk_max] or whose k-th code is padding (255 = a
    zero prob: the bound degenerates) are kept.  Returns keep mask."""
    B = codes.shape[0]
    if B == 0:
        return np.ones(0, bool)
    ks = np.asarray(ks, dtype=np.int64)
    kmax = int(min(max(int(ks.max(initial=1)), 1), topk_max))
    csum = np.cumsum(codes[:, :kmax].astype(np.int64), axis=1)
    k_idx = np.clip(np.minimum(ks, kmax) - 1, 0, kmax - 1)
    rows = np.arange(B)
    code_sum = csum[rows, k_idx]
    kth = codes[rows, k_idx]
    lb_log = -LN2_8 * code_sum.astype(np.float64)
    bounded = (ks >= 1) & (ks <= topk_max) & (kth < 255)
    with np.errstate(divide="ignore"):
        discard = bounded & (
            lb_log + np.log(np.asarray(bonf, dtype=np.float64))
            + np.log(0.5) > np.log(np.float64(sig)))
    return ~discard


def screen_dispatch_codes(codes, ks, bonf, sig):
    """screen_dispatch for pre-quantized top-S codes: no partition, no
    quantize — pad to the production (Bp, TOP_S) bucket and issue.  The
    255 padding decodes to 0.0 (a DP identity), so depths are simply S
    for every row.  Returns an opaque handle for screen_fetch, or None
    (screen unavailable)."""
    _jax, jnp = _get_jax()
    B, s0 = codes.shape
    s = TOP_S
    Bp = _bucket_b(B)
    if _jax.default_backend() != "cpu":
        Bp = max(Bp, 4096)
    fn = _manager.get(Bp, s)
    if fn is None:
        DISPATCH_STATS["unavailable"] += 1
        return None
    DISPATCH_STATS["dispatched"] += 1
    codes_p = np.full((Bp, s), 255, dtype=np.uint8)
    codes_p[:B, :s0] = codes
    depths_p = np.full(Bp, s, dtype=np.int32)
    ks_p = np.ones(Bp, dtype=np.int32)
    ks_p[:B] = np.maximum(np.asarray(ks, dtype=np.int32), 1)
    bonf = np.broadcast_to(np.asarray(bonf, dtype=np.float64), (B,))
    log_thresh = np.full(Bp, np.float32(np.log(sig * MARGIN)))
    log_thresh[:B] = np.log(sig * MARGIN / bonf).astype(np.float32)
    mask = fn(
        jnp.asarray(codes_p), jnp.asarray(depths_p), jnp.asarray(ks_p),
        jnp.asarray(log_thresh), s=s,
    )
    return (mask, B)


def host_screen_tail_codes(codes, ks, bonf, sig) -> np.ndarray:
    """Host engine of the code sub-screen: the same clipped-K partial
    tail DP as host_screen_tail, over the decoded codes (f64)."""
    dec = np.zeros(256)
    dec[:255] = np.exp2(-np.arange(255, dtype=np.float64) / 8.0)
    return host_screen_tail(dec[codes], np.full(codes.shape[0],
                                                codes.shape[1]),
                            ks, bonf, sig)
