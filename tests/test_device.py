"""Device pipeline tests: screen consistency vs exact path, sharding
equivalence, graft entry points."""

import numpy as np

import __graft_entry__ as ge
from lofreq_tpu.core.poissbin import snpcaller_batch
from lofreq_tpu.core.quals import merge_srcq_mapq_baq_and_bq
from lofreq_tpu.ops.device_call import build_column_call
from lofreq_tpu.ops.screen import screen_candidates


def test_screen_is_conservative():
    """Every column the exact DP finds significant must survive screening."""
    rng = np.random.default_rng(3)
    B, D = 200, 400
    probs = np.sort(10 ** (-rng.uniform(1.0, 4.5, (B, D))), axis=1)
    depths = rng.integers(50, D + 1, B)
    ks = rng.integers(1, 9, B)
    bonf = np.full(B, 30000.0)
    sig = 0.01
    cand = screen_candidates(probs, depths, ks, bonf, sig)
    counts = np.zeros((B, 3), dtype=np.int64)
    counts[:, 0] = ks
    pv = snpcaller_batch(probs, depths, counts, bonf, sig)
    sig_mask = (pv[:, 0] * bonf) < sig
    # all significant columns are candidates
    assert not np.any(sig_mask & ~cand)
    # screening removes a decent share of insignificant columns
    assert cand.sum() < B


def test_device_counts_match_host():
    """Device alt counts / depths agree with the host errprob path."""
    import jax

    rng = np.random.default_rng(5)
    B, D = 32, 128
    ref_nt4 = rng.integers(0, 4, B).astype(np.int8)
    nt4 = np.where(rng.random((B, D)) < 0.99, ref_nt4[:, None],
                   rng.integers(0, 4, (B, D))).astype(np.int8)
    bq = rng.integers(2, 41, (B, D)).astype(np.int16)
    mq = np.full((B, D), 60, np.int16)
    baq = np.full((B, D), -1, np.int16)
    sq = np.full((B, D), -1, np.int16)
    valid = rng.random((B, D)) < 0.9
    fn = jax.jit(build_column_call(use_baq=False))
    out = fn(nt4, bq, baq, mq, sq, valid, ref_nt4,
             np.full(B, 3.0, np.float32))
    # host recomputation
    for c in range(B):
        v = valid[c] & (nt4[c] != 4)
        is_alt = v & (nt4[c] != ref_nt4[c])
        keep = v & (bq[c] >= 6)
        assert int(out["depths"][c]) == int(keep.sum())
        for i, b in enumerate([x for x in range(4) if x != ref_nt4[c]]):
            assert int(out["alt_nt"][c, i]) == b
            assert int(out["alt_counts"][c, i]) == int(
                (keep & (nt4[c] == b)).sum())
            assert int(out["alt_raw"][c, i]) == int((is_alt & (nt4[c] == b)).sum())


def test_merge_quals_device_close_to_host():
    rng = np.random.default_rng(1)
    n = 1000
    bq = rng.integers(2, 60, n)
    mq = rng.integers(0, 61, n)
    baq = rng.integers(-1, 60, n)
    sq = np.full(n, -1)
    host = merge_srcq_mapq_baq_and_bq(sq, mq, baq, bq)
    import jax.numpy as jnp

    from lofreq_tpu.ops.device_call import merge_quals_f32

    dev = np.asarray(merge_quals_f32(jnp, jnp.asarray(sq), jnp.asarray(mq),
                                     jnp.asarray(baq), jnp.asarray(bq)))
    np.testing.assert_allclose(dev, host, rtol=2e-6)


def test_graft_entry_single():
    import jax

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out["alt_counts"].shape[0] == args[0].shape[0]


def test_graft_dryrun_multichip():
    import jax

    n = min(8, len(jax.devices()))
    ge.dryrun_multichip(n)


def test_device_screen_conservative_vs_exact():
    """Linear-space device screen must keep every column the exact host DP
    finds significant (planted variants -> non-trivial candidate set)."""
    import jax

    rng = np.random.default_rng(17)
    B, D = 256, 400
    ref_nt4 = rng.integers(0, 4, B).astype(np.int8)
    nt4 = np.repeat(ref_nt4[:, None], D, axis=1).astype(np.int8)
    bq = rng.integers(25, 41, (B, D)).astype(np.int16)
    valid = rng.random((B, D)) < 0.97
    # plant variants of varying strength in every 4th column
    planted = {}
    for c in range(0, B, 4):
        k = int(rng.integers(2, 12))
        alt = (ref_nt4[c] + 1) % 4
        idx = rng.choice(D, k, replace=False)
        nt4[c, idx] = alt
        bq[c, idx] = 35
        valid[c, idx] = True
        planted[c] = k
    # sprinkle background errors
    err = rng.random((B, D)) < 0.002
    for c, r in zip(*np.nonzero(err)):
        nt4[c, r] = rng.integers(0, 4)
    mq = np.full((B, D), 60, np.int16)
    baq = np.full((B, D), -1, np.int16)
    sq = np.full((B, D), -1, np.int16)
    bonf = np.full(B, 3000.0, np.float32)

    fn = jax.jit(build_column_call(use_baq=False))
    out = fn(nt4, bq, baq, mq, sq, valid, ref_nt4, bonf)
    cand = np.asarray(out["candidate"])

    # exact host path on identical inputs
    sig = 0.01
    n_missed = 0
    n_sig = 0
    for c in range(B):
        keep = valid[c] & (bq[c] >= 6)
        probs = merge_srcq_mapq_baq_and_bq(
            sq[c][keep], mq[c][keep], baq[c][keep], bq[c][keep])
        probs = np.sort(probs)
        counts = np.zeros((1, 3), dtype=np.int64)
        for i, b in enumerate([x for x in range(4) if x != ref_nt4[c]]):
            counts[0, i] = int((keep & (nt4[c] == b)).sum())
        if counts.max() == 0:
            continue
        pv = snpcaller_batch(probs[None, :], np.array([keep.sum()]),
                             counts, np.array([3000.0]), sig)
        if (pv * 3000.0 < sig).any():
            n_sig += 1
            if not cand[c]:
                n_missed += 1
    assert n_sig > 20, f"test should plant detectable variants, got {n_sig}"
    assert n_missed == 0, f"screen dropped {n_missed} significant columns"
    # and it must still rule out a decent share of non-variant columns
    assert cand.sum() < B * 0.6


def test_screen_u8_quantization_conservative():
    """decode(encode(p)) <= p for the u8 log-quantized screen transfers:
    quantization may only shrink err probs (shrinking the tail lower
    bound only ADDS candidates).  Dense sweep incl. code boundaries,
    phred edges and subnormal-ish values."""
    dec = np.zeros(256)
    dec[:255] = np.exp2(-np.arange(255) / 8.0)
    ps = np.concatenate([
        np.exp2(-np.arange(255) / 8.0),              # exact boundaries
        np.exp2(-(np.arange(254) + 0.5) / 8.0),      # midpoints
        10.0 ** (-np.arange(1, 13, dtype=np.float64)),  # phred decades
        np.random.default_rng(0).uniform(1e-12, 1.0, 4096),
        np.array([1.0, 0.999999999, 1e-300, 5e-324]),
    ])
    with np.errstate(divide="ignore"):
        lg = np.ceil(-np.log2(np.maximum(ps, 1e-300)) * 8.0)
    codes = np.where((ps <= 0.0) | (lg > 254), 255,
                     np.clip(lg, 0, 254)).astype(np.uint8)
    decoded = dec[codes]
    # f64 table here; the device f32 table adds <=1ulp absorbed by MARGIN
    assert (decoded <= ps + 1e-16).all()
    # and the decode is within one quantization step (sharp enough)
    real = ps > 2 ** (-254 / 8.0)
    assert (decoded[real] >= ps[real] * 2 ** (-1 / 8.0) * (1 - 1e-12)).all()


# --- screen manager: late adoption of slow compiles ---------------------
# A compile that outlasts the first wait must mean "host engine for now",
# not "screen dark for the process": the manager keeps the in-flight
# future and adopts it when it lands.  A compile that fails raises.

def _fake_build(sleep_s, fail=False):
    def build(mesh=None):
        def fn(codes, depths, ks, lt, s=None):
            import time

            time.sleep(sleep_s)
            if fail:
                raise RuntimeError("boom")
            return np.ones(codes.shape[0], bool)

        return fn

    return build


def test_screen_manager_late_adoption(monkeypatch):
    import time

    from lofreq_tpu.ops import screen as S

    monkeypatch.setattr(S, "_build_screen_fn", _fake_build(2.0))
    m = S._ScreenManager()
    m.FIRST_WAIT_S = 0.3
    assert m.get(64, 32) is None          # 0.3s first wait < 2s compile
    assert m._inflight is not None        # still pending, not dropped
    fn = None
    for _ in range(100):                  # poll like screen_dispatch does
        fn = m.get(64, 32)
        if fn is not None:
            break
        time.sleep(0.1)
    assert fn is not None                 # adopted once the compile landed
    assert m._inflight is None


def test_screen_manager_wait_budget(monkeypatch):
    from lofreq_tpu.ops import screen as S

    monkeypatch.setattr(S, "_build_screen_fn", _fake_build(1.0))
    m = S._ScreenManager()
    m.FIRST_WAIT_S = 0.2
    # a warm-up caller's generous budget rides through the slow compile
    assert m.get(64, 32, wait_s=10.0) is not None


def test_screen_manager_failure_degrades(monkeypatch):
    """A failing compile raises on the caller (the run exits non-zero)
    instead of degrading to the host engine without a word."""
    import time

    import pytest

    from lofreq_tpu.ops import screen as S

    monkeypatch.setattr(S, "_build_screen_fn", _fake_build(0.0, fail=True))
    m = S._ScreenManager()
    t0 = time.time()
    with pytest.raises(RuntimeError, match="boom"):
        m.get(64, 32)
    assert time.time() - t0 < 30
    assert not m._fns


def test_screen_manager_hard_abandon(monkeypatch):
    import time

    import pytest

    from lofreq_tpu.ops import screen as S

    monkeypatch.setattr(S, "_build_screen_fn", _fake_build(30.0))
    m = S._ScreenManager()
    m.FIRST_WAIT_S = 0.2
    m.HARD_ABANDON_S = 0.5
    assert m.get(64, 32) is None          # pending
    time.sleep(0.6)
    with pytest.raises(TimeoutError):     # hung past the hard limit
        m.get(64, 32)


def test_host_screen_tail_conservative_vs_exact():
    """The host fallback sub-screen (numpy mirror of the device screen,
    ops/screen.py:host_screen_tail) must keep every packed column whose
    exact DP emission is significant, while discarding a real share of
    the rest.  Interface-level test on packed [B, D] matrices with 2.0
    padding, exactly as _screen_dispatch_sub hands them over."""
    from lofreq_tpu.core.poissbin import snpcaller_batch
    from lofreq_tpu.ops.screen import host_screen_tail

    rng = np.random.default_rng(23)
    B, D = 300, 500
    depths = rng.integers(40, D + 1, B)
    probs = np.full((B, D), 2.0)
    for c in range(B):
        d = depths[c]
        v = 10.0 ** (-rng.uniform(1.0, 4.2, d))
        if c % 3 == 0:  # sprinkle strong-signal columns
            v[: rng.integers(1, 8)] = 10.0 ** (-rng.uniform(3.0, 9.0))
        probs[c, :d] = np.sort(v)
    ks = rng.integers(1, 25, B)
    bonf = rng.choice([3.0, 3000.0, 3e6], B)
    sig = 0.01

    keep = host_screen_tail(probs, depths, ks, bonf, sig)

    counts = np.zeros((B, 3), dtype=np.int64)
    counts[:, 0] = ks
    pv = snpcaller_batch(probs, depths, counts, bonf.astype(np.float64),
                         sig)
    is_sig = (pv * bonf[:, None].astype(np.longdouble) < sig).any(axis=1)
    missed = int((is_sig & ~keep).sum())
    assert is_sig.sum() > 30, f"want real positives, got {is_sig.sum()}"
    assert missed == 0, f"host screen dropped {missed} significant columns"
    assert keep.sum() < B, "host screen should discard something"
    # tighter than the top-k product prescreen on the same inputs
    from lofreq_tpu.call.caller import _topk_prescreen

    topk = _topk_prescreen(probs, ks, bonf, sig)
    assert keep.sum() <= topk.sum()
