"""Device (JAX) BAQ vs the exact native C BAQ."""

import numpy as np
import pytest

from lofreq_tpu.io.bam import BamRead
from lofreq_tpu.ops.baq_hmm import realn_batch
from lofreq_tpu.ops.baq_jax import baq_batch_jax, extract_baq


def test_baq_jax_matches_c():
    rng = np.random.default_rng(17)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000)
    ref = genome.tobytes()
    L = 100
    B = 64
    reads = []
    infos = []
    for i in range(B):
        pos = int(rng.integers(10, 3800))
        r = BamRead()
        r.qname = f"j{i}"
        r.tid = 0
        r.pos = pos
        seq = genome[pos : pos + L].copy()
        # a few mismatches
        for _ in range(int(rng.integers(0, 4))):
            at = int(rng.integers(0, L))
            b = seq[at]
            while b == seq[at]:
                b = rng.choice(np.frombuffer(b"ACGT", np.uint8))
            seq[at] = b
        r.seq = seq.tobytes()
        r.qual = rng.integers(10, 41, L).astype(np.uint8)
        r.set_cigar_string(f"{L}M")
        reads.append(r)
        xb = max(pos - 3, 0)
        xe = min(pos + L + 3, len(ref))
        infos.append((pos, r.seq, r.qual, xb, xe))

    # exact C BAQ
    realn_batch(reads, ref, baq=True, ext_baq=True, idaq=False)
    c_baq = np.stack([
        np.frombuffer(r.get_tag("lb").encode("latin-1"), np.uint8) - 33
        for r in reads
    ]).astype(np.int64)

    # device BAQ
    q, state = baq_batch_jax(infos, ref)
    j_baq = np.stack([
        extract_baq(q[i], state[i], infos[i][0], infos[i][3])
        for i in range(B)
    ]).astype(np.int64)

    diff = np.abs(c_baq - j_baq)
    frac_exact = (diff == 0).mean()
    assert frac_exact > 0.97, f"only {frac_exact:.3f} exact"
    assert diff.max() <= 2, f"max phred diff {diff.max()}"


def test_baq_jax_flips_only_at_truncation_boundaries():
    """Device (f32) vs exact C BAQ: integer disagreements must be confined
    to bases whose pre-truncation phred sits within 1e-3 of an integer
    boundary (margin_q) or whose MAP winner is within 1e-3 of the
    runner-up (margin_s).  This is the deviation model behind the call
    pipeline's BAQ_SCREEN_DELTA safety band and behind the decision to
    keep tag emission (alnqual) on the exact C kernel — see
    docs/DEVICE_HMM.md."""
    import jax.numpy as jnp

    from lofreq_tpu.ops.baq_jax import _BASECODE, _Q2P, _build

    rng = np.random.default_rng(23)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 6000)
    ref = genome.tobytes()
    L, B = 100, 512
    reads = []
    for i in range(B):
        pos = int(rng.integers(10, 5800))
        r = BamRead()
        r.qname = f"m{i}"
        r.tid = 0
        r.pos = pos
        seq = genome[pos:pos + L].copy()
        for _ in range(int(rng.integers(0, 6))):
            at = int(rng.integers(0, L))
            seq[at] = rng.choice(np.frombuffer(b"ACGT", np.uint8))
        r.seq = seq.tobytes()
        r.qual = rng.integers(5, 41, L).astype(np.uint8)
        r.set_cigar_string(f"{L}M")
        reads.append(r)
    realn_batch(reads, ref, baq=True, ext_baq=True, idaq=False)
    c_bq = np.stack([np.frombuffer(r.get_tag("lb").encode("latin-1"),
                                   np.uint8) for r in reads]) - 33

    run = _build(L, 128, 7, want_margin=True)
    refa = np.frombuffer(ref, np.uint8)
    codes = np.empty((B, L), np.int32)
    qualp = np.empty((B, L), np.float32)
    lr = np.empty(B, np.int32)
    d0 = np.empty(B, np.int32)
    refw = np.full((B, 128), 4, np.int32)
    for i, r in enumerate(reads):
        codes[i] = _BASECODE[np.frombuffer(r.seq, np.uint8)]
        qualp[i] = _Q2P[np.asarray(r.qual)]
        b = max(r.pos - 3, 0)
        e = min(r.pos + L + 3, len(ref))
        lr[i] = e - b
        d0[i] = r.pos - b
        refw[i, : e - b] = _BASECODE[refa[b:e]]
    q, st, mq, ms, _ = run(jnp.asarray(refw), jnp.asarray(codes),
                           jnp.asarray(qualp), jnp.asarray(lr))
    q, st = np.asarray(q), np.asarray(st)
    mq, ms = np.asarray(mq), np.asarray(ms)
    diag = d0[:, None] + np.arange(L)[None, :]
    ok = ((st & 3) == 0) & ((st >> 2) == diag)
    bq0 = np.where(ok, q, 0)
    left = np.maximum.accumulate(bq0, axis=1)
    right = np.maximum.accumulate(bq0[:, ::-1], axis=1)[:, ::-1]
    dev_bq = np.minimum(np.minimum(left, right), 93)
    flips = dev_bq != c_bq
    assert flips.mean() < 0.01  # flips are rare ...
    # ext smoothing propagates a flip along the read, so confinement is
    # asserted per READ: any read with flips must contain a base within
    # the margin band
    near_read = ((mq < 1e-3) | (ms < 1e-3)).any(axis=1)
    flip_read = flips.any(axis=1)
    assert not np.any(flip_read & ~near_read)
