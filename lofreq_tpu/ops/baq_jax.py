"""Batched BAQ forward/backward HMM on device (JAX).

Device rendition of the banded glocal probabilistic alignment
(csrc/baq.c:glocal is the exact host version; see the reference's
kprobaln_ext.c:80 for the original).  Instead of band-relative cell
indexing, each DP row spans the full reference window (~read length +
2*band ≈ 128 lanes) and the band is applied as a mask — wasting a few x
elementwise FLOPs in exchange for perfectly regular shapes.  The D state's within-row first-order recurrence
   fD[k] = a[k] + beta * fD[k-1]
is evaluated with an associative scan.

Batched over reads of one length bucket; f32.  Returns per-base MAP phred
posteriors and states, matching the exact C kernel to ~1 phred (the C path
remains the bit-exact oracle; this is the throughput path for device-side
read rescoring).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

NEG0 = 0.0

PAR_D = 0.00001
PAR_E = 0.4
EI = 0.25
EM = 0.33333333333


@lru_cache(maxsize=64)
def _build(L, Lr, bw, want_pd=False, want_margin=False):
    import jax
    import jax.numpy as jnp

    sM = sI = 1.0 / (2 * L + 2)
    m00 = (1 - PAR_D - PAR_D) * (1 - sM)
    m01 = m02 = PAR_D * (1 - sM)
    m10 = (1 - PAR_E) * (1 - sI)
    m11 = PAR_E * (1 - sI)
    m20 = 1 - PAR_E
    m22 = PAR_E

    ks = jnp.arange(1, Lr + 1)  # 1-based ref positions within window

    def band_mask(i, l_ref):
        lo = jnp.maximum(1, i - bw)
        hi = jnp.minimum(l_ref, i + bw)
        return (ks >= lo) & (ks <= hi)

    def emission(refw, qual_i, query_i):
        # refw: [B, Lr] codes; query_i: [B] code; qual_i: [B] err prob
        amb = (refw > 3) | (query_i[:, None] > 3)
        match = refw == query_i[:, None]
        return jnp.where(amb, 1.0,
                         jnp.where(match, 1.0 - qual_i[:, None],
                                   qual_i[:, None] * EM))

    # The D-state within-row recurrence fD[k] = a[k] + m22*fD[k-1] is a
    # geometric convolution fD[k] = sum_{j<=k} a[j]*m22^(k-j): one
    # triangular-Toeplitz matmul instead of an associative scan — one
    # [B, Lr] x [Lr, Lr] matrix product per row step — and m22^j underflows f32 past j~127 so the matrix IS the
    # exact (truncated) chain.  Precision.HIGHEST keeps it in full f32:
    # the GPU would otherwise run an f32 matmul in TF32 (~3 decimal
    # digits), far outside the few-phred screening budget.
    _kj = np.arange(Lr)[:, None] - np.arange(Lr)[None, :]  # j rows, k cols
    _T = np.where(_kj <= 0, np.power(np.float64(m22), -_kj,
                                     where=_kj <= 0, out=np.zeros_like(
                                         _kj, dtype=np.float64)), 0.0)
    import jax.numpy as _jnp
    T_D = _jnp.asarray(_T.astype(np.float32))       # fD = a @ T_D
    T_Drev = _jnp.asarray(_T.T.astype(np.float32))  # reverse chain

    def d_scan(a):
        """fD[k] = a[k] + m22 * fD[k-1], fD[0-] = 0, along last axis."""
        return jnp.dot(a, T_D, precision=jax.lax.Precision.HIGHEST)

    def d_scan_rev(a):
        return jnp.dot(a, T_Drev, precision=jax.lax.Precision.HIGHEST)

    @jax.jit
    def run(refw, query, qualp, l_ref):
        """refw [B, Lr] ref codes (0..4; pad 4), query [B, L] codes,
        qualp [B, L] error probs (float table applied), l_ref [B].
        Returns (q [B, L] phred ints, state [B, L], pd_m/pd_i/pd_d
        [B, L, Lr] posteriors for IDAQ)."""
        B = query.shape[0]
        in_ref = ks[None, :] <= l_ref[:, None]
        # begin-state transitions use the *per-read* window length
        bM = ((1 - PAR_D) / l_ref)[:, None]
        bI = (PAR_D / l_ref)[:, None]

        # ---- forward ----
        def fwd_step(carry, xs):
            fM, fI, fD, i = carry
            q_i, query_i = xs
            e = emission(refw, q_i, query_i)
            mask = band_mask(i, l_ref[:, None]) & in_ref
            fM1 = jnp.pad(fM, ((0, 0), (1, 0)))[:, :-1]  # fM[i-1, k-1]
            fD1 = jnp.pad(fD, ((0, 0), (1, 0)))[:, :-1]
            newM = e * (m00 * fM1 + m10 * jnp.pad(fI, ((0, 0), (1, 0)))[:, :-1]
                        + m20 * fD1)
            newI = EI * (m01 * fM + m11 * fI)
            newM = jnp.where(mask, newM, 0.0)
            newI = jnp.where(mask, newI, 0.0)
            # first-row boundary handled by caller's init (i starts at 2)
            aD = m02 * jnp.pad(newM, ((0, 0), (1, 0)))[:, :-1]
            newD = d_scan(aD)
            newD = jnp.where(mask, newD, 0.0)
            s = jnp.sum(newM + newI + newD, axis=1)
            s = jnp.maximum(s, 1e-30)
            inv = 1.0 / s
            outD = newD * inv[:, None] if want_pd else jnp.zeros(
                (0, 0), jnp.float32)  # D rows only needed for posteriors
            return ((newM * inv[:, None], newI * inv[:, None],
                     newD * inv[:, None], i + 1),
                    (newM * inv[:, None], newI * inv[:, None], outD, s))

        # row 1 init
        e1 = emission(refw, qualp[:, 0], query[:, 0])
        mask1 = band_mask(1, l_ref[:, None]) & in_ref & (
            ks[None, :] <= jnp.minimum(l_ref, bw + 1)[:, None])
        fM = jnp.where(mask1, e1 * bM, 0.0)
        fI = jnp.where(mask1, EI * bI, 0.0)
        fD = jnp.zeros_like(fM)
        s1 = jnp.maximum(jnp.sum(fM + fI, axis=1), 1e-30)
        fM = fM / s1[:, None]
        fI = fI / s1[:, None]

        (fMn, fIn, fDn, _), (Ms, Is, Ds, ss) = jax.lax.scan(
            fwd_step, (fM, fI, fD, jnp.int32(2)),
            (qualp[:, 1:].T, query[:, 1:].T))
        # stack row 1 + rows 2..L  -> [L, B, Lr]
        Ms = jnp.concatenate([fM[None], Ms], axis=0)
        Is = jnp.concatenate([fI[None], Is], axis=0)
        if want_pd:
            Ds = jnp.concatenate([fD[None], Ds], axis=0)
        ss = jnp.concatenate([s1[None], ss], axis=0)  # [L, B]
        sL1 = jnp.sum(Ms[-1] * sM + Is[-1] * sI, axis=1)  # s[L+1]

        # ---- backward ----
        bM_L = jnp.where(in_ref, sM / ss[-1][:, None] / sL1[:, None], 0.0)
        bI_L = jnp.where(in_ref, sI / ss[-1][:, None] / sL1[:, None], 0.0)
        bD_L = jnp.zeros_like(bM_L)
        maskL = band_mask(L, l_ref[:, None]) & in_ref
        bM_L = jnp.where(maskL, bM_L, 0.0)
        bI_L = jnp.where(maskL, bI_L, 0.0)

        def bwd_step(carry, xs):
            bMc, bIc, bDc, i = carry  # row i+1 values
            q_i1, query_i1, s_i = xs  # quals/query of row i+1, scale s[i]
            e = emission(refw, q_i1, query_i1)
            # e_{k+1} * b_{i+1}[k+1]
            eb = e * bMc
            eb_shift = jnp.pad(eb, ((0, 0), (0, 1)))[:, 1:]  # [k] <- k+1
            common = EI * bIc
            # bD[i][k] = (e*m20*b[i+1]M[k+1] + m22*bD[i][k+1]) * y
            # mask the scan *inputs* to this row's band: out-of-band cells
            # are zero in the reference and must not feed the chain
            y = (i > 1).astype(jnp.float32)
            mask = band_mask(i, l_ref[:, None]) & in_ref
            bDn = d_scan_rev(jnp.where(mask, eb_shift * m20, 0.0)) * y
            bDn = jnp.where(mask, bDn, 0.0)
            bD_next = jnp.pad(bDn, ((0, 0), (0, 1)))[:, 1:]  # bD[i][k+1]
            bMn = eb_shift * m00 + m01 * common + m02 * bD_next
            bIn = eb_shift * m10 + m11 * common
            bMn = jnp.where(mask, bMn, 0.0)
            bIn = jnp.where(mask, bIn, 0.0)
            inv = 1.0 / s_i[:, None]
            return ((bMn * inv, bIn * inv, bDn * inv, i - 1),
                    (bMn * inv, bIn * inv, bDn * inv))

        def map_row(zM_i, zI_i):
            """Per-row MAP phred + state from posterior row [B, Lr].
            Failure mass computed directly (sum minus the winning cell,
            not 1 - max/tot): f32 would otherwise saturate for posteriors
            near 1 (BAQ > ~72)."""
            best_m = jnp.max(zM_i, axis=1)
            best_i = jnp.max(zI_i, axis=1)
            is_ins = best_i > best_m
            best = jnp.where(is_ins, best_i, best_m)
            best_k = jnp.where(is_ins, jnp.argmax(zI_i, axis=1),
                               jnp.argmax(zM_i, axis=1))
            lane = jnp.arange(Lr)[None, :]
            win_m = (~is_ins)[:, None] & (lane == best_k[:, None])
            win_i = is_ins[:, None] & (lane == best_k[:, None])
            rest = (jnp.sum(jnp.where(win_m, 0.0, zM_i), axis=1)
                    + jnp.sum(jnp.where(win_i, 0.0, zI_i), axis=1))
            pfail = rest / jnp.maximum(rest + best, 1e-30)
            y = -4.343 * jnp.log(jnp.maximum(pfail, 1e-38)) + 0.499
            qph = y.astype(jnp.int32)
            qph = jnp.where(qph > 100, 99, qph)  # C: k>100 ? 99 : k
            st = (best_k.astype(jnp.int32) << 2) | is_ins.astype(jnp.int32)
            if not want_margin:
                return qph, st
            # decision margins for the exact-confirm band (device f64->f32
            # deviations can only flip results where these are small):
            # margin_q: distance of the pre-truncation phred to an integer
            # boundary; margin_s: relative gap of the MAP winner to the
            # runner-up cell (a state flip changes the diagonal check)
            frac = y - jnp.floor(y)
            margin_q = jnp.minimum(frac, 1.0 - frac)
            second = jnp.maximum(
                jnp.max(jnp.where(win_m, 0.0, zM_i), axis=1),
                jnp.max(jnp.where(win_i, 0.0, zI_i), axis=1))
            margin_s = 1.0 - second / jnp.maximum(best, 1e-30)
            return qph, st, margin_q, margin_s

        if want_pd:
            xs = (qualp[:, 1:].T[::-1], query[:, 1:].T[::-1], ss[:-1][::-1])
            (_, _, _, _), (bMs_r, bIs_r, bDs_r) = jax.lax.scan(
                bwd_step, (bM_L, bI_L, bD_L, jnp.int32(L - 1)), xs)
            bMs = jnp.concatenate([bMs_r[::-1], bM_L[None]], axis=0)
            bIs = jnp.concatenate([bIs_r[::-1], bI_L[None]], axis=0)
            bDs = jnp.concatenate([bDs_r[::-1], bD_L[None]], axis=0)
            zM = Ms * bMs  # [L, B, Lr]
            zI = Is * bIs
            zD = Ds * bDs
            qphred, state = jax.vmap(map_row)(zM, zI)
            pd_scale = ss[:, :, None]
            return (qphred.T, state.T,
                    (zM * pd_scale).transpose(1, 0, 2),
                    (zI * pd_scale).transpose(1, 0, 2),
                    (zD * pd_scale).transpose(1, 0, 2))

        # BAQ-only: fold the posterior/MAP computation into the backward
        # scan so no [L, B, Lr] posterior tensors are ever materialized
        def bwd_map_step(carry, xs):
            q_i1, query_i1, s_i, Ms_i, Is_i = xs
            (bMn, bIn, bDn, i), _ = bwd_step(carry, (q_i1, query_i1, s_i))
            return (bMn, bIn, bDn, i), map_row(Ms_i * bMn, Is_i * bIn)

        xs = (qualp[:, 1:].T[::-1], query[:, 1:].T[::-1], ss[:-1][::-1],
              Ms[:-1][::-1], Is[:-1][::-1])
        carry0 = (bM_L, bI_L, bD_L, jnp.int32(L - 1))
        if want_margin:
            _, (q_r, st_r, mq_r, ms_r) = jax.lax.scan(bwd_map_step, carry0,
                                                      xs)
            qL, stL, mqL, msL = map_row(Ms[-1] * bM_L, Is[-1] * bI_L)
            qphred = jnp.concatenate([q_r[::-1], qL[None]], axis=0)
            state = jnp.concatenate([st_r[::-1], stL[None]], axis=0)
            marg_q = jnp.concatenate([mq_r[::-1], mqL[None]], axis=0)
            marg_s = jnp.concatenate([ms_r[::-1], msL[None]], axis=0)
            return qphred.T, state.T, marg_q.T, marg_s.T, None
        _, (q_r, st_r) = jax.lax.scan(bwd_map_step, carry0, xs)
        qL, stL = map_row(Ms[-1] * bM_L, Is[-1] * bI_L)
        qphred = jnp.concatenate([q_r[::-1], qL[None]], axis=0)
        state = jnp.concatenate([st_r[::-1], stL[None]], axis=0)
        return qphred.T, state.T, None, None, None

    return run


_BASECODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _BASECODE[ord(_c)] = _i
    _BASECODE[ord(_c.lower())] = _i

_Q2P = np.array([np.float32(10.0 ** (-q / 10.0)) for q in range(256)],
                dtype=np.float32)


def baq_batch_jax(reads_info, ref: bytes):
    """Device BAQ for a batch of same-length reads.

    reads_info: list of (pos, seq bytes, qual np.uint8, xb, xe) where
    [xb, xe) is the reference window (as computed by the driver's band
    logic).  All reads must share l_qseq and window length.
    Returns (q [B, L] int, state [B, L] int).
    """
    import jax.numpy as jnp

    B = len(reads_info)
    L = len(reads_info[0][1])
    Lr = max(r[4] - r[3] for r in reads_info)
    Lr_pad = -(-Lr // 128) * 128
    refarr = np.frombuffer(ref, dtype=np.uint8)
    refw = np.full((B, Lr_pad), 4, dtype=np.int8)
    l_ref = np.zeros(B, dtype=np.int32)
    query = np.zeros((B, L), dtype=np.int8)
    qualp = np.zeros((B, L), dtype=np.float32)
    for i, (pos, seq, qual, xb, xe) in enumerate(reads_info):
        w = _BASECODE[refarr[xb:xe]]
        refw[i, : len(w)] = w
        l_ref[i] = len(w)
        query[i] = _BASECODE[np.frombuffer(seq, dtype=np.uint8)]
        qualp[i] = _Q2P[qual]
    bw = 7  # driver guarantees simple-band reads in this bucket
    run = _build(L, Lr_pad, bw)
    q, state, _pm, _pi, _pd = run(
        jnp.asarray(refw.astype(np.int32)), jnp.asarray(query.astype(np.int32)),
        jnp.asarray(qualp), jnp.asarray(l_ref))
    return np.asarray(q), np.asarray(state)


def extract_baq(q, state, pos, xb, ext=True):
    """Host-side BAQ extraction for an all-match read (the general cigar
    walk lives in csrc/baq.c; this covers the M-only bucket the device
    path handles): zero off-diagonal states + ext smoothing.  Non-ext BAQ
    is the raw posterior with NO state masking — in the reference's
    compiled build the zeroing of that branch is dead code
    (bam_md_ext.c:417-421, no ORIG_BAQ)."""
    L = len(q)
    if not ext:
        return np.minimum(q, 93)
    diag = pos - xb + np.arange(L)
    ok = ((state & 3) == 0) & ((state >> 2) == diag)
    bq = np.where(ok, q, 0)
    left = np.maximum.accumulate(bq)
    right = np.maximum.accumulate(bq[::-1])[::-1]
    bq = np.minimum(left, right)
    return np.minimum(bq, 93)
