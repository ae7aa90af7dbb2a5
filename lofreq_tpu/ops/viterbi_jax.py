"""Batched Viterbi realignment on device (JAX).

Device rendition of the per-read realigner (csrc/realign.c is the exact host
version).  Full-width DP rows over the reference window; the D state's
within-row max-plus recurrence
    D[k] = max(M[k-1] + a, D[k-1] + b)
has the closed form  D[k] = a + b*k + cummax_{j<=k}(M[j-1] - b*j), so each
row is fully vectorized.  Backpointers are packed into one uint8 per cell
and the traceback runs as a lax.scan with per-read gathers, so only the
final alignment strings leave the device.

Tie-breaking matches the reference's argmax_first (first-listed operand
wins ties).  f32; near-exact agreement with the C realigner (ties beyond
f32 resolution may differ; the C path remains the default in the BAM
pipeline, this is the device-throughput variant).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

ALPHA = 0.00001
BETA = 0.4
NEG = np.float32(-2147483648.0)  # INT_MIN like the reference init

# pointer encodings
PM_S, PM_M, PM_I, PM_D = 0, 1, 2, 3  # ptr for match state ("SMID")
PI_S, PI_M, PI_I = 0, 1, 2  # "SMI"
PD_M, PD_D = 0, 1  # "MD"


@lru_cache(maxsize=32)
def _build(L, Lr):
    from . import ensure_jax_cache

    ensure_jax_cache()
    import jax
    import jax.numpy as jnp

    ep_ins = np.float32(np.log10(0.25))
    ks = jnp.arange(Lr)

    def first_argmax(vals):
        """argmax with first-listed tie-breaking over a python list of
        arrays; returns (best, idx)."""
        best = vals[0]
        idx = jnp.zeros_like(vals[0], dtype=jnp.int32)
        for j, v in enumerate(vals[1:], start=1):
            take = v > best
            best = jnp.where(take, v, best)
            idx = jnp.where(take, j, idx)
        return best, idx

    @jax.jit
    def run(refw, query, bp, l_ref):
        """refw [B, Lr] codes; query [B, L]; bp [B, L] err prob (Q2 already
        replaced); l_ref [B].  Returns (end_state, end_k, ptrs [L,B,Lr]
        uint8, vM/vI last row)."""
        B = query.shape[0]
        in_ref = ks[None, :] < l_ref[:, None]
        # transition probs use the *per-read* DP length rlen = l_ref + 1
        # (viterbi.c:127-143)
        rlen = (l_ref + 1).astype(jnp.float32)[:, None]
        gamma = 1.0 / (2.0 * rlen)
        lg10 = np.float32(np.log(10.0))

        def lg(x):
            return jnp.log(x) / lg10

        tp_mm = lg((1 - 2 * ALPHA) * (1 - gamma))
        tp_mi = lg(ALPHA * (1 - gamma))
        tp_md = tp_mi
        tp_im = lg((1 - BETA) * (1 - gamma))
        tp_ii = lg(BETA * (1 - gamma))
        tp_dm = np.float32(np.log10(1 - BETA))
        tp_dd = np.float32(np.log10(BETA))
        tp_sm = lg((1 - ALPHA) / rlen)
        tp_si = lg(ALPHA / rlen)
        vM = jnp.full((B, Lr), NEG)
        vI = jnp.full((B, Lr), NEG)
        vD = jnp.full((B, Lr), NEG)

        def shift1(x):
            return jnp.concatenate(
                [jnp.full((B, 1), NEG, x.dtype), x[:, :-1]], axis=1)

        def step(carry, xs):
            vM, vI, vD, i = carry
            q_i, bp_i = xs
            ep_match = jnp.log10(1.0 - bp_i)
            ep_mismatch = jnp.log10(bp_i / 3.0)
            is_start = (i == 0)
            vs_prev = jnp.where(is_start, 0.0, NEG)  # V_start[i-1]

            mterms = [
                jnp.full((B, Lr), vs_prev) + tp_sm,
                shift1(vM) + tp_mm,
                shift1(vI) + tp_im,
                shift1(vD) + tp_dm,
            ]
            bestM, ptrM = first_argmax(mterms)
            match = refw == q_i[:, None]
            e = jnp.where(match, ep_match[:, None], ep_mismatch[:, None])
            newM = e + bestM

            iterms = [
                jnp.full((B, Lr), vs_prev) + tp_si,
                vM + tp_mi,
                vI + tp_ii,
            ]
            bestI, ptrI = first_argmax(iterms)
            newI = ep_ins + bestI

            # D row: D[k] = max(M[k-1]+tp_md, D[k-1]+tp_dd), D[<0] = NEG
            a = shift1(newM) + tp_md
            run_val = jnp.maximum.accumulate(
                a - tp_dd * ks[None, :], axis=1)
            newD = run_val + tp_dd * ks[None, :]
            newD = jnp.maximum(newD, NEG)
            d_prev = shift1(newD)
            ptrD = jnp.where(a >= d_prev + tp_dd, PD_M, PD_D)

            newM = jnp.where(in_ref, newM, NEG)
            newI = jnp.where(in_ref, newI, NEG)
            newD = jnp.where(in_ref, newD, NEG)
            ptr = (ptrM.astype(jnp.uint8)
                   | (ptrI.astype(jnp.uint8) << 2)
                   | (ptrD.astype(jnp.uint8) << 4))
            return (newM, newI, newD, i + 1), ptr

        (vM, vI, vD, _), ptrs = jax.lax.scan(
            step, (vM, vI, vD, jnp.int32(0)), (query.T, bp.T))

        m_best = jnp.max(vM, axis=1)
        i_best = jnp.max(vI, axis=1)
        end_is_ins = i_best > m_best
        end_k = jnp.where(end_is_ins, jnp.argmax(vI, axis=1),
                          jnp.argmax(vM, axis=1))
        return end_is_ins, end_k, ptrs

    @jax.jit
    def traceback(end_is_ins, end_k, ptrs):
        """Vectorized traceback.  States: 0=M 1=I 2=D 3=done.
        Returns (aln_codes [B, L+Lr] uint8 with 0=M,1=I,2=D,255=empty
        filled right-to-left, k_final [B])."""
        B = end_k.shape[0]
        maxs = ptrs.shape[0] + ptrs.shape[2]
        state = jnp.where(end_is_ins, 1, 0).astype(jnp.int32)
        i = jnp.full(B, ptrs.shape[0], jnp.int32)  # 1-based query row
        k = end_k.astype(jnp.int32) + 1  # 1-based ref col
        bidx = jnp.arange(B)

        def tb_step(carry, si):
            state, i, k, kfin = carry
            active = (state < 3) & (i > 0) & (k > 0)
            out = jnp.where(active, state, 255).astype(jnp.uint8)
            p = ptrs[jnp.clip(i - 1, 0, ptrs.shape[0] - 1), bidx,
                     jnp.clip(k - 1, 0, ptrs.shape[2] - 1)]
            pm = p & 3
            pi = (p >> 2) & 3
            pd = (p >> 4) & 1
            # next pointer by current state
            nxt = jnp.where(state == 0, pm,  # SMID
                            jnp.where(state == 1,
                                      jnp.where(pi == PI_S, PM_S,
                                                jnp.where(pi == PI_M, PM_M,
                                                          PM_I)),
                                      jnp.where(pd == PD_M, PM_M, PM_D)))
            di = jnp.where(state == 0, 1, jnp.where(state == 1, 1, 0))
            dk = jnp.where(state == 0, 1, jnp.where(state == 1, 0, 1))
            new_i = jnp.where(active, i - di, i)
            new_k = jnp.where(active, k - dk, k)
            # map pointer to next state: S -> done
            new_state = jnp.where(
                active,
                jnp.where(nxt == PM_S, 3, nxt - 1),
                state)
            kfin = jnp.where(active & ~((new_state < 3) & (new_i > 0)
                                        & (new_k > 0)), new_k, kfin)
            return (new_state, new_i, new_k, kfin), out

        kfin0 = k
        (state, i, k, kfin), outs = jax.lax.scan(
            tb_step, (state, i, k, kfin0), jnp.arange(maxs))
        return outs.T[:, ::-1], kfin

    return run, traceback


_BASECODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _BASECODE[ord(_c)] = _i
    _BASECODE[ord(_c.lower())] = _i


def viterbi_batch_jax(ref_wins, queries, bquals, q2defaults):
    """Batch realignment: same-length queries and windows.

    ref_wins: list of bytes (ref windows, equal length); queries: list of
    bytes (equal length); bquals: list of np.uint8 phred arrays;
    q2defaults: per-read Q2 replacement.
    Returns list of (shift, aln_string) like viterbi_align.
    """
    import jax.numpy as jnp

    B = len(queries)
    L = len(queries[0])
    Lr = len(ref_wins[0])
    Lr_pad = -(-Lr // 128) * 128
    refw = np.full((B, Lr_pad), 4, dtype=np.int32)
    l_ref = np.zeros(B, dtype=np.int32)
    query = np.zeros((B, L), dtype=np.int32)
    bp = np.zeros((B, L), dtype=np.float32)
    for b in range(B):
        w = _BASECODE[np.frombuffer(ref_wins[b], np.uint8)]
        refw[b, : len(w)] = w
        l_ref[b] = len(w)
        query[b] = _BASECODE[np.frombuffer(queries[b], np.uint8)]
        q = bquals[b].astype(np.float64)
        q = np.where(q == 2, q2defaults[b], q)
        bp[b] = 10.0 ** (-q / 10.0)
    run, traceback = _build(L, Lr_pad)
    end_is_ins, end_k, ptrs = run(
        jnp.asarray(refw), jnp.asarray(query), jnp.asarray(bp),
        jnp.asarray(l_ref))
    codes, kfin = traceback(end_is_ins, end_k, ptrs)
    codes = np.asarray(codes)
    kfin = np.asarray(kfin)
    out = []
    lut = np.array([77, 73, 68], dtype=np.uint8)  # 'M','I','D'
    for b in range(B):
        c = codes[b]
        c = c[c != 255]
        aln = lut[c].tobytes().decode()
        shift = int(kfin[b])
        aln = _left_align(ref_wins[b], queries[b], shift, aln)
        out.append((shift, aln))
    return out


def _left_align(ref_win: bytes, query: bytes, shift: int, aln: str) -> str:
    """Left-align indels in the state string (viterbi.c:48-96 semantics),
    reconstructing the padded ref/query strings from the alignment."""
    r = []
    q = []
    ri = shift
    qi = 0
    for ch in aln:
        if ch == "M":
            r.append(chr(ref_win[ri]) if ri < len(ref_win) else "N")
            q.append(chr(query[qi]) if qi < len(query) else "N")
            ri += 1
            qi += 1
        elif ch == "I":
            r.append("*")
            q.append(chr(query[qi]) if qi < len(query) else "N")
            qi += 1
        else:
            r.append(chr(ref_win[ri]) if ri < len(ref_win) else "N")
            q.append("*")
            ri += 1
    r = list("".join(r))
    q = list("".join(q))
    n = len(r)
    i = 0
    while i < n - 1:
        if r[i] != "*" and q[i] != "*":
            if r[i + 1] == "*":
                ilen = 0
                while i + 1 + ilen < n and r[i + 1 + ilen] == "*":
                    ilen += 1
                if i + ilen < n and q[i + ilen] == r[i]:
                    r[i + ilen] = r[i]
                    r[i] = "*"
                    i -= 1
                    continue
            elif q[i + 1] == "*":
                dlen = 0
                while i + 1 + dlen < n and q[i + 1 + dlen] == "*":
                    dlen += 1
                if i + dlen < n and q[i] == r[i + dlen]:
                    q[i + dlen] = q[i]
                    q[i] = "*"
                    i -= 1
                    continue
        i += 1
    out = []
    for j in range(n):
        if r[j] == "*":
            out.append("I")
        elif q[j] == "*":
            out.append("D")
        else:
            out.append("M")
    return "".join(out)
