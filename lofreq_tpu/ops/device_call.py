"""The device column-calling step: one jitted function that takes packed
per-base column tensors and produces everything the host needs to emit
variants, with only screened candidate columns requiring exact host
confirmation.

Per column batch [B, D] (D = padded depth):
  1. merge qualities  PJ = PM + (1-PM)PS + (1-PM)(1-PS)PBAQ + ...PB
  2. base filters (min_bq / min_alt_bq / min_jq) + alt counts (segment sums)
  3. linear-space screening DP over the full depth (pure FMA scan;
     filtered reads enter as p=0 = exact identity) -> candidate mask

Multi-chip: columns are data-parallel over the mesh ("cols" axis); the only
cross-chip reduction is the per-shard tested-column count (psum), mirroring
the global dynamic-Bonferroni reduction of the reference's parallel wrapper
(lofreq2_call_pparallel.py:131-161).
"""

from __future__ import annotations

from functools import partial

import numpy as np

from .. import defaults as D
from .screen import KMAX, MARGIN

MQ0_ERRPROB = D.MQ0_ERRPROB


def _jx():
    from . import ensure_jax_cache

    ensure_jax_cache()
    import jax
    import jax.numpy as jnp

    return jax, jnp


def merge_quals_f32(jnp, sq, mq, baq, bq):
    """f32 joint error prob; -1 = missing; MQ0 -> 0.5 (snpcaller.c:302)."""
    def q2p(q):
        return jnp.where(q < 0, 0.0, 10.0 ** (-q.astype(jnp.float32) / 10.0))

    sp = q2p(sq)
    mp = jnp.where(mq == 0, MQ0_ERRPROB, q2p(mq))
    bap = q2p(baq)
    bp = q2p(bq)
    return (mp + (1 - mp) * sp + (1 - mp) * (1 - sp) * bap
            + (1 - mp) * (1 - sp) * (1 - bap) * bp)


def build_column_call(min_bq=D.DEFAULT_MIN_BQ, min_alt_bq=D.DEFAULT_MIN_ALT_BQ,
                      min_jq=D.DEFAULT_MIN_JQ, min_alt_jq=D.DEFAULT_MIN_ALT_JQ,
                      min_cov=D.DEFAULT_MIN_COV, sig=D.DEFAULT_SIG,
                      use_baq=True, use_mq=True, use_sq=False,
                      s=None, kmax=KMAX):
    """Returns a jittable fn(nt4, bq, baq, mq, sq, valid, ref_nt4, num_bases,
    coverage, bonf_base) -> dict of per-column outputs."""
    jax, jnp = _jx()

    def column_call(nt4, bq, baq, mq, sq, valid, ref_nt4, bonf_base):
        B, Dd = nt4.shape
        not_n = valid & (nt4 != 4)
        is_alt = not_n & (nt4 != ref_nt4[:, None])

        keep = not_n & (bq >= min_bq) & (~is_alt | (bq >= min_alt_bq))
        mq_eff = jnp.where((mq == 255) | (not use_mq), -1, mq)
        baq_eff = baq if use_baq else jnp.full_like(baq, -1)
        sq_eff = sq if use_sq else jnp.full_like(sq, -1)
        merged = merge_quals_f32(jnp, sq_eff, mq_eff, baq_eff, bq)
        if min_jq > 0 or min_alt_jq > 0:
            mq_phred = -10.0 * jnp.log10(jnp.maximum(merged, 1e-30))
            keep &= mq_phred >= min_jq
            keep &= ~is_alt | (mq_phred >= min_alt_jq)

        # per-base counts via 5 masked sums over [B, D] — never
        # materializing a one-hot [B, D, 5] tensor (that would move GBs
        # of device memory at the bench shape)
        kept_alt = keep & is_alt
        alt_raw5 = jnp.stack(
            [jnp.sum((nt4 == b) & is_alt, axis=1) for b in range(5)], axis=1
        ).astype(jnp.int32)
        alt_cnt5 = jnp.stack(
            [jnp.sum((nt4 == b) & kept_alt, axis=1) for b in range(5)], axis=1
        ).astype(jnp.int32)
        depths = jnp.sum(keep, axis=1)

        # per-column alt bases = non-ref in ACGT order
        base_ids = jnp.arange(4)[None, :]
        alt_sel = base_ids != ref_nt4[:, None]  # [B,4] 3 True per row
        # indices of the 3 alt bases (stable order)
        alt_nt = jnp.argsort(~alt_sel, axis=1, stable=True)[:, :3]
        alt_counts = jnp.take_along_axis(alt_cnt5[:, :4], alt_nt, axis=1)
        alt_raw = jnp.take_along_axis(alt_raw5[:, :4], alt_nt, axis=1)

        # The Poisson-binomial tail is permutation invariant, so the
        # screening DP streams the *unsorted* masked probs — no device sort
        # needed.  The DP runs in LINEAR f32 space: each step is then pure
        # multiply-add (no transcendentals, unlike a log-space scan).
        # Filtered-out reads are encoded as p=0, which is
        # an *exact* identity update (a zero-error-prob read multiplies
        # every cell by 1-p=1).  f32 underflow can only shrink the partial
        # tail, and a smaller tail only *adds* candidates — conservative in
        # the safe direction (the exact host DP confirms all candidates).
        masked = jnp.where(keep, merged, 0.0).astype(jnp.float32)
        if s is None or s >= Dd:
            prefix = masked
            s_eff = Dd
        else:
            # prefix mode: DP over only the s smallest nonzero probs
            # (2.0 sentinel keeps zeros out of the bottom-k, then maps
            # back to the p=0 identity)
            neg_top, _ = jax.lax.top_k(
                -jnp.where(masked > 0.0, masked, 2.0), s)
            prefix = jnp.where(-neg_top > 1.5, 0.0, -neg_top)
            s_eff = s

        ks = jnp.max(alt_counts, axis=1)
        tested = (ref_nt4 != 4) & (depths >= 0) & (ks > 0)
        # the *running* bonf can only grow => bonf_base is a lower bound,
        # making the threshold an upper bound (conservative screen)
        log_thresh = jnp.log(jnp.float32(sig * MARGIN)) - jnp.log(
            jnp.maximum(bonf_base.astype(jnp.float32), 1.0))

        kc = jnp.minimum(jnp.maximum(ks, 1), kmax)
        cell = jnp.arange(kmax + 1)[None, :]
        is_tail = (cell == kc[:, None]).astype(jnp.float32)
        not_beyond = (cell <= kc[:, None]).astype(jnp.float32)
        # tie the carry to a batch-varying input so shard_map's varying-axis
        # tracking accepts the scan carry.  state[j<kc] = P(exactly j
        # errors), state[kc] = tail accumulator P(>= kc) (snpcaller.c:830).
        state0 = jnp.where(cell == 0, 1.0, 0.0).astype(jnp.float32) \
            + 0.0 * prefix[:, :1]
        prefix = jnp.clip(prefix, 0.0, 1.0)

        def step(state, p):
            shifted = jnp.concatenate(
                [state[:, :1] * 0.0, state[:, :-1]], axis=1)
            adv = shifted * p[:, None]
            std = state * (1.0 - p)[:, None] + adv
            tail = state + adv
            new = (is_tail * tail + (1.0 - is_tail) * std) * not_beyond
            return new, None

        state, _ = jax.lax.scan(step, state0, prefix.T, unroll=16)
        lin_tail = jnp.take_along_axis(state, kc[:, None], axis=1)[:, 0]
        tail_val = jnp.log(jnp.maximum(lin_tail, jnp.float32(1e-37)))
        # tail_val after min(depth, s_eff) reads is a lower bound of the
        # final tail (exact when the whole depth was processed), so
        # "bound >= threshold" safely rules a column out.  Columns whose
        # alt count exceeds the clipped K can't be resolved (the clipped
        # tail is an *upper* bound there) and stay candidates.
        candidate = tested & ((tail_val < log_thresh) | (ks > kmax))

        return dict(
            alt_counts=alt_counts, alt_raw=alt_raw, alt_nt=alt_nt,
            depths=depths, tested=tested, candidate=candidate,
            screen_tail=tail_val, num_tested=jnp.sum(tested.astype(jnp.int32)),
        )

    return column_call


def build_sharded_column_call(mesh=None, **kw):
    """shard_map the column pipeline over a device mesh: columns sharded on
    the 'cols' axis, test counters psum'd across chips."""
    jax, jnp = _jx()
    from jax.sharding import Mesh, PartitionSpec as P

    if mesh is None:
        devs = np.array(jax.devices())
        mesh = Mesh(devs, ("cols",))
    fn = build_column_call(**kw)

    def sharded(nt4, bq, baq, mq, sq, valid, ref_nt4, bonf_base):
        out = fn(nt4, bq, baq, mq, sq, valid, ref_nt4, bonf_base)
        # global dynamic-Bonferroni numerator: reduction over the mesh
        out["num_tested"] = jax.lax.psum(out.pop("num_tested"), "cols")
        return out

    from jax import shard_map

    spec_cols = P("cols")
    in_specs = (spec_cols,) * 7 + (spec_cols,)
    out_specs = dict(
        alt_counts=spec_cols, alt_raw=spec_cols, alt_nt=spec_cols,
        depths=spec_cols, tested=spec_cols, candidate=spec_cols,
        screen_tail=spec_cols, num_tested=P(),
    )
    sm = shard_map(sharded, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs)
    return jax.jit(sm), mesh
