#!/usr/bin/env python3
"""Bring-up check of the default `call` on one GPU.

Usage:
    python chip_smoke.py               # phases 0-4 on one card
    python chip_smoke.py --four-cards  # only the 4-card sharded screen

Phases (any failure raises and the script exits non-zero):
  0. Device: JAX's platform must be `gpu`; prints the device, the JAX
     version, XLA_FLAGS, the compile-cache directory and the card's name
     and power limit (nvidia-smi, read by a process that stays off JAX).
  1. Kernels at production shapes, each compiled once with its
     memory_analysis() printed: the u8 significance screen at
     (4096, 128) against the exact Poisson-binomial DP (0 misses) and the
     host f64 screen; device BAQ at tile 32768, L = 100 against the C BAQ
     (max |d phred| <= BAQ_SCREEN_DELTA); the column step at B = 4096,
     D = 512 against host counts (exact).
  2. Default `call` (CLI entry point, in this process) on 200 kb @ 800x,
     100 bp reads (tests/simulate_fast.py, seed 3): warm-up, then a timed
     run whose VCF must equal the all-exact host run's and whose screen
     must have dispatched with 0 unavailable.
  3. `call --device-baq` on the same BAM: identical VCF, device BAQ ran.
  4. `call --call-indels`: identical VCF to the host run with indels.

The host references run in subprocesses pinned to the CPU
(JAX_PLATFORMS=cpu), so this is the only process that opens the card.
The last line of stdout is one JSON object with the device JAX reports.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GENOME, DEPTH, SEED = 200_000, 800, 3
CARD = "card unknown"


def say(msg: str, seconds: float | None = None) -> None:
    if seconds is not None:
        msg = f"{msg}: {seconds:.4f} s [{CARD}]"
    print(msg, flush=True)


# -- phase 0 ------------------------------------------------------------

def device_phase(want_count: int | None = None) -> dict:
    """Checks that JAX runs on a GPU; returns the device record."""
    global CARD
    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{dev.platform!r}); nothing was checked")
    if want_count is not None and len(devs) != want_count:
        raise SystemExit(f"chip_smoke: need {want_count} GPUs, JAX sees "
                         f"{len(devs)}")
    sys.path.insert(0, REPO)
    from lofreq_tpu.ops import ensure_jax_cache

    ensure_jax_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    CARD = smi[0].strip()
    say(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    say(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} compile cache="
        f"{jax.config.jax_compilation_cache_dir!r}")
    for line in smi:
        say(f"nvidia-smi: {line.strip()}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devs)}


# -- data ---------------------------------------------------------------

def simulate(workdir: str, genome_len: int = GENOME, depth: int = DEPTH):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from simulate_fast import simulate_fast

    t0 = time.perf_counter()
    art = simulate_fast(workdir, genome_len=genome_len, depth=depth,
                        seed=SEED)
    say(f"simulated {genome_len} bp @ {depth}x "
        f"({genome_len * depth // 100} reads of 100 bp)",
        time.perf_counter() - t0)
    return art


def start_host_reference(art, out: str, flags=()) -> subprocess.Popen:
    """The all-exact host `call` in a CPU-pinned subprocess: no device
    screen, no screening engine, exact C BAQ everywhere."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", LOFREQ_TPU_BAQ_SCREEN="0")
    return subprocess.Popen(
        [sys.executable, "-m", "lofreq_tpu.cli", "call",
         "--no-device-screen", *flags, "-f", art["fa"], "-o", out,
         art["bam"]], cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, what: str) -> None:
    _out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{what} exited {proc.returncode}: {err[-2000:]}")


def vcf_body(path: str) -> list:
    """VCF lines that must match: all but ##fileDate and ##source (the
    date and the command line)."""
    with open(path) as fh:
        return [ln for ln in fh
                if not ln.startswith(("##fileDate", "##source"))]


# -- phase 1 ------------------------------------------------------------

def memory(fn, *args, **kw) -> str:
    if not hasattr(fn, "lower"):
        return "memory_analysis: n/a (sharded wrapper)"
    ma = fn.lower(*args, **kw).compile().memory_analysis()
    if ma is None:
        return "memory_analysis: n/a"
    return (f"memory_analysis: args {ma.argument_size_in_bytes} B, out "
            f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B, "
            f"code {ma.generated_code_size_in_bytes} B")


def record_screen_codes(art, region: str) -> list:
    """Runs the host engine on `region` and returns the (codes, ks, bonf,
    sig) sub-screen batches it screened: production codes."""
    from lofreq_tpu.call.caller import VarcallConf
    from lofreq_tpu.ops import screen as S
    from lofreq_tpu.pipelines.call_pipeline import run_call

    seen = []
    host = S.host_screen_tail_codes

    def spy(codes, ks, bonf, sig):
        seen.append((codes.copy(), np.asarray(ks).copy(),
                     np.asarray(bonf, np.float64).copy(), sig))
        return host(codes, ks, bonf, sig)

    S.host_screen_tail_codes = spy
    try:
        run_call(art["bam"], art["fa"], region=region,
                 vconf=VarcallConf(use_device_screen=False,
                                   use_device_baq=False))
    finally:
        S.host_screen_tail_codes = host
    return seen


def random_codes(rng, n: int):
    """Sorted u8 codes (255-padded) of per-read err probs from phred
    2..40, with alt counts 1..24 (mostly 1..3, some beyond KMAX) and
    running-bonf values 3..3e6."""
    from lofreq_tpu.ops.screen import TOP_S

    depth = rng.integers(16, TOP_S + 1, n)
    phred = np.where(rng.random((n, TOP_S)) < 0.9,
                     rng.uniform(20, 40, (n, TOP_S)),
                     rng.uniform(2, 20, (n, TOP_S)))
    codes = np.ceil(phred / 10 * np.log2(10) * 8).astype(np.int64)
    codes = np.where(np.arange(TOP_S)[None, :] < depth[:, None], codes, 255)
    codes = np.sort(codes, axis=1).astype(np.uint8)
    ks = np.where(rng.random(n) < 0.7, rng.integers(1, 4, n),
                  rng.integers(4, 25, n))
    ks = np.minimum(ks, depth)
    bonf = np.exp(rng.uniform(np.log(3), np.log(3e6), n))
    return codes, ks, bonf


def exact_significant(codes, ks, bonf, sig) -> np.ndarray:
    """The exact Poisson-binomial DP over the decoded probs: True where the
    column's p-value passes sig at its bonf."""
    from lofreq_tpu.core.poissbin import snpcaller_batch

    dec = np.zeros(256)
    dec[:255] = np.exp2(-np.arange(255) / 8.0)
    probs = dec[codes]
    depth = (codes < 255).sum(axis=1)
    # ascending probs, valid first, 2.0 padding (snpcaller_batch layout)
    probs = np.sort(np.where(codes < 255, probs, 2.0), axis=1)
    counts = np.zeros((len(ks), 3), np.int64)
    counts[:, 0] = ks
    pv = snpcaller_batch(probs, depth, counts, bonf, sig)
    with np.errstate(over="ignore"):
        return pv[:, 0] * bonf.astype(np.longdouble) < sig


def check_screen(real, n_batches: int = 16, B: int = 4096,
                 seed: int = 0) -> dict:
    """Device screen on n_batches x B columns (the recorded production
    batches first, random codes after): every exactly-significant column
    must be a device candidate.  Reports the agreement with the host f64
    screen (host_screen_tail_codes)."""
    import jax.numpy as jnp

    from lofreq_tpu.ops import screen as S

    rng = np.random.default_rng(seed)
    sig = real[0][3] if real else 0.01
    rc = np.concatenate([r[0] for r in real]) if real else \
        np.zeros((0, S.TOP_S), np.uint8)
    rk = np.concatenate([r[1] for r in real]) if real else np.zeros(0)
    rb = np.concatenate([r[2] for r in real]) if real else np.zeros(0)
    n = n_batches * B
    rc, rk, rb = rc[:n], rk[:n], rb[:n]
    codes, ks, bonf = random_codes(rng, n - len(rc))
    codes = np.concatenate([rc, codes]).astype(np.uint8)
    ks = np.concatenate([rk, ks]).astype(np.int64)
    bonf = np.concatenate([rb, bonf])

    Bp = S._bucket_b(B)
    t0 = time.perf_counter()
    assert S.screen_ready(B=Bp, wait_s=600.0), "screen did not compile"
    say("screen compile", time.perf_counter() - t0)
    fn = S._manager.get(Bp, S.TOP_S)
    z = jnp.zeros(B, jnp.int32)
    say("screen " + memory(fn, jnp.zeros((B, S.TOP_S), jnp.uint8), z, z,
                           jnp.zeros(B, jnp.float32), s=S.TOP_S))
    masks, lat = [], []
    for i in range(n_batches):
        sl = slice(i * B, (i + 1) * B)
        t0 = time.perf_counter()
        h = S.screen_dispatch_codes(codes[sl], ks[sl], bonf[sl], sig)
        masks.append(S.screen_fetch(h))
        lat.append(time.perf_counter() - t0)
    dev = np.concatenate(masks)
    host = np.concatenate([
        S.host_screen_tail_codes(codes[i * B:(i + 1) * B],
                                 ks[i * B:(i + 1) * B],
                                 bonf[i * B:(i + 1) * B], sig)
        for i in range(n_batches)])
    exact = exact_significant(codes, ks, bonf, sig)
    misses = int((exact & ~dev).sum())
    out = dict(columns=n, production_columns=len(rc),
               exact_significant=int(exact.sum()),
               device_candidates=int(dev.sum()), misses=misses,
               host_disagree=int((dev != host).sum()),
               device_only=int((dev & ~host).sum()),
               host_only=int((host & ~dev).sum()))
    say(f"screen ({B}, {S.TOP_S}) x {n_batches}: {json.dumps(out)}")
    say("screen dispatch-to-fetch latency, median", float(np.median(lat)))
    assert misses == 0, f"device screen dropped {misses} significant columns"
    assert out["exact_significant"] > 0 and out["device_candidates"] < n
    return out


def bam_reads(art, n: int, L: int = 100) -> list:
    from lofreq_tpu.io.bam import BamReader

    rdr = BamReader(art["bam"])
    reads = []
    for r in rdr.fetch(art["chrom"]):
        if r.l_qseq == L and r.cigar_string() == f"{L}M":
            reads.append(r)
            if len(reads) == n:
                break
    rdr.close()
    return reads


def check_device_baq(art, n: int | None = None, L: int = 100) -> dict:
    """Device BAQ (the --device-baq runner at its production tile) against
    the exact C BAQ: max |d phred| <= BAQ_SCREEN_DELTA."""
    from lofreq_tpu.defaults import BAQ_SCREEN_DELTA
    from lofreq_tpu.io.fasta import Fasta
    from lofreq_tpu.ops.baq_hmm import realn_batch
    from lofreq_tpu.ops.baq_jax import _BASECODE
    from lofreq_tpu.ops.device_baq import _tile_b, get_runner

    n = n or _tile_b()
    ref = Fasta(art["fa"]).fetch(art["chrom"])
    reads = bam_reads(art, n, L)
    assert len(reads) == n, f"only {len(reads)} reads"
    pos = np.array([r.pos for r in reads], np.int64)
    xb = np.maximum(pos - 3, 0)
    xe = np.minimum(pos + L + 3, len(ref))
    codes = np.stack([_BASECODE[np.frombuffer(r.seq, np.uint8)]
                      for r in reads])
    quals = np.stack([np.frombuffer(bytes(r.qual), np.uint8)
                      for r in reads])
    t0 = time.perf_counter()
    realn_batch(reads, ref, baq=True, ext_baq=True, idaq=False)
    say(f"C BAQ, {n} reads", time.perf_counter() - t0)
    c_bq = np.stack([np.frombuffer(r.get_tag("lb").encode("latin-1"),
                                   np.uint8) for r in reads]) - 33
    runner = get_runner(ext_baq=True)
    t0 = time.perf_counter()
    dev = runner.run(ref, codes, quals, pos, xb, xe)
    say(f"device BAQ compile + first run, {n} reads",
        time.perf_counter() - t0)
    t0 = time.perf_counter()
    dev = runner.run(ref, codes, quals, pos, xb, xe)
    say(f"device BAQ run, {n} reads", time.perf_counter() - t0)
    (key, fn), = [(k, f) for k, f in runner._fns.items() if k[0] == L]
    import jax.numpy as jnp

    tile = runner._tile
    say("device BAQ " + memory(
        fn, jnp.zeros(key[2], jnp.uint8), jnp.zeros(256, jnp.float32),
        jnp.zeros((tile, L), jnp.int8), jnp.zeros((tile, L), jnp.uint8),
        jnp.zeros(tile, jnp.int32), jnp.zeros(tile, jnp.int32),
        jnp.zeros(tile, jnp.int32)))
    d = np.abs(dev.astype(np.int64) - c_bq.astype(np.int64))
    hist = np.bincount(d.ravel())
    out = dict(reads=n, bases=int(d.size), max_delta=int(d.max()),
               exact_share=float((d == 0).mean()),
               delta_hist={str(i): int(c) for i, c in enumerate(hist) if c})
    say(f"device BAQ vs C BAQ: {json.dumps(out)}")
    assert out["max_delta"] <= BAQ_SCREEN_DELTA, out
    return out


def check_column_step(B: int = 4096, D: int = 512) -> dict:
    """The device column step's counts and depths equal the host's."""
    import jax

    sys.path.insert(0, REPO)
    from __graft_entry__ import _example_batch
    from lofreq_tpu.ops.device_call import build_column_call

    args = _example_batch(B=B, D=D, seed=5)
    nt4, bq, baq, mq, sq, valid, ref_nt4, bonf = args
    fn = jax.jit(build_column_call(use_baq=True))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    say(f"column step ({B}, {D}) compile + run", time.perf_counter() - t0)
    say("column step " + memory(fn, *args))
    not_n = valid & (nt4 != 4)
    is_alt = not_n & (nt4 != ref_nt4[:, None])
    from lofreq_tpu import defaults as Dd

    keep = not_n & (bq >= Dd.DEFAULT_MIN_BQ) & (
        ~is_alt | (bq >= Dd.DEFAULT_MIN_ALT_BQ))
    alt_nt = np.asarray(out["alt_nt"])
    rows = np.arange(B)[:, None]
    per_base = np.stack([(keep & is_alt & (nt4 == b)).sum(axis=1)
                         for b in range(4)], axis=1)
    raw_base = np.stack([(is_alt & (nt4 == b)).sum(axis=1)
                         for b in range(4)], axis=1)
    want_nt = np.array([[b for b in range(4) if b != r] for r in ref_nt4])
    assert np.array_equal(alt_nt, want_nt)
    assert np.array_equal(np.asarray(out["depths"]), keep.sum(axis=1))
    assert np.array_equal(np.asarray(out["alt_counts"]),
                          per_base[rows, want_nt])
    assert np.array_equal(np.asarray(out["alt_raw"]),
                          raw_base[rows, want_nt])
    res = dict(columns=B, depth=D, alt_bases=int(per_base.sum()))
    say(f"column step matches host counts: {json.dumps(res)}")
    return res


# -- phases 2-4 ---------------------------------------------------------

def cli_call(art, out: str, flags=()) -> float:
    """One `call` through the CLI entry point in this process."""
    from lofreq_tpu.cli import main

    if os.path.exists(out):
        os.unlink(out)
    t0 = time.perf_counter()
    rc = main(["call", *flags, "-f", art["fa"], "-o", out, art["bam"]])
    wall = time.perf_counter() - t0
    assert rc == 0, f"call {flags} exited {rc}"
    return wall


def check_call(art, want_vcf: str, out: str, flags=(),
               require_screen: bool = True) -> dict:
    """Warm-up + timed `call` with `flags`; the timed run's VCF must equal
    want_vcf, and with require_screen the device screen must have
    dispatched with none unavailable."""
    from lofreq_tpu.core import stagetimer
    from lofreq_tpu.ops.screen import DISPATCH_STATS

    name = " ".join(["call", *flags])
    say(f"{name} warm-up", cli_call(art, out, flags))
    DISPATCH_STATS.update(dispatched=0, unavailable=0)
    stagetimer.reset()
    wall = cli_call(art, out, flags)
    stages = stagetimer.report()
    say(f"{name} timed run ({GENOME} cols/{wall:.3f} s = "
        f"{GENOME / wall:.0f} cols/s)", wall)
    say(f"{name} stages (s): {json.dumps(stages)}")
    say(f"{name} screen: {json.dumps(DISPATCH_STATS)}")
    same = vcf_body(out) == vcf_body(want_vcf)
    n_rec = sum(1 for ln in vcf_body(out) if not ln.startswith("#"))
    say(f"{name}: VCF identical to the host run: {same} ({n_rec} records)")
    assert same, f"{name}: VCF differs from the all-exact host run"
    if require_screen:
        assert DISPATCH_STATS["dispatched"] > 0, DISPATCH_STATS
        assert DISPATCH_STATS["unavailable"] == 0, DISPATCH_STATS
    return dict(wall=wall, stages=stages, records=n_rec,
                **{f"screen_{k}": v for k, v in DISPATCH_STATS.items()})


# -- --four-cards ---------------------------------------------------------

def check_sharded_screen(B: int = 16384, seed: int = 1) -> None:
    """The screen sharded over every local device (_local_mesh) equals
    the single-device build at (B, TOP_S)."""
    import jax

    from lofreq_tpu.ops import screen as S

    mesh = S._local_mesh()
    assert mesh is not None and mesh.devices.size == len(jax.devices())
    codes, ks, bonf = random_codes(np.random.default_rng(seed), B)
    depths = np.full(B, S.TOP_S, np.int32)
    lt = np.log(0.01 * S.MARGIN / bonf).astype(np.float32)
    args = (codes, depths, ks.astype(np.int32), lt)
    sharded = S._build_screen_fn(mesh=mesh)(*args, s=S.TOP_S)
    devs = {sh.device for sh in sharded.addressable_shards}
    single = S._build_screen_fn(mesh=None)(*args, s=S.TOP_S)
    same = np.array_equal(np.asarray(sharded), np.asarray(single))
    say(f"sharded screen ({B}, {S.TOP_S}) over {len(devs)} devices equals "
        f"the single-device mask: {same}")
    assert same and len(devs) == mesh.devices.size


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the default call with the screen "
                         "sharded over 4 GPUs")
    opts = ap.parse_args()
    device = device_phase(want_count=4 if opts.four_cards else 1)
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as td:
        art = simulate(td)
        host_vcf = os.path.join(td, "host.vcf")
        ref = start_host_reference(art, host_vcf)
        indel_ref = None
        if not opts.four_cards:
            host_indel_vcf = os.path.join(td, "host_indels.vcf")
            indel_ref = start_host_reference(art, host_indel_vcf,
                                             ["--call-indels"])
            say("== phase 1: kernels at production shapes")
            real = record_screen_codes(art, f"{art['chrom']}:1-50000")
            check_screen(real)
            check_device_baq(art)
            check_column_step()
        else:
            say("== --four-cards: sharded screen")
            check_sharded_screen()
        t0 = time.perf_counter()
        finish(ref, "host reference call")
        say("host reference call (all-exact, CPU) finished; waited",
            time.perf_counter() - t0)
        say("== phase 2: default call")
        check_call(art, host_vcf, os.path.join(td, "dev.vcf"))
        if indel_ref is not None:
            say("== phase 3: call --device-baq")
            res = check_call(art, host_vcf, os.path.join(td, "baq.vcf"),
                             ["--device-baq"])
            assert res["stages"].get("ingest.device_baq", 0.0) > 0, res
            say("== phase 4: call --call-indels")
            finish(indel_ref, "host reference call --call-indels")
            check_call(art, host_indel_vcf, os.path.join(td, "ind.vcf"),
                       ["--call-indels"])
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
