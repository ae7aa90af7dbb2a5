#!/usr/bin/env python3
"""End-to-end benchmark: full BAM -> VCF `call` on the default engine.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

value      = pileup columns/sec through the COMPLETE default `call`
             pipeline (BGZF decode -> native ingest/BAQ -> fused column
             build -> device screen -> exact
             confirmation -> VCF records) on a synthetic BAM.  MEDIAN of
             N timed runs after a warm-up region (kernel compiles
             amortized); the min/max spread is reported in "unit".
vs_baseline = median over runs of (cols_i / ref_i), where ref_i is a
             single-core reference-C measurement INTERLEAVED right
             after timed run i — the reference's OWN kernels
             (snpcaller.c plp_to_errprobs+qsort+snpcaller per column,
             bam_md_ext.c/kprobaln_ext.c BAQ per read), compiled
             unmodified from /root/reference (tests/oracle/
             bench_ref.c).  Pairwise co-sampling matters on this host:
             hypervisor-steal bursts last minutes, so a denominator
             measured before the runs can see a different machine than
             they do.  The denominator EXCLUDES the reference's BAM
             decode/pileup/VCF costs, so the ratio understates the
             true end-to-end speedup.  When the reference checkout is
             absent the fallback denominator is this repo's own
             single-thread no-device path (reported in "unit").
             Correctness: the device run's VCF records must be
             identical to the single-core no-device run's.

BASELINE.md driver metric: "pileup columns/sec; end-to-end wall-clock vs
C LoFreq".
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

GENOME = int(os.environ.get("LOFREQ_BENCH_GENOME", 200_000))
DEPTH = int(os.environ.get("LOFREQ_BENCH_DEPTH", 800))
READLEN = 100
# 7 runs: each timed run is only ~2-5s and this host's hypervisor-steal
# bursts can eat 1-2 of them; a median over 7 is robust to two outliers
# while the adaptive wall budget still bounds the total
NRUNS = int(os.environ.get("LOFREQ_BENCH_RUNS", 7))
REPO = os.path.dirname(os.path.abspath(__file__))


def simulate(tmpdir):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from simulate_fast import simulate_fast

    return simulate_fast(tmpdir, genome_len=GENOME, depth=DEPTH, seed=3)


def build_bench_ref(tmpdir):
    """Compile the single-core reference-C kernel bench
    (tests/oracle/bench_ref.c over the reference's own kernels).
    Returns the exe path, or None when the checkout is absent."""
    if not os.path.isdir("/root/reference/src/lofreq"):
        return None
    exe = os.path.join(tmpdir, "bench_ref")
    try:
        subprocess.run(
            [os.path.join(REPO, "tests", "oracle", "build_bench_ref.sh"),
             exe],
            capture_output=True, check=True, timeout=120)
        return exe
    except Exception:
        return None


def reference_c_once(exe):
    """One reference-C measurement (cols/s), or None on failure."""
    try:
        out = subprocess.run(
            [exe, str(DEPTH), str(READLEN), str(GENOME), "4000"],
            capture_output=True, text=True, check=True, timeout=120)
        return float(json.loads(out.stdout)["ref_cols_per_sec"])
    except Exception:
        return None


def baseline_single_core(art):
    """Single-core, device-off run in a fresh process (the repo's own
    reference-equivalent path; provides the identical-VCF oracle and the
    fallback denominator).  Run before this process touches jax so its
    client threads can't steal the core."""
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from lofreq_tpu.call.caller import VarcallConf\n"
        "from lofreq_tpu.pipelines.call_pipeline import run_call\n"
        "t0 = time.time()\n"
        f"res = run_call({art['bam']!r}, {art['fa']!r},\n"
        "    vconf=VarcallConf(use_device_screen=False,\n"
        "                      use_device_baq=False))\n"
        "print(json.dumps({'wall': time.time() - t0,\n"
        "    'vars': [(v.pos, v.ref, v.alt, v.qual, v.info)"
        " for v in res.vars],\n"
        "    'tests': res.stats.num_snv_tests}))\n"
    )
    env = dict(os.environ, LOFREQ_NATIVE_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def device_run(art, ref_exe=None):
    """Default call (device engine on a GPU), warmed then timed NRUNS times.

    Records, per run, the wall AND the stagetimer breakdown; the engine
    decisions are OBSERVED from the stage counters (a stage that never
    ran never appears), not inferred from the gate predicates — so the
    JSON states what the timed runs actually executed."""
    from lofreq_tpu.call.caller import VarcallConf
    from lofreq_tpu.core import stagetimer
    from lofreq_tpu.pipelines.call_pipeline import run_call

    chrom = art["chrom"]
    # settle every engine decision BEFORE the timed region: an
    # unresolved screen compile would land inside a timed run
    from lofreq_tpu.ops.screen import device_screen_default, screen_ready

    compile_pending = False
    if device_screen_default():
        # compile the screen now with a BOUNDED budget; past the cap the
        # bench proceeds on the host engine, records compile_pending,
        # and the screen may still adopt late mid-run (column batches
        # are independent; adoption never changes output).  The bench
        # must always terminate with a JSON (see test_bench_bounded.py).
        wait = float(os.environ.get("LOFREQ_BENCH_COMPILE_WAIT", "240"))
        compile_pending = not screen_ready(wait_s=wait)
    # warm-up: same depth/read-length -> compiles the same kernel buckets
    run_call(art["bam"], art["fa"], region=f"{chrom}:1-6000",
             vconf=VarcallConf())
    walls = []
    ref_rates = []
    stage_reports = []
    res = None
    # adaptive run count: keep total timed wall ~bounded even when the
    # host is degraded (steal) or a late compile thread is burning CPU
    budget_s = float(os.environ.get("LOFREQ_BENCH_WALL_BUDGET", "120"))
    for i in range(NRUNS):
        stagetimer.reset()
        t0 = time.time()
        res = run_call(art["bam"], art["fa"], vconf=VarcallConf())
        walls.append(time.time() - t0)
        stage_reports.append(stagetimer.report())
        # co-sampled denominator: hypervisor-steal bursts last minutes,
        # so a reference-C measurement taken minutes before the timed
        # runs can see a different machine than they do — interleave
        # one single-core reference run after each timed run and use
        # PAIRWISE ratios (median over i of cols_i / ref_i)
        if ref_exe is not None:
            r = reference_c_once(ref_exe)
            ref_rates.append(r if r else None)
        if sum(walls) + walls[-1] > budget_s and len(walls) >= 3:
            break
    n_runs = len(walls)
    med_i = sorted(range(n_runs), key=lambda i: walls[i])[n_runs // 2]
    stages = stage_reports[med_i]
    from lofreq_tpu.ops.screen import DISPATCH_STATS

    baq_s = sum(r.get("ingest.device_baq", 0.0) for r in stage_reports)
    engine = {
        # real dispatch accounting, not stage presence (the stage wraps
        # the call even when the screen is off and returns instantly)
        "device_screen": DISPATCH_STATS["dispatched"] > 0,
        "screen_dispatches": DISPATCH_STATS["dispatched"],
        "screen_unavailable": DISPATCH_STATS["unavailable"],
        "device_baq": baq_s > 0.05,
        "compile_pending": compile_pending,
    }
    import jax

    dev = jax.devices()[0]
    engine.update(backend=dev.platform, device_kind=dev.device_kind,
                  device_count=len(jax.devices()))
    # lists, not tuples: the baseline's came through a JSON round-trip
    return dict(walls=walls, ref_rates=ref_rates, stages=stages,
                engine=engine,
                vars=[[v.pos, v.ref, v.alt, v.qual, v.info]
                      for v in res.vars],
                tests=res.stats.num_snv_tests)


def main():
    with tempfile.TemporaryDirectory() as td:
        art = simulate(td)
        ref_exe = build_bench_ref(td)
        base = baseline_single_core(art)
        dev = device_run(art, ref_exe=ref_exe)
        if base["vars"] != dev["vars"] or base["tests"] != dev["tests"]:
            print(json.dumps({"metric": "end_to_end_call_columns_per_sec",
                              "value": 0, "unit": "MISMATCH vs baseline",
                              "vs_baseline": 0}))
            return 1
        wall = statistics.median(dev["walls"])
        cols_per_sec = GENOME / wall
        pairs = [(GENOME / w, r) for w, r in
                 zip(dev["walls"], dev["ref_rates"]) if r]
        if pairs:
            ratios = sorted(c / r for c, r in pairs)
            vs = ratios[len(ratios) // 2]
            med_ref = statistics.median(r for _c, r in pairs)
            denom = (f"PAIRWISE co-sampled single-core reference-C "
                     f"kernels (one ref run interleaved after each "
                     f"timed run, median ratio; ref median "
                     f"{med_ref:.0f} cols/s, tests/oracle/bench_ref.c "
                     "— excludes ref BAM/pileup/VCF costs, so the "
                     "ratio understates)")
        else:
            vs = base["wall"] / wall
            denom = ("repo's own single-thread no-device path "
                     "(reference checkout absent)")
        eng = dev["engine"]
        spread = (f"median of {len(dev['walls'])}, "
                  f"min {GENOME / max(dev['walls']):.0f} / "
                  f"max {GENOME / min(dev['walls']):.0f} cols/s")
        engine_s = (f"engine observed during timed runs: "
                    f"backend={eng.get('backend')}, "
                    f"device_screen={'on' if eng.get('device_screen') else 'off'}, "
                    f"device_baq={'on' if eng.get('device_baq') else 'off'}")
        result = json.dumps({
            "metric": "end_to_end_call_columns_per_sec",
            "value": round(cols_per_sec, 1),
            "unit": (f"cols/s, {GENOME//1000}kb@{DEPTH}x BAM->VCF, default "
                     f"call, {spread}; identical VCF vs single-core run; "
                     f"{engine_s}; vs_baseline = value / {denom}"),
            "vs_baseline": round(vs, 2),
            "runs_wall_s": [round(w, 3) for w in dev["walls"]],
            "ref_rates_cols_s": [round(r, 1) if r else None
                                 for r in dev["ref_rates"]],
            "median_run_stages_s": dev["stages"],
            "engine": eng,
        })
    # tempdir is cleaned up; print and leave WITHOUT interpreter teardown:
    # a still-running compile thread is non-daemon, and joining it at
    # exit could stall the harness
    print(result)
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
