"""Region-parallel calling: the reference's only parallelism strategy
(lofreq2_call_pparallel.py), rebuilt in-process.

Genome regions are binned from the BAM header (read-free chroms skipped),
the largest bin is bisected greedily until max bin < total/(2*threads),
bins run as independent call workers (multiprocessing across host cores;
forked workers run the host engine, so no worker opens the card), per-bin
test counts are *summed globally* before the final quality filter — the
same two-phase dynamic-Bonferroni structure as the reference — and
per-bin variant lists are concatenated in BAM chromosome order.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import sys

import numpy as np

from ..core.phred import prob_to_phred
from ..filt.filter import FilterConf, MtcFilter, run_filter
from ..io.bai import BaiIndex, build_bai
from ..io.bam import BamReader
from ..io.vcf import VcfWriter, new_header

BIN_PER_THREAD = 2
log = logging.getLogger("lofreq_tpu")
_HOST_ENGINE_LOGGED = False


def bins_from_bamheader(bam_path):
    """[(chrom, start, end)] per chromosome with mapped reads
    (bins_from_bamheader, lofreq2_call_pparallel.py:270-299)."""
    rdr = BamReader(bam_path)
    bai_path = str(bam_path) + ".bai"
    if not os.path.exists(bai_path):
        build_bai(bam_path)
    idx = BaiIndex.load(bai_path)
    bins = []
    for tid, (name, length) in enumerate(rdr.header.references):
        mapped, _un = idx.mapped_unmapped(tid)
        if mapped == 0:
            continue
        bins.append((name, 0, length))
    chrom_order = [name for name, _l in rdr.header.references]
    rdr.close()
    return bins, chrom_order


def split_bins(bins, threads):
    """Greedy bisection of the largest bin (lofreq2_call_pparallel.py:595)."""
    total = sum(e - s for _c, s, e in bins)
    if total == 0:
        return bins
    target = total / (BIN_PER_THREAD * threads)
    bins = list(bins)
    while True:
        bins.sort(key=lambda b: b[2] - b[1], reverse=True)
        chrom, s, e = bins[0]
        if (e - s) <= target or (e - s) < 2:
            break
        mid = s + (e - s) // 2
        bins[0] = (chrom, s, mid)
        bins.append((chrom, mid, e))
    return bins


def sort_bins(bins, chrom_order):
    order = {c: i for i, c in enumerate(chrom_order)}
    return sorted(bins, key=lambda b: (order.get(b[0], 1 << 30), b[1]))


def _worker(job):
    from ..call.caller import VarcallConf
    from ..io.bed import BedIndex
    from ..pileup.engine import PileupConf
    from .call_pipeline import run_call

    vconf = VarcallConf(**job["vconf_kw"])
    pconf = PileupConf(**job["pconf_kw"])
    bed = BedIndex.read(job["bed_path"]) if job["bed_path"] else None
    region = f"{job['chrom']}:{job['start'] + 1}-{job['end']}"
    res = run_call(job["bam"], job["ref"], vconf=vconf, pconf=pconf,
                   region=region, bed=bed, ign_pos=job.get("ign_pos"))
    return ([v.to_line() for v in res.vars], res.stats.num_snv_tests,
            res.stats.num_indel_tests)


def make_job(bam, ref, chrom, start, end, vconf_kw, pconf_kw,
             bed_path=None, ign_pos=None):
    """Worker job record — keyed, so new fields can't be silently
    dropped by positional callers."""
    return dict(bam=str(bam), ref=str(ref), chrom=chrom, start=start,
                end=end, vconf_kw=vconf_kw, pconf_kw=pconf_kw,
                bed_path=bed_path, ign_pos=ign_pos)


def run_parallel_regions(bam_path, ref_path, vconf_kw, pconf_kw, threads,
                         bed_path=None, pool=None, ign_pos=None):
    """Returns (lines-in-order, num_snv_tests, num_indel_tests).
    ign_pos: chrom -> set of 0-based positions for -S source-qual."""
    bins, chrom_order = bins_from_bamheader(bam_path)
    bins = split_bins(bins, threads)
    bins = sort_bins(bins, chrom_order)
    jobs = [make_job(bam_path, ref_path, c, s, e, vconf_kw, pconf_kw,
                     bed_path, ign_pos) for c, s, e in bins]
    if threads > 1:
        # one process per card: a JAX process reserves most of the card's
        # memory, and a CUDA context does not survive fork.  So the parent
        # touches no JAX backend before forking, and the workers run the
        # host engine (same VCF; see call/caller.py:_screen_dispatch_sub)
        global _HOST_ENGINE_LOGGED
        if not _HOST_ENGINE_LOGGED:
            _HOST_ENGINE_LOGGED = True
            log.info("region-parallel call: %d worker processes run the "
                     "host engine; no worker opens the device", threads)
        for j in jobs:
            j["vconf_kw"] = dict(j["vconf_kw"], use_device_screen=False,
                                 use_device_baq=False)
        ctx = mp.get_context("fork")
        # process-parallel workers each get a single native BAQ thread —
        # region parallelism already saturates the cores
        prev = os.environ.get("LOFREQ_NATIVE_THREADS")
        os.environ["LOFREQ_NATIVE_THREADS"] = "1"
        try:
            with ctx.Pool(threads) as p:
                results = p.map(_worker, jobs)
        finally:
            if prev is None:
                os.environ.pop("LOFREQ_NATIVE_THREADS", None)
            else:
                os.environ["LOFREQ_NATIVE_THREADS"] = prev
    else:
        results = [_worker(j) for j in jobs]
    lines = []
    n_snv = 0
    n_indel = 0
    for ls, s, i in results:
        lines.extend(ls)
        n_snv += s
        n_indel += i
    return lines, n_snv, n_indel


def load_ign_vcfs(paths: str):
    """chrom -> set of positions from a comma-separated vcf list (-S)."""
    from ..io.vcf import VcfReader

    ign = {}
    for path in paths.split(","):
        if not os.path.exists(path):
            print(f"FATAL: ign-vcf file {path} does not exist",
                  file=sys.stderr)
            raise SystemExit(1)
        with VcfReader(path) as rdr:
            for v in rdr:
                ign.setdefault(v.chrom, set()).add(v.pos)
    return ign


def run_call_parallel(args, extra) -> int:
    """CLI glue for `call-parallel` (mirrors the wrapper's restrictions:
    no -r/--plp-summary-only under the parallel driver)."""
    from ..call.caller import VarcallConf

    if args.region:
        print("FATAL: regions not allowed with call-parallel",
              file=sys.stderr)
        return 1
    if args.plp_summary_only:
        print("FATAL: --plp-summary-only not allowed with call-parallel",
              file=sys.stderr)
        return 1
    from ..cli import confs_from_args

    vconf, pconf = confs_from_args(args)
    vconf_kw = {k: getattr(vconf, k) for k in vconf.__dataclass_fields__}
    pconf_kw = {k: getattr(pconf, k) for k in pconf.__dataclass_fields__
                if k != "bed"}
    ign_pos = load_ign_vcfs(args.ign_vcf) if getattr(
        args, "ign_vcf", None) else None
    lines, n_snv, n_indel = run_parallel_regions(
        args.bam, args.ref, vconf_kw, pconf_kw, args.pp_threads,
        bed_path=args.bed, ign_pos=ign_pos,
    )
    return finalize_parallel_output(lines, n_snv, n_indel, args, vconf,
                                    tool="call-parallel")


def finalize_parallel_output(lines, n_snv, n_indel, args, vconf,
                             tool="call-parallel") -> int:
    """Merge worker VCF lines, apply the final filter with the globally
    summed test counts, emit the load-bearing counter lines."""
    from ..io.vcf import Var

    vars_ = [Var.from_line(l) for l in lines]
    header = new_header(f"lofreq_tpu {tool}", args.ref)

    cfg = FilterConf(no_defaults=args.no_default_filter)
    if vconf.bonf_dynamic:
        # mirror the wrapper script's OWN arithmetic
        # (lofreq2_call_pparallel.py:54-70,697-709): python-double
        # division, round-half-even, prob==0 -> MAXINT, bonf 0 -> 1 —
        # note round() where the C auto-filter truncates
        import math

        def _script_phred(bonf: int) -> int:
            prob = float(vconf.sig) / float(max(bonf, 1))
            if prob == 0.0:
                return 2**31 - 1
            return int(round(-10.0 * math.log10(prob)))

        cfg.snvqual = MtcFilter(thresh=_script_phred(n_snv))
        cfg.indelqual = MtcFilter(thresh=_script_phred(n_indel))
    header, out_vars = run_filter(header, vars_, cfg)
    with VcfWriter(args.out, header) as w:
        for v in out_vars:
            w.write(v)
    if str(args.out).endswith(".gz"):
        # tabix the merged output like the reference wrapper's
        # `bcftools index -t` step (lofreq2_call_pparallel.py:164-185)
        from ..io.tabix import build_tbi

        build_tbi(args.out)
    print(f"Number of substitution tests performed: {n_snv}",
          file=sys.stderr)
    print(f"Number of indel tests performed: {n_indel}", file=sys.stderr)
    return 0
