#!/usr/bin/env python3
"""Host ingest throughput: BGZF decode -> native fill -> fused columns.

Reports rows/s and columns/s for the host side of the call pipeline (the
part that must keep the device fed) at 1..N threads, on a synthetic BAM.
SURVEY §7 "htslib decode must not starve chips".

Usage: python tools/ingest_bench.py [genome_len] [depth]
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main():
    genome = int(sys.argv[1]) if len(sys.argv) > 1 else 400_000
    depth = int(sys.argv[2]) if len(sys.argv) > 2 else 150
    import tempfile

    import numpy as np  # noqa: F401

    from simulate_fast import simulate_fast

    from lofreq_tpu.call.caller import VarcallConf
    from lofreq_tpu.io.bam import BamReader
    from lofreq_tpu.pileup.engine import PileupConf
    from lofreq_tpu.pileup.fast_columns import build_snv_batch
    from lofreq_tpu.pileup.native_ingest import (SlabPool, ingest_region,
                                                 raw_records_for_region)

    with tempfile.TemporaryDirectory() as td:
        art = simulate_fast(td, genome_len=genome, depth=depth, seed=3)
        rdr = BamReader(art["bam"])
        with open(art["fa"]) as fh:
            ref = "".join(l.strip() for l in fh
                          if not l.startswith(">")).encode()
        pconf = PileupConf()
        vconf = VarcallConf(use_device_screen=False)
        WINDOW = 100_000
        for nth in (1, 4, 8):
            os.environ["LOFREQ_NATIVE_THREADS"] = str(nth)
            pool = SlabPool(2)
            cpool = SlabPool(2)
            rows_total = 0
            t_raw = t_fill = t_cols = 0.0
            for rep in range(2):  # rep 0 warms the slab pools
                if rep == 1:
                    rows_total = 0
                    t_raw = t_fill = t_cols = 0.0
                for win in range(0, genome, WINDOW):
                    hi = min(win + WINDOW, genome)
                    t0 = time.perf_counter()
                    raw = raw_records_for_region(rdr, 0, win, hi)
                    t_raw += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    rows = ingest_region(rdr, pconf, ref, 0, beg=win,
                                         end=hi, raw=raw, pool=pool)
                    t_fill += time.perf_counter() - t0
                    rows_total += len(rows.pos)
                    t0 = time.perf_counter()
                    build_snv_batch(rows, rows.raw_flags, win, hi, ref,
                                    art["chrom"], pconf, vconf, pool=cpool)
                    t_cols += time.perf_counter() - t0
            total = t_raw + t_fill + t_cols
            print(json.dumps(dict(
                threads=nth,
                rows_per_sec=round(rows_total / total, 0),
                cols_per_sec=round(genome / total, 0),
                raw_s=round(t_raw, 2), fill_s=round(t_fill, 2),
                columns_s=round(t_cols, 2))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
