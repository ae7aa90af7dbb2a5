#!/usr/bin/env python3
"""Three-row engine matrix on the bench workload:
host engine / device screen / device BAQ — same workload, same schema,
identical-VCF asserted across all rows.

Usage: python tools/engine_matrix_bench.py [nruns]
Prints one JSON object {rows: [...], identical: bool}.
"""

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

GENOME = int(os.environ.get("LOFREQ_BENCH_GENOME", 200_000))
DEPTH = int(os.environ.get("LOFREQ_BENCH_DEPTH", 800))


def main():
    nruns = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    from simulate_fast import simulate_fast

    from lofreq_tpu.call.caller import VarcallConf
    from lofreq_tpu.core import stagetimer
    from lofreq_tpu.ops import screen as S
    from lofreq_tpu.pipelines.call_pipeline import run_call

    td = tempfile.mkdtemp()
    art = simulate_fast(td, genome_len=GENOME, depth=DEPTH, seed=3)

    ready = S.screen_ready(wait_s=float(
        os.environ.get("LOFREQ_BENCH_COMPILE_WAIT", "240")))

    rows = []
    vcfs = {}
    configs = [
        ("host-engine", VarcallConf(use_device_screen=False,
                                    use_device_baq=False)),
        ("device-screen", VarcallConf(use_device_screen=True,
                                      use_device_baq=False)),
        ("device-baq", VarcallConf(use_device_screen=True,
                                   use_device_baq=True)),
    ]
    for name, vconf in configs:
        import copy

        run_call(art["bam"], art["fa"], region=f"{art['chrom']}:1-6000",
                 vconf=copy.copy(vconf))  # warm per-engine compiles
        walls = []
        res = None
        d0 = S.DISPATCH_STATS["dispatched"]
        for _ in range(nruns):
            stagetimer.reset()
            t0 = time.time()
            res = run_call(art["bam"], art["fa"], vconf=copy.copy(vconf))
            walls.append(time.time() - t0)
        stages = stagetimer.report()
        vcfs[name] = [(v.pos, v.ref, v.alt, v.qual, v.info)
                      for v in res.vars]
        walls.sort()
        rows.append(dict(
            engine=name,
            cols_per_sec=round(GENOME / walls[len(walls) // 2], 1),
            best_cols_per_sec=round(GENOME / walls[0], 1),
            walls_s=[round(w, 3) for w in walls],
            screen_dispatches=S.DISPATCH_STATS["dispatched"] - d0,
            last_run_stages_s={k: round(v, 3)
                               for k, v in stages.items()},
        ))
    identical = (vcfs["host-engine"] == vcfs["device-screen"]
                 == vcfs["device-baq"])
    print(json.dumps(dict(screen_ready_at_start=ready, rows=rows,
                          identical=identical,
                          n_vars=len(vcfs["host-engine"]))))
    sys.stdout.flush()
    os._exit(0 if identical else 1)


if __name__ == "__main__":
    main()
