"""call-parallel keeps to one process per card: the parent initializes no
JAX backend before it forks, the workers run the host engine, and the
VCF records equal a single-process host call's."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[1] + "/tests")
from simulate_fast import simulate_fast
from lofreq_tpu.cli import main

art = simulate_fast(sys.argv[2], genome_len=12000, depth=60, seed=5)
par, one = sys.argv[2] + "/par.vcf", sys.argv[2] + "/one.vcf"
import lofreq_tpu.pipelines.parallel_call as PC
seen = []
orig = PC.run_parallel_regions

def spy(bam, ref, vconf_kw, pconf_kw, threads, **kw):
    # what the parent holds at the moment it forks
    xb = sys.modules.get("jax._src.xla_bridge")
    seen.append(bool(xb is not None and xb._backends))
    return orig(bam, ref, vconf_kw, pconf_kw, threads, **kw)

PC.run_parallel_regions = spy
worker = PC._worker

def worker_spy(job):
    # runs in the forked worker: did it stay off the device?
    res = worker(job)
    xb = sys.modules.get("jax._src.xla_bridge")
    with open(sys.argv[2] + "/workers.jsonl", "a") as fh:
        fh.write(json.dumps(dict(
            screen=job["vconf_kw"]["use_device_screen"],
            baq=job["vconf_kw"]["use_device_baq"],
            backend=bool(xb is not None and xb._backends))) + "\n")
    return res

PC._worker = worker_spy
rc_par = main(["call-parallel", "--pp-threads", "3", "--device-baq",
               "-f", art["fa"], "-o", par, art["bam"]])
xb = sys.modules.get("jax._src.xla_bridge")
after = bool(xb is not None and xb._backends)
rc_one = main(["call", "--no-device-screen", "-f", art["fa"], "-o", one,
               art["bam"]])
recs = lambda p: [l for l in open(p) if not l.startswith("#")]
workers = [json.loads(l) for l in open(sys.argv[2] + "/workers.jsonl")]
print(json.dumps(dict(rc=[rc_par, rc_one], at_fork=seen, after=after,
                      workers=workers, same=recs(par) == recs(one),
                      n=len(recs(one)))))
"""


def test_call_parallel_keeps_parent_off_the_device(tmp_path):
    # no JAX_PLATFORMS pin: with no backend touched, none is chosen
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", _SCRIPT, REPO,
                          str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rc"] == [0, 0]
    assert res["at_fork"] == [False]
    assert res["after"] is False
    assert res["same"] and res["n"] > 0
    assert len(res["workers"]) >= 3
    assert all(w == dict(screen=False, baq=False, backend=False)
               for w in res["workers"]), res["workers"]
