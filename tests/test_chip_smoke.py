"""chip_smoke.py: refuses to run without a GPU, and its phases hold at a
tiny size on the CPU (called directly; the script has no CPU mode)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_without_gpu(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:  # a directory that holds chip_smoke.py and nothing else
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("smoke"))
    art = C.simulate(td, genome_len=6000, depth=150)
    refs = {}
    procs = {name: C.start_host_reference(art, os.path.join(td, name),
                                          flags)
             for name, flags in (("host.vcf", []),
                                 ("host_indels.vcf", ["--call-indels"]))}
    for name, p in procs.items():
        C.finish(p, name)
        refs[name] = os.path.join(td, name)
    art["refs"] = refs
    art["td"] = td
    return art


def test_screen_phase(art):
    real = C.record_screen_codes(art, f"{art['chrom']}:1-6000")
    assert real and all(r[0].shape[1] == 128 for r in real)
    out = C.check_screen(real, n_batches=2, B=256)
    assert out["misses"] == 0 and out["production_columns"] > 0


def test_screen_phase_catches_a_miss(art, monkeypatch):
    """A screen that drops candidates must fail the phase."""
    from lofreq_tpu.ops import screen as S

    monkeypatch.setattr(S, "screen_fetch",
                        lambda h: np.zeros(h[1], bool))
    with pytest.raises(AssertionError, match="dropped"):
        C.check_screen([], n_batches=1, B=256)


def test_device_baq_phase(art):
    out = C.check_device_baq(art, n=128)
    assert out["reads"] == 128 and out["max_delta"] <= 6


def test_column_step_phase():
    out = C.check_column_step(B=128, D=64)
    assert out["columns"] == 128


@pytest.mark.parametrize("flags,ref", [
    ((), "host.vcf"),
    (("--device-baq",), "host.vcf"),
    (("--call-indels",), "host_indels.vcf"),
])
def test_call_phases(art, flags, ref):
    # the CPU backend's default engine is the host one: force the screen
    res = C.check_call(art, art["refs"][ref],
                       os.path.join(art["td"], "dev.vcf"),
                       ("--device-screen", *flags))
    assert res["screen_dispatched"] > 0 and res["records"] > 0
    if "--device-baq" in flags:
        assert res["stages"].get("ingest.device_baq", 0.0) > 0


def test_sharded_screen_phase():
    C.check_sharded_screen(B=1024)
