"""End-to-end SNV calling tests on simulated data, mirroring the oracle
style of the reference's denv2 tests (0 false positives, high sensitivity)."""

import numpy as np
import pytest

from lofreq_tpu.call.caller import VarcallConf
from lofreq_tpu.pileup.engine import PileupConf
from lofreq_tpu.pipelines.call_pipeline import call_and_filter, run_call
from simulate import simulate


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sim")
    return simulate(str(tmp), genome_len=6000, depth=800, seed=11)


@pytest.fixture(scope="module")
def called(sim, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("out")
    vconf = VarcallConf(use_baq=False, use_idaq=False)
    pconf = PileupConf(use_baq=False, use_idaq=False)
    out = str(tmp / "out.vcf")
    res = call_and_filter(sim["bam"], sim["fa"], out, vconf=vconf, pconf=pconf)
    return res, out


def test_snv_call_sensitivity_specificity(sim, called):
    res, _ = called
    got = {(v.pos, v.ref, v.alt) for v in res.vars if not v.is_indel()}
    truth = {(pos, ref, alt) for pos, ref, alt, af, kind, cnt, dp
             in sim["truth"] if kind == "snv"}
    truth_pos = {t[0] for t in truth}
    fps = [c for c in got if c not in truth and c[0] not in truth_pos]
    assert not fps, f"false positives: {sorted(fps)[:10]}"
    # sensitivity: variants whose realized alt count is >= 1% of depth
    want = {(pos, ref, alt) for pos, ref, alt, af, kind, cnt, dp
            in sim["truth"] if kind == "snv" and dp and cnt / dp >= 0.01
            and cnt >= 8}
    missed = want - got
    assert not missed, f"missed detectable SNVs: {sorted(missed)}"
    assert res.stats.num_snv_tests > 0
    assert res.stats.num_snv_tests % 3 == 0


def test_call_with_baq(sim, tmp_path):
    vconf = VarcallConf(use_baq=True, use_idaq=False)
    pconf = PileupConf(use_baq=True, use_idaq=False)
    out = str(tmp_path / "baq.vcf")
    res = call_and_filter(sim["bam"], sim["fa"], out, vconf=vconf, pconf=pconf)
    got = {(v.pos, v.ref, v.alt) for v in res.vars if not v.is_indel()}
    truth = {(pos, ref, alt) for pos, ref, alt, af, kind, cnt, dp
             in sim["truth"] if kind == "snv"}
    truth_pos = {t[0] for t in truth}
    fps = [c for c in got if c not in truth and c[0] not in truth_pos]
    assert not fps
    # BAQ should call fewer or equal variants (baq-calls-less-than-nobaq.sh)
    want = {(pos, ref, alt) for pos, ref, alt, af, kind, cnt, dp
            in sim["truth"] if kind == "snv" and dp and cnt / dp >= 0.02}
    assert not want - got


def test_call_region_subset(sim):
    vconf = VarcallConf(use_baq=False, use_idaq=False)
    pconf = PileupConf(use_baq=False, use_idaq=False)
    res_all = run_call(sim["bam"], sim["fa"], vconf=vconf, pconf=pconf)
    region = f"{sim['chrom']}:2001-4000"
    res_reg = run_call(sim["bam"], sim["fa"],
                       vconf=VarcallConf(use_baq=False, use_idaq=False),
                       pconf=PileupConf(use_baq=False, use_idaq=False),
                       region=region)
    want = {(v.pos, v.ref, v.alt) for v in res_all.vars
            if 2000 <= v.pos < 4000}
    got = {(v.pos, v.ref, v.alt) for v in res_reg.vars}
    assert got == want


def test_vcf_output_format(called):
    _res, out = called
    lines = open(out).read().splitlines()
    assert lines[0] == "##fileformat=VCFv4.0"
    assert any(l.startswith("#CHROM\tPOS") for l in lines)
    data = [l for l in lines if not l.startswith("#")]
    assert data, "no variants in output VCF"
    f = data[0].split("\t")
    assert f[6] == "PASS"
    assert f[7].startswith("DP=")
    assert ";DP4=" in f[7]
    pos = [int(l.split("\t")[1]) for l in data]
    assert pos == sorted(pos)


def test_af_accuracy(sim, called):
    """AF in the VCF equals realized counts / coverage (cf. af_tests.sh)."""
    res, _ = called
    by_key = {(v.pos, v.alt): v for v in res.vars if not v.is_indel()}
    for pos, ref, alt, af, kind, cnt, dp in sim["truth"]:
        if kind != "snv" or not dp or cnt / dp < 0.05:
            continue
        v = by_key.get((pos, alt))
        assert v is not None, (pos, alt)
        _found, af_s = v.info_value("AF")
        got = float(af_s)
        want = cnt / dp
        assert abs(got - want) < 0.03, (pos, want, got)


def test_device_screen_equivalence(sim, called, tmp_path):
    """Calls with the device screening path must equal the all-exact path."""
    res_exact, _ = called
    vconf = VarcallConf(use_baq=False, use_idaq=False, use_device_screen=True)
    pconf = PileupConf(use_baq=False, use_idaq=False)
    out = str(tmp_path / "screen.vcf")
    res_scr = call_and_filter(sim["bam"], sim["fa"], out, vconf=vconf,
                              pconf=pconf)
    a = [v.to_line() for v in res_exact.vars]
    b = [v.to_line() for v in res_scr.vars]
    assert a == b
    assert res_scr.stats.num_snv_tests == res_exact.stats.num_snv_tests


def test_bonf_auto_vs_fixed(sim, called, tmp_path):
    """Dynamic vs precomputed-bonferroni give identical output
    (tests/bonf_auto_vs_dyn.sh)."""
    res_dyn, _ = called
    fixed = res_dyn.stats.num_snv_tests  # final factor the dynamic run used
    vconf = VarcallConf(use_baq=False, use_idaq=False, bonf_dynamic=False,
                        bonf_subst=fixed, bonf_indel=fixed)
    out = str(tmp_path / "fixedbonf.vcf")
    res_fix = call_and_filter(sim["bam"], sim["fa"], out, vconf=vconf,
                              pconf=PileupConf(use_baq=False, use_idaq=False))
    a = [v.to_line() for v in res_dyn.vars]
    b = [v.to_line() for v in res_fix.vars]
    assert a == b


def test_no_indel_calls_on_indel_free_bam(sim, tmp_path):
    """Indel-free BAM -> 0 indel calls (tests/indel_misc.sh)."""
    vconf = VarcallConf(use_baq=False, use_idaq=True, no_indels=False)
    pconf = PileupConf(use_baq=False, use_idaq=True, collect_indels=True)
    out = str(tmp_path / "ind.vcf")
    res = call_and_filter(sim["bam"], sim["fa"], out, vconf=vconf,
                          pconf=pconf)
    indels = [v for v in res.vars if v.is_indel()]
    assert not indels


def test_indel_errprobs_bit_exact_vs_reference():
    """_indel_errprobs reproduces plp_to_{ins,del}_errprobs bit-exactly
    (golden from the reference oracle, tests/oracle/oracle_indel.c),
    including the quirks: non-event reads keep MQ=255 unmapped, IDAQ only
    for the candidate key, event MQ 255 -> -1."""
    import json
    import os
    from types import SimpleNamespace

    from lofreq_tpu.call.caller import VarcallConf, _indel_errprobs

    path = os.path.join(os.path.dirname(__file__), "golden",
                        "indel_errprobs.json")
    with open(path) as fh:
        golden = json.load(fh)
    assert len(golden) == 120
    for entry in golden:
        c = entry["case"]
        conf = VarcallConf(
            use_mq=bool(c["flags"] & 1),
            use_idaq=bool(c["flags"] & 2),
            use_sq=bool(c["flags"] & 4),
        )
        q_ne = [iq for iq, _mq in c["neq"]]
        mq_ne = [mq for _iq, mq in c["neq"]]
        neq = (q_ne, mq_ne, [0] * len(q_ne))
        events = {}
        for ekey, rows in c["events"]:
            ev = events.setdefault(ekey, SimpleNamespace(
                quals=[], aln_quals=[], map_quals=[], source_quals=[]))
            for iq, aq, mq, sq in rows:
                ev.quals.append(iq)
                ev.aln_quals.append(aq)
                ev.map_quals.append(mq)
                ev.source_quals.append(sq)
        got = _indel_errprobs(neq, events, c["key"], conf,
                              is_ins=c["mode"] == 0)
        want = [float.fromhex(h) for h in entry["probs_hex"]]
        assert len(got) == entry["n"]
        # the oracle's contract is the exact double MULTISET sorted with a
        # strict comparator (oracle_indel.c:dbl_cmp_asc); our vector is
        # eps-qsorted, which can swap eps-tied values — compare strictly
        # sorted (the eps ordering itself is exercised by the call_snvs
        # differential and the end-to-end identity tests)
        assert sorted(float(x) for x in got) == want, (c, got, want)


def test_window_size_and_engine_invariance(tmp_path, monkeypatch):
    """run_call output (records AND test counts) must be invariant to the
    streaming window width and to the screening engine state: the window
    is pure implementation geometry (25kb default, retuned r4), and every
    screen is conservative + exact-confirmed.  Pins the invariants the
    r4 window/pipe retune relies on."""
    import lofreq_tpu.pipelines.call_pipeline as cp

    art = simulate(str(tmp_path), genome_len=24_000, depth=200, seed=5)
    vconf = VarcallConf()

    def call_with(window, screen_env):
        monkeypatch.setattr(cp, "WINDOW", window)
        monkeypatch.setenv("LOFREQ_TPU_BAQ_SCREEN", screen_env)
        res = cp.run_call(art["bam"], art["fa"], vconf=VarcallConf())
        return ([(v.pos, v.ref, v.alt, v.qual, v.info) for v in res.vars],
                res.stats.num_snv_tests)

    base = call_with(25_000, "1")
    assert base == call_with(7_000, "1")      # window partitions a call
    assert base == call_with(100_000, "1")    # old default
    assert base == call_with(25_000, "0")     # screening engine off
    assert base[0], "simulation should yield calls for a meaningful test"
