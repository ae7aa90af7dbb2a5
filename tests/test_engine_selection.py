"""Engine selection, compile-cache placement and the native build key.

The engine is decided in this process from JAX's backend (no probe
process, no link gates); the compile cache goes where
JAX_COMPILATION_CACHE_DIR says, else to one fixed path in the checkout;
the native library is keyed on its sources, compiler and host CPU.
"""

import os
import shutil

import numpy as np
import pytest

from lofreq_tpu import _native_build as NB
from lofreq_tpu import ops
from lofreq_tpu.ops import screen as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeJax:
    def __init__(self, backend):
        self._backend = backend

    def default_backend(self):
        return self._backend


@pytest.mark.parametrize("backend,want", [("gpu", True), ("cpu", False)])
def test_device_screen_follows_backend(monkeypatch, backend, want):
    monkeypatch.setattr(S, "_SCREEN_DEFAULT", None)
    monkeypatch.setattr(S, "_get_jax", lambda: (_FakeJax(backend), None))
    assert S.device_screen_default() is want
    # decided once per process
    monkeypatch.setattr(S, "_get_jax", lambda: (_FakeJax("gpu"), None))
    assert S.device_screen_default() is want


def test_unset_conf_follows_engine_selection(monkeypatch):
    from lofreq_tpu.call.caller import VarcallConf

    monkeypatch.setattr(S, "_SCREEN_DEFAULT", None)
    monkeypatch.setattr(S, "_get_jax", lambda: (_FakeJax("gpu"), None))
    assert VarcallConf().device_screen_on() is True
    assert VarcallConf(use_device_screen=False).device_screen_on() is False


@pytest.mark.parametrize("env", ["/some/where/else", None])
def test_compile_cache_placement(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert ops.jax_cache_dir() == os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert ops.jax_cache_dir() is None  # JAX reads the variable itself


def test_cpu_backend_keeps_cache_off(monkeypatch):
    import jax

    monkeypatch.setattr(ops, "_jax_cache_set", False)
    before = jax.config.jax_compilation_cache_dir
    ops.ensure_jax_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_native_build_key_changes_with_cpu_flags(monkeypatch):
    args = NB._compile_args()
    monkeypatch.setattr(NB, "_cpu_flags", lambda: "fpu sse2")
    a = NB.build_key(args)
    assert NB.build_key(args) == a
    monkeypatch.setattr(NB, "_cpu_flags", lambda: "fpu sse2 avx512f")
    assert NB.build_key(args) != a


def test_native_build_key_changes_with_sources(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(os.path.join(REPO, "csrc"), csrc,
                    ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(NB, "_CSRC", str(csrc))
    args = NB._compile_args()
    a = NB.build_key(args)
    with open(csrc / "realign_xw.inc", "a") as fh:
        fh.write("\n/* edited */\n")
    assert NB.build_key(args) != a
    assert NB.build_key(args + ["-DX"]) != NB.build_key(args)


def test_loaded_library_carries_its_key():
    lib = NB.get_native_lib()
    key = NB.build_key(NB._compile_args())
    assert os.path.basename(lib._name) == f"liblofreq_native-{key}.so"


def test_screen_on_gpu_matches_host(gpu):
    """On a card: the engine picks the device screen, and its mask at the
    production shape keeps every column the host f64 screen keeps."""
    from chip_smoke import random_codes

    assert S.device_screen_default() is True
    codes, ks, bonf = random_codes(np.random.default_rng(0), 4096)
    dev = S.screen_fetch(S.screen_dispatch_codes(codes, ks, bonf, 0.01))
    host = S.host_screen_tail_codes(codes, ks, bonf, 0.01)
    assert not (host & ~dev).any()
