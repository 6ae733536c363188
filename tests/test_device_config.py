"""Device placement, compile-cache location and the peak-rate table."""

import os
import subprocess
import sys

import numpy as np
import pytest

from qpn_tpu.config import CHECKOUT_DIR, glue_dispatch_device


class TestGluePlacement:
    def test_glue_device_pins_cpu_on_accelerator(self, monkeypatch):
        import qpn_tpu.config as cfg
        monkeypatch.setattr(cfg.jax, "default_backend", lambda: "gpu")
        with glue_dispatch_device() as routed:
            assert routed
        monkeypatch.setattr(cfg.jax, "default_backend", lambda: "cpu")
        with glue_dispatch_device() as routed:
            assert not routed

    def test_solve_avi_runs_under_glue_placement(self, monkeypatch):
        """The per-QEP multi-start solve (the reference's serial PATH call)
        must route through the glue placement."""
        import contextlib
        import qpn_tpu.config as cfg
        from qpn_tpu.ops.avi import AVI, solve_avi, Status
        entered = []

        @contextlib.contextmanager
        def spy():
            entered.append(1)
            yield False
        monkeypatch.setattr(cfg, "glue_dispatch_device", spy)
        n = 4
        avi = AVI(M=np.eye(n), N=np.zeros((n, 1)), o=-np.ones(n),
                  l=np.full(n, -2.0), u=np.full(n, 2.0))
        z, status = solve_avi(avi, np.zeros(n), np.zeros(1))
        assert status == Status.SUCCESS
        assert np.allclose(z, 1.0, atol=1e-8)
        assert entered


def _cache_dir_in_fresh_process(env_value):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    env["PYTHONPATH"] = CHECKOUT_DIR + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c",
         "import qpn_tpu.config, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_follows_env_var(tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the only compile cache."""
    assert _cache_dir_in_fresh_process(str(tmp_path)) == str(tmp_path)


def test_compile_cache_defaults_into_checkout(monkeypatch):
    from qpn_tpu.config import default_compile_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert default_compile_cache_dir() is None
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    want = os.path.join(CHECKOUT_DIR, ".jax_cache")
    assert default_compile_cache_dir() == want
    assert _cache_dir_in_fresh_process(None) == want


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3"])
def test_peak_table_resolves_known_kinds(kind):
    from qpn_tpu.utils.flops import device_peaks
    p = device_peaks(kind)
    assert p["bf16"] > p["tf32"] > p["f32"] > 0 and p["hbm"] > 0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_rejects_unknown_kinds(kind):
    from qpn_tpu.utils.flops import device_peaks
    with pytest.raises(KeyError, match="no peak rates"):
        device_peaks(kind)
