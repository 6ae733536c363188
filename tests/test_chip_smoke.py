"""chip_smoke.py: it refuses to run without a GPU, and its phases' checks
hold at tiny sizes on the CPU (the card runs them at full width)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from qpn_tpu.config import CHECKOUT_DIR

sys.path.insert(0, CHECKOUT_DIR)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_to_run_without_a_gpu(tmp_path, where):
    script = os.path.join(CHECKOUT_DIR, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_golden_phase():
    assert chip_smoke.phase_golden(points=(0, 5, 7)) == {"points": 3}


def test_zoo_phase_compares_devices():
    out = chip_smoke.phase_zoo(models=chip_smoke.ZOO[1:])
    assert out["four_player_matrix_game"]["x_diff"] <= 1e-6


def test_flagship_phase_tiny():
    out = chip_smoke.phase_flagship(S=8, runs=1, interpret=True)
    assert out["conv"] == 1.0 and out["primal_diff"] <= 1e-6
    assert out["kernel_vs_xla"]["z_diff"] <= 1e-6


def test_shared_and_superstep_phases_tiny():
    from qpn_tpu.parallel.mesh import make_mesh
    out, batch, _ = chip_smoke.phase_shared(S=8, T=2, num_obj=1, ref_lanes=4)
    assert out["conv"] == 1.0 and out["primal_diff"] <= 1e-6
    s = chip_smoke.phase_superstep(batch, make_mesh(1))
    assert s["frac"] == 1.0 and s["keep"].any()


@pytest.mark.parametrize("resid,want", [
    ([1e-6, 1e-7, 0.0], [False, True, True]),     # smaller residual wins
    ([1e-9, 1e-10, 0.0], [True, False, True]),    # certified: lowest index
])
def test_keep_reference_drops_duplicates(resid, want):
    z = np.array([[0.0, 1.0], [0.0, 1.0], [0.5, 1.0]])
    l, u = np.zeros((3, 2)), np.ones((3, 2))
    keep = chip_smoke.keep_reference(z, np.array(resid), l, u, tol=1e-8)
    assert keep.tolist() == want


def test_multicard_phase_on_virtual_devices():
    out = chip_smoke.phase_multicard(S=16, T=2, num_obj=1, n_devices=4)
    assert out["superstep_dz"] <= 1e-8 and out["shared_dz"] <= 1e-8
