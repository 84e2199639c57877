"""chip_smoke.py's contract where there is no GPU: it fails before
printing a result, and ``--four`` selects only its own phase."""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_exits_nonzero_without_a_gpu():
    proc = _run(ROOT, SCRIPT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    lone = shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    proc = _run(str(tmp_path), str(lone))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize(
    "argv,phases,need",
    [([], ("train", "serve", "band", "sampled"), 1), (["--four"], ("four",), 4)],
)
def test_phase_selection(argv, phases, need):
    mod = _load()
    assert mod.select_phases(mod.parse_args(argv)) == (phases, need)


def test_every_phase_is_registered():
    mod = _load()
    assert set(mod.PHASES) == set(mod.ONE_GPU_PHASES + mod.FOUR_GPU_PHASES)
