"""chip_smoke.py on the CPU: the rehearsal passes without a device result,
and with no GPU (or without the package beside it) the script fails without
printing the ok line."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import jax

import chip_smoke

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def own_cache(monkeypatch, tmp_path):
    """main() points the persistent compile cache at the env dir: keep it
    in a temp dir and restore the config afterwards."""
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    yield
    jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("flags", [[], ["--four-cards"]],
                         ids=["one_card", "four_cards"])
def test_rehearsal_passes_without_ok_line(own_cache, capsys, flags):
    assert chip_smoke.main(["--rehearse"] + flags) == 0
    out = capsys.readouterr().out
    assert '"ok"' not in out
    lines = [ln for ln in out.splitlines() if ln.startswith('{"phase"')]
    want = (chip_smoke.FOUR_CARD_PHASES if flags
            else chip_smoke.ONE_CARD_PHASES)
    assert len(lines) == len(want)
    key = "bit_exact_vs_card0" if flags else "cpu_slice_bit_exact"
    assert all(f'"{key}": true' in ln for ln in lines)


def test_refuses_without_gpu(own_cache, capsys):
    with pytest.raises(chip_smoke.SmokeFailure, match="GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_fails_alone_in_a_directory(tmp_path):
    """Copied away from the package, the script exits non-zero and prints
    no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
