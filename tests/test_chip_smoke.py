"""chip_smoke.py: it refuses to run without a GPU, and its phases run end
to end on the CPU at tiny shapes (a rehearsal of what it checks on the
card; no timing here means anything)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = chip_smoke.Sizes(
    nodes=2000, dim=32, hidden=32, batch=32, fanout="4,3", cache_mb=16,
    window=4, max_steps=8, epochs=3, p_nodes=6000, p_dim=64,
    p_fanout="4,3,3", p_cache_mb=1, p_epochs=2, scratch_windows=3,
    agg_n_src=512, agg_n_dst=256, agg_fanout=10, agg_dim=32,
    four_warm_windows=1, four_windows=2, lr=1e-2)


@pytest.mark.parametrize("where", ["cpu_platform", "lone_directory"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    script, cwd = os.path.join(REPO, "chip_smoke.py"), REPO
    if where == "lone_directory":
        script = str(shutil.copy(script, tmp_path))
        cwd = str(tmp_path)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.fixture
def counter():
    return chip_smoke.CompileCounter()


@pytest.mark.parametrize("model_type", ["sage", "gat"])
def test_smoke_coverage_and_reference(model_type, counter, capsys):
    run = chip_smoke.phase_coverage(model_type, TINY, "cpu", counter, "cpu")
    chip_smoke.phase_reference(model_type, run)
    out = capsys.readouterr().out
    assert "losses finite, falling" in out
    assert "matches the reference" in out


def test_smoke_pressure_and_scratch(counter, capsys):
    chip_smoke.phase_pressure(TINY, "cpu", counter, "cpu")
    out = capsys.readouterr().out
    assert "pool vs fresh buffers bitwise equal" in out
    assert "[pressure/int8]" in out


def test_smoke_aggregate(capsys):
    chip_smoke.phase_aggregate(TINY, "cpu")
    assert capsys.readouterr().out.count("[aggregate]") == 4


def test_smoke_four_on_virtual_devices(counter, capsys):
    chip_smoke.phase_four(TINY, jax.devices(), counter, "cpu")
    out = capsys.readouterr().out
    for mode in ("sharded", "isolated", "node_local groups of 2"):
        assert f"[four/{mode}]" in out
    assert out.count(": exact") == 3
    assert "match" in out
