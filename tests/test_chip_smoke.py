"""chip_smoke.py's phases at a tiny size on the CPU, each against its numpy
reference; the compile-cache helper; the bench's peak table."""
import os

import jax
import pytest

import bench
import chip_smoke as cs
from libgdf_tpu.utils import compile_cache

PHASES = {
    "filter": lambda: cs.phase_filter(3000, reps=1),
    "join_inner": lambda: cs.phase_join_inner(3000, 400, reps=1),
    "join_left": lambda: cs.phase_join_left(3000, 400, reps=1),
    "join_dup": lambda: cs.phase_join_dup(3000, 800, reps=1),
    "join_full": lambda: cs.phase_join_full(3000, 800, reps=1),
    "groupby": lambda: cs.phase_groupby(3000, 100, reps=1),
    "window": lambda: cs.phase_window(3000, 40, reps=1),
    "orderby": lambda: cs.phase_orderby(3000, reps=1),
}


@pytest.mark.parametrize("phase", list(PHASES))
def test_phase_matches_reference(phase):
    line = PHASES[phase]()
    assert line["phase"] == phase
    assert line["checks"] and line["ok"], line["checks"]
    assert line["steady_s"] > 0 and line["compile_s"] > 0


def test_dist_phase_plain_and_salted_agree():
    lines = cs.phase_dist(4, 1500, ndim=500, reps=1)
    assert [x["phase"] for x in lines] == [
        "dist_plain", "dist_salted", "dist_plain_vs_salted"]
    for line in lines:
        assert line["ok"], line["checks"]


def test_failed_check_is_reported():
    import numpy as np
    bad = cs._exact("x", np.arange(3), np.arange(3) + 1)
    assert not bad["ok"] and bad["max_diff"] == 1.0
    loose = cs._bounded("y", [1.0, 2.0], [1.0, 2.5], 0.1, "test")
    assert not loose["ok"] and loose["max_diff"] == 0.5


def test_main_refuses_a_cpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "needs a GPU" in out.err


@pytest.fixture
def cache_config():
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes")}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_default_dir(cache_config, monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == compile_cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == path
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")


def test_compile_cache_env_var_wins(cache_config, monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_peak_table_knows_the_h100():
    assert bench.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200", "NVIDIA A100-SXM4-40GB"])
def test_peak_table_refuses_unknown_devices(kind):
    with pytest.raises(ValueError, match="no published memory bandwidth"):
        bench.peak_bytes_per_s(kind)
