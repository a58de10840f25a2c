"""The port's campaign entry against the pinned campaign values.

``python -m repro_torch.launch.campaign --device cpu`` runs the ``sim`` and
``search`` targets in a fresh process (the ``compiles`` counts are per
process, as the reference's jit caches are) and writes a
``repro.bench.v1`` trajectory; the JAX package's own gate,
``benchmarks/render_tables.py::check_bench``, must pass it against the
unmodified ``benchmarks/BENCH_pinned.json``.  The port reproduces the
reference bit for bit, so the pins hold at rtol 1e-6 as well as at the
gate's 5%, and every count of ``CHECK_COUNTS`` exactly.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import campaign  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PINNED = ROOT / "benchmarks" / "BENCH_pinned.json"


def _render_tables():
    """``benchmarks/render_tables.py``, which imports only the standard
    library, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "render_tables", ROOT / "benchmarks" / "render_tables.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """One run of the entry point on the CPU in a subprocess, with two
    planning workers; its trajectory's path and its stdout."""
    path = tmp_path_factory.mktemp("campaign") / "BENCH_torch.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_PLAN_WORKERS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.campaign", "--device",
         "cpu", "--bench-json", str(path)], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=600, check=True)
    return path, proc.stdout


def test_campaign_passes_the_pinned_gate(bench, capsys):
    path, _ = bench
    rt = _render_tables()
    assert rt.check_bench(str(path), str(PINNED)) == 0
    assert rt.check_bench(str(path), str(PINNED), rtol=1e-6) == 0
    assert "check-bench OK: 56 pinned sim metrics" in capsys.readouterr().out
    got = json.loads(path.read_text())["benches"]
    pins = json.loads(PINNED.read_text())["benches"]
    for name, pin in pins.items():
        for key, want in pin["metrics"].items():
            assert got[name]["metrics"][key] == pytest.approx(want, rel=1e-6,
                                                              abs=0), key
        for key in rt.CHECK_COUNTS:
            if key in pin:
                assert got[name][key] == pin[key], (name, key)
    assert (got["sim"]["plans"], got["sim"]["evals"], got["sim"]["runs"],
            got["sim"]["compiles"], got["sim"]["contended_compiles"],
            got["sim"]["plan_cache_hits"], got["sim"]["plan_cache_misses"]) \
        == (99, 891, 1208, 8, 1, 12, 87)
    assert (got["search"]["evals"], got["search"]["compiles"],
            got["search"]["buckets"], got["search"]["cells"]) == (2241, 3, 3, 6)


def test_the_gate_from_the_command_line(bench):
    path, _ = bench
    proc = subprocess.run(
        [sys.executable, "-m", "benchmarks.render_tables", "--check-bench",
         str(path), str(PINNED)], capture_output=True, text=True, cwd=ROOT,
        timeout=120, check=True)
    assert "# check-bench OK: 56 pinned sim metrics" in proc.stdout


def test_trajectory_records_the_pipeline_and_the_host(bench):
    path, out = bench
    doc = json.loads(path.read_text())
    assert doc["schema"] == "repro.bench.v1"
    assert doc["run"] == {"seed": 0, "full": False,
                          "targets": ["sim", "search"]}
    assert doc["host"]["backend"] == "cpu" and doc["host"]["device_count"] == 1
    sim = doc["benches"]["sim"]
    assert sim["plan_workers"] == 2 and sim["plan_build_s"] > 0
    assert 0 <= sim["overlap_frac"] < 1 and sim["build_wall_s"] > 0
    assert sim["lines"][0].startswith("sim/hlp_est,")
    # on the CPU the wrappers take the plain versions: no kernel launches;
    # one replay chunk per bucket (one device), one contended group
    assert sim["launches"] == {"replay": 0, "contention": 0,
                               "replay_chunks": sim["buckets"],
                               "contended_groups": 1}
    search = doc["benches"]["search"]["launches"]
    assert search["replay"] == search["contention"] == 0
    assert search["replay_chunks"] > 0 and search["contended_groups"] == 0
    assert doc["benches"]["search"]["wall_s"] > 0 and sim["wall_s"] > 0
    assert "# sim: 1208 runs over 24 scenarios" in out
    for csv_name in ("sim_sweep.csv", "search_sweep.csv"):
        assert (campaign.ART / csv_name).is_file()


def test_full_grid_raises_naming_the_missing_solver():
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        campaign.sim_sweep(full=True, device="cpu")


def test_entry_defaults_to_the_card_and_rejects_unknown_targets(monkeypatch,
                                                                tmp_path):
    assert campaign.main(["--only", "offline2", "--bench-json", ""]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        campaign.main(["--bench-json", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_partial_run_keeps_the_other_bench(tmp_path):
    path = str(tmp_path / "b.json")
    args = argparse.Namespace(seed=0, device="cpu")
    campaign.write_bench_json(path, args, ["sim"], {"sim": {"wall_s": 1.0}})
    campaign.write_bench_json(path, args, ["search"],
                              {"search": {"wall_s": 2.0}})
    doc = json.loads(open(path).read())
    assert doc["run"]["targets"] == ["search", "sim"]
    assert set(doc["benches"]) == {"sim", "search"}
    campaign.write_bench_json(path, argparse.Namespace(seed=1, device="cpu"),
                              ["search"], {"search": {"wall_s": 3.0}})
    assert set(json.loads(open(path).read())["benches"]) == {"search"}
