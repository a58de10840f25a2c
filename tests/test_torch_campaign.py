"""The port's campaign entry against the pinned campaign values.

``python -m repro_torch.launch.campaign --device cpu`` runs the ``sim`` and
``search`` targets in a fresh process (the ``compiles`` counts are per
process, as the reference's jit caches are) and writes a
``repro.bench.v1`` trajectory; the JAX package's own gate,
``benchmarks/render_tables.py::check_bench``, must pass it against the
unmodified ``benchmarks/BENCH_pinned.json``.  The port reproduces the
reference bit for bit, so the pins hold at rtol 1e-6 as well as at the
gate's 5%, and every count of ``CHECK_COUNTS`` exactly.

``--full --only sim`` runs the reference's full grid, ``hlp_jax_ols``
(the first-order LP) among its static adapters, against
``tests/torch_sim_full_pin.json``: the reference's own trajectory of the
same grid, written on the CPU with ROADMAP C1's workaround by::

  JAX_PLATFORMS=cpu PYTHONPATH=src REPRO_PLAN_WORKERS=4 python -c "import jax, jax.experimental; jax.experimental.enable_x64 = lambda: jax.enable_x64(True); import sys; sys.argv = ['run', '--only', 'sim', '--full', '--bench-json', 'tests/torch_sim_full_pin.json']; from benchmarks import run; run.main()"
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
FULL_PIN = ROOT / "tests" / "torch_sim_full_pin.json"


def _render_tables():
    """``benchmarks/render_tables.py``, which imports only the standard
    library, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "render_tables", ROOT / "benchmarks" / "render_tables.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_entry(path, *args):
    """The entry point on the CPU in a subprocess, with two planning
    workers; its stdout."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_PLAN_WORKERS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.campaign", "--device",
         "cpu", "--bench-json", str(path), *args], capture_output=True,
        text=True, env=env, cwd=ROOT, timeout=600, check=True)
    return proc.stdout


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """One default run; its trajectory's path and its stdout."""
    path = tmp_path_factory.mktemp("campaign") / "BENCH_torch.json"
    return path, _run_entry(path)


@pytest.fixture(scope="module")
def full_bench(tmp_path_factory):
    """One run of the full sim grid; its trajectory's path and stdout."""
    path = tmp_path_factory.mktemp("campaign_full") / "BENCH_torch_full.json"
    return path, _run_entry(path, "--full", "--only", "sim")


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
    assert sim["launches"] == {"replay": 0, "contention": 0, "hlp_fo": 0,
                               "maxplus": 0, "flash": 0,
                               "replay_chunks": sim["buckets"],
                               "contended_groups": 1}
    search = doc["benches"]["search"]["launches"]
    assert search["replay"] == search["contention"] == 0
    assert search["replay_chunks"] > 0 and search["contended_groups"] == 0
    assert doc["benches"]["search"]["wall_s"] > 0 and sim["wall_s"] > 0
    assert "# sim: 1208 runs over 24 scenarios" in out
    for csv_name in ("sim_sweep.csv", "search_sweep.csv"):
        assert (campaign.ART / csv_name).is_file()


def test_full_grid_passes_its_pin(full_bench, capsys):
    path, _ = full_bench
    rt = _render_tables()
    assert rt.check_bench(str(path), str(FULL_PIN)) == 0
    assert rt.check_bench(str(path), str(FULL_PIN), rtol=1e-6) == 0
    assert "check-bench OK: 53 pinned sim metrics" in capsys.readouterr().out


def test_full_grid_holds_every_metric_at_rtol_1e6(full_bench):
    path, _ = full_bench
    got = json.loads(path.read_text())["benches"]["sim"]["metrics"]
    pins = json.loads(FULL_PIN.read_text())["benches"]["sim"]["metrics"]
    assert len(pins) == 45 and set(got) == set(pins)
    for key, want in pins.items():
        assert got[key] == pytest.approx(want, rel=1e-6, abs=0), key
    assert got["hlp_jax_ols"] == pytest.approx(1.0372892216722764, rel=1e-6)


def test_full_grid_counts_are_the_references(full_bench):
    path, _ = full_bench
    sim = json.loads(path.read_text())["benches"]["sim"]
    pin = json.loads(FULL_PIN.read_text())["benches"]["sim"]
    for key in _render_tables().CHECK_COUNTS:
        if key in pin:
            assert sim[key] == pin[key], key
    assert (sim["plans"], sim["evals"], sim["runs"], sim["scenarios"],
            sim["compiles"], sim["contended_compiles"],
            sim["plan_cache_hits"], sim["plan_cache_misses"]) \
        == (224, 7392, 10496, 48, 8, 2, 24, 200)


def test_full_trajectory_records_the_grid_and_the_first_order_adapter(
        full_bench):
    path, out = full_bench
    doc = json.loads(path.read_text())
    assert doc["run"] == {"seed": 0, "full": True, "targets": ["sim"]}
    sim = doc["benches"]["sim"]
    assert any(line.startswith("sim/hlp_jax_ols,") for line in sim["lines"])
    # on the CPU the first-order LP takes the plain version: no launches
    assert sim["launches"]["hlp_fo"] == 0
    assert "# sim: 10496 runs over 48 scenarios" in out
    assert "full=True" in out


def test_the_gate_from_the_command_line_on_the_full_pin(full_bench):
    path, _ = full_bench
    proc = subprocess.run(
        [sys.executable, "-m", "benchmarks.render_tables", "--check-bench",
         str(path), str(FULL_PIN)], capture_output=True, text=True, cwd=ROOT,
        timeout=120, check=True)
    assert "# check-bench OK: 53 pinned sim metrics" in proc.stdout


def test_a_full_run_keeps_only_benches_of_a_full_file(tmp_path):
    path = str(tmp_path / "b.json")
    quick = argparse.Namespace(seed=0, device="cpu", full=False)
    full = argparse.Namespace(seed=0, device="cpu", full=True)
    campaign.write_bench_json(path, quick, ["search"], {"search": {}})
    campaign.write_bench_json(path, full, ["sim"], {"sim": {}})
    doc = json.loads(open(path).read())
    assert doc["run"] == {"seed": 0, "full": True, "targets": ["sim"]}
    campaign.write_bench_json(path, full, ["solver"], {"solver": {}})
    doc = json.loads(open(path).read())
    assert set(doc["benches"]) == {"sim", "solver"}
    assert doc["run"]["full"] is True


def test_solver_target_runs_highs_against_the_first_order_lp(capsys):
    lines, extras = campaign.bench_solver(False, 0, "cpu")
    names = [line.split(",")[0] for line in lines]
    assert names == ["solver/potrf10_exact", "solver/potrf10_jax",
                     "solver/getrf10_exact", "solver/getrf10_jax"]
    for name, inst in extras["instances"].items():
        # λ of the first-order iterate is feasible: never below HiGHS's
        assert inst["first_order_lp"] >= inst["lp"] - 1e-9, name
        assert 0 <= inst["gap_pct"] < 3, name
        assert inst["exact_s"] > 0 and inst["first_order_s"] > 0
    assert extras["instances"]["potrf10"]["n"] == 220
    assert "# solver potrf10 (n=220): HiGHS" in capsys.readouterr().out


def test_entry_defaults_to_the_card_and_rejects_unknown_targets(monkeypatch,
                                                                tmp_path):
    # roofline waits for the sharding and launch port (ROADMAP A10)
    assert campaign.main(["--only", "roofline", "--bench-json", ""]) == 2
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
