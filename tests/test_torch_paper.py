"""The paper's §6 experiments in the port's campaign entry, against the
reference.

``repro_torch.launch.campaign``'s ``offline_2type`` (Fig. 3/4),
``offline_3type`` (Fig. 5) and ``online_2type`` (Fig. 6/7) run beside
``benchmarks/campaign.py``'s on a tiny grid (``instances`` and
``OFFLINE_CONFIGS_2`` replaced in both modules, each module's ``ART`` a
temporary directory): the returned dicts, the CSVs without the
``lp_seconds`` timing column, the targets' lines without their µs column
and the ``#   paper claims`` prints must be equal.  A run over the
planning pool must equal a serial one, and the entry point must land the
dicts in its trajectory.

The default grid (34 instances, 544 runs an experiment) takes the reference
about 4 minutes here, so its outputs are pinned in
``tests/torch_paper_pin.json``, with the placement planner's plans on the
full published configs, and ``chip_smoke.py`` holds the port to the pin on
the card (where there is no JAX).  The pin was written by::

  JAX_PLATFORMS=cpu PYTHONPATH=src:. python -c "import tests.test_torch_paper as t; t.write_pin()"
"""
import base64
import contextlib
import csv
import hashlib
import io
import json
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import benchmarks.campaign as RC  # noqa: E402
import benchmarks.run as RR  # noqa: E402
import repro.core.workloads as RW  # noqa: E402
import repro_torch.core.workloads as TW  # noqa: E402
from repro_torch.launch import campaign as TC  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PIN = ROOT / "tests" / "torch_paper_pin.json"

#: target -> (campaign function, the CSVs it writes)
EXPERIMENTS = {
    "offline2": ("offline_2type", ("offline_2type.csv",)),
    "offline3": ("offline_3type", ("offline_3type.csv",)),
    "online": ("online_2type", ("online_2type.csv",
                                "online_competitive_curve.csv")),
}
TINY_CONFIGS_2 = [(16, 2), (32, 8), (64, 16), (128, 4)]
#: the placement planner's platforms: the 3-pod one of
#: ``tests/test_substrate.py::test_pipeline_plan_respects_q_q1_bound`` and
#: a 2-pod one (hosts as the paper's CPUs, fast pods as its GPUs), so
#: both ``solve_qhlp`` and ``solve_hlp`` run
PLATFORMS = {"3pod": [("fast", 2, 1e12, 1e11), ("mid", 2, 4e11, 5e10),
                      ("slow", 4, 1e11, 2e10)],
             "2pod": [("host", 8, 1e11, 2e10), ("fast", 2, 1e12, 1e11)]}
PLACEMENT_ARCHS = ("granite-3-2b", "qwen2-1.5b")
PLACEMENT_STREAMS = (1, 6)


def _tiny(workloads):
    """A 3-instance grid: potrf nb=5 at block 64, a getrf, a fork-join."""
    def instances(full, num_types=2):
        yield ("potrf_n5_b64", "potrf",
               workloads.chameleon("potrf", 5, 64, num_types))
        yield ("getrf_n5_b320", "getrf",
               workloads.chameleon("getrf", 5, 320, num_types))
        yield ("forkjoin_w20_p2", "forkjoin",
               workloads.fork_join(20, 2, num_types))
    return instances


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """Both campaign modules on the tiny grid, their CSVs under
    ``tmp_path``; returns the two CSV directories."""
    ref, port = tmp_path / "ref", tmp_path / "port"
    for mod, wl, art in ((RC, RW, str(ref)), (TC, TW, port)):
        monkeypatch.setattr(mod, "instances", _tiny(wl))
        monkeypatch.setattr(mod, "OFFLINE_CONFIGS_2", TINY_CONFIGS_2)
        monkeypatch.setattr(mod, "ART", art)
    return ref, port


def jsonable(r: dict) -> dict:
    """An experiment's dict as a trajectory holds it, timings dropped."""
    return json.loads(json.dumps({k: v for k, v in r.items()
                                  if k != "alg_seconds"}))


def _claims(out: str) -> list[str]:
    return [line for line in out.splitlines() if line.startswith("#   ")]


def _reference_target(target: str):
    """The reference's target through ``benchmarks/run.py``: its dict,
    lines and ``#   `` prints."""
    fn_name = EXPERIMENTS[target][0]
    fn, got = getattr(RC, fn_name), {}

    def keep(*a, **kw):
        got["r"] = fn(*a, **kw)
        return got["r"]
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RC, fn_name, keep)
        with contextlib.redirect_stdout(buf):
            lines = getattr(RR, f"bench_{target}")(False)
    return got["r"], lines, _claims(buf.getvalue())


@pytest.mark.parametrize("target", list(EXPERIMENTS))
def test_experiment_equals_the_reference(target, tiny, capsys):
    """Equal dicts, CSV rows (without ``lp_seconds``), lines (without µs)
    and paper-claims prints on the tiny grid."""
    ref_dir, port_dir = tiny
    want, want_lines, want_claims = _reference_target(target)
    capsys.readouterr()
    lines, extras = TC.BENCHES[target](False, 0, "cpu")
    claims = _claims(capsys.readouterr().out)
    runs = 3 * (16 if target == "offline3" else len(TINY_CONFIGS_2))
    assert want["runs"] == extras["runs"] == runs
    got = {k: v for k, v in extras.items() if k != "csv"}
    assert jsonable(got) == jsonable(want)
    assert TC.without_us(lines) == TC.without_us(want_lines)
    assert claims == want_claims and claims
    for name in EXPERIMENTS[target][1]:
        digest = TC.csv_digest(ref_dir / name)
        assert TC.csv_digest(port_dir / name) == digest
        assert extras["csv"][name] == {"rows": digest[0], "sha256": digest[1]}


def test_pooled_runs_equal_serial_runs(tiny):
    """Two planning workers against one: every experiment's dict and CSVs
    the same (the pool's jobs come back in the reference's order)."""
    _, port_dir = tiny
    from repro_torch.obs import registry as obs
    broken = obs.counter_value("plan_pool.broken")
    for fn_name, csvs in EXPERIMENTS.values():
        fn = getattr(TC, fn_name)
        serial = jsonable(fn(workers=1))
        digests = [TC.csv_digest(port_dir / name) for name in csvs]
        assert jsonable(fn(workers=2)) == serial
        assert [TC.csv_digest(port_dir / name) for name in csvs] == digests
    assert obs.counter_value("plan_pool.broken") == broken


def test_entry_point_lands_the_experiments_in_its_trajectory(tiny, tmp_path,
                                                             capsys):
    """``--only offline2,offline3,online --device cpu`` writes one
    trajectory whose extras carry each experiment's dict and CSV digests,
    and launches no kernel."""
    _, port_dir = tiny
    path = tmp_path / "BENCH.json"
    assert TC.main(["--only", "offline2,offline3,online", "--device", "cpu",
                    "--bench-json", str(path)]) == 0
    doc = json.loads(path.read_text())
    assert doc["run"]["targets"] == ["offline2", "offline3", "online"]
    for target, (fn_name, csvs) in EXPERIMENTS.items():
        b = doc["benches"][target]
        assert b["wall_s"] > 0 and len(b["lines"]) >= 5
        assert set(b["launches"].values()) == {0}
        r = jsonable(getattr(TC, fn_name)(workers=1))
        assert {k: v for k, v in b.items() if k in r} == r
        for name in csvs:
            rows, digest = TC.csv_digest(port_dir / name)
            assert b["csv"][name] == {"rows": rows, "sha256": digest}
    assert "online/erls_vs_eft" in capsys.readouterr().out


def test_targets_and_defaults():
    """The new targets are registered; a run without ``--only`` still runs
    ``sim`` and ``search`` alone (what ``BENCH_pinned.json`` pins); the
    ``kernels`` target lands its µs a call on the CPU without a launch."""
    assert set(TC.BENCHES) == {"offline2", "offline3", "online", "sim",
                               "search", "streams", "solver", "kernels"}
    assert TC.DEFAULT_TARGETS == ("sim", "search")
    before = TC._launches()
    lines, extras = TC.bench_kernels(False, 0, "cpu")
    assert TC._launches() == before
    assert set(extras["us_per_call"]) == {line.split(",")[0]
                                          for line in lines}
    assert set(extras["us_per_call"]) == {"kernels/maxplus_256x256x256",
                                          "kernels/flash_attn_s512"}
    # each case's error against its plain version (0 here: the wrappers
    # take the plain versions on the CPU)
    assert set(extras["cases"]) == set(extras["us_per_call"])
    for c in extras["cases"].values():
        assert c["max_abs_err"] == c["err_vs_plain"] == 0 and c["ref_us"] > 0
    assert extras["cases"]["kernels/flash_attn_s512"]["shape"] == [
        2, 512, 4, 4, 64]
    from repro_torch.launch.kernel_bench import err_vs_plain
    want = torch.tensor([0.0, 1.0, -3.0], dtype=torch.float64)
    got = want + torch.tensor([0.0, 2e-5, 0.0], dtype=torch.float64)
    assert err_vs_plain(got, want) == pytest.approx(1e-5)
    assert TC.without_us(["a/b,123,x=1;y=2"]) == ["a/b,x=1;y=2"]


def test_pin_is_well_formed():
    """The pin holds each experiment of the default grid (544 runs, its
    dict, CSV rows and digests, lines and claims) and 8 placement plans;
    it is not re-run here."""
    pin = json.loads(PIN.read_text())
    for target, (_, csvs) in EXPERIMENTS.items():
        p = pin[target]
        assert p["result"]["runs"] == 544
        assert "alg_seconds" not in p["result"]
        assert set(p["csv"]) == set(csvs)
        for c in p["csv"].values():
            assert len(c["sha256"]) == 64 and c["rows"] > 0
        assert p["csv"][csvs[0]]["rows"] == 544
        assert len(p["lines"]) in (5, 6) and p["claims"]
        assert all(line.startswith(target + "/") for line in p["lines"])
        if target == "online":
            continue
        # the offline experiments' rows give back their dicts, and each
        # row's allocation has its instance's task count
        rows = [[v if i < 2 else float(v) for i, v in enumerate(row)]
                for row in p["rows"]]
        summary = (TC.offline2_summary if target == "offline2"
                   else TC.offline3_summary)
        assert json.loads(json.dumps(summary(rows))) == p["result"]
        # under the CSV's header the rows hash to the pinned digest, which
        # chip_smoke.py holds a CSV with rows reconciled from the pin to
        head = (["instance", "app", "m", "k", "lp_star", "hlp_est",
                 "hlp_ols", "heft"] if target == "offline2" else
                ["instance", "app", "m", "k1", "k2", "lp_star", "qhlp_est",
                 "qhlp_ols", "qheft"])
        buf = io.StringIO()
        csv.writer(buf).writerows([head] + p["rows"])
        assert hashlib.sha256(buf.getvalue().encode()).hexdigest() == \
            p["csv"][csvs[0]]["sha256"]
        sizes = [g.n for _, _, g in TC.instances(False)
                 for _ in range(16)]
        packed = np.frombuffer(zlib.decompress(base64.b64decode(
            p["alloc"])), np.int8)
        assert packed.size == sum(sizes) and packed.max() == \
            (1 if target == "offline2" else 2)
    assert pin["offline2"]["result"]["ratios"]["hlp_ols"] < \
        pin["offline2"]["result"]["ratios"]["hlp_est"]
    assert set(pin["online"]["result"]["curve"]) == {
        "1.0", "1.41", "2.0", "2.83", "4.0", "5.66", "8.0"}
    plans = pin["placement"]
    assert len(plans) == len(PLACEMENT_ARCHS) * len(PLATFORMS) * len(
        PLACEMENT_STREAMS)
    for p in plans:
        assert p["arch"] in PLACEMENT_ARCHS and p["streams"] in (1, 6)
        assert (p["seq"], p["batch"]) == (4096, 8)
        assert len(p["assignment"]) > 0 and p["makespan"] >= p["lp_bound"] > 0
        q = len(p["pods"])
        assert p["makespan"] <= q * (q + 1) * p["lp_bound"]


def test_default_grid_equals_the_pin(monkeypatch, tmp_path, capsys):
    """The port's entry on the default grid (34 instances, 544 runs an
    experiment) with ``--device cpu`` equals the pin exactly: every dict,
    every CSV digest (so no LP lands on another vertex than the
    reference's on this host's HiGHS), the lines and the claims.  Where
    ``chip_smoke.py`` finds rows on another vertex, the host's HiGHS is
    the cause, not the port."""
    monkeypatch.setattr(TC, "ART", tmp_path)
    monkeypatch.setenv("REPRO_PLAN_WORKERS", "4")
    path = tmp_path / "BENCH.json"
    capsys.readouterr()
    assert TC.main(["--only", "offline2,offline3,online", "--device", "cpu",
                    "--bench-json", str(path)]) == 0
    claims = _claims(capsys.readouterr().out)
    pin = json.loads(PIN.read_text())
    benches = json.loads(path.read_text())["benches"]
    for target in EXPERIMENTS:
        b, p = benches[target], pin[target]
        assert {k: b[k] for k in p["result"]} == p["result"], target
        assert b["csv"] == p["csv"], target
        assert TC.without_us(b["lines"]) == p["lines"], target
    assert claims == [c for t in EXPERIMENTS for c in pin[t]["claims"]]


def reference_placement() -> list[dict]:
    """The reference's plans on the full published configs: each arch x
    platform x streams at its defaults (seq 4096, batch 8)."""
    from repro.configs import get_config
    from repro.core.placement import PodType, plan_pipeline
    out = []
    for arch in PLACEMENT_ARCHS:
        for pods in PLATFORMS.values():
            for streams in PLACEMENT_STREAMS:
                plan = plan_pipeline(get_config(arch),
                                     [PodType(*p) for p in pods],
                                     streams=streams)
                out.append({"arch": arch, "pods": [list(p) for p in pods],
                            "seq": 4096, "batch": 8, "streams": streams,
                            "assignment": [int(a) for a in plan.assignment],
                            "makespan": float(plan.makespan),
                            "lp_bound": float(plan.lp_bound)})
    return out


def csv_rows(path) -> list[list[str]]:
    """A CSV's data rows without the ``lp_seconds`` column, as text."""
    with open(path, newline="") as f:
        table = list(csv.reader(f))
    keep = [i for i, name in enumerate(table[0]) if name != "lp_seconds"]
    return [[row[i] for i in keep] for row in table[1:]]


def pack_allocs(allocs) -> str:
    """Allocations (one int array a row) as base64 of their zlib-packed
    int8 concatenation; ``chip_smoke.py`` unpacks them by the instances'
    task counts."""
    raw = np.concatenate([np.asarray(a, np.int8) for a in allocs]).tobytes()
    return base64.b64encode(zlib.compress(raw, 9)).decode()


def write_pin(path: Path = PIN) -> None:
    """Run the reference's three experiments on the default grid through
    ``benchmarks/run.py``'s targets and its placement planner, and write
    what the port is held to (the command is in the module docstring):
    each experiment's dict, CSV digests, lines and claims, and for the two
    offline ones their CSV rows and each row's LP allocation, which
    ``chip_smoke.py`` reads where the card's host's HiGHS returns another
    optimal vertex."""
    import tempfile
    pin = {}
    with tempfile.TemporaryDirectory() as art, pytest.MonkeyPatch.context() \
            as mp:
        mp.setattr(RC, "ART", art)
        allocs = []
        for name in ("solve_hlp", "solve_qhlp"):
            def keep(*a, _fn=getattr(RC, name), **kw):
                sol = _fn(*a, **kw)
                allocs.append(sol.alloc)
                return sol
            mp.setattr(RC, name, keep)
        for target, (_, csvs) in EXPERIMENTS.items():
            allocs.clear()
            r, lines, claims = _reference_target(target)
            pin[target] = {
                "result": jsonable(r),
                "csv": {name: dict(zip(("rows", "sha256"), TC.csv_digest(
                    Path(art) / name))) for name in csvs},
                "lines": TC.without_us(lines), "claims": claims}
            if target != "online":
                pin[target]["rows"] = csv_rows(Path(art) / csvs[0])
                assert len(allocs) == r["runs"]
                pin[target]["alloc"] = pack_allocs(allocs)
            print(f"{target}: {r['runs']} runs", flush=True)
    pin["placement"] = reference_placement()
    path.write_text(json.dumps(pin, indent=1, sort_keys=True) + "\n")
