"""The port's ``streams`` target (``repro_torch.launch.campaign``) against
the JAX package's ``benchmarks/campaign.py::streams_campaign`` and
``benchmarks/run.py::bench_streams``.

* the port's grid at ``full=False`` on the CPU, in this process, equal to
  the reference's: the dict with ``==`` on every float (the replay-shape
  count aside, which depends on what ran earlier in a process), the CSV
  rows and the 16 lines without their µs column;
* the pin ``tests/torch_streams_pin.json``, the reference's outputs written
  each from a fresh process (its ``compiles`` count is per process): the
  port's entry ``python -m repro_torch.launch.campaign --only streams``
  (and ``--full``) in a fresh process on the CPU equal to it, and a fresh
  run of the reference equal to it; the pin's Chameleon stream (32 jobs,
  31,196 tasks on (32, 4), ``sim_in_the_loop`` at 8 noisy rollout seeds
  and ``er_ls``), which ``chip_smoke.py`` runs on the card, well formed;
* the target, ``streams_campaign`` and ``SimInTheLoop`` default to the card
  and raise without one.

Remake the pin with (about a minute; the reference on this CPU)::

  JAX_PLATFORMS=cpu PYTHONPATH=src:. python -c \\
      "import tests.test_torch_streams_campaign as t; t.write_pin()"
"""
import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import benchmarks.campaign as RC  # noqa: E402
import repro_torch.launch.campaign as TC  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PIN = ROOT / "tests" / "torch_streams_pin.json"
#: the Chameleon stream at a size a shared cluster serves: the
#: configuration ``chip_smoke.py`` reads from the pin
CHAMELEON = {"apps": ["potrf", "getrf", "potri"], "num_jobs": 32,
             "nb_blocks": [10, 16], "block_size": 320, "num_tenants": 4,
             "rate": 0.02, "seed": 0, "machine": [32, 4], "noise": 0.2,
             "rollout_seeds": 8}

_REFERENCE_GRID = """
import json, sys, tempfile
import benchmarks.campaign as C
import benchmarks.run as R
import repro.streams.policy as P
from repro_torch.launch.campaign import csv_digest, rollout_digest, without_us
sweeps = []
sweep = P.sweep_suite_makespans
def kept(*args, **kw):
    out = sweep(*args, **kw)
    sweeps.append(out)
    return out
P.sweep_suite_makespans = kept
box = {}
orig = C.streams_campaign
def keep(**kw):
    box["r"] = orig(**kw)
    return box["r"]
C.streams_campaign = keep
with tempfile.TemporaryDirectory() as art:
    C.ART = art
    lines = R.bench_streams(sys.argv[1] == "full", 0)
    rows, digest = csv_digest(art + "/streams_campaign.csv")
r = box["r"]
out = {"mean_slowdown": {f"{p}/{q}": v for (p, q), v in
                         r["mean_slowdown"].items()},
       "sitl_vs_erls_bursty": r["sitl_vs_erls_bursty"],
       "policies": r["policies"], "processes": r["processes"],
       "runs": r["runs"], "jobs": r["jobs"], "compiles": r["compiles"],
       "csv": {"rows": rows, "sha256": digest},
       "lines": without_us(lines), **rollout_digest(sweeps)}
print("PIN " + json.dumps(out))
"""

_REFERENCE_CHAMELEON = """
import json, sys
import repro.streams.policy as P
from repro.sim import NoiseModel
from repro.sim.batch import trace_count
from repro.sim.engine import Machine
from repro.streams import SimInTheLoop, chameleon_stream, make_policy, run_stream
from repro_torch.launch.campaign import rollout_digest, stream_summary
sweeps = []
sweep = P.sweep_suite_makespans
def kept(*args, **kw):
    out = sweep(*args, **kw)
    sweeps.append(out)
    return out
P.sweep_suite_makespans = kept
cfg = json.loads(sys.argv[1])
pol = (SimInTheLoop(rollout_seeds=range(cfg["rollout_seeds"]),
                    rollout_noise=NoiseModel("lognormal", cfg["noise"]))
       if sys.argv[2] == "sim_in_the_loop" else make_policy(sys.argv[2]))
src = chameleon_stream(tuple(cfg["apps"]), num_jobs=cfg["num_jobs"],
                       nb_blocks=tuple(cfg["nb_blocks"]),
                       block_size=cfg["block_size"],
                       num_tenants=cfg["num_tenants"], rate=cfg["rate"],
                       seed=cfg["seed"])
res = run_stream(src, Machine.hybrid(*cfg["machine"]), pol,
                 noise=NoiseModel("lognormal", cfg["noise"]), seed=cfg["seed"])
out = stream_summary(res)
out["traces"] = trace_count("bucket")
out["decisions"] = [list(d) for d in getattr(pol, "decisions", [])]
out.update(rollout_digest(sweeps))
print("PIN " + json.dumps(out))
"""


def _env():
    return {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
            "JAX_PLATFORMS": "cpu"}


def _fresh(script: str, *args: str) -> dict:
    """Run ``script`` in a fresh interpreter; its ``PIN`` line's JSON."""
    run = subprocess.run([sys.executable, "-c", script, *args], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    line, = [x for x in run.stdout.splitlines() if x.startswith("PIN ")]
    return json.loads(line[4:])


def write_pin(path: Path = PIN) -> None:
    """The reference's default and full grids (``benchmarks/run.py``'s
    ``streams`` target, each in a fresh process) and its Chameleon stream
    under ``sim_in_the_loop`` and ``er_ls`` (each in a fresh process), each
    with the digest of every rollout's makespans: what the port is held
    to."""
    pin = {"default": _fresh(_REFERENCE_GRID, "default"),
           "full": _fresh(_REFERENCE_GRID, "full"),
           "chameleon": {"config": CHAMELEON}}
    for pol in ("sim_in_the_loop", "er_ls"):
        pin["chameleon"][pol] = _fresh(_REFERENCE_CHAMELEON,
                                       json.dumps(CHAMELEON), pol)
        print(pol, pin["chameleon"][pol]["mean_slowdown"], flush=True)
    path.write_text(json.dumps(pin, indent=1, sort_keys=True) + "\n")


def _pin() -> dict:
    return json.loads(PIN.read_text())


def _csv_rows(path) -> list[list[str]]:
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _port_entry(tmp_path, *args) -> dict:
    out = tmp_path / "bench.json"
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.campaign",
                          "--only", "streams", "--device", "cpu", *args,
                          "--bench-json", str(out)], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(out.read_text())["benches"]["streams"]


def _held_to(got: dict, want: dict) -> None:
    for key in ("mean_slowdown", "sitl_vs_erls_bursty", "policies",
                "processes", "runs", "jobs", "compiles"):
        assert got[key] == want[key], key
    assert got["csv"]["streams_campaign.csv"] == want["csv"]
    assert TC.without_us(got["lines"]) == want["lines"]
    assert len(got["lines"]) == 16


def test_port_grid_equals_the_reference_grid(monkeypatch, tmp_path):
    """Both campaigns in this process on the CPU: the same dict, CSV rows
    and lines (µs aside)."""
    monkeypatch.setattr(RC, "ART", str(tmp_path / "ref"))
    monkeypatch.setattr(TC, "ART", tmp_path / "port")
    want = RC.streams_campaign(full=False)
    got = TC.streams_campaign(full=False, device="cpu")
    for key in ("mean_slowdown", "sitl_vs_erls_bursty", "policies",
                "processes", "runs", "jobs"):
        assert got[key] == want[key], key
    assert (got["runs"], got["jobs"]) == (30, 480)
    assert _csv_rows(tmp_path / "port" / "streams_campaign.csv") == \
        _csv_rows(tmp_path / "ref" / "streams_campaign.csv")
    import benchmarks.run as RR
    monkeypatch.setattr(RC, "streams_campaign", lambda **kw: want)
    assert TC.without_us(TC.streams_lines(want, 0.0)) == \
        TC.without_us(RR.bench_streams(False, 0))


def test_entry_in_a_fresh_process_equals_the_pin(tmp_path):
    got = _port_entry(tmp_path)
    _held_to(got, _pin()["default"])
    assert got["launches"]["replay"] == 0          # the CPU: no launch
    assert got["launches"]["replay_chunks"] > 0


def test_full_grid_in_a_fresh_process_equals_the_pin(tmp_path):
    got = _port_entry(tmp_path, "--full")
    _held_to(got, _pin()["full"])
    assert (got["runs"], got["jobs"]) == (60, 1920)


def test_pin_equals_a_fresh_reference_run():
    assert _fresh(_REFERENCE_GRID, "default") == _pin()["default"]


def test_pin_is_well_formed():
    pin = _pin()
    assert pin["default"]["runs"] == 30 and pin["default"]["jobs"] == 480
    assert pin["full"]["runs"] == 60 and pin["full"]["jobs"] == 1920
    assert (pin["default"]["rollouts"], pin["full"]["rollouts"]) == (96, 384)
    cham = pin["chameleon"]
    assert cham["config"] == CHAMELEON
    sitl, erls = cham["sim_in_the_loop"], cham["er_ls"]
    for run in (sitl, erls):
        assert run["tasks"] == 31196 and len(run["jobs"]) == 32
        assert run["traces"] >= 0
    assert len(sitl["decisions"]) == 32 and erls["decisions"] == []
    assert sitl["rollouts"] == 32 and erls["rollouts"] == 0
    assert sitl["rollout_shapes"] == [[4, 8]]
    assert {jid for jid, _ in sitl["decisions"]} == set(range(32))
    assert sitl["mean_slowdown"] < erls["mean_slowdown"]
    for key in ("default", "full"):
        lines = pin[key]["lines"]
        assert len(lines) == 16 and lines[-1].startswith(
            "streams/sitl_vs_erls_bursty,")
        assert np.isclose(float(lines[-1].rsplit("=", 1)[1]),
                          (pin[key]["sitl_vs_erls_bursty"] - 1) * 100,
                          atol=0.005)


def test_streams_default_to_the_card(monkeypatch):
    """Without a card, the target, the campaign and the rollout policy
    raise rather than fall back to the CPU."""
    from repro_torch.streams import SimInTheLoop, make_policy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TC.streams_campaign(full=False),
                 lambda: SimInTheLoop(),
                 lambda: make_policy("sim_in_the_loop"),
                 lambda: TC.main(["--only", "streams", "--bench-json", ""])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # on the CPU the candidates that solve or score on a device run there
    # too: the first-order LP's adapter would take the card by default
    import repro_torch.streams as S
    from repro_torch.sim.engine import Machine
    pol = SimInTheLoop(candidates=("er_ls", "hlp_jax_ols"), device="cpu")
    assert pol.device.type == "cpu"
    src = S.open_stream(S.PoissonProcess(0.08), S.JobFactory(("chain",)),
                        num_jobs=2, seed=0)
    res = S.run_stream(src, Machine.hybrid(4, 2), pol, seed=0)
    assert len(pol.decisions) == 2 and len(res.jobs) == 2
    S.run_stream(S.open_stream(S.PoissonProcess(0.08),
                               S.JobFactory(("chain",)), num_jobs=1, seed=0),
                 Machine.hybrid(4, 2),
                 make_policy("hlp_jax_ols", device="cpu"), seed=0)
