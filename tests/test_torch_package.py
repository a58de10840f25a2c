"""Package rules of the port: no JAX, no ``repro``, no silent CPU fallback."""
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.launch import kernel_bench, serve  # noqa: E402

SRC = Path(repro_torch.__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_import_loads_no_jax_and_no_repro():
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, env={"PYTHONPATH": str(SRC)}, timeout=300,
                          check=True)
    count, bad = proc.stdout.split(maxsplit=1)
    assert int(count) >= 20
    assert bad.strip() == "[]"


_PLANNER_PROBE = """
import sys
import repro_torch.launch.campaign, repro_torch.sim.adapters
import repro_torch.sim.pipeline, repro_torch.sim.scenarios
import repro_torch.core.placement
from repro_torch.launch.campaign import (_offline2_job, _offline3_job,
                                         _online_job)
print(sorted(m for m in sys.modules if m.split(".")[0] == "torch"))
"""


def test_the_planners_import_no_torch():
    """What a planning worker of the process pool imports (the adapters,
    the pipeline module for its task function, the campaign entry it
    re-runs as ``__main__``, whose module also holds the paper
    experiments' jobs) and the placement planner load no torch, whose
    import alone takes seconds; the lazy names still resolve."""
    proc = subprocess.run([sys.executable, "-c", _PLANNER_PROBE],
                          capture_output=True, text=True,
                          env={"PYTHONPATH": str(SRC)}, timeout=300,
                          check=True)
    assert proc.stdout.strip() == "[]"
    import repro_torch.sim as T
    from repro_torch.sim import network
    from repro_torch.sim.batch import trace_count
    from repro_torch.sim.pipeline import pipelined_sweep_makespans
    assert T.trace_count is trace_count and repro_torch.resolve_device is \
        resolve_device
    assert T.pipelined_sweep_makespans is pipelined_sweep_makespans
    assert network.fluid_finishes_ref.__module__ == \
        "repro_torch.kernels.contention.ref"
    with pytest.raises(AttributeError):
        T.no_such_name


def test_every_module_is_listed_by_the_probe():
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.launch.serve", "repro_torch.models.convert",
            "repro_torch.kernels.build",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.maxplus.ops", "repro_torch.launch.kernel_bench",
            "repro_torch.core.hlp", "repro_torch.core.listsched",
            "repro_torch.sim.engine", "repro_torch.sim.adapters",
            "repro_torch.sim.network", "repro_torch.obs.registry",
            "repro_torch.sim.batch", "repro_torch.kernels.replay.replay",
            "repro_torch.kernels.replay.ref",
            "repro_torch.kernels.contention.contention",
            "repro_torch.kernels.contention.ref",
            "repro_torch.sim.pipeline", "repro_torch.search",
            "repro_torch.search.genome", "repro_torch.search.evolve",
            "repro_torch.launch.campaign", "repro_torch.obs.trace",
            "repro_torch.obs.provenance", "repro_torch.core.hlp_jax",
            "repro_torch.kernels.hlp_fo.hlp_fo",
            "repro_torch.kernels.hlp_fo.ref",
            "repro_torch.core.placement", "repro_torch.streams",
            "repro_torch.streams.arrivals", "repro_torch.streams.engine",
            "repro_torch.streams.metrics", "repro_torch.streams.policy",
            "repro_torch.streams.replay",
            "repro_torch.streams.tenants"} <= names


_STREAMS_PROBE = """
import sys
import repro_torch.streams.arrivals, repro_torch.streams.engine
import repro_torch.streams.metrics, repro_torch.streams.replay
import repro_torch.streams.tenants
from repro_torch.streams import JobFactory, open_stream, run_stream
print(sorted(m for m in sys.modules if m.split(".")[0] == "torch"))
"""


def test_the_stream_host_modules_import_no_torch():
    """The open-system engine, its sources, metrics, trace replay and
    tenant records are host code: they (and the package's eager names)
    load no torch; the policy names load ``policy`` when first asked for."""
    proc = subprocess.run([sys.executable, "-c", _STREAMS_PROBE],
                          capture_output=True, text=True,
                          env={"PYTHONPATH": str(SRC)}, timeout=300,
                          check=True)
    assert proc.stdout.strip() == "[]"
    import repro_torch.streams as S
    from repro_torch.streams import policy
    assert S.SimInTheLoop is policy.SimInTheLoop
    assert S.make_policy is policy.make_policy
    with pytest.raises(AttributeError):
        S.no_such_name


@pytest.fixture
def no_card(monkeypatch):
    """Stands for a host without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_for_cuda_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_serve_main_defaults_to_the_card_and_raises_without_it(no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "qwen2-1.5b", "--smoke"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cuda"])


def test_replay_evaluators_default_to_the_card_and_raise_without_it(no_card):
    from repro_torch.sim import NoiseModel, batch, make_scheduler
    from repro_torch.sim.scenarios import chain_scenario

    sc = chain_scenario(n=6, counts=(2, 1), seed=0)
    plan = make_scheduler("heft").allocate(sc.graph, sc.machine)
    rows = [batch.sample_actual_batch(sc.graph, plan, NoiseModel(), [0])]
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="cuda"):
            batch.bucketed_makespans([(sc.graph, plan)], rows, **kw)
        with pytest.raises(RuntimeError, match="cuda"):
            batch.sweep_suite_makespans(
                [(sc.graph, sc.machine, make_scheduler("heft"))],
                noise=NoiseModel(), seeds=[0], **kw)
    assert batch.bucketed_makespans([(sc.graph, plan)], rows,
                                    device="cpu")[0].shape == (1,)


def test_kernel_bench_defaults_to_the_card_and_raises_without_it(no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        kernel_bench.main([])


def test_kernel_bench_on_cpu_prints_the_reference_csv_lines():
    lines = kernel_bench.main(["--device", "cpu"])
    assert [line.split(",")[0] for line in lines] == [
        "kernels/maxplus_256x256x256", "kernels/flash_attn_s512"]
    assert lines[0].endswith(";max_err=0.0e+00")
    assert all(line.split(",")[2].startswith("ref_us=") for line in lines)


def test_flash_wrapper_on_cpu_takes_the_plain_path():
    fa.reset_launch_count()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 130, 4, 64, generator=g)
    k = torch.randn(1, 130, 2, 64, generator=g)
    v = torch.randn(1, 130, 2, 64, generator=g)
    out = ops.flash_attention(q, k, v)
    assert fa.launch_count() == 0
    assert torch.equal(out, ops.flash_attention_ref(q, k, v))
    fa.flash_attention_bhsd(q[:, :, 0], q[:, :, 1], q[:, :, 2])
    assert fa.launch_count() == 0


def test_kernel_launch_refuses_cpu_tensors():
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="card"):
        fa.launch_bshd(q, q, q, causal=True)
    assert fa.launch_count() == 0


def test_build_is_content_addressed_and_lazy():
    lib = build.library_path("flash_attention")
    assert lib.parent == build.BUILD_DIR
    assert lib.name.startswith("libflash_attention-") and lib.suffix == ".so"
    assert build.load.cache_info().currsize == 0 or torch.cuda.is_available()


_SMOKE_PROBE = """
import runpy, sys
sys.argv = ["chip_smoke.py"]
try:
    runpy.run_path("chip_smoke.py", run_name="__main__")
    code = 0
except SystemExit as stop:
    code = stop.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(code, bad)
"""


def test_chip_smoke_refuses_without_a_card_and_loads_no_jax():
    """``chip_smoke.py`` with no card visible: exit code 1, no result line,
    and nothing of JAX or of the JAX package loaded."""
    env = {"PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", _SMOKE_PROBE],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=SRC.parent, check=True)
    assert proc.stdout.strip() == "1 []"
    assert "is_available() is False" in proc.stderr


def test_build_hashes_the_shared_headers_into_every_library(tmp_path,
                                                            monkeypatch):
    """The kernels include ``contention_common.cuh`` and
    ``sm90_common.cuh``: an edit there must rebuild each.  On a copy of
    ``csrc/``, one byte added to either shared header changes every
    library's name, and an edit of one source only that source's.  The
    first ports of the replay and contention kernels are gone: one source
    each is left."""
    headers = sorted(p.name for p in build.CSRC.glob("*.cuh"))
    assert {"contention_common.cuh", "sm90_common.cuh"} <= set(headers)
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = sorted(p.stem for p in csrc.glob("*.cu"))
    assert {"contention_sm90", "replay_sm90"} <= set(names)
    assert not {"contention", "replay"} & set(names)

    def paths():
        return {name: build.library_path(name) for name in names}

    before = paths()
    for name, path in before.items():
        assert path.name.startswith(f"lib{name}-")
    for header in ("contention_common.cuh", "sm90_common.cuh"):
        with open(csrc / header, "a") as f:
            f.write("\n")
        after = paths()
        assert all(after[n] != before[n] for n in names), header
        before = after
    with open(csrc / "contention_sm90.cu", "a") as f:
        f.write("\n")
    after = paths()
    assert [n for n in names if after[n] != before[n]] == ["contention_sm90"]
