"""Package rules of the port: no JAX, no ``repro``, no silent CPU fallback."""
import pkgutil
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
            "repro_torch.kernels.contention.ref"} <= names


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
