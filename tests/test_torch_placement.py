"""The placement planner (``repro_torch.core.placement``) against the
reference's ``repro.core.placement``: the same layer DAG and the same
``PipelinePlan`` (allocation exact, makespan and LP bound exact) on the
smoke and the full published granite-3-2b and qwen2-1.5b configs, on 2
and 3 pod types (``solve_hlp`` and ``solve_qhlp``) with 1 and 6 streams,
and the paper's Q(Q+1) guarantee."""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.configs as RCF  # noqa: E402
import repro.core.placement as RP  # noqa: E402
import repro_torch.configs as TCF  # noqa: E402
import repro_torch.core.placement as TP  # noqa: E402

from test_torch_paper import PLATFORMS  # noqa: E402

#: (seq, batch) a config is planned at: the smoke configs at the size of
#: ``tests/test_substrate.py``'s bound test, the full ones at the defaults
SIZES = {"smoke": (128, 4), "full": (4096, 8)}


def _configs(arch: str, size: str):
    if size == "smoke":
        return RCF.get_smoke_config(arch), TCF.get_smoke_config(arch)
    return RCF.get_config(arch), TCF.get_config(arch)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-1.5b"])
def test_plans_equal_the_references(arch, size):
    ref_cfg, cfg = _configs(arch, size)
    seq, batch = SIZES[size]
    for pods in PLATFORMS.values():
        for streams in (1, 6):
            want = RP.plan_pipeline(ref_cfg, [RP.PodType(*p) for p in pods],
                                    seq=seq, batch=batch, streams=streams)
            got = TP.plan_pipeline(cfg, [TP.PodType(*p) for p in pods],
                                   seq=seq, batch=batch, streams=streams)
            np.testing.assert_array_equal(got.assignment, want.assignment)
            assert got.makespan == want.makespan
            assert got.lp_bound == want.lp_bound
            assert got.names == want.names
            np.testing.assert_array_equal(got.schedule.start,
                                          want.schedule.start)
            assert got.summary() == want.summary()


@pytest.mark.parametrize("streams", [1, 6])
def test_layer_dag_equals_the_references(streams):
    pods = PLATFORMS["3pod"]
    for arch in ("granite-3-2b", "qwen2-1.5b"):
        ref_cfg, cfg = _configs(arch, "full")
        assert TP._layer_tasks(cfg, 4096, 8) == RP._layer_tasks(ref_cfg,
                                                                4096, 8)
        want = RP.layer_dag(ref_cfg, [RP.PodType(*p) for p in pods],
                            streams=streams)
        got = TP.layer_dag(cfg, [TP.PodType(*p) for p in pods],
                           streams=streams)
        np.testing.assert_array_equal(got.proc, want.proc)
        np.testing.assert_array_equal(got.edges, want.edges)
        assert got.names == want.names


def test_pipeline_plan_respects_q_q1_bound():
    cfg = TCF.get_smoke_config("granite-3-2b")
    pods = [TP.PodType("fast", 2, 1e12, 1e11), TP.PodType("mid", 2, 4e11, 5e10),
            TP.PodType("slow", 4, 1e11, 2e10)]
    plan = TP.plan_pipeline(cfg, pods, seq=128, batch=4, streams=6)
    q = len(pods)
    assert plan.makespan <= q * (q + 1) * plan.lp_bound + 1e-9
    assert "pipeline plan" in plan.summary()
