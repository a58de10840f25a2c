"""Simulation-in-the-loop rollouts on the card.

``SimInTheLoop`` scores each arriving job's candidate plans by replaying
them through the replay kernel (``csrc/replay_sm90.cu``), one launch per
shape bucket.  The kernel equals its plain version bit for bit, so a stream
run on the card must make the same decisions and commit the same records
as the same stream with ``device="cpu"``.  Every test carries the ``card``
marker and asks for the ``card`` fixture (which skips without a card), and
the file imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_streams_card.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro_torch.streams as S  # noqa: E402
from repro_torch.kernels.replay import replay as R  # noqa: E402
from repro_torch.obs import registry as obs  # noqa: E402
from repro_torch.sim import NoiseModel  # noqa: E402
from repro_torch.sim.engine import Machine  # noqa: E402

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    """The card, for tests that launch the kernel; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _run(device, seeds=range(4)):
    pol = S.SimInTheLoop(rollout_seeds=seeds,
                         rollout_noise=NoiseModel("lognormal", 0.2),
                         device=device)
    src = S.open_stream(S.MMPPProcess((0.04, 0.6), (60.0, 25.0)),
                        S.JobFactory(("fork_join", "layered", "random")),
                        num_jobs=12, num_tenants=3, seed=1)
    res = S.run_stream(src, Machine.hybrid(8, 2), pol,
                       noise=NoiseModel("lognormal", 0.2), seed=1)
    return pol, res


def test_sitl_stream_on_the_card_equals_the_cpu_stream(card):
    """A bursty 12-job stream: the rollouts launch the replay kernel (one
    launch per replay chunk dispatched, none on the CPU), and the
    decisions and every task and job record equal the CPU run's."""
    R.reset_launch_count()
    chunks = obs.counter_value("sim.replay.chunks")
    pol_c, res_c = _run("cuda")
    launches = R.launch_count()
    assert launches > 0
    assert launches == obs.counter_value("sim.replay.chunks") - chunks
    pol_h, res_h = _run("cpu")
    assert R.launch_count() == launches
    assert pol_c.decisions == pol_h.decisions
    assert len(pol_c.decisions) == 12
    assert [dataclasses.astuple(t) for t in res_c.tasks] == \
        [dataclasses.astuple(t) for t in res_h.tasks]
    assert [dataclasses.astuple(j) for j in res_c.jobs] == \
        [dataclasses.astuple(j) for j in res_h.jobs]
    assert res_c.mean_slowdown() == res_h.mean_slowdown()


def test_streams_campaign_on_the_card_equals_the_cpu_grid(card):
    """The ``streams`` target's default grid through the kernel and
    through its plain version: the same dict."""
    from repro_torch.launch.campaign import streams_campaign
    R.reset_launch_count()
    got = streams_campaign(full=False, device="cuda")
    assert R.launch_count() > 0
    want = streams_campaign(full=False, device="cpu")
    for key in ("mean_slowdown", "sitl_vs_erls_bursty", "runs", "jobs"):
        assert got[key] == want[key], key
