"""The port's serving slice against the JAX package's: the ER-LS dispatcher
decision for decision, and the greedy prefill/decode loop token for token."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import dispatch as JD  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import dispatch as TD  # noqa: E402


def _requests(mod, seed, n=24):
    """A seeded request stream with fixed arrival times and three tenants."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(0.05, n))
    return [mod.Request(rid=i, prompt_tokens=int(rng.integers(16, 2048)),
                        decode_tokens=int(rng.integers(1, 256)),
                        arrival=float(arrivals[i]), tenant=i % 3)
            for i in range(n)]


def _dispatcher(mod, workers, fast_speed, fast_flops):
    slow = mod.Pool("cpu-pool", workers=workers[0], speed=1.0)
    fast = mod.Pool("gpu-pool", workers=workers[1], speed=fast_speed)
    return mod.ERLSDispatcher(slow, fast, mod.token_cost_model(
        pool_flops={"cpu-pool": 5e11, "gpu-pool": fast_flops}))


def _as_tuples(records):
    return [dataclasses.astuple(r) for r in records]


# the serving driver's fleet (every phase goes to the fast pool), and two
# closer fleets where Step 1 and rule R2 each send phases to both pools
FLEETS = [(0, (16, 4), 8.0, 2e12), (1, (8, 2), 1.5, 5e11),
          (2, (16, 4), 1.2, 5e11)]


@pytest.mark.parametrize("seed,workers,fast_speed,fast_flops", FLEETS)
def test_dispatcher_matches_jax(seed, workers, fast_speed, fast_flops):
    jd = _dispatcher(JD, workers, fast_speed, fast_flops)
    td = _dispatcher(TD, workers, fast_speed, fast_flops)
    jpl = [jd.submit(r) for r in _requests(JD, seed)]
    tpl = [td.submit(r) for r in _requests(TD, seed)]
    assert [_as_tuples(p) for p in tpl] == [_as_tuples(p) for p in jpl]
    assert [(rid, ph, d.rtype, d.width) for rid, ph, d in td.decisions] == \
        [(rid, ph, d.rtype, d.width) for rid, ph, d in jd.decisions]
    assert {d.rtype for _, _, d in td.decisions} == ({1} if seed == 0
                                                     else {0, 1})
    assert td.makespan == jd.makespan

    # straggler backups on every other placement, at 2x and 4x its estimate
    jreqs, treqs = _requests(JD, seed), _requests(TD, seed)
    fired = 0
    for i, (jp, tp) in enumerate(zip(jd.log[::2], td.log[::2])):
        factor = 4.0 if i % 2 else 2.0
        jb = jd.maybe_backup(jp, factor * (jp.finish - jp.start), jreqs[jp.rid])
        tb = td.maybe_backup(tp, factor * (tp.finish - tp.start), treqs[tp.rid])
        assert (tb is None) == (jb is None)
        if tb is not None:
            fired += 1
            assert dataclasses.astuple(tb) == dataclasses.astuple(jb)
    assert fired > 0 or seed == 0     # a backup on the slow pool never pays
    assert td.makespan == jd.makespan
    assert _as_tuples(td.job_records()) == _as_tuples(jd.job_records())
    assert td.tenant_table(tau=1e-3) == jd.tenant_table(tau=1e-3)


def test_greedy_tokens_match_jax_serving_loop():
    """8 greedy steps at float32 on carried-over weights give the same ids."""
    jcfg = dataclasses.replace(jax_smoke("qwen2-1.5b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    B, S, GEN = 3, 20, 8
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, S))

    prefill = jax.jit(lambda p, b, c: JM.prefill(jcfg, p, b, c))
    decode = jax.jit(lambda p, c, t: JM.decode_step(jcfg, p, c, t))
    logits, cache = prefill(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)},
                            JM.init_cache(jcfg, B, S + GEN))
    tok = jnp.argmax(logits, -1)[:, None]
    want = [tok]
    for _ in range(GEN - 1):
        logits, cache = decode(jparams, cache, tok)
        tok = jnp.argmax(logits, -1)[:, None]
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))

    got = serve.generate(tcfg, tparams, torch.as_tensor(prompt), GEN, S + GEN)
    assert got.finite
    np.testing.assert_array_equal(got.tokens.numpy(), want)


def test_serve_main_smoke_on_cpu_returns_summary(capsys):
    out = serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                      "--requests", "3", "--batch", "2", "--prompt", "16",
                      "--gen", "4"])
    assert out["device"] == "cpu" and out["arch"] == "qwen2-1.5b"
    assert out["tokens"] == 3 * 4
    assert out["flash_launches"] == 0 and out["logits_finite"]
    assert out["makespan"] > 0 and out["tok_per_s"] > 0
    assert out["prefill_s"] > 0 and out["decode_s"] > 0
    text = capsys.readouterr().out
    assert "planned fleet makespan" in text and "tok/s" in text


def test_serve_main_rejects_unported_families():
    with pytest.raises(KeyError):
        serve.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu"])


def test_online_rules_match_jax():
    from repro.core import online as JO
    from repro_torch.core import online as TO
    rng = np.random.default_rng(5)
    for _ in range(500):
        pc, pg = rng.exponential(1.0, 2)
        m, k = int(rng.integers(1, 33)), int(rng.integers(1, 9))
        r_gpu = float(rng.exponential(0.5))
        assert TO.erls_decide(pc, pg, m, k, r_gpu) == \
            JO.erls_decide(pc, pg, m, k, r_gpu)
        for name, rule in TO.RULES.items():
            assert rule(pc, pg, m, k) == JO.RULES[name](pc, pg, m, k)


def test_pool_state_matches_jax():
    from repro import platform as JP
    from repro_torch import platform as TP
    js, ts = JP.PoolState((5, 3)), TP.PoolState((5, 3))
    rng = np.random.default_rng(6)
    for _ in range(200):
        q = int(rng.integers(0, 2))
        w = int(rng.integers(1, 4))
        assert ts.earliest_idle(q, w) == js.earliest_idle(q, w)
        ready, p = float(rng.exponential(1.0)), float(rng.exponential(1.0))
        assert ts.commit_wide(q, ready, p, w) == js.commit_wide(q, ready, p, w)
    assert ts.platform.names == js.platform.names == ("cpu", "gpu")
    assert TP.as_decision(1) == TP.Decision(1, 1)
    assert TP.as_decision((0, 2)) == TP.Decision(0, 2)
    with pytest.raises(ValueError):
        TP.Decision(0, 0)
    with pytest.raises(RuntimeError):
        ts.commit_wide(1, 0.0, 1.0, 4)
