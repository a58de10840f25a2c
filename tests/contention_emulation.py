"""A numpy emulation of ``csrc/contention.cu``'s loop, for the tests.

It runs the kernel's schedule on one plan at a time in float64, operation
for operation: the staged step records (a masked slot reads the zero cell
with delay +0.0), warp 0's walk with its lanes over the slots and a
butterfly max, threads over the transfers (thread ``i % nt`` owns transfer
``i``), the warps' partial counts and mins meeting across the block, the
replicated ``used`` capacities, and the kernel's three stops: the filling
loop ends once no flow is unfrozen or the guard froze them all, the event
loop once ``t_ev`` is infinite, the rounds once the plan's durations froze.
It returns the durations and the kernel's per-plan counts (rounds, events,
filling rounds, replay steps).  ``tests/test_torch_contention.py`` holds it
to the plain version bit for bit; ``tests/test_torch_contention_card.py``
holds the kernel's counts to its counts.  ``random_bucket`` and
``fluid_bucket`` make the inputs both files share; nothing here imports
JAX.
"""
import numpy as np
import torch

from repro_torch.sim.batch import ContendedBucket

EPS = 1e-12
TINY = np.finfo(np.float64).tiny
MAX_THREADS = 512
INF = np.inf


def _warp_min(vals: np.ndarray, nt: int) -> float:
    """Min over the block as the kernel takes it: each thread's own min,
    then each warp's, then across warps."""
    per_thread = np.full(nt, INF)
    for i, v in enumerate(vals):
        per_thread[i % nt] = min(per_thread[i % nt], v)
    return float(per_thread.reshape(-1, 32).min(axis=1).min())


def emulate_plan(order, pred, pred_mask, pred_tid, times, src, size, up, dn,
                 t_mask, cap, num_links: int, iters: int,
                 max_threads: int = MAX_THREADS):
    """(T_pad,) durations and (rounds, events, fills, steps) of one plan."""
    n_pad, P = pred.shape
    T = size.shape[0]
    nt = min(-(-T // 32) * 32, max_threads)
    cap = float(cap)
    task = order.astype(np.int64)
    time_s = times[task]
    slot = np.where(pred_mask[task], pred[task], n_pad)
    stid = np.where(pred_mask[task], pred_tid[task], -1)
    dur = np.where(t_mask, size / cap, 0.0)
    thresh = EPS * cap + EPS
    cap_eps = cap - EPS
    width = 32 if P >= 32 else 1 << max(0, int(np.ceil(np.log2(max(P, 1)))))
    rounds = events = fills = steps = 0
    owner = np.arange(T) % nt

    for _ in range(iters):
        rounds += 1
        pd = np.where(stid >= 0, dur[np.maximum(stid, 0)], 0.0)
        finish = np.zeros(n_pad + 1)
        for i in range(n_pad):
            lanes = np.zeros(32)
            for k in range(P):
                lanes[k % 32] = max(lanes[k % 32], finish[slot[i, k]] + pd[i, k])
            off = width >> 1
            while off:
                lanes = np.maximum(lanes, lanes[np.arange(32) ^ off])
                off >>= 1
            finish[task[i]] = lanes[0] + time_s[i]
        steps += n_pad

        starts = finish[src]
        live = t_mask & (size > EPS)
        finished = ~live
        fin = np.where(t_mask, starts, 0.0)
        remaining = np.where(live, size, 0.0)
        t = _warp_min(np.where(t_mask, starts, INF), nt)
        for _ev in range(3 * T + 4):
            t_eps = t + EPS
            active = live & ~finished & (starts <= t_eps)
            unfrozen = active.copy()
            rate = np.zeros(T)
            used = np.zeros(num_links)
            for _round in range(num_links):
                cnt = np.zeros((nt, num_links), dtype=np.int64)
                for i in np.flatnonzero(unfrozen):
                    cnt[owner[i], up[i]] += 1
                    cnt[owner[i], dn[i]] += 1
                nl = cnt.reshape(-1, 32, num_links).sum(axis=1).sum(axis=0)
                fills += 1
                if not nl.any():
                    break
                nl = nl.astype(np.float64)
                inc = INF
                for l in range(num_links):
                    if nl[l] > 0.0:
                        inc = min(inc, (cap - used[l]) / nl[l])
                inc = inc if np.isfinite(inc) else 0.0
                inc = max(inc, 0.0)
                sat = np.zeros(num_links, dtype=bool)
                froze = False
                for l in range(num_links):
                    used[l] = used[l] + inc * nl[l]
                    if used[l] >= cap_eps:
                        sat[l] = True
                        froze = froze or nl[l] > 0.0
                rate = np.where(unfrozen, rate + inc, rate)
                if not froze:
                    break
                unfrozen = unfrozen & ~(sat[up] | sat[dn])
            with np.errstate(over="ignore"):
                cand_done = np.where(
                    active, t + remaining / np.maximum(rate, TINY), INF)
            cand_next = np.where(live & ~finished & (starts > t_eps), starts,
                                 INF)
            t_done = _warp_min(cand_done, nt)
            t_next = _warp_min(cand_next, nt)
            events += 1
            t_ev = min(t_done, t_next)
            if not np.isfinite(t_ev):
                break
            t_new = max(t_ev, t)
            dt = t_new - t
            remaining = np.where(active, remaining - rate * dt, remaining)
            done_now = active & (remaining <= thresh)
            fin = np.where(done_now, t_new, fin)
            finished = finished | done_now
            t = t_new

        new = fin - starts
        close = bool(np.all((np.abs(new - dur) <= 1e-9 + 1e-3 * np.abs(dur))
                            | ~t_mask))
        dur = np.where(t_mask, new, dur)
        if close:
            break
    return dur, (rounds, events, fills, steps)


def emulate(cb, num_links: int, iters: int, max_threads: int = MAX_THREADS):
    """(B, T_pad) durations and (B, 4) counts of a ``ContendedBucket``."""
    arrays = [t.numpy() for t in cb.tensors()]
    durs, counts = [], []
    for b in range(arrays[0].shape[0]):
        d, c = emulate_plan(*(a[b] for a in arrays), num_links, iters,
                            max_threads)
        durs.append(d)
        counts.append(c)
    return np.stack(durs), np.asarray(counts, dtype=np.int32)


def random_bucket(rng, B, n, P, T):
    """B random plans of n tasks (up to P preds each, topological order),
    T_pad transfers over four links, some empty, some padding."""
    order = np.zeros((B, n), np.int32)
    pred = np.full((B, n, P), -1, np.int32)
    tid = np.full((B, n, P), -1, np.int32)
    count = rng.integers(T // 2, T + 1, B)
    src = np.zeros((B, T), np.int32)
    for b in range(B):
        perm = rng.permutation(n).astype(np.int32)
        order[b] = perm
        src[b, :count[b]] = rng.choice(perm[: n - 1], count[b])
        pos = np.argsort(perm)
        for i in range(1, n):
            k = rng.integers(0, min(i, P) + 1)
            pred[b, perm[i], :k] = rng.choice(perm[:i], k, replace=False)
            for s in range(k):
                mine = np.flatnonzero(src[b, :count[b]] == pred[b, perm[i], s])
                if len(mine) and pos[pred[b, perm[i], s]] < i:
                    tid[b, perm[i], s] = rng.choice(mine)
    size = rng.uniform(0.0, 4.0, (B, T))
    size[rng.random((B, T)) < 0.1] = 0.0
    t_mask = np.arange(T)[None] < count[:, None]
    size[~t_mask] = 0.0
    up = (rng.integers(0, 2, (B, T)) * 2).astype(np.int32)
    dn = (rng.integers(0, 2, (B, T)) * 2 + 1).astype(np.int32)
    up[~t_mask] = dn[~t_mask] = 0
    return ContendedBucket(
        order=torch.from_numpy(order), pred=torch.from_numpy(pred),
        pred_mask=torch.from_numpy(pred >= 0), pred_tid=torch.from_numpy(tid),
        times=torch.from_numpy(rng.lognormal(0, 0.5, (B, n))),
        src=torch.from_numpy(src), size=torch.from_numpy(size),
        up=torch.from_numpy(up), dn=torch.from_numpy(dn),
        t_mask=torch.from_numpy(t_mask),
        capacity=torch.from_numpy(rng.uniform(0.5, 3.0, B)))


def fluid_bucket(cases):
    """A bucket whose fixpoint is one fluid solve per plan: plan b has one
    task per transfer of ``cases[b] = (capacity, starts, sizes, up, dn)``,
    no edges, task i taking ``starts[i]`` and shipping transfer i, so every
    round starts the transfers at ``starts`` and the durations are the
    fluid finishes less the starts."""
    B = len(cases)
    T = max(len(c[1]) for c in cases)
    n = T + 1
    order = np.tile(np.arange(n, dtype=np.int32), (B, 1))
    pred = np.full((B, n, 1), -1, np.int32)
    times = np.zeros((B, n))
    src = np.zeros((B, T), np.int32)
    size = np.zeros((B, T))
    up = np.zeros((B, T), np.int32)
    dn = np.zeros((B, T), np.int32)
    t_mask = np.zeros((B, T), bool)
    for b, (_, starts, sizes, u, d) in enumerate(cases):
        k = len(starts)
        times[b, :k] = starts
        src[b, :k] = np.arange(k)
        size[b, :k] = sizes
        up[b, :k] = u
        dn[b, :k] = d
        t_mask[b, :k] = True
    return ContendedBucket(
        order=torch.from_numpy(order), pred=torch.from_numpy(pred),
        pred_mask=torch.from_numpy(pred >= 0), pred_tid=torch.from_numpy(pred),
        times=torch.from_numpy(times), src=torch.from_numpy(src),
        size=torch.from_numpy(size), up=torch.from_numpy(up),
        dn=torch.from_numpy(dn), t_mask=torch.from_numpy(t_mask),
        capacity=torch.tensor([c[0] for c in cases], dtype=torch.float64))


def random_transfer_sets(count: int = 8, types: int = 2, first_seed: int = 0):
    """``tests/test_network_kernel.py``'s random transfer sets (with the
    defaults), as ``(capacity, starts, sizes, up, dn)`` over ``types``
    resource types' links (up links even, down links odd), some objects
    empty."""
    cases = []
    for seed in range(first_seed, first_seed + count):
        rng = np.random.default_rng(seed)
        T = int(rng.integers(1, 14))
        cap = float(rng.uniform(0.5, 3.0))
        starts = rng.uniform(0.0, 5.0, T)
        sizes = rng.uniform(0.0, 4.0, T)
        sizes[rng.random(T) < 0.15] = 0.0
        up = rng.integers(0, types, T) * 2
        dn = rng.integers(0, types, T) * 2 + 1
        cases.append((cap, starts, sizes, up, dn))
    return cases
