"""Benchmark: collection env-steps/s on one GPU (BASELINE.json configs).

Runs 4096-env rollouts of supplychain-linear-v0, supplychain-ntom-v0,
beergame-v0 and beergame-v2 through two engines and prints ONE JSON line:

* **scan** -- the ``lax.scan`` engine: random policy, on-device PRNG,
  auto-reset, observations consumed every step (``envs/vector.py``,
  ``core/beergame.py``).
* **kernel** -- the Pallas collect kernels (``ops/``): whole episodes in one
  kernel, replaying episode tables drawn inside the timed region.  Before it
  is timed, each kernel's trajectory is compared with the scan engine's on
  identical tables at the full batch and horizon: max |obs diff| <= 1e-5 and
  max |reward diff| / max |reward| <= 1e-5 for the supply chain in float32,
  bit-exact for the beer game.

The headline takes the faster engine per config (a kernel counts only when it
matched), as a geometric mean over beergame-v0, linear and ntom.
``vs_baseline`` divides by the reference NumPy envs' single-process
throughput (benchmarks/ref_baseline.py; the reference publishes no numbers).

Timing
------
Each timed dispatch ends by fetching a scalar to the host, which waits for
the device.  ``per_step_us`` is the least-squares slope of the minimum wall
time over four dispatch lengths (1x/2x/4x/8x of a pilot-scaled base), so
the fixed cost of a dispatch and its fetch drops out;
``linearity_check`` = slope(l1->l2) / slope(l3->l4) should be ~1.0.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

REPEATS = 5
BATCH = 4096
# lax.scan unroll of the supply-chain rollout bodies (PPOConfig.rollout_unroll
# uses the same value, so the trainer runs the benchmarked configuration)
UNROLL_SC = 4
UNROLL_BG = 1
LINEARITY_BAND = (0.9, 1.1)
# the smallest slope interval must carry at least this much device work
TARGET_MARGINAL_S = 0.1
SLOPE_RETRIES = 3
# beer-game episodes per kernel call (35 weeks each)
BEERGAME_EPISODES_PER_CALL = 8


def _timed_fetch(run, seed):
    """Wall-time one dispatch, synchronized by fetching the scalar result."""
    t0 = time.perf_counter()
    float(run(seed))
    return time.perf_counter() - t0


def _measure_slope_once(make_run, lengths):
    med = {}
    best = {}
    stats = {}
    for s in lengths:
        run = make_run(s)
        _timed_fetch(run, 0)                      # compile + warm + 1st fetch
        times = [_timed_fetch(run, r + 1) for r in range(REPEATS)]
        med[s] = float(np.median(times))
        best[s] = float(np.min(times))
        stats[s] = times
    # fit on the per-length MINIMUM: host-side noise (dispatch scheduling,
    # fetch jitter) is additive-positive, so the min is the lowest-variance
    # estimator of the true wall time; medians are reported alongside
    xs = np.asarray(lengths, np.float64)
    ys = np.asarray([best[s] for s in lengths], np.float64)
    slope, intercept = np.polyfit(xs, ys, 1)
    pred = slope * xs + intercept
    ss_tot = float(np.sum((ys - ys.mean()) ** 2))
    r2 = 1.0 - float(np.sum((ys - pred) ** 2)) / ss_tot if ss_tot > 0 else 0.0
    lo = (best[lengths[1]] - best[lengths[0]]) / (lengths[1] - lengths[0])
    hi = (best[lengths[-1]] - best[lengths[-2]]) / (lengths[-1] - lengths[-2])
    lin = round(lo / hi, 3) if hi > 0 else None
    return {
        "scan_lengths": list(lengths),
        "median_ms": {str(s): round(med[s] * 1e3, 3) for s in lengths},
        "min_ms": {str(s): round(best[s] * 1e3, 3) for s in lengths},
        "std_ms": round(float(np.std(stats[lengths[-1]])) * 1e3, 3),
        "per_step_us": round(float(slope) * 1e6, 4),
        "fit_r2": round(r2, 5),
        "linearity_check": lin,
        "linearity_ok": (lin is not None and slope > 0
                         and LINEARITY_BAND[0] <= lin <= LINEARITY_BAND[1]),
        "dispatch_inclusive_s_per_run": round(med[lengths[-1]], 4),
    }


def _measure_slope(make_run, base_steps):
    """Least-squares marginal time per step over four dispatch lengths.

    A pilot pass at (1x, 4x) * base_steps estimates the per-step time, then
    the lengths (1, 2, 4, 8) * k * base_steps are scaled so the smallest
    interval carries >= TARGET_MARGINAL_S of device work.  Up to
    SLOPE_RETRIES attempts; the one with the linearity ratio closest to 1.0
    is kept."""
    run1, run4 = make_run(base_steps), make_run(4 * base_steps)
    _timed_fetch(run1, 0)
    _timed_fetch(run4, 0)
    t1 = min(_timed_fetch(run1, 1), _timed_fetch(run1, 2))
    t4 = min(_timed_fetch(run4, 1), _timed_fetch(run4, 2))
    est = max((t4 - t1) / (3 * base_steps), 1e-9)   # s per step, pilot
    # cap the longest sweep run at ~6 s wall (t4 bounds the per-run floor)
    k_cap = max(1, int(3.0 / max(t4, 1e-3)))
    k = int(np.clip(np.ceil(TARGET_MARGINAL_S / (est * base_steps)),
                    1, k_cap))
    lengths = [m * k * base_steps for m in (1, 2, 4, 8)]
    best = None
    for attempt in range(SLOPE_RETRIES):
        r = _measure_slope_once(make_run, lengths)
        r["pilot_scale"] = k
        if attempt:
            r["retried"] = attempt
        if (best is None
                or abs((r["linearity_check"] or 99) - 1.0)
                < abs((best["linearity_check"] or 99) - 1.0)):
            best = r
        if best["linearity_ok"]:
            break
    if not best["linearity_ok"]:
        print(f"WARNING: linearity_check {best['linearity_check']} outside "
              f"{LINEARITY_BAND}; slope may not measure per-step work",
              file=sys.stderr)
    return best


def supplychain_scan_rollout(cc, B):
    """Scan engine: stateless on-device RNG, auto-reset, random actions.
    Returns ``make_run(steps) -> jitted rollout(seed) -> scalar``."""
    import jax
    from gym_supplychain_tpu.envs.vector import make_vec_env

    init_fn, step_fn, obs_fn = make_vec_env(cc, B)

    def make_run(steps):
        def rollout(seed):
            # rbg keys: XLA's RngBitGenerator; the env's stateless per-step
            # draws inherit the key's implementation
            key = jax.random.key(seed, impl="rbg")
            st = init_fn(key)

            def body(st, k):
                a = jax.random.uniform(k, (cc.A, B), minval=-1.0, maxval=1.0)
                st, out = step_fn(st, a)
                # consume reward and obs so XLA cannot dead-code the obs path
                # (a real rollout feeds obs to a policy every step)
                return st, out.reward.sum() + out.obs.sum()

            ks = jax.random.split(key, steps)
            st, rews = jax.lax.scan(body, st, ks, unroll=UNROLL_SC)
            return rews.sum()

        return jax.jit(rollout)

    return make_run


def beergame_scan_rollout(name, B):
    """Scan engine for a named beer-game config: random orders, auto-reset
    with fresh per-lane tables for the stochastic configs.  Returns
    ``make_run(steps)`` like :func:`supplychain_scan_rollout`."""
    import jax
    import jax.numpy as jnp
    from gym_supplychain_tpu.core.beergame import make_beergame_kernels
    from gym_supplychain_tpu.envs.vector import make_beergame_table_draw
    from gym_supplychain_tpu.ops.reference import BEERGAME_CONFIGS

    c = BEERGAME_CONFIGS[name]
    L, W = c["levels"], c["weeks"]
    v2 = c.get("v2", False)
    if "delay_range" in c:
        max_delay, delays = max(2, c["delay_range"][1] - 1), None
    else:
        max_delay = c["delay"]
        delays = np.full(W + 1, c["delay"], np.int32)
    reset_fn, step_fn, _ = make_beergame_kernels(
        L, W, max_delay, v2=v2, max_stock=c.get("max_stock", 0),
        exceeded_capacity_penalty=c.get("penalty", 0) if v2 else 0,
        itype=jnp.int32)
    draw = make_beergame_table_draw(W, c.get("demand_range"),
                                    c.get("delay_range"), c.get("demand"),
                                    delays, jnp.int32)

    def make_run(steps):
        def rollout(seed):
            key = jax.random.key(seed, impl="rbg")

            def fresh(k):
                dem, dly = draw(k, B)
                return reset_fn(dem, dly, [12] * L, 4, 4, B)

            st = fresh(key)

            def body(st, k):
                a = jax.random.randint(k, (L, B), 0, c["max_order"])
                st, (obs, reward, done) = step_fn(st, a)
                st = jax.lax.cond(
                    done, lambda _: fresh(jax.random.fold_in(k, 7)),
                    lambda _: st, None)
                return st, (reward.astype(jnp.float32).sum()
                            + obs.astype(jnp.float32).sum())

            ks = jax.random.split(key, steps)
            st, rews = jax.lax.scan(body, st, ks, unroll=UNROLL_BG)
            return rews.sum()

        return jax.jit(rollout)

    return make_run


def _kernel_result(call, steps_per_call):
    """Slope timing for a collect kernel: the timed dispatch ``lax.scan``s
    ``call`` (tables + kernel) R times with distinct seeds, reducing each
    call's outputs into the carry so XLA reuses the trajectory buffers; the
    slope over R gives the steady time per call."""
    import jax
    import jax.numpy as jnp

    def make_run(R):
        def fn(seed):
            def body(acc, i):
                return acc + call(seed * 131 + i), 0

            acc, _ = jax.lax.scan(body, jnp.float32(0.0), jnp.arange(R))
            return acc

        return jax.jit(fn)

    r = _measure_slope(make_run, 2)
    per_call_ms = r["per_step_us"] * 1e-3
    r["per_call_ms"] = round(per_call_ms, 4)
    r["per_step_us"] = round(per_call_ms * 1e3 / steps_per_call, 4)
    r["steps_per_call"] = steps_per_call
    r["scan_lengths"] = [f"{n} calls" for n in r["scan_lengths"]]
    return r


def supplychain_kernel_call(cc, B):
    """One episode of tables drawn from ``seed`` plus the collect kernel,
    reduced to a scalar: ``call(seed)`` (traceable)."""
    import jax
    from gym_supplychain_tpu.ops.reference import supplychain_tables
    from gym_supplychain_tpu.ops.supplychain_pallas import (
        make_supplychain_collect_pallas)

    run = make_supplychain_collect_pallas(cc, B)

    def call(seed):
        dem, lt, act = supplychain_tables(jax.random.PRNGKey(seed), cc, B)
        obs, rew = run(dem, lt, act) if lt is not None else run(dem, act)
        return obs.sum() + rew.sum()

    return call


def beergame_kernel_call(name, B):
    """BEERGAME_EPISODES_PER_CALL episodes of tables drawn from ``seed``
    plus the collect kernel, reduced to a scalar: ``call(seed)``."""
    import jax
    import jax.numpy as jnp
    from gym_supplychain_tpu.ops.reference import (beergame_kernel,
                                                   beergame_tables)

    E = BEERGAME_EPISODES_PER_CALL
    run = beergame_kernel(name, B, E)

    def call(seed):
        dem, dly, act = beergame_tables(jax.random.PRNGKey(seed), name, B, E)
        obs, rew = run(dem, dly, act) if dly is not None else run(dem, act)
        # f32 accumulation: an int32 sum over millions of emitted ints wraps
        return obs.astype(jnp.float32).sum() + rew.astype(jnp.float32).sum()

    return call


def bench_supplychain_kernel(cc, B):
    """Supply-chain collect kernel: checked against the scan engine, then
    timed with one episode of tables drawn per call."""
    from gym_supplychain_tpu.ops.reference import (OBS_ATOL, REWARD_RTOL,
                                                   compare_supplychain)
    from gym_supplychain_tpu.ops.supplychain_pallas import DEFAULT_BATCH_TILE

    obs_err, rew_rel = compare_supplychain(cc, B)
    parity_ok = obs_err <= OBS_ATOL and rew_rel <= REWARD_RTOL
    if not parity_ok:
        raise SystemExit(f"supply-chain kernel differs from the scan engine: "
                         f"obs {obs_err:.2e}, relative reward {rew_rel:.2e}")
    r = _kernel_result(supplychain_kernel_call(cc, B), cc.T)
    r["batch_tile"] = DEFAULT_BATCH_TILE
    r["parity"] = {"B": B, "steps": cc.T,
                   "max_abs_obs_err_vs_scan": obs_err,
                   "max_rel_reward_err_vs_scan": rew_rel,
                   "parity_ok": parity_ok}
    return r


def bench_beergame_kernel(name, B):
    """Beer-game collect kernel: bit-exact against the scan engine, then
    timed with BEERGAME_EPISODES_PER_CALL episodes of tables per call."""
    from gym_supplychain_tpu.ops.reference import (BEERGAME_CONFIGS,
                                                   compare_beergame)
    from gym_supplychain_tpu.ops.supplychain_pallas import DEFAULT_BATCH_TILE

    obs_err, rew_err = compare_beergame(name, B)
    if obs_err or rew_err:
        raise SystemExit(f"{name} kernel differs from the scan engine "
                         f"(obs {obs_err}, reward {rew_err})")
    r = _kernel_result(beergame_kernel_call(name, B),
                       BEERGAME_EPISODES_PER_CALL
                       * BEERGAME_CONFIGS[name]["weeks"])
    r["batch_tile"] = DEFAULT_BATCH_TILE
    r["parity"] = {"B": B, "episodes": 2, "bit_exact": True}
    return r


def main():
    import jax
    from benchmarks.ref_baseline import get_baseline
    from gym_supplychain_tpu.envs.presets import (SupplyChainLinearEnv,
                                                  SupplyChainNtoMEnv)
    from gym_supplychain_tpu.ops.reference import BEERGAME_CONFIGS
    from gym_supplychain_tpu.utils.device import (card_name_and_power_limit,
                                                  require_gpu,
                                                  use_compile_cache)

    devices = require_gpu()
    use_compile_cache()
    B = BATCH
    details = {"platform": devices[0].platform,
               "device_kind": devices[0].device_kind,
               "device_count": len(devices),
               "card": card_name_and_power_limit(),
               "batch": B,
               "unroll": {"supplychain": UNROLL_SC, "beergame": UNROLL_BG},
               "timing_protocol":
               "post-fetch sync; per_step_us = least-squares slope over "
               "1x/2x/4x/8x pilot-scaled dispatches (>=100 ms marginal work "
               f"per interval); min of {REPEATS} repeats per length"}
    ccs = {"supplychain-linear-v0": SupplyChainLinearEnv(
               total_time_steps=360).cc,
           "supplychain-ntom-v0": SupplyChainNtoMEnv(
               total_time_steps=360).cc}
    scan, kernel = {}, {}
    for name, cc in ccs.items():
        scan[name] = _measure_slope(supplychain_scan_rollout(cc, B),
                                    4 * cc.T)
        kernel[name] = bench_supplychain_kernel(cc, B)
    for name in ("beergame-v0", "beergame-v2"):
        scan[name] = _measure_slope(beergame_scan_rollout(name, B),
                                    40 * BEERGAME_CONFIGS[name]["weeks"])
        kernel[name] = bench_beergame_kernel(name, B)

    steps_per_s = {}
    for name, r in scan.items():
        r["steps_per_s"] = round(B / (r["per_step_us"] * 1e-6), 1)
        k = kernel[name]
        k["steps_per_s"] = round(B / (k["per_step_us"] * 1e-6), 1)
        r["engine"] = ("kernel" if k["linearity_ok"]
                       and k["steps_per_s"] > r["steps_per_s"] else "scan")
        steps_per_s[name] = (k if r["engine"] == "kernel"
                             else r)["steps_per_s"]
    details["scan"] = scan
    details["kernel"] = kernel
    details["headline_steps_per_s"] = steps_per_s
    details["linearity_ok"] = all(r["linearity_ok"] for r in
                                  list(scan.values()) + list(kernel.values()))
    details["parity_ok"] = True       # a kernel that differs stops the run

    headline = ("beergame-v0", "supplychain-linear-v0", "supplychain-ntom-v0")
    baseline = get_baseline()
    details["reference_single_env_steps_per_s"] = baseline
    speedups = [steps_per_s[k] / baseline[k] for k in headline
                if k in baseline and baseline[k] > 0]
    vs = float(np.exp(np.mean(np.log(speedups)))) if speedups else 0.0
    value = float(np.exp(np.mean(np.log([steps_per_s[k] for k in headline]))))

    print(json.dumps({
        "metric": f"env-steps/s/chip ({B} parallel envs, geomean of "
                  "beergame-v0 + supplychain-linear-v0 + supplychain-ntom-v0)",
        "value": round(value, 1),
        "unit": "env-steps/s",
        "vs_baseline": round(vs, 2),
        "details": details,
    }))


if __name__ == "__main__":
    main()
