"""Large-topology benchmark: compile time + runtime of the scan engine on
big chains, so compile-time regressions are visible.

The scan path (``make_vec_env``): trace+compile wall time recorded next to
the per-step runtime (post-fetch slope over 1x/2x scan lengths, see
bench.py).  Prints one JSON object naming the device.
``python benchmarks/large_topologies.py`` (needs a GPU).
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPEATS = 5


def _bench(cc, B, base_steps):
    import jax
    from gym_supplychain_tpu.envs.vector import make_vec_env

    init_fn, step_fn, obs_fn = make_vec_env(cc, B)

    def make_rollout(steps):
        def rollout(seed):
            key = jax.random.PRNGKey(seed)
            st = init_fn(key)

            def body(st, k):
                a = jax.random.uniform(k, (cc.A, B), minval=-1.0, maxval=1.0)
                st, out = step_fn(st, a)
                return st, out.reward.sum() + out.obs.sum()

            ks = jax.random.split(key, steps)
            st, rews = jax.lax.scan(body, st, ks)
            return rews.sum()

        return rollout

    # trace + compile, timed separately (the scan body is traced once, so
    # compile time is ~independent of scan length; measure at base_steps)
    t0 = time.perf_counter()
    lowered = jax.jit(make_rollout(base_steps)).lower(0)
    trace_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t0

    def timed(fn, seed):
        t0 = time.perf_counter()
        float(fn(seed))
        return time.perf_counter() - t0

    run2 = jax.jit(make_rollout(2 * base_steps))
    timed(compiled, 0)
    timed(run2, 0)
    med1 = float(np.median([timed(compiled, r + 1) for r in range(REPEATS)]))
    med2 = float(np.median([timed(run2, r + 1) for r in range(REPEATS)]))
    per_step_us = (med2 - med1) / base_steps * 1e6
    return {
        "nodes": cc.N, "products": cc.P, "action_dim": cc.A,
        "obs_dim": cc.obs_dim,
        "trace_s": round(trace_s, 2),
        "compile_s": round(compile_s, 2),
        "per_step_us": round(per_step_us, 2),
        "steps_per_s": round(B / (per_step_us * 1e-6), 1),
    }


def main():
    from gym_supplychain_tpu.envs.presets import (SupplyChainNPerStage,
                                                  SupplyChainMultiProduct)
    from gym_supplychain_tpu.utils.device import (card_name_and_power_limit,
                                                  require_gpu,
                                                  use_compile_cache)

    devices = require_gpu()
    use_compile_cache()
    B = 4096
    out = {"platform": devices[0].platform,
           "device_kind": devices[0].device_kind,
           "device_count": len(devices),
           "card": card_name_and_power_limit(), "B": B,
           "protocol": "post-fetch slope over 1x/2x scans, median of "
                       f"{REPEATS}"}
    T = 360
    configs = {
        "NPerStage [5,4,7,10] x4prod": lambda t: SupplyChainNPerStage(
            nodes_per_echelon=[5, 4, 7, 10], num_products=4,
            total_time_steps=t, stochastic_leadtimes=True).cc,
        "NPerStage 10 x2prod": lambda t: SupplyChainNPerStage(
            nodes_per_echelon=10, num_products=2, total_time_steps=t,
            stochastic_leadtimes=True).cc,
        "2perstage 10prod": lambda t: SupplyChainMultiProduct(
            num_products=10, total_time_steps=t,
            stochastic_leadtimes=True).cc,
    }
    for name, make_cc in configs.items():
        out[name] = _bench(make_cc(T), B, T)
        print(json.dumps({name: out[name]}), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
