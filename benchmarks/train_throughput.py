"""PPO training throughput on one GPU, with a phase breakdown.

Protocol: ``lax.scan`` over K iterations inside one jitted dispatch,
post-fetch timing, per-iteration time = bench.py's pilot-scaled
least-squares slope over four iteration counts (>= 100 ms of marginal
device work per slope interval, minima of repeated runs).  The
phase bodies reuse ``train_step``'s own closures (train_step.rollout/.gae),
so the breakdown measures the deployed code:

* ``rollout``      — vectorized env + policy sampling only
* ``rollout+gae``  — plus advantage estimation
* ``full``         — plus the ``epochs`` clipped-PPO updates
* ``update`` (derived) = full - rollout+gae

A second row runs the full iteration with the bf16 learner trunk.  Prints
one JSON object naming the device.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import bench

def _slope_per_iter(make_run):
    """Seconds per iteration via bench.py's pilot-scaled protocol: every
    slope interval carries >= 100 ms of marginal device work, and the
    least-squares slope is fitted on per-length minima."""
    r = bench._measure_slope(make_run, 2)
    med = {int(k): v * 1e-3 for k, v in r["min_ms"].items()}
    return r["per_step_us"] * 1e-6, med


def main():
    import jax

    import gym_supplychain_tpu as sct
    from gym_supplychain_tpu.learn.ppo import PPOConfig, make_ppo
    from gym_supplychain_tpu.utils.device import (card_name_and_power_limit,
                                                  require_gpu,
                                                  use_compile_cache)

    devices = require_gpu()
    use_compile_cache()
    B = bench.BATCH
    T = 60
    cfg = PPOConfig(rollout_steps=16, epochs=2, hidden=(128, 128))
    cc = sct.make("supplychain-ntom-v0", total_time_steps=T).cc
    init_fn, train_step = make_ppo(cc, B, cfg)

    def scan_phase(body):
        def make_run(iters):
            def fn(seed):
                state = init_fn(jax.random.PRNGKey(seed))

                def wrap(state, _):
                    return body(state)

                state, outs = jax.lax.scan(wrap, state, None, length=iters)
                return outs.sum()

            return jax.jit(fn)
        return make_run

    def rollout_body(state):
        key, kr = jax.random.split(state.key)
        env_state, traj, last_value = train_step.rollout(
            state.params, state.env, kr)
        return (state._replace(env=env_state, key=key),
                traj.reward.sum() + traj.obs.sum() + last_value.sum())

    def gae_body(state):
        key, kr = jax.random.split(state.key)
        env_state, traj, last_value = train_step.rollout(
            state.params, state.env, kr)
        adv, ret = train_step.gae(traj, last_value)
        return (state._replace(env=env_state, key=key),
                adv.sum() + ret.sum())

    def full_body(state):
        state, metrics = train_step(state)
        return state, metrics["loss"]

    phases = {}
    for name, body in (("rollout", rollout_body), ("rollout+gae", gae_body),
                       ("full", full_body)):
        per_iter_s, med = _slope_per_iter(scan_phase(body))
        phases[name] = {"per_iter_ms": round(per_iter_s * 1e3, 3),
                        "median_ms": {str(k): round(v * 1e3, 2)
                                      for k, v in med.items()}}
    phases["update (derived)"] = {"per_iter_ms": round(
        phases["full"]["per_iter_ms"]
        - phases["rollout+gae"]["per_iter_ms"], 3)}
    phases["gae (derived)"] = {"per_iter_ms": round(
        phases["rollout+gae"]["per_iter_ms"]
        - phases["rollout"]["per_iter_ms"], 3)}
    scan_steps = B * cfg.rollout_steps
    scan_ms = phases["full"]["per_iter_ms"]
    scan_sps = scan_steps / (scan_ms * 1e-3)

    # ---- bf16 learner trunk on the scan path (VERDICT r3 item 3: the
    # update phase has no env-parity obligation; quality covered by
    # tests/test_vector_learn.py::test_ppo_improves_bf16_learner) ---------
    import jax.numpy as jnp
    cfg16 = cfg._replace(learner_dtype=jnp.bfloat16)
    init16, step16 = make_ppo(cc, B, cfg16)

    def full16_run(iters):
        def fn(seed):
            state = init16(jax.random.PRNGKey(seed))

            def body(state, _):
                state, metrics = step16(state)
                return state, metrics["loss"]

            state, losses = jax.lax.scan(body, state, None, length=iters)
            return losses.sum()

        return jax.jit(fn)

    scan16_s, scan16_med = _slope_per_iter(full16_run)
    scan16_sps = scan_steps / scan16_s

    best = max(scan_sps, scan16_sps)

    print(json.dumps({
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "card": card_name_and_power_limit(),
        "config": f"supplychain-ntom-v0 PPO, {B} envs, T={T}, "
                  f"rollout {cfg.rollout_steps} (unroll "
                  f"{cfg.rollout_unroll}), {cfg.epochs} epochs, "
                  "(128,128) MLP",
        "protocol": "bench.py pilot-scaled post-fetch slope (>=100 ms "
                    "marginal work per interval, min-of-repeats LS fit)",
        "scan_path": {
            "phases": phases,
            "env_steps_per_iter": scan_steps,
            "per_train_iter_ms": scan_ms,
            "train_env_steps_per_s": round(scan_sps, 1),
        },
        "scan_path_bf16_learner": {
            "note": "learner_dtype=bf16 trunk in the update only; rollout "
                    "forward unchanged",
            "env_steps_per_iter": scan_steps,
            "per_train_iter_ms": round(scan16_s * 1e3, 3),
            "median_ms": {str(k): round(v * 1e3, 2)
                          for k, v in scan16_med.items()},
            "train_env_steps_per_s": round(scan16_sps, 1),
        },
        "best_train_env_steps_per_s": round(best, 1),
    }, indent=1))


if __name__ == "__main__":
    main()
