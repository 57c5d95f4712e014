"""Smoke test of the whole system on NVIDIA GPUs.

    python chip_smoke.py               # one card: phases 1-4
    python chip_smoke.py --four-cards  # four cards: the sharded trainer only

Phases (one card):
  1. device: JAX's default backend must be the GPU; prints the device kind,
     the device count and the card's name and power limit.
  2. float64 parity on the card: the golden episodic returns and the
     recorded reference trajectories of the CPU test suite.
  3. collect kernels vs the scan engine at 4096 envs and full horizon
     (supply chain within 1e-5 in float32, beer game bit-exact), then the
     time of one kernel call against the scan engine's for the same steps.
  4. trainer and evaluator through their CLIs' ``main``: PPO with the
     (128, 128) actor-critic on supplychain-ntom-v0 at 4096 envs and on
     beergame-v2 at 1024 envs, then greedy evaluation of the checkpoint.

``--four-cards`` trains ntom at 8192 global envs over a data=4 mesh through
``learn.train`` and compares the first iteration with the same seed on one
card.  Every phase raises on failure; the last stdout line is a JSON object
naming the device.  A run where JAX finds no GPU fails at phase 1.
"""
import argparse
import json
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import numpy as np

from gym_supplychain_tpu.utils.device import (card_name_and_power_limit,
                                              require_gpu, use_compile_cache)

B = 4096
REPS = 5


def phase_device():
    devices = require_gpu()
    print(f"[1] backend gpu: {devices[0].device_kind} x {len(devices)}")
    print(f"[1] card: {card_name_and_power_limit()}", flush=True)
    return devices


def phase_float64_parity():
    """The CPU suite's golden returns and recorded trajectories, run on the
    card in float64 with the suite's own tolerances."""
    from tests import test_multiproduct_2perstage as mp
    from tests import test_nperstage as nps
    from tests import test_recorded_trajectory as rec
    from tests.fixture_scenarios import SC_SCENARIOS, beergame_scenarios

    golden = [mp.test_SupplyChainMultiProduct, mp.test_scenario_mp_N20,
              mp.test_scenario_mp_rN50, mp.test_SupplyChainMultiProduct_3products,
              mp.test_increasing_costs, mp.test_DemConfigByProd,
              mp.test_DemConfigByProd_IncCosts, nps.test3perStage,
              nps.test3perStageSeasonalDemands, nps.test3perStage3Products,
              nps.testChain_3_2_3_5]
    with jax.enable_x64(True):
        t0 = time.perf_counter()
        for test in golden:
            test()
        print(f"[2] {len(golden)} golden episodic returns match in float64 "
              f"({time.perf_counter() - t0:.1f} s), among them "
              f"SupplyChainMultiProduct -34704704.078214735", flush=True)
        sc = np.load(os.path.join(rec.DATA, "ref_trajectories.npz"))
        bg = np.load(os.path.join(rec.DATA, "ref_beergame.npz"))
        for name in sorted(SC_SCENARIOS):
            rec.test_recorded_supplychain_trajectory(name, sc)
        for name in sorted(beergame_scenarios()):
            rec.test_recorded_beergame_trajectory(name, bg)
        print(f"[2] {len(SC_SCENARIOS) + len(beergame_scenarios())} recorded "
              f"reference trajectories match", flush=True)


def _median_s(fn, arg):
    """Median wall time of ``fn(arg)`` over REPS runs after a warm-up."""
    jax.block_until_ready(fn(arg))
    times = []
    for r in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg + r + 1))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_kernels(card):
    import bench
    import gym_supplychain_tpu as sct
    from gym_supplychain_tpu.ops import reference as ref

    for env_id in ("supplychain-linear-v0", "supplychain-ntom-v0",
                   "supplychain-2perstage-v0"):
        cc = sct.make(env_id).cc
        obs_err, rew_rel = ref.compare_supplychain(cc, B)
        print(f"[3] {env_id}: max |obs diff| {obs_err:.3e}, max relative "
              f"|reward diff| {rew_rel:.3e} (B={B}, T={cc.T})", flush=True)
        assert obs_err <= ref.OBS_ATOL and rew_rel <= ref.REWARD_RTOL, env_id
        kernel = jax.jit(bench.supplychain_kernel_call(cc, B))
        scan = bench.supplychain_scan_rollout(cc, B)(cc.T)
        tk, ts = _median_s(kernel, 0), _median_s(scan, 0)
        print(f"[3] {env_id}: one {cc.T}-step episode at {B} envs: kernel "
              f"(tables + kernel) {tk * 1e3:.3f} ms, scan {ts * 1e3:.3f} ms "
              f"({card})", flush=True)
    for name in ("beergame-v0", "beergame-v2"):
        obs_err, rew_err = ref.compare_beergame(name, B)
        print(f"[3] {name}: max |obs diff| {obs_err}, max |reward diff| "
              f"{rew_err} (B={B}, 2 episodes)", flush=True)
        assert obs_err == 0 and rew_err == 0, name
        steps = (bench.BEERGAME_EPISODES_PER_CALL
                 * ref.BEERGAME_CONFIGS[name]["weeks"])
        kernel = jax.jit(bench.beergame_kernel_call(name, B))
        scan = bench.beergame_scan_rollout(name, B)(steps)
        tk, ts = _median_s(kernel, 0), _median_s(scan, 0)
        print(f"[3] {name}: {steps} weeks at {B} envs: kernel "
              f"{tk * 1e3:.3f} ms, scan {ts * 1e3:.3f} ms ({card})",
              flush=True)


def _moved(a, b):
    return any(not np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def phase_trainer():
    from gym_supplychain_tpu.learn import evaluate, train

    # the main path must not need orbax: checkpoints fall back to pickle
    sys.modules["orbax"] = None
    sys.modules["orbax.checkpoint"] = None
    print(f"[4] matmul precision in force: "
          f"{jax.config.jax_default_matmul_precision or 'default'} (the "
          f"policy sets none, so float32 matmuls may run as TF32 here)",
          flush=True)
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        init, state, hist = train.main(
            ["--env", "supplychain-ntom-v0", "--envs", str(B), "--iters", "5",
             "--hidden", "128", "128", "--checkpoint-dir", ckpt])
        loss = float(hist[-1]["loss"])
        assert math.isfinite(loss) and _moved(init, state.params)
        print(f"[4] train ntom {B} envs, 5 iters: loss {loss:.6f}, mean "
              f"reward {float(hist[-1]['mean_reward']):.3f}, params moved "
              f"({time.perf_counter() - t0:.1f} s with compile)", flush=True)
        stats = evaluate.main(["--restore", ckpt, "--envs", str(B),
                               "--episodes", "1"])
        assert all(math.isfinite(v) for v in stats.values()), stats
        print(f"[4] evaluate ntom {B} envs, 1 episode: mean return "
              f"{stats['mean_return']:.1f}", flush=True)
    init, state, hist = train.main(
        ["--env", "beergame-v2", "--envs", "1024", "--iters", "5",
         "--hidden", "128", "128"])
    loss = float(hist[-1]["loss"])
    assert math.isfinite(loss) and _moved(init, state.params)
    print(f"[4] train beergame-v2 1024 envs, 5 iters: loss {loss:.6f}",
          flush=True)


def phase_four_cards(envs=8192, iters=3):
    """Sharded PPO through learn.train's mesh path vs the same seed on one
    card.  Matmuls run at 'highest' precision in both, so the difference is
    float32 summation order (the all-reduce over four cards against one
    card's reduction) carried through two epochs of updates."""
    import gym_supplychain_tpu as sct
    from gym_supplychain_tpu.learn import train
    from gym_supplychain_tpu.learn.ppo import PPOConfig, make_ppo

    n = len(jax.devices())
    assert n == 4, f"--four-cards needs 4 devices, found {n}"
    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        _, _, hist = train.main(
            ["--env", "supplychain-ntom-v0", "--envs", str(envs), "--iters",
             str(iters), "--hidden", "128", "128"])
        sharded = {k: float(hist[0][k]) for k in ("loss", "mean_reward")}
        print(f"[4c] data=4 mesh, {envs} envs, {iters} iters: first "
              f"iteration {sharded} ({time.perf_counter() - t0:.1f} s with "
              f"compile)", flush=True)
        cc = sct.make("supplychain-ntom-v0", total_time_steps=360).cc
        cfg = PPOConfig(rollout_steps=16, epochs=2, lr=3e-4,
                        hidden=(128, 128))
        init_fn, train_step = make_ppo(cc, envs, cfg)
        one = jax.devices()[0]
        state = jax.device_put(init_fn(jax.random.PRNGKey(0)), one)
        _, m = jax.jit(train_step)(state)
        single = {k: float(m[k]) for k in ("loss", "mean_reward")}
    print(f"[4c] one card, same seed: first iteration {single}", flush=True)
    for k in sharded:
        tol = 1e-3 * max(1.0, abs(single[k]))
        diff = abs(sharded[k] - single[k])
        print(f"[4c] {k}: |sharded - one card| = {diff:.3e} "
              f"(tolerance {tol:.3e})", flush=True)
        assert diff <= tol, (k, sharded[k], single[k])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card sharded trainer phase")
    args = p.parse_args(argv)
    use_compile_cache()
    devices = phase_device()
    if args.four_cards:
        phase_four_cards()
    else:
        card = card_name_and_power_limit()
        phase_float64_parity()
        phase_kernels(card)
        phase_trainer()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
