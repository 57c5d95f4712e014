"""Multi-host scaling benchmark for the north-star config (SURVEY.md §7 M5):
sharded PPO on supplychain-ntom-v0 with the env batch sharded over the mesh
'data' axis across SEPARATE OS PROCESSES joined by ``jax.distributed``.

Each process runs the identical SPMD program: its env shards live on
process-local devices (rollouts need NO communication — envs are
independent), and the PPO gradient all-reduce crosses process boundaries via
the collective backend.  On GPUs the same code rides NCCL; here Gloo/CPU
stands in, so the numbers demonstrate the *code path and scaling shape*, not
GPU throughput (bench.py measures that).

Usage:
    python benchmarks/multihost_scaling.py [--envs 8192] [--iters 8]
        [--procs 1 2] [--devices-per-proc 4]

Prints one JSON line per process count plus a scaling summary.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import time

_SELF = os.path.abspath(__file__)
_REPO = os.path.dirname(os.path.dirname(_SELF))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, nprocs: int, port: str, envs: int, iters: int,
            devices_per_proc: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devices_per_proc}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    if nprocs > 1:
        jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                                   num_processes=nprocs, process_id=rank)
    sys.path.insert(0, _REPO)
    from jax.sharding import NamedSharding, PartitionSpec as P

    import gym_supplychain_tpu as sct
    from gym_supplychain_tpu.learn.ppo import PPOConfig, make_ppo
    from gym_supplychain_tpu.parallel.mesh import (make_mesh,
                                                   train_state_shardings)

    cfg = PPOConfig(rollout_steps=16, epochs=2, hidden=(64, 64))
    cc = sct.make("supplychain-ntom-v0", total_time_steps=64).cc
    init_fn, train_step = make_ppo(cc, envs, cfg)
    mesh = make_mesh(data=jax.device_count(), model=1)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    sh = train_state_shardings(mesh, shapes)
    repl = NamedSharding(mesh, P())
    state = jax.jit(init_fn, out_shardings=sh)(jax.random.PRNGKey(0))
    step = jax.jit(train_step, in_shardings=(sh,),
                   out_shardings=(sh, {"loss": repl, "mean_reward": repl,
                                       "mean_value": repl}))
    state, metrics = step(state)            # compile + first step
    jax.block_until_ready(metrics)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step(state)
    jax.block_until_ready(metrics)
    dt = time.perf_counter() - t0
    sps = envs * cfg.rollout_steps * iters / dt
    print(f"RANK{rank} env_steps_per_s={sps:.1f} loss={float(metrics['loss']):.5f}",
          flush=True)


def _run(nprocs: int, envs: int, iters: int, devices_per_proc: int,
         pin_cores: bool = False) -> float:
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    ncores = os.cpu_count() or 1

    def _cmd(r):
        cmd = [sys.executable, _SELF, "--_worker", str(r), str(nprocs), port,
               str(envs), str(iters), str(devices_per_proc)]
        if pin_cores:
            # one core per process: without pinning, a 1-process XLA CPU run
            # already multithreads over every core, so N processes on the
            # same cores measure contention, not scaling.  Pinning makes it
            # a weak-resource-scaling test (each "host" = one core), which
            # is the multi-host semantics being modeled.
            cmd = ["taskset", "-c", str(r % ncores)] + cmd
        return cmd

    procs = [subprocess.Popen(
        _cmd(r),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(nprocs)]
    sps = []
    for p in procs:
        out, err = p.communicate(timeout=1200)
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{out}\n{err[-2000:]}")
        sps.append(float(re.search(r"env_steps_per_s=([\d.]+)", out).group(1)))
    # every process executes the same global program; throughput is the
    # global batch rate (identical across ranks up to timing jitter)
    return max(sps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--_worker", nargs=6, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--envs", type=int, default=8192,
                    help="GLOBAL env batch (north-star: 8192)")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--pin-cores", action="store_true",
                    help="pin each process to one core (fair per-host "
                         "scaling on a shared-core box)")
    args = ap.parse_args()

    if args._worker:
        r, n, port, envs, iters, dpp = args._worker
        _worker(int(r), int(n), port, int(envs), int(iters), int(dpp))
        return

    results = {}
    for n in args.procs:
        sps = _run(n, args.envs, args.iters, args.devices_per_proc,
                   args.pin_cores)
        results[n] = sps
        print(json.dumps({"processes": n, "global_envs": args.envs,
                          "train_env_steps_per_s": round(sps, 1)}))
    if len(results) > 1:
        base = min(results)
        print(json.dumps({
            "scaling": {str(n): round(results[n] / results[base], 3)
                        for n in sorted(results)},
            "note": "CPU+Gloo stand-in; the same SPMD program rides NCCL on GPUs"}))


if __name__ == "__main__":
    main()
