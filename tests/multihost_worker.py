"""Worker process for tests/test_multihost.py: joins a 2-process
jax.distributed CPU cluster (4 virtual devices per process = 8 global), runs
the sharded PPO train step over the GLOBAL mesh, and prints its loss.

This is the real multi-host code path (SURVEY.md §7 M5): every process
executes the same SPMD program; env shards live process-local on the mesh
'data' axis and gradient psums cross process boundaries via the collective
backend — exactly how a multi-process GPU run is driven, with Gloo/CPU
standing in for NCCL.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    rank = int(sys.argv[1])
    port = sys.argv[2]
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=2, process_id=rank)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import gym_supplychain_tpu as sct
    from gym_supplychain_tpu.learn.ppo import PPOConfig, make_ppo
    from gym_supplychain_tpu.parallel.mesh import (make_mesh,
                                                   train_state_shardings)

    assert jax.device_count() == 8 and jax.local_device_count() == 4

    cc = sct.make("supplychain-ntom-v0", total_time_steps=8).cc
    B = 16
    init_fn, train_step = make_ppo(cc, B, PPOConfig(rollout_steps=4,
                                                    hidden=(16,)))
    mesh = make_mesh(data=8, model=1)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    out_shardings = train_state_shardings(mesh, shapes)
    repl = NamedSharding(mesh, P())

    state = jax.jit(init_fn, out_shardings=out_shardings)(
        jax.random.PRNGKey(0))
    step = jax.jit(train_step,
                   in_shardings=(out_shardings,),
                   out_shardings=(out_shardings,
                                  {"loss": repl, "mean_reward": repl,
                                   "mean_value": repl}))
    mode = sys.argv[3] if len(sys.argv) > 3 else "train"
    if mode == "train":
        for _ in range(3):
            state, metrics = step(state)
        loss = float(metrics["loss"])
        reward = float(metrics["mean_reward"])
        assert np.isfinite(loss) and np.isfinite(reward)
        print(f"RANK{rank} loss={loss!r} mean_reward={reward!r}", flush=True)
        return

    # mode == "ckpt": multi-host checkpoint/resume (round-1 VERDICT item 3).
    # Train 2 iters, save the GLOBALLY-SHARDED state collectively, train 1
    # more -> reference metrics.  Then restore into a template with the same
    # global shardings and re-run that iteration -> must be bitwise equal.
    assert mode == "ckpt"
    ckdir = sys.argv[4]
    from gym_supplychain_tpu.utils.checkpoint import (restore_checkpoint,
                                                      save_checkpoint)
    for _ in range(2):
        state, _ = step(state)
    path = save_checkpoint(ckdir, state, step=2)
    state_direct, metrics_direct = step(state)
    loss_direct = float(metrics_direct["loss"])

    template = jax.jit(init_fn, out_shardings=out_shardings)(
        jax.random.PRNGKey(1))
    restored = restore_checkpoint(path, like=template)
    # the restored state must carry the SAME global shardings as the live one
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        assert a.sharding == b.sharding, (a.sharding, b.sharding)
    state_resumed, metrics_resumed = step(restored)
    loss_resumed = float(metrics_resumed["loss"])
    for a, b in zip(jax.tree.leaves(state_resumed),
                    jax.tree.leaves(state_direct)):
        # compare this process's addressable shards (the full array is not
        # addressable from one process)
        for sa, sb in zip(a.addressable_shards, b.addressable_shards):
            np.testing.assert_array_equal(np.asarray(sa.data),
                                          np.asarray(sb.data))
    print(f"RANK{rank} direct={loss_direct!r} resumed={loss_resumed!r} "
          f"equal={loss_direct == loss_resumed}", flush=True)


if __name__ == "__main__":
    main()
