"""Training CLI: PPO over batched envs, optionally sharded over a mesh.

Usage (one GPU):
    python -m gym_supplychain_tpu.learn.train --env supplychain-ntom-v0 \
        --envs 4096 --iters 200
All GPUs of a machine, one process: the same command; the env batch is
sharded over a ('data', 'model') mesh of every visible device and XLA
emits the gradient all-reduce (NCCL between cards).
Several processes, one card each (e.g. across machines): start one process
per card with
    --coordinator HOST:PORT --num-processes N --process-id I
and each process initializes JAX's distributed runtime with those values
and sees only its own card (``parallel/mesh.py``).

This supplies the training entry point the reference delegated to external
stable-baselines loops (SURVEY.md §3.5).
"""
from __future__ import annotations

import argparse

import jax


def main(argv=None):
    """Run the CLI; returns ``(initial params, final state, per-iteration
    metrics)`` for in-process callers."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", default="supplychain-ntom-v0")
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--rollout-steps", type=int, default=16)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--hidden", type=int, nargs="+", default=[128, 128])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--horizon", type=int, default=360)
    p.add_argument("--model-axis", type=int, default=1,
                   help="tensor-parallel degree over policy hidden dims")
    p.add_argument("--learner-dtype", default=None, choices=[None, "bf16"],
                   help="update-phase trunk compute dtype (bf16 halves "
                        "stored-activation traffic; rollout unaffected)")
    p.add_argument("--minibatches", type=int, default=1,
                   help="contiguous minibatches per PPO epoch")
    p.add_argument("--coordinator", default=None,
                   help="HOST:PORT of process 0 (multi-process runs)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--restore", default=None)
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--log-every", type=int, default=10)
    args = p.parse_args(argv)

    from gym_supplychain_tpu.parallel.mesh import (init_distributed,
                                                   make_mesh, replicated)
    from gym_supplychain_tpu.utils.device import use_compile_cache

    use_compile_cache()
    init_distributed(args.coordinator, args.num_processes, args.process_id)

    import gym_supplychain_tpu as sct
    from gym_supplychain_tpu.learn.ppo import (PPOConfig, make_beergame_ppo,
                                               make_ppo)
    from gym_supplychain_tpu.utils.checkpoint import (restore_checkpoint,
                                                      save_checkpoint)
    from gym_supplychain_tpu.utils.profiling import (Throughput, log_metrics,
                                                     trace)

    import jax.numpy as jnp
    cfg = PPOConfig(rollout_steps=args.rollout_steps, epochs=args.epochs,
                    lr=args.lr, hidden=tuple(args.hidden),
                    minibatches=args.minibatches,
                    learner_dtype=(jnp.bfloat16
                                   if args.learner_dtype == "bf16" else None))
    key = jax.random.PRNGKey(args.seed)
    n_dev = len(jax.devices())
    mesh = None
    if n_dev > 1:
        mesh = make_mesh(data=n_dev // args.model_axis,
                         model=args.model_axis)
        print(f"# mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}")

    if args.env.startswith("beergame"):
        init_fn, train_step = make_beergame_ppo(
            args.envs, cfg, v2=args.env.endswith("v2"))
    else:
        cc = sct.make(args.env, total_time_steps=args.horizon).cc
        init_fn, train_step = make_ppo(cc, args.envs, cfg)

    if mesh is not None:
        # global shardings at creation time: required for multi-process
        # (multi-host) runs, where arrays built outside jit are committed to
        # process-local devices
        from gym_supplychain_tpu.parallel.mesh import train_state_shardings
        shapes = jax.eval_shape(init_fn, key)
        sh = train_state_shardings(
            mesh, shapes, "model" if args.model_axis > 1 else None)
        state = jax.jit(init_fn, out_shardings=sh)(key)
        repl = replicated(mesh)
        step_jit = jax.jit(
            train_step, in_shardings=(sh,),
            out_shardings=(sh, {"loss": repl, "mean_reward": repl,
                                "mean_value": repl}))
    else:
        state = init_fn(key)
        step_jit = jax.jit(train_step)

    if args.restore:
        state = restore_checkpoint(args.restore, like=state)
    init_params = state.params
    history = []
    meter = Throughput(args.envs * cfg.rollout_steps)
    with trace(args.trace_dir):
        for it in range(args.iters):
            state, metrics = step_jit(state)
            history.append(metrics)
            if it == 0:
                jax.block_until_ready(metrics)
                meter.reset()          # exclude compile time from steps/s
            elif (it + 1) % args.log_every == 0:
                jax.block_until_ready(metrics)
                sps = meter.update(args.log_every)
                log_metrics(it + 1, {**metrics, "env_steps_per_s": sps})
    jax.block_until_ready(state.params)
    if args.checkpoint_dir:
        path = save_checkpoint(args.checkpoint_dir, state, step=args.iters)
        print(f"# checkpoint: {path}")
    return init_params, state, history


if __name__ == "__main__":
    main()
