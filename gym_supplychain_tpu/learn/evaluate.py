"""Deterministic policy evaluation (the serving path of the learner layer).

Runs greedy (mode-action) rollouts of a trained policy over the batched env
under one jitted ``lax.scan`` and reports per-episode return statistics.
Pairs with ``utils/checkpoint.py`` for evaluating saved training runs:

    python -m gym_supplychain_tpu.learn.evaluate --restore ckpt/step_100 \
        --env supplychain-ntom-v0 --envs 1024 --episodes 4
"""
from __future__ import annotations

import argparse
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.compile import CompiledChain
from ..envs.vector import make_vec_env
from ..models.policy import actor_critic_forward

__all__ = ["make_evaluator", "make_beergame_evaluator", "main"]


def make_evaluator(cc: CompiledChain, batch_size: int, dtype=jnp.float32):
    """Returns ``evaluate(params, key, episodes) -> {mean, std, min, max}``
    of the per-env accumulated return under the greedy (tanh(mu)) policy."""
    B = batch_size
    env_init, env_step, env_obs = make_vec_env(cc, B, dtype)

    def evaluate(params, key, episodes: int = 1):
        steps = cc.T * episodes

        def body(carry, _):
            env_state, obs = carry
            mu, _, _ = actor_critic_forward(params, obs)
            env_state, out = env_step(env_state, jnp.tanh(mu))
            return (env_state, out.obs), out.reward

        st = env_init(key)
        (_, _), rewards = jax.lax.scan(body, (st, env_obs(st)), None,
                                       length=steps)
        per_env = rewards.reshape(episodes, cc.T, B).sum(axis=1)  # [ep, B]
        return {"mean_return": per_env.mean(),
                "std_return": per_env.std(),
                "min_return": per_env.min(),
                "max_return": per_env.max()}

    return evaluate


def make_beergame_evaluator(batch_size: int, levels: int = 4,
                            weeks: int = 35, max_order: int = 16,
                            customer_demand=None, shipment_delays=2,
                            v2: bool = False, max_stock: int = 100,
                            exceeded_capacity_penalty: int = 100,
                            dtype=jnp.float32):
    """Greedy (argmax-logits) evaluation of a ``make_beergame_ppo``-trained
    policy: whole fresh episodes with per-lane stochastic tables re-drawn
    each episode (the v2 ranges, beergame2_env.py:41-58), same observation
    scaling as the trainer.  Returns ``evaluate(params, key, episodes) ->
    {mean, std, min, max}`` of the per-env episodic return."""
    from ..core.beergame import make_beergame_kernels
    from ..envs.vector import _is_range, make_beergame_table_draw
    from ..models.policy import discrete_forward

    B, L = batch_size, levels
    dem_range = customer_demand if _is_range(customer_demand) else None
    delay_range = shipment_delays if _is_range(shipment_delays) else None
    demand = delays = None
    if dem_range is None:
        demand = np.asarray(customer_demand if customer_demand is not None
                            else [4] * 4 + [8] * (weeks - 4), np.int32)
        weeks_ = len(demand)
    else:
        weeks_ = weeks
    if delay_range is None:
        delays = np.full(weeks_ + 1, shipment_delays, np.int32)
        delays[0] = 2
        max_delay = int(delays.max())
    else:
        max_delay = max(2, int(delay_range[1]))
    draw = make_beergame_table_draw(weeks_, dem_range, delay_range,
                                    demand, delays, jnp.int32)
    reset_k, step_k, obs_k = make_beergame_kernels(
        L, weeks_, max_delay, v2=v2, max_stock=max_stock,
        exceeded_capacity_penalty=exceeded_capacity_penalty,
        itype=jnp.int32)
    max_dem = float(demand.max()) if demand is not None \
        else float(dem_range[1] - 1)
    obs_scale = 1.0 / (4.0 * max_dem)          # matches make_beergame_ppo
    inv0 = np.full(L, 12, np.int32)

    def evaluate(params, key, episodes: int = 1):
        def episode(acc, k):
            dem, dly = draw(k, B)
            st = reset_k(dem, dly, inv0, 4, 4, B)

            def body(st, _):
                obs = obs_k(st).astype(dtype) * obs_scale
                logits, _ = discrete_forward(params, obs, L, max_order)
                act = jnp.argmax(logits, axis=1)           # [L, B]
                st, (_, r, _) = step_k(st, act)
                return st, r

            _, rews = jax.lax.scan(body, st, None, length=weeks_)
            return acc, rews.astype(jnp.float32).sum(axis=0)   # [B]

        _, per_env = jax.lax.scan(episode, 0.0,
                                  jax.random.split(key, episodes))
        return {"mean_return": per_env.mean(),
                "std_return": per_env.std(),
                "min_return": per_env.min(),
                "max_return": per_env.max()}

    return evaluate


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", default="supplychain-ntom-v0")
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--episodes", type=int, default=4)
    p.add_argument("--horizon", type=int, default=360)
    p.add_argument("--restore", required=True)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import gym_supplychain_tpu as sct
    from gym_supplychain_tpu.utils.checkpoint import restore_checkpoint
    from gym_supplychain_tpu.utils.device import use_compile_cache

    use_compile_cache()

    cc = sct.make(args.env, total_time_steps=args.horizon).cc
    # the checkpoint format is self-describing (utils/checkpoint.py): the
    # state pytree is a TrainState (pickle backend) or a dict with the same
    # field names (orbax backend without a template)
    state = restore_checkpoint(args.restore)
    params = state.params if hasattr(state, "params") else state["params"]
    evaluate = jax.jit(make_evaluator(cc, args.envs),
                       static_argnames="episodes")
    stats = evaluate(params, jax.random.PRNGKey(args.seed), args.episodes)
    stats = {k: float(v) for k, v in stats.items()}
    print(stats)
    return stats


if __name__ == "__main__":
    main()
