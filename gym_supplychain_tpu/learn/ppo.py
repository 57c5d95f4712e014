"""Compact PPO learner driving the batched env — the missing training layer.

The reference was consumed by external stable-baselines loops (SURVEY.md §3.5,
supplychain_env.py:794-795); this provides a native on-device learner:
rollout via ``lax.scan`` over the batched step kernel, GAE, clipped PPO
updates with optax, everything inside one jitted ``train_step``.

Scaling model (SURVEY.md §5 "distributed communication backend"): the env
batch axis (trailing) is the data-parallel axis.  Shard ``VecState``/rollout
arrays over a mesh 'data' axis and keep params replicated (or hidden-dim
sharded over an optional 'model' axis, models/policy.py:param_shardings);
XLA inserts the psum/all-gather collectives from the sharding annotations —
no hand-written communication.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from ..core.compile import CompiledChain
from ..envs.vector import VecState, make_vec_env
from ..models.policy import (MLPConfig, actor_critic_forward,
                             categorical_logp_entropy, discrete_forward,
                             init_actor_critic, init_discrete_actor_critic,
                             sample_tanh_gaussian, tanh_gaussian_logp)

__all__ = ["PPOConfig", "TrainState", "make_ppo", "make_beergame_ppo"]


class PPOConfig(NamedTuple):
    rollout_steps: int = 16
    epochs: int = 4
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    lr: float = 1e-3
    ent_coef: float = 1e-3
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    # L2 penalty on pre-tanh action means: keeps the squashed policy off the
    # tanh saturation rails where gradients vanish (the supply-chain optimum
    # near "order nothing" otherwise collapses the policy to a corner)
    pre_tanh_reg: float = 1e-3
    hidden: Tuple[int, ...] = (128, 128)
    # lax.scan unroll for the trajectory-collection scan: unrolling lets XLA
    # fuse across consecutive env steps, at a compile-time cost proportional
    # to the factor.  Matches bench.py's UNROLL_SC, so the trainer runs the
    # benchmarked configuration.
    rollout_unroll: int = 4
    # minibatches per epoch (one optimizer step per minibatch; 1 = the
    # full-batch update).  Chunks slice the ENV axis, so each spans every
    # timestep of a block of i.i.d. env lanes, in a freshly permuted order
    # per epoch; advantages are normalized over the FULL rollout batch
    # either way, so minibatches=1 reproduces the full-batch update
    minibatches: int = 1
    # trunk compute dtype for the UPDATE phase only (None = params dtype).
    # jnp.bfloat16 halves the stored-activation traffic of the update;
    # heads/log-probs stay f32 and the ROLLOUT forward is untouched.  The
    # learner has no env-parity obligation, so this trades a little gradient
    # precision for update throughput; quality is covered by
    # tests/test_vector_learn.py::test_ppo_improves_bf16_learner
    learner_dtype: Any = None


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    env: VecState
    key: jax.Array


class Trajectory(NamedTuple):
    obs: jax.Array       # [S, obs_dim, B]
    act_pre: jax.Array   # [S, A, B] pre-tanh actions
    logp: jax.Array      # [S, B]
    reward: jax.Array    # [S, B]
    value: jax.Array     # [S, B]
    done: jax.Array      # [S]


def _make_gae(cfg: PPOConfig):
    """Generalized advantage estimation over a [S, B] trajectory (shared by
    all the learners; ``done`` is per-step scalar — lockstep batches)."""
    def gae(traj: Trajectory, last_value):
        def body(carry, xs):
            gae, next_value = carry
            reward, value, done = xs
            nonterm = jnp.where(done, 0.0, 1.0)
            delta = reward + cfg.gamma * next_value * nonterm - value
            gae = delta + cfg.gamma * cfg.lam * nonterm * gae
            return (gae, value), gae

        (_, _), adv = jax.lax.scan(
            body, (jnp.zeros_like(last_value), last_value),
            (traj.reward, traj.value, traj.done), reverse=True,
            unroll=min(8, traj.reward.shape[0]))
        return adv, adv + traj.value

    return gae


def _make_cont_loss(cfg: PPOConfig):
    """Clipped-PPO loss for the continuous tanh-Gaussian policy over
    pre-flattened sample-trailing arrays (``obs [obs_dim, M]``,
    ``pre [A, M]``, the rest ``[M]``; advantages already normalized)."""
    def loss(params, obs, pre, old_logp, adv, ret):
        mu, log_std, value = actor_critic_forward(
            params, obs, compute_dtype=cfg.learner_dtype)
        logp = tanh_gaussian_logp(pre, mu, log_std)
        ratio = jnp.exp(logp - old_logp)
        pg = -jnp.minimum(
            ratio * adv,
            jnp.clip(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv).mean()
        vf = 0.5 * ((value - ret) ** 2).mean()
        # entropy of the squashed policy estimated as -E[log pi(a|s)]
        ent = -logp.mean()
        reg = (mu ** 2).mean()
        return (pg + cfg.vf_coef * vf - cfg.ent_coef * ent
                + cfg.pre_tanh_reg * reg), (pg, vf)

    return loss


def _flatten_traj(traj: Trajectory, adv, ret):
    """[S, X, B] trajectory -> sample-LAST update data ``(obs [X, S, B],
    pre [X, S, B], logp/adv/ret [S, B])`` with full-batch advantage
    normalization.  The transposes are hoisted OUT of the epoch scan (the
    pre-r4 trainer re-transposed the whole trajectory inside every epoch),
    and since r5 the update phase consumes the 3D layout directly
    (``_make_update``): the final flatten to the loss's [X, M] is a free
    reshape of the (S, B)-minor axes, and minibatch chunks slice the env
    axis — every chunk spans all timesteps of a block of i.i.d. env lanes
    instead of a temporally-correlated window."""
    advn = (adv - adv.mean()) / (adv.std() + 1e-8)
    return (traj.obs.transpose(1, 0, 2), traj.act_pre.transpose(1, 0, 2),
            traj.logp, advn, ret)


def _flat2(x):
    """[..., S, B] -> [..., S*B]: free for (S, B)-minor-contiguous layouts
    (the whole point of the sample-last update data contract)."""
    return x.reshape(x.shape[:-2] + (-1,))


def _make_update(cfg: PPOConfig, tx, loss_fn):
    """Epoch x minibatch clipped-PPO update scan.

    ``update(params, opt_state, data, key) -> (params, opt_state, losses)``
    where ``data`` is a tuple of sample-LAST arrays ([X, S, B] or [S, B]):
    the loss consumes [X, S*B] via a free reshape, so no trajectory-wide
    layout copy sits between collection and the matmuls.  Minibatches
    slice the env (B) axis — each chunk spans every timestep of a block of
    i.i.d. env lanes — in a freshly permuted order per epoch (``key``);
    minibatches=1 reproduces the full-batch update exactly."""
    def update(params, opt_state, data, key=None):
        Bb = data[0].shape[-1]
        mb = int(cfg.minibatches)
        if Bb % mb != 0:
            raise ValueError(f"minibatches {mb} must divide env batch {Bb}")
        bs = Bb // mb

        def step(carry, i):
            params, opt_state = carry
            if mb == 1:
                chunk = data
            else:
                chunk = tuple(
                    jax.lax.dynamic_slice_in_dim(d, i * bs, bs,
                                                 axis=d.ndim - 1)
                    for d in data)
            (loss, aux), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, *(_flat2(d) for d in chunk))
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        if key is None or mb == 1:
            idx = jnp.tile(jnp.arange(mb), cfg.epochs)
        else:
            # fresh chunk order per epoch
            idx = jax.vmap(lambda k: jax.random.permutation(k, mb))(
                jax.random.split(key, cfg.epochs)).reshape(-1)
        (params, opt_state), losses = jax.lax.scan(
            step, (params, opt_state), idx)
        return params, opt_state, losses

    return update


def make_ppo(cc: CompiledChain, batch_size: int, cfg: PPOConfig = PPOConfig(),
             dtype=jnp.float32, reward_scale: float = 1e-4):
    """Build (init_fn, train_step) for PPO on a compiled chain.

    ``init_fn(key) -> TrainState``; ``train_step(state) -> (state, metrics)``
    runs one rollout of ``cfg.rollout_steps`` and ``cfg.epochs`` full-batch
    PPO updates.  Jit/shard the returned function as a whole.
    """
    B = batch_size
    env_init, env_step, env_obs = make_vec_env(cc, B, dtype)
    mcfg = MLPConfig(obs_dim=cc.obs_dim, act_dim=cc.A, hidden=cfg.hidden)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(cfg.lr))

    def init_fn(key) -> TrainState:
        kp, ke, kk = jax.random.split(key, 3)
        params = init_actor_critic(kp, mcfg, dtype)
        return TrainState(params=params, opt_state=tx.init(params),
                          env=env_init(ke), key=kk)

    def _rollout(params, env_state: VecState, key):
        obs0 = env_obs(env_state)

        def body(carry, k):
            env_state, obs = carry
            mu, log_std, value = actor_critic_forward(params, obs)
            eps = jax.random.normal(k, mu.shape, mu.dtype)
            pre = mu + jnp.exp(log_std) * eps
            act = jnp.tanh(pre)
            logp = tanh_gaussian_logp(pre, mu, log_std)
            env_state, out = env_step(env_state, act)
            traj = Trajectory(obs=obs, act_pre=pre, logp=logp,
                              reward=out.reward * reward_scale, value=value,
                              done=out.done)
            return (env_state, out.obs), traj

        keys = jax.random.split(key, cfg.rollout_steps)
        (env_state, last_obs), traj = jax.lax.scan(
            body, (env_state, obs0), keys,
            unroll=min(cfg.rollout_unroll, cfg.rollout_steps))
        _, _, last_value = actor_critic_forward(params, last_obs)
        return env_state, traj, last_value

    _gae = _make_gae(cfg)
    _loss = _make_cont_loss(cfg)
    _update = _make_update(cfg, tx, _loss)

    def train_step(state: TrainState):
        key, kr = jax.random.split(state.key)
        env_state, traj, last_value = _rollout(state.params, state.env, kr)
        adv, ret = _gae(traj, last_value)
        data = _flatten_traj(traj, adv, ret)
        params, opt_state, losses = _update(
            state.params, state.opt_state, data,
            key=jax.random.fold_in(key, 0x7fb5))
        metrics = {"loss": losses[-1],
                   "mean_reward": traj.reward.mean() / reward_scale,
                   "mean_value": traj.value.mean()}
        return TrainState(params=params, opt_state=opt_state, env=env_state,
                          key=key), metrics

    # phase hooks for benchmarks/train_throughput.py's breakdown: the same
    # closures train_step composes, so phase timings measure the deployed
    # code, not a re-implementation
    train_step.rollout = _rollout
    train_step.gae = _gae
    train_step.loss = _loss
    train_step.update = _update
    return init_fn, train_step


def make_beergame_ppo(batch_size: int, cfg: PPOConfig = PPOConfig(),
                      levels: int = 4, weeks: int = 35, max_order: int = 16,
                      customer_demand=None, shipment_delays: int = 2,
                      initial_inventory: int = 12, v2: bool = False,
                      max_stock: int = 100, exceeded_capacity_penalty: int = 100,
                      dtype=jnp.float32, reward_scale: float = 1e-2):
    """PPO for the beer game's MultiDiscrete action space (SURVEY.md §7.5):
    one categorical head per chain level over ``max_order`` order quantities.

    The rollout runs continuous auto-reset episodes of the batched beer game
    kernel.  ``customer_demand`` / ``shipment_delays`` accept the reference
    v2's stochastic 2-element ``randint`` ranges (beergame2_env.py:41-58):
    fresh per-lane episode tables are then drawn on device at every
    auto-reset, so training covers the stochastic variants.  ``init_fn(key)
    -> TrainState``; ``train_step`` as in :func:`make_ppo`."""
    import numpy as np

    from ..core.beergame import make_beergame_kernels
    from ..envs.vector import _is_range, make_beergame_table_draw

    B = batch_size
    dem_range = customer_demand if _is_range(customer_demand) else None
    delay_range = shipment_delays if _is_range(shipment_delays) else None
    demand = delays = None
    if dem_range is None:
        demand = np.asarray(customer_demand if customer_demand is not None
                            else [4] * 4 + [8] * (weeks - 4), np.int32)
        weeks = len(demand)
    if delay_range is None:
        delays = np.full(weeks + 1, shipment_delays, np.int32)
        delays[0] = 2
        max_delay = int(delays.max())
    else:
        max_delay = max(2, int(delay_range[1]))
    stochastic = dem_range is not None or delay_range is not None
    draw = make_beergame_table_draw(weeks, dem_range, delay_range,
                                    demand, delays, jnp.int32)
    inv0 = np.full(levels, initial_inventory, np.int32)
    reset_k, step_k, obs_k = make_beergame_kernels(
        levels, weeks, max_delay, v2=v2, max_stock=max_stock,
        exceeded_capacity_penalty=exceeded_capacity_penalty, itype=jnp.int32)
    max_dem = float(demand.max()) if demand is not None \
        else float(dem_range[1] - 1)
    obs_scale = 1.0 / (4.0 * max_dem)                 # keep obs O(1)
    mcfg = MLPConfig(obs_dim=levels, act_dim=levels, hidden=cfg.hidden)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(cfg.lr))

    def _fresh(key):
        dem, dly = draw(key, B)
        return reset_k(dem, dly, inv0, 4, 4, B)

    def _obs(st):
        return obs_k(st).astype(dtype) * obs_scale

    def init_fn(key) -> TrainState:
        kp, ke, kk = jax.random.split(key, 3)
        params = init_discrete_actor_critic(kp, mcfg, max_order, dtype)
        return TrainState(params=params, opt_state=tx.init(params),
                          env=_fresh(ke), key=kk)

    def _rollout(params, env_state, key):
        obs0 = _obs(env_state)

        def body(carry, k):
            env_state, obs = carry
            logits, value = discrete_forward(params, obs, levels, max_order)
            act = jax.random.categorical(k, logits.transpose(0, 2, 1),
                                         axis=-1)            # [L, B]
            logp, _ = categorical_logp_entropy(logits, act)
            env_state, (next_obs, reward, done) = step_k(env_state, act)
            # fresh per-lane stochastic tables at the episode boundary; the
            # scalar cond keeps the reset body off the per-step hot path
            # (see envs/vector.py step_fn note)
            env_state = jax.lax.cond(
                done, lambda _: _fresh(jax.random.fold_in(k, 7)),
                lambda _: env_state, None)
            traj = Trajectory(obs=obs, act_pre=act, logp=logp,
                              reward=reward.astype(dtype) * reward_scale,
                              value=value, done=done)
            return (env_state, _obs(env_state)), traj

        keys = jax.random.split(key, cfg.rollout_steps)
        (env_state, last_obs), traj = jax.lax.scan(
            body, (env_state, obs0), keys,
            unroll=min(cfg.rollout_unroll, cfg.rollout_steps))
        _, last_value = discrete_forward(params, last_obs, levels, max_order)
        return env_state, traj, last_value

    _gae = _make_gae(cfg)

    def _loss(params, obs, act, old_logp, adv, ret):
        logits, value = discrete_forward(params, obs, levels, max_order)
        logp, ent = categorical_logp_entropy(logits, act)
        ratio = jnp.exp(logp - old_logp)
        pg = -jnp.minimum(ratio * adv,
                          jnp.clip(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv).mean()
        vf = 0.5 * ((value - ret) ** 2).mean()
        return pg + cfg.vf_coef * vf - cfg.ent_coef * ent.mean(), (pg, vf)

    _update = _make_update(cfg, tx, _loss)

    def train_step(state: TrainState):
        key, kr = jax.random.split(state.key)
        env_state, traj, last_value = _rollout(state.params, state.env, kr)
        adv, ret = _gae(traj, last_value)
        data = _flatten_traj(traj, adv, ret)
        params, opt_state, losses = _update(
            state.params, state.opt_state, data,
            key=jax.random.fold_in(key, 0x7fb5))
        metrics = {"loss": losses[-1],
                   "mean_reward": traj.reward.mean() / reward_scale,
                   "mean_value": traj.value.mean()}
        return TrainState(params=params, opt_state=opt_state, env=env_state,
                          key=key), metrics

    return init_fn, train_step
