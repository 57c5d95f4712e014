"""Policy/value networks for the supply-chain envs (pure JAX pytrees).

The reference has no model code at all (SURVEY.md §3.5: training was external
stable-baselines); this supplies the missing learner layer natively.  Obs are
small (<~100 dims) so the policy is an MLP; batch stays the trailing axis
(``x[obs_dim, B]``) so layers are ``W[h_out, h_in] @ x`` with the batch as
the matmul's wide N dimension.  No precision is set: float32 products may
run as TF32 on a GPU at default precision (set
``jax.default_matmul_precision("highest")`` where a comparison needs full
float32).

Tensor-parallel hook: ``hidden_sharding`` names a mesh axis to shard the
hidden dimension over (SURVEY.md §2 TP row: documented as an optional pjit
axis, not bespoke machinery — XLA inserts the collectives).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["MLPConfig", "init_actor_critic", "actor_critic_forward",
           "sample_tanh_gaussian", "tanh_gaussian_logp", "param_shardings",
           "init_discrete_actor_critic", "discrete_forward",
           "categorical_logp_entropy"]

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0


class MLPConfig(NamedTuple):
    obs_dim: int
    act_dim: int
    hidden: Tuple[int, ...] = (128, 128)


def init_actor_critic(key, cfg: MLPConfig, dtype=jnp.float32) -> Dict[str, Any]:
    """Orthogonal-ish init actor-critic trunk + heads."""
    def dense(key, n_out, n_in, scale):
        w = jax.random.normal(key, (n_out, n_in), dtype) * scale / np.sqrt(n_in)
        return {"w": w, "b": jnp.zeros((n_out, 1), dtype)}

    keys = jax.random.split(key, 2 * len(cfg.hidden) + 3)
    params = {"actor": [], "critic": []}
    n_in = cfg.obs_dim
    for i, h in enumerate(cfg.hidden):
        params["actor"].append(dense(keys[2 * i], h, n_in, 1.0))
        params["critic"].append(dense(keys[2 * i + 1], h, n_in, 1.0))
        n_in = h
    params["mu"] = dense(keys[-3], cfg.act_dim, n_in, 0.01)
    params["v"] = dense(keys[-2], 1, n_in, 1.0)
    params["log_std"] = jnp.full((cfg.act_dim, 1), -0.5, dtype)
    return params


def actor_critic_forward(params, obs, compute_dtype=None):
    """obs[obs_dim, B] -> (mu[A, B], log_std[A, 1], value[B]).

    ``compute_dtype`` (e.g. ``jnp.bfloat16``) runs the TRUNK matmuls and
    activations in that dtype with f32 master params, halving the memory
    traffic of the stored activations in the PPO update.  Heads always
    compute in the params' dtype (f32): ``mu``/``value`` feed the log-prob and ratio math, which
    is precision-sensitive.  ``None`` keeps everything in the params'
    dtype (the rollout/parity path)."""
    if compute_dtype is not None:
        a = c = obs.astype(compute_dtype)
        for layer in params["actor"]:
            a = jnp.tanh(layer["w"].astype(compute_dtype) @ a
                         + layer["b"].astype(compute_dtype))
        for layer in params["critic"]:
            c = jnp.tanh(layer["w"].astype(compute_dtype) @ c
                         + layer["b"].astype(compute_dtype))
        a = a.astype(params["mu"]["w"].dtype)
        c = c.astype(params["v"]["w"].dtype)
    else:
        a = obs
        c = obs
        for layer in params["actor"]:
            a = jnp.tanh(layer["w"] @ a + layer["b"])
        for layer in params["critic"]:
            c = jnp.tanh(layer["w"] @ c + layer["b"])
    mu = params["mu"]["w"] @ a + params["mu"]["b"]
    v = (params["v"]["w"] @ c + params["v"]["b"])[0]
    log_std = jnp.clip(params["log_std"], LOG_STD_MIN, LOG_STD_MAX)
    return mu, log_std, v


def sample_tanh_gaussian(key, mu, log_std):
    """Tanh-squashed Gaussian sample for the Box(-1, 1) action space.
    Returns (action in (-1, 1), log-prob)."""
    eps = jax.random.normal(key, mu.shape, mu.dtype)
    pre = mu + jnp.exp(log_std) * eps
    act = jnp.tanh(pre)
    logp = tanh_gaussian_logp(pre, mu, log_std)
    return act, logp


def tanh_gaussian_logp(pre_tanh, mu, log_std):
    """Log-density of tanh(N(mu, std)) evaluated at tanh(pre_tanh),
    summed over the action axis -> [B]."""
    std = jnp.exp(log_std)
    g = -0.5 * (((pre_tanh - mu) / std) ** 2 + 2 * log_std
                + jnp.log(2 * jnp.pi))
    # tanh change of variables: log(1 - tanh(x)^2) = 2(log2 - x - softplus(-2x))
    corr = 2 * (jnp.log(2.0) - pre_tanh - jax.nn.softplus(-2 * pre_tanh))
    return (g - corr).sum(axis=0)


def init_discrete_actor_critic(key, cfg: MLPConfig, n_choices: int,
                               dtype=jnp.float32) -> Dict[str, Any]:
    """Actor-critic for a MultiDiscrete action space (the beer game's order
    quantities, reference beergame2_env.py:27): ``cfg.act_dim`` independent
    categoricals with ``n_choices`` options each, sharing the obs trunk."""
    params = init_actor_critic(key, cfg, dtype)
    del params["mu"], params["log_std"]
    n_in = cfg.hidden[-1] if cfg.hidden else cfg.obs_dim
    klog = jax.random.fold_in(key, 7)
    w = jax.random.normal(klog, (cfg.act_dim * n_choices, n_in), dtype)
    params["logits"] = {"w": w * 0.01 / np.sqrt(n_in),
                        "b": jnp.zeros((cfg.act_dim * n_choices, 1), dtype)}
    return params


def discrete_forward(params, obs, act_dim: int, n_choices: int):
    """obs[obs_dim, B] -> (logits[act_dim, n_choices, B], value[B])."""
    a = obs
    c = obs
    for layer in params["actor"]:
        a = jnp.tanh(layer["w"] @ a + layer["b"])
    for layer in params["critic"]:
        c = jnp.tanh(layer["w"] @ c + layer["b"])
    logits = params["logits"]["w"] @ a + params["logits"]["b"]
    v = (params["v"]["w"] @ c + params["v"]["b"])[0]
    return logits.reshape(act_dim, n_choices, -1), v


def categorical_logp_entropy(logits, act):
    """logits[A, n, B], act[A, B] int -> (logp[B], entropy[B]).

    Log-prob summed over the independent action dims; entropy is the sum of
    the per-dim categorical entropies (exact, not a sample estimate)."""
    logp_all = jax.nn.log_softmax(logits, axis=1)          # [A, n, B]
    logp_act = jnp.take_along_axis(logp_all, act[:, None, :], axis=1)[:, 0]
    ent = -(jnp.exp(logp_all) * logp_all).sum(axis=1)      # [A, B]
    return logp_act.sum(axis=0), ent.sum(axis=0)


def param_shardings(params, mesh, hidden_axis: Optional[str] = "model"):
    """NamedSharding tree: replicate everything except the hidden dims of the
    trunk layers, which shard over ``hidden_axis`` when the mesh has it
    (the optional TP axis).  Returns a pytree matching ``params``."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def repl():
        return NamedSharding(mesh, P())

    def shard_hidden(n_axes):
        if hidden_axis and hidden_axis in mesh.axis_names:
            return NamedSharding(mesh, P(hidden_axis, *([None] * (n_axes - 1))))
        return repl()

    out = {"actor": [], "critic": []}
    for branch in ("actor", "critic"):
        for layer in params[branch]:
            out[branch].append({"w": shard_hidden(2), "b": shard_hidden(2)})
    # heads contract over the (sharded) hidden axis -> replicate outputs
    for head in ("mu", "v", "logits"):
        if head in params:
            out[head] = {"w": repl(), "b": repl()}
    if "log_std" in params:
        out["log_std"] = repl()
    return out
