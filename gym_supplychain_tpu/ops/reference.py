"""Random episode tables and plain references for the collect kernels.

The kernels in ``supplychain_pallas.py`` and ``beergame_pallas.py`` replay
episode tables; their plain reference is the scan engine (``core/step.py``
in table mode, ``core/beergame.py``) stepping the same tables under
``lax.scan``.  The table draws here are what the benchmark times in front of
each kernel call: ``rng/device.py``'s demand and lead-time tables plus
uniform actions, so the timed inputs are the checked inputs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.beergame import make_beergame_kernels
from ..core.compile import CompiledChain
from ..core.step import make_supplychain_kernels
from ..rng.device import device_demand_tables, device_leadtime_tables
from .beergame_pallas import make_beergame_collect_pallas
from .supplychain_pallas import (DEFAULT_BATCH_TILE,
                                 make_supplychain_collect_pallas)

__all__ = ["supplychain_tables", "supplychain_scan_trajectory",
           "compare_supplychain", "BEERGAME_CONFIGS", "beergame_tables",
           "beergame_scan_trajectory", "beergame_kernel",
           "compare_beergame"]

# Tolerances of the supply-chain kernel against the scan engine in float32:
# the state follows the same operations in the same order, the reward sums
# its cost terms in another association.
OBS_ATOL = 1e-5
REWARD_RTOL = 1e-5


def supplychain_tables(key, cc: CompiledChain, B: int):
    """One episode's tables: demands ``[T+1, R, P, B]`` f32, lead-times
    ``[T, K, B]`` int32 (None for constant lead-times) and actions
    ``[T, A, B]`` uniform in [-1, 1]."""
    kd, kl, ka = jax.random.split(key, 3)
    dem = device_demand_tables(kd, cc, B)
    lt = (device_leadtime_tables(kl, cc, B) if cc.stochastic_leadtimes
          else None)
    act = jax.random.uniform(ka, (cc.T, cc.A, B), jnp.float32, -1.0, 1.0)
    return dem, lt, act


def supplychain_scan_trajectory(cc: CompiledChain, demands, leadtimes,
                                actions):
    """Scan-engine trajectory of one episode: ``(obs [T, O, B],
    rewards [T, B])`` with ``obs[t]`` the observation before step t."""
    reset_fn, step_fn, obs_fn = make_supplychain_kernels(cc)
    st = reset_fn(demands, leadtimes, actions.shape[-1])

    def body(carry, a):
        st, obs = carry
        st, out = step_fn(st, a)
        return (st, out.obs), (obs, out.reward)

    _, (obs, rew) = jax.lax.scan(body, (st, obs_fn(st)), actions)
    return obs, rew


def compare_supplychain(cc: CompiledChain, B: int, seed: int = 0,
                        batch_tile: int = DEFAULT_BATCH_TILE,
                        interpret: bool = False):
    """Kernel vs scan engine on one episode of identical random tables.
    Returns ``(max |obs diff|, max |reward diff| / max |reward|)``."""
    run = make_supplychain_collect_pallas(cc, B, batch_tile=batch_tile,
                                          interpret=interpret)

    @jax.jit
    def errors(key):
        dem, lt, act = supplychain_tables(key, cc, B)
        obs, rew = (run(dem, lt, act) if lt is not None
                    else run(dem, act))
        ref_obs, ref_rew = supplychain_scan_trajectory(cc, dem, lt, act)
        return (jnp.abs(obs - ref_obs).max(),
                jnp.abs(rew - ref_rew).max() / jnp.abs(ref_rew).max())

    obs_err, rew_rel = jax.device_get(errors(jax.random.PRNGKey(seed)))
    return float(obs_err), float(rew_rel)


# The beer-game configurations the benchmark and the checks run: the
# classic scripted game (reference beergame_env.py defaults) and v2 with
# stochastic demand and delays (beergame2_env.py:41-58, :87-92).
BEERGAME_CONFIGS = {
    "beergame-v0": dict(levels=4, weeks=35, demand=[4] * 4 + [8] * 31,
                        delay=2, max_order=16),
    "beergame-v2": dict(levels=4, weeks=35, demand_range=(0, 12),
                        delay_range=(0, 4), max_order=16, v2=True,
                        max_stock=100, penalty=100),
}


def beergame_tables(key, name: str, B: int, episodes: int = 1):
    """``(demand [S, B], delays [S, B] or None, actions [S, L, B])`` int32
    for S = episodes * weeks.  Delays are per lane for stochastic configs
    (row s = week (s % weeks) + 1's delay) and None otherwise."""
    c = BEERGAME_CONFIGS[name]
    W, L, S = c["weeks"], c["levels"], episodes * c["weeks"]
    kd, kl, ka = jax.random.split(key, 3)
    if "demand_range" in c:
        dem = jax.random.randint(kd, (S, B), *c["demand_range"], jnp.int32)
    else:
        dem = jnp.broadcast_to(
            jnp.tile(jnp.asarray(c["demand"], jnp.int32), episodes)[:, None],
            (S, B))
    dly = (jax.random.randint(kl, (S, B), *c["delay_range"], jnp.int32)
           if "delay_range" in c else None)
    act = jax.random.randint(ka, (S, L, B), 0, c["max_order"], jnp.int32)
    return dem, dly, act


def beergame_kernel(name: str, B: int, episodes: int = 1,
                    batch_tile: int = DEFAULT_BATCH_TILE,
                    interpret: bool = False):
    """The collect kernel for a named config: ``run(demand, [delays,]
    actions)``."""
    c = BEERGAME_CONFIGS[name]
    kw = dict(episodes=episodes, batch_tile=batch_tile, interpret=interpret,
              v2=c.get("v2", False), max_stock=c.get("max_stock", 100),
              exceeded_capacity_penalty=c.get("penalty", 100))
    if "delay_range" in c:
        kw.update(delay=None, max_delay=c["delay_range"][1] - 1)
    else:
        kw.update(delay=c["delay"])
    return make_beergame_collect_pallas(c["weeks"], c["levels"], B, **kw)


def beergame_scan_trajectory(name: str, dem, dly, act, episodes: int = 1):
    """``core/beergame.py`` trajectory over the same tables: back-to-back
    episodes, each from the reset state.  Returns ``(obs [S, L, B],
    reward [S, B])``."""
    c = BEERGAME_CONFIGS[name]
    W, L, B = c["weeks"], c["levels"], act.shape[-1]
    max_delay = max(2, c["delay_range"][1] - 1 if "delay_range" in c
                    else c["delay"])
    reset_fn, step_fn, _ = make_beergame_kernels(
        L, W, max_delay, v2=c.get("v2", False),
        max_stock=c.get("max_stock", 0),
        exceeded_capacity_penalty=c.get("penalty", 0) if c.get("v2") else 0,
        itype=jnp.int32)
    if dly is None:
        dly = jnp.full((episodes * W, B), c["delay"], jnp.int32)

    def episode(_, xs):
        d, dl, acts = xs
        # slot 0 is the prepended initial delay (beergame2_env.py:50)
        dtab = jnp.concatenate([jnp.full((1, B), 2, jnp.int32), dl])
        st = reset_fn(d, dtab, [12] * L, 4, 4, B)

        def body(st, a):
            st, (o, r, _) = step_fn(st, a)
            return st, (o, r)

        _, (obs, rew) = jax.lax.scan(body, st, acts)
        return 0, (obs, rew)

    _, (obs, rew) = jax.lax.scan(
        episode, 0, (dem.reshape(episodes, W, B), dly.reshape(episodes, W, B),
                     act.reshape(episodes, W, L, B)))
    return obs.reshape(episodes * W, L, B), rew.reshape(episodes * W, B)


def compare_beergame(name: str, B: int, seed: int = 0, episodes: int = 2,
                     batch_tile: int = DEFAULT_BATCH_TILE,
                     interpret: bool = False):
    """Kernel vs scan engine on identical tables across ``episodes``
    back-to-back episodes.  Returns ``(max |obs diff|, max |reward diff|)``
    as ints; both are 0 when the kernel is bit-exact."""
    run = beergame_kernel(name, B, episodes, batch_tile, interpret)

    @jax.jit
    def errors(key):
        dem, dly, act = beergame_tables(key, name, B, episodes)
        obs, rew = run(dem, dly, act) if dly is not None else run(dem, act)
        ref_obs, ref_rew = beergame_scan_trajectory(name, dem, dly, act,
                                                    episodes)
        return jnp.abs(obs - ref_obs).max(), jnp.abs(rew - ref_rew).max()

    obs_err, rew_err = jax.device_get(errors(jax.random.PRNGKey(seed)))
    return int(obs_err), int(rew_err)
