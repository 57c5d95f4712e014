"""Single-env, reference-compatible wrapper around the batched kernels.

This is the drop-in parity surface: same constructor schema, ``seed`` /
``reset`` / ``step`` / ``render`` protocol and info structure as the
reference ``SupplyChainEnv`` (supplychain_env.py:478-813), backed by the
B=1 slice of the vectorized kernels.  Stochastic inputs come from the
host-side MT19937 generator so fixed-seed tables match the reference
bit-exactly (see rng/host.py).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.compile import CompiledChain, compile_chain
from ..core.step import COST_KEYS, EnvState, make_supplychain_kernels
from ..rng.gym_compat import OldGymBox
from ..rng.host import HostEpisodeRNG

__all__ = ["SupplyChainEnv"]


def _default_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


class SupplyChainEnv:
    """Gym-style single environment over the compiled chain.

    ``nodes_info`` and all keyword arguments use the reference schema
    (supplychain_env.py:482-489).
    """

    def __init__(self, nodes_info: Dict[str, Dict[str, Any]], num_products=1,
                 unmet_demand_cost=1000, exceeded_stock_capacity_cost=1000,
                 exceeded_process_capacity_cost=1000,
                 exceeded_ship_capacity_cost=1000,
                 demand_config_by_product=False, demand_range=(10, 20),
                 demand_std=None, demand_sen_peaks=None, avg_demand_range=None,
                 processing_ratio=3, stochastic_leadtimes=False,
                 avg_leadtime=2, max_leadtime=2, total_time_steps=360,
                 seed=None, build_info=False, demand_perturb_norm=False,
                 dtype=None, strict_obs=False):
        self.cc: CompiledChain = compile_chain(
            nodes_info, num_products=num_products,
            unmet_demand_cost=unmet_demand_cost,
            exceeded_stock_capacity_cost=exceeded_stock_capacity_cost,
            exceeded_process_capacity_cost=exceeded_process_capacity_cost,
            exceeded_ship_capacity_cost=exceeded_ship_capacity_cost,
            demand_config_by_product=demand_config_by_product,
            demand_range=demand_range, demand_std=demand_std,
            demand_sen_peaks=demand_sen_peaks,
            avg_demand_range=avg_demand_range,
            processing_ratio=processing_ratio,
            stochastic_leadtimes=stochastic_leadtimes,
            avg_leadtime=avg_leadtime, max_leadtime=max_leadtime,
            total_time_steps=total_time_steps,
            demand_perturb_norm=demand_perturb_norm)
        self.num_products = num_products
        self.build_info = build_info
        self.dtype = dtype or _default_dtype()
        # strict_obs: bit-exact observation parity incl. the reference's
        # heap-array-order quirk (SURVEY.md §2.1-7) via a host heap mirror
        # fed by the kernel's push introspection outputs
        self.strict_obs = bool(strict_obs)
        reset_fn, step_fn, obs_fn = make_supplychain_kernels(
            self.cc, dtype=self.dtype, debug=self.strict_obs)
        # jit everything: eager dispatch costs dwarf these tiny kernels
        self._reset_fn = jax.jit(reset_fn, static_argnums=2)
        self._obs_fn = jax.jit(obs_fn)
        self._step_jit = jax.jit(step_fn)
        if self.strict_obs:
            from .strict_obs import HeapMirror
            self._mirror = HeapMirror(self.cc)
        self._rng = HostEpisodeRNG(self.cc, seed)
        self.action_space = OldGymBox(-1.0, 1.0, (self.cc.A,))
        self.observation_space = OldGymBox(-1.0, 1.0, (self.cc.obs_dim,))
        self.state: Optional[EnvState] = None
        self.current_state = None
        self.current_reward = 0.0
        self.current_info: Dict[str, Any] = {}

    # -- gym protocol ------------------------------------------------------
    def seed(self, seed=None):
        """Re-seed env RNG; the action space is hard-seeded with 0, exactly
        like the reference (supplychain_env.py:811-813)."""
        self._rng.seed(seed)
        self.action_space.seed(0)

    def reset(self):
        demands, leadtimes = self._rng.episode_tables()
        self.customer_demands = demands          # [T+1, R, P] int
        self.leadtimes = leadtimes               # [T, K] int or None
        self.state = self._reset_fn(demands, leadtimes, 1)
        if self.strict_obs:
            self._mirror.reset()
            self.current_state = self._mirror.build_observation(
                0, jax.device_get(self.state.stock)[..., 0], demands)
        else:
            self.current_state = jax.device_get(self._obs_fn(self.state))[:, 0]
        self.current_reward = 0.0
        self.current_info = {}
        return self.current_state

    def step(self, action):
        # the reference slices exactly the entries each node consumes, so a
        # longer action vector's tail is silently ignored (its tests rely on
        # this, e.g. test_supplychain_env.py:73 passes 6 values to 4 actions)
        action = np.asarray(action).ravel()[:self.cc.A]
        a = jnp.asarray(action.reshape(self.cc.A, 1))
        self.state, out = self._step_jit(self.state, a)
        # one batched device->host fetch per step (individual __array__ calls
        # carry several ms of overhead each under this runtime)
        if self.build_info:
            obs, reward, done, epr, epc, epu = jax.device_get(
                (out.obs, out.reward, out.done, self.state.ep_reward,
                 self.state.ep_costs, self.state.ep_units))
            self.current_info = self._build_return_info(epr, epc, epu)
        else:
            obs, reward, done = jax.device_get((out.obs, out.reward, out.done))
        self.current_state = obs[:, 0]
        if self.strict_obs:
            t = int(self.state.t)
            adt = action.dtype if np.issubdtype(action.dtype, np.floating) \
                else np.float64
            self._mirror.step(t, out.sup_push, out.sup_lt, out.ship_push,
                              out.ship_lt, action_dtype=adt)
            self.current_state = self._mirror.build_observation(
                t, jax.device_get(self.state.stock)[..., 0],
                self.customer_demands)
        self.current_reward = float(reward[0])
        return self.current_state, self.current_reward, bool(done), self.current_info

    def _build_return_info(self, ep_reward, ep_costs, ep_units):
        ep_costs = ep_costs[..., 0]
        ep_units = ep_units[..., 0]
        return {"sc_episode": {
            "rewards": float(ep_reward[0]),
            "costs": {k: list(ep_costs[i]) for i, k in enumerate(COST_KEYS)},
            "units": {k: list(ep_units[i]) for i, k in enumerate(COST_KEYS)},
        }}

    # -- state inspection (test/debug surface) -----------------------------
    @property
    def time_step(self) -> int:
        return int(self.state.t)

    def stock(self, node) -> np.ndarray:
        """Stock per product of a node (by name or index)."""
        n = node if isinstance(node, int) else self.cc.node_index(node)
        return jax.device_get(self.state.stock)[n, :, 0]

    def pipeline(self, node, prod: int = 0):
        """In-transit material of a node/product as [(arrival_time, amount)],
        aggregated per arrival time (the dense equivalent of the reference's
        ``shipments_by_prod`` heap contents)."""
        n = node if isinstance(node, int) else self.cc.node_index(node)
        t = int(self.state.t)
        pipe = jax.device_get(self.state.pipe)[:, n, prod, 0]
        return [(t + 1 + j, float(v)) for j, v in enumerate(pipe) if v != 0]

    def render(self, mode="human"):
        t = int(self.state.t)
        print("TIMESTEP:", t)
        for i, name in enumerate(self.cc.node_names):
            desc = f"{name} ("
            for p in range(self.cc.P):
                desc += "[" + ", ".join(
                    f"{tt} {round(a, 1)}" for tt, a in self.pipeline(i, p)) + "]"
            desc += f") [{np.round(self.stock(i), 1)}]"
            print(desc)
        print("Next demands  :", self.customer_demands[t])
        print("Current reward:", round(self.current_reward, 3))
        print("=" * 30)

    def close(self):
        pass
