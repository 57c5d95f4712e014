"""Optional Gymnasium integration.

The reference registers its envs with classic gym (gym_supplychain/__init__.py
:1-51).  Classic gym is dead; we provide the modern equivalent: a Gymnasium
``Env`` adapter (5-tuple step API, ``reset(seed=...)``) plus registration of
every environment id under the ``gym_supplychain_tpu/`` namespace, so
``gymnasium.make("gym_supplychain_tpu/sc-2perstage-v0")`` works when gymnasium
is installed.  The native 4-tuple wrappers remain the parity surface.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

__all__ = ["GymnasiumAdapter", "GymnasiumVectorAdapter", "register_gymnasium"]

try:
    import gymnasium as _gymnasium
    _EnvBase = _gymnasium.Env
except ImportError:          # pragma: no cover
    _EnvBase = object


class GymnasiumAdapter(_EnvBase):
    """Wrap a parity env (4-tuple API) as a gymnasium.Env."""

    metadata = {"render_modes": ["human"]}

    def __init__(self, env_id: str, **kwargs):
        import gymnasium
        from .. import make as _make
        self._env = _make(env_id, **kwargs)
        if hasattr(self._env, "action_space"):
            a = self._env.action_space
            if hasattr(a, "nvec"):
                self.action_space = gymnasium.spaces.MultiDiscrete(a.nvec)
                self.observation_space = gymnasium.spaces.MultiDiscrete(
                    self._env.observation_space.nvec)
            else:
                self.action_space = gymnasium.spaces.Box(
                    -1.0, 1.0, a.shape, np.float32)
                self.observation_space = gymnasium.spaces.Box(
                    -1.0, 1.0, self._env.observation_space.shape, np.float32)
        self._obs_dtype = (np.int64 if hasattr(self._env.observation_space, "nvec")
                           else np.float32)
        self._elapsed = 0

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None and hasattr(self._env, "seed"):
            self._env.seed(seed)
        obs = self._env.reset()
        self._elapsed = 0
        return np.asarray(obs, self._obs_dtype), {}

    def step(self, action):
        obs, reward, done, info = self._env.step(np.asarray(action))
        self._elapsed += 1
        # fixed-horizon episodes: report termination as truncation=False,
        # terminated=True at T (the reference has no truncation concept,
        # supplychain_env.py:742)
        return (np.asarray(obs, self._obs_dtype), float(reward), bool(done),
                False, info)

    def render(self):
        return self._env.render()

    def close(self):
        if hasattr(self._env, "close"):
            self._env.close()


class GymnasiumVectorAdapter:
    """Expose the batched engine through the ``gymnasium.vector``
    conventions (batch-FIRST arrays, autoreset every `T` steps, 5-tuple
    step).  The native batch-trailing layout stays on device; only the
    returned views are transposed.

    >>> vec = GymnasiumVectorAdapter("supplychain-ntom-v0", num_envs=4096)
    >>> obs, info = vec.reset(seed=0)          # obs [4096, obs_dim]
    >>> obs, r, term, trunc, info = vec.step(actions)   # actions [4096, A]
    """

    def __init__(self, env_id: str, num_envs: int = 1024, **kwargs):
        import gymnasium
        import jax.numpy as jnp
        from .. import make as _make
        from .vector import VecSupplyChainEnv

        proto = _make(env_id, **kwargs)
        if not hasattr(proto, "cc"):
            raise ValueError(f"{env_id!r} is not a supply-chain env; the "
                             "vector adapter covers the Box-action family")
        self.num_envs = num_envs
        self._vec = VecSupplyChainEnv(cc=proto.cc, batch_size=num_envs)
        A, O = proto.cc.A, proto.cc.obs_dim
        self.single_action_space = gymnasium.spaces.Box(-1., 1., (A,), np.float32)
        self.single_observation_space = gymnasium.spaces.Box(-1., 1., (O,), np.float32)
        self.action_space = gymnasium.spaces.Box(-1., 1., (num_envs, A), np.float32)
        self.observation_space = gymnasium.spaces.Box(-1., 1., (num_envs, O), np.float32)
        self._T = proto.cc.T
        self._jnp = jnp

    def reset(self, *, seed: Optional[int] = None, options=None):
        import jax
        if seed is not None:
            self._vec._key = jax.random.PRNGKey(seed)
        obs = self._vec.reset()
        return np.asarray(obs).T, {}

    def step(self, actions):
        out = self._vec.step(self._jnp.asarray(np.asarray(actions).T))
        done = bool(out.done)
        term = np.full(self.num_envs, done)
        trunc = np.zeros(self.num_envs, bool)
        return (np.asarray(out.obs).T, np.asarray(out.reward), term, trunc, {})

    def close(self):
        pass


def register_gymnasium() -> bool:
    """Register all ids with gymnasium (idempotent); returns success."""
    try:
        import gymnasium
        from gymnasium.envs.registration import register, registry
    except ImportError:
        return False
    from .. import _REGISTRY
    for env_id in _REGISTRY:
        full = f"gym_supplychain_tpu/{env_id}"
        if full in registry:
            continue
        register(id=full,
                 entry_point="gym_supplychain_tpu.envs.gym_registry:GymnasiumAdapter",
                 kwargs={"env_id": env_id})
    return True
