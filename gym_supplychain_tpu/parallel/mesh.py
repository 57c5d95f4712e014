"""Device mesh setup and sharding layouts.

Replacement for a distributed communication backend (the reference has none;
SURVEY.md §2/§5): an optional multi-process runtime via
``jax.distributed.initialize`` with one card per process, a ``Mesh`` with a
``data`` axis (env batch) and an optional ``model`` axis (TP hook for the
learner's hidden dims), and NamedShardings over the batch-trailing arrays.
All collectives are emitted by XLA from these annotations (NCCL between
GPUs, within a machine over NVLink) — no explicit send/recv anywhere.
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["init_distributed", "make_mesh", "trailing_sharding",
           "shard_vec_state", "replicated", "train_state_shardings"]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None):
    """Initialize multi-process JAX (no-op for a single process).

    Nothing detects a cluster, so all three values are explicit:
    ``coordinator_address`` is process 0's ``host:port``.  Each process
    opens only ``local_device_ids`` — by default ``[process_id]``, one card
    per process on one machine — so no process reserves memory on another
    process's card.  Call before anything touches a device.
    """
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("multi-process runs need coordinator_address and "
                         "process_id")
    if local_device_ids is None:
        local_device_ids = [process_id]
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices=None) -> Mesh:
    """Mesh with ('data', 'model') axes over all (or given) devices.

    ``data`` defaults to n_devices // model.  With model=1 this is the pure
    env-batch data-parallel mesh of the north-star config.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if data is None:
        data = n // model
    assert data * model == n, f"{data}x{model} != {n} devices"
    return Mesh(devices.reshape(data, model), ("data", "model"))


def trailing_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the trailing (env batch) axis of an ndim-array over 'data'."""
    return NamedSharding(mesh, P(*([None] * (ndim - 1) + ["data"])))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def train_state_shardings(mesh: Mesh, shapes, hidden_axis: Optional[str] = None):
    """Sharding tree for a PPO ``TrainState`` (learn/ppo.py) over ``mesh``:
    params/opt_state/PRNG keys replicated (optionally trunk hidden dims over
    ``hidden_axis``), env arrays sharded on their trailing env-batch axis.

    ``shapes`` is ``jax.eval_shape(init_fn, key)``.  Use as ``out_shardings``
    of a jitted ``init_fn`` so state is created directly with GLOBAL
    shardings — required in multi-process (multi-host) runs, where arrays
    built outside jit would be committed to process-local devices.
    """
    def repl(_=None):
        return NamedSharding(mesh, P())

    def trailing(x):
        if getattr(x, "ndim", 0) == 0:
            return repl()
        return trailing_sharding(mesh, x.ndim)

    if hidden_axis and hidden_axis in mesh.axis_names:
        from ..models.policy import param_shardings
        params_sh = param_shardings(shapes.params, mesh, hidden_axis)
    else:
        params_sh = jax.tree.map(repl, shapes.params)
    def env_tree(es):
        sh = jax.tree.map(trailing, es)
        # EnvState in stateless-RNG mode carries the episode PRNG key —
        # replicate it (every shard draws the same stream; lane independence
        # comes from the draw's batch axis, which IS sharded)
        if hasattr(es, "_fields") and "ep_key" in es._fields \
                and es.ep_key is not None:
            sh = sh._replace(ep_key=repl())
        return sh

    env_shapes = shapes.env
    if hasattr(env_shapes, "_fields") and \
            {"key", "env"} <= set(env_shapes._fields):
        # VecState: replicate its PRNG key, shard the inner EnvState
        env_sh = env_shapes._replace(key=repl(), env=env_tree(env_shapes.env))
    else:
        # bare env state (e.g. BeerGameState): all arrays batch-trailing
        env_sh = env_tree(env_shapes)
    return shapes._replace(
        params=params_sh,
        opt_state=jax.tree.map(repl, shapes.opt_state),
        env=env_sh,
        key=repl(),
    )


def shard_vec_state(mesh: Mesh, state):
    """Place a ``VecState``/``EnvState`` pytree with every array's trailing
    env-batch axis sharded over 'data' (PRNG keys and scalars replicated)."""
    def place(x):
        if not hasattr(x, "ndim") or x.ndim == 0:
            return jax.device_put(x, replicated(mesh))
        if hasattr(x, "dtype") and x.dtype == jax.random.PRNGKey(0).dtype \
                and x.ndim == 1:
            return jax.device_put(x, replicated(mesh))
        return jax.device_put(x, trailing_sharding(mesh, x.ndim))
    return jax.tree.map(place, state)
