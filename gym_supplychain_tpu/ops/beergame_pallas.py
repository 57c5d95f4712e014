"""Pallas (Triton route) kernel: whole-episode beer-game trajectory collect.

The beer-game counterpart of ``ops/supplychain_pallas.py``: one program owns
``Bt`` env lanes and runs ``episodes`` back-to-back episodes in a
``lax.fori_loop``, writing each week's observation ``[L, Bt]`` and reward
``[Bt]`` rows to the ``[S, L, B]`` / ``[S, B]`` trajectory.  Inventory,
backlog, the order slips and the shipment pipeline are loop-carried int32
``[Bt]`` rows, one per level; the pipeline is a shift register (``pipe[j]``
arrives ``j + 1`` weeks from now), so every slot access is static.

Semantics match ``core/beergame.py`` with ``itype=int32`` bit for bit
(reference beergame_env.py:66-138): receive -> fill -> deliver -> record ->
place orders -> reward; a zero delay delivers straight into downstream
inventory (:93-96, :111-114).  ``v2=True`` switches orders to the action
verbatim (beergame2_env.py:168), adds the exceeded-capacity penalty
(:177-184) and offsets the observation by ``max_stock`` (:111-112).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .supplychain_pallas import DEFAULT_BATCH_TILE, _pad_lanes, num_warps_for

__all__ = ["make_beergame_collect_pallas"]


def make_beergame_collect_pallas(weeks: int, levels: int, B: int,
                                 episodes: int = 1, delay=2,
                                 init_delay: int = None, init_ship: int = 4,
                                 init_orders: int = 4, init_inv=12,
                                 inv_cost: int = 1, backlog_cost: int = 2,
                                 v2: bool = False, max_stock: int = 100,
                                 exceeded_capacity_penalty: int = 100,
                                 max_delay: int = None,
                                 batch_tile: int = DEFAULT_BATCH_TILE,
                                 interpret: bool = False):
    """Build the beer-game trajectory-collect kernel (v0 and v2).

    ``delay``: a constant shipment delay, or ``None`` for per-lane delay
    tables (the v2 stochastic-delay variant, beergame2_env.py:87-92; pass
    ``max_delay`` to size the pipeline).  ``init_delay`` is the reference's
    prepended initial delay governing the initially in-transit shipments
    (defaults to ``delay``, or 2 with per-lane delays).  ``init_inv`` is a
    scalar or one value per level.  With S = episodes * weeks:

    * constant delay -- ``run(demand, actions [S, L, B])``
    * per-lane delays -- ``run(demand, delays, actions)``, ``delays``
      ``[S, B]`` (or ``[S]``) int32, row s = week (s % weeks) + 1's delay

    ``demand`` is ``[weeks]``/``[weeks, B]`` (tiled across episodes) or
    ``[S, B]``.  Returns ``(obs [S, L, B], reward [S, B])`` int32.  ``B`` is
    padded to a multiple of ``batch_tile`` (a power of two) inside the
    wrapper.
    """
    Bt = int(batch_tile)
    if Bt <= 0 or Bt & (Bt - 1):
        raise ValueError(f"batch_tile {Bt} must be a power of two")
    per_lane = delay is None
    if per_lane:
        if max_delay is None:
            raise ValueError("per-lane delays need max_delay")
        if init_delay is None:
            init_delay = 2
    else:
        if init_delay is None:
            init_delay = delay
        max_delay = delay
    L = int(levels)
    W = int(weeks)
    E = int(episodes)
    S = E * W
    D = max(int(max_delay), int(init_delay), 1)   # pipeline slots
    nB = -(-B // Bt)
    Bp = nB * Bt
    i32 = jnp.int32
    inv0 = np.broadcast_to(np.asarray(init_inv, np.int32), (L,))

    def full(v):
        return jnp.full((Bt,), v, i32)

    def kernel(*refs):
        if per_lane:
            dem_ref, dly_ref, act_ref, obs_ref, rew_ref = refs
        else:
            dem_ref, act_ref, obs_ref, rew_ref = refs

        def episode(e, carry):
            # episode-initial state (beergame_env.py:39-52): the first
            # init_delay weeks each receive init_ship
            state = ([full(inv0[l]) for l in range(L)],
                     [full(0) for _ in range(L)],
                     [full(init_orders) for _ in range(L)],
                     [[full(init_ship if j < init_delay else 0)
                       for _ in range(L)] for j in range(D)])

            def week(w, state):
                inv, back, placed, pipe = state
                s = e * W + w
                # 1. receive this week's shipments
                inventory = [inv[l] + pipe[0][l] for l in range(L)]
                pipe = [list(row) for row in pipe[1:]] + [
                    [full(0) for _ in range(L)]]
                # 2. fill orders (incoming = customer demand, then the
                # downstream level's order slip)
                incoming = [dem_ref[s]] + placed[:-1]
                to_fill = [incoming[l] + back[l] for l in range(L)]
                deliver = [jnp.minimum(inventory[l], to_fill[l])
                           for l in range(L)]
                # 3. deliveries downstream + factory self-supply
                down = deliver[1:] + [placed[-1]]
                if per_lane:
                    dl = dly_ref[s]
                    inventory = [inventory[l] + jnp.where(dl == 0, down[l], 0)
                                 for l in range(L)]
                    for d in range(1, int(max_delay) + 1):
                        pipe[d - 1] = [pipe[d - 1][l]
                                       + jnp.where(dl == d, down[l], 0)
                                       for l in range(L)]
                elif delay == 0:
                    inventory = [inventory[l] + down[l] for l in range(L)]
                else:
                    pipe[delay - 1] = [pipe[delay - 1][l] + down[l]
                                       for l in range(L)]
                # 4. record inventory / backlog
                inventory = [inventory[l] - deliver[l] for l in range(L)]
                backlog = [to_fill[l] - deliver[l] for l in range(L)]
                # 5. place orders
                action = [act_ref[s, l] for l in range(L)]
                placed = action if v2 else [incoming[l] + action[l]
                                            for l in range(L)]
                # 6. observation and reward
                reward = full(0)
                for l in range(L):
                    reward = reward - (inv_cost * inventory[l]
                                       + backlog_cost * backlog[l])
                    obs = inventory[l] - backlog[l]
                    obs_ref[s, l] = max_stock + obs if v2 else obs
                if v2:
                    pen = full(0)
                    for l in range(L):
                        pen = pen + exceeded_capacity_penalty * (
                            jnp.maximum(inventory[l] - max_stock, 0)
                            + jnp.maximum(backlog[l] - max_stock, 0))
                    reward = reward - pen
                rew_ref[s] = reward
                return inventory, backlog, placed, pipe

            jax.lax.fori_loop(0, W, week, state)
            return carry

        jax.lax.fori_loop(0, E, episode, 0)

    def lanes(*lead):
        return pl.BlockSpec(lead + (Bt,),
                            lambda i: (0,) * len(lead) + (i,))

    in_specs = [lanes(S)] + ([lanes(S)] if per_lane else []) + [lanes(S, L)]
    call = pl.pallas_call(
        kernel,
        grid=(nB,),
        in_specs=in_specs,
        out_specs=[lanes(S, L), lanes(S)],
        out_shape=[jax.ShapeDtypeStruct((S, L, Bp), i32),
                   jax.ShapeDtypeStruct((S, Bp), i32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps_for(Bt), num_stages=1),
        interpret=interpret,
        name="beergame_collect",
    )

    def table(x):
        """[W]/[W, B]/[S]/[S, B] -> [S, Bp] int32 week-row table."""
        x = jnp.asarray(x, i32)
        if x.ndim == 1:
            x = jnp.broadcast_to(x[:, None], (x.shape[0], B))
        if x.shape[0] == W and W != S:
            x = jnp.tile(x, (E, 1))
        return _pad_lanes(x[:S], Bp, 0)

    def run(demand, *rest):
        if len(rest) != (2 if per_lane else 1):
            raise TypeError("run(demand, [delays,] actions): delays go with "
                            "per-lane delay tables only")
        args = [table(demand)]
        if per_lane:
            args.append(table(rest[0]))
        args.append(_pad_lanes(jnp.asarray(rest[-1], i32)[:S], Bp, 0))
        obs, rew = call(*args)
        return obs[..., :B], rew[:, :B]

    return jax.jit(run)
