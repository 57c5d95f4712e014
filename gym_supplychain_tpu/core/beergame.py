"""Batched MIT Beer Game kernels (v0 and v2).

The reference beer game (beergame_env.py:6-181, beergame2_env.py:5-211)
stores shipments densely as ``shipments[time, level]`` over the whole
episode.  Here the per-week update becomes a batched array op over
``[levels, B]`` state with the batch as the trailing (contiguous) axis, and the
shipment pipeline collapses to a **ring buffer** ``[max_delay+1, levels, B]``
indexed by ``week % R``: a shipment placed with delay d in 1..max_delay lands
at slot ``(week+d) % R``, which never collides with the current week's slot,
so arrival semantics are identical to the episode-length buffer while the
per-step state traffic shrinks from O(weeks) to O(max_delay) — this is what
keeps the scan body's state small.

Semantics reproduced exactly (integer arithmetic like upstream):

* 6-phase week: receive shipments -> fill orders incl. backlog -> record
  inventory/backlog -> advance order slips -> place orders -> reward
  (beergame_env.py:66-138).
* zero-delay weeks deliver straight into downstream inventory
  (beergame_env.py:93-96, :111-114).
* v0 orders = incoming + action (:121); v2 orders = action verbatim
  (beergame2_env.py:168).
* v2 adds the exceeded-capacity penalty on inventory/backlog beyond
  ``max_stock`` (beergame2_env.py:177-184) and the offset observation
  ``max_stock + inventory - backlog`` (:111-112).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["BeerGameState", "make_beergame_kernels"]


class BeerGameState(NamedTuple):
    week: jnp.ndarray            # scalar int32
    inventory: jnp.ndarray       # [L, B] int
    backlog: jnp.ndarray         # [L, B] int
    orders_placed: jnp.ndarray   # [L, B] int
    incoming_orders: jnp.ndarray  # [L, B] int
    shipments: jnp.ndarray       # [R, L, B] int ring buffer, slot = week % R
    customer_demand: jnp.ndarray  # [max_weeks, B] int
    shipment_delays: jnp.ndarray  # [max_weeks + 1, B] int
    inventory_costs: jnp.ndarray  # [L, B]
    backlog_costs: jnp.ndarray   # [L, B]
    penalty_costs: jnp.ndarray   # [L, B]


def make_beergame_kernels(levels: int, max_weeks: int, max_delay: int,
                          inv_cost=1, backlog_cost=2,
                          exceeded_capacity_penalty=0, max_stock: int = 0,
                          v2: bool = False, itype=jnp.int64):
    """Build (reset_fn, step_fn) for a beer game family.

    ``max_delay`` bounds every shipment-delay value (including the prepended
    initial delay in slot 0 of the delays table) and statically sizes the
    ring buffer: R = max_delay + 1.
    """
    L = levels
    R = max_delay + 1

    def reset_fn(customer_demand, shipment_delays, initial_inventory,
                 initial_shipment_value, initial_orders_value, B: int):
        """State from episode tables.

        ``customer_demand`` [max_weeks(+)] or [max_weeks, B];
        ``shipment_delays`` [max_weeks + 1] or [max_weeks + 1, B] (slot 0 is
        the prepended initial delay, beergame_env.py:39 / beergame2_env.py:50).
        """
        demand = jnp.asarray(customer_demand, itype)
        if demand.ndim == 1:
            demand = jnp.broadcast_to(demand[:, None], (demand.shape[0], B))
        delays = jnp.asarray(shipment_delays, itype)
        if delays.ndim == 1:
            delays = jnp.broadcast_to(delays[:, None], (delays.shape[0], B))
        inv0 = jnp.broadcast_to(jnp.asarray(initial_inventory, itype)[:, None],
                                (L, B))
        # shipments[1 : 1 + delays[0]] = initial_shipment_value
        # (beergame_env.py:50-52); weeks 1..delays[0] <= max_delay map to
        # distinct ring slots 1..delays[0]
        ridx = jnp.arange(R, dtype=itype)[:, None]                  # [R,1]
        seeded = ((ridx >= 1) & (ridx <= delays[0][None, :]))       # [R,B]
        ship0 = jnp.where(seeded[:, None, :],
                          jnp.asarray(initial_shipment_value, itype),
                          jnp.zeros((), itype))
        ship0 = jnp.broadcast_to(ship0, (R, L, B))
        orders0 = jnp.full((L, B), initial_orders_value, itype)
        return BeerGameState(
            week=jnp.zeros((), jnp.int32),
            inventory=inv0,
            backlog=jnp.zeros((L, B), itype),
            orders_placed=orders0,
            incoming_orders=orders0,
            shipments=ship0,
            customer_demand=demand,
            shipment_delays=delays,
            inventory_costs=jnp.zeros((L, B), itype),
            backlog_costs=jnp.zeros((L, B), itype),
            penalty_costs=jnp.zeros((L, B), itype),
        )

    def obs_fn(state: BeerGameState):
        if v2:
            return max_stock + state.inventory - state.backlog
        return state.inventory - state.backlog

    def step_fn(state: BeerGameState, action):
        """One week for the whole batch; ``action`` [L, B] int."""
        action = jnp.asarray(action, itype)
        week = state.week + 1

        # 1. receive scheduled shipments (ring slot week % R, cleared below
        # so the slot can be reused for week + R)
        slot = jnp.asarray(week % R, itype)
        inventory = state.inventory + jax.lax.dynamic_index_in_dim(
            state.shipments, slot, 0, keepdims=False)

        # 2. fill orders (incoming + backlog, capped by inventory)
        demand_row = jax.lax.dynamic_index_in_dim(
            state.customer_demand, week - 1, 0, keepdims=False)     # [B]
        incoming = jnp.concatenate(
            [demand_row[None, :], state.orders_placed[:-1]], axis=0)
        orders_to_fill = incoming + state.backlog
        to_deliver = jnp.minimum(inventory, orders_to_fill)

        delay = jax.lax.dynamic_index_in_dim(
            state.shipment_delays, week, 0, keepdims=False)         # [B]
        zero_delay = delay == 0                                     # [B]

        # deliveries downstream: immediate into inventory when delay == 0,
        # scheduled otherwise (both computed, selected per batch lane)
        downstream = jnp.concatenate(
            [to_deliver[1:], jnp.zeros((1, to_deliver.shape[-1]), itype)], 0)
        # scheduled path: ring[(week + delay) % R, :-1] += to_deliver[1:];
        # delay in 1..max_delay never collides with the current slot
        ridx = jnp.arange(R, dtype=itype)[:, None]                  # [R,1]
        sched_mask = (ridx == ((week + delay) % R)[None, :])        # [R,B]
        sched_add = jnp.where((~zero_delay) & sched_mask[:, None, :],
                              downstream[None, :, :], 0)
        # factory self-supply: ring[(week + delay) % R, -1] += orders_placed[-1]
        factory_add = jnp.where((~zero_delay) & sched_mask[:, None, :],
                                jnp.concatenate(
                                    [jnp.zeros((L - 1, to_deliver.shape[-1]), itype),
                                     state.orders_placed[-1:]], 0)[None, :, :], 0)
        # clear the consumed slot, then scatter this week's shipments
        shipments = (jnp.where(ridx[:, None, :] == slot, 0, state.shipments)
                     + sched_add + factory_add)

        inv_immediate = jnp.where(zero_delay[None, :], downstream, 0)
        factory_immediate = jnp.concatenate(
            [jnp.zeros((L - 1, to_deliver.shape[-1]), itype),
             jnp.where(zero_delay[None, :], state.orders_placed[-1:], 0)], 0)

        # 3. record inventory / backlog
        inventory = inventory - to_deliver + inv_immediate + factory_immediate
        backlog = orders_to_fill - to_deliver

        # 5. place orders
        orders_placed = (incoming + action) if not v2 else action

        # 6. reward
        reward = -(inv_cost * inventory + backlog_cost * backlog).sum(0)
        pen = jnp.zeros((L, inventory.shape[-1]), itype)
        if v2:
            pen = (jnp.clip(inventory - max_stock, 0, None)
                   + jnp.clip(backlog - max_stock, 0, None))
            reward = reward - (exceeded_capacity_penalty * pen).sum(0)

        new_state = BeerGameState(
            week=week, inventory=inventory, backlog=backlog,
            orders_placed=orders_placed, incoming_orders=incoming,
            shipments=shipments, customer_demand=state.customer_demand,
            shipment_delays=state.shipment_delays,
            inventory_costs=state.inventory_costs + inv_cost * inventory,
            backlog_costs=state.backlog_costs + backlog_cost * backlog,
            penalty_costs=state.penalty_costs + exceeded_capacity_penalty * pen,
        )
        done = week == max_weeks
        return new_state, (obs_fn(new_state), reward, done)

    return reset_fn, step_fn, obs_fn
