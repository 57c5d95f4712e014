"""Vectorized step kernel for the graph supply-chain environment.

Design
------
The reference steps one env object at a time with Python loops over nodes,
products and destinations plus per-node binary heaps of in-transit shipments
(``SC_Node.act``, reference supplychain_env.py:208-396).  Here the whole batch
of environments advances in lockstep as dense array ops:

* **Batch-trailing layout**: every state array carries the environment batch as
  its *last* axis (``stock[N, P, B]``, ``pipe[H, N, P, B]``).  The last axis
  is the contiguous one, so a batch of thousands of envs turns every per-node
  scalar op of the reference into one coalesced op over the batch.  No
  ``vmap`` is needed — all ops broadcast over the trailing axis.
* **Dense time-indexed pipeline** replaces the heaps: ``pipe[j]`` holds the
  material arriving at ``t + 1 + j``.  Arrival dynamics are identical because
  ``act`` pops *all* entries of the current step (supplychain_env.py:220-228).
* **Static unrolled loops** over products/destinations (both small) carry the
  shared processing/ship capacities exactly like the reference's sequential
  loops, including its bug-compatible ship-capacity bookkeeping
  (supplychain_env.py:312-328; see SURVEY.md §2.1-4).
* The per-step lead-time column consumption is action-dependent in the
  reference (supplychain_env.py:252-254, :270, :344-348, :374-375); we
  reproduce it with a cumulative count of "fired" supply actions and
  ``take_along_axis`` gathers.

Everything is shape-static and jit/scan/shard_map friendly; ``t`` is a traced
scalar (episodes are fixed-length so the whole batch shares one clock).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .compile import CompiledChain

__all__ = ["EnvState", "StepOutput", "make_supplychain_kernels", "COST_KEYS"]

# Category order matches the reference's build_info dicts
# (supplychain_env.py:416-417).
COST_KEYS = ("stock", "stock_pen", "supply", "process", "process_pen",
             "ship", "ship_pen", "unmet_dem")
_CK = {k: i for i, k in enumerate(COST_KEYS)}


class EnvState(NamedTuple):
    """Per-episode device state (a flat pytree; batch is the trailing axis).

    Two RNG layouts share this container: table mode (parity/host streams)
    carries the whole-episode ``demands [T+1,R,P,B]`` / ``leadtimes [T,K,B]``
    tables and ``ep_key`` is None; stateless mode (the fast device path) carries
    only the CURRENT demand row ``demands [R,P,B]`` plus the episode PRNG key,
    and every step's rows are drawn counter-based from ``fold_in(ep_key, t)``.
    """
    t: jnp.ndarray           # scalar int32, current time step
    stock: jnp.ndarray       # [N, P, B]
    pipe: jnp.ndarray        # [H, N, P, B]; pipe[j] arrives at t+1+j
    demands: jnp.ndarray     # [T+1, R, P, B] table, or [R, P, B] current row
    leadtimes: Optional[jnp.ndarray]  # [T, K, B] int32, or None
    ep_reward: jnp.ndarray   # [B]
    ep_costs: jnp.ndarray    # [8, P, B] accumulated cost per category
    ep_units: jnp.ndarray    # [8, P, B] accumulated units per category
    ep_key: Optional[jnp.ndarray] = None  # episode PRNG key (stateless mode)


class StepOutput(NamedTuple):
    obs: jnp.ndarray         # [obs_dim, B] in [-1, 1]
    reward: jnp.ndarray      # [B]
    done: jnp.ndarray        # scalar bool
    costs: jnp.ndarray       # [8, P, B] this-step cost per category (over nodes)
    units: jnp.ndarray       # [8, P, B]
    # optional push introspection (debug=True kernels; None otherwise) —
    # feeds the host-side heap mirror for strict observation parity
    sup_push: Optional[jnp.ndarray] = None   # [N, P, B] supplied amounts
    sup_lt: Optional[jnp.ndarray] = None     # [N, P, B] supply lead-times
    ship_push: Optional[jnp.ndarray] = None  # [E, P, B] shipped amounts
    ship_lt: Optional[jnp.ndarray] = None    # [E, B] transport lead-times


def make_supplychain_kernels(cc: CompiledChain, dtype=jnp.float32,
                             debug: bool = False,
                             stateless_rng: bool = False):
    """Build (reset_fn, step_fn, obs_fn) closures over a compiled chain.

    Table mode (default): ``reset_fn(demands, leadtimes, B)`` takes
    per-episode tables (host- or device-generated).
    Stateless mode (``stateless_rng=True``): ``reset_fn(key, B)`` takes an
    episode PRNG key and every step draws its demand/lead-time rows
    counter-based on device (see ``EnvState`` docstring; distribution parity
    with the reference, not stream parity).
    ``step_fn(state, action)`` takes ``action[A, B]`` in [-1, 1].
    """
    # Constants are kept as NumPy arrays so jit lowering embeds them directly
    # as literals instead of capturing device arrays.
    np_dtype = np.dtype(dtype)
    f = lambda x: np.asarray(x, np_dtype)
    N, P, Dmax, R = cc.N, cc.P, cc.Dmax, cc.R
    Lavg, Lmax, H, T, K = cc.Lavg, cc.Lmax, cc.H, cc.T, cc.K

    is_retailer = np.asarray(cc.is_retailer)
    retailer_idx = np.asarray(cc.retailer_idx)
    is_factory = np.asarray(cc.is_factory)
    has_supply = np.asarray(cc.has_supply)
    has_ship = np.asarray(cc.has_ship) & (~cc.is_retailer[:, None])
    supply_cap = f(cc.supply_cap)
    supply_cost = f(cc.supply_cost)
    stock_cap = f(cc.stock_cap)
    stock_cost = f(cc.stock_cost)
    proc_cap = f(cc.proc_cap)
    proc_cost = f(cc.proc_cost)
    proc_ratio = f(cc.proc_ratio)
    ship_cap_edge = f(cc.ship_cap_edge)
    ship_cost = f(cc.ship_cost)
    edge_mask = np.asarray(cc.edge_mask)
    max_ship = f(cc.max_ship)
    dem_min = f(cc.dem_min)
    dem_rangev = f(cc.dem_range)
    sup_act_idx = np.maximum(cc.sup_act_idx, 0)
    ship_act_idx = np.maximum(cc.ship_act_idx, 0)
    lt_base = np.asarray(cc.lt_base, np.int32)

    # flat edge list for delivery of shipments into destination pipelines
    e_src, e_di = np.nonzero(cc.edge_mask)
    e_dst = np.asarray(cc.edge_dst[e_src, e_di], np.int32)
    e_src = np.asarray(e_src, np.int32)
    e_di = np.asarray(e_di, np.int32)
    # one-hot destination matrix [N, E] (static) for gather-free delivery
    oh_dst = np.zeros((N, len(e_dst)), np_dtype)
    oh_dst[e_dst, np.arange(len(e_dst))] = 1

    def _select_lt_sup(lt_row, rank):
        """lt_row[K, B], rank[N, P, B] in [0, P) -> lead-times[N, P, B].

        The supply column index is ``lt_base[n] + rank`` and rank (the count
        of earlier fired supplies at the node) is < P, so P masked selects
        over STATIC per-node gathers cover every reachable column, where a
        one-hot select over all K columns would cost K passes (~144 on the
        26-node NPerStage chains) and per-lane dynamic gathers a gather per
        lane; this needs only P.
        """
        out = jnp.zeros(rank.shape, lt_row.dtype)
        for r in range(P):
            row = lt_row[np.clip(lt_base + r, 0, K - 1)]        # [N, B]
            out = jnp.where(rank == r, row[:, None, :], out)
        return out

    def _select_lt_shp(lt_row, n_fired):
        """lt_row[K, B], n_fired[N, B] in [0, P] -> lead-times[N, Dmax, B].

        Transport columns sit at ``lt_base[n] + n_fired + di``; n_fired has
        only P+1 values, so P+1 masked selects over static [N, Dmax] index
        tables replace the K-pass one-hot (see _select_lt_sup)."""
        out = jnp.zeros((N, Dmax) + n_fired.shape[-1:], lt_row.dtype)
        di = np.arange(Dmax)
        for m in range(P + 1):
            idx = np.clip(lt_base[:, None] + m + di, 0, K - 1)  # [N, Dmax]
            out = jnp.where(n_fired[:, None, :] == m, lt_row[idx], out)
        return out

    def obs_fn(state: EnvState) -> jnp.ndarray:
        """Observation (supplychain_env.py:762-791 + SC_Node.build_observation
        :428-463), computed densely from the time-indexed pipeline."""
        B = state.stock.shape[-1]
        if stateless_rng:
            dem_row = state.demands                            # current row
        else:
            dem_row = jax.lax.dynamic_index_in_dim(state.demands, state.t, 0,
                                                   keepdims=False)  # [R,P,B]
        dem_obs = ((dem_row - dem_min[None, :, None])
                   / dem_rangev[None, :, None]).reshape(R * P, B)

        # direct division like the reference (:433): x/inf -> 0 for the
        # default unbounded capacity, 0/0 -> nan for a degenerate zero
        # capacity (the reference emits that nan too)
        stock_obs = state.stock / stock_cap[:, :, None]              # [N,P,B]

        ms = jnp.where(max_ship > 0, max_ship, 1.0)[:, :, None]
        ms_ok = (max_ship > 0)[:, :, None]
        buckets = []
        for j in range(Lavg - 1):
            buckets.append(jnp.where(ms_ok, state.pipe[j] / ms, 0.0))
        tail = state.pipe[Lavg - 1:].sum(axis=0)
        # last bucket divisor: max_ship * (Lmax - (Lavg - 1))
        # (supplychain_env.py:455-461)
        buckets.append(jnp.where(ms_ok, tail / (ms * (Lmax - (Lavg - 1))), 0.0))
        transit_obs = jnp.stack(buckets, axis=2)  # [N,P,Lavg,B]

        node_obs = jnp.concatenate(
            [stock_obs, transit_obs.reshape(N, P * Lavg, B)], axis=1)
        remaining = ((T - state.t).astype(dtype) / T) * jnp.ones((1, B), dtype)
        obs = jnp.concatenate(
            [dem_obs, node_obs.reshape(N * P * (1 + Lavg), B), remaining], axis=0)
        return jnp.clip(2.0 * obs - 1.0, -1.0, 1.0)

    def _blank_state(demands, leadtimes, B, ep_key=None) -> EnvState:
        return EnvState(
            t=jnp.zeros((), jnp.int32),
            stock=jnp.broadcast_to(f(cc.initial_stock)[:, :, None], (N, P, B)).copy(),
            pipe=jnp.broadcast_to(f(cc.init_pipe)[:, :, :, None], (H, N, P, B)).copy(),
            demands=demands, leadtimes=leadtimes,
            ep_reward=jnp.zeros((B,), dtype),
            ep_costs=jnp.zeros((8, P, B), dtype),
            ep_units=jnp.zeros((8, P, B), dtype),
            ep_key=ep_key,
        )

    def reset_fn(demands, leadtimes, B: int) -> EnvState:
        """Fresh state from per-episode tables (reference reset, :630-682)."""
        demands = jnp.asarray(demands, dtype)
        if demands.ndim == 3:           # [T+1,R,P] -> broadcast batch
            demands = jnp.broadcast_to(demands[..., None], (T + 1, R, P, B))
        if cc.stochastic_leadtimes:
            leadtimes = jnp.asarray(leadtimes, jnp.int32)
            if leadtimes.ndim == 2:
                leadtimes = jnp.broadcast_to(leadtimes[..., None], (T, K, B))
        else:
            leadtimes = None
        return _blank_state(demands, leadtimes, B)

    def reset_fn_stateless(key, B: int) -> EnvState:
        """Fresh state from an episode PRNG key; demand row 0 drawn now,
        later rows drawn per step from ``fold_in(key, t)``."""
        from ..rng.device import stateless_step_rows
        dem0, _ = stateless_step_rows(key, 0, cc, B, dtype)
        return _blank_state(dem0, None, B, ep_key=key)

    def step_fn(state: EnvState, action: jnp.ndarray):
        B = action.shape[-1]
        # The reference performs the action-facing arithmetic on the raw
        # (usually float32) action values before any float64 state math:
        # denormalization (supplychain_env.py:697-698), the supplied amount
        # and its cost (SC_Action.apply SUPPLY :49-57 — float32 * int stays
        # float32), and the sorted-cut differences (:78-94).  Keep those in
        # the action's own dtype and promote afterwards so float64 parity
        # mode reproduces the reference's float32 rounding exactly.
        # integer action arrays promote to float64 at (a+1)/2 upstream
        adt = action.dtype if jnp.issubdtype(action.dtype, jnp.floating) \
            else jnp.dtype(dtype)
        a = ((action.astype(adt) + 1) * jnp.asarray(0.5, adt)).astype(adt)
        t = state.t + 1
        if stateless_rng:
            # all of this step's stochastic inputs from one fused draw:
            # the demand row for period t (shown by this step's obs; the row
            # consumed below is carried in state.demands) and the lead-time
            # row for this step
            from ..rng.device import stateless_step_rows
            dem_next, lt_row_sl = stateless_step_rows(
                state.ep_key, t, cc, B, dtype)

        zero_a = jnp.zeros((), adt)
        a_sup = jnp.where(has_supply[:, :, None],
                          jnp.take(a, sup_act_idx, axis=0), zero_a)  # [N,P,B]
        a_shp = jnp.where(
            (has_ship[:, :, None] & edge_mask[:, None, :])[..., None],
            jnp.take(a, ship_act_idx, axis=0), zero_a)       # [N,P,Dmax,B]

        costs = {k: jnp.zeros((P, B), dtype) for k in COST_KEYS}
        units = {k: jnp.zeros((P, B), dtype) for k in COST_KEYS}

        # --- phase 1: arrivals (act :220-228) ----------------------------
        with jax.named_scope("arrivals"):
            arrived = state.pipe[0]
            pipe = jnp.concatenate([state.pipe[1:],
                                    jnp.zeros_like(state.pipe[:1])], 0)
            stock = state.stock + arrived

        # --- phase 2: stock-capacity overflow (act :232-240) -------------
        with jax.named_scope("stock_capacity"):
            excess = jnp.maximum(stock - stock_cap[:, :, None], 0.0)
            excess = jnp.where(jnp.isfinite(stock_cap)[:, :, None], excess, 0.0)
            costs["stock_pen"] = cc.c_stock_pen * excess.sum(0)
            units["stock_pen"] = excess.sum(0)
            stock = jnp.minimum(stock, stock_cap[:, :, None])

        # --- phase 3: supply (act :244-259); amount and cost are computed
        # in the action dtype like the reference (f32 * int -> f32), then
        # promoted ---------------------------------------------------------
        supply_scope = jax.named_scope("supply"); supply_scope.__enter__()
        sup_amt_raw = a_sup * supply_cap.astype(adt)[:, :, None]
        sup_amt = sup_amt_raw.astype(dtype)
        fired = has_supply[:, :, None] & (sup_amt > 0)
        costs["supply"] = (sup_amt_raw
                           * supply_cost.astype(adt)[:, :, None]).astype(dtype).sum(0)
        units["supply"] = sup_amt.sum(0)
        if cc.stochastic_leadtimes:
            if stateless_rng:
                lt_row = lt_row_sl                                   # [K,B]
            else:
                lt_row = jax.lax.dynamic_index_in_dim(
                    state.leadtimes, t - 1, 0, keepdims=False)       # [K,B]
            # supply lead-time column = base + #earlier fired supplies
            # (index advances only when supplied amount > 0, :252-254)
            rank = jnp.cumsum(fired, axis=1) - fired.astype(jnp.int32)
            lt_sup = _select_lt_sup(lt_row, rank)                    # [N,P,B]
            n_fired = fired.sum(axis=1).astype(jnp.int32)            # [N,B]
            # transport lead-time columns follow the fired supplies and are
            # shared across products (:270, :344-348, :374-375)
            lt_shp = _select_lt_shp(lt_row, n_fired)                 # [N,Dmax,B]
            contrib_l = jnp.where(
                fired[None] & (lt_sup[None]
                               == np.arange(1, Lmax + 1)[:, None, None, None]),
                sup_amt[None], 0.0)                                  # [Lmax,N,P,B]
            pipe = pipe.at[:Lmax].add(contrib_l)
        else:
            lt_sup = jnp.full((N, P, B), Lavg, jnp.int32)
            lt_shp = jnp.full((N, Dmax, B), Lavg, jnp.int32)
            # constant mode: everything arrives at t+Lavg (even if
            # Lavg > Lmax, like the reference's heaps) — one scatter
            pipe = pipe.at[Lavg - 1].add(jnp.where(fired, sup_amt, 0.0))

        supply_scope.__exit__(None, None, None)
        # --- phase 4: ship (act :262-375); product loop carries shared
        # processing / per-destination ship capacities ---------------------
        ship_scope = jax.named_scope("ship"); ship_scope.__enter__()
        avail_proc = jnp.broadcast_to(proc_cap[:, None], (N, B))
        avail_ship = jnp.broadcast_to(ship_cap_edge[:, :, None], (N, Dmax, B))

        # sorted-cut allocation (SC_Action.apply SHIP, :58-96), gather-free
        # and vectorized over all products at once.  The reference sorts the
        # action values ascending (stable => ties by destination index, like
        # Python's tuple sort) and takes consecutive differences as fractions
        # of the available stock, clamping cumulatively.  Instead of argsort +
        # take_along_axis (per-lane gathers), compute for every destination i:
        #   w_i   = value of its predecessor in the stable ascending sort
        #           (the identical float the sorted-diff would subtract)
        #   rank_i= its position in that sort
        # via Dmax masked passes, then run the reference's sequential clamp
        # over sorted POSITIONS with one-hot selection — the same FP ops in
        # the same order, so results are bit-exact vs the sorted loop.
        def _sorted_cut(v, s_g, cap_g, D):
            """Sorted-cut allocation for one group of nodes with D
            destination slots: v [n,P,D,B] action values, s_g [n,P,B] stock,
            cap_g [n,P] stock capacity.  Returns amounts [n,P,D,B]."""
            w = jnp.full(v.shape, -jnp.inf, adt)
            rank = jnp.zeros(v.shape, jnp.int32)
            didx = np.arange(D)[None, None, :, None]
            for j in range(D):
                vj = v[:, :, j:j + 1, :]
                before = (vj < v) | ((vj == v) & (j < didx))
                w = jnp.maximum(w, jnp.where(before, vj, -jnp.inf))
                rank = rank + before
            # the predecessor of the first sorted element is literally 0
            # (reference prepends a zero before differencing, :78-84)
            w = jnp.where(rank == 0, jnp.zeros((), adt), w)
            # the cut difference is computed on the raw action dtype
            # (reference :83-84 subtracts two float32 action values).  When
            # the stock sits exactly at capacity, the reference's
            # min(capacity, stock) returns the Python int capacity and the
            # product stays in the action dtype; otherwise the float64 stock
            # promotes it (:62-64, :84).
            vdiff = v - w                                  # adt
            cut_f64 = vdiff.astype(dtype) * s_g[:, :, None, :]
            at_cap = (s_g == cap_g[:, :, None])[:, :, None, :]
            cut_raw = (vdiff * s_g.astype(adt)[:, :, None, :]).astype(dtype)
            cut = jnp.where(at_cap, cut_raw, cut_f64)
            availr = s_g                                   # [n,P,B]
            amounts = jnp.zeros(cut.shape, dtype)
            for k in range(D):
                sel = rank == k
                cut_k = jnp.where(sel, cut, 0.0).sum(axis=2)   # [n,P,B]
                amt_k = jnp.minimum(cut_k, availr)
                availr = availr - amt_k
                amounts = amounts + jnp.where(sel, amt_k[:, :, None, :], 0.0)
            return amounts

        amounts_all = _sorted_cut(a_shp, stock, stock_cap, Dmax)
        amounts_all = jnp.where(edge_mask[:, None, :, None],
                                amounts_all, 0.0)

        new_stock_cols = []
        ship_pushes = []
        lt_e = lt_shp[e_src, e_di]                                   # [E,B]
        for p in range(P):
            avail_mat = stock[:, p]                                  # [N,B]
            amounts = amounts_all[:, p]                              # [N,Dmax,B]

            # processing-capacity clip, sequential over destinations
            # (:298-310); decrement gated on the ORIGINAL amount > 0 and by
            # the post-clip amount
            exc_proc = jnp.zeros((N, B), dtype)
            if bool(cc.is_factory.any()):
                clipped = []
                for i in range(Dmax):
                    ai = amounts[:, i]
                    gate = is_factory[:, None] & (ai > 0)
                    over = gate & (ai > avail_proc)
                    exc_proc = exc_proc + jnp.where(over, ai - avail_proc, 0.0)
                    ai2 = jnp.where(over, avail_proc, ai)
                    avail_proc = avail_proc - jnp.where(gate, ai2, 0.0)
                    clipped.append(ai2)
                amounts = jnp.stack(clipped, axis=1)
                to_ship = jnp.where(is_factory[:, None, None],
                                    amounts / proc_ratio[:, p, None, None],
                                    amounts)
            else:
                to_ship = amounts

            # ship-capacity clip (:312-328).  Bug-compatible: the shared
            # capacity is decremented only in the over-capacity branch, and by
            # the RAW amount; it may go negative and later products then clip
            # against the negative value (SURVEY.md §2.1-4).
            a2 = to_ship
            gate2 = (a2 > 0) & (a2 > avail_ship)
            exc_ship = jnp.where(gate2, a2 - avail_ship, 0.0).sum(axis=1)
            a2c = jnp.where(gate2, avail_ship, a2)
            raw = jnp.where(gate2,
                            jnp.where(is_factory[:, None, None],
                                      a2c * proc_ratio[:, p, None, None], a2c),
                            amounts)
            avail_ship = avail_ship - jnp.where(gate2, raw, 0.0)

            leaving = raw.sum(axis=1)                                # [N,B]
            new_stock_cols.append(avail_mat - leaving)

            costs["process"] = costs["process"].at[p].add(
                jnp.where(is_factory[:, None], leaving * proc_cost[:, p, None], 0.0).sum(0))
            units["process"] = units["process"].at[p].add(
                jnp.where(is_factory[:, None], leaving, 0.0).sum(0))
            costs["process_pen"] = costs["process_pen"].at[p].add(
                cc.c_proc_pen * exc_proc.sum(0))
            units["process_pen"] = units["process_pen"].at[p].add(exc_proc.sum(0))
            costs["ship_pen"] = costs["ship_pen"].at[p].add(
                cc.c_ship_pen * exc_ship.sum(0))
            units["ship_pen"] = units["ship_pen"].at[p].add(exc_ship.sum(0))
            # transport costs are re-priced on post-clip shipped amounts
            # (calculate_costs, :103-104, :350-356)
            costs["ship"] = costs["ship"].at[p].add(
                (a2c * ship_cost[:, p, :, None]).sum(axis=(0, 1)))
            units["ship"] = units["ship"].at[p].add(a2c.sum(axis=(0, 1)))

            # shipped amounts on the flat edge list; the delivery contraction
            # itself is batched over products below the loop
            ship_pushes.append(a2c[e_src, e_di])                     # [E,B]

        stock = jnp.stack(new_stock_cols, axis=1)                    # [N,P,B]

        # deliver into destination pipelines (push only if > 0, :343-348).
        # One-hot contraction over the (static) edge->destination matrix
        # instead of Lmax scatter-adds; summing incoming edges in edge-index
        # order matches the scatter order.  One einsum covers ALL products
        # (a single pipe update instead of P in-place slices).
        # precision=HIGHEST is LOAD-BEARING: at default precision a GPU may
        # multiply float32 in TF32 (10-bit mantissa), which silently
        # truncates shipped amounts (e.g. 8.203125 -> 8.1875) and breaks
        # reference parity on the card even though CPU tests pass; HIGHEST
        # keeps full float32.
        contrib_ep = jnp.stack(ship_pushes, axis=1)                  # [E,P,B]
        if cc.stochastic_leadtimes:
            lt_ok = jnp.where(contrib_ep > 0, lt_e[:, None, :], 0)
            masked = jnp.where(
                lt_ok[None] == np.arange(1, Lmax + 1)[:, None, None, None],
                contrib_ep[None], 0.0)                          # [Lmax,E,P,B]
            add_l = jnp.einsum('ne,lepb->lnpb', oh_dst, masked,
                               precision=jax.lax.Precision.HIGHEST)
            pipe = pipe.at[:Lmax].add(add_l)
        else:
            add0 = jnp.einsum('ne,epb->npb', oh_dst,
                              jnp.where(contrib_ep > 0, contrib_ep, 0.0),
                              precision=jax.lax.Precision.HIGHEST)
            pipe = pipe.at[Lavg - 1].add(add0)

        ship_scope.__exit__(None, None, None)
        # --- phase 5: retailer demand fulfillment (:378-387) --------------
        if stateless_rng:
            dem_row = state.demands          # the row this step's obs showed
        else:
            dem_row = jax.lax.dynamic_index_in_dim(state.demands, t - 1, 0,
                                                   keepdims=False)   # [R,P,B]
        r_stock = stock[retailer_idx]
        fulfilled = jnp.minimum(r_stock, dem_row)
        stock = stock.at[retailer_idx].add(-fulfilled)
        unmet = (dem_row - fulfilled).sum(0)
        costs["unmet_dem"] = cc.c_unmet * unmet
        units["unmet_dem"] = unmet

        # --- phase 6: holding costs (:389-394) -----------------------------
        costs["stock"] = (stock * stock_cost[:, :, None]).sum(0)
        units["stock"] = stock.sum(0)

        cost_mat = jnp.stack([costs[k] for k in COST_KEYS])          # [8,P,B]
        unit_mat = jnp.stack([units[k] for k in COST_KEYS])
        reward = -cost_mat.sum(axis=(0, 1))                          # [B]

        new_demands = dem_next if stateless_rng else state.demands
        new_state = EnvState(
            t=t, stock=stock, pipe=pipe, demands=new_demands,
            leadtimes=state.leadtimes,
            ep_reward=state.ep_reward + reward,
            ep_costs=state.ep_costs + cost_mat,
            ep_units=state.ep_units + unit_mat,
            ep_key=state.ep_key,
        )
        obs = obs_fn(new_state)
        done = t == T
        out = StepOutput(obs=obs, reward=reward, done=done,
                         costs=cost_mat, units=unit_mat)
        if debug:
            out = out._replace(sup_push=jnp.where(fired, sup_amt, 0.0),
                               sup_lt=lt_sup,
                               ship_push=contrib_ep,
                               ship_lt=lt_e)
        return new_state, out

    return (reset_fn_stateless if stateless_rng else reset_fn), step_fn, obs_fn
