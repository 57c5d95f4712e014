"""Pallas (Triton route) kernel: whole-episode supply-chain trajectory collect.

One program owns ``Bt`` env lanes and runs ``episodes`` back-to-back
``cc.T``-step episodes in a ``lax.fori_loop``, writing each step's
observation ``[O, Bt]`` and reward ``[Bt]`` rows to the ``[S, O, B]`` /
``[S, B]`` trajectory (S = episodes * T).  The grid runs over lane tiles
only, so the time loop never leaves the program and the env state never
leaves registers: stock and the in-transit pipeline are loop-carried Python
lists of ``[Bt]`` rows, one per (node, product) and (arrival slot, node,
product).  The pipeline is a shift register — ``pipe[j]`` arrives ``j + 1``
steps from now, like ``core/step.py``'s dense pipeline — and shifting it is
a renaming of list entries at trace time, so every slot access is static.

Inputs are the table-mode episode tables of the scan engine: demand rows
``[S, R, P, B]``, lead-time rows ``[S, K, B]`` (stochastic lead-times only)
and actions ``[S, A, B]`` in [-1, 1]; step ``s`` reads row ``s`` of each.
Semantics follow ``core/step.py`` phase for phase (reference
supplychain_env.py:208-396): arrivals -> stock-capacity penalty -> supply ->
sorted-cut ship with processing and ship clipping (including the reference's
bug-compatible shared ship-capacity bookkeeping, SURVEY.md §2.1-4) ->
retailer demand -> holding costs, with the same floating-point operations in
the same order for the state, so observations match the scan engine to
rounding and rewards to the association of their cost sum.

All node, product and destination loops are unrolled at trace time (they
are small static constants of the compiled chain).  The sorted cut uses an
unrolled selection network over the <= Dmax destination values, stable in
destination order exactly like the reference's tuple sort.  Stochastic
lead-times reproduce the reference's action-dependent column consumption
(supplychain_env.py:252-254, :270, :344-348, :374-375; SURVEY.md §2.1-5)
with bounded per-use selects: a column index is a static base plus the
count of fired supplies at the node, which takes at most ``n_sup + 1``
values.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..core.compile import CompiledChain

__all__ = ["make_supplychain_collect_pallas", "DEFAULT_BATCH_TILE"]

# Env lanes per program: one warp, one lane per thread.  4096 envs give 128
# programs for the H100's 132 SMs; the tile sweep in PERF.md chose it.
DEFAULT_BATCH_TILE = 32


def num_warps_for(batch_tile: int) -> int:
    """One env lane per thread: a warp covers 32 lanes."""
    return max(1, min(4, batch_tile // 32))


def _pad_lanes(x, Bp, value):
    """Pad the trailing env axis of ``x`` to ``Bp`` lanes with ``value``."""
    pad = Bp - x.shape[-1]
    if pad == 0:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)],
                   constant_values=value)


def make_supplychain_collect_pallas(cc: CompiledChain, B: int,
                                    episodes: int = 1,
                                    batch_tile: int = DEFAULT_BATCH_TILE,
                                    interpret: bool = False):
    """Build the trajectory-collect kernel for a compiled chain.

    Returns ``run(demands, [leadtimes,] actions) -> (obs [S, O, B],
    rewards [S, B])`` with S = episodes * cc.T; ``leadtimes`` is passed only
    for chains with stochastic lead-times.  ``demands`` may carry extra
    trailing rows (the scan engine's ``[T+1, R, P, B]`` table works for one
    episode); every other table has at least S rows.  ``obs[s]`` is the
    observation the action of step ``s`` was chosen on (before the step),
    ``rewards[s]`` that step's reward; each episode starts from the reset
    state.  ``B`` is padded to a multiple of ``batch_tile`` inside the
    wrapper and the padding lanes are dropped from the outputs.
    ``batch_tile`` must be a power of two (Triton block shapes).
    """
    Bt = int(batch_tile)
    if Bt <= 0 or Bt & (Bt - 1):
        raise ValueError(f"batch_tile {Bt} must be a power of two")
    T = int(cc.T)
    E = int(episodes)
    S = E * T
    nB = -(-B // Bt)
    Bp = nB * Bt
    N, P, Dmax, A, R, K = cc.N, cc.P, cc.Dmax, cc.A, cc.R, cc.K
    H = int(cc.H)
    stochastic = bool(cc.stochastic_leadtimes)
    Lavg, Lmax = int(cc.Lavg), int(cc.Lmax)
    O = int(cc.obs_dim)
    f32 = jnp.float32
    i32 = jnp.int32

    retailer_idx = [int(i) for i in np.asarray(cc.retailer_idx)]
    is_factory = np.asarray(cc.is_factory)
    has_supply = np.asarray(cc.has_supply)
    has_ship = np.asarray(cc.has_ship) & (~cc.is_retailer[:, None])
    supply_cap = np.asarray(cc.supply_cap, np.float32)
    supply_cost = np.asarray(cc.supply_cost, np.float32)
    stock_cap = np.asarray(cc.stock_cap, np.float32)
    stock_cost = np.asarray(cc.stock_cost, np.float32)
    proc_cap = np.asarray(cc.proc_cap, np.float32)
    proc_cost = np.asarray(cc.proc_cost, np.float32)
    proc_ratio = np.asarray(cc.proc_ratio, np.float32)
    ship_cap_edge = np.asarray(cc.ship_cap_edge, np.float32)
    ship_cost = np.asarray(cc.ship_cost, np.float32)
    edge_mask = np.asarray(cc.edge_mask)
    sup_act_idx = np.maximum(cc.sup_act_idx, 0)
    ship_act_idx = np.maximum(cc.ship_act_idx, 0)
    lt_base = np.asarray(cc.lt_base, np.int64)
    init_stock = np.asarray(cc.initial_stock, np.float32)      # [N, P]
    init_pipe = np.asarray(cc.init_pipe, np.float32)           # [H, N, P]
    c_stock_pen = np.float32(cc.c_stock_pen)
    c_proc_pen = np.float32(cc.c_proc_pen)
    c_ship_pen = np.float32(cc.c_ship_pen)
    c_unmet = np.float32(cc.c_unmet)
    dst_of = {(int(s), int(d)): int(cc.edge_dst[s, d])
              for s, d in zip(*np.nonzero(edge_mask))}

    # observation normalizers (core/step.py obs_fn)
    max_ship = np.asarray(cc.max_ship, np.float32)
    ms_safe = np.where(max_ship > 0, max_ship, np.float32(1.0))
    ms_ok = max_ship > 0
    tail_div = ms_safe * np.float32(Lmax - (Lavg - 1))
    dem_min = np.asarray(cc.dem_min, np.float32)
    dem_rangev = np.asarray(cc.dem_range, np.float32)
    # supply (n, p) pairs per node: bounds the fired-supply counter
    n_sup = has_supply.sum(axis=1).astype(int)

    def zeros():
        return jnp.zeros((Bt,), f32)

    def _reset_state():
        """Reference reset (:630-682): initial stock + seeded pipeline."""
        stock = [[jnp.full((Bt,), init_stock[n, p], f32) for p in range(P)]
                 for n in range(N)]
        pipe = [[[jnp.full((Bt,), init_pipe[j, n, p], f32) for p in range(P)]
                 for n in range(N)] for j in range(H)]
        return stock, pipe

    def _obs_rows(stock, pipe, dem, te):
        """Observation rows (core/step.py obs_fn) of the state at episode
        step ``te``; ``dem[r][p]`` is the demand row it shows."""
        rows = []
        for r in range(R):
            for p in range(P):
                rows.append((dem[r][p] - dem_min[p]) / dem_rangev[p])
        for n in range(N):
            for p in range(P):
                rows.append(stock[n][p] / stock_cap[n, p])
            for p in range(P):
                for j in range(Lavg - 1):
                    rows.append(pipe[j][n][p] / ms_safe[n, p]
                                if ms_ok[n, p] else zeros())
                tail = pipe[Lavg - 1][n][p]
                for j in range(Lavg, H):
                    tail = tail + pipe[j][n][p]
                rows.append(tail / tail_div[n, p] if ms_ok[n, p] else zeros())
        remaining = (T - te).astype(f32) / T
        rows.append(jnp.full((Bt,), remaining, f32))
        assert len(rows) == O, (len(rows), O)
        return [jnp.clip(2.0 * x - 1.0, -1.0, 1.0) for x in rows]

    def _step(stock, pipe, a, lt_col, dem):
        """One env step for the lane tile.

        ``a(i)`` returns action row ``i`` already mapped to [0, 1];
        ``lt_col(k)`` lead-time table column ``k`` of this step (stochastic
        only); ``dem[r][p]`` this step's demand rows.  Returns
        ``(stock, pipe, reward)``."""
        acc = zeros()

        def spend(coeff, term):
            nonlocal acc
            acc = acc - coeff * term

        def select_lt(base, nf, nmax):
            """Column ``base + nf`` with static base and nf in [0, nmax]
            (indices clipped to K-1 like core/step.py)."""
            out = lt_col(min(base, K - 1))
            for c in range(1, nmax + 1):
                out = jnp.where(nf == c, lt_col(min(base + c, K - 1)), out)
            return out

        # phase 1+2: arrivals, stock-capacity penalty ------------------
        stocks = []
        for n in range(N):
            cols = []
            for p in range(P):
                s = stock[n][p] + pipe[0][n][p]
                if np.isfinite(stock_cap[n, p]):
                    spend(c_stock_pen, jnp.maximum(s - stock_cap[n, p], 0.0))
                    s = jnp.minimum(s, stock_cap[n, p])
                cols.append(s)
            stocks.append(cols)
        # shift: pipe[j] now arrives j + 1 steps after this one
        pipe = [[list(row) for row in slot] for slot in pipe[1:]] + \
            [[[zeros() for _ in range(P)] for _ in range(N)]]

        # phase 3: supply (:244-259) -----------------------------------
        nfired = [jnp.zeros((Bt,), i32) for _ in range(N)]
        for n in range(N):
            for p in range(P):
                if not has_supply[n, p]:
                    continue
                amt = a(sup_act_idx[n, p]) * supply_cap[n, p]
                spend(supply_cost[n, p], amt)
                fired = amt > 0
                pushed = jnp.where(fired, amt, 0.0)
                if stochastic:
                    lt = select_lt(int(lt_base[n]), nfired[n], n_sup[n])
                    for L in range(1, Lmax + 1):
                        pipe[L - 1][n][p] = pipe[L - 1][n][p] + jnp.where(
                            lt == L, pushed, 0.0)
                else:
                    pipe[Lavg - 1][n][p] = pipe[Lavg - 1][n][p] + pushed
                nfired[n] = nfired[n] + fired.astype(i32)

        # phase 4: ship (:262-375).  Pushes collect per (delay, node,
        # product) in edge order and land after the supply pushes, like
        # core/step.py's separate supply and delivery adds.
        upd = {}

        def push(j, n, p, amt):
            key = (j, n, p)
            upd[key] = amt if key not in upd else upd[key] + amt

        for n in range(N):
            if not has_ship[n].any():
                continue
            if stochastic:
                lt_dst = {d: select_lt(int(lt_base[n]) + d, nfired[n],
                                       n_sup[n])
                          for d in range(Dmax) if edge_mask[n, d]}
            avail_proc = jnp.full((Bt,), proc_cap[n], f32)
            # one product: the shared ship capacity is never decremented
            # before it is read, so each edge's capacity stays the static
            # constant (cap >= 0 is validated in core/compile.py)
            avail_ship = [float(ship_cap_edge[n, d]) if P == 1 else
                          jnp.full((Bt,), ship_cap_edge[n, d], f32)
                          for d in range(Dmax)]
            for p in range(P):
                dvals = [a(ship_act_idx[n, p, d])
                         if has_ship[n, p] and edge_mask[n, d] else zeros()
                         for d in range(Dmax)]
                avail_mat = stocks[n][p]
                # sorted cut (SC_Action.apply SHIP, :58-96): sort ascending,
                # ties by destination index; each cut is the gap to the
                # sort predecessor, then the reference's sequential clamp
                # over sorted positions (:86-87)
                if Dmax == 1:
                    amounts = [jnp.minimum(dvals[0] * avail_mat, avail_mat)]
                elif Dmax == 2:
                    v0, v1 = dvals
                    swap = v1 < v0
                    lo = jnp.where(swap, v1, v0)
                    hi = jnp.where(swap, v0, v1)
                    amt_lo = jnp.minimum(lo * avail_mat, avail_mat)
                    amt_hi = jnp.minimum((hi - lo) * avail_mat,
                                         avail_mat - amt_lo)
                    amounts = [jnp.where(swap, amt_hi, amt_lo),
                               jnp.where(swap, amt_lo, amt_hi)]
                else:
                    cuts, ranks = [], []
                    for d in range(Dmax):
                        pred = jnp.full((Bt,), -jnp.inf, f32)
                        rank = jnp.zeros((Bt,), i32)
                        for e in range(Dmax):
                            if e == d:
                                continue
                            before = (dvals[e] <= dvals[d]) if e < d else \
                                (dvals[e] < dvals[d])
                            pred = jnp.maximum(
                                pred, jnp.where(before, dvals[e], -jnp.inf))
                            rank = rank + before.astype(i32)
                        pred = jnp.where(rank == 0, 0.0, pred)
                        cuts.append((dvals[d] - pred) * avail_mat)
                        ranks.append(rank)
                    availr = avail_mat
                    amounts = [zeros() for _ in range(Dmax)]
                    for k in range(Dmax):
                        cut_k = zeros()
                        for d in range(Dmax):
                            cut_k = cut_k + jnp.where(ranks[d] == k,
                                                      cuts[d], 0.0)
                        amt_k = jnp.minimum(cut_k, availr)
                        availr = availr - amt_k
                        for d in range(Dmax):
                            amounts[d] = amounts[d] + jnp.where(
                                ranks[d] == k, amt_k, 0.0)
                # dead destinations join the cut with value 0 but ship
                # nothing (core/step.py masks them after the cut)
                amounts = [amt if edge_mask[n, d] else zeros()
                           for d, amt in enumerate(amounts)]

                # processing clip (factories, :298-310)
                if is_factory[n]:
                    clipped = []
                    for d in range(Dmax):
                        ai = amounts[d]
                        gate = ai > 0
                        over = gate & (ai > avail_proc)
                        spend(c_proc_pen, jnp.where(over, ai - avail_proc, 0.0))
                        ai2 = jnp.where(over, avail_proc, ai)
                        avail_proc = avail_proc - jnp.where(gate, ai2, 0.0)
                        clipped.append(ai2)
                    to_ship = [c / proc_ratio[n, p] for c in clipped]
                    amounts = clipped
                else:
                    to_ship = amounts

                # ship clip, bug-compatible bookkeeping (:312-328)
                leaving = zeros()
                for d in range(Dmax):
                    if not edge_mask[n, d]:
                        continue
                    a2 = to_ship[d]
                    if P == 1 and not np.isfinite(ship_cap_edge[n, d]):
                        a2c, raw = a2, amounts[d]
                    else:
                        cap = avail_ship[d]
                        gate2 = (a2 > cap) if P == 1 else (a2 > 0) & (a2 > cap)
                        spend(c_ship_pen, jnp.where(gate2, a2 - cap, 0.0))
                        a2c = jnp.where(gate2, cap, a2)
                        raw = jnp.where(
                            gate2,
                            a2c * proc_ratio[n, p] if is_factory[n] else a2c,
                            amounts[d])
                        if P > 1:
                            avail_ship[d] = cap - jnp.where(gate2, raw, 0.0)
                    leaving = leaving + raw
                    spend(ship_cost[n, p, d], a2c)
                    # deliver only positive amounts (:343-348)
                    pushed = jnp.where(a2c > 0, a2c, 0.0)
                    dst = dst_of[(n, d)]
                    if stochastic:
                        for L in range(1, Lmax + 1):
                            push(L - 1, dst, p,
                                 jnp.where(lt_dst[d] == L, pushed, 0.0))
                    else:
                        push(Lavg - 1, dst, p, pushed)
                stocks[n][p] = avail_mat - leaving
                if is_factory[n]:
                    spend(proc_cost[n, p], leaving)

        # phase 5: retailer demand (:378-387) --------------------------
        for ri, n in enumerate(retailer_idx):
            for p in range(P):
                ful = jnp.minimum(stocks[n][p], dem[ri][p])
                stocks[n][p] = stocks[n][p] - ful
                spend(c_unmet, dem[ri][p] - ful)

        # phase 6: holding costs (:389-394) ----------------------------
        for n in range(N):
            for p in range(P):
                spend(stock_cost[n, p], stocks[n][p])
        for (j, n, p), amt in upd.items():
            pipe[j][n][p] = pipe[j][n][p] + amt
        return stocks, pipe, acc

    def kernel(*refs):
        if stochastic:
            dem_ref, lt_ref, act_ref, obs_ref, rew_ref = refs
        else:
            dem_ref, act_ref, obs_ref, rew_ref = refs
            lt_ref = None

        def episode(e, carry):
            def step(te, state):
                stock, pipe = state
                s = e * T + te
                dem = [[dem_ref[s, r, p] for p in range(P)] for r in range(R)]
                for o, row in enumerate(_obs_rows(stock, pipe, dem, te)):
                    obs_ref[s, o] = row
                act_rows, lt_rows = {}, {}

                def a(i):
                    i = int(i)
                    if i not in act_rows:
                        act_rows[i] = (act_ref[s, i] + 1.0) * 0.5
                    return act_rows[i]

                def lt_col(k):
                    if k not in lt_rows:
                        lt_rows[k] = lt_ref[s, k]
                    return lt_rows[k]

                stock, pipe, reward = _step(stock, pipe, a, lt_col, dem)
                rew_ref[s] = reward
                return stock, pipe

            jax.lax.fori_loop(0, T, step, _reset_state())
            return carry

        jax.lax.fori_loop(0, E, episode, 0)

    def lanes(*lead):
        return pl.BlockSpec(lead + (Bt,),
                            lambda i: (0,) * len(lead) + (i,))

    def build(dem_rows):
        in_specs = [lanes(dem_rows, R, P)]
        if stochastic:
            in_specs.append(lanes(S, K))
        in_specs.append(lanes(S, A))
        return pl.pallas_call(
            kernel,
            grid=(nB,),
            in_specs=in_specs,
            out_specs=[lanes(S, O), lanes(S)],
            out_shape=[jax.ShapeDtypeStruct((S, O, Bp), f32),
                       jax.ShapeDtypeStruct((S, Bp), f32)],
            backend="triton",
            compiler_params=pltriton.CompilerParams(
                num_warps=num_warps_for(Bt), num_stages=1),
            interpret=interpret,
            name="supplychain_collect",
        )

    def run(demands, *rest):
        if len(rest) != (2 if stochastic else 1):
            raise TypeError("run(demands, [leadtimes,] actions): leadtimes "
                            "go with stochastic lead-times only")
        demands = jnp.asarray(demands, f32)
        if demands.shape[0] < S:
            raise ValueError(f"demand table has {demands.shape[0]} rows, "
                             f"needs {S}")
        args = [_pad_lanes(demands, Bp, 0.0)]
        if stochastic:
            args.append(_pad_lanes(jnp.asarray(rest[0], i32)[:S], Bp, 1))
        args.append(_pad_lanes(jnp.asarray(rest[-1], f32)[:S], Bp, 0.0))
        obs, rew = build(demands.shape[0])(*args)
        return obs[..., :B], rew[:, :B]

    return jax.jit(run)
