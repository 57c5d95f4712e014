"""Collect-kernel parity in interpret mode on CPU: the beer-game kernel must
match the lax.scan path bit-for-bit, the supply-chain kernel the scan
engine to float32 rounding.  The compiled kernels are compared on the GPU by
tests/test_collect_compiled.py and chip_smoke.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np


def _beergame_scan(L, W, demand, delays, actions, inv0, ship=4, orders=4,
                   max_delay=2, episodes=1, **kw):
    """Oracle: per-week (obs, reward) through core/beergame.py, resetting at
    each episode start.  ``demand(e)`` / ``delays(e)`` give episode e's
    demand row and delays table (slot 0 = prepended initial delay)."""
    from gym_supplychain_tpu.core.beergame import make_beergame_kernels

    B = actions.shape[-1]
    reset_fn, step_fn, _ = make_beergame_kernels(L, W, max_delay,
                                                 itype=jnp.int32, **kw)
    step = jax.jit(step_fn)
    obs, rew = [], []
    for e in range(episodes):
        st = reset_fn(demand(e), delays(e), inv0, ship, orders, B)
        for w in range(W):
            st, (o, r, _) = step(st, actions[e * W + w])
            obs.append(np.asarray(o))
            rew.append(np.asarray(r))
    return np.stack(obs), np.stack(rew)


def test_pallas_episode_matches_scan():
    from gym_supplychain_tpu.ops.beergame_pallas import (
        make_beergame_collect_pallas)

    W, L, B = 35, 4, 8
    rs = np.random.RandomState(0)
    demand = np.array([4] * 4 + [8] * (W - 4), np.int32)
    actions = rs.randint(0, 16, size=(W, L, B)).astype(np.int32)
    _, scan_rewards = _beergame_scan(
        L, W, lambda e: demand, lambda e: np.full(W + 1, 2, np.int32),
        actions, [12] * L)
    _, pallas_rewards = make_beergame_collect_pallas(
        W, L, B, batch_tile=8, interpret=True)(demand, actions)
    np.testing.assert_array_equal(np.asarray(pallas_rewards), scan_rewards)


def test_pallas_episode_custom_params():
    from gym_supplychain_tpu.ops.beergame_pallas import (
        make_beergame_collect_pallas)

    W, L, B = 20, 3, 4
    rs = np.random.RandomState(5)
    demand = rs.randint(0, 10, size=W).astype(np.int32)
    actions = rs.randint(0, 9, size=(W, L, B)).astype(np.int32)
    scan_obs, scan_rewards = _beergame_scan(
        L, W, lambda e: demand, lambda e: np.full(W + 1, 3, np.int32),
        actions, [5, 9, 13], ship=6, orders=2, max_delay=3, inv_cost=2,
        backlog_cost=7)
    obs, rew = make_beergame_collect_pallas(
        W, L, B, delay=3, init_ship=6, init_orders=2, init_inv=[5, 9, 13],
        inv_cost=2, backlog_cost=7, batch_tile=4, interpret=True)(
            demand, actions)
    np.testing.assert_array_equal(np.asarray(rew), scan_rewards)
    np.testing.assert_array_equal(np.asarray(obs), scan_obs)


def _supplychain_check(cc, demands, actions, leadtimes=None, batch_tile=4):
    """Kernel rewards vs the scan engine on one episode of tables."""
    from gym_supplychain_tpu.ops.reference import supplychain_scan_trajectory
    from gym_supplychain_tpu.ops.supplychain_pallas import (
        make_supplychain_collect_pallas)

    B = actions.shape[-1]
    run = make_supplychain_collect_pallas(cc, B, batch_tile=batch_tile,
                                          interpret=True)
    args = (demands, actions) if leadtimes is None \
        else (demands, leadtimes, actions)
    _, pal = run(*args)
    _, scan = jax.jit(functools.partial(supplychain_scan_trajectory, cc))(
        jnp.asarray(demands, jnp.float32),
        None if leadtimes is None else jnp.asarray(leadtimes),
        jnp.asarray(actions))
    scan = np.asarray(scan)
    np.testing.assert_allclose(np.asarray(pal), scan, rtol=0,
                               atol=1e-5 * np.abs(scan).max())


def test_supplychain_pallas_linear():
    import gym_supplychain_tpu as sct

    T, B = 20, 4
    cc = sct.make("supplychain-linear-v0", total_time_steps=T).cc
    rs = np.random.RandomState(0)
    actions = (2 * rs.rand(T, cc.A, B) - 1).astype(np.float32)
    demands = rs.randint(0, 20, size=(T + 1, cc.R, cc.P, B)).astype(np.float32)
    _supplychain_check(cc, demands, actions)


def test_supplychain_pallas_2perstage():
    """Full 8-node bipartite chain: factories (processing ratio/capacity),
    sorted-cut over 2 destinations, every cost category."""
    import gym_supplychain_tpu as sct

    T, B = 15, 4
    cc = sct.make("supplychain-2perstage-v0", total_time_steps=T,
                  stochastic_leadtimes=False).cc
    rs = np.random.RandomState(3)
    actions = (2 * rs.rand(T, cc.A, B) - 1).astype(np.float32)
    demands = rs.randint(0, 30, size=(T + 1, cc.R, cc.P, B)).astype(np.float32)
    _supplychain_check(cc, demands, actions)


def test_supplychain_pallas_negative_ship_overflow():
    """Regression: the reference's bug-compatible shared ship-capacity
    bookkeeping (SURVEY.md §2.1-4) can drive avail_ship negative, making a
    later product's clipped amount a2c negative; the kernel must then push
    NOTHING into the destination pipeline (supplychain_env.py:343-348), in
    constant-lead-time mode too, exactly like the scan engine."""
    import gym_supplychain_tpu as sct

    T, B = 6, 4
    nodes_info = {
        'Factory': {'initial_stock': [900, 900], 'stock_capacity': 10000,
                    'stock_cost': 1, 'processing_capacity': 5000,
                    'processing_cost': 10,
                    'destinations': ['Retailer'], 'dest_costs': [[2], [2]],
                    'ship_capacity': [100]},
        'Retailer': {'initial_stock': [10, 10], 'stock_capacity': 10000,
                     'stock_cost': 1, 'last_level': True},
    }
    cc = sct.make('supplychain-v0', nodes_info=nodes_info, num_products=2,
                  total_time_steps=T).cc
    # all actions at max: product 0 over-ships (900/3 = 300 > 100), the
    # shared capacity is decremented by the RAW amount (-> 100-300 = -200),
    # product 1 then clips to a2c = -200
    actions = np.ones((T, cc.A, B), np.float32)
    demands = np.full((T + 1, cc.R, cc.P, B), 5, np.float32)
    _supplychain_check(cc, demands, actions)


def test_supplychain_pallas_stochastic_leadtimes():
    """N-to-M chain with stochastic lead-times: the kernel must consume the
    lead-time table with the reference's action-dependent column indexing
    (SURVEY.md §2.1-5) exactly like the scan engine."""
    import gym_supplychain_tpu as sct

    T, B = 15, 4
    cc = sct.make("supplychain-ntom-v0", total_time_steps=T).cc
    assert cc.stochastic_leadtimes and cc.K > 0
    rs = np.random.RandomState(7)
    actions = (2 * rs.rand(T, cc.A, B) - 1).astype(np.float32)
    # include zero actions so some supplies do NOT fire (exercises the
    # action-dependent column advancement)
    actions[actions < -0.5] = -1.0
    demands = rs.randint(0, 30, size=(T + 1, cc.R, cc.P, B)).astype(np.float32)
    leadtimes = rs.randint(1, cc.Lmax + 1, size=(T, cc.K, B)).astype(np.int32)
    _supplychain_check(cc, demands, actions, leadtimes)


def test_pallas_episode_zero_delay():
    """delay=0 delivers straight into downstream inventory the same week
    (reference beergame_env.py:93-96, :111-114) — must match the scan path."""
    from gym_supplychain_tpu.ops.beergame_pallas import (
        make_beergame_collect_pallas)

    W, L, B = 12, 4, 4
    rs = np.random.RandomState(11)
    demand = rs.randint(0, 10, size=W).astype(np.int32)
    actions = rs.randint(0, 9, size=(W, L, B)).astype(np.int32)
    delays = np.zeros(W + 1, np.int32)
    delays[0] = 2   # prepended initial delay seeds the pipeline
    scan_obs, scan_rewards = _beergame_scan(
        L, W, lambda e: demand, lambda e: delays, actions, [12] * L)
    obs, rew = make_beergame_collect_pallas(
        W, L, B, delay=0, init_delay=2, batch_tile=4, interpret=True)(
            demand, actions)
    np.testing.assert_array_equal(np.asarray(rew), scan_rewards)
    np.testing.assert_array_equal(np.asarray(obs), scan_obs)


def test_beergame_collect_actions_matches_scan_two_episodes():
    """Per-week obs + reward bit-equal to the lax.scan kernel across an
    auto-reset boundary (2 back-to-back episodes)."""
    from gym_supplychain_tpu.ops.beergame_pallas import (
        make_beergame_collect_pallas)

    W, L, B, E = 35, 4, 8, 2
    rs = np.random.RandomState(2)
    demand = np.array([4] * 4 + [8] * (W - 4), np.int32)
    actions = rs.randint(0, 16, size=(E * W, L, B)).astype(np.int32)
    scan_obs, scan_rew = _beergame_scan(
        L, W, lambda e: demand, lambda e: np.full(W + 1, 2, np.int32),
        actions, [12] * L, episodes=E)
    obs, rew = make_beergame_collect_pallas(
        W, L, B, episodes=E, batch_tile=8, interpret=True)(demand, actions)
    np.testing.assert_array_equal(np.asarray(obs), scan_obs)
    np.testing.assert_array_equal(np.asarray(rew), scan_rew)


def test_beergame_collect_v2_stochastic_matches_scan():
    """v2 collect kernel (orders = action verbatim, capacity penalty, offset
    obs) with PER-LANE stochastic delay tables — per-week obs + reward
    bit-equal to the lax.scan kernel across an auto-reset boundary,
    including zero-delay weeks (immediate delivery)."""
    from gym_supplychain_tpu.ops.beergame_pallas import (
        make_beergame_collect_pallas)

    W, L, B, E = 20, 4, 8, 2
    MAXD, MS, PEN = 3, 25, 37
    rs = np.random.RandomState(5)
    demand = rs.randint(0, 12, size=(E * W, B)).astype(np.int32)
    delays = rs.randint(0, MAXD + 1, size=(E * W, B)).astype(np.int32)
    actions = rs.randint(0, 16, size=(E * W, L, B)).astype(np.int32)

    # scan-kernel convention: delays table has the prepended initial delay
    # 2 at slot 0 (beergame2_env.py:50), weeks at slots 1..W
    def dtab(e):
        return np.concatenate([np.full((1, B), 2, np.int32),
                               delays[e * W:(e + 1) * W]])

    scan_obs, scan_rew = _beergame_scan(
        L, W, lambda e: demand[e * W:(e + 1) * W], dtab, actions, [12] * L,
        max_delay=max(MAXD, 2), episodes=E, v2=True, max_stock=MS,
        exceeded_capacity_penalty=PEN)
    obs, rew = make_beergame_collect_pallas(
        W, L, B, episodes=E, delay=None, max_delay=MAXD, v2=True,
        max_stock=MS, exceeded_capacity_penalty=PEN, batch_tile=4,
        interpret=True)(demand, delays, actions)
    np.testing.assert_array_equal(np.asarray(obs), scan_obs)
    np.testing.assert_array_equal(np.asarray(rew), scan_rew)


def test_beergame_collect_v2_scalar_delay_matches_scan():
    """v2 flags with a constant scalar delay: the penalty/obs/orders
    changes alone, bit-equal to the scan kernel."""
    from gym_supplychain_tpu.ops.beergame_pallas import (
        make_beergame_collect_pallas)

    W, L, B = 15, 4, 8
    MS, PEN = 30, 11
    rs = np.random.RandomState(9)
    demand = np.array([4] * 4 + [8] * (W - 4), np.int32)
    actions = rs.randint(0, 16, size=(W, L, B)).astype(np.int32)
    scan_obs, scan_rew = _beergame_scan(
        L, W, lambda e: demand, lambda e: np.full(W + 1, 2, np.int32),
        actions, [12] * L, v2=True, max_stock=MS,
        exceeded_capacity_penalty=PEN)
    obs, rew = make_beergame_collect_pallas(
        W, L, B, v2=True, max_stock=MS, exceeded_capacity_penalty=PEN,
        batch_tile=8, interpret=True)(demand, actions)
    np.testing.assert_array_equal(np.asarray(obs), scan_obs)
    np.testing.assert_array_equal(np.asarray(rew), scan_rew)


def test_beergame_collect_batch_tile_matches_untiled():
    """Lane tiles are independent programs: 4-lane tiles reproduce one
    16-lane tile bit for bit, for both the v0 constant-delay and the v2
    per-lane stochastic-delay variants."""
    from gym_supplychain_tpu.ops.beergame_pallas import (
        make_beergame_collect_pallas)

    weeks, L, B, E = 10, 4, 16, 2
    demand = np.array([4] * 4 + [8] * (weeks - 4), np.int32)
    acts = jax.random.randint(jax.random.PRNGKey(0), (E * weeks, L, B),
                              0, 16, jnp.int32)

    kw = dict(episodes=E, interpret=True)
    o1, w1 = make_beergame_collect_pallas(weeks, L, B, batch_tile=16,
                                          **kw)(demand, acts)
    o2, w2 = make_beergame_collect_pallas(weeks, L, B, batch_tile=4,
                                          **kw)(demand, acts)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))

    kw2 = dict(episodes=E, delay=None, max_delay=3, v2=True, max_stock=100,
               exceeded_capacity_penalty=100, interpret=True)
    k = jax.random.PRNGKey(1)
    dem = jax.random.randint(k, (E * weeks, B), 0, 12, jnp.int32)
    dly = jax.random.randint(jax.random.fold_in(k, 1), (E * weeks, B),
                             0, 4, jnp.int32)
    o3, w3 = make_beergame_collect_pallas(weeks, L, B, batch_tile=16,
                                          **kw2)(dem, dly, acts)
    o4, w4 = make_beergame_collect_pallas(weeks, L, B, batch_tile=4,
                                          **kw2)(dem, dly, acts)
    np.testing.assert_array_equal(np.asarray(o3), np.asarray(o4))
    np.testing.assert_array_equal(np.asarray(w3), np.asarray(w4))
