"""Trajectory-collect kernel parity (interpret mode on CPU).

``make_supplychain_collect_pallas`` must reproduce the scan engine step for
step: (obs, rewards) for scripted demand, lead-time and action tables,
across back-to-back episodes and any lane tiling.  The compiled kernel is
compared on the GPU by tests/test_collect_compiled.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np


def _scan_traj(cc, demands, actions, leadtimes=None):
    """Oracle: per-step (pre-action obs, reward) through the scan engine."""
    from gym_supplychain_tpu.core.step import make_supplychain_kernels
    T, B = actions.shape[0], actions.shape[-1]
    reset_fn, step_fn, obs_fn = make_supplychain_kernels(cc)
    st = reset_fn(demands, leadtimes, B)
    step = jax.jit(step_fn)
    obs, rews = [np.asarray(obs_fn(st))], []
    for t in range(T):
        st, o = step(st, jnp.asarray(actions[t]))
        rews.append(np.asarray(o.reward))
        obs.append(np.asarray(o.obs))
    return np.stack(obs[:T]), np.stack(rews)


def _check_actions_mode(env_id, T, B, seed, **make_kw):
    import gym_supplychain_tpu as sct
    from gym_supplychain_tpu.ops.supplychain_pallas import (
        make_supplychain_collect_pallas)

    cc = sct.make(env_id, total_time_steps=T, **make_kw).cc
    rs = np.random.RandomState(seed)
    actions = (2 * rs.rand(T, cc.A, B) - 1).astype(np.float32)
    actions[actions < -0.5] = -1.0     # some supplies must NOT fire (§2.1-5)
    demands = rs.randint(0, 25, size=(T + 1, cc.R, cc.P, B)).astype(np.float32)
    lt = None
    if cc.stochastic_leadtimes:
        lt = rs.randint(1, cc.Lmax + 1, size=(T, cc.K, B)).astype(np.int32)

    run = make_supplychain_collect_pallas(cc, B, batch_tile=4,
                                          interpret=True)
    if lt is not None:
        pal_obs, pal_rew = [np.asarray(x) for x in run(demands, lt, actions)]
    else:
        pal_obs, pal_rew = [np.asarray(x) for x in run(demands, actions)]
    ref_obs, ref_rew = _scan_traj(cc, demands, actions, lt)
    assert pal_obs.shape == (T, cc.obs_dim, B)
    np.testing.assert_allclose(pal_obs, ref_obs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pal_rew, ref_rew, rtol=0,
                               atol=1e-5 * np.abs(ref_rew).max())


def test_collect_actions_linear():
    _check_actions_mode("supplychain-linear-v0", 20, 4, 0)


def test_collect_actions_2perstage():
    _check_actions_mode("supplychain-2perstage-v0", 12, 4, 3,
                        stochastic_leadtimes=False)


def test_collect_actions_ntom_stochastic():
    _check_actions_mode("supplychain-ntom-v0", 15, 4, 7)


def test_collect_multi_episode_auto_reset():
    """Back-to-back episodes in one kernel: with identical tiled per-episode
    tables the emitted trajectory must repeat exactly across episodes (the
    in-kernel auto-reset restores the full reset state at each boundary)."""
    import gym_supplychain_tpu as sct
    from gym_supplychain_tpu.ops.supplychain_pallas import (
        make_supplychain_collect_pallas)

    T, B, episodes = 8, 4, 3
    cc = sct.make("supplychain-linear-v0", total_time_steps=T).cc
    rs = np.random.RandomState(4)
    actions1 = (2 * rs.rand(T, cc.A, B) - 1).astype(np.float32)
    demands1 = rs.randint(0, 25, size=(T + 1, cc.R, cc.P, B)).astype(np.float32)

    # step s reads table row s, so episodes > 1 take S-row tiled tables
    dem_tiled = np.concatenate([demands1[:T]] * episodes, axis=0)
    act_tiled = np.concatenate([actions1] * episodes, axis=0)

    run = make_supplychain_collect_pallas(cc, B, episodes=episodes,
                                          batch_tile=4, interpret=True)
    obs, rew = [np.asarray(x) for x in run(dem_tiled, act_tiled)]
    ref_obs, ref_rew = _scan_traj(cc, demands1, actions1)
    for e in range(episodes):
        np.testing.assert_allclose(obs[e * T:(e + 1) * T], ref_obs,
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(obs[e * T:(e + 1) * T], obs[:T])
        np.testing.assert_array_equal(rew[e * T:(e + 1) * T], rew[:T])


def test_collect_batch_tile_matches_untiled():
    """Lane tiles are independent programs: 4-lane tiles must reproduce one
    16-lane tile bit for bit on both a constant- and a stochastic-lead-time
    preset, across an episode boundary."""
    import gym_supplychain_tpu as sct
    from gym_supplychain_tpu.ops.supplychain_pallas import (
        make_supplychain_collect_pallas)

    for env_id, T in (("supplychain-linear-v0", 8),
                      ("supplychain-ntom-v0", 6)):
        cc = sct.make(env_id, total_time_steps=T).cc
        B, E = 16, 2
        S = E * T
        run_full = make_supplychain_collect_pallas(
            cc, B, episodes=E, batch_tile=16, interpret=True)
        run_tile = make_supplychain_collect_pallas(
            cc, B, episodes=E, batch_tile=4, interpret=True)
        rs = np.random.RandomState(11)
        dem = rs.randint(0, 25, size=(S, cc.R, cc.P, B)).astype(np.float32)
        act = (2 * rs.rand(S, cc.A, B) - 1).astype(np.float32)
        args = [dem]
        if cc.stochastic_leadtimes:
            args.append(rs.randint(1, cc.Lmax + 1,
                                   size=(S, cc.K, B)).astype(np.int32))
        args.append(act)
        o1, r1 = run_full(*args)
        o2, r2 = run_tile(*args)
        np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
        np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
