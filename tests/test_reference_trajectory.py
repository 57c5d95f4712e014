"""Full-trajectory parity against the actual reference implementation.

Imports the reference package from /root/reference through a minimal gym
shim (benchmarks/ref_baseline.py) and replays identical seeded episodes
through both engines, comparing observations, rewards and episode returns
step by step.  ``strict_obs=True`` engages the host heap mirror so even the
reference's heap-array-order observation quirk (SURVEY.md §2.1-7) matches.

Skipped when the reference checkout is unavailable.
"""
import os
import sys

import numpy as np
import pytest

REF = "/root/reference"
pytestmark = pytest.mark.skipif(not os.path.isdir(REF),
                                reason="reference checkout not available")


def _load_reference():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from benchmarks.ref_baseline import _install_gym_shim
    _install_gym_shim()
    if REF not in sys.path:
        sys.path.insert(0, REF)
    import importlib
    return importlib.import_module("gym_supplychain.envs")


def _compare(ref_env, our_env, seed, episodes=1, obs_atol=5e-7):
    """Step-by-step comparison.  Tolerances: the reference's float32 action
    arithmetic leaks into its cost bookkeeping whenever a node ships while
    exactly at stock capacity (min(int_capacity, stock) returns the Python
    int, keeping the whole product pipeline in float32; SC_Action.apply
    :62-64).  We emulate the first-order float32 rounding (supply amounts &
    costs, sorted-cut differences, at-capacity cuts); the residual is <= one
    float32 ulp in observations/rewards while *stocks stay bit-exact* (the
    instrumented comparison in this repo's history showed stockdiff == 0
    across full episodes).  Any semantic bug produces O(1) divergence, far
    above these tolerances."""
    ref_env.seed(seed)
    our_env.seed(seed)
    for _ in range(episodes):
        ref_obs = ref_env.reset()
        our_obs = our_env.reset()
        np.testing.assert_allclose(our_obs, ref_obs, atol=obs_atol,
                                   err_msg="reset obs")
        done = False
        t = 0
        ref_total = our_total = 0.0
        while not done:
            t += 1
            a = ref_env.action_space.sample()
            a2 = our_env.action_space.sample()
            np.testing.assert_array_equal(a, a2)
            ref_obs, ref_r, done, _ = ref_env.step(a)
            our_obs, our_r, done2, _ = our_env.step(a)
            assert done == done2
            np.testing.assert_allclose(our_obs, ref_obs, atol=obs_atol,
                                       err_msg=f"obs at t={t}")
            assert np.allclose(our_r, ref_r, rtol=1e-6, atol=1e-2), \
                (t, our_r, ref_r)
            ref_total += ref_r
            our_total += our_r
        assert np.allclose(ref_total, our_total)


def test_2perstage_stochastic_leadtimes_trajectory():
    envs = _load_reference()
    from gym_supplychain_tpu import SupplyChain2perStageEnv
    kw = dict(stochastic_leadtimes=True, avg_leadtime=2, max_leadtime=4,
              total_time_steps=60)
    _compare(envs.SupplyChain2perStageEnv(**kw),
             SupplyChain2perStageEnv(strict_obs=True, **kw),
             seed=0, episodes=2)


def test_ntom_stochastic_trajectory():
    envs = _load_reference()
    from benchmarks.ref_baseline import _ntom_nodes_info
    from gym_supplychain_tpu import SupplyChainNtoMEnv
    ref = envs.SupplyChainEnv(
        _ntom_nodes_info(), num_products=1, demand_range=(10, 20),
        unmet_demand_cost=2 * (5 + 3 * 2 * 2 + 10),
        exceeded_stock_capacity_cost=10, exceeded_process_capacity_cost=10,
        exceeded_ship_capacity_cost=10, processing_ratio=3,
        stochastic_leadtimes=True, avg_leadtime=2, max_leadtime=4,
        total_time_steps=60)
    ours = SupplyChainNtoMEnv(total_time_steps=60, strict_obs=True)
    # align penalty costs with the ref construction above
    _compare(ref, ours, seed=3, episodes=2)


def test_multiproduct_trajectory_constant_leadtimes():
    envs = _load_reference()
    import importlib
    ref_mod = importlib.import_module(
        "gym_supplychain.envs.supplychain_multiproduct_env")
    from gym_supplychain_tpu import SupplyChainMultiProduct
    _compare(ref_mod.SupplyChainMultiProduct(total_time_steps=40),
             SupplyChainMultiProduct(total_time_steps=40, strict_obs=True),
             seed=1, episodes=2)


def test_partial_supply_products_trajectory():
    """Edge case: a supplier with capacity for only SOME products.  The
    lead-time table still allocates num_products columns for the node
    (supplychain_env.py:601-604) while the per-step slice consumes
    num_supply_actions + dests (:719-722) — the action/lead-time index maps
    must reproduce this asymmetry exactly."""
    envs = _load_reference()
    from gym_supplychain_tpu import SupplyChainEnv
    nodes = {
        'Sup': {'initial_stock': [5, 5], 'stock_capacity': [50, 50],
                'stock_cost': [1, 1], 'supply_capacity': [30, 0],
                'supply_cost': [2, 0], 'destinations': ['Ret'],
                'dest_costs': [[1], [1]], 'ship_capacity': [40]},
        'Ret': {'initial_stock': [5, 5], 'stock_capacity': [50, 50],
                'stock_cost': [1, 1], 'last_level': True},
    }
    kw = dict(num_products=2, demand_range=(0, 8), stochastic_leadtimes=True,
              avg_leadtime=2, max_leadtime=4, total_time_steps=30)
    ref = envs.SupplyChainEnv(dict(nodes), **kw)
    ours = SupplyChainEnv(dict(nodes), strict_obs=True, **kw)
    _compare(ref, ours, seed=2, episodes=2)


def test_seasonal_2perstage_stochastic_leadtimes_trajectory():
    """Seasonal chain dynamics WITH lead-times — explicitly flagged untested
    in the reference itself (test_supplychain_2perstage_env.py:4)."""
    envs = _load_reference()
    from gym_supplychain_tpu import SupplyChain2perStageSeasonalEnv
    kw = dict(stochastic_leadtimes=True, avg_leadtime=2, max_leadtime=4,
              total_time_steps=40)
    ref = envs.SupplyChain2perStageSeasonalEnv(**kw)
    ours = SupplyChain2perStageSeasonalEnv(strict_obs=True, **kw)
    _compare(ref, ours, seed=4, episodes=2)


def test_demconfigbyprod_trajectory():
    """Per-product demand configs — flagged untested upstream
    (test_multiproduct_2perstage.py:6).  Exercises the different MT19937
    stream-consumption order (one (T+1, R) draw per product,
    supplychain_env.py:650-661)."""
    envs = _load_reference()
    from gym_supplychain_tpu import SupplyChainMultiProduct_DemConfigByProd
    kw = dict(num_products=3, total_time_steps=40)
    ref = envs.SupplyChainMultiProduct_DemConfigByProd(**kw)
    ours = SupplyChainMultiProduct_DemConfigByProd(strict_obs=True, **kw)
    _compare(ref, ours, seed=5, episodes=2)


def test_nperstage_trajectory():
    """Asymmetric N-per-stage topology [3,2,3,5] — reference only smoke-tests
    these (test_Nperstage.py:6)."""
    envs = _load_reference()
    from gym_supplychain_tpu import SupplyChainNPerStage
    kw = dict(nodes_per_echelon=[3, 2, 3, 5], total_time_steps=30,
              stochastic_leadtimes=True, avg_leadtime=2, max_leadtime=4)
    ref = envs.SupplyChainNPerStage(**kw)
    ours = SupplyChainNPerStage(strict_obs=True, **kw)
    _compare(ref, ours, seed=6, episodes=2)


def test_heap_quirk_manifests():
    """The heap-order observation quirk (SURVEY.md §2.1-7) is real and the
    strict mirror is load-bearing: under stochastic lead-times the reference
    walks each heap's internal ARRAY order, so dense time-indexed in-transit
    buckets must diverge from the reference observations by O(1) while
    (a) dynamics/rewards still agree and (b) the strict heap-mirror mode
    stays within float-rounding tolerance at every step.  A broken mirror
    fails the strict bound; a 'fixed' (non-bug-compatible) dense obs would
    fail the divergence bound."""
    envs = _load_reference()
    from gym_supplychain_tpu import SupplyChain2perStageEnv
    kw = dict(stochastic_leadtimes=True, avg_leadtime=2, max_leadtime=4,
              total_time_steps=60)
    ref = envs.SupplyChain2perStageEnv(**kw)
    dense = SupplyChain2perStageEnv(strict_obs=False, **kw)
    strict = SupplyChain2perStageEnv(strict_obs=True, **kw)
    for e in (ref, dense, strict):
        e.seed(0)
        e.reset()
    max_dense_diff = 0.0
    done = False
    while not done:
        a = ref.action_space.sample()
        dense.action_space.sample()
        strict.action_space.sample()
        ref_obs, ref_r, done, _ = ref.step(a)
        dense_obs, dense_r, _, _ = dense.step(a)
        strict_obs, strict_r, _, _ = strict.step(a)
        # dynamics unaffected by the obs representation
        assert np.allclose(dense_r, ref_r, rtol=1e-7, atol=1e-6)
        # the mirror reproduces the reference heap walk at every step
        np.testing.assert_allclose(strict_obs, ref_obs, atol=5e-7,
                                   err_msg="strict mirror diverged")
        max_dense_diff = max(max_dense_diff,
                             float(np.max(np.abs(dense_obs - ref_obs))))
    # the quirk manifests: dense buckets disagree with the heap walk by O(1)
    assert max_dense_diff > 0.05, (
        f"quirk did not manifest (max dense diff {max_dense_diff}); "
        "pick a config where heap disorder occurs")
