"""Beer game full-trajectory parity against the ACTUAL reference code.

The reference ships no beer game tests at all (SURVEY.md §4), so
tests/test_beergame.py checks our kernels against a NumPy oracle; here we go
further and replay identical episodes through the real reference classes
(beergame_env.py:6-181, beergame2_env.py:5-211) imported via the gym shim —
including v2's stochastic demand/delay streams and zero-delay weeks.

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


def _run_pair(ref, ours, actions):
    """Step both envs with the given per-week actions; compare everything."""
    ref_obs = ref.reset()
    our_obs = ours.reset()
    np.testing.assert_array_equal(our_obs, ref_obs, err_msg="reset obs")
    for t, a in enumerate(actions):
        ref_obs, ref_r, ref_done, _ = ref.step(a)
        our_obs, our_r, our_done, _ = ours.step(a)
        np.testing.assert_array_equal(our_obs, ref_obs,
                                      err_msg=f"obs week {t + 1}")
        assert float(our_r) == float(ref_r), f"reward week {t + 1}"
        assert bool(our_done) == bool(ref_done)
    np.testing.assert_array_equal(ours.inventory, ref.inventory)
    np.testing.assert_array_equal(ours.backlog, ref.backlog)


def test_v0_default_random_actions():
    envs = _load_reference()
    from gym_supplychain_tpu.envs.beergame import BeerGameEnv
    rs = np.random.RandomState(0)
    actions = [rs.randint(0, 16, size=4) for _ in range(35)]
    _run_pair(envs.BeerGameEnv(), BeerGameEnv(), actions)


def test_v0_custom_levels_and_zero_delays():
    envs = _load_reference()
    from gym_supplychain_tpu.envs.beergame import BeerGameEnv
    demand = [3, 7, 1, 9, 5, 2, 8, 6, 4, 10] * 2
    delays = [2, 0, 1, 3, 0, 2, 1, 0, 3, 2] * 2
    info = {'levels': 3, 'customer_demand': demand,
            'shipment_delays': delays, 'initial_inventory': [5, 8, 11],
            'inv_cost': 2, 'backlog_cost': 5, 'initial_shipment_value': 3,
            'initial_orders_value': 2}
    rs = np.random.RandomState(7)
    actions = [rs.randint(0, 12, size=3) for _ in range(len(demand))]
    _run_pair(envs.BeerGameEnv(dict(info)), BeerGameEnv(dict(info)), actions)


def test_v2_deterministic_sampled_actions():
    envs = _load_reference()
    from gym_supplychain_tpu.envs.beergame import BeerGameEnv2
    ref = envs.BeerGameEnv2()
    ours = BeerGameEnv2()
    ref.action_space.seed(0)
    actions = [ref.action_space.sample() for _ in range(35)]
    _run_pair(ref, ours, actions)


def test_v2_stochastic_streams_two_episodes():
    """Stochastic demand AND delays (incl. zero-delay weeks): the MT19937
    draw order (demand first, then delays, per reset; beergame2_env.py:87-92)
    must match across consecutive episodes of one seeded stream."""
    envs = _load_reference()
    from gym_supplychain_tpu.envs.beergame import BeerGameEnv2
    kw = dict(customer_demand=(0, 12), shipment_delays=(0, 4), max_stock=40,
              exceeded_capacity_penalty=37, seed=11)
    ref = envs.BeerGameEnv2(**kw)
    ours = BeerGameEnv2(**kw)
    rs = np.random.RandomState(3)
    for _ in range(3):
        actions = [rs.randint(0, 20, size=4) for _ in range(35)]
        _run_pair(ref, ours, actions)
        np.testing.assert_array_equal(ours.customer_demand,
                                      ref.customer_demand)
        np.testing.assert_array_equal(ours.shipment_delays,
                                      ref.shipment_delays)


def test_v2_reseed_reproduces():
    envs = _load_reference()
    from gym_supplychain_tpu.envs.beergame import BeerGameEnv2
    ours = BeerGameEnv2(customer_demand=(2, 9), shipment_delays=(1, 3))
    ours.seed(5)
    ours.reset()
    d1 = np.copy(ours.customer_demand)
    ours.reset()
    d2 = np.copy(ours.customer_demand)
    assert not np.array_equal(d1, d2)
    ours.seed(5)
    ours.reset()
    np.testing.assert_array_equal(ours.customer_demand, d1)
