"""Ports of the reference's hand-computed step-dynamics tests
(test_supplychain_env.py) against this engine in float64 parity mode.

Heap-content assertions become dense pipeline-bucket assertions (amounts
aggregated per arrival time); arrival/cost dynamics are identical (SURVEY.md
§2.1-7: only heap *array order* can differ, which these constant/stochastic
lead-time scenarios don't exhibit in observations either).
"""
import numpy as np

from gym_supplychain_tpu import SupplyChainEnv
from .utils import check_build_info, pipes, simple_chain


def _create_env(num_products=1, stochastic_leadtimes=False, avg_leadtime=2,
                max_leadtime=4, build_info=False):
    nodes_info = simple_chain(num_products=num_products, initial_stock=10,
                              stock_capacity=100, stock_cost=1, dest_cost=2,
                              supply_cost=5, supply_capacity=50,
                              processing_cost=10, processing_capacity=100,
                              ship_capacity=100)
    return SupplyChainEnv(nodes_info, num_products=num_products,
                          unmet_demand_cost=1000,
                          exceeded_stock_capacity_cost=1000,
                          exceeded_process_capacity_cost=1000,
                          exceeded_ship_capacity_cost=1000,
                          demand_range=(0, 5), processing_ratio=2,
                          stochastic_leadtimes=stochastic_leadtimes,
                          avg_leadtime=avg_leadtime, max_leadtime=max_leadtime,
                          total_time_steps=5, build_info=build_info)


def _simpleenv(build_info=False):
    return _create_env(stochastic_leadtimes=False, avg_leadtime=2,
                       max_leadtime=2, build_info=build_info)


def _stoc_env(build_info=False):
    return _create_env(stochastic_leadtimes=True, avg_leadtime=2,
                       max_leadtime=4, build_info=build_info)


def test_initial_stocks():
    env = _simpleenv()
    env.seed(0)
    env.reset()
    for n in range(4):
        assert np.all(env.stock(n) == [10])
        assert np.all(env.cc.stock_cap[n] == [100])
        assert np.all(env.cc.stock_cost[n] == [1])


def test_simpleenv():
    """Reference test_supplychain_env.py:60-127."""
    env = _simpleenv()
    env.seed(0)
    env.reset()
    assert np.all(env.customer_demands.flatten() == [4, 5, 0, 3, 3, 3])
    for n in range(4):
        assert pipes(env, n) == {}

    supply_action = 2 * np.array([1, 0, 0, 0, 0, 0]) - 1
    env.step(supply_action)  # t=1
    assert pipes(env, 0) == {3: 50}
    for n in range(1, 4):
        assert pipes(env, n) == {}
    for n in range(3):
        assert env.stock(n) == 10
    assert env.stock(3) == 10 - env.customer_demands[0]

    send_all = 2 * np.ones(6) - 1
    env.step(send_all)  # t=2
    assert pipes(env, 0) == {3: 50, 4: 50}
    assert pipes(env, 1) == {4: 10}
    assert pipes(env, 2) == {4: 5}
    assert pipes(env, 3) == {4: 10}
    for n in range(3):
        assert env.stock(n) == 0
    assert env.stock(3) == max(0, 10 - env.customer_demands[:env.time_step].sum())

    env.step(send_all)  # t=3
    assert pipes(env, 0) == {4: 50, 5: 50}
    assert pipes(env, 1) == {4: 10, 5: 50}
    assert pipes(env, 2) == {4: 5}
    assert pipes(env, 3) == {4: 10}
    for n in range(3):
        assert env.stock(n) == 0
    assert env.stock(3) == max(0, 10 - env.customer_demands[:env.time_step].sum())

    env.step(send_all)  # t=4
    assert pipes(env, 0) == {5: 50, 6: 50}
    assert pipes(env, 1) == {5: 50, 6: 50}
    assert pipes(env, 2) == {6: 5}
    assert pipes(env, 3) == {6: 5}
    for n in range(3):
        assert env.stock(n) == 0
    assert env.stock(3) == max(0, 20 - env.customer_demands[:env.time_step].sum())

    env.step(send_all)  # t=5
    assert pipes(env, 0) == {6: 50, 7: 50}
    assert pipes(env, 1) == {6: 50, 7: 50}
    assert pipes(env, 2) == {6: 5, 7: 25}
    assert pipes(env, 3) == {6: 5}
    for n in range(3):
        assert env.stock(n) == 0
    assert env.stock(3) == max(0, 20 - env.customer_demands[:env.time_step].sum())


def test_stocleadtimes_simpleenv():
    """Reference test_supplychain_env.py:129-205 (action-dependent lead-time
    stream consumption, exact Poisson table under seed 0)."""
    env = _stoc_env()
    env.seed(0)
    env.reset()
    assert np.all(env.customer_demands.flatten() == [4, 5, 0, 3, 3, 3])
    assert np.all(env.leadtimes == [[3, 1, 1, 1],
                                    [3, 2, 1, 2],
                                    [2, 3, 2, 3],
                                    [2, 2, 2, 1],
                                    [1, 1, 1, 2]])
    for n in range(4):
        assert pipes(env, n) == {}

    supply_action = 2 * np.array([1, 0, 0, 0, 0, 0]) - 1
    env.step(supply_action)  # t=1
    assert pipes(env, 0) == {4: 50}
    for n in range(1, 4):
        assert pipes(env, n) == {}
    for n in range(3):
        assert env.stock(n) == 10
    assert env.stock(3) == 10 - env.customer_demands[0]

    send_all = 2 * np.ones(6) - 1
    env.step(send_all)  # t=2
    assert pipes(env, 0) == {4: 50, 5: 50}
    assert pipes(env, 1) == {4: 10}
    assert pipes(env, 2) == {3: 5}
    assert pipes(env, 3) == {4: 10}
    for n in range(3):
        assert env.stock(n) == 0
    assert env.stock(3) == max(0, 10 - env.customer_demands[:env.time_step].sum())

    env.step(send_all)  # t=3
    assert pipes(env, 0) == {4: 50, 5: 100}
    assert pipes(env, 1) == {4: 10}
    assert pipes(env, 2) == {}
    assert pipes(env, 3) == {4: 10, 6: 5}
    for n in range(3):
        assert env.stock(n) == 0

    env.step(send_all)  # t=4
    assert pipes(env, 0) == {5: 100, 6: 50}
    assert pipes(env, 1) == {6: 50}
    assert pipes(env, 2) == {6: 5}
    assert pipes(env, 3) == {6: 5}
    for n in range(3):
        assert env.stock(n) == 0
    assert env.stock(3) == max(0, 20 - env.customer_demands[:env.time_step].sum())

    env.step(send_all)  # t=5
    assert pipes(env, 0) == {6: 100}
    assert pipes(env, 1) == {6: 150}
    assert pipes(env, 2) == {6: 5}
    assert pipes(env, 3) == {6: 5}
    for n in range(3):
        assert env.stock(n) == 0
    assert env.stock(3) == max(0, 20 - env.customer_demands[:env.time_step].sum())


def test_build_info_simpleenv():
    check_build_info(_simpleenv(build_info=True))


def test_build_info_stocleadtimes():
    check_build_info(_stoc_env(build_info=True))


def test_const_leadtime_exceeding_max_leadtime():
    """Constant mode ships at t+avg_leadtime even when avg > max_leadtime
    (the reference's heaps accept any arrival time; max_leadtime only clips
    stochastic draws).  Dynamics must be identical to avg == max."""
    def run(max_lt):
        env = SupplyChainEnv(
            simple_chain(initial_stock=10, stock_capacity=100,
                                supply_capacity=50, processing_capacity=100,
                                ship_capacity=100),
            demand_range=(0, 5), processing_ratio=2, total_time_steps=8,
            avg_leadtime=3, max_leadtime=max_lt)
        env.seed(0)
        env.reset()
        rewards = []
        for t in range(8):
            _, r, _, _ = env.step(np.ones(env.cc.A))
            rewards.append(r)
        return np.asarray(rewards)

    np.testing.assert_allclose(run(2), run(3))
