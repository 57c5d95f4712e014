"""Parameter-validation parity with the reference:

- non-int scalar node params raise ValueError
  (`_treat_int_or_list_param`, supplychain_env.py:178-191)
- per-product lists of the wrong length raise AssertionError (:182)
- degenerate demand range (min == max) raises AssertionError (:589-595)
"""
import numpy as np
import pytest

from gym_supplychain_tpu import SupplyChainEnv


def _nodes(**over):
    n = {'Sup': {'initial_stock': 10, 'stock_capacity': 100, 'stock_cost': 1,
                 'supply_capacity': 50, 'supply_cost': 2,
                 'destinations': ['Ret'], 'dest_costs': [[1]],
                 'ship_capacity': [100]},
         'Ret': {'initial_stock': 10, 'stock_capacity': 100, 'stock_cost': 1,
                 'last_level': True}}
    n['Sup'].update(over)
    return n


def test_float_scalar_param_raises():
    with pytest.raises(ValueError):
        SupplyChainEnv(_nodes(supply_capacity=50.5), demand_range=(0, 10),
                       total_time_steps=5)


def test_wrong_length_product_list_raises():
    with pytest.raises(AssertionError):
        SupplyChainEnv(_nodes(supply_capacity=[50, 60]), num_products=3,
                       demand_range=(0, 10), total_time_steps=5)


def test_degenerate_demand_range_raises():
    with pytest.raises(AssertionError):
        SupplyChainEnv(_nodes(), demand_range=(5, 5), total_time_steps=5)


def test_empty_list_defaults_like_reference():
    """An empty list means 'use the default per product' (:181-183)."""
    env = SupplyChainEnv(_nodes(supply_cost=[]), demand_range=(0, 10),
                         total_time_steps=5)
    env.seed(0)
    env.reset()
    obs, r, done, _ = env.step(np.zeros(env.cc.A))
    assert np.isfinite(r)


def test_unknown_env_id():
    import gym_supplychain_tpu as sct
    with pytest.raises(KeyError):
        sct.make("not-an-env-v0")


def test_action_tail_ignored():
    """Actions longer than the action dim are accepted with the tail ignored,
    matching the reference's numpy slicing (supplychain_env.py:714-717)."""
    env = SupplyChainEnv(_nodes(), demand_range=(0, 10), total_time_steps=3)
    env.seed(0)
    env.reset()
    _, r1, _, _ = env.step(np.zeros(env.cc.A + 5))
    assert np.isfinite(r1)


def test_processing_capacity_without_cost_raises():
    """processing_capacity > 0 with processing_cost == 0 zeroes the ratio
    (supplychain_env.py:518-522) and makes the reference divide shipments by
    zero (:310); here it must fail loudly at compile time."""
    with pytest.raises(ValueError):
        SupplyChainEnv(_nodes(processing_capacity=100), demand_range=(0, 10),
                       total_time_steps=5)


@pytest.mark.parametrize("over", [dict(ship_capacity=[-1]),
                                  dict(processing_capacity=-5,
                                       processing_cost=1)],
                         ids=["ship_capacity", "processing_capacity"])
def test_negative_capacity_raises(over):
    """Negative capacities have no meaning upstream, and the collect
    kernel's one-product ship clip relies on cap >= 0."""
    with pytest.raises(ValueError, match=">= 0"):
        SupplyChainEnv(_nodes(**over), demand_range=(0, 10),
                       total_time_steps=5)
