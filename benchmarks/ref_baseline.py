"""Measure the reference NumPy envs' single-process throughput.

Classic gym is not installed, so a minimal shim module satisfies the
reference's ``import gym`` surface (Env base, Box/MultiDiscrete spaces with
the classic sampling streams).  We import the reference package from
/root/reference read-only and time its envs as-is.  Results are cached to
``ref_baseline.json`` next to this file so benchmark runs don't depend on the
reference being present.
"""
from __future__ import annotations

import importlib
import json
import os
import sys
import time
import types

REF_PATH = "/root/reference"
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "ref_baseline.json")


def _install_gym_shim():
    import numpy as np
    from gym_supplychain_tpu.rng.gym_compat import OldGymBox, old_gym_np_random
    from gym_supplychain_tpu.envs.beergame import OldGymMultiDiscrete

    gym = types.ModuleType("gym")

    class Env:
        def close(self):
            pass

    class _Box(OldGymBox):
        def __init__(self, low=-1.0, high=1.0, shape=None, dtype=np.float32):
            super().__init__(float(np.min(low)), float(np.max(high)),
                             shape, dtype)

    spaces = types.ModuleType("gym.spaces")
    spaces.Box = _Box
    spaces.MultiDiscrete = OldGymMultiDiscrete
    utils = types.ModuleType("gym.utils")
    seeding = types.ModuleType("gym.utils.seeding")
    seeding.np_random = lambda seed=None: (old_gym_np_random(seed), seed)
    utils.seeding = seeding
    error = types.ModuleType("gym.error")
    error.Error = Exception
    registration = types.ModuleType("gym.envs.registration")
    registration.register = lambda **kw: None
    envs_mod = types.ModuleType("gym.envs")
    envs_mod.registration = registration

    gym.Env = Env
    gym.spaces = spaces
    gym.utils = utils
    gym.error = error
    gym.envs = envs_mod
    for name, mod in [("gym", gym), ("gym.spaces", spaces),
                      ("gym.utils", utils), ("gym.utils.seeding", seeding),
                      ("gym.error", error), ("gym.envs", envs_mod),
                      ("gym.envs.registration", registration)]:
        sys.modules[name] = mod


def measure(min_seconds: float = 3.0):
    """Returns {config: steps_per_second} for the reference envs."""
    import numpy as np
    _install_gym_shim()
    sys.path.insert(0, REF_PATH)
    sc = importlib.import_module("gym_supplychain.envs.supplychain_env")
    bg = importlib.import_module("gym_supplychain.envs.beergame_env")

    results = {}

    def time_env(name, env, scripted_action=None):
        if hasattr(env, "seed"):
            env.seed(0)
        env.reset()
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < min_seconds:
            a = (env.action_space.sample() if scripted_action is None
                 else scripted_action)
            _, _, done, _ = env.step(a)
            n += 1
            if done:
                env.reset()
        results[name] = n / (time.perf_counter() - t0)

    # linear chain (same topology as supplychain-linear-v0)
    nodes_info = {
        'Supplier': {'initial_stock': 10, 'stock_capacity': 100, 'stock_cost': 1,
                     'supply_capacity': 50, 'supply_cost': 5,
                     'destinations': ['Factory'], 'dest_costs': [[2]],
                     'ship_capacity': [100]},
        'Factory': {'initial_stock': 10, 'stock_capacity': 100, 'stock_cost': 1,
                    'processing_capacity': 100, 'processing_cost': 10,
                    'destinations': ['Wholesal'], 'dest_costs': [[2]],
                    'ship_capacity': [100]},
        'Wholesal': {'initial_stock': 10, 'stock_capacity': 100, 'stock_cost': 1,
                     'destinations': ['Retailer'], 'dest_costs': [[2]],
                     'ship_capacity': [100]},
        'Retailer': {'initial_stock': 10, 'stock_capacity': 100, 'stock_cost': 1,
                     'last_level': True},
    }
    time_env("supplychain-linear-v0",
             sc.SupplyChainEnv(nodes_info, demand_range=(0, 5),
                               processing_ratio=2, total_time_steps=360))

    # N-to-M demo graph (supplychain-ntom-v0), stochastic lead-times
    from gym_supplychain_tpu.envs.presets import SupplyChainNtoMEnv
    ntom_nodes = {}
    our_env = SupplyChainNtoMEnv(total_time_steps=360)
    # rebuild the same nodes_info dict for the reference class
    import gym_supplychain_tpu.envs.presets as presets
    env_ref = sc.SupplyChainEnv(
        _ntom_nodes_info(), num_products=1, demand_range=(10, 20),
        unmet_demand_cost=2 * (5 + 3 * 2 * 2 + 10),
        exceeded_stock_capacity_cost=10, exceeded_process_capacity_cost=10,
        exceeded_ship_capacity_cost=10, processing_ratio=3,
        stochastic_leadtimes=True, avg_leadtime=2, max_leadtime=4,
        total_time_steps=360)
    time_env("supplychain-ntom-v0", env_ref)

    time_env("beergame-v0", bg.BeerGameEnv(),
             scripted_action=np.array([1, 2, 3, 4]))
    return results


def _ntom_nodes_info():
    stock_capacity, ship_capacity = 300, 300
    nodes_info = {}
    for i, s0 in (('1', 10), ('2', 0)):
        nodes_info[f'Supplier {i}'] = {
            'initial_stock': s0, 'stock_capacity': stock_capacity,
            'stock_cost': 1, 'supply_capacity': 50, 'supply_cost': 5,
            'destinations': ['Factory  1', 'Factory  2'],
            'dest_costs': [[2] * 2], 'ship_capacity': [ship_capacity] * 2}
    for i in ('1', '2'):
        nodes_info[f'Factory  {i}'] = {
            'initial_stock': 0, 'stock_capacity': stock_capacity,
            'stock_cost': 1, 'processing_capacity': 50, 'processing_cost': 10,
            'destinations': ['Wholesal 1', 'Wholesal 2'],
            'dest_costs': [[2] * 2], 'ship_capacity': [ship_capacity] * 2}
    for i, s0 in (('1', 10), ('2', 15)):
        nodes_info[f'Wholesal {i}'] = {
            'initial_stock': s0, 'stock_capacity': stock_capacity,
            'stock_cost': 1, 'destinations': ['Retailer 1', 'Retailer 2'],
            'dest_costs': [[2] * 2], 'ship_capacity': [ship_capacity] * 2}
    for i, s0 in (('1', 10), ('2', 20)):
        nodes_info[f'Retailer {i}'] = {
            'initial_stock': s0, 'stock_capacity': stock_capacity,
            'stock_cost': 1, 'last_level': True}
    return nodes_info


def get_baseline():
    """Cached numbers by default (stable across runs and measured on an
    idle host — live re-measurement under benchmark load would flatter us);
    set GST_REMEASURE=1 to re-measure from /root/reference."""
    if os.environ.get("GST_REMEASURE") == "1" and os.path.isdir(REF_PATH):
        try:
            results = measure()
            with open(CACHE, "w") as fh:
                json.dump(results, fh, indent=1)
            return results
        except Exception as e:  # pragma: no cover
            print(f"# reference measurement failed: {e}", file=sys.stderr)
    if os.path.exists(CACHE):
        with open(CACHE) as fh:
            return json.load(fh)
    if os.path.isdir(REF_PATH):
        results = measure()
        with open(CACHE, "w") as fh:
            json.dump(results, fh, indent=1)
        return results
    return {}


if __name__ == "__main__":
    print(json.dumps(get_baseline(), indent=1))
