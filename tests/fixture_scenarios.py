"""Shared scenario table for the recorded-trajectory parity fixtures.

Each scenario names a reference environment configuration (the 7 golden
configs exercised live by tests/test_reference_trajectory.py) and how to
construct BOTH engines for it.  ``tests/record_fixtures.py`` runs the
reference side once (requires the /root/reference checkout) and commits the
resulting action/observation/reward trajectories to
``tests/data/ref_trajectories.npz``; ``tests/test_recorded_trajectory.py``
replays them through this package with NO reference checkout needed —
mirroring how the reference ships its own committed RNG-stream oracles
(reference gym_supplychain/envs/tests/data/*.npy, loaded at
test_supplychain_env.py:207-285).
"""
import numpy as np

# name -> dict(seed, episodes, make() -> strict-obs env,
#              make_ref(envs_module) -> reference env)
SC_SCENARIOS = {}


def _scenario(name, seed, episodes=2):
    def deco(fn):
        SC_SCENARIOS[name] = dict(seed=seed, episodes=episodes, build=fn)
        return fn
    return deco


def _partial_supply_nodes():
    return {
        'Sup': {'initial_stock': [5, 5], 'stock_capacity': [50, 50],
                'stock_cost': [1, 1], 'supply_capacity': [30, 0],
                'supply_cost': [2, 0], 'destinations': ['Ret'],
                'dest_costs': [[1], [1]], 'ship_capacity': [40]},
        'Ret': {'initial_stock': [5, 5], 'stock_capacity': [50, 50],
                'stock_cost': [1, 1], 'last_level': True},
    }


# Each build(ref_envs) returns (ref_env_or_None, our_env): pass ref_envs=None
# to construct only this package's side (the replay path).

@_scenario("2perstage_stochastic_leadtimes", seed=0)
def _build_2perstage(ref_envs):
    from gym_supplychain_tpu import SupplyChain2perStageEnv
    kw = dict(stochastic_leadtimes=True, avg_leadtime=2, max_leadtime=4,
              total_time_steps=60)
    ref = ref_envs.SupplyChain2perStageEnv(**kw) if ref_envs else None
    return ref, SupplyChain2perStageEnv(strict_obs=True, **kw)


@_scenario("ntom_stochastic", seed=3)
def _build_ntom(ref_envs):
    from gym_supplychain_tpu import SupplyChainNtoMEnv
    ours = SupplyChainNtoMEnv(total_time_steps=60, strict_obs=True)
    ref = None
    if ref_envs:
        from benchmarks.ref_baseline import _ntom_nodes_info
        ref = ref_envs.SupplyChainEnv(
            _ntom_nodes_info(), num_products=1, demand_range=(10, 20),
            unmet_demand_cost=2 * (5 + 3 * 2 * 2 + 10),
            exceeded_stock_capacity_cost=10,
            exceeded_process_capacity_cost=10,
            exceeded_ship_capacity_cost=10, processing_ratio=3,
            stochastic_leadtimes=True, avg_leadtime=2, max_leadtime=4,
            total_time_steps=60)
    return ref, ours


@_scenario("multiproduct_constant_leadtimes", seed=1)
def _build_multiproduct(ref_envs):
    from gym_supplychain_tpu import SupplyChainMultiProduct
    ref = None
    if ref_envs:
        import importlib
        ref_mod = importlib.import_module(
            "gym_supplychain.envs.supplychain_multiproduct_env")
        ref = ref_mod.SupplyChainMultiProduct(total_time_steps=40)
    return ref, SupplyChainMultiProduct(total_time_steps=40, strict_obs=True)


@_scenario("partial_supply_products", seed=2)
def _build_partial(ref_envs):
    from gym_supplychain_tpu import SupplyChainEnv
    kw = dict(num_products=2, demand_range=(0, 8), stochastic_leadtimes=True,
              avg_leadtime=2, max_leadtime=4, total_time_steps=30)
    ref = (ref_envs.SupplyChainEnv(_partial_supply_nodes(), **kw)
           if ref_envs else None)
    return ref, SupplyChainEnv(_partial_supply_nodes(), strict_obs=True, **kw)


@_scenario("seasonal_2perstage_stochastic", seed=4)
def _build_seasonal(ref_envs):
    from gym_supplychain_tpu import SupplyChain2perStageSeasonalEnv
    kw = dict(stochastic_leadtimes=True, avg_leadtime=2, max_leadtime=4,
              total_time_steps=40)
    ref = ref_envs.SupplyChain2perStageSeasonalEnv(**kw) if ref_envs else None
    return ref, SupplyChain2perStageSeasonalEnv(strict_obs=True, **kw)


@_scenario("demconfigbyprod", seed=5)
def _build_demconfig(ref_envs):
    from gym_supplychain_tpu import SupplyChainMultiProduct_DemConfigByProd
    kw = dict(num_products=3, total_time_steps=40)
    ref = (ref_envs.SupplyChainMultiProduct_DemConfigByProd(**kw)
           if ref_envs else None)
    return ref, SupplyChainMultiProduct_DemConfigByProd(strict_obs=True, **kw)


@_scenario("nperstage_3_2_3_5", seed=6)
def _build_nperstage(ref_envs):
    from gym_supplychain_tpu import SupplyChainNPerStage
    kw = dict(nodes_per_echelon=[3, 2, 3, 5], total_time_steps=30,
              stochastic_leadtimes=True, avg_leadtime=2, max_leadtime=4)
    ref = ref_envs.SupplyChainNPerStage(**kw) if ref_envs else None
    return ref, SupplyChainNPerStage(strict_obs=True, **kw)


# ---------------------------------------------------------------------------
# Beer game scenarios (tests/test_beergame_reference.py live equivalents)
# ---------------------------------------------------------------------------

def beergame_scenarios():
    """name -> dict(make() -> env, kwargs for the paired construction,
    actions [n_episodes][T, L] int).  Actions are derived from committed
    RandomState streams so the recorder and the replay generate identical
    inputs without gym."""
    v0_acts = [np.random.RandomState(0).randint(0, 16, size=(35, 4))]
    demand = [3, 7, 1, 9, 5, 2, 8, 6, 4, 10] * 2
    delays = [2, 0, 1, 3, 0, 2, 1, 0, 3, 2] * 2
    custom_info = {'levels': 3, 'customer_demand': demand,
                   'shipment_delays': delays,
                   'initial_inventory': [5, 8, 11], 'inv_cost': 2,
                   'backlog_cost': 5, 'initial_shipment_value': 3,
                   'initial_orders_value': 2}
    custom_acts = [np.random.RandomState(7).randint(0, 12,
                                                    size=(len(demand), 3))]
    v2_kw = dict(customer_demand=(0, 12), shipment_delays=(0, 4),
                 max_stock=40, exceeded_capacity_penalty=37, seed=11)
    rs = np.random.RandomState(3)
    v2_acts = [rs.randint(0, 20, size=(35, 4)) for _ in range(3)]
    return {
        "v0_default": dict(cls="BeerGameEnv", args=(), kwargs={},
                           actions=v0_acts),
        "v0_custom_zero_delays": dict(cls="BeerGameEnv",
                                      args=(dict(custom_info),), kwargs={},
                                      actions=custom_acts),
        "v2_stochastic_streams": dict(cls="BeerGameEnv2", args=(),
                                      kwargs=v2_kw, actions=v2_acts),
    }
