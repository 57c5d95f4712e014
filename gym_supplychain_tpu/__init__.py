"""gym-supplychain-tpu: vectorized supply-chain RL environments in JAX.

A ground-up JAX/XLA re-design of the capabilities of ``gym-supplychain``
(beer game + graph supply-chain simulators): pure-functional lockstep step
kernels batched over thousands of envs, host-parity MT19937 stochastic inputs,
and mesh-sharded rollouts.  See README.md.

Environment ids cover every reference registration
(gym_supplychain/__init__.py:1-51) plus the README-documented topology names
(README.md:17-23) the reference never registered.
"""
from .core.compile import CompiledChain, DemandConfig, compile_chain
from .core.step import COST_KEYS, EnvState, StepOutput, make_supplychain_kernels
from .envs.beergame import BeerGameEnv, BeerGameEnv2
from .envs.single import SupplyChainEnv
from .rng.host import generate_demand
from .envs.presets import (
    SupplyChain2perStageEnv, SupplyChain2perStageSeasonalEnv,
    SupplyChainMultiProduct, SupplyChainMultiProduct_IncreasingCosts,
    SupplyChainMultiProduct_DemConfigByProd,
    SupplyChainMultiProduct_DemConfigByProd_IncCosts,
    SupplyChainNPerStage, SupplyChainLinearEnv, SupplyChainOneOneNEnv,
    SupplyChainNtoMEnv,
)

_REGISTRY = {
    # reference ids (gym_supplychain/__init__.py:1-51)
    "beergame-v0": "gym_supplychain_tpu.envs.beergame:BeerGameEnv",
    "beergame-v2": "gym_supplychain_tpu.envs.beergame:BeerGameEnv2",
    "supplychain-v0": "gym_supplychain_tpu.envs.single:SupplyChainEnv",
    "sc-2perstage-v0": "gym_supplychain_tpu.envs.presets:SupplyChain2perStageEnv",
    "sc-2perstage-seasonal-v0": "gym_supplychain_tpu.envs.presets:SupplyChain2perStageSeasonalEnv",
    "sc-2perstage-multiproduct-v0": "gym_supplychain_tpu.envs.presets:SupplyChainMultiProduct",
    "sc-Nperstage-multiproduct-v0": "gym_supplychain_tpu.envs.presets:SupplyChainNPerStage",
    "sc-2perstage-multiproduct-inccosts-v0": "gym_supplychain_tpu.envs.presets:SupplyChainMultiProduct_IncreasingCosts",
    "sc-2perstage-multiproduct-v1": "gym_supplychain_tpu.envs.presets:SupplyChainMultiProduct_DemConfigByProd",
    "sc-2perstage-multiproduct-inccosts-v1": "gym_supplychain_tpu.envs.presets:SupplyChainMultiProduct_DemConfigByProd_IncCosts",
    # README-documented topology names (README.md:17-23), first-class here
    "supplychain-linear-v0": "gym_supplychain_tpu.envs.presets:SupplyChainLinearEnv",
    "supplychain-oneonen-v0": "gym_supplychain_tpu.envs.presets:SupplyChainOneOneNEnv",
    "supplychain-ntom-v0": "gym_supplychain_tpu.envs.presets:SupplyChainNtoMEnv",
    "supplychain-2perstage-v0": "gym_supplychain_tpu.envs.presets:SupplyChain2perStageEnv",
}


def registry():
    """All registered environment ids."""
    return tuple(_REGISTRY)


def make(env_id: str, **kwargs):
    """Instantiate a registered environment by id (gym.make equivalent)."""
    try:
        path = _REGISTRY[env_id]
    except KeyError:
        raise KeyError(f"Unknown env id {env_id!r}; known: {sorted(_REGISTRY)}")
    module, cls = path.split(":")
    import importlib
    return getattr(importlib.import_module(module), cls)(**kwargs)


__version__ = "0.1.0"
__all__ = [
    "make", "registry", "compile_chain", "CompiledChain", "DemandConfig",
    "EnvState", "StepOutput", "COST_KEYS", "make_supplychain_kernels",
    "BeerGameEnv", "BeerGameEnv2", "generate_demand",
    "SupplyChainEnv", "SupplyChain2perStageEnv", "SupplyChain2perStageSeasonalEnv",
    "SupplyChainMultiProduct", "SupplyChainMultiProduct_IncreasingCosts",
    "SupplyChainMultiProduct_DemConfigByProd",
    "SupplyChainMultiProduct_DemConfigByProd_IncCosts", "SupplyChainNPerStage",
    "SupplyChainLinearEnv", "SupplyChainOneOneNEnv", "SupplyChainNtoMEnv",
]
