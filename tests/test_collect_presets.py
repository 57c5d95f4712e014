"""Collect kernels against the scan engine on every registered preset
(interpret mode on CPU, short horizons).  Each supply-chain id runs at a
batch that is a multiple of the lane tile and at one that needs padding."""
import pytest

import gym_supplychain_tpu as sct
from gym_supplychain_tpu.ops import reference as ref

TILE = 8
SUPPLYCHAIN_IDS = [e for e in sct.registry() if not e.startswith("beergame")]


def _chain(env_id, T):
    if env_id == "supplychain-v0":
        # the bare graph env takes its topology from the caller: a
        # two-product linear chain with stochastic lead-times
        from gym_supplychain_tpu.envs.presets import _linear_nodes
        return sct.make(env_id, nodes_info=_linear_nodes(num_products=2),
                        num_products=2, stochastic_leadtimes=True,
                        avg_leadtime=2, max_leadtime=3,
                        total_time_steps=T).cc
    return sct.make(env_id, total_time_steps=T).cc


def test_every_supplychain_preset_is_covered():
    assert len(SUPPLYCHAIN_IDS) == 12


@pytest.mark.parametrize("B", [2 * TILE, TILE + 3], ids=["tiled", "padded"])
@pytest.mark.parametrize("env_id", SUPPLYCHAIN_IDS)
def test_supplychain_kernel_matches_scan(env_id, B):
    cc = _chain(env_id, T=5)
    obs_err, rew_rel = ref.compare_supplychain(cc, B, seed=3,
                                               batch_tile=TILE,
                                               interpret=True)
    assert obs_err <= ref.OBS_ATOL, obs_err
    assert rew_rel <= ref.REWARD_RTOL, rew_rel


@pytest.mark.parametrize("name", sorted(ref.BEERGAME_CONFIGS))
def test_beergame_kernel_matches_scan_padded(name):
    assert ref.compare_beergame(name, TILE + 3, seed=1, episodes=2,
                                batch_tile=TILE, interpret=True) == (0, 0)
