"""Compiled collect kernels against the scan engine on the GPU, at the
benchmark's 4096 envs and full horizon (360 steps, 35 weeks).  Skips on the
CPU, where Pallas kernels run only in interpret mode (tests/test_pallas_*.py,
tests/test_collect_presets.py); chip_smoke.py runs the same comparisons.

    GST_TEST_GPU=1 python -m pytest tests/ -m gpu
"""
import pytest

import gym_supplychain_tpu as sct
from gym_supplychain_tpu.ops import reference as ref

B = 4096


@pytest.mark.gpu
@pytest.mark.parametrize("env_id", ["supplychain-linear-v0",
                                    "supplychain-ntom-v0",
                                    "supplychain-2perstage-v0"])
def test_supplychain_kernel_compiled(gpu, env_id):
    obs_err, rew_rel = ref.compare_supplychain(sct.make(env_id).cc, B)
    assert obs_err <= ref.OBS_ATOL and rew_rel <= ref.REWARD_RTOL, \
        (obs_err, rew_rel)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ref.BEERGAME_CONFIGS))
def test_beergame_kernel_compiled(gpu, name):
    assert ref.compare_beergame(name, B) == (0, 0)
