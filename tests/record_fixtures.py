"""Record reference-trajectory parity fixtures (run once, needs the checkout).

Replays seeded episodes through the ACTUAL reference implementation at
/root/reference and commits per-step (action, observation, reward)
trajectories to compressed .npz fixtures, so the trajectory-parity layer runs
on any machine with no reference checkout — the portable analogue of the
reference's own committed RNG-stream oracles
(gym_supplychain/envs/tests/data/*.npy).

Usage: python tests/record_fixtures.py
Writes tests/data/ref_trajectories.npz and tests/data/ref_beergame.npz.
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REF = "/root/reference"


def _load_reference():
    sys.path.insert(0, os.path.join(HERE, ".."))
    from benchmarks.ref_baseline import _install_gym_shim
    _install_gym_shim()
    if REF not in sys.path:
        sys.path.insert(0, REF)
    import importlib
    return importlib.import_module("gym_supplychain.envs")


def record_supplychain(envs):
    from fixture_scenarios import SC_SCENARIOS
    out = {}
    for name, spec in SC_SCENARIOS.items():
        ref, _ours = spec["build"](envs)
        ref.seed(spec["seed"])
        for ep in range(spec["episodes"]):
            obs = [np.asarray(ref.reset(), np.float64)]
            acts, rews = [], []
            done = False
            while not done:
                a = ref.action_space.sample()
                acts.append(np.asarray(a, np.float32))
                o, r, done, _ = ref.step(a)
                obs.append(np.asarray(o, np.float64))
                rews.append(float(r))
            out[f"{name}/ep{ep}/actions"] = np.stack(acts)
            out[f"{name}/ep{ep}/obs"] = np.stack(obs)
            out[f"{name}/ep{ep}/rewards"] = np.asarray(rews, np.float64)
        print(f"recorded {name}: {spec['episodes']} episodes, "
              f"T={len(rews)}, A={acts[0].shape}, obs={obs[0].shape}")
    return out


def record_beergame(envs):
    from fixture_scenarios import beergame_scenarios
    out = {}
    for name, spec in beergame_scenarios().items():
        ref = getattr(envs, spec["cls"])(*spec["args"], **spec["kwargs"])
        for ep, actions in enumerate(spec["actions"]):
            obs = [np.asarray(ref.reset(), np.float64)]
            rews = []
            for a in actions:
                o, r, done, _ = ref.step(a)
                obs.append(np.asarray(o, np.float64))
                rews.append(float(r))
            out[f"{name}/ep{ep}/obs"] = np.stack(obs)
            out[f"{name}/ep{ep}/rewards"] = np.asarray(rews, np.float64)
            out[f"{name}/ep{ep}/inventory"] = np.asarray(ref.inventory)
            out[f"{name}/ep{ep}/backlog"] = np.asarray(ref.backlog)
            out[f"{name}/ep{ep}/customer_demand"] = np.asarray(
                ref.customer_demand)
            out[f"{name}/ep{ep}/shipment_delays"] = np.asarray(
                ref.shipment_delays)
        print(f"recorded beergame {name}: {len(spec['actions'])} episodes")
    return out


def main():
    assert os.path.isdir(REF), "needs the /root/reference checkout"
    sys.path.insert(0, HERE)
    envs = _load_reference()
    data_dir = os.path.join(HERE, "data")
    os.makedirs(data_dir, exist_ok=True)
    sc = record_supplychain(envs)
    np.savez_compressed(os.path.join(data_dir, "ref_trajectories.npz"), **sc)
    bg = record_beergame(envs)
    np.savez_compressed(os.path.join(data_dir, "ref_beergame.npz"), **bg)
    for f in ("ref_trajectories.npz", "ref_beergame.npz"):
        p = os.path.join(data_dir, f)
        print(f"{f}: {os.path.getsize(p) / 1024:.1f} KiB")


if __name__ == "__main__":
    main()
