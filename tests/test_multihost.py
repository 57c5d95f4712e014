"""True multi-process distributed training test (SURVEY.md §7 M5).

Spawns TWO OS processes that form a jax.distributed CPU cluster (4 virtual
devices each = 8 global), jit the sharded PPO train step over the global
('data' x 'model') mesh, and train for 3 iterations.  Asserts both ranks
complete and report bitwise-identical replicated metrics — the same SPMD
program a multi-process GPU run executes, with Gloo standing in for NCCL.
"""
import os
import re
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.skipif(os.environ.get("GST_NO_SUBPROC") == "1",
                    reason="subprocess tests disabled")
def test_two_process_sharded_training():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen([sys.executable, _WORKER, str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for r in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-2000:]}"
        outs.append(out)
    losses = sorted(re.search(r"RANK(\d) loss=([-\d.e]+)", o).groups()
                    for o in outs)
    assert [r for r, _ in losses] == ["0", "1"]
    # replicated metrics must be bitwise identical across processes
    assert losses[0][1] == losses[1][1]


@pytest.mark.skipif(os.environ.get("GST_NO_SUBPROC") == "1",
                    reason="subprocess tests disabled")
def test_two_process_checkpoint_resume(tmp_path):
    """Multi-host checkpoint/resume (round-1 VERDICT item 3): a 2-process
    run saves its globally-sharded TrainState, restores it into a fresh
    template, and the resumed train iteration must be bitwise identical to
    the uninterrupted one on every shard of every leaf."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    ckdir = str(tmp_path / "mh_ckpt")
    procs = [subprocess.Popen(
                 [sys.executable, _WORKER, str(r), str(port), "ckpt", ckdir],
                 stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                 text=True, env=env)
             for r in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-2000:]}"
        outs.append(out)
    rows = sorted(
        re.search(r"RANK(\d) direct=([-\d.e]+) resumed=([-\d.e]+) "
                  r"equal=(\w+)", o).groups()
        for o in outs)
    assert [r[0] for r in rows] == ["0", "1"]
    for _, direct, resumed, equal in rows:
        assert equal == "True" and direct == resumed
    # both ranks saw the same replicated loss
    assert rows[0][1] == rows[1][1]


@pytest.mark.skipif(os.environ.get("GST_NO_SUBPROC") == "1",
                    reason="subprocess tests disabled")
def test_two_process_scaling_benchmark_smoke():
    """CI-sized run of the multi-host scaling benchmark (round-1 VERDICT
    item 2): the sharded PPO path must run at 2 processes on a small batch
    and report a sane positive throughput.  The committed full-size results
    (8192 envs) live in docs/PERFORMANCE.md."""
    bench = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                         "multihost_scaling.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run(
        [sys.executable, bench, "--envs", "256", "--iters", "2",
         "--procs", "2", "--devices-per-proc", "1"],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["processes"] == 2 and row["global_envs"] == 256
    assert row["train_env_steps_per_s"] > 100, row
