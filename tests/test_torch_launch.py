"""Multi-process launch of the port: processes started with the
``PADDLE_COORDINATOR`` / ``PADDLE_NUM_NODES`` / ``PADDLE_NODE_ID``
environment join one gloo process group on the CPU and train data
parallel, one process a device.

- ``test_cli_two_processes_train_the_config_data_parallel``: two
  ``python -m paddle_tpu_torch train --distributed`` processes on the
  tiny ``configs/rnn.py`` (global batch 8, 4 a rank) exit 0 and write
  one pass-00000 whose parameters are the one-process job's within atol
  1e-5 (the CLI test's Adam tolerance).
- ``test_two_process_global_mesh``: the JAX package's
  ``tests/test_launch.py`` case with two port processes — a global sum
  over the mesh, then a ``Trainer`` on it whose ``TRAIN_LOSS`` line is
  the same in both (slow, as the JAX test is).

Every process has a deadline and is killed at it.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from torch_dist_workers import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNN = os.path.join(REPO, "paddle_tpu_torch", "configs", "rnn.py")
TINY = "hidden_size=16,vocab_size=50,batch_size=8,num_samples=32"
DEADLINE_S = 120


def _env(port=None, rank=None, world=2):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    for name in ("PADDLE_COORDINATOR", "PADDLE_NUM_NODES", "PADDLE_NODE_ID"):
        env.pop(name, None)
    if port is not None:
        env.update(PADDLE_COORDINATOR=f"127.0.0.1:{port}",
                   PADDLE_NUM_NODES=str(world), PADDLE_NODE_ID=str(rank))
    return env


def _run_all(argvs, envs):
    procs = [subprocess.Popen(argv, env=env, cwd=REPO, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for argv, env in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def test_cli_two_processes_train_the_config_data_parallel(tmp_path):
    from paddle_tpu_torch.trainer.checkpoint import load_params
    port = free_port()
    cmd = [sys.executable, "-m", "paddle_tpu_torch", "train", "--config",
           RNN, "--config_args", TINY, "--device", "cpu", "--num_passes",
           "1"]
    rcs, outs = _run_all(
        [cmd + ["--distributed", "--save_dir", str(tmp_path / "dp")]] * 2
        + [cmd + ["--save_dir", str(tmp_path / "one")]],
        [_env(port, 0), _env(port, 1), _env()])
    assert rcs == [0, 0, 0], "\n".join(o[-2000:] for o in outs)
    assert "process 0/2" in outs[0] and "process 1/2" in outs[1]
    dp = load_params(str(tmp_path / "dp" / "pass-00000"))
    one = load_params(str(tmp_path / "one" / "pass-00000"))
    assert sorted(dp) == sorted(one)
    for k in one:
        np.testing.assert_allclose(dp[k], one[k], rtol=0, atol=1e-5,
                                   err_msg=k)


WORKER = textwrap.dedent("""
    import os
    import numpy as np
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed.launch import (initialize_cluster,
                                                     global_mesh)
    pid = int(os.environ["PADDLE_NODE_ID"])
    assert initialize_cluster(device="cpu")
    assert dist.get_world_size() == 2
    mesh = global_mesh({"data": 2})
    # global data-parallel sum: each process contributes its rows
    x = torch.arange(4, dtype=torch.float32) + 4 * pid
    total = x.sum()
    dist.all_reduce(total, group=mesh.group("data"))
    print("TOTAL", float(total))
    assert float(total) == sum(range(8)), float(total)

    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.config.dsl import config_scope
    from paddle_tpu_torch.data.feeder import dense_vector, integer_value
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.trainer.trainer import Trainer
    with config_scope():
        xl = dsl.data_layer("x", dense_vector(6))
        yl = dsl.data_layer("y", integer_value(3))
        pred = dsl.fc_layer(xl, size=3, act=dsl.SoftmaxActivation())
        cfg = dsl.topology(dsl.classification_cost(pred, yl))
    tr = Trainer(NeuralNetwork(cfg), mesh=mesh, seed=1, device="cpu")
    rng = np.random.RandomState(pid)          # per-process rows
    losses = []
    for _ in range(3):
        loss = tr.train_one_batch({
            "x": torch.from_numpy(rng.randn(8, 6).astype(np.float32)),
            "y": torch.from_numpy(rng.randint(0, 3, (8,)).astype(np.int32))})
        losses.append(float(loss))
    assert all(np.isfinite(l) for l in losses), losses
    print("TRAIN_LOSS", " ".join(f"{l:.6f}" for l in losses))
    print("LAUNCH_OK", pid)
""")


@pytest.mark.slow
def test_two_process_global_mesh():
    port = free_port()
    rcs, outs = _run_all([[sys.executable, "-c", WORKER]] * 2,
                         [_env(port, 0), _env(port, 1)])
    loss_lines = []
    for pid, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"worker {pid}:\n{out[-3000:]}"
        assert f"LAUNCH_OK {pid}" in out
        assert "TOTAL 28.0" in out
        loss_lines.append([l for l in out.splitlines()
                           if l.startswith("TRAIN_LOSS")][0])
    # the loss is the all-reduced global one: the same in both processes
    assert loss_lines[0] == loss_lines[1], loss_lines
