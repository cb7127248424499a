"""The mesh half of the port's ``core/device.py`` and
``distributed/launch.py`` against the JAX package's: ``parse_mesh_shape``,
the mesh's axes and its device-count check, the data / replicated
specs, the ``PADDLE_*`` environment, and the rule that a ``{data: 1}``
mesh with no process group is the one-device program: a ``Trainer`` on
it (``--fsdp`` on or off) trains byte for byte as a plain one.  No
processes are started here (``tests/test_torch_launch.py`` starts
them)."""

import numpy as np
import pytest
import torch

from paddle_tpu.core import device as jdevice
from paddle_tpu.distributed import launch as jlaunch
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.distributed import launch as tlaunch
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.models import lstm_text_classifier
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.trainer.trainer import Trainer
from paddle_tpu_torch.utils import FLAGS, PaddleTpuError

from torch_dist_workers import to_feed


@pytest.mark.parametrize("spec", ["data=4", "data=4,model=2",
                                  " data = 2 , model=1 ,", "model=8"])
def test_parse_mesh_shape_matches_jax(spec):
    got = tdevice.parse_mesh_shape(spec)
    assert got == jdevice.parse_mesh_shape(spec)
    assert list(got) == list(jdevice.parse_mesh_shape(spec))


def test_bad_mesh_component_raises_in_both():
    with pytest.raises(PaddleTpuError, match="bad mesh_shape component"):
        tdevice.parse_mesh_shape("data4")
    with pytest.raises(Exception, match="bad mesh_shape component"):
        jdevice.parse_mesh_shape("data4")


def test_mesh_without_process_group():
    """No process group: the default mesh is ``{data: 1}`` with no
    ``DeviceMesh``; a mesh of more devices than processes fails the
    JAX package's check; ``--mesh_shape`` names the axes."""
    mesh = tdevice.build_mesh()
    assert mesh.shape == {"data": 1} and mesh.size == 1
    assert mesh.device_mesh is None and mesh.group("data") is None
    assert mesh.coordinate("data") == 0
    with pytest.raises(PaddleTpuError,
                       match=r"mesh \{'data': 2\} needs 2 devices, have 1"):
        tdevice.build_mesh({"data": 2})
    old = FLAGS.get("mesh_shape")
    try:
        FLAGS.set("mesh_shape", "data=1,model=1")
        assert tdevice.get_mesh(refresh=True).axis_names == ("data", "model")
    finally:
        FLAGS.set("mesh_shape", old)
        tdevice.set_mesh(None)
    assert tdevice.num_data_shards(mesh) == 1


def test_data_and_replicated_specs_match_jax():
    jmesh = jdevice.build_mesh({"data": 1})
    tmesh = tdevice.build_mesh({"data": 1})
    for rank in (1, 2, 4):
        assert tuple(tdevice.data_sharding(tmesh, rank).spec) == \
            tuple(jdevice.data_sharding(jmesh, rank).spec)
    assert tuple(tdevice.replicated(tmesh).spec) == \
        tuple(jdevice.replicated(jmesh).spec) == ()
    assert tdevice.DATA_AXIS == jdevice.DATA_AXIS
    assert tdevice.MODEL_AXIS == jdevice.MODEL_AXIS


def test_cluster_env_matches_jax(monkeypatch):
    for name in ("PADDLE_COORDINATOR", "PADDLE_NUM_NODES", "PADDLE_NODE_ID"):
        monkeypatch.delenv(name, raising=False)
    assert tlaunch.cluster_env() is None and jlaunch.cluster_env() is None
    assert tlaunch.initialize_cluster() is False
    monkeypatch.setenv("PADDLE_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("PADDLE_NUM_NODES", "2")
    monkeypatch.setenv("PADDLE_NODE_ID", "1")
    assert tlaunch.cluster_env() == jlaunch.cluster_env() == {
        "coordinator_address": "127.0.0.1:1", "num_processes": "2",
        "process_id": "1"}
    monkeypatch.delenv("PADDLE_NODE_ID")
    with pytest.raises(PaddleTpuError, match="PADDLE_NODE_ID"):
        tlaunch.initialize_cluster(device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, cluster has 1"):
        tlaunch.global_mesh({"data": 2})
    assert tlaunch.global_mesh({"data": 1}).shape == {"data": 1}


def test_launch_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        tlaunch.initialize_cluster("127.0.0.1:1", 1, 0)


def test_data1_mesh_trains_byte_identically_to_a_plain_trainer():
    """A ``{data: 1}`` mesh with no process group (and ``--fsdp`` on it)
    trains the LSTM classifier byte for byte as a plain ``Trainer``."""
    rng = np.random.RandomState(0)
    feeds = [{"data": ("seq", rng.randint(0, 50, (8, 6)).astype(np.int32),
                       rng.randint(1, 7, (8,)).astype(np.int32)),
              "label": rng.randint(0, 2, (8,)).astype(np.int32)}
             for _ in range(3)]
    cfg = lstm_text_classifier(50, 8, 16, 1, 2)
    opt = TOpt(learning_method="adam", learning_rate=1e-2,
               gradient_clipping_threshold=1.0)
    plain = Trainer(TNet(cfg), opt, seed=2, device="cpu")
    meshed = Trainer(TNet(cfg), opt, seed=2, device="cpu",
                     mesh=tdevice.build_mesh({"data": 1}))
    fsdp = Trainer(TNet(cfg), opt, seed=2, device="cpu",
                   mesh=tdevice.Mesh({"data": 1}), fsdp=True)
    for f in feeds:
        want = plain.train_one_batch(to_feed(f))
        assert torch.equal(meshed.train_one_batch(to_feed(f)), want)
        assert torch.equal(fsdp.train_one_batch(to_feed(f)), want)
    for name, p in plain.params.items():
        assert torch.equal(meshed.params[name], p), name
        assert torch.equal(fsdp.params[name], p), name
    for name, s in plain.opt_state[1].items():
        for a, b in zip(s, meshed.opt_state[1][name]):
            assert torch.equal(a, b), name
