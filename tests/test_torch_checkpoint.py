"""The port's checkpoints (``trainer/checkpoint.py``, ``Trainer.save`` /
``load`` / ``resume``), model-file interop (``trainer/interop.py``) and
torch weight import (``utils/torch_interop.py``) against the JAX
package's, on the CPU.

The nets come from the JAX DSL and reach the port through
``ModelConfig.from_json``: an fc classifier (x 16 -> fc 32 relu -> fc 4
softmax) and a conv + batch-norm net (3x8x8 -> 3x3 conv 8 -> BN -> fc 4)
for the buffers.  A checkpoint one package writes is loaded by the
other: the state must come back bit for bit, and a load followed by a
save must write files whose SHA-256 digests (and manifests) equal the
source's.  After a load both packages take the same steps: losses
within rtol 1e-5 and parameters within atol 1e-5, the Adam trajectory
tolerance of ``tests/test_torch_train.py``.  The integrity cases are
``tests/test_chaos.py``'s (truncate, bit flip, a transient read fault,
all corrupt, ``--ckpt_verify=false``, retention) run on the port's
module, with the damage made by the JAX package's
``testing.fault.corrupt_checkpoint``.
"""

import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl
from paddle_tpu.config.dsl import config_scope
from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.data import feeder as jfeed
from paddle_tpu.data.feeder import dense_vector, integer_value
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.models import image as jimage
from paddle_tpu.testing import fault
from paddle_tpu.trainer import checkpoint as jck
from paddle_tpu.trainer import interop as jinterop
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu.utils import torch_interop as jti
from paddle_tpu_torch.config.model_config import ModelConfig as TModelConfig
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.core.sequence import value_of
from paddle_tpu_torch.data import feeder as tfeed
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.ops.nn_ops import conv2d as t_conv2d
from paddle_tpu_torch.trainer import checkpoint as tck
from paddle_tpu_torch.trainer import interop as tinterop
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from paddle_tpu_torch.utils import FLAGS as TFLAGS
from paddle_tpu_torch.utils import PaddleTpuError
from paddle_tpu_torch.utils import torch_interop as tti

B = 8
OPTS = {"sgd": dict(learning_method="sgd", learning_rate=0.1),
        "adam": dict(learning_method="adam", learning_rate=2e-3,
                     l2_weight_decay=8e-4, gradient_clipping_threshold=25.0),
        # sgd with a momentum is the momentum rule, in both packages
        "momentum": dict(learning_method="sgd", momentum=0.9,
                         learning_rate=0.05, l2_weight_decay=1e-4),
        "adagrad": dict(learning_method="adagrad", learning_rate=0.05),
        "adadelta": dict(learning_method="adadelta", learning_rate=1.0,
                         ada_rou=0.9),
        "rmsprop": dict(learning_method="rmsprop", learning_rate=1e-3),
        "decayed_adagrad": dict(learning_method="decayed_adagrad",
                                learning_rate=1e-3),
        "adamax": dict(learning_method="adamax", learning_rate=2e-3),
        "proximal_gd": dict(learning_method="proximal_gd",
                            learning_rate=0.1, l1_weight_decay=1e-3),
        "proximal_adagrad": dict(learning_method="proximal_adagrad",
                                 learning_rate=0.05)}
# slots a parameter: the structure JAX prints as the optimizer state's
SLOTS = {"sgd": "()", "proximal_gd": "()", "momentum": "(*,)",
         "adagrad": "(*,)", "decayed_adagrad": "(*,)",
         "proximal_adagrad": "(*,)", "adam": "(*, *)", "adamax": "(*, *)",
         "adadelta": "(*, *)", "rmsprop": "(*, *)"}
FLAG_NAMES = ("save_dir", "saving_period", "start_pass", "init_model_path",
              "ckpt_keep", "ckpt_verify", "ckpt_export_lease_s",
              "load_missing_parameter_strategy", "log_period",
              "prefetch_depth", "precision", "loss_scale_init",
              "loss_scale_growth_interval", "conv_bn_fuse",
              "conv_bn_fuse_fwd")


@pytest.fixture(autouse=True)
def _restore_flags():
    old_j = {k: getattr(JFLAGS, k) for k in FLAG_NAMES}
    old_t = {k: TFLAGS.get(k) for k in FLAG_NAMES}
    _set_both(prefetch_depth=0, save_dir="", log_period=1)
    yield
    for k in FLAG_NAMES:
        JFLAGS.set(k, old_j[k])
        TFLAGS.set(k, old_t[k])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _set_both(**kw):
    for k, v in kw.items():
        JFLAGS.set(k, v)
        TFLAGS.set(k, v)


# ------------------------------------------------------------ the nets
def _fc_cfgs():
    with config_scope():
        x = dsl.data_layer("x", dense_vector(16))
        y = dsl.data_layer("label", integer_value(4))
        hid = dsl.fc_layer(x, size=32, act=dsl.ReluActivation())
        pred = dsl.fc_layer(hid, size=4, act=dsl.SoftmaxActivation())
        jcfg = dsl.topology(dsl.classification_cost(pred, y))
    return jcfg, TModelConfig.from_json(jcfg.to_json())


def _bn_cfgs():
    with config_scope():
        img = dsl.data("image", dense_vector(3 * 8 * 8), height=8, width=8)
        lab = dsl.data("label", integer_value(4))
        net = jimage._bn_conv(img, 3, 8, 1, 1, channels=3)
        pred = dsl.fc(net, size=4, act=dsl.SoftmaxActivation())
        jcfg = dsl.topology(dsl.classification_cost(pred, lab))
    return jcfg, TModelConfig.from_json(jcfg.to_json())


def _feed(rng, width=16, key="x"):
    x = rng.randn(B, width).astype(np.float32)
    y = rng.randint(0, 4, (B,)).astype(np.int32)
    return ({key: jnp.asarray(x), "label": jnp.asarray(y)},
            {key: torch.from_numpy(x), "label": torch.from_numpy(y)})


def _trainers(cfgs, method, precision="", jseed=0, tseed=5):
    jcfg, tcfg = cfgs
    jtr = JTrainer(JNet(jcfg), opt_config=JOpt(**OPTS[method],
                                               precision=precision),
                   seed=jseed)
    ttr = TTrainer(TNet(tcfg), TOpt(**OPTS[method], precision=precision),
                   seed=tseed, device="cpu")
    return jtr, ttr


def _digests(ckpt):
    return {f: v["sha256"] for f, v in
            tck.load_manifest(ckpt)["files"].items()}


def _assert_same_state(jtr, ttr):
    """Parameters, buffers, optimizer-state leaves and samples_seen bit
    for bit, in the same order."""
    assert list(ttr.params) == list(jtr.params)
    for n, p in jtr.params.items():
        np.testing.assert_array_equal(ttr.params[n].numpy(), np.asarray(p),
                                      err_msg=n)
    assert list(ttr.buffers) == list(jtr.buffers)
    for n, b in jtr.buffers.items():
        np.testing.assert_array_equal(ttr.buffers[n].numpy(),
                                      np.asarray(b), err_msg=n)
    want = jax.tree_util.tree_leaves(jtr.opt_state)
    got, _ = tck.flatten_opt_state(ttr.opt_state)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.numpy().dtype == np.asarray(w).dtype, i
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"leaf {i}")
    assert ttr.samples_seen == jtr.samples_seen


def _assert_close_params(jtr, ttr):
    for n, p in jtr.params.items():
        np.testing.assert_allclose(ttr.params[n].numpy(), np.asarray(p),
                                   rtol=0, atol=1e-5, err_msg=n)


# --------------------------------------------------- the config and flags
def test_model_config_from_json_round_trips_and_refuses_projections():
    from paddle_tpu.config.model_config import (LayerConfig, LayerInput,
                                                ModelConfig, ProjConfig)
    from paddle_tpu.models import lstm_text_classifier
    for jcfg in (_fc_cfgs()[0], _bn_cfgs()[0],
                 lstm_text_classifier(50, 8, 16, 2, 2)):
        text = jcfg.to_json()
        assert TModelConfig.from_json(text).to_json() == text
    # a projection round-trips since the config front end came (its
    # mixed layer is refused when NeuralNetwork builds it, not here)
    proj = ModelConfig(layers=[LayerConfig(
        name="m", type="mixed", size=4,
        inputs=[LayerInput(input_layer_name="x", proj=ProjConfig(
            type="slice", input_size=8, slices=[(0, 2), (4, 6)]))])])
    text = proj.to_json()
    back = TModelConfig.from_json(text)
    assert back.to_json() == text
    assert type(back.layers[0].inputs[0].proj).__name__ == "ProjConfig"
    assert back.layers[0].inputs[0].proj.resolved_output_size() == 4


def test_checkpoint_flags_are_the_reference_flags():
    for name in ("init_model_path", "load_missing_parameter_strategy",
                 "ckpt_keep", "ckpt_verify", "ckpt_export_lease_s",
                 "save_dir", "saving_period", "start_pass"):
        spec = JFLAGS._specs[name]
        assert TFLAGS.specs[name] == (spec.default, spec.help), name


# ------------------------------------------------ across the packages
@pytest.mark.parametrize("method, precision", [
    *((m, "fp32") for m in sorted(OPTS)), ("adam", "bf16"),
    ("momentum", "bf16")])
def test_checkpoint_crosses_packages_with_equal_digests(tmp_path, method,
                                                        precision):
    """JAX save -> port load (state bit for bit) -> port save (equal
    digests and manifest); one more step on each side; port save -> JAX
    load -> JAX save (equal digests).  Under bf16 the step is held to
    ``tests/test_torch_precision.py``'s trajectory tolerance (loss rtol
    5e-3, parameters 1e-3 + 2e-2 * max|ref|)."""
    cfgs = _fc_cfgs()
    jtr, ttr = _trainers(cfgs, method, precision)
    rng = np.random.RandomState(1)
    f1, f2 = _feed(rng), _feed(rng)
    jtr.train_one_batch(f1[0])
    a = jtr.save(str(tmp_path / "jax"), 0)
    ttr.load(a)
    _assert_same_state(jtr, ttr)
    b = ttr.save(str(tmp_path / "port"), 0)
    assert _digests(b) == _digests(a)
    assert tck.load_manifest(b) == tck.load_manifest(a)
    assert tck.load_manifest(b)["opt_treedef"] == \
        "PyTreeDef((*, [" + ", ".join([SLOTS[method]] * 4) + "]))"

    want = float(jtr.train_one_batch(f2[0]))
    got = float(ttr.train_one_batch(f2[1]))
    if precision == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5)
        _assert_close_params(jtr, ttr)
    else:
        np.testing.assert_allclose(got, want, rtol=5e-3)
        for n, p in jtr.params.items():
            p = np.asarray(p)
            np.testing.assert_allclose(
                ttr.params[n].numpy(), p, rtol=0,
                atol=1e-3 + 2e-2 * float(np.abs(p).max()), err_msg=n)

    c = ttr.save(str(tmp_path / "port"), 1)
    jtr2 = JTrainer(JNet(cfgs[0]), opt_config=JOpt(**OPTS[method],
                                                   precision=precision),
                    seed=3)
    jtr2.load(c)
    _assert_same_state(jtr2, ttr)
    d = jtr2.save(str(tmp_path / "jax2"), 1)
    assert _digests(d) == _digests(c)
    assert tck.load_manifest(d) == dict(tck.load_manifest(c), pass_id=1)


def test_bn_buffers_cross_packages(tmp_path):
    """A batch-norm net's running statistics: saved after a step by one
    package, loaded and saved by the other with equal digests, and the
    next step's loss and new buffers agree."""
    _set_both(conv_bn_fuse=False, conv_bn_fuse_fwd=False)
    cfgs = _bn_cfgs()
    jtr, ttr = _trainers(cfgs, "adam")
    assert sorted(ttr.buffers) == sorted(jtr.buffers) and ttr.buffers
    rng = np.random.RandomState(2)
    f1, f2 = _feed(rng, 192, "image"), _feed(rng, 192, "image")
    jtr.train_one_batch(f1[0])
    a = jtr.save(str(tmp_path / "jax"), 0)
    assert "buffers.npz" in _digests(a)
    ttr.load(a)
    _assert_same_state(jtr, ttr)
    assert _digests(ttr.save(str(tmp_path / "port"), 0)) == _digests(a)
    want = float(jtr.train_one_batch(f2[0]))
    got = float(ttr.train_one_batch(f2[1]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert list(ttr.buffers) == list(jtr.buffers)
    for n, v in jtr.buffers.items():
        np.testing.assert_allclose(ttr.buffers[n].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    c = ttr.save(str(tmp_path / "port"), 1)
    jtr2 = JTrainer(JNet(cfgs[0]), opt_config=JOpt(**OPTS["adam"]), seed=4)
    jtr2.load(c)
    _assert_same_state(jtr2, ttr)
    assert _digests(jtr2.save(str(tmp_path / "jax2"), 1)) == _digests(c)


def _fc_samples(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(16).astype(np.float32), int(rng.randint(0, 4)))
            for _ in range(n)]


def _reader(samples):
    def batches():
        for i in range(0, len(samples) - B + 1, B):
            yield samples[i:i + B]
    return batches


def _feeders():
    return (jfeed.DataFeeder([("x", jfeed.dense_vector(16)),
                              ("label", jfeed.integer_value(4))]),
            tfeed.DataFeeder([("x", tfeed.dense_vector(16)),
                              ("label", tfeed.integer_value(4))]))


def _record(events):
    def handle(e):
        payload = getattr(e, "cost", None) if type(e).__name__ == \
            "EndIteration" else dict(getattr(e, "metrics", {}))
        events.append((type(e).__name__, e.pass_id,
                       getattr(e, "batch_id", None), payload))
    return handle


def _assert_events_close(got, want):
    assert [e[:3] for e in got] == [e[:3] for e in want]
    for (kind, p, b, g), (_, _, _, w) in zip(got, want):
        if kind == "EndIteration":
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       err_msg=f"cost of {p}/{b}")
        elif kind == "EndPass":
            np.testing.assert_allclose(g["cost"], w["cost"], rtol=1e-5)


def _from_pass(events, pass_id):
    return [e for e in events if e[1] >= pass_id]


@pytest.mark.parametrize("method", ["adam", "momentum"])
def test_resume_at_start_pass_matches_the_uninterrupted_run(tmp_path,
                                                            method):
    """Each package resumes the other's ``pass-00000`` through
    ``--init_model_path`` at ``--start_pass=1`` and trains passes 1 and
    2: the events, costs, parameters and saved ``samples_seen`` match
    the other package's uninterrupted three-pass run."""
    cfgs = _fc_cfgs()
    reader = _reader(_fc_samples(4 * B, 7))
    jf, tf = _feeders()
    runs = {}
    for side in ("jax", "port"):
        _set_both(save_dir=str(tmp_path / f"{side}_full"), start_pass=0)
        jtr, ttr = _trainers(cfgs, method)
        tr, f = (jtr, jf) if side == "jax" else (ttr, tf)
        events = []
        tr.train(reader, 3, _record(events), f)
        runs[side] = (tr, events)
    for side, other in (("port", "jax"), ("jax", "port")):
        src = str(tmp_path / f"{other}_full" / "pass-00000")
        _set_both(init_model_path=src, start_pass=1,
                  save_dir=str(tmp_path / f"{side}_resumed"))
        jtr, ttr = _trainers(cfgs, method, jseed=9, tseed=9)
        _set_both(init_model_path="")
        tr, f = (jtr, jf) if side == "jax" else (ttr, tf)
        assert tr.samples_seen == 4 * B
        events = []
        tr.train(reader, 2, _record(events), f)
        full, full_events = runs[other]
        _assert_events_close(events, _from_pass(full_events, 1))
        assert tr.samples_seen == full.samples_seen == 3 * 4 * B
        jt, tt = (tr, full) if side == "jax" else (full, tr)
        _assert_close_params(jt, tt)
        saved = sorted(os.listdir(tmp_path / f"{side}_resumed"))
        assert saved == ["pass-00001", "pass-00002"]
        for p in saved:
            assert tck.load_manifest(str(
                tmp_path / f"{side}_resumed" / p))["samples_seen"] == \
                tck.load_manifest(str(
                    tmp_path / f"{other}_full" / p))["samples_seen"]


def test_bf16_loss_scale_state_crosses_packages(tmp_path):
    """``--precision=bf16``: the loss scale after a skipped step travels
    in the manifest both ways (template:
    ``tests/test_precision.py::test_loss_scale_persists_through_checkpoint``)."""
    _set_both(loss_scale_init=256.0)
    cfgs = _fc_cfgs()
    jtr, ttr = _trainers(cfgs, "adam", precision="bf16")
    rng = np.random.RandomState(4)
    jtr.train_one_batch(_feed(rng)[0])
    bad = {"x": jnp.full((B, 16), np.inf, jnp.float32),
           "label": jnp.zeros((B,), jnp.int32)}
    jtr.train_one_batch(bad)                         # scale -> 128
    a = jtr.save(str(tmp_path / "jax"), 0)
    ttr.load(a)
    assert float(ttr._ls_state.scale) == 128.0
    assert int(ttr._ls_state.skipped_total) == 1
    assert int(ttr._ls_state.growth_count) == 0
    _assert_same_state(jtr, ttr)
    b = ttr.save(str(tmp_path / "port"), 0)
    assert tck.load_manifest(b)["loss_scale"] == \
        tck.load_manifest(a)["loss_scale"] == {
            "scale": 128.0, "growth_count": 0, "skipped_total": 1}
    assert _digests(b) == _digests(a)
    ttr.train_one_batch({"x": torch.full((B, 16), float("inf")),
                         "label": torch.zeros(B, dtype=torch.int32)})
    c = ttr.save(str(tmp_path / "port"), 1)
    jtr2 = JTrainer(JNet(cfgs[0]), opt_config=JOpt(**OPTS["adam"],
                                                   precision="bf16"))
    jtr2.load(c)
    assert float(jtr2._ls_state.scale) == 64.0
    assert int(jtr2._ls_state.skipped_total) == 2


def test_sharded_jax_checkpoint_loads_in_the_port(tmp_path):
    """A JAX ``shard=True`` checkpoint (leaves split over an 8-device
    mesh, the ``--fsdp`` layout; template ``tests/test_fsdp.py``) loads
    into the port's one-device trainer; the port refuses to write one."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P
    jtr, ttr = _trainers(_fc_cfgs(), "adam")
    jtr.train_one_batch(_feed(np.random.RandomState(5))[0])
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))

    def place(x):
        spec = P("data") if np.ndim(x) and np.shape(x)[0] % 8 == 0 else P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    d = jck.save_checkpoint(
        str(tmp_path / "jax"), 0, {n: place(v) for n, v in
                                   jtr.params.items()},
        jax.tree_util.tree_map(place, jtr.opt_state), jtr.buffers,
        meta={"samples_seen": jtr.samples_seen}, shard=True)
    man = tck.load_manifest(d)
    assert man["shards"]["params"] and man["shards"]["opt_state"]
    assert any(f.startswith("params.shard-") for f in man["files"])
    assert tck.verify_checkpoint(d)
    ttr.load(d)
    _assert_same_state(jtr, ttr)
    # one process holds nothing sharded: a sharded save writes the base
    # archives alone, as the JAX package's does with no sharded leaf
    # (tests/test_torch_fsdp.py writes them from two ranks)
    d2 = tck.save_checkpoint(str(tmp_path / "port"), 0, ttr.params,
                             ttr.opt_state, shard=True)
    assert "shards" not in tck.load_manifest(d2)
    assert not any(f.startswith("params.shard-")
                   for f in os.listdir(d2))
    back = jck.load_params(d2)
    for n, v in ttr.params.items():
        np.testing.assert_array_equal(back[n], v.numpy())


def test_load_missing_parameter_strategy_matches_jax(tmp_path):
    jtr, ttr = _trainers(_fc_cfgs(), "adam")
    names = sorted(jtr.params)
    d = jck.save_checkpoint(str(tmp_path), 0, {
        n: v for n, v in jtr.params.items() if n != names[0]})
    for tr in (jtr, ttr):
        with pytest.raises(KeyError, match=names[0]):
            tr.load(d)
    _set_both(load_missing_parameter_strategy="zero")
    kept = ttr.params[names[0]].clone()
    ttr.load(d)
    torch.testing.assert_close(ttr.params[names[0]], kept, rtol=0, atol=0)
    for n in names[1:]:
        np.testing.assert_array_equal(ttr.params[n].numpy(),
                                      np.asarray(jtr.params[n]))


def test_init_model_path_loads_before_the_first_step(tmp_path):
    jtr, _ = _trainers(_fc_cfgs(), "sgd")
    d = jtr.save(str(tmp_path), 0)
    _set_both(init_model_path=d)
    _, ttr = _trainers(_fc_cfgs(), "sgd", tseed=11)
    _assert_same_state(jtr, ttr)


# ------------------------------------------------------ integrity
def _tiny(seed=0):
    ttr = TTrainer(TNet(_fc_cfgs()[1]), TOpt(**OPTS["adam"]), seed=seed,
                   device="cpu")
    return ttr, _feed(np.random.RandomState(seed))[1]


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_resume_falls_back_past_a_corrupt_checkpoint(tmp_path, mode):
    save_dir = str(tmp_path / "ckpt")
    tr, feed = _tiny()
    tr.train_one_batch(feed)
    tr.save(save_dir, 0)
    tr.train_one_batch(feed)
    tr.save(save_dir, 1)
    fault.corrupt_checkpoint(os.path.join(save_dir, "pass-00001"),
                             mode=mode)
    assert tck.verify_checkpoint(os.path.join(save_dir,
                                              "pass-00001")) is False
    tr2, _ = _tiny(seed=99)
    assert tr2.resume(save_dir) is True
    assert tr2.samples_seen == tck.load_manifest(
        os.path.join(save_dir, "pass-00000"))["samples_seen"] == B
    dirs = sorted(os.listdir(save_dir))
    assert ".corrupt-pass-00001" in dirs and "pass-00001" not in dirs


def test_transient_read_fault_does_not_quarantine(tmp_path, monkeypatch):
    save_dir = str(tmp_path / "ckpt")
    tr, feed = _tiny()
    tr.train_one_batch(feed)
    tr.save(save_dir, 0)

    def flaky_sha(path):
        raise OSError(5, "injected EIO")

    monkeypatch.setattr(tck, "_sha256_file", flaky_sha)
    assert tck.latest_valid_checkpoint(save_dir) is None
    assert sorted(os.listdir(save_dir)) == ["pass-00000"]
    monkeypatch.undo()
    assert tck.latest_valid_checkpoint(save_dir).endswith("pass-00000")


def test_resume_all_corrupt_returns_false(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    tr, feed = _tiny()
    tr.train_one_batch(feed)
    tr.save(save_dir, 0)
    fault.corrupt_checkpoint(os.path.join(save_dir, "pass-00000"))
    tr2, _ = _tiny(seed=99)
    assert tr2.resume(save_dir) is False
    assert tck.latest_valid_checkpoint(save_dir) is None
    assert tr2.resume(str(tmp_path / "nothing")) is False


def test_ckpt_verify_kill_switch_restores_the_blind_crash(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    tr, feed = _tiny()
    tr.train_one_batch(feed)
    tr.save(save_dir, 0)
    tr.save(save_dir, 1)
    fault.corrupt_checkpoint(os.path.join(save_dir, "pass-00001"),
                             mode="bitflip")
    tr2, _ = _tiny(seed=99)
    with pytest.raises(PaddleTpuError, match="integrity"):
        tr2.load(os.path.join(save_dir, "pass-00001"))
    TFLAGS.set("ckpt_verify", False)
    with pytest.raises(Exception):          # zip CRC / parse error
        tr2.resume(save_dir)
    assert tck.latest_checkpoint(save_dir).endswith("pass-00001")
    # without digests a save records no files and verifies structurally
    d = tr.save(str(tmp_path / "blind"), 0)
    assert "files" not in tck.load_manifest(d)
    assert tck.checkpoint_digest(d) is None and tck.verify_checkpoint(d)


def test_checkpoint_retention_sweep(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    tr, feed = _tiny()
    tr.train_one_batch(feed)
    TFLAGS.set("ckpt_keep", 3)
    for p in range(6):
        tr.save(save_dir, p)
    dirs = sorted(d for d in os.listdir(save_dir) if d.startswith("pass-"))
    assert dirs == ["pass-00003", "pass-00004", "pass-00005"]
    TFLAGS.set("ckpt_keep", 0)
    assert tck.sweep_retention(save_dir) == []
    # equal bytes under another pass id: the same content digest
    assert tck.checkpoint_digest(os.path.join(save_dir, "pass-00003")) == \
        tck.checkpoint_digest(os.path.join(save_dir, "pass-00005")) == \
        jck.checkpoint_digest(os.path.join(save_dir, "pass-00005"))


def test_retention_never_sweeps_the_only_valid_checkpoint(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    tr, feed = _tiny()
    tr.train_one_batch(feed)
    tr.save(save_dir, 0)
    tr.save(save_dir, 1)
    fault.corrupt_checkpoint(os.path.join(save_dir, "pass-00001"))
    assert tck.latest_valid_checkpoint(save_dir).endswith("pass-00000")
    tck.sweep_retention(save_dir, keep=1)
    left = sorted(os.listdir(save_dir))
    assert "pass-00000" in left and ".corrupt-pass-00001" in left
    for p in (2, 3, 4):
        tr.save(save_dir, p)
        fault.corrupt_checkpoint(os.path.join(save_dir, f"pass-{p:05d}"))
        assert tck.latest_valid_checkpoint(save_dir)
    tck.sweep_retention(save_dir, keep=1)
    assert len([d for d in os.listdir(save_dir)
                if d.startswith(".corrupt-")]) == 1


def test_export_lease_pins_a_dir_against_retention(tmp_path):
    save_dir = str(tmp_path / "ckpt")
    tr, _ = _tiny()
    first = tr.save(save_dir, 0)
    TFLAGS.set("ckpt_keep", 1)
    with tck.export_lease(first) as marker:
        assert tck.export_pinned(first) and jck.export_pinned(first)
        tr.save(save_dir, 1)
        tr.save(save_dir, 2)
        assert sorted(os.listdir(save_dir)) == ["pass-00000", "pass-00002"]
    assert not os.path.exists(marker) and not tck.export_pinned(first)
    tck.sweep_retention(save_dir)
    assert sorted(os.listdir(save_dir)) == ["pass-00002"]
    # a killed exporter's marker goes stale after --ckpt_export_lease_s
    last = os.path.join(save_dir, "pass-00002")
    stale = os.path.join(last, ".exporting-1")
    open(stale, "w").close()
    assert tck.export_pinned(last)
    TFLAGS.set("ckpt_export_lease_s", 60.0)
    os.utime(stale, (0, 0))
    assert not tck.export_pinned(last)


def test_save_failure_raises_and_leaves_no_dir(tmp_path, monkeypatch):
    tr, _ = _tiny()

    def full_disk(*a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(tck.np, "savez", full_disk)
    with pytest.raises(OSError, match="No space"):
        tr.save(str(tmp_path), 0)
    assert os.listdir(tmp_path) == []


# ------------------------------------------------------ interop
def test_parameter_stream_bytes_match_jax(tmp_path):
    v = np.array([[1.5, -2.0], [0.25, 3.0]], np.float32)
    tinterop.save_parameter_file(str(tmp_path / "t"), torch.from_numpy(v))
    jinterop.save_parameter_file(str(tmp_path / "j"), v)
    raw = (tmp_path / "t").read_bytes()
    assert raw == (tmp_path / "j").read_bytes()
    assert struct.unpack("<iIQ", raw[:16]) == (0, 4, 4)
    np.testing.assert_array_equal(
        tinterop.load_parameter_file(str(tmp_path / "j"), [2, 2]), v)
    with open(tmp_path / "bad", "wb") as f:
        f.write(struct.pack("<iIQ", 1, 4, 2))
        f.write(np.zeros(2, np.float32).tobytes())
    with pytest.raises(PaddleTpuError, match="unsupported parameter format"):
        tinterop.load_parameter_file(str(tmp_path / "bad"))
    with open(tmp_path / "short", "wb") as f:
        f.write(struct.pack("<iIQ", 0, 4, 9))
    with pytest.raises(PaddleTpuError, match="truncated"):
        tinterop.load_parameter_file(str(tmp_path / "short"))


def test_reference_model_dir_round_trip_across_packages(tmp_path):
    jcfg, tcfg = _fc_cfgs()
    jcfg = jinterop.with_full_param_specs(jcfg)
    tcfg = tinterop.with_full_param_specs(tcfg)
    assert tcfg.to_json() == jcfg.to_json()
    rng = np.random.RandomState(1)
    params = {p.name: rng.randn(*p.dims).astype(np.float32)
              for p in tcfg.parameters}
    jinterop.save_reference_model_dir(str(tmp_path / "j"), params)
    tinterop.save_reference_model_dir(str(tmp_path / "t"), params)
    for name in params:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    got = tinterop.load_reference_model_dir(str(tmp_path / "j"), tcfg,
                                            strict=True)
    for name, v in params.items():
        np.testing.assert_array_equal(got[name], v)
    os.remove(tmp_path / "j" / tcfg.parameters[0].name)
    with pytest.raises(PaddleTpuError, match="missing parameter file"):
        tinterop.load_reference_model_dir(str(tmp_path / "j"), tcfg,
                                          strict=True)
    assert tcfg.parameters[0].name not in tinterop.load_reference_model_dir(
        str(tmp_path / "j"), tcfg)


def test_merge_model_files_are_byte_equal_between_packages(tmp_path):
    jcfg, tcfg = _fc_cfgs()
    jcfg = jinterop.with_full_param_specs(jcfg)
    tcfg = tinterop.with_full_param_specs(tcfg)
    jtr = JTrainer(JNet(jcfg), seed=0)
    params = {n: np.array(v) for n, v in jtr.params.items()}
    jinterop.merge_model(jcfg, params, str(tmp_path / "j.paddle"))
    tinterop.merge_model(tcfg, {n: torch.from_numpy(v)
                                for n, v in params.items()},
                         str(tmp_path / "t.paddle"))
    assert (tmp_path / "t.paddle").read_bytes() == \
        (tmp_path / "j.paddle").read_bytes()
    model, got = tinterop.load_merged_model(str(tmp_path / "j.paddle"))
    assert model.to_json() == jcfg.to_json()
    for n, v in params.items():
        np.testing.assert_array_equal(got[n], v)
        assert got[n].shape == v.shape
    # the merged model drives the port's net: the JAX net's outputs
    x = np.random.RandomState(2).randn(4, 16).astype(np.float32)
    y = np.zeros(4, np.int32)
    tnet = TNet(model)
    out, _ = tnet.forward({n: torch.from_numpy(v) for n, v in got.items()},
                          {"x": torch.from_numpy(x),
                           "label": torch.from_numpy(y)}, is_training=False)
    jout, _ = jtr.network.forward(jtr.params, {"x": jnp.asarray(x),
                                               "label": jnp.asarray(y)},
                                  {}, is_training=False)
    name = model.layers[2].name
    np.testing.assert_allclose(value_of(out[name]).numpy(),
                               np.asarray(jout[name]), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(PaddleTpuError, match="not loaded"):
        tinterop.merge_model(tcfg, {}, str(tmp_path / "x.paddle"))
    (tmp_path / "bad.paddle").write_bytes(
        struct.pack("<q", 4) + b"XXXX")
    with pytest.raises(PaddleTpuError, match="not a paddle-tpu merged"):
        tinterop.load_merged_model(str(tmp_path / "bad.paddle"))


def test_checkpoint_to_params_reads_a_jax_checkpoint(tmp_path):
    jtr, _ = _trainers(_fc_cfgs(), "sgd")
    d = jtr.save(str(tmp_path), 0)
    got = tinterop.checkpoint_to_params(d)
    assert list(got) == list(jtr.params)
    for n, v in jtr.params.items():
        np.testing.assert_array_equal(got[n], np.asarray(v))
    assert tinterop.checkpoint_to_params(str(tmp_path / "none")) == {}


def test_torch_linear_import_matches_forward():
    """A torch MLP's weights through ``import_torch_model``: the port's
    fc layers give its logits (template: ``tests/test_tools.py``)."""
    torch.manual_seed(0)
    tm = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.ReLU(),
                             torch.nn.Linear(5, 3))
    with config_scope():
        x = dsl.data_layer("x", dense_vector(6))
        h = dsl.fc_layer(x, size=5, act=dsl.ReluActivation(), name="h")
        out = dsl.fc_layer(h, size=3, act=dsl.LinearActivation(),
                           name="out")
        cfg = TModelConfig.from_json(dsl.topology(out).to_json())
    net = TNet(cfg)
    params = net.init_params(device="cpu")
    names = {"0.weight": "_h.w0", "0.bias": "_h.wbias",
             "2.weight": "_out.w0", "2.bias": "_out.wbias"}
    imported = tti.import_torch_model(tm, names)
    want_j = jti.import_torch_model(tm, names)
    for k, v in imported.items():
        assert tuple(v.shape) == tuple(params[k].shape), k
        np.testing.assert_array_equal(v, want_j[k])
        params[k] = torch.from_numpy(v)
    xb = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    want = tm(torch.from_numpy(xb)).detach().numpy()
    got, _ = net.forward(params, {"x": torch.from_numpy(xb)},
                         is_training=False)
    np.testing.assert_allclose(value_of(got["out"]).detach().numpy(), want,
                               atol=1e-5)
    with pytest.raises(KeyError, match="lacks"):
        tti.torch_state_dict_to_params(tm.state_dict(), {"9.weight": "w"})


def test_torch_conv_import_matches_the_port_conv():
    torch.manual_seed(1)
    conv = torch.nn.Conv2d(3, 4, kernel_size=3, padding=1, bias=False)
    xb = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32)
    want = conv(torch.from_numpy(xb)).detach().numpy()
    w = tti.convert_tensor("conv.weight", conv.weight)       # HWIO
    np.testing.assert_array_equal(
        w, jti.convert_tensor("conv.weight", conv.weight))
    got = t_conv2d(torch.from_numpy(xb.transpose(0, 2, 3, 1)),
                   torch.from_numpy(w), stride=1, padding=[(1, 1), (1, 1)])
    np.testing.assert_allclose(got.numpy().transpose(0, 3, 1, 2), want,
                               atol=2e-5)
    emb = torch.nn.Embedding(7, 3).weight
    np.testing.assert_array_equal(tti.convert_tensor("e.weight", emb, "raw"),
                                  emb.detach().numpy())


def test_import_torch_model_writes_the_reference_dir(tmp_path):
    torch.manual_seed(2)
    tm = torch.nn.Linear(4, 2)
    names = {"weight": "_fc.w0", "bias": "_fc.wbias"}
    tti.import_torch_model(tm, names, save_dir=str(tmp_path / "t"),
                           kinds={"weight": "linear_weight"})
    jti.import_torch_model(tm, names, save_dir=str(tmp_path / "j"),
                           kinds={"weight": "linear_weight"})
    assert sorted(os.listdir(tmp_path / "t")) == ["_fc.w0", "_fc.wbias"]
    for n in names.values():
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes()


def test_manifest_json_is_the_reference_text(tmp_path):
    """The manifest's text (not only its content) equals the JAX
    package's for the same state."""
    jtr, ttr = _trainers(_fc_cfgs(), "adam")
    a = jtr.save(str(tmp_path / "jax"), 3)
    ttr.load(a)
    b = ttr.save(str(tmp_path / "port"), 3)
    with open(os.path.join(a, "manifest.json")) as f, \
            open(os.path.join(b, "manifest.json")) as g:
        assert g.read() == f.read()
    assert json.loads(open(os.path.join(b, "manifest.json")).read())[
        "format"] == 2
