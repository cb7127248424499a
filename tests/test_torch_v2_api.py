"""The port's v2 API (``paddle_tpu_torch/v2``) against the JAX package's
(``paddle_tpu/v2``), the 12 cases of ``tests/test_v2_api.py`` through
both packages on the CPU.

- Training: the MNIST MLP (Momentum), UCI-housing regression (Adam),
  the sequence-LSTM classifier (Adam) and the recommender demo's
  dual-tower net (Adam, sparse-update id tables), each built through its
  package's ``v2`` and trained by ``v2.trainer.SGD`` from the same
  parameters (the JAX trainer's, carried over by
  ``utils.jax_interop.network_params_from_jax``): every batch's cost of
  3 batches within rtol 1e-5, atol 1e-6.  ``SGD.test`` with
  ``v2.evaluator.classification_error()`` before training: equal error,
  ``test_cost`` within the same tolerance.
- ``v2.infer`` from the same parameters: outputs within that tolerance.
- ``Parameters`` tars: written by either package, loaded by the other
  bit for bit, also into an ``SGD``; ``v2.model.save_model`` /
  ``load_model`` with a stub master (``request_save_model``) in place
  of the JAX package's ``distributed.Master``.
- ``Topology.proto()`` equal; config-declared evaluators through
  ``Trainer.test``; the namespace over the reference's ``__all__``; the
  ``paddle.v2`` alias with its deep imports; ``master.client()`` and
  ``init(trainer_count=2)`` refusing with "A9".
"""

import importlib
import importlib.util
import io
import os
import types

import numpy as np
import pytest
import torch

import paddle_tpu.v2 as jv2
from paddle_tpu.config import dsl as jdsl
from paddle_tpu.data import datasets as jds
from paddle_tpu.data import download as jdl
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu_torch import v2 as tv2
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.data import datasets as tds
from paddle_tpu_torch.data import download as tdl
from paddle_tpu_torch.utils import FLAGS as TFLAGS
from paddle_tpu_torch.utils import PaddleTpuError
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax
from test_torch_config_parser import paddle_aliases  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
N_BATCHES = 3
LOOP_FLAGS = ("save_dir", "log_period")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def flags_and_cache(tmp_path, monkeypatch):
    """Both packages log every batch's cost and save nothing; their
    dataset caches point at an empty directory (the surrogates)."""
    old_j = {k: getattr(JFLAGS, k) for k in LOOP_FLAGS}
    old_t = {k: TFLAGS.get(k) for k in LOOP_FLAGS}
    for fl in (JFLAGS, TFLAGS):
        fl.set("save_dir", "")
        fl.set("log_period", 1)
    for dl in (jdl, tdl):
        monkeypatch.setattr(dl, "DATA_HOME", str(tmp_path))
    for ds in (jds, tds):
        monkeypatch.setattr(ds, "CACHE_ROOT", str(tmp_path))
        monkeypatch.setattr(ds, "_download_failed", set())
        monkeypatch.setattr(ds, "_MOVIELENS", ds._MovielensMeta())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for k in LOOP_FLAGS:
        JFLAGS.set(k, old_j[k])
        TFLAGS.set(k, old_t[k])


def _pair(build, optimizer):
    """``build(v2)`` → (cost, extra) inside each package's config scope;
    an ``SGD`` of each (the port's on the CPU) with the port's
    parameters set to the JAX trainer's."""
    out = []
    for v2, dsl, kw in ((jv2, jdsl, {}), (tv2, tdsl, {"device": "cpu"})):
        with dsl.config_scope():
            cost, extra = build(v2)
            sgd = v2.trainer.SGD(cost, update_equation=optimizer(v2), **kw)
        out.append((sgd, extra))
    (jsgd, jextra), (tsgd, textra) = out
    tsgd.core.params = network_params_from_jax(
        {n: np.array(v) for n, v in jsgd.core.params.items()},
        tsgd.network, "cpu")
    return jsgd, tsgd, jextra, textra


def _costs(sgd, reader, feeding):
    costs = []

    def handler(e):
        if type(e).__name__ == "EndIteration":
            costs.append(e.cost)

    sgd.train(reader, num_passes=1, event_handler=handler, feeding=feeding)
    assert len(costs) == N_BATCHES
    return costs


def _train_both(jsgd, tsgd, make_reader, feeding):
    want = _costs(jsgd, make_reader(jv2), feeding)
    got = _costs(tsgd, make_reader(tv2), feeding)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert all(np.isfinite(got))


def _mnist_net(v2):
    images = v2.layer.data("pixel", v2.data_type.dense_vector(784))
    label = v2.layer.data("label", v2.data_type.integer_value(10))
    h1 = v2.layer.fc(images, size=64, act=v2.activation.Relu())
    h2 = v2.layer.fc(h1, size=64, act=v2.activation.Relu())
    probs = v2.layer.fc(h2, size=10, act=v2.activation.Softmax())
    return v2.layer.classification_cost(probs, label), probs


def _mnist_pair():
    return _pair(_mnist_net, lambda v2: v2.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9))


MNIST_FEEDING = {"pixel": 0, "label": 1}


def test_mnist_mlp_trains():
    jsgd, tsgd, _, _ = _mnist_pair()
    # the evaluator path, from the same parameters
    test_reader = {v2: v2.reader.batch(v2.dataset.mnist.test(n_synth=128),
                                       64) for v2 in (jv2, tv2)}
    want = jsgd.test(test_reader[jv2], feeding=MNIST_FEEDING,
                     evaluators=[jv2.evaluator.classification_error()])
    got = tsgd.test(test_reader[tv2], feeding=MNIST_FEEDING,
                    evaluators=[tv2.evaluator.classification_error()])
    assert set(got) == set(want) == {"test_cost", "classification_error"}
    assert got["classification_error"] == want["classification_error"]
    np.testing.assert_allclose(got["test_cost"], want["test_cost"],
                               rtol=RTOL, atol=ATOL)
    _train_both(jsgd, tsgd, lambda v2: v2.reader.firstn(v2.reader.batch(
        v2.reader.shuffle(v2.dataset.mnist.train(n_synth=512), 1024, seed=0),
        64), N_BATCHES), MNIST_FEEDING)


def test_uci_housing_regression():
    def net(v2):
        x = v2.layer.data("x", v2.data_type.dense_vector(13))
        y = v2.layer.data("y", v2.data_type.dense_vector(1))
        pred = v2.layer.fc(x, size=1, act=v2.activation.Linear())
        return v2.layer.square_error_cost(pred, y), None

    jsgd, tsgd, _, _ = _pair(net, lambda v2: v2.optimizer.Adam(
        learning_rate=0.01))
    _train_both(jsgd, tsgd, lambda v2: v2.reader.firstn(v2.reader.batch(
        v2.dataset.uci_housing.train(), 32), N_BATCHES), {"x": 0, "y": 1})


def test_sequence_lstm_classification():
    def net(v2):
        word = v2.layer.data("word", v2.data_type.integer_value_sequence(200))
        label = v2.layer.data("label", v2.data_type.integer_value(2))
        emb = v2.layer.embedding(word, size=16)
        lstm = v2.networks.simple_lstm(emb, size=16)
        pooled = v2.layer.pooling(lstm, v2.pooling.Max())
        probs = v2.layer.fc(pooled, size=2, act=v2.activation.Softmax())
        return v2.layer.classification_cost(probs, label), None

    def synth():
        rng = np.random.RandomState(3)
        for _ in range(32 * N_BATCHES):
            y = int(rng.randint(2))
            length = int(rng.randint(4, 12))
            lo, hi = (2, 100) if y == 0 else (100, 198)
            yield rng.randint(lo, hi, length), y

    jsgd, tsgd, _, _ = _pair(net, lambda v2: v2.optimizer.Adam(
        learning_rate=0.01))
    _train_both(jsgd, tsgd, lambda v2: v2.reader.batch(synth, 32),
                {"word": 0, "label": 1})


def test_recommender_system_trains():
    """The recommender demo's ``build_model`` run with its ``paddle``
    and ``datasets`` names bound to each package in turn."""
    spec = importlib.util.spec_from_file_location(
        "recommender_demo_v2_parity",
        os.path.join(REPO, "demo", "recommender", "train.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    pkg = {jv2: jds, tv2: tds}

    def net(v2):
        demo.paddle, demo.datasets = v2, pkg[v2]
        meta = demo.movielens_meta()
        return demo.build_model(meta, emb=8, hidden=16)[0], meta

    jsgd, tsgd, jmeta, tmeta = _pair(net, lambda v2: v2.optimizer.Adam(
        learning_rate=1e-3))
    assert tmeta == jmeta
    _train_both(jsgd, tsgd, lambda v2: v2.reader.firstn(v2.batch(
        v2.reader.map_readers(demo.to_sample, v2.dataset.movielens.train()),
        32), N_BATCHES), demo.FEEDING)


def test_inference_api():
    """``infer`` runs inside the config scope that built the net, as in
    the JAX package's test; the port's parameters are set to the JAX
    trainer's through ``Parameters.set``."""
    from paddle_tpu_torch.data.feeder import DataFeeder, dense_vector
    batch = [(x,) for x, _ in list(jv2.dataset.mnist.test(n_synth=8)())]
    outs, jparams = [], None
    for v2, dsl, kw in ((jv2, jdsl, {}), (tv2, tdsl, {"device": "cpu"})):
        with dsl.config_scope():
            cost, probs = _mnist_net(v2)
            sgd = v2.trainer.SGD(cost, update_equation=v2.optimizer.SGD(),
                                 **kw)
            if jparams is None:
                jparams = sgd.parameters
            else:
                for n in jparams.names():
                    sgd.parameters.set(n, jparams.get(n))
            outs.append(v2.infer(output_layer=probs,
                                 parameters=sgd.parameters,
                                 input=[batch, batch[:3]],
                                 feeding={"pixel": 0}, **kw))
            if v2 is tv2:   # a converted feed, as the JAX test gives it
                feed = DataFeeder([("pixel", dense_vector(784))]).convert(
                    batch)
                inf = tv2.inference.Inference(probs, sgd.parameters,
                                              device="cpu")
                by_feed = inf.infer([feed])
    want, got = outs
    assert got.shape == want.shape == (11, 10)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), np.ones(11), rtol=1e-5)
    np.testing.assert_array_equal(by_feed, got[:8])


def test_checkpoint_roundtrip():
    """``Parameters`` tars across the packages, both ways, bit for bit."""
    jsgd, tsgd, _, _ = _mnist_pair()
    jsgd.core.train_one_batch(jsgd._feeder(MNIST_FEEDING).convert(
        list(jv2.dataset.mnist.train(n_synth=4)())))
    buf = io.BytesIO()
    jsgd.parameters.to_tar(buf)
    buf.seek(0)
    loaded = tv2.Parameters.from_tar(buf)
    assert loaded.names() == jsgd.parameters.names()
    for n in loaded.names():
        want = np.asarray(jsgd.core.params[n])
        assert loaded.get(n).dtype == want.dtype
        np.testing.assert_array_equal(loaded.get(n), want)
    # into a port SGD: the stored values are written into its trainer
    with tdsl.config_scope():
        cost, _ = _mnist_net(tv2)
        tsgd2 = tv2.trainer.SGD(cost, parameters=loaded, device="cpu",
                                update_equation=tv2.optimizer.SGD())
    for n in loaded.names():
        t = tsgd2.core.params[n]
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(tsgd2.parameters[n],
                                      np.asarray(jsgd.core.params[n]))
    # and back: the port's tar into the JAX package
    buf = io.BytesIO()
    tsgd2.parameters.to_tar(buf)
    buf.seek(0)
    back = jv2.Parameters.from_tar(buf)
    for n in back.names():
        np.testing.assert_array_equal(back.get(n), loaded.get(n))
    # set keeps the trainer's dtype and device, and refuses a bad shape
    tsgd2.parameters.set(n, np.zeros(back.get(n).shape, np.float64))
    assert tsgd2.core.params[n].dtype == torch.float32
    with pytest.raises(PaddleTpuError, match="shape"):
        tsgd2.parameters.set(n, np.zeros((1, 2, 3)))


def test_config_declared_evaluators_run_in_test_job():
    from paddle_tpu.data import feeder as jfeed
    from paddle_tpu.layers import NeuralNetwork as JNet
    from paddle_tpu.trainer.trainer import Trainer as JTrainer
    from paddle_tpu_torch.data import feeder as tfeed
    from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
    from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer

    cfgs = []
    for dsl, feed in ((jdsl, jfeed), (tdsl, tfeed)):
        with dsl.config_scope():
            x = dsl.data_layer("x", feed.dense_vector(8))
            y = dsl.data_layer("y", feed.integer_value(3))
            pred = dsl.fc_layer(x, size=3, act=dsl.SoftmaxActivation(),
                                name="pred")
            dsl.classification_error_evaluator(pred, label=y)
            dsl.sum_evaluator(pred)
            cfgs.append(dsl.topology(dsl.classification_cost(pred, y)))
    assert cfgs[1].to_json() == cfgs[0].to_json()
    assert len(cfgs[1].evaluators) == 2
    jtr = JTrainer(JNet(cfgs[0]))
    ttr = TTrainer(TNet(cfgs[1]), device="cpu")
    ttr.params = network_params_from_jax(
        {n: np.array(v) for n, v in jtr.params.items()}, ttr.network, "cpu")
    rng = np.random.RandomState(0)
    batches = [[(rng.randn(8).astype(np.float32), int(rng.randint(3)))
                for _ in range(4)] for _ in range(3)]
    metrics = []
    for tr, feed in ((jtr, jfeed), (ttr, tfeed)):
        feeder = feed.DataFeeder([("x", feed.dense_vector(8)),
                                  ("y", feed.integer_value(3))])
        metrics.append(tr.test(lambda: iter(batches), feeder,
                               label_name="y"))
    want, got = metrics
    assert set(got) == set(want) and "classification_error" in got
    assert any("sum" in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


#: names that differ between the packages' v2 modules on purpose: the
#: helpers each imports, and the JAX master's classes (the port's master
#: waits for queue A9)
HELPERS = {"Optional", "Sequence", "Union", "SequenceBatch", "LayerOutput",
           "resolve_device", "enforce", "PaddleTpuError", "InputType",
           "Master", "MasterClient"}


def test_v2_namespace_parity():
    ref_all = ['optimizer', 'layer', 'activation', 'parameters', 'init',
               'trainer', 'event', 'data_type', 'attr', 'pooling',
               'dataset', 'reader', 'topology', 'networks', 'infer',
               'plot', 'evaluator', 'image', 'master', 'model']
    assert [n for n in ref_all if not hasattr(tv2, n)] == []
    assert tv2.__all__ == jv2.__all__

    def public(mod):
        return {n for n, v in vars(mod).items() if not n.startswith("_")
                and not isinstance(v, types.ModuleType)} - HELPERS

    for name in jv2.__all__:
        jm, tm = getattr(jv2, name), getattr(tv2, name)
        if isinstance(jm, types.ModuleType):
            assert public(tm) == public(jm), name
    for cls in ("mnist", "imdb", "movielens", "flowers", "common"):
        jc, tc = getattr(jv2.dataset, cls), getattr(tv2.dataset, cls)
        assert set(vars(jc)) - {"__module__", "__qualname__"} <= \
            set(vars(tc)), cls


def test_v2_topology_wrapper():
    protos = []
    for dsl, v2 in ((jdsl, jv2), (tdsl, tv2)):
        with dsl.config_scope():
            a = dsl.data_layer("a", size=4)
            out = dsl.fc_layer(input=[a], size=2, name="out")
            topo = v2.topology.Topology(out)
            assert topo.proto().output_layer_names == ["out"]
            assert list(topo.data_layers()) == ["a"]
            assert topo.get_layer_proto("out").size == 2
            assert topo.get_layer_proto("nope") is None
            protos.append(topo.proto().to_json())
        with pytest.raises(Exception, match="LayerOutput"):
            v2.topology.Topology("not a layer")
    assert protos[1] == protos[0]


class StubMaster:
    """The save-model election of the JAX package's master: the first
    trainer to ask wins."""

    def __init__(self):
        self.winner = None

    def request_save_model(self, trainer_id, interval_s):
        if self.winner is None:
            self.winner = trainer_id
        return self.winner == trainer_id


def test_v2_model_save_load_with_election(tmp_path):
    params = tv2.Parameters()
    params["w"] = np.arange(6, dtype=np.float32).reshape(2, 3)
    p = tv2.model.save_model(params, str(tmp_path / "m.tar"))
    assert p and os.path.exists(p)
    for pkg in (tv2, jv2):
        loaded = pkg.Parameters()
        loaded["w"] = np.zeros((2, 3), np.float32)
        pkg.model.load_model(loaded, p)
        np.testing.assert_array_equal(loaded["w"], params["w"])
    m = StubMaster()
    wins = [tv2.model.save_model(params, str(tmp_path / "dist"), master=m,
                                 trainer=tid)
            for tid in ("trainer-a", "trainer-b", "trainer-a")]
    assert wins[1] is None and wins[0] == wins[2] == \
        str(tmp_path / "dist" / "trainer-a" / "model.tar")
    # a JAX-written model loads into the port
    q = jv2.model.save_model(params, str(tmp_path / "j.tar"))
    loaded = tv2.Parameters()
    tv2.model.load_model(loaded, q)
    np.testing.assert_array_equal(loaded["w"], params["w"])


def test_v2_master_client_and_trainer_count_refuse():
    with pytest.raises(PaddleTpuError, match="A9"):
        tv2.master.client()
    with pytest.raises(PaddleTpuError, match="A9"):
        tv2.master.client("127.0.0.1:1", timeout_sec=5.0)
    with pytest.raises(PaddleTpuError, match="A9"):
        tv2.init(use_gpu=True, trainer_count=2)
    tv2.init(use_gpu=True, trainer_count=1)
    with pytest.raises(PaddleTpuError, match="A9"):
        tv2.reader.cloud_reader(["x"], master=None)
    with tdsl.config_scope():
        cost, _ = _mnist_net(tv2)
        with pytest.raises(PaddleTpuError, match="A9"):
            tv2.trainer.SGD(cost, is_local=False, device="cpu")


def test_compat_paddle_v2_alias(paddle_aliases):  # noqa: F811
    from paddle_tpu_torch import compat
    with paddle_aliases():
        compat.install()
        ref = importlib.import_module("paddle.v2")
        assert ref is tv2
        mnist = importlib.import_module("paddle.v2.dataset.mnist")
        assert mnist is tv2.dataset.mnist and callable(mnist.train)
        nets = importlib.import_module("paddle.v2.networks")
        assert nets.simple_gru is tv2.networks.simple_gru
        assert importlib.import_module("paddle.v2.layer") is tv2.layer
        assert ref.batch is tv2.reader.batch
