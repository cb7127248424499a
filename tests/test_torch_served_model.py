"""The port's serving artifact (``paddle_tpu_torch.serving.export`` and
``loader.ServedModel``) on the CPU: the four cases of
``tests/test_serving.py``, ``tests/test_serving_server.py::
test_loader_batch_aware_call`` and the four int8 cases of
``tests/test_precision.py``, each also held against the JAX package's
``ServedModel`` on the same parameters (carried by
``utils.jax_interop``).

Tolerances: an fp32 net exported by the port gives the port's own
forward bit for bit, and the JAX package's ``ServedModel`` within atol
1e-6 (fp32 products summed in another order).  The int8 artifacts'
weights dequantize to the same bits in both packages (bf16 rounds to
nearest even in both), so their outputs agree as closely; the LSTM
classifier agrees with the JAX forward (its Pallas LSTM in interpret
mode) within 1e-5, the recurrence's rounding over T steps.

The exported graph carries kernel 8 (``ptpu::lstm_fwd``) and the
attention forward (``ptpu::flash_fwd``, and ``ptpu::flash_fwd_legacy``
under ``--flash_block_sparse=false``) as custom ops, with none of their
plain versions' ops in their place; a kernel that is no custom op yet
refuses the export by name.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.utils import FLAGS, PaddleTpuError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(build):
    """``build(dsl, feeder)`` through both packages' DSLs → (JAX net,
    port net)."""
    from paddle_tpu.config import dsl as jdsl
    from paddle_tpu.data import feeder as jfeeder
    from paddle_tpu.layers import NeuralNetwork as JNet
    from paddle_tpu_torch.config import dsl as tdsl
    from paddle_tpu_torch.data import feeder as tfeeder
    from paddle_tpu_torch.layers.network import NeuralNetwork as TNet

    with jdsl.config_scope():
        jcfg = jdsl.topology(build(jdsl, jfeeder))
    with tdsl.config_scope():
        tcfg = tdsl.topology(build(tdsl, tfeeder))
    return JNet(jcfg), TNet(tcfg)


def _carry(jnet, tnet, seed):
    from paddle_tpu_torch.utils.jax_interop import network_params_from_jax

    jp = jnet.init_params(seed)
    tp = network_params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                 tnet, "cpu")
    return jp, tp


def _mnist_net(dsl, feeder, hidden=64, din=784):
    img = dsl.data_layer("img", feeder.dense_vector(din))
    lbl = dsl.data_layer("label", feeder.integer_value(10))
    h = dsl.fc_layer(img, size=hidden, act=dsl.ReluActivation())
    pred = dsl.fc_layer(h, size=10, act=dsl.SoftmaxActivation(),
                        name="prediction")
    return dsl.classification_cost(pred, lbl)


def _mlp_net(dsl, feeder):
    return _mnist_net(dsl, feeder, hidden=48, din=64)


def _forward(tnet, tp, feed, names):
    from paddle_tpu_torch.core.sequence import value_of

    with torch.no_grad():
        vals, _ = tnet.forward(tp, feed, tnet.init_buffers("cpu"),
                               is_training=False, only=names)
    return {n: value_of(vals[n]).numpy() for n in names}


def _jax_served(jnet, jp, feed, d, **kw):
    from paddle_tpu.serving import ServedModel as JServed
    from paddle_tpu.serving import export_network as jexport

    jexport(jnet, jp, feed, d, **kw)
    return JServed.load(d)


def _graph_ops(d):
    from paddle_tpu_torch.ops import export_ops  # noqa: F401
    ep = torch.export.load(os.path.join(d, "model.pt2"))
    return [str(n.target) for n in ep.graph.nodes
            if n.op == "call_function"]


# ------------------------------------------------ tests/test_serving.py
def test_export_and_load_identical_logits(tmp_path):
    from paddle_tpu_torch.serving import ServedModel, export_network

    jnet, tnet = _both(_mnist_net)
    jp, tp = _carry(jnet, tnet, 11)
    rng = np.random.RandomState(1)
    x = rng.randn(8, 784).astype(np.float32)
    d = str(tmp_path / "artifact")
    export_network(tnet, tp, {"img": x}, d)
    assert os.path.exists(os.path.join(d, "manifest.json"))
    assert os.path.exists(os.path.join(d, "model.pt2"))
    ref = _forward(tnet, tp, {"img": torch.from_numpy(x)},
                   ["prediction"])["prediction"]
    m = ServedModel.load(d, device="cpu")
    got = m(img=x)["prediction"]
    np.testing.assert_array_equal(got, ref)
    jm = _jax_served(jnet, jp, {"img": x}, str(tmp_path / "jax"))
    np.testing.assert_allclose(got, jm(img=x)["prediction"], atol=1e-6,
                               rtol=0)
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    assert manifest["module"] == "model.pt2"
    assert manifest["batch_polymorphic"]
    x2 = rng.randn(3, 784).astype(np.float32)
    assert m(img=x2)["prediction"].shape == (3, 10)


def test_fresh_process_never_imports_layer_engine(tmp_path):
    """Identical logits from a process that never imports
    ``paddle_tpu_torch.layers`` (or the DSL, the trainer, the framework);
    the kernel-op module is the one ``ops`` module it loads."""
    from paddle_tpu_torch.serving import export_network

    _, tnet = _both(_mnist_net)
    tp = tnet.init_params(11, device="cpu")
    x = np.random.RandomState(2).randn(5, 784).astype(np.float32)
    d = str(tmp_path / "artifact")
    export_network(tnet, tp, {"img": x}, d)
    np.save(str(tmp_path / "x.npy"), x)
    np.save(str(tmp_path / "ref.npy"), _forward(
        tnet, tp, {"img": torch.from_numpy(x)}, ["prediction"])["prediction"])
    script = f"""
import sys
import numpy as np
from paddle_tpu_torch.serving.loader import ServedModel
m = ServedModel.load({d!r}, device="cpu")
out = m(img=np.load({str(tmp_path / 'x.npy')!r}))["prediction"]
np.testing.assert_array_equal(out, np.load({str(tmp_path / 'ref.npy')!r}))
banned = [m for m in sys.modules
          if m.startswith(("paddle_tpu_torch.layers",
                           "paddle_tpu_torch.config",
                           "paddle_tpu_torch.trainer",
                           "paddle_tpu_torch.framework"))
          or m == "jax" or m.startswith("paddle_tpu.")]
assert not banned, f"loader dragged in framework modules: {{banned}}"
assert "paddle_tpu_torch.ops.export_ops" in sys.modules
print("SERVED_OK")
"""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "SERVED_OK" in r.stdout


def test_loader_rejects_bad_feed_and_future_version(tmp_path):
    from paddle_tpu_torch.serving import ServedModel, export_network

    _, tnet = _both(_mnist_net)
    tp = tnet.init_params(1, device="cpu")
    x = np.zeros((2, 784), np.float32)
    d = str(tmp_path / "artifact")
    export_network(tnet, tp, {"img": x}, d)
    m = ServedModel.load(d, device="cpu")
    with pytest.raises(KeyError):
        m(wrong=x)
    with pytest.raises(ValueError):
        m(img=np.zeros((2, 7), np.float32))
    mpath = os.path.join(d, "manifest.json")
    manifest = json.load(open(mpath))
    manifest["version"] = 99
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(ValueError):
        ServedModel.load(d, device="cpu")


def _transformer_net(dsl, feeder):
    import importlib
    text = importlib.import_module(dsl.__name__.split(".")[0]
                                   + ".models.text")
    return text.transformer_classifier_cost(vocab_size=20, model_dim=16,
                                            num_heads=2, num_layers=1,
                                            ffn_dim=32, max_len=16)


def _transformer_feed():
    rng = np.random.RandomState(2)
    return (rng.randint(0, 20, (4, 8)).astype(np.int32),
            np.array([8, 5, 8, 3], np.int32))


def test_export_transformer_with_flash_attention(tmp_path):
    """A transformer classifier exports with the attention forward as a
    custom op and serves the framework's probabilities; the JAX
    package's artifact of the same parameters agrees."""
    from paddle_tpu.core.sequence import SequenceBatch as JSeq
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.serving import ServedModel, export_network

    jnet, tnet = _both(_transformer_net)
    jp, tp = _carry(jnet, tnet, 7)
    ids, lens = _transformer_feed()
    feed = {"data": SequenceBatch(torch.from_numpy(ids),
                                  torch.from_numpy(lens))}
    d = str(tmp_path / "artifact")
    export_network(tnet, tp, feed, d)
    ref = _forward(tnet, tp, feed, ["cls"])["cls"]
    got = ServedModel.load(d, device="cpu")(data=ids, data_len=lens)["cls"]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    jm = _jax_served(jnet, jp, {"data": JSeq(ids, lens)},
                     str(tmp_path / "jax"))
    np.testing.assert_allclose(got, jm(data=ids, data_len=lens)["cls"],
                               rtol=1e-5, atol=1e-6)
    assert "ptpu.flash_fwd.default" in _graph_ops(d)


# ------------------------------------- tests/test_serving_server.py
def test_loader_batch_aware_call(tmp_path):
    """``ServedModel.__call__(n_requests=N)`` books telemetry per
    REQUEST: ``serve_requests`` ticks by N and ``serve_infer_seconds``
    gets N observations for the one launch."""
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.serving import ServedModel, export_inference_fn

    w = np.linspace(-1, 1, 12).reshape(4, 3).astype(np.float32)
    tw = torch.from_numpy(w)

    def fn(feed):
        return {"y": feed["x"] @ tw}

    d = str(tmp_path / "artifact")
    x = np.ones((2, 4), np.float32)
    export_inference_fn(fn, {"x": x}, d, fetch_names=["y"])
    m = ServedModel.load(d, device="cpu")
    observe.REGISTRY.reset()
    try:
        out = m(n_requests=5, x=x)
        np.testing.assert_allclose(out["y"], x @ w, rtol=1e-6)
        assert observe.counter("serve_requests", "").value() == 5
        assert observe.histogram("serve_infer_seconds",
                                 "").retained_samples() == 5
        assert observe.gauge("serve_batch_size", "").value() == 5
        with pytest.raises(ValueError):
            m(n_requests=0, x=x)
    finally:
        observe.REGISTRY.reset()


# ------------------------------------------ tests/test_precision.py int8
def test_quantize_int8_per_channel_error_bound():
    from paddle_tpu.serving.export import quantize_int8 as jquant
    from paddle_tpu_torch.serving.export import (dequantize_int8,
                                                 quantize_int8)

    rng = np.random.RandomState(0)
    w = (rng.randn(96, 24).astype(np.float32)
         * np.linspace(0.05, 8.0, 24, dtype=np.float32))
    q, scale = quantize_int8(w)
    assert q.dtype == np.int8 and scale.shape == (24,)
    assert int(np.abs(q).max()) <= 127
    deq = dequantize_int8(q, scale, dtype="float32")
    err = np.abs(deq - w).max(axis=0)
    assert np.all(err <= scale / 2 + 1e-7)
    jq, js = jquant(w)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale, js)
    bf = dequantize_int8(q, scale, dtype="bfloat16")
    assert bf.dtype == torch.bfloat16


def test_int8_artifact_manifest_v2_schema_and_v1_unchanged(tmp_path):
    from paddle_tpu_torch.serving import export_network

    jnet, tnet = _both(_mlp_net)
    jp, tp = _carry(jnet, tnet, 3)
    x = np.random.RandomState(0).randn(4, 64).astype(np.float32)
    d1 = str(tmp_path / "v1")
    export_network(tnet, tp, {"img": x}, d1)
    m1 = json.load(open(os.path.join(d1, "manifest.json")))
    assert m1["version"] == 1 and "weights" not in m1
    assert not os.path.exists(os.path.join(d1, "weights.npz"))

    d2 = str(tmp_path / "v2")
    export_network(tnet, tp, {"img": x}, d2, quantize="int8")
    m2 = json.load(open(os.path.join(d2, "manifest.json")))
    assert m2["format"] == "paddle-tpu-serving"
    assert m2["version"] == 2
    w = m2["weights"]
    assert w["scheme"] == "int8-weights-per-channel"
    assert w["file"] == "weights.npz"
    assert w["dequant_dtype"] == "bfloat16"
    assert {e["name"] for e in w["entries"]} == set(tp)
    for e in w["entries"]:
        assert set(e) == {"name", "shape", "dtype", "quantized", "axis"}
        if e["quantized"]:
            assert e["axis"] == -1 and e["dtype"] == "bfloat16"
        else:
            assert e["dtype"] == "float32"
    npz = np.load(os.path.join(d2, "weights.npz"))
    for e in w["entries"]:
        if e["quantized"]:
            assert npz["q::" + e["name"]].dtype == np.int8
            assert npz["s::" + e["name"]].dtype == np.float32
        else:
            assert ("w::" + e["name"]) in npz
    # the JAX package's int8 export of the same parameters: the same
    # entries and the same stored arrays
    dj = str(tmp_path / "jax_v2")
    _jax_served(jnet, jp, {"img": x}, dj, quantize="int8")
    mj = json.load(open(os.path.join(dj, "manifest.json")))
    assert mj["weights"]["entries"] == w["entries"]
    jnpz = np.load(os.path.join(dj, "weights.npz"))
    assert sorted(jnpz.files) == sorted(npz.files)
    for k in npz.files:
        np.testing.assert_array_equal(npz[k], jnpz[k])


def test_int8_artifact_outputs_close_to_v1(tmp_path):
    from paddle_tpu_torch.serving import ServedModel, export_network

    jnet, tnet = _both(_mlp_net)
    jp, tp = _carry(jnet, tnet, 4)
    x = np.random.RandomState(1).randn(8, 64).astype(np.float32)
    d1, d2 = str(tmp_path / "fp32"), str(tmp_path / "int8")
    export_network(tnet, tp, {"img": x}, d1)
    export_network(tnet, tp, {"img": x}, d2, quantize="int8")
    a = ServedModel.load(d1, device="cpu")(img=x)["prediction"]
    b = ServedModel.load(d2, device="cpu")(img=x)["prediction"]
    assert b.shape == a.shape
    assert float(np.max(np.abs(a - b))) < 0.05
    np.testing.assert_array_equal(a, _forward(
        tnet, tp, {"img": torch.from_numpy(x)}, ["prediction"])["prediction"])
    # the bf16-dequantized weights meet fp32 activations: upcast at the
    # op, the JAX package's promotion — its int8 artifact's outputs
    jb = _jax_served(jnet, jp, {"img": x}, str(tmp_path / "jax_int8"),
                     quantize="int8")(img=x)["prediction"]
    np.testing.assert_allclose(b, np.asarray(jb, np.float32), atol=1e-6,
                               rtol=0)


def test_int8_fp32_dequant_and_batch_poly(tmp_path):
    from paddle_tpu_torch.serving import ServedModel, export_network

    jnet, tnet = _both(_mlp_net)
    jp, tp = _carry(jnet, tnet, 5)
    x = np.random.RandomState(2).randn(4, 64).astype(np.float32)
    d = str(tmp_path / "int8fp32")
    export_network(tnet, tp, {"img": x}, d, quantize="int8",
                   dequant_dtype="float32")
    m = json.load(open(os.path.join(d, "manifest.json")))
    assert m["weights"]["dequant_dtype"] == "float32"
    srv = ServedModel.load(d, device="cpu")
    assert m["batch_polymorphic"]
    x3 = np.random.RandomState(3).randn(3, 64).astype(np.float32)
    out = srv(img=x3)["prediction"]
    assert out.shape == (3, 10)
    jm = _jax_served(jnet, jp, {"img": x}, str(tmp_path / "jax"),
                     quantize="int8", dequant_dtype="float32")
    np.testing.assert_allclose(out, jm(img=x3)["prediction"], atol=1e-6,
                               rtol=0)


# -------------------------------------------- the kernels in the graph
def _lstm_net(dsl, feeder, hidden=128):
    net = dsl.data("data", feeder.integer_value_sequence(50))
    net = dsl.embedding(net, size=16)
    for i in range(2):
        net = dsl.lstmemory(dsl.fc(net, size=4 * hidden,
                                   act=dsl.LinearActivation(),
                                   name=f"proj{i}"), name=f"lstm{i}")
    net = dsl.last_seq(net)
    net = dsl.fc(net, size=2, act=dsl.SoftmaxActivation(), name="pred")
    lab = dsl.data("label", feeder.integer_value(2))
    return dsl.classification_cost(net, lab)


def _lstm_feed(b=8, t=12, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 50, (b, t)).astype(np.int32),
            rng.randint(3, t + 1, b).astype(np.int32))


#: the plain versions' ops that must not stand in the kernels' place
PLAIN_LSTM_OPS = ("aten.sigmoid", "aten.tanh")
PLAIN_ATTENTION_OPS = ("aten.exp", "aten.einsum", "aten.amax")


def test_exported_graph_holds_the_kernel_ops(tmp_path):
    """The LSTM classifier's program holds ``ptpu::lstm_fwd`` once a
    layer and no sigmoid or tanh (the plain step loop's); the
    transformer's holds ``ptpu::flash_fwd`` (``ptpu::flash_fwd_legacy``
    under ``--flash_block_sparse=false``) and no exp, einsum or amax (the
    plain composition's, which ``--flash_kernel=false`` does export)."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.serving import export_network

    _, tnet = _both(_lstm_net)
    ids, lens = _lstm_feed()
    feed = {"data": SequenceBatch(torch.from_numpy(ids),
                                  torch.from_numpy(lens))}
    d = str(tmp_path / "lstm")
    export_network(tnet, tnet.init_params(3, device="cpu"), feed, d)
    ops = _graph_ops(d)
    assert ops.count("ptpu.lstm_fwd.default") == 2
    assert not [o for o in ops if o.startswith(PLAIN_LSTM_OPS)], ops

    _, tnet = _both(_transformer_net)
    ids, lens = _transformer_feed()
    feed = {"data": SequenceBatch(torch.from_numpy(ids),
                                  torch.from_numpy(lens))}
    tp = tnet.init_params(7, device="cpu")
    for flag, want in (("flash_block_sparse", "ptpu.flash_fwd.default"),
                       ("", "ptpu.flash_fwd.default"),
                       ("flash_kernel", None)):
        saved = FLAGS.get(flag) if flag else None
        if flag == "flash_block_sparse":
            FLAGS.set(flag, False)
            want = "ptpu.flash_fwd_legacy.default"
        elif flag:
            FLAGS.set(flag, False)
        try:
            d = str(tmp_path / f"attn_{flag or 'default'}")
            export_network(tnet, tp, feed, d)
        finally:
            if flag:
                FLAGS.set(flag, saved)
        ops = _graph_ops(d)
        plain = [o for o in ops if o.startswith(PLAIN_ATTENTION_OPS)]
        if want is None:                 # the kill switch: plain ops
            assert plain and not [o for o in ops if o.startswith("ptpu")]
        else:
            assert ops.count(want) == 1 and not plain, ops


def test_lstm_classifier_served_matches_jax(tmp_path):
    """The LSTM row's net (at H 128) exported with a SequenceBatch feed:
    the artifact gives the port's forward bit for bit and the JAX
    forward (its Pallas LSTM in interpret mode) within 1e-5."""
    from paddle_tpu.core.sequence import SequenceBatch as JSeq
    from paddle_tpu.core.sequence import value_of as jvalue
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.serving import ServedModel, export_network

    jnet, tnet = _both(_lstm_net)
    jp, tp = _carry(jnet, tnet, 3)
    ids, lens = _lstm_feed()
    feed = {"data": SequenceBatch(torch.from_numpy(ids),
                                  torch.from_numpy(lens))}
    d = str(tmp_path / "lstm")
    export_network(tnet, tp, feed, d)
    got = ServedModel.load(d, device="cpu")(data=ids, data_len=lens)["pred"]
    np.testing.assert_array_equal(got, _forward(tnet, tp, feed,
                                                ["pred"])["pred"])
    jv, _ = jnet.forward(jp, {"data": JSeq(ids, lens)}, jnet.init_buffers(),
                         is_training=False, only=["pred"])
    np.testing.assert_allclose(got, np.asarray(jvalue(jv["pred"])),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("what", ["kernel 10", "kernel 13"])
def test_unexportable_kernels_refuse_by_name(tmp_path, what):
    """A forward kernel that is no custom op yet refuses the export by
    name (queue A6b) — never a silent plain version in the program."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.serving import export_network

    if what == "kernel 10":          # the blocked LSTM tier, H > 512
        _, tnet = _both(lambda d, f: _lstm_net(d, f, hidden=640))
    else:                            # the fused GRU, kernel 13
        def gru(dsl, feeder):
            net = dsl.data("data", feeder.integer_value_sequence(50))
            net = dsl.embedding(net, size=16)
            net = dsl.grumemory(dsl.fc(net, size=3 * 128,
                                       act=dsl.LinearActivation()))
            net = dsl.fc(dsl.last_seq(net), size=2,
                         act=dsl.SoftmaxActivation(), name="pred")
            return dsl.classification_cost(
                net, dsl.data("label", feeder.integer_value(2)))
        _, tnet = _both(gru)
    ids, lens = _lstm_feed(t=4)
    feed = {"data": SequenceBatch(torch.from_numpy(ids),
                                  torch.from_numpy(lens))}
    with pytest.raises(PaddleTpuError, match=f"{what}.*not exportable "
                                             "yet, ROADMAP A6b"):
        export_network(tnet, tnet.init_params(1, device="cpu"), feed,
                       str(tmp_path / "refused"))


def test_loader_refuses_decoder_and_jax_module_artifacts(tmp_path):
    from paddle_tpu_torch.serving import ServedModel
    from paddle_tpu_torch.serving.model import (DecoderConfig,
                                                export_decoder,
                                                init_decoder_params)

    cfg = DecoderConfig(64, 32, 2, 1, 64, 64)
    d = str(tmp_path / "dec")
    export_decoder(init_decoder_params(cfg), cfg, d)
    with pytest.raises(ValueError, match="DecoderModel.from_artifact"):
        ServedModel.load(d, device="cpu")
    jnet, _ = _both(_mnist_net)
    dj = str(tmp_path / "jax")
    _jax_served(jnet, jnet.init_params(1),
                {"img": np.zeros((2, 784), np.float32)}, dj)
    with pytest.raises(ValueError, match="model.stablehlo"):
        ServedModel.load(dj, device="cpu")
