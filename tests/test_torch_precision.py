"""The port's precision policy, bf16 train path and dynamic loss scaling
against the JAX package's, on the CPU.

- ``core/dtypes``: the same policy from the same flags, in every
  combination;
- ``math_ops.matmul`` under the bf16-compute / fp32-output policy: an
  fp32 result equal to JAX's ``preferred_element_type`` product (and
  not the bf16-rounded one ``torch.matmul`` of two bf16 tensors gives);
- the LSTM text classifier at H = 640 (both packages on their blocked
  LSTM tier) through ``NeuralNetwork.loss``: fp32, and under ``bench.py``'s
  flags (``use_bf16`` and ``bf16_activations``);
- ``optimizer/loss_scale``: grow, back off, floor, ceiling, unscale,
  select, against the JAX functions;
- ``--precision=bf16`` in both trainers: a 3-step trajectory, then a
  step with a non-finite gradient (an inf feed, as
  ``tests/test_precision.py`` makes it) that must leave params and Adam
  slots bit-identical, halve the scale and count one skip.

Tolerances: fp32 as in ``tests/test_torch_train.py`` (loss rtol 1e-5,
gradients 1e-5 + 1e-4 * max|ref|).  bf16: the two packages round to
bf16 at the same places but sum in other orders, and a sum that lands
near a rounding boundary rounds the other way.  Measured on this
classifier: loss rel err 5.3e-6 (limit 5e-3); gradients within
1.34e-2 * max|ref| for the LSTM biases (their gate part is a sum over
B*T of bf16 dgates, rounded to bf16: 3 ulps) and within 2.6e-3 for the
rest (limit 2e-2).  The bf16 trainer trajectory (an fc model, fp32
masters): losses equal to the printed digit (limit rtol 5e-3),
parameters after 3 steps 7.5e-9 apart (limit 1e-3 + 2e-2 * max|ref|).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl
from paddle_tpu.config.dsl import config_scope
from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.core import dtypes as jd
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.data.feeder import dense_vector, integer_value
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.models import lstm_text_classifier as j_classifier
from paddle_tpu.ops import math_ops as jm
from paddle_tpu.optimizer import loss_scale as jls
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu_torch.config.model_config import (LayerConfig, LayerInput,
                                                  ModelConfig)
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.core import dtypes as td
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.models import lstm_text_classifier as t_classifier
from paddle_tpu_torch.ops import math_ops as tm
from paddle_tpu_torch.optimizer import loss_scale as tls
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from paddle_tpu_torch.utils import FLAGS as TFLAGS
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax

FLAG_NAMES = ("use_bf16", "bf16_activations", "precision", "loss_scale_init",
              "loss_scale_growth_interval", "fused_rnn_hblock")
V, E, H, C = 100, 16, 640, 2
OPT = dict(learning_method="adam", learning_rate=2e-3, l2_weight_decay=8e-4,
           gradient_clipping_threshold=25.0)
DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = [(f, {k: f.get(k) for k in FLAG_NAMES})
             for f in (JFLAGS, TFLAGS)]
    yield
    for f, values in saved:
        for k, v in values.items():
            f.set(k, v)


def _set_both(**kw):
    for k, v in kw.items():
        JFLAGS.set(k, v)
        TFLAGS.set(k, v)


# ------------------------------------------------------------- policy
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("act", [False, True])
def test_policy_resolution_matches_jax(precision, use_bf16, act):
    _set_both(precision=precision, use_bf16=use_bf16, bf16_activations=act)

    def same(tp, jp):
        return (DT[tp.param_dtype], DT[tp.compute_dtype],
                DT[tp.output_dtype]) == \
            (jp.param_dtype, jp.compute_dtype, jp.output_dtype)

    assert same(td.current_policy(), jd.current_policy())
    assert same(td.policy_for(precision), jd.policy_for(precision))
    assert td.resolve_precision() == jd.resolve_precision() == precision
    assert td.resolve_precision(TOpt(precision="bf16")) == "bf16"
    with td.full_precision():
        assert td.current_policy().compute_dtype == torch.float32
    with pytest.raises(ValueError):
        td.resolve_precision(TOpt(precision="fp16"))


def test_matmul_under_bf16_gives_the_fp32_product_of_bf16_operands():
    """``_bf16`` (bf16 compute, fp32 output): JAX asks for
    ``preferred_element_type=float32``, an fp32 sum of exact products
    of the bf16-rounded operands.  The port gives that number; a bf16
    ``torch.matmul`` would round it to bf16 (the trap)."""
    rng = np.random.RandomState(0)
    x = rng.randn(16, 256).astype(np.float32)
    y = rng.randn(256, 24).astype(np.float32)
    with jd.policy_scope(jd._bf16):
        want = np.asarray(jm.matmul(jnp.asarray(x), jnp.asarray(y)))
    with td.policy_scope(td._bf16):
        got = tm.matmul(torch.from_numpy(x), torch.from_numpy(y))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    rounded = (torch.from_numpy(x).bfloat16() @ torch.from_numpy(y).bfloat16()
               ).float().numpy()
    assert np.abs(rounded - want).max() > 1e-3
    # the bf16-activation policy keeps the product in bf16 on both sides
    with jd.policy_scope(jd._bf16_act):
        want = np.asarray(jm.matmul(jnp.asarray(x), jnp.asarray(y)),
                          np.float32)
    with td.policy_scope(td._bf16_act):
        got = tm.matmul(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)


# ------------------------------------------------- classifier at H = 640
def _feed(b, t, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, size=(b, t)).astype(np.int32)
    lengths = rng.randint(1, t + 1, size=(b,)).astype(np.int32)
    lengths[0] = t
    labels = rng.randint(0, C, size=(b,)).astype(np.int32)
    return ids, lengths, labels


def _classifier_loss_and_grads(bf16):
    """(JAX loss, grads), (port loss, grads) of one feed at H = 640."""
    _set_both(use_bf16=bf16, bf16_activations=bf16, fused_rnn_hblock=True)
    jnet = JNet(j_classifier(V, E, H, 2, C))
    tnet = TNet(t_classifier(V, E, H, 2, C))
    jparams = jnet.init_params(seed=0)
    ids, lengths, labels = _feed(8, 6, 1)
    jfeed = {"data": JSeq(jnp.asarray(ids), jnp.asarray(lengths)),
             "label": jnp.asarray(labels)}
    want = jax.value_and_grad(
        lambda p: jnet.loss(p, jfeed, {}, is_training=True)[0])(jparams)
    params = network_params_from_jax(
        {n: np.asarray(v) for n, v in jparams.items()}, tnet, "cpu")
    params = {n: p.requires_grad_(True) for n, p in params.items()}
    loss, _ = tnet.loss(params, {
        "data": TSeq(torch.from_numpy(ids), torch.from_numpy(lengths)),
        "label": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, list(params.values()))
    return want, (loss.detach(), dict(zip(params, grads)))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_act"])
def test_classifier_h640_matches_jax(bf16):
    (want_l, want_g), (got_l, got_g) = _classifier_loss_and_grads(bf16)
    loss_rtol, grad_rtol = (5e-3, 2e-2) if bf16 else (1e-5, 1e-4)
    assert got_l.dtype == torch.float32
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=loss_rtol)
    assert set(got_g) == set(want_g)
    for name, g in want_g.items():
        g = np.asarray(g, np.float32)
        assert got_g[name].dtype == torch.float32, name
        np.testing.assert_allclose(
            got_g[name].numpy(), g, rtol=0,
            atol=1e-5 + grad_rtol * float(np.abs(g).max()), err_msg=name)


def test_bf16_activations_make_bf16_layer_outputs():
    _set_both(use_bf16=True, bf16_activations=True)
    tnet = TNet(t_classifier(V, E, 520, 1, C))
    params = tnet.init_params(seed=0, device="cpu")
    ids, lengths, labels = _feed(2, 3, 2)
    loss, (values, _) = tnet.loss(params, {
        "data": TSeq(torch.from_numpy(ids), torch.from_numpy(lengths)),
        "label": torch.from_numpy(labels)})
    assert loss.dtype == torch.float32
    assert values["lstm0"].data.dtype == torch.bfloat16
    assert values["__embedding_1__"].data.dtype == torch.bfloat16
    assert values["__fc_3__.logits"].dtype == torch.bfloat16
    assert values["__multi-class-cross-entropy_4__"].dtype == torch.float32


# ------------------------------------------------------- loss scaling
def _jstate(scale, count, skipped):
    return jls.LossScaleState(jnp.asarray(scale, jnp.float32),
                              jnp.asarray(count, jnp.int32),
                              jnp.asarray(skipped, jnp.int32))


def _tstate(scale, count, skipped):
    return tls.LossScaleState(torch.tensor(scale, dtype=torch.float32),
                              torch.tensor(count, dtype=torch.int32),
                              torch.tensor(skipped, dtype=torch.int32))


@pytest.mark.parametrize("start,finite,interval", [
    ((8.0, 0, 0), [True, True, True], 2),          # grows after 2
    ((4.0, 7, 0), [False] * 6, 100),               # backs off to the floor
    ((tls.MAX_SCALE, 0, 0), [True, False], 1),     # ceiling, then backoff
    ((1024.0, 3, 2), [True, False, True], 3)])
def test_loss_scale_update_matches_jax(start, finite, interval):
    js, ts = _jstate(*start), _tstate(*start)
    for f in finite:
        js = jls.update(js, jnp.asarray(f), growth_interval=interval)
        ts = tls.update(ts, torch.tensor(f), growth_interval=interval)
        assert (float(ts.scale), int(ts.growth_count),
                int(ts.skipped_total)) == \
            (float(js.scale), int(js.growth_count), int(js.skipped_total))
    assert tls.GROWTH_FACTOR == jls.GROWTH_FACTOR
    assert tls.BACKOFF_FACTOR == jls.BACKOFF_FACTOR
    assert (tls.MIN_SCALE, tls.MAX_SCALE) == (jls.MIN_SCALE, jls.MAX_SCALE)


def test_loss_scale_helpers():
    g = {"w": torch.tensor([2.0, 4.0], dtype=torch.bfloat16)}
    out = tls.unscale(g, torch.tensor(2.0))
    assert out["w"].dtype == torch.float32
    assert out["w"].tolist() == [1.0, 2.0]
    assert bool(tls.all_finite({"a": torch.ones(3), "b": torch.zeros(2)}))
    assert not bool(tls.all_finite({"a": torch.tensor([1.0, np.inf])}))
    assert not bool(tls.all_finite({"a": torch.tensor([np.nan])}))
    old = {"w": torch.tensor([1.25, -3.5]), "s": (torch.tensor(3),)}
    new = {"w": torch.tensor([np.nan, 9.0]), "s": (torch.tensor(4),)}
    kept = tls.select(torch.tensor(False), new, old)
    assert kept["w"].numpy().tobytes() == old["w"].numpy().tobytes()
    assert int(kept["s"][0]) == 3
    TFLAGS.set("loss_scale_init", 256.0)
    st = tls.init_state(device="cpu")
    assert float(st.scale) == 256.0 and int(st.skipped_total) == 0


# ------------------------------------------------ --precision=bf16 step
def _fc_pair(precision):
    with config_scope():
        img = dsl.data_layer("x", dense_vector(16))
        lbl = dsl.data_layer("label", integer_value(4))
        hid = dsl.fc_layer(img, size=32, act=dsl.ReluActivation())
        pred = dsl.fc_layer(hid, size=4, act=dsl.SoftmaxActivation(),
                            name="pred")
        jcfg = dsl.topology(dsl.classification_cost(pred, lbl))

    def layer(name, ltype, size, inputs, act="", bias=False, kind=None,
              attrs=None):
        if kind is not None:
            attrs = {"height": 0, "width": 0, "seq_level": 0, "kind": kind}
        return LayerConfig(name=name, type=ltype, size=size, active_type=act,
                           inputs=[LayerInput(input_layer_name=i)
                                   for i in inputs], with_bias=bias,
                           attrs=attrs or {})

    cost = "__multi-class-cross-entropy_2__"
    tcfg = ModelConfig(
        layers=[layer("x", "data", 16, [], kind="dense"),
                layer("__fc_1__", "fc", 32, ["x"], "relu", True),
                layer("pred", "fc", 4, ["__fc_1__"], "softmax", True),
                layer("label", "data", 4, [], kind="index"),
                layer(cost, "multi-class-cross-entropy", 1,
                      ["pred", "label"], attrs={"coeff": 1.0})],
        input_layer_names=["x", "label"], output_layer_names=[cost])
    assert dataclasses.asdict(tcfg) == json.loads(jcfg.to_json())
    jtr = JTrainer(JNet(jcfg), opt_config=JOpt(**OPT, precision=precision),
                   seed=0)
    tnet = TNet(tcfg)
    ttr = TTrainer(tnet, TOpt(**OPT, precision=precision), seed=0,
                   device="cpu")
    ttr.params = network_params_from_jax(
        {n: np.array(v) for n, v in jtr.params.items()}, tnet, "cpu")
    return jtr, ttr


def _fc_feeds(rng, b=8):
    x = rng.randn(b, 16).astype(np.float32)
    label = rng.randint(0, 4, (b,)).astype(np.int32)
    return ({"x": jnp.asarray(x), "label": jnp.asarray(label)},
            {"x": torch.from_numpy(x), "label": torch.from_numpy(label)})


def test_bf16_trainer_trajectory_and_skipped_step_match_jax():
    _set_both(loss_scale_init=1024.0, loss_scale_growth_interval=2)
    jtr, ttr = _fc_pair("bf16")
    assert ttr.precision == "bf16"
    rng = np.random.RandomState(2)
    for step in range(3):
        jf, tf = _fc_feeds(rng)
        want = float(jtr.train_one_batch(jf))
        got = float(ttr.train_one_batch(tf))
        np.testing.assert_allclose(got, want, rtol=5e-3,
                                   err_msg=f"loss of step {step}")
        assert float(ttr._ls_state.scale) == float(jtr._ls_state.scale)
    assert float(ttr._ls_state.scale) == 2048.0      # grew after 2 steps
    for name, p in jtr.params.items():
        p = np.asarray(p)
        assert ttr.params[name].dtype == torch.float32
        np.testing.assert_allclose(ttr.params[name].numpy(), p, rtol=0,
                                   atol=1e-3 + 2e-2 * float(np.abs(p).max()),
                                   err_msg=name)
    p0 = {n: p.numpy().tobytes() for n, p in ttr.params.items()}
    count0, slots0 = ttr.opt_state
    o0 = {n: [s.numpy().tobytes() for s in sl] for n, sl in slots0.items()}
    jf, tf = _fc_feeds(rng)
    jf["x"] = jnp.full((8, 16), np.inf, jnp.float32)
    tf["x"] = torch.full((8, 16), float("inf"))
    jtr.train_one_batch(jf)
    ttr.train_one_batch(tf)                          # seeded overflow
    assert {n: p.numpy().tobytes() for n, p in ttr.params.items()} == p0
    count1, slots1 = ttr.opt_state
    assert int(count1) == int(count0) == 3
    assert {n: [s.numpy().tobytes() for s in sl]
            for n, sl in slots1.items()} == o0
    assert float(ttr._ls_state.scale) == float(jtr._ls_state.scale) == 1024.0
    assert int(ttr._ls_state.skipped_total) == \
        int(jtr._ls_state.skipped_total) == 1
    # a following finite step applies at the reduced scale
    jf, tf = _fc_feeds(rng)
    np.testing.assert_allclose(float(ttr.train_one_batch(tf)),
                               float(jtr.train_one_batch(jf)), rtol=5e-3)
    assert {n: p.numpy().tobytes() for n, p in ttr.params.items()} != p0
    assert int(ttr._ls_state.skipped_total) == 1


def test_fp32_precision_keeps_the_plain_step():
    _, ttr = _fc_pair("fp32")
    assert ttr.precision == "fp32" and ttr._ls_state is None
    _, tf = _fc_feeds(np.random.RandomState(3))
    ttr.train_one_batch(tf)
    assert int(ttr.opt_state[0]) == 1
