"""The port's transformer slice (``layers/attention.py``:
``scaled_dot_product_attention``, ``layer_norm``, ``position_embedding``;
``models.transformer_text_classifier``; one ``Trainer`` step) against the
JAX package's, on the CPU.

The same ``ModelConfig`` comes out of both packages; the JAX
``init_params`` is carried into the port by name.  The JAX side's flash
attention runs its Pallas kernels in interpret mode; the port's kernel
wrappers take their plain versions on CPU tensors.  Feeds and layer
inputs come from a numpy seed.

Tolerances: fp32 (summation order) — layer outputs 1e-5, loss rtol 1e-5,
gradients 1e-4 * max|ref| per parameter (measured ≤ 1e-6), the Adam step's
parameters atol 1e-6.  Under ``bench.py``'s flags (``use_bf16`` +
``bf16_activations``) both packages round to bf16 at the same places but
sum in other orders (XLA's and PyTorch's bf16 matmuls, layer norm), and a
value near a rounding boundary rounds the other way, which later layers
carry on: layer outputs within 2 bf16 ulps of the larger value plus
1e-2 * max|ref|, the net's loss rtol 5e-3 (measured 8.1e-4), gradients
5e-2 * max|ref| + 1e-6 (measured up to 3.2e-2, on the position table:
sums over the batch of bf16 gradients).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.model_config import LayerConfig as JConf
from paddle_tpu.config.model_config import LayerInput as JIn
from paddle_tpu.config.model_config import ModelConfig as JModel
from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.models import transformer_text_classifier as j_transformer
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu_torch.config.model_config import (LayerConfig, LayerInput,
                                                  ModelConfig)
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.models import transformer_text_classifier
from paddle_tpu_torch.ops import attention as ta
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from paddle_tpu_torch.utils import FLAGS as TFLAGS
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax

# the small net; bench.py's attention row for the config check
SMALL = dict(vocab_size=50, model_dim=64, num_heads=2, num_layers=2,
             ffn_dim=128, max_len=256, block_q=128, block_k=128)
BENCH = dict(vocab_size=30000, model_dim=512, num_heads=8, num_layers=4,
             ffn_dim=2048, max_len=2048)
B, T, LENGTHS = 2, 256, (256, 93)
OPT = dict(learning_method="adam", learning_rate=1e-3,
           gradient_clipping_threshold=25.0)       # bench.py:270-278, :583
FLAG_NAMES = ("use_bf16", "bf16_activations", "flash_kernel",
              "flash_block_sparse", "attention_packing")
TOL = {"fp32": dict(out=1e-5, loss=1e-5, grad=(1e-4, 0.0)),
       "bench": dict(out=1e-2, loss=5e-3, grad=(5e-2, 1e-6))}


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


def _set_precision(flags):
    bf16 = flags == "bench"
    _set_both(use_bf16=bf16, bf16_activations=bf16)


def _np(x):
    x = x.data if isinstance(x, (JSeq, TSeq)) else x
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _grads_close(got, want, flags):
    rtol, floor = TOL[flags]["grad"]
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=rtol * np.abs(w).max() + floor,
                                   err_msg=name)


# ------------------------------------------------------------- config
@pytest.mark.parametrize("dims", [dict(BENCH), dict(SMALL, causal=True,
                                                    packed=True)],
                         ids=["bench_row", "small_causal_packed"])
def test_config_and_param_specs_match_jax(dims):
    jcfg, tcfg = j_transformer(**dims), transformer_text_classifier(**dims)
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
    specs = [{n: dataclasses.asdict(s) for n, s in net.param_specs.items()}
             for net in (JNet(jcfg), TNet(tcfg))]
    assert specs[1] == specs[0]


# ------------------------------------------------------------- layers
def _single(ltype, size, input_sizes, with_bias=False, attrs=None):
    """One layer over dense data inputs in0..inN in both packages."""
    names = [f"in{i}" for i in range(len(input_sizes))]
    conf = dict(name="test", type=ltype, size=size, with_bias=with_bias,
                attrs=attrs or {})
    jl = [JConf(name=n, type="data", size=s)
          for n, s in zip(names, input_sizes)]
    tl = [LayerConfig(name=n, type="data", size=s)
          for n, s in zip(names, input_sizes)]
    jl.append(JConf(inputs=[JIn(input_layer_name=n) for n in names],
                    **conf))
    tl.append(LayerConfig(inputs=[LayerInput(input_layer_name=n)
                                  for n in names], **conf))
    return (JNet(JModel(layers=jl, input_layer_names=names,
                        output_layer_names=["test"])),
            TNet(ModelConfig(layers=tl, input_layer_names=names,
                             output_layer_names=["test"])))


def _seq(rng, lens, t, d):
    x = rng.randn(len(lens), t, d).astype(np.float32)
    ln = np.asarray(lens, np.int32)
    return ((JSeq(jnp.asarray(x), jnp.asarray(ln)),
             TSeq(torch.from_numpy(x), torch.from_numpy(ln))), ln)


def _layer_run(nets, feeds, flags, seed=2):
    """Output (padding zeroed) and every parameter's gradient of
    ``sum(out * cot)`` in both packages, from JAX's params."""
    _set_precision(flags)
    jnet, tnet = nets
    jp = jnet.init_params(seed=seed)
    jp = {n: v + 0.3 if n.endswith(".w0") and v.ndim == 1 else v
          for n, v in jp.items()}               # a non-trivial LN gain
    tp = network_params_from_jax({n: np.asarray(v) for n, v in jp.items()},
                                 tnet, "cpu")
    jfeed = {n: j for n, (j, _) in feeds.items()}
    tfeed = {n: t for n, (_, t) in feeds.items()}
    jout = jnet.forward(jp, jfeed, is_training=True)[0]["test"]
    shape = _np(jout).shape
    cot = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    mask = np.ones(shape, np.float32)
    if isinstance(jout, JSeq):
        ln = np.asarray(jout.length)
        mask = (np.arange(shape[1])[None, :] < ln[:, None]).astype(
            np.float32)[..., None] * mask
    w = cot * mask

    def jloss(p):
        out = jnet.forward(p, jfeed, is_training=True)[0]["test"]
        out = out.data if isinstance(out, JSeq) else out
        return jnp.sum(out.astype(jnp.float32) * w)
    jg = jax.grad(jloss)(jp)
    tp = {n: p.requires_grad_(True) for n, p in tp.items()}
    tout = tnet.forward(tp, tfeed)[0]["test"]
    data = tout.data if isinstance(tout, TSeq) else tout
    tg = torch.autograd.grad((data.float() * torch.from_numpy(w)).sum(),
                             list(tp.values()))
    assert data.dtype == (torch.bfloat16 if flags == "bench"
                          else torch.float32)
    return ((_np(jout) * mask, _np(tout) * mask),
            ({n: np.asarray(g, np.float32) for n, g in jg.items()},
             {n: g.float().numpy() for n, g in zip(tp, tg)}))


def _outputs_close(got, want, flags):
    if flags == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL["fp32"]["out"])
        return
    top = np.maximum(np.abs(got), np.abs(want))
    tol = 2 * np.ldexp(1.0, np.frexp(top)[1] - 8) \
        + TOL["bench"]["out"] * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _layer_case(name):
    rng = np.random.RandomState(0)
    if name in ("mha", "mha_causal"):
        (pair, _) = _seq(rng, [6, 4], 6, 12)
        return (_single("scaled_dot_product_attention", 16, [12], True,
                        {"num_heads": 4, "causal": name == "mha_causal"}),
                {"in0": pair})
    if name == "mha_packed":
        (pair, _) = _seq(rng, [128, 77], 128, 16)
        return (_single("scaled_dot_product_attention", 16, [16], True,
                        {"num_heads": 2, "packed": True, "block_q": 128,
                         "block_k": 128}), {"in0": pair})
    if name == "mha_cross":
        (q, _), (kv, _) = _seq(rng, [5, 3], 5, 8), _seq(rng, [7, 2], 7, 10)
        return (_single("scaled_dot_product_attention", 8, [8, 10, 10],
                        False, {"num_heads": 2}),
                {"in0": q, "in1": kv, "in2": kv})
    if name == "layer_norm":
        x = (rng.randn(4, 12) * 3 + 1).astype(np.float32)
        return (_single("layer_norm", 12, [12], True, {"epsilon": 1e-5}),
                {"in0": (jnp.asarray(x), torch.from_numpy(x))})
    (pair, _) = _seq(rng, [4, 2], 4, 6)
    return (_single("position_embedding", 6, [6], False, {"max_len": 10}),
            {"in0": pair})


@pytest.mark.parametrize("flags", ["fp32", "bench"])
@pytest.mark.parametrize("name", ["mha", "mha_causal", "mha_packed",
                                  "mha_cross", "layer_norm",
                                  "position_embedding"])
def test_layer_matches_jax(name, flags):
    """The reference's own layer cases (tests/test_attention_layer.py),
    through a one-layer net of each package: output and every parameter
    gradient."""
    nets, feeds = _layer_case(name)
    (jout, tout), (jg, tg) = _layer_run(nets, feeds, flags)
    assert tout.shape == jout.shape
    _outputs_close(tout, jout, flags)
    _grads_close(tg, jg, flags)


def test_packed_layer_padding_is_zero_before_wo():
    """Packed: padding positions of the attention are exact zeros, so the
    layer's output there is its bias (no bias: exactly 0)."""
    nets, feeds = _layer_case("mha_packed")
    tnet = nets[1]
    conf = tnet.layers["test"].conf
    conf.with_bias = False
    tp = tnet.init_params(seed=0, device="cpu")
    tp.pop("_test.wbias", None)
    out = tnet.forward(tp, {"in0": feeds["in0"][1]})[0]["test"]
    assert torch.all(out.data[1, 77:] == 0)


def test_mha_output_ignores_key_padding():
    """Cross attention: row 1's keys past its length 2 do not reach its
    output (the reference's check, here on the port alone)."""
    nets, feeds = _layer_case("mha_cross")
    tnet = nets[1]
    tp = tnet.init_params(seed=3, device="cpu")
    q, kv = feeds["in0"][1], feeds["in1"][1]
    kv2 = kv.with_data(kv.data.clone())
    kv2.data[1, 2:] = 99.0
    a = tnet.forward(tp, {"in0": q, "in1": kv, "in2": kv})[0]["test"]
    b = tnet.forward(tp, {"in0": q, "in1": kv2, "in2": kv2})[0]["test"]
    assert torch.equal(a.length, torch.tensor([5, 3], dtype=torch.int32))
    torch.testing.assert_close(a.data[1, :3], b.data[1, :3], rtol=0,
                               atol=1e-6)


# ------------------------------------------------------ the whole step
def _feed_arrays(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, SMALL["vocab_size"], (B, T)).astype(np.int32)
    labels = rng.randint(0, 2, (B,)).astype(np.int32)
    return ids, np.asarray(LENGTHS, np.int32), labels


def _jfeed(ids, ln, labels):
    return {"data": JSeq(jnp.asarray(ids), jnp.asarray(ln)),
            "label": jnp.asarray(labels)}


def _tfeed(ids, ln, labels):
    return {"data": TSeq(torch.from_numpy(ids), torch.from_numpy(ln)),
            "label": torch.from_numpy(labels)}


def _mode(mode):
    return dict(SMALL, causal=mode == "causal", packed=mode == "packed")


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(mode, flags):
    _set_precision(flags)
    jnet = JNet(j_transformer(**_mode(mode)))
    jp = jnet.init_params(seed=0)
    feed = _jfeed(*_feed_arrays())
    loss, grads = jax.value_and_grad(
        lambda p: jnet.loss(p, feed, {}, is_training=True)[0])(jp)
    return ({n: np.asarray(v) for n, v in jp.items()}, float(loss),
            {n: np.asarray(g, np.float32) for n, g in grads.items()})


@pytest.mark.parametrize("flags", ["fp32", "bench"])
@pytest.mark.parametrize("mode", ["padded", "packed", "causal"])
def test_loss_and_every_gradient_match_jax(mode, flags):
    np_params, want_loss, want_g = _jax_loss_and_grads(mode, flags)
    _set_precision(flags)
    ta.attention_dispatch_total.clear()
    tnet = TNet(transformer_text_classifier(**_mode(mode)))
    params = network_params_from_jax(np_params, tnet, "cpu")
    params = {n: p.requires_grad_(True) for n, p in params.items()}
    loss, (values, _) = tnet.loss(params, _tfeed(*_feed_arrays()))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), want_loss,
                               rtol=TOL[flags]["loss"])
    assert len(grads) == 28
    _grads_close({n: g.float().numpy() for n, g in zip(params, grads)},
                 want_g, flags)
    path = "packed" if mode == "packed" else "block_sparse"
    assert dict(ta.attention_dispatch_total) == {(path, ""): 2}
    assert values["res1f"].data.dtype == (torch.bfloat16 if flags == "bench"
                                          else torch.float32)


def test_adam_step_matches_jax():
    """One step of bench.py's optimizer (Adam lr 1e-3, clip 25) from the
    same carried params on one feed, fp32: the loss and every parameter
    after the step."""
    _set_precision("fp32")
    jtr = JTrainer(JNet(j_transformer(**SMALL)), opt_config=JOpt(**OPT),
                   seed=0)
    tnet = TNet(transformer_text_classifier(**SMALL))
    ttr = TTrainer(tnet, opt_config=TOpt(**OPT), seed=0, device="cpu")
    ttr.params = network_params_from_jax(
        {n: np.array(v) for n, v in jtr.params.items()}, tnet, "cpu")
    arrays = _feed_arrays(seed=3)
    want = float(jtr.train_one_batch(_jfeed(*arrays)))
    got = float(ttr.train_one_batch(_tfeed(*arrays)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert ttr.samples_seen == B
    for name, p in jtr.params.items():
        np.testing.assert_allclose(ttr.params[name].numpy(), np.asarray(p),
                                   rtol=0, atol=1e-6, err_msg=name)
