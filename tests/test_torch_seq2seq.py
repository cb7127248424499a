"""The port's seq2seq training path (``paddle_tpu_torch.models.
seq2seq_config``: bi-GRU encoder, attention decoder in a recurrent group)
against the JAX package's, on the CPU.

The JAX side builds ``bench.py``'s seq2seq topology (``seq2seq_setup``)
with its config DSL, written out here (the test does not import
``bench.py``); its fused GRU kernels run in Pallas interpret mode (B 8,
H 128).  The JAX ``init_params(0)`` is carried into the port by name.
Feeds come from a numpy seed, with source and target lengths varied.

Tolerances: fp32 (different summation orders) loss rtol 1e-5, gradients
1e-5 * max|ref| + 1e-9 per parameter (measured ≤ 2e-7), layer outputs
1e-6.  Under ``bench.py``'s flags (``use_bf16`` + ``bf16_activations``)
both packages round to bf16 at the same places but sum in other orders,
and a bf16 sum that lands near a rounding boundary rounds the other way:
loss rtol 1e-3 (measured 5.4e-6), gradients within 5e-2 * max|ref| +
1e-6 (measured up to 1.5e-2 * max|ref|, on the encoder biases: sums over
B·T of bf16 dxw).  The 1e-6 floor (3e-5 of the net's largest gradient)
is for ``_att_transform.w0``, whose gradient (max 2.3e-6) is a
cancellation in the attention softmax's backward: both packages land
12-15 % of its max away from their own fp32 value under these flags,
and 19 % from each other.  The Adam trajectory (3 steps, fp32): losses
rtol 1e-5, parameters atol 1e-5.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl
from paddle_tpu.config.dsl import ParamAttr, StepInput, config_scope
from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.data.feeder import integer_value_sequence
from paddle_tpu.layers.base import ForwardContext as JCtx
from paddle_tpu.layers.base import LAYERS as JLAYERS
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu.v2.networks import simple_attention, simple_gru
from paddle_tpu_torch.analysis import netcheck
from paddle_tpu_torch.config.model_config import (LayerConfig, LayerInput,
                                                  ModelConfig)
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.layers.base import ForwardContext as TCtx
from paddle_tpu_torch.layers.base import get_layer_class
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.layers.recurrent_group import RecurrentGroup
from paddle_tpu_torch.models import seq2seq_config
from paddle_tpu_torch.ops import gru as tgru
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from paddle_tpu_torch.utils import FLAGS as TFLAGS
from paddle_tpu_torch.utils import PaddleTpuError
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax

# the small net of the CPU tests; bench.py's dims for the config check
B, S, T, V, E, H = 8, 6, 5, 50, 16, 128
SRC_LEN = (6, 1, 3, 6, 5, 2, 4, 6)
TRG_LEN = (5, 5, 1, 3, 2, 5, 4, 1)
OPT = dict(learning_method="adam", learning_rate=5e-4,
           gradient_clipping_threshold=25.0)       # bench.py:270-278, :540
FLAG_NAMES = ("use_bf16", "bf16_activations")


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


def _jax_config(vocab, embed, hidden):
    """``bench.py``'s seq2seq_setup topology (bench.py:467-500)."""
    with config_scope():
        src = dsl.data("source", integer_value_sequence(vocab))
        trg = dsl.data("target", integer_value_sequence(vocab))
        trg_next = dsl.data("target_next", integer_value_sequence(vocab))
        src_emb = dsl.embedding(src, size=embed, name="src_emb",
                                param_attr=ParamAttr(name="_src_emb"),
                                vocab_size=vocab)
        fwd = simple_gru(src_emb, size=hidden, name="enc_fwd")
        bwd = simple_gru(src_emb, size=hidden, name="enc_bwd", reverse=True)
        enc = dsl.concat([fwd, bwd], name="enc_seq")
        enc_proj = dsl.fc(enc, size=hidden, act=dsl.LinearActivation(),
                          bias_attr=False, name="enc_proj")
        boot = dsl.fc(dsl.last_seq(bwd), size=hidden,
                      act=dsl.TanhActivation(), name="dec_boot")
        trg_emb = dsl.embedding(trg, size=embed, name="trg_emb",
                                param_attr=ParamAttr(name="_trg_emb"),
                                vocab_size=vocab)

        def step(e, ep, b, w):
            mem = dsl.memory(name="dec_gru", size=hidden, boot_layer=b)
            context = simple_attention(e, ep, mem.out, name="att")
            inp = dsl.fc([context, w], size=hidden * 3,
                         act=dsl.LinearActivation(), bias_attr=False,
                         name="dec_inproj")
            h = dsl.gru_step_layer(inp, mem.out, size=hidden, name="dec_gru")
            return dsl.fc(h, size=vocab, act=dsl.SoftmaxActivation(),
                          name="dec_prob")

        probs = dsl.recurrent_group(
            step, [enc, enc_proj, boot, StepInput(trg_emb)], name="decoder")
        cost = dsl.classification_cost(probs, trg_next)
        return dsl.topology(cost)


@pytest.mark.parametrize("dims", [(30000, 512, 512), (V, E, H)],
                         ids=["bench_row", "small"])
def test_config_and_param_specs_match_jax(dims):
    jcfg, tcfg = _jax_config(*dims), seq2seq_config(*dims)
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
    want = {n: dataclasses.asdict(s) for n, s in JNet(jcfg).param_specs.items()}
    got = {n: dataclasses.asdict(s) for n, s in TNet(tcfg).param_specs.items()}
    assert got == want


def test_fusion_plan_and_walk_skip_the_group_layers():
    """The decoder's step layers run only inside the group: the main
    walk and the fusion plan's root layers leave them out."""
    net = TNet(seq2seq_config(V, E, H))
    assert set(net.groups) == {"decoder"}
    inner = set(net.config.sub_models[1].layer_names)
    assert not inner & set(net.order)
    assert net.group_of["dec_prob"] == "decoder"
    assert netcheck.fusion_plan(net.config) == ({}, {})
    assert netcheck._root_and_outputs(net.config)[0] == set(net.order)


# ------------------------------------------------------------ layers
def _seq_pair(data, lengths):
    return (JSeq(jnp.asarray(data), jnp.asarray(lengths)),
            TSeq(torch.from_numpy(data), torch.from_numpy(lengths)))


def _run_layer(ltype, size, inputs, act="", attrs=None):
    """The layer of both packages on the same (JAX, port) input pairs:
    (JAX output data, port output data) as numpy."""
    conf = dict(name="l", type=ltype, size=size, active_type=act,
                attrs=attrs or {})
    from paddle_tpu.config.model_config import LayerConfig as JConf
    from paddle_tpu.config.model_config import LayerInput as JIn
    from paddle_tpu.config.model_config import ModelConfig as JModel
    names = [f"in{i}" for i in range(len(inputs))]
    jconf = JConf(inputs=[JIn(input_layer_name=n) for n in names], **conf)
    tconf = LayerConfig(inputs=[LayerInput(input_layer_name=n)
                                for n in names], **conf)
    jl = JLAYERS.get(ltype)(jconf, JModel(layers=[jconf]))
    tl = get_layer_class(ltype)(tconf, ModelConfig(layers=[tconf]))
    jout = jl.forward({}, [j for j, _ in inputs], JCtx())
    tout = tl.forward({}, [t for _, t in inputs], TCtx())
    val = lambda o: o.data if hasattr(o, "data") and not isinstance(  # noqa
        o, (np.ndarray, torch.Tensor)) else o
    return np.asarray(val(jout)), val(tout).numpy()


LEN = np.array([4, 1, 3], np.int32)


def _layer_case(name):
    rng = np.random.RandomState(7)
    x = rng.randn(3, 4, 6).astype(np.float32)
    y = rng.randn(3, 4, 10).astype(np.float32)
    w = rng.randn(3, 4, 1).astype(np.float32)
    rows = rng.randn(3, 6).astype(np.float32)
    return {
        "concat": ("concat", 16, [_seq_pair(x, LEN), _seq_pair(y, LEN)],
                   "tanh", None),
        "scaling": ("scaling", 10, [_seq_pair(w, LEN), _seq_pair(y, LEN)],
                    "", None),
        "expand": ("expand", 6, [(jnp.asarray(rows), torch.from_numpy(rows)),
                                 _seq_pair(y, LEN)], "", None),
        "average_sum": ("average", 6, [_seq_pair(x, LEN)], "",
                        {"stride": -1, "average_strategy": "sum"}),
        "average_mean": ("average", 6, [_seq_pair(x, LEN)], "tanh",
                         {"stride": -1, "average_strategy": "average"}),
        "sequence_softmax": ("fc_seq_softmax", 1, [_seq_pair(w, LEN)],
                             "sequence_softmax", None),
    }[name]


@pytest.mark.parametrize("name", ["concat", "scaling", "expand",
                                  "average_sum", "average_mean",
                                  "sequence_softmax"])
def test_layer_matches_jax(name):
    ltype, size, inputs, act, attrs = _layer_case(name)
    if ltype == "fc_seq_softmax":
        # the activation alone, through the layers' finalize (an addto of
        # one input is the identity): padded steps get exactly 0
        ltype = "addto"
    want, got = _run_layer(ltype, size, inputs, act, attrs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if name == "sequence_softmax":
        pad = np.arange(4)[None, :] >= LEN[:, None]
        assert np.all(got[pad] == 0)
        np.testing.assert_allclose(got.sum(1)[:, 0], 1.0, rtol=1e-6)


# ------------------------------------------------------ the whole step
def _feed_arrays(seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(2, V, (B, S)).astype(np.int32)
    trg = rng.randint(2, V, (B, T)).astype(np.int32)
    nxt = rng.randint(2, V, (B, T)).astype(np.int32)
    return src, trg, nxt


def _jfeed(src, trg, nxt):
    sl, tl = (jnp.asarray(np.asarray(x, np.int32)) for x in (SRC_LEN, TRG_LEN))
    return {"source": JSeq(jnp.asarray(src), sl),
            "target": JSeq(jnp.asarray(trg), tl),
            "target_next": JSeq(jnp.asarray(nxt), tl)}


def _tfeed(src, trg, nxt):
    sl, tl = (torch.tensor(x, dtype=torch.int32) for x in (SRC_LEN, TRG_LEN))
    return {"source": TSeq(torch.from_numpy(src), sl),
            "target": TSeq(torch.from_numpy(trg), tl),
            "target_next": TSeq(torch.from_numpy(nxt), tl)}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(bf16, hidden=H):
    _set_both(use_bf16=bf16, bf16_activations=bf16)
    jnet = JNet(_jax_config(V, E, hidden))
    jparams = jnet.init_params(seed=0)
    feed = _jfeed(*_feed_arrays())
    loss, grads = jax.value_and_grad(
        lambda p: jnet.loss(p, feed, {}, is_training=True)[0])(jparams)
    return ({n: np.asarray(v) for n, v in jparams.items()}, float(loss),
            {n: np.asarray(g, np.float32) for n, g in grads.items()})


def _torch_loss_and_grads(np_params, bf16, hidden=H):
    _set_both(use_bf16=bf16, bf16_activations=bf16)
    tnet = TNet(seq2seq_config(V, E, hidden))
    params = network_params_from_jax(np_params, tnet, "cpu")
    params = {n: p.requires_grad_(True) for n, p in params.items()}
    loss, (values, _) = tnet.loss(params, _tfeed(*_feed_arrays()))
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {n: g.numpy()
                                  for n, g in zip(params, grads)}, values


@pytest.mark.parametrize("flags", ["fp32", "bench_bf16"])
def test_loss_and_every_gradient_match_jax(flags):
    bf16 = flags == "bench_bf16"
    np_params, want_loss, want_g = _jax_loss_and_grads(bf16)
    loss, grads, values = _torch_loss_and_grads(np_params, bf16)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-3 if bf16 else 1e-5)
    assert set(grads) == set(want_g) and len(grads) == 19
    rtol, floor = (5e-2, 1e-6) if bf16 else (1e-5, 1e-9)
    for name, w in want_g.items():
        np.testing.assert_allclose(grads[name], w, rtol=0,
                                   atol=rtol * np.abs(w).max() + floor,
                                   err_msg=name)
    # the cost is per token, [B*T, 1], padded tokens 0: the objective is
    # the valid tokens' sum over B*T (the JAX package's reduction)
    cost = values["__multi-class-cross-entropy_3__"]
    assert isinstance(cost, TSeq) and tuple(cost.data.shape) == (B * T, 1)
    pad = (np.arange(T)[None, :] >= np.asarray(TRG_LEN)[:, None]).reshape(-1)
    assert np.all(cost.data.detach().numpy()[pad] == 0)
    np.testing.assert_allclose(float(cost.data.detach().sum()) / (B * T),
                               loss,
                               rtol=1e-6)
    assert values["dec_prob"].data.dtype == \
        (torch.bfloat16 if bf16 else torch.float32)


@pytest.mark.parametrize("flags", ["fp32", "bench_bf16"])
def test_h640_loss_and_every_gradient_match_jax(flags, monkeypatch):
    """The slice at H 640: both packages' encoder GRUs take their
    hidden-blocked tier (kernels 15-17; in the port their plain versions
    on the CPU), and the loss and every gradient agree within the
    tolerances of ``test_loss_and_every_gradient_match_jax``."""
    bf16 = flags == "bench_bf16"
    np_params, want_loss, want_g = _jax_loss_and_grads(bf16, 640)
    calls = []
    real = tgru.gru_fused_sequence_blocked
    monkeypatch.setattr(tgru, "gru_fused_sequence_blocked",
                        lambda *a: calls.append(1) or real(*a))
    loss, grads, _ = _torch_loss_and_grads(np_params, bf16, 640)
    assert len(calls) == 2                # enc_fwd, enc_bwd
    np.testing.assert_allclose(loss, want_loss, rtol=1e-3 if bf16 else 1e-5)
    assert set(grads) == set(want_g) and len(grads) == 19
    rtol, floor = (5e-2, 1e-6) if bf16 else (1e-5, 1e-9)
    for name, w in want_g.items():
        np.testing.assert_allclose(grads[name], w, rtol=0,
                                   atol=rtol * np.abs(w).max() + floor,
                                   err_msg=name)


def test_hoisted_epilogue_matches_the_in_loop_run(monkeypatch):
    """``HOIST`` off runs the softmax projection inside the loop and the
    cost on probabilities (no '.logits' is exposed); the loss and every
    gradient agree with the hoisted run, fp32."""
    np_params, want_loss, _ = _jax_loss_and_grads(False)
    loss_h, grads_h, values_h = _torch_loss_and_grads(np_params, False)
    assert "dec_prob.logits" in values_h
    monkeypatch.setattr(RecurrentGroup, "HOIST", False)
    loss_l, grads_l, values_l = _torch_loss_and_grads(np_params, False)
    assert "dec_prob.logits" not in values_l
    np.testing.assert_allclose(loss_l, loss_h, rtol=1e-5)
    np.testing.assert_allclose(loss_h, want_loss, rtol=1e-5)
    for name, w in grads_h.items():
        np.testing.assert_allclose(grads_l[name], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-9,
                                   err_msg=name)


def test_adam_trajectory_matches_jax():
    """Three Adam steps (bench.py's optimizer) from the same carried
    params on one feed, fp32."""
    _set_both(use_bf16=False, bf16_activations=False)
    jtr = JTrainer(JNet(_jax_config(V, E, H)), opt_config=JOpt(**OPT),
                   seed=0)
    tnet = TNet(seq2seq_config(V, E, H))
    ttr = TTrainer(tnet, opt_config=TOpt(**OPT), seed=0, device="cpu")
    ttr.params = network_params_from_jax(
        {n: np.array(v) for n, v in jtr.params.items()}, tnet, "cpu")
    arrays = _feed_arrays(seed=3)
    for step in range(3):
        want = float(jtr.train_one_batch(_jfeed(*arrays)))
        got = float(ttr.train_one_batch(_tfeed(*arrays)))
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"loss of step {step}")
    assert ttr.samples_seen == 3 * B
    for name, p in jtr.params.items():
        np.testing.assert_allclose(ttr.params[name].numpy(), np.asarray(p),
                                   rtol=0, atol=1e-5, err_msg=name)


# ------------------------------------------------------------ refusals
def test_generating_groups_are_refused():
    """A beam-search (generating) group is refused at build time."""
    cfg = seq2seq_config(V, E, H)
    cfg.sub_models[1].is_generating = True
    with pytest.raises(PaddleTpuError, match="generating group"):
        TNet(cfg)


def test_nested_groups_are_refused():
    """A group whose in-link reads a nested-sequence data layer steps
    over subsequences (``_run_nested``): refused at build time."""
    cfg = seq2seq_config(V, E, H)
    cfg.layer_map()["target"].attrs["seq_level"] = 2
    with pytest.raises(PaddleTpuError, match="nested group"):
        TNet(cfg)
