"""The port's ``recurrent``, ``lstm_step`` and ``mdlstmemory`` layers and
the ``recurrent_ops`` they run (``simple_rnn``, ``lstm_unit``) against
the JAX package's, on the CPU.

Each type runs the JAX sweep's own case (``test_layer_grad_sweep.CASES``)
through both packages with the JAX parameters carried into the port
(``test_torch_dense_layers.check_parity``: the output and the gradient
of the sweep's readout in every parameter and float input), plus a
reversed ``recurrent`` and ``mdlstmemory`` in its four directions, on a
non-square grid and on sequence input.  ``lstmemory_group`` built by
both DSLs exercises ``lstm_step`` with an h memory and a memory of its
``.state`` output.

Tolerance (fp32): rtol 1e-5, atol 1e-6 · max(1, max|ref|).  ~25 s
alone (most of it the JAX side's compiles; ``check_parity(jit=True)``
compiles each net whole).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_layer_grad_sweep as sweep
from layer_grad_util import build_single_layer_net
from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.data import feeder as jfeeder
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.ops import recurrent_ops as jrec
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.v2 import networks as jnets
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.data import feeder as tfeeder
from paddle_tpu_torch.ops import recurrent_ops as trec
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.v2 import networks as tnets
from test_torch_dense_layers import (carried_params, check_parity, close,
                                     jax_feed, numpy_feed, port_net,
                                     torch_feed)

#: the types this file holds (the closure test reads it)
RNN_TYPES = ["recurrent", "lstm_step", "mdlstmemory"]


@pytest.mark.parametrize("name", RNN_TYPES)
def test_sweep_case_matches_jax(name):
    kwargs, feed_fn, _ = sweep.CASES[name]
    check_parity(build_single_layer_net(name, **kwargs),
                 numpy_feed(feed_fn()), jit=True)


def _ragged(lens, d, seed, scale=0.5):
    r = np.random.RandomState(seed)
    data = np.zeros((len(lens), max(lens), d), np.float32)
    for i, n in enumerate(lens):
        data[i, :n] = r.uniform(-scale, scale, (n, d))
    return data, np.asarray(lens, np.int32)


@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_reversed_recurrent_matches_jax(act):
    net = build_single_layer_net("recurrent", size=4, input_sizes=[4],
                                 with_bias=True, active_type=act,
                                 attrs={"reversed": True})
    check_parity(net, {"in0": _ragged([5, 0, 3, 6], 4, 1)}, jit=True)


@pytest.mark.parametrize("directions", [[True, True], [False, True],
                                        [True, False], [False, False]])
def test_mdlstm_directions_match_jax(directions):
    """A 2×3 grid (not square), dense input, each walk direction."""
    net = build_single_layer_net(
        "mdlstmemory", size=2, input_sizes=[2 * 3 * 10], with_bias=True,
        attrs={"height": 2, "width": 3, "directions": directions})
    r = np.random.RandomState(4)
    check_parity(net, {"in0": r.uniform(-0.5, 0.5, (3, 60)).astype(
        np.float32)}, jit=True)


def test_mdlstm_sequence_input_and_no_bias_match_jax():
    net = build_single_layer_net(
        "mdlstmemory", size=3, input_sizes=[15], with_bias=False,
        attrs={"height": 3, "width": 2, "directions": [False, True]})
    r = np.random.RandomState(5)
    data = r.uniform(-0.5, 0.5, (2, 6, 15)).astype(np.float32)
    check_parity(net, {"in0": (data, np.array([6, 6], np.int32))},
                 jit=True)


def test_simple_rnn_op_matches_jax_with_boot_state():
    data, lens = _ragged([4, 1, 0], 3, 6)
    r = np.random.RandomState(7)
    w = r.randn(3, 3).astype(np.float32) * 0.5
    b = r.randn(3).astype(np.float32) * 0.1
    h0 = r.randn(3, 3).astype(np.float32)
    for reverse in (False, True):
        jo, jf = jrec.simple_rnn(JSeq(jnp.asarray(data), jnp.asarray(lens)),
                                 jnp.asarray(w), jnp.asarray(b),
                                 jnp.asarray(h0), reverse=reverse)
        to, tf = trec.simple_rnn(TSeq(torch.from_numpy(data),
                                      torch.from_numpy(lens)),
                                 torch.from_numpy(w), torch.from_numpy(b),
                                 torch.from_numpy(h0), reverse=reverse)
        close(to.data.numpy(), jo.data, f"outputs, reverse {reverse}")
        close(tf.numpy(), jf, f"final state, reverse {reverse}")


def test_lstm_unit_gate_order_matches_jax():
    """(i, f, o, j) with a forget bias: each quarter moved alone moves
    the same output in both packages; values and gradients equal."""
    r = np.random.RandomState(8)
    x = r.randn(3, 8).astype(np.float32)
    c = r.randn(3, 2).astype(np.float32)

    def jfn(x, c):
        cn, h = jrec.lstm_unit(x, c, forget_bias=0.7)
        return jnp.sum(cn * jnp.cos(jnp.arange(6.0).reshape(3, 2))
                       + 2.0 * h), (cn, h)

    (jv, (jc, jh)), (jgx, jgc) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(c))
    tx = torch.from_numpy(x).requires_grad_(True)
    tc = torch.from_numpy(c).requires_grad_(True)
    cn, h = trec.lstm_unit(tx, tc, forget_bias=0.7)
    tv = torch.sum(cn * torch.cos(torch.arange(6.0).reshape(3, 2))
                   + 2.0 * h)
    gx, gc = torch.autograd.grad(tv, [tx, tc])
    for got, want, what in ((cn, jc, "c"), (h, jh, "h"), (gx, jgx, "dx"),
                            (gc, jgc, "dc")):
        close(got.detach().numpy(), want, what)
    # the third quarter is the output gate: it leaves c alone
    x2 = x.copy()
    x2[:, 4:6] += 1.0
    c2, _ = trec.lstm_unit(torch.from_numpy(x2), torch.from_numpy(c),
                           forget_bias=0.7)
    np.testing.assert_array_equal(c2.numpy(), cn.detach().numpy())


def test_recurrent_ops_are_registered_under_the_jax_names():
    def names(registry):
        ents = {n for n, d in registry._entries.items()
                if d.fn.__module__.rsplit(".", 1)[-1] == "recurrent_ops"}
        return ents, {a: n for a, n in registry._aliases.items()
                      if n in ents}
    assert names(TOPS) == names(JOPS)
    assert names(TOPS)[0] == {"lstm", "gru", "recurrent", "lstm_unit",
                              "gru_unit"}
    assert TOPS.get("lstm_unit").n_outputs == 2


# ----------------------------------------------- lstmemory_group, both DSLs
def _lstm_group_config(d, f, n):
    with d.config_scope():
        s = d.data("s", f.dense_vector_sequence(8))
        g = n.lstmemory_group(s, size=2, name="lg", reverse=False)
        r = n.lstmemory_group(s, size=2, name="lr", reverse=True)
        return d.topology([d.last_seq(g), d.first_seq(r)])


def test_lstmemory_group_from_both_dsls_matches_jax():
    """``lstmemory_group``: a mixed input + recurrent projection into
    ``lstm_step`` with an h memory and a ``.state`` memory; the same
    config from both DSLs, the same outputs and gradients."""
    jcfg = _lstm_group_config(jdsl, jfeeder, jnets)
    tcfg = _lstm_group_config(tdsl, tfeeder, tnets)
    assert tcfg.to_json() == jcfg.to_json()
    types = {l.type for l in tcfg.layers}
    assert {"lstm_step", "mixed"} <= types
    jnet = JNet(jcfg)
    feed = {"s": _ragged([4, 2, 3], 8, 9)}
    tnet = port_net(jnet)
    jparams, tparams = carried_params(jnet, tnet)
    outs = jnet.config.output_layer_names
    jv, _ = jnet.forward(jparams, jax_feed(feed), is_training=False)
    tv, _ = tnet.forward(tparams, torch_feed(feed), is_training=False)
    for name in outs:
        close(tv[name].detach().numpy(), jv[name], name)

    def jobj(p):
        v, _ = jnet.forward(p, jax_feed(feed), is_training=False)
        return sum(jnp.sum(v[o] * (i + 1.5)) for i, o in enumerate(outs))
    jg = jax.grad(jobj)(jparams)
    tp = {k: v.requires_grad_(True) for k, v in tparams.items()}
    v, _ = tnet.forward(tp, torch_feed(feed), is_training=False)
    tval = sum(torch.sum(v[o] * (i + 1.5)) for i, o in enumerate(outs))
    tg = dict(zip(tp, torch.autograd.grad(tval, list(tp.values()))))
    assert set(tg) == set(jg)
    for k in jg:
        close(tg[k].numpy(), jg[k], f"gradient of {k}")
