"""The port's ``framework`` package (``paddle_tpu_torch/framework/``)
against the JAX package's, on the CPU.

Each program of ``tests/test_framework.py`` (fit a line, the MNIST MLP
and conv nets, StaticRNN forward and trained through, the inference
model's save and load) is built by the same calls in both packages; the
JAX startup program's values are carried into the port's scope by
``framework_scope_from_jax`` (parameters paired in
``Program.parameters()`` order: each package names variables from its
own counter).  Then N optimizer steps on the same feeds: every fetch
and every persistable after them within rtol 1e-4, atol 1e-4 (fp32; the
two packages round in other orders).  Also: the eight optimizers and
both regularizers, ``cond``, a directory written by either package's
``save_inference_model`` loaded into the other, ``append_backward``
against central differences, and the LSTM row's Fluid program
(``embedding`` → ``sequence_conv`` → ``lstm`` twice → ``sequence_pool``
→ ``fc`` → ``cross_entropy``, Adam) at B 8, T 6, V 50, E 8, H 8 (the
scan in both) and H 128 (the JAX Pallas LSTM in interpret mode, the
port's kernels' plain versions) with the same ``rnn_dispatch_total``
decisions as the JAX package; ``fc`` → ``lstm`` raises in both.
"""

import types

import numpy as np
import pytest
import torch

import paddle_tpu.framework as jfw
import paddle_tpu_torch.framework as tfw
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.framework import io as jio
from paddle_tpu.framework import layers as jlayers
from paddle_tpu.framework import nets as jnets
from paddle_tpu.framework import optimizer as jopt
from paddle_tpu.framework import regularizer as jreg
from paddle_tpu.framework.executor import Executor as JExecutor
from paddle_tpu.framework.executor import Scope as JScope
from paddle_tpu.ops import recurrent_ops as jro
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.framework import layers as tlayers
from paddle_tpu_torch.framework import nets as tnets
from paddle_tpu_torch.framework import optimizer as topt
from paddle_tpu_torch.framework import regularizer as treg
from paddle_tpu_torch.framework.executor import Executor as TExecutor
from paddle_tpu_torch.framework.executor import Scope as TScope
from paddle_tpu_torch.ops import recurrent_ops as tro
from paddle_tpu_torch.utils import PaddleTpuError
from paddle_tpu_torch.utils.jax_interop import framework_scope_from_jax

RTOL = ATOL = 1e-4

JAX = types.SimpleNamespace(fw=jfw, layers=jlayers, nets=jnets, opt=jopt,
                            reg=jreg, io=jio, Seq=JSeq, name="jax")
TORCH = types.SimpleNamespace(fw=tfw, layers=tlayers, nets=tnets, opt=topt,
                              reg=treg, io=tio, Seq=TSeq, name="torch")


def _seq(pkg, ids, lens):
    if pkg is JAX:
        import jax.numpy as jnp
        return JSeq(jnp.asarray(ids), jnp.asarray(lens, jnp.int32))
    return TSeq(torch.from_numpy(ids), torch.from_numpy(
        np.asarray(lens, np.int32)))


class Pair:
    """One program built by the same calls in both packages, the JAX
    startup values carried into the port's scope."""

    def __init__(self, build):
        self.prog, self.out = {}, {}
        for pkg in (JAX, TORCH):
            main, startup = pkg.fw.Program(), pkg.fw.Program()
            with pkg.fw.program_guard(main, startup):
                self.out[pkg.name] = build(pkg)
            self.prog[pkg.name] = (main, startup)
        self.jexe, self.jscope = JExecutor(), JScope()
        self.jexe.run(self.prog["jax"][1], scope=self.jscope)
        jmain = self.prog["jax"][0]
        values = {p.name: np.asarray(self.jscope.find(p.name))
                  for p in jmain.parameters()}
        self.texe = TExecutor(place="cpu")
        self.tscope = framework_scope_from_jax(
            values, jmain, self.prog["torch"][0], device="cpu")

    def run(self, feeds, fetch, **kw):
        """Both packages' fetches (lists of numpy arrays); ``feeds`` maps
        a package to its feed dict, ``fetch`` maps the package's build
        output to its fetch list."""
        j = self.jexe.run(self.prog["jax"][0], feed=feeds(JAX),
                          fetch_list=fetch(self.out["jax"]),
                          scope=self.jscope, **kw)
        t = self.texe.run(self.prog["torch"][0], feed=feeds(TORCH),
                          fetch_list=fetch(self.out["torch"]),
                          scope=self.tscope, **kw)
        return [np.asarray(a) for a in j], t

    def check_persistables(self):
        """Every parameter (optimizer state included), paired by order."""
        jp = self.prog["jax"][0].parameters()
        tp = self.prog["torch"][0].parameters()
        assert len(jp) == len(tp)
        for a, b in zip(jp, tp):
            want = np.asarray(self.jscope.find(a.name))
            got = self.tscope.find(b.name)
            assert got.grad_fn is None and not got.requires_grad, b.name
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=ATOL, err_msg=b.name)


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: fetch {i}")


# ------------------------------------------------------ the book programs
def _fit_a_line(pkg, optimizer=None):
    x = pkg.layers.data("x", shape=[13])
    y = pkg.layers.data("y", shape=[1])
    pred = pkg.layers.fc(x, size=1)
    cost = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    (optimizer or (lambda p: p.opt.SGDOptimizer(learning_rate=0.01)))(
        pkg).minimize(cost)
    return cost, pred


def test_fit_a_line_matches_jax():
    rng = np.random.RandomState(0)
    pair = Pair(_fit_a_line)
    w = rng.randn(13, 1).astype(np.float32)
    for _ in range(5):
        xb = rng.randn(32, 13).astype(np.float32)
        yb = xb @ w + 0.01 * rng.randn(32, 1).astype(np.float32)
        j, t = pair.run(lambda p: {"x": xb, "y": yb}, lambda o: [o[0], o[1]])
        _close(t, j, "fit_a_line")
    pair.check_persistables()


def _mlp(pkg):
    img = pkg.layers.data("img", shape=[64])
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    h = pkg.layers.fc(img, size=32, act="relu")
    pred = pkg.layers.fc(h, size=4, act="softmax")
    cost = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
    acc = pkg.fw.Accuracy(pred, label)
    pkg.opt.AdamOptimizer(learning_rate=0.01).minimize(cost)
    return cost, acc


def test_recognize_digits_mlp_matches_jax():
    rng = np.random.RandomState(1)
    pair = Pair(_mlp)
    protos = rng.randn(4, 64).astype(np.float32)
    for _ in range(5):
        lab = rng.randint(0, 4, (32, 1)).astype(np.int64)
        xb = protos[lab[:, 0]] + 0.4 * rng.randn(32, 64).astype(np.float32)
        j, t = pair.run(lambda p: {"img": xb, "label": lab},
                        lambda o: [o[0]] + o[1].metrics())
        _close(t, j, "mlp")
        for pkg, vals in (("jax", j), ("torch", t)):
            pair.out[pkg][1].update(vals[1], 32)
    pair.check_persistables()
    assert pair.out["torch"][1].eval() == pytest.approx(
        pair.out["jax"][1].eval(), abs=1e-6)


def _conv(pkg):
    im = pkg.layers.data("im", shape=[1, 8, 8])
    lb = pkg.layers.data("lb", shape=[1], dtype="int64")
    cp = pkg.nets.simple_img_conv_pool(im, num_filters=4, filter_size=3,
                                       pool_size=2, pool_stride=2,
                                       act="relu")
    bn = pkg.layers.batch_norm(cp)
    p2 = pkg.layers.fc(bn, size=2, act="softmax")
    c2 = pkg.layers.mean(pkg.layers.cross_entropy(p2, lb))
    pkg.opt.MomentumOptimizer(0.05, 0.9).minimize(c2)
    return c2, p2


def test_recognize_digits_conv_matches_jax():
    rng = np.random.RandomState(2)
    pair = Pair(_conv)
    for _ in range(4):
        lab = rng.randint(0, 2, (16, 1))
        xb = (lab[:, :, None, None]
              + 0.3 * rng.randn(16, 1, 8, 8)).astype(np.float32)
        j, t = pair.run(lambda p: {"im": xb, "lb": lab.astype(np.int64)},
                        lambda o: list(o))
        _close(t, j, "conv")
    pair.check_persistables()


def _cumsum_rnn(pkg):
    seq = pkg.layers.data("seq", shape=[5, 3])
    rnn = pkg.layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(seq)
        mem = rnn.memory(batch_ref=seq, shape=(-1, 3), init_value=0.0)
        nxt = pkg.layers.sums([xt, mem])
        rnn.update_memory(mem, nxt)
        rnn.output(nxt)
    return rnn()


def test_static_rnn_cumsum_matches_jax():
    pair = Pair(_cumsum_rnn)
    xb = np.arange(2 * 5 * 3).reshape(2, 5, 3).astype(np.float32)
    j, t = pair.run(lambda p: {"seq": xb}, lambda o: [o])
    np.testing.assert_allclose(t[0], np.cumsum(xb, axis=1), rtol=1e-6)
    _close(t, j, "cumsum")


def _rnn_trained(pkg):
    seq = pkg.layers.data("seq", shape=[4, 2])
    tgt = pkg.layers.data("tgt", shape=[3])
    rnn = pkg.layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(seq)
        mem = rnn.memory(batch_ref=seq, shape=(-1, 3), init_value=0.0)
        nxt = pkg.layers.fc([xt, mem], size=3, act="tanh")
        rnn.update_memory(mem, nxt)
        rnn.output(nxt)
    outs = rnn()
    last = pkg.layers.reshape(outs, [-1, 4 * 3])
    pred = pkg.layers.fc(last, size=3)
    cost = pkg.layers.mean(pkg.layers.square_error_cost(pred, tgt))
    pkg.opt.SGDOptimizer(learning_rate=0.1).minimize(cost)
    return cost, outs


def test_static_rnn_trained_through_matches_jax():
    rng = np.random.RandomState(3)
    pair = Pair(_rnn_trained)
    for _ in range(5):
        xb = rng.randn(8, 4, 2).astype(np.float32)
        yb = np.tanh(xb.sum(1))[:, :1].repeat(3, 1).astype(np.float32)
        j, t = pair.run(lambda p: {"seq": xb, "tgt": yb},
                        lambda o: list(o))
        _close(t, j, "static rnn")
    pair.check_persistables()


OPTIMIZERS = {
    "sgd": lambda p: p.opt.SGDOptimizer(learning_rate=0.05),
    "momentum": lambda p: p.opt.MomentumOptimizer(0.02, 0.9),
    "nesterov": lambda p: p.opt.MomentumOptimizer(0.02, 0.9,
                                                  use_nesterov=True),
    "adagrad": lambda p: p.opt.AdagradOptimizer(learning_rate=0.1),
    "adam": lambda p: p.opt.AdamOptimizer(learning_rate=0.05),
    "adamax": lambda p: p.opt.AdamaxOptimizer(learning_rate=0.05),
    "adadelta": lambda p: p.opt.AdadeltaOptimizer(),
    "decayed_adagrad": lambda p: p.opt.DecayedAdagradOptimizer(
        learning_rate=0.1),
    "rmsprop": lambda p: p.opt.RMSPropOptimizer(learning_rate=0.01,
                                                momentum=0.5),
    "sgd_l2": lambda p: p.opt.SGDOptimizer(
        learning_rate=0.05, regularization=p.reg.L2Decay(0.1)),
    "momentum_l1": lambda p: p.opt.MomentumOptimizer(
        0.02, 0.9, regularization=p.reg.L1Decay(0.05)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_jax(name):
    """Three steps of each optimizer (and regularizer) on fit_a_line."""
    rng = np.random.RandomState(4)
    pair = Pair(lambda p: _fit_a_line(p, OPTIMIZERS[name]))
    for _ in range(3):
        xb = rng.randn(16, 13).astype(np.float32)
        yb = rng.randn(16, 1).astype(np.float32)
        j, t = pair.run(lambda p: {"x": xb, "y": yb}, lambda o: [o[0]])
        _close(t, j, name)
    pair.check_persistables()


def _cond(pkg):
    x = pkg.layers.data("x", shape=[3])
    pred = pkg.layers.data("pred", shape=[1])
    main = pkg.fw.default_main_program()
    blocks = []
    for scale in (2.0, -1.0):
        blk = main.create_block()
        with main.block_guard(blk):
            out = blk.create_var(name="cond_out", shape=(-1, 3))
            tmp = blk.create_var(name=f"cond_tmp_{len(blocks)}",
                                 shape=(-1, 3))
            blk.append_op("scale", inputs={"X": [x]},
                          outputs={"Out": [tmp]}, attrs={"scale": scale})
            blk.append_op("elementwise_add", inputs={"X": [tmp], "Y": [x]},
                          outputs={"Out": [out]})
        blocks.append(blk)
    gb = main.global_block
    out = gb.create_var(name="cond_out", shape=(-1, 3))
    gb.append_op("cond", inputs={"Cond": [pred]}, outputs={"Out": [out]},
                 attrs={"true_block": blocks[0].idx,
                        "false_block": blocks[1].idx})
    return out


def test_cond_matches_jax():
    pair = Pair(_cond)
    xb = np.arange(6, dtype=np.float32).reshape(2, 3)
    for p, want in ((1.0, 3 * xb), (-1.0, 0 * xb)):
        pb = np.full((2, 1), p, np.float32)
        j, t = pair.run(lambda _: {"x": xb, "pred": pb}, lambda o: [o])
        np.testing.assert_allclose(t[0], want, rtol=1e-6)
        _close(t, j, f"cond {p}")


# ------------------------------------------------------- save and load
def _softmax_fc(pkg):
    x = pkg.layers.data("x", shape=[6])
    return pkg.layers.fc(x, size=3, act="softmax")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_inference_model_loads_across_packages(tmp_path, writer):
    """A directory written by one package's ``save_inference_model``
    loads into the other's ``load_inference_model`` and gives the same
    output; the reverse too (for the fc net and the StaticRNN)."""
    rng = np.random.RandomState(5)
    for build, feed in ((_softmax_fc, {"x": rng.randn(4, 6).astype(
            np.float32)}), (_cumsum_rnn, {"seq": rng.randn(2, 5, 3).astype(
                np.float32)})):
        pair = Pair(build)
        j, t = pair.run(lambda p: feed, lambda o: [o], is_test=True)
        _close(t, j, "before save")
        d = tmp_path / f"{writer}_{build.__name__}"
        if writer == "jax":
            jio.save_inference_model(str(d), list(feed), [pair.out["jax"]],
                                     pair.jexe, main_program=pair.prog[
                                         "jax"][0], scope=pair.jscope)
            sc = TScope()
            prog, feeds, fetches = tio.load_inference_model(str(d),
                                                            pair.texe, sc)
            out = pair.texe.run(prog, feed=feed, fetch_list=fetches,
                                scope=sc, is_test=True)
            assert all(isinstance(v, torch.Tensor) for v in sc.vars.values())
        else:
            tio.save_inference_model(str(d), list(feed), [pair.out["torch"]],
                                     pair.texe, main_program=pair.prog[
                                         "torch"][0], scope=pair.tscope)
            sc = JScope()
            prog, feeds, fetches = jio.load_inference_model(str(d),
                                                            pair.jexe, sc)
            out = pair.jexe.run(prog, feed=feed, fetch_list=fetches,
                                scope=sc, is_test=True)
        assert feeds == list(feed)
        _close([np.asarray(out[0])], j, f"{writer} -> other")


def test_save_and_load_ops_and_persistables(tmp_path):
    """``save``/``load`` ops run on the host around the block, in npz;
    ``save_persistables``/``load_persistables`` round-trip onto the
    executor's device."""
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        out = _softmax_fc(TORCH)
    exe = TExecutor(place="cpu")
    sc = TScope()
    exe.run(startup, scope=sc)
    names = [p.name for p in main.parameters()]
    path = str(tmp_path / "ckpt" / "p.npz")
    saver = tfw.Program()
    saver.global_block.append_op("save", inputs={"X": names},
                                 attrs={"file_path": path})
    exe.run(saver, scope=sc)
    loader = tfw.Program()
    loader.global_block.append_op("load", outputs={"Out": names},
                                  attrs={"file_path": path})
    sc2 = TScope()
    exe.run(loader, scope=sc2)
    xb = np.ones((2, 6), np.float32)
    a, = exe.run(main, feed={"x": xb}, fetch_list=[out], scope=sc)
    b, = exe.run(main, feed={"x": xb}, fetch_list=[out], scope=sc2)
    np.testing.assert_array_equal(a, b)
    tio.save_persistables(exe, str(tmp_path / "pers"), main, sc)
    sc3 = TScope()
    tio.load_persistables(exe, str(tmp_path / "pers"), main, sc3)
    assert sorted(sc3.vars) == sorted(names)
    for n in names:
        assert torch.equal(sc3.find(n), sc.find(n))


# ------------------------------------------------------------ backward
def test_append_backward_matches_central_differences():
    """The ``@GRAD`` fetch of ``append_backward`` against central
    differences of the cost (the JAX framework test's check)."""
    rng = np.random.RandomState(6)
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        x = tlayers.data("x", shape=[5])
        y = tlayers.data("y", shape=[1])
        pred = tlayers.fc(x, size=1, bias_attr=False)
        cost = tlayers.mean(tlayers.square_error_cost(pred, y))
        grads = tfw.append_backward(cost)
    exe = TExecutor(place="cpu")
    scope = TScope()
    exe.run(startup, scope=scope)
    w_name, g_name = grads[0][0].name, grads[0][1].name
    xb = rng.randn(8, 5).astype(np.float32)
    yb = rng.randn(8, 1).astype(np.float32)
    g, = exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[g_name],
                 scope=scope)
    w0 = scope.find(w_name).numpy().copy()
    eps = 1e-3
    num = np.zeros_like(w0)
    for i in range(w0.shape[0]):
        for pm, sgn in ((eps, 1.0), (-eps, -1.0)):
            w = w0.copy()
            w[i, 0] += pm
            scope.set(w_name, torch.from_numpy(w))
            c, = exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[cost],
                         scope=scope)
            num[i, 0] += sgn * float(c)
    num /= 2 * eps
    np.testing.assert_allclose(g, num, rtol=1e-2, atol=1e-3)


def test_backward_gives_zeros_to_an_unreached_parameter():
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        x = tlayers.data("x", shape=[4])
        used = tlayers.fc(x, size=2)
        tlayers.fc(x, size=3)            # never reaches the cost
        cost = tlayers.mean(used)
        grads = tfw.append_backward(cost)
    exe = TExecutor(place="cpu")
    scope = TScope()
    exe.run(startup, scope=scope)
    outs = exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                   fetch_list=[g.name for _, g in grads], scope=scope)
    by_name = {p.name: o for (p, _), o in zip(grads, outs)}
    assert len(by_name) == 4
    unused = [n for n, g in by_name.items() if not g.any()]
    assert sorted(unused) == sorted(
        p.name for p, _ in grads if not p.name.startswith(
            used.name.split(".")[0]))
    assert len(unused) == 2


# ------------------------------------------------- the LSTM row's program
ROW = dict(B=8, T=6, V=50, E=8, H=8)


def _lstm_row(pkg, b=None, t=ROW["T"], v=ROW["V"], e=ROW["E"], h=ROW["H"]):
    words = pkg.layers.data("words", [t], "int64", lod_level=1)
    label = pkg.layers.data("label", [1], "int64")
    net = pkg.layers.embedding(words, [v, e])
    for _ in range(2):
        proj = pkg.layers.sequence_conv(net, 4 * h, filter_size=1)
        net, _ = pkg.layers.lstm(proj, h)
    last = pkg.layers.sequence_pool(net, "LAST")
    probs = pkg.layers.fc(last, 2, act="softmax")
    cost = pkg.layers.mean(pkg.layers.cross_entropy(probs, label))
    pkg.opt.AdamOptimizer(learning_rate=2e-3).minimize(cost)
    return cost, probs


def _row_feed(rng, b, t, v):
    ids = rng.randint(0, v, (b, t)).astype(np.int64)
    lens = rng.randint(t // 2, t + 1, (b,)).astype(np.int32)
    lab = rng.randint(0, 2, (b, 1)).astype(np.int64)
    return lambda pkg: {"words": _seq(pkg, ids, lens), "label": lab}


def _pruned_eval(pair, feed):
    """The port's and the JAX package's probabilities from the main
    program pruned to them (``is_test`` on the main program would still
    run the optimizer ops)."""
    out = {}
    for pkg, exe, scope in ((JAX, pair.jexe, pair.jscope),
                            (TORCH, pair.texe, pair.tscope)):
        probs = pair.out[pkg.name][1]
        prog = pair.prog[pkg.name][0].prune([probs.name])
        out[pkg.name] = [np.asarray(v) for v in exe.run(
            prog, feed=feed(pkg), fetch_list=[probs], scope=scope,
            is_test=True)]
    return out["torch"], out["jax"]


def _jax_rnn_decisions():
    from paddle_tpu.observe import counter
    return {(s["labels"]["kind"], s["labels"]["path"],
             s["labels"]["reason"]): s["value"]
            for s in counter("rnn_dispatch_total").samples()}


def test_lstm_row_program_matches_jax(monkeypatch):
    """Three Adam steps and an ``is_test`` run of the row's program: the
    costs, the probabilities and every persistable within 1e-4; the same
    ``rnn_dispatch_total`` decisions (the JAX counter ticks at trace
    time, the port's at each call: the labels are compared)."""
    monkeypatch.setattr(tro, "rnn_dispatch_total",
                        type(tro.rnn_dispatch_total)())
    before = _jax_rnn_decisions()
    rng = np.random.RandomState(7)
    pair = Pair(_lstm_row)
    for _ in range(3):
        feed = _row_feed(rng, ROW["B"], ROW["T"], ROW["V"])
        j, t = pair.run(feed, lambda o: list(o))
        _close(t, j, "lstm row")
    pair.check_persistables()
    _close(*_pruned_eval(pair, feed), "lstm row, is_test")
    jdec = {k for k, v in _jax_rnn_decisions().items()
            if v > before.get(k, 0.0)}
    tdec = set(tro.rnn_dispatch_total)
    assert tdec == jdec == {("lstm", "scan", jro._fallback_reason(
        ROW["B"], ROW["H"]))}
    # two lstm ops a run, three training runs and the pruned one
    assert sum(tro.rnn_dispatch_total.values()) == 8


def test_fc_into_lstm_raises_in_both_packages():
    """``mul`` returns a plain array, so ``fc`` → ``lstm`` is refused by
    the lstm op in both packages."""
    for pkg, exe in ((JAX, JExecutor()), (TORCH, TExecutor(place="cpu"))):
        main, startup = pkg.fw.Program(), pkg.fw.Program()
        with pkg.fw.program_guard(main, startup):
            words = pkg.layers.data("words", [4], "int64", lod_level=1)
            emb = pkg.layers.embedding(words, [20, 4])
            proj = pkg.layers.fc(emb, size=16, num_flatten_dims=2)
            hidden, _ = pkg.layers.lstm(proj, 4)
        scope = JScope() if pkg is JAX else TScope()
        exe.run(startup, scope=scope)
        ids = np.zeros((2, 4), np.int64)
        with pytest.raises(Exception, match="lstm op wants LoD input"):
            exe.run(main, feed={"words": _seq(pkg, ids, [4, 2])},
                    fetch_list=[hidden], scope=scope)


# ------------------------------------------------------------- devices
def test_executor_runs_on_cuda_by_default(monkeypatch):
    """``Executor()`` means CUDA and raises without it; the CPU runs only
    when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        TExecutor()
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        TExecutor(place="cuda")
    assert TExecutor(place="cpu").place.type == "cpu"


def test_feeds_keep_int64_and_narrow_float64():
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        ids = tlayers.data("ids", [3], "int64")
        x = tlayers.data("x", [2])
        y = tlayers.scale(x, 2.0)
    exe = TExecutor(place="cpu")
    got_ids, got_y = exe.run(main, feed={"ids": np.arange(6).reshape(2, 3),
                                         "x": np.ones((2, 2))},
                             fetch_list=[ids, y], scope=TScope(),
                             return_numpy=False)
    assert got_ids.dtype == torch.int64 and got_y.dtype == torch.float32


def test_framework_scope_from_jax_refuses_mismatches():
    pair = Pair(_softmax_fc)
    jmain, tmain = pair.prog["jax"][0], pair.prog["torch"][0]
    values = {p.name: np.asarray(pair.jscope.find(p.name))
              for p in jmain.parameters()}
    first = jmain.parameters()[0].name
    bad = dict(values, **{first: np.zeros((1, 1), np.float32)})
    with pytest.raises(PaddleTpuError, match="shape"):
        framework_scope_from_jax(bad, jmain, tmain, device="cpu")
    other = tfw.Program()
    with tfw.program_guard(other, tfw.Program()):
        _fit_a_line(TORCH)
    with pytest.raises(PaddleTpuError, match="parameters"):
        framework_scope_from_jax(values, jmain, other, device="cpu")


def test_lstm_row_program_fused_tier_matches_jax(monkeypatch):
    """The row's program at H 128: both packages send the shape to their
    fused LSTM (the JAX Pallas kernels in interpret mode, the port's
    kernels' plain versions on the CPU); one Adam step and an
    ``is_test`` run within 1e-4, the decisions ``fused``."""
    monkeypatch.setattr(tro, "rnn_dispatch_total",
                        type(tro.rnn_dispatch_total)())
    before = _jax_rnn_decisions()
    rng = np.random.RandomState(8)
    pair = Pair(lambda p: _lstm_row(p, h=128))
    feed = _row_feed(rng, ROW["B"], ROW["T"], ROW["V"])
    j, t = pair.run(feed, lambda o: list(o))
    _close(t, j, "lstm row at H 128")
    pair.check_persistables()
    _close(*_pruned_eval(pair, feed), "lstm row at H 128, is_test")
    jdec = {k for k, v in _jax_rnn_decisions().items()
            if v > before.get(k, 0.0)}
    assert set(tro.rnn_dispatch_total) == jdec == {("lstm", "fused", "")}


def test_random_op_in_a_static_rnn_draws_the_same_each_step():
    """A dropout inside a StaticRNN step draws one mask for every step in
    both packages (``lax.scan`` traces the step once; the port's loop
    reuses the step's op counters), and a new one the next run."""
    def build(pkg):
        seq = pkg.layers.data("seq", shape=[5, 64])
        rnn = pkg.layers.StaticRNN()
        with rnn.step():
            rnn.output(pkg.layers.dropout(rnn.step_input(seq), 0.5))
        return rnn()

    pair = Pair(build)
    xb = np.ones((4, 5, 64), np.float32)
    runs = [pair.run(lambda p: {"seq": xb}, lambda o: [o]) for _ in range(2)]
    for j, t in runs:
        for out in (j[0], t[0]):
            assert 0 < (out == 0).mean() < 1
            for step in range(1, 5):
                np.testing.assert_array_equal(out[:, step], out[:, 0])
    assert not np.array_equal(runs[0][1][0], runs[1][1][0])
