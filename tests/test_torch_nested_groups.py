"""Nested recurrent groups and sub-sequence feeds in the port
(``RecurrentGroup._run_nested``, ``DataFeeder``'s ``seq_level`` 2)
against the JAX package's, on the CPU.

The two cases of ``tests/test_nested_recurrent.py`` at its sizes (B 3,
S 4, T 6): a group stepping over subsequences, whose step runs an inner
``recurrent`` and takes its ``last_seq``, equals the JAX group in
outputs and in every parameter's gradient, and equals the flat net
over the same subsequences (the reference's defining test); a memory
carried across subsequences.  Also: a reversed group, a sequence-valued
out-link (a nested batch back), an empty subsequence and a slot empty
in every row, the outer mask keeping a memory, and the feeder's nested
batches for index and dense kinds.  Both DSLs build each config, with
equal ``to_json()``.

Tolerance (fp32): rtol 1e-5, atol 1e-6 · max(1, max|ref|); lengths and
ids exact.  ~20 s alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.sequence import NestedSequenceBatch as JNested
from paddle_tpu.data import feeder as jfeeder
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.sequence import NestedSequenceBatch as TNested
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.data import feeder as tfeeder
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax
from test_torch_dense_layers import close

F, H = 5, 7
B, S, T = 3, 4, 6


# ------------------------------------------------------------ configs
def _nested(d, reverse=False, seq_out=False):
    x = d.data("x", jfeeder.dense_vector(F) if d is jdsl
               else tfeeder.dense_vector(F))

    def step(frame):
        h = d.fc(frame, size=H, name="proj", act=d.TanhActivation())
        r = d.recurrent(h, name="inner")
        return r if seq_out else d.last_seq(r, name="sub_state")

    out = d.recurrent_group(step, [d.StepInput(x)], name="outer",
                            reverse=reverse)
    return d.topology(out)


def _flat(d):
    x = d.data("x", jfeeder.dense_vector(F) if d is jdsl
               else tfeeder.dense_vector(F))
    h = d.fc(x, size=H, name="proj", act=d.TanhActivation())
    r = d.recurrent(h, name="inner")
    return d.topology(d.last_seq(r, name="sub_state"))


def _memory(d):
    x = d.data("x", jfeeder.dense_vector(F) if d is jdsl
               else tfeeder.dense_vector(F))

    def step(frame):
        pooled = d.pooling(frame, pooling_type=d.SumPooling(),
                           name="sub_sum")
        mem = d.memory(name="acc", size=F)
        return d.addto([pooled, mem.out], name="acc")

    return d.topology(d.recurrent_group(step, [d.StepInput(x)],
                                        name="outer"))


def _both(make, **kw):
    """(JAX net, port net) of one config function ``make`` through both
    DSLs, whose configs must be equal."""
    with jdsl.config_scope():
        jcfg = make(jdsl, **kw)
    with tdsl.config_scope():
        tcfg = make(tdsl, **kw)
    assert tcfg.to_json() == jcfg.to_json()
    return JNet(jcfg), TNet(tcfg)


def _batch(seed=0, num_subseq=(4, 2, 3), s=S, empty=()):
    """A nested batch of B rows (numpy): random lengths in [1, T], those
    at ``empty`` (row, slot) set to 0."""
    r = np.random.RandomState(seed)
    data = r.randn(B, s, T, F).astype(np.float32)
    sub = r.randint(1, T + 1, size=(B, s)).astype(np.int32)
    for i, j in empty:
        sub[i, j] = 0
    return data, np.asarray(num_subseq, np.int32), sub


def _tnested(data, n, sub):
    return TNested(torch.from_numpy(data.copy()), torch.from_numpy(n),
                   torch.from_numpy(sub))


def _params(jnet, tnet, seed=4):
    jp = jnet.init_params(seed=seed)
    jp = {k: v + 0.05 * jnp.asarray(np.random.RandomState(1).randn(
        *v.shape), jnp.float32) for k, v in jp.items()}
    return jp, network_params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()}, tnet, "cpu")


def _readout(shape, valid):
    return np.cos(0.1 * np.arange(np.prod(shape))).reshape(shape) \
        * valid.reshape(valid.shape + (1,) * (len(shape) - valid.ndim))


def _parity(jnet, tnet, batch, out="sub_state"):
    """Forward value of ``out`` and the gradient of a ramp readout over
    its valid places in every parameter and in the input: JAX against
    the port.  Returns the port's value, gradients and parameters."""
    data, n, sub = batch
    jp, tp = _params(jnet, tnet)
    svalid = np.arange(data.shape[1])[None] < n[:, None]       # [B, S]
    tvalid = (np.arange(T)[None, None] < sub[..., None]) & svalid[..., None]

    def readout(v):
        return _readout(tuple(v.data.shape),
                        tvalid if v.data.ndim == 4 else svalid)

    def jobj(p, x):
        v = jnet.forward(p, {"x": JNested(x, jnp.asarray(n),
                                          jnp.asarray(sub))},
                         is_training=False)[0][out]
        w = readout(v)
        return jnp.sum(jnp.where(jnp.asarray(w) != 0, v.data, 0.0) * w), v
    (_, jv), (jg, jgx) = jax.value_and_grad(jobj, argnums=(0, 1),
                                            has_aux=True)(
        jp, jnp.asarray(data))
    jg = dict(jg, x=jgx)
    tp = {k: p.requires_grad_(True) for k, p in tp.items()}
    x = torch.from_numpy(data.copy()).requires_grad_(True)
    tv = tnet.forward(tp, {"x": TNested(x, torch.from_numpy(n),
                                        torch.from_numpy(sub))},
                      is_training=False)[0][out]
    w = torch.from_numpy(readout(jv))
    obj = torch.sum(torch.where(w != 0, tv.data, 0.0) * w)
    tg = dict(zip([*tp, "x"], torch.autograd.grad(
        obj, [*tp.values(), x])))
    assert type(tv).__name__ == type(jv).__name__
    for f in ("length", "num_subseq", "sub_length"):
        if hasattr(jv, f):
            np.testing.assert_array_equal(getattr(tv, f).numpy(),
                                          np.asarray(getattr(jv, f)), f)
    close(tv.data.detach().numpy(), jv.data, "value")
    assert set(tg) == set(jg)
    for k in jg:
        close(tg[k].numpy(), jg[k], f"gradient of {k}")
    return tv, tg, tp


# ------------------------------------------------------------ the cases
def test_nested_group_matches_jax_and_equals_flat():
    """``test_nested_recurrent.py``'s defining case: the port's nested
    group equals JAX's, and equals the port's flat net over the same
    subsequences in outputs and every gradient."""
    jnet, tnet = _both(_nested)
    batch = _batch()
    tv, tg, tp = _parity(jnet, tnet, batch)
    _, fnet = _both(_flat)
    flat = _tnested(*batch).flatten_to_subseq()
    fv = fnet.forward(tp, {"x": flat}, is_training=False)[0]["sub_state"]
    valid = (np.arange(S)[None] < batch[1][:, None])
    st = fv.reshape(B, S, H) * torch.from_numpy(valid)[..., None]
    close(tv.data.detach().numpy() * valid[..., None],
          st.detach().numpy(), "nested = flat")
    w = torch.from_numpy(_readout(tuple(st.shape), valid))
    fg = torch.autograd.grad(torch.sum(st * w), list(tp.values()))
    for k, g in zip(tp, fg):         # (the input's gradient is JAX's)
        close(tg[k].numpy(), g.numpy(), f"nested = flat: gradient of {k}")


def test_nested_memory_across_subsequences_matches_jax():
    """The accumulating memory of ``test_nested_recurrent.py``: equal to
    JAX and to the host's running sum of each subsequence's sum."""
    jnet, tnet = _both(_memory)
    batch = _batch(seed=1, num_subseq=(3, 4, 2))
    tv, _, _ = _parity(jnet, tnet, batch, out="acc")
    data, n, sub = batch
    tok = np.arange(T)[None, None] < sub[..., None]
    sums = np.cumsum((data * tok[..., None]).sum(2), 1)
    valid = (np.arange(S)[None] < n[:, None])[..., None]
    close(tv.data.detach().numpy() * valid, sums * valid, "running sum")


def test_reversed_nested_group_matches_jax():
    jnet, tnet = _both(_nested, reverse=True)
    _parity(jnet, tnet, _batch(seed=2))


def test_sequence_out_link_comes_back_nested_like_jax():
    """The step returns the inner recurrence's sequence: a nested batch
    back, its rows 0 in invalid slots, lengths as JAX's."""
    jnet, tnet = _both(_nested, seq_out=True)
    tv, _, _ = _parity(jnet, tnet, _batch(seed=3), out="inner")
    assert isinstance(tv, TNested)


def test_empty_subsequence_and_empty_slot_match_jax():
    """A valid subsequence of length 0, and a fifth slot that no row
    fills (every row empty there): the group runs every slot, as the JAX
    scan does; the outer mask keeps the memory."""
    data, n, sub = _batch(seed=5, num_subseq=(4, 1, 3), s=S + 1,
                          empty=[(0, 1), (2, 2)])
    for make, out in ((_nested, "sub_state"), (_memory, "acc")):
        jnet, tnet = _both(make)
        tv, _, _ = _parity(jnet, tnet, (data, n, sub), out=out)
        np.testing.assert_array_equal(tv.length.numpy(), n)
        assert (tv.data[:, S].detach().numpy() == 0).all()


def test_nested_frames_reach_the_step_as_sequences():
    """Each step's frame is the slot's SequenceBatch: an invalid slot's
    rows have length 0."""
    _, tnet = _both(_nested)
    group = tnet.groups["outer"]
    seen = []
    step = group.step

    def spy(params, frame, mems, outer, ctx, order=None):
        seen.append(frame["x"])
        return step(params, frame, mems, outer, ctx, order)
    group.step = spy
    data, n, sub = _batch()
    tnet.forward(tnet.init_params(0, "cpu"), {"x": _tnested(data, n, sub)},
                 is_training=False)
    assert len(seen) == S and all(isinstance(f, TSeq) for f in seen)
    for j, f in enumerate(seen):
        np.testing.assert_array_equal(f.length.numpy(),
                                      np.where(j < n, sub[:, j], 0))


# ------------------------------------------------------ sub-sequence feeds
@pytest.mark.parametrize("kind", ["index", "dense"])
def test_sub_sequence_feed_matches_jax(kind):
    r = np.random.RandomState(6)
    if kind == "index":
        feeding = "integer_value_sub_sequence", (30,)
        rows = [[list(r.randint(0, 30, n)) for n in sub]
                for sub in ([3, 1, 5], [2], [4, 9])]
    else:
        feeding = "dense_vector_sub_sequence", (3,)
        rows = [[r.randn(n, 3).astype(np.float32).tolist() for n in sub]
                for sub in ([2, 4], [1, 1, 3], [5])]
    batch = [(x, i) for i, x in enumerate(rows)]
    name, args = feeding
    jf = jfeeder.DataFeeder([("s", getattr(jfeeder, name)(*args)),
                             ("y", jfeeder.integer_value(3))])
    tf = tfeeder.DataFeeder([("s", getattr(tfeeder, name)(*args)),
                             ("y", tfeeder.integer_value(3))])
    want, got = jf.convert(batch)["s"], tf.convert(batch)["s"]
    assert isinstance(got, TNested)
    for f in ("data", "num_subseq", "sub_length"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
