"""The port's sequence layers, ops and helpers (``paddle_tpu_torch/
layers/seq.py``, ``ops/sequence_ops.py``, ``core/sequence.py``) against
the JAX package's, on the CPU.

The fifteen newly ported types run the JAX sweep's own case
(``test_layer_grad_sweep.CASES``) through both packages
(``test_torch_dense_layers.check_parity``: output and readout gradients
within rtol 1e-5, atol 1e-6 · max(1, max|ref|)); the types with an
integer or nested output are compared forward only, ids exactly.  The
ops take ragged inputs with an empty sequence; the pooling layers run
strided and over nested sequences for every pool type.

Pinned where the port copies the JAX package rather than the reference
(ROADMAP queue C): the strided and nested pooling paths return without
the layer's activation; an unknown ``average_strategy`` reads as
``average``; an empty sequence max-pools to −inf (the JAX op's
``where(denom > 0, …)`` never fires: its comment says 0), on the flat,
strided and nested paths alike (fault C7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_layer_grad_sweep as sweep
from layer_grad_util import build_single_layer_net
from paddle_tpu.core import sequence as jseq
from paddle_tpu.ops import sequence_ops as jops
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.core import sequence as tseq
from paddle_tpu_torch.ops import sequence_ops as tops
from paddle_tpu_torch.ops.registry import OPS as TOPS
from test_torch_dense_layers import (check_parity, close, numpy_feed,
                                     port_net)

#: the sweep's cases of the newly ported types, by how they compare
GRAD_TYPES = ["max", "seqfirstins", "seqconcat", "seqreshape", "seq_slice",
              "subseq", "row_conv", "get_output", "gather_agent",
              "scatter_agent"]
INT_TYPES = ["kmax_seq_score", "maxid", "eos_id"]
#: every type this file holds (the closure test reads it); sampling_id
#: is in test_torch_sampled_layers.py
SEQ_TYPES = GRAD_TYPES + INT_TYPES + ["sub_nested_seq", "sampling_id"]
POOLS = [("average", {}), ("average", {"average_strategy": "sum"}),
         ("average", {"average_strategy": "squarerootn"}), ("max", {}),
         ("seqlastins", {}), ("seqfirstins", {})]
LENS = [5, 0, 3, 7]                  # ragged, with an empty sequence


def _ragged(lens=LENS, d=3, seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(n, d).astype(np.float32) for n in lens]


def _both(rows, **kw):
    return jseq.pad_batch(rows, **kw), tseq.pad_batch(rows, **kw)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same_seq(t, j, what, exact=False):
    np.testing.assert_array_equal(_np(t.length), np.asarray(j.length),
                                  err_msg=what)
    if exact:
        np.testing.assert_array_equal(_np(t.data), np.asarray(j.data),
                                      err_msg=what)
    else:
        close(_np(t.data), np.asarray(j.data), what)


def close_inf(got, want, what):
    """``close`` on the finite values; the infinities at the same places
    with the same sign."""
    got, want = np.asarray(got), np.asarray(want)
    for test in (np.isneginf, np.isposinf, np.isnan):
        np.testing.assert_array_equal(test(got), test(want), err_msg=what)
    fin = np.isfinite(want)
    close(got[fin], want[fin], what)


def _forward_both(jnet, np_feed):
    from test_torch_dense_layers import carried_params, jax_feed, torch_feed
    tnet = port_net(jnet)
    jparams, tparams = carried_params(jnet, tnet)
    jv, _ = jnet.forward(jparams, jax_feed(np_feed), is_training=False)
    with torch.no_grad():
        tv, _ = tnet.forward(tparams, torch_feed(np_feed), is_training=False)
    return tv["test"], jv["test"]


# ------------------------------------------------------ the sweep's cases
@pytest.mark.parametrize("name", GRAD_TYPES)
def test_sweep_case_matches_jax(name):
    kwargs, feed_fn, _ = sweep.CASES[name]
    check_parity(build_single_layer_net(name, **kwargs),
                 numpy_feed(feed_fn()))


@pytest.mark.parametrize("name", INT_TYPES)
def test_integer_output_matches_jax(name):
    kwargs, feed_fn, _ = sweep.CASES[name]
    got, want = _forward_both(build_single_layer_net(name, **kwargs),
                              numpy_feed(feed_fn()))
    if isinstance(want, jseq.SequenceBatch):
        _same_seq(got, want, name, exact=True)
    else:
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_sub_nested_seq_matches_jax():
    kwargs, feed_fn, _ = sweep.CASES["sub_nested_seq"]
    jnet = build_single_layer_net("sub_nested_seq", **kwargs)
    feed = feed_fn()
    nested = feed["in0"]
    tnet = port_net(jnet)
    want, _ = jnet.forward({}, feed, is_training=False)
    got, _ = tnet.forward({}, {
        "in0": tseq.NestedSequenceBatch(
            torch.from_numpy(np.array(nested.data)),
            torch.from_numpy(np.array(nested.num_subseq)),
            torch.from_numpy(np.array(nested.sub_length))),
        "in1": torch.from_numpy(np.array(feed["in1"]))},
        is_training=False)
    got, want = got["test"], want["test"]
    assert isinstance(got, tseq.NestedSequenceBatch)
    for f in ("data", "num_subseq", "sub_length"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)


# ---------------------------------------------------- pooling paths
def _valid_step_parity(jnet, np_feed):
    """Output and input gradient of a readout over the valid steps only
    (``where``, not a product: a JAX max pool of a window past the end
    is -inf, which a product with the mask turns into NaN)."""
    data, lens = np_feed["in0"]

    def jobj(d):
        out = jnet.forward({}, {"in0": jseq.SequenceBatch(
            d, jnp.asarray(lens))}, is_training=False)[0]["test"]
        m = out.bool_mask()[..., None]
        v = jnp.where(m, out.data, 0.0)
        return jnp.sum(v * jnp.cos(0.1 * jnp.arange(v.size).reshape(
            v.shape))), out
    (jval, jout), jg = jax.value_and_grad(jobj, has_aux=True)(
        jnp.asarray(data))
    tnet = port_net(jnet)
    d = torch.from_numpy(data.copy()).requires_grad_(True)
    out = tnet.forward({}, {"in0": tseq.SequenceBatch(
        d, torch.from_numpy(lens.copy()))}, is_training=False)[0]["test"]
    v = torch.where(out.bool_mask()[..., None], out.data, 0.0)
    tval = torch.sum(v * torch.cos(0.1 * torch.arange(
        v.numel(), dtype=v.dtype).reshape(v.shape)))
    tg, = torch.autograd.grad(tval, [d])
    _same_seq(out.with_data(v.detach()), jout.with_data(
        jnp.where(jout.bool_mask()[..., None], jout.data, 0.0)), "output")
    close(float(tval.detach()), float(jval), "objective")
    close(_np(tg), np.asarray(jg), "input gradient")


def _pool_net(ltype, attrs, act="tanh"):
    return build_single_layer_net(ltype, size=3, input_sizes=[3],
                                  active_type=act, attrs=attrs)


@pytest.mark.parametrize("ltype,attrs", POOLS)
def test_strided_pooling_matches_jax_without_activation(ltype, attrs):
    """Strided pooling (windows of 3 steps, a shorter sequence): equal to
    JAX, which applies no activation on this path (its tanh would change
    every value here), and to the flat pool of each window."""
    rows = [r[:n] for r, n in zip(_ragged([5, 3, 7, 1], seed=1),
                                  [5, 3, 7, 1])]
    jnet = _pool_net(ltype, dict(attrs, stride=3))
    feed = numpy_feed({"in0": jseq.pad_batch(rows)})
    _valid_step_parity(jnet, feed)
    got, want = _forward_both(jnet, feed)
    plain = tops.sequence_pool(
        tseq.pad_batch([r[3:6] for r in rows], max_len=3),
        {"average": {"sum": "sum", "squarerootn": "sqrt"}.get(
            attrs.get("average_strategy"), "average"), "max": "max",
         "seqlastins": "last", "seqfirstins": "first"}[ltype])
    valid = np.asarray([len(r) > 3 for r in rows])
    close(_np(got.data)[valid, 1], _np(plain)[valid], "window 1, no tanh")
    np.testing.assert_array_equal(_np(got.length), [2, 1, 3, 1])
    # every window, those past the end too (the max pool's -inf, C7)
    close_inf(_np(got.data), np.asarray(want.data), "every window")


@pytest.mark.parametrize("ltype,attrs", POOLS)
def test_nested_pooling_matches_jax_without_activation(ltype, attrs):
    """Pooling a nested sequence: one vector per subsequence, equal to
    JAX's and to the untransformed pool (no tanh, as in JAX)."""
    r = np.random.RandomState(2)
    nested = [[r.randn(n, 3).astype(np.float32) for n in sub]
              for sub in ([2, 4, 1], [3], [1, 2])]
    jn = jseq.pad_nested_batch(nested)
    tn = tseq.pad_nested_batch(nested)
    jnet = _pool_net(ltype, attrs)
    tnet = port_net(jnet)
    want, _ = jnet.forward({}, {"in0": jn}, is_training=False)
    got, _ = tnet.forward({}, {"in0": tn}, is_training=False)
    mask = _np(tn.subseq_mask()) > 0
    np.testing.assert_array_equal(_np(got["test"].length),
                                  np.asarray(want["test"].length))
    # every slot, the empty ones too: a max pool gives -inf there in
    # both packages (C7)
    close_inf(_np(got["test"].data), np.asarray(want["test"].data), ltype)
    flat = tops.sequence_pool(tn.flatten_to_subseq(), tnet.layers[
        "test"].pool_type).reshape(3, 3, 3)
    close(_np(got["test"].data)[mask], _np(flat)[mask], "no tanh")


@pytest.mark.parametrize("ltype,attrs", POOLS)
def test_flat_pooling_applies_the_activation(ltype, attrs):
    rows = _ragged([4, 2, 3], seed=3)
    check_parity(_pool_net(ltype, attrs), numpy_feed(
        {"in0": jseq.pad_batch(rows)}))


def test_unknown_average_strategy_reads_as_average_like_jax():
    rows = _ragged([4, 2, 3], seed=4)
    feed = numpy_feed({"in0": jseq.pad_batch(rows)})
    got, want = _forward_both(_pool_net("average", {
        "average_strategy": "no-such-strategy"}, act=""), feed)
    close(_np(got), np.asarray(want), "unknown strategy")
    mean = np.stack([r.mean(0) for r in rows])
    close(_np(got), mean, "the average")


def test_expand_over_a_nested_template_matches_jax():
    r = np.random.RandomState(5)
    nested = [[r.randn(n, 2).astype(np.float32) for n in sub]
              for sub in ([2, 1], [3, 1, 2])]
    x = r.randn(2, 3).astype(np.float32)
    jnet = build_single_layer_net("expand", size=3, input_sizes=[3, 2])
    tnet = port_net(jnet)
    want, _ = jnet.forward({}, {"in0": jnp.asarray(x),
                                "in1": jseq.pad_nested_batch(nested)},
                           is_training=False)
    got, _ = tnet.forward({}, {"in0": torch.from_numpy(x),
                               "in1": tseq.pad_nested_batch(nested)},
                          is_training=False)
    _same_seq(got["test"], want["test"], "expand", exact=True)


# ------------------------------------------------------------ the ops
def _seq_pair(lens=LENS, d=3, seed=0):
    return _both(_ragged(lens, d, seed))


@pytest.mark.parametrize("pool", ["average", "sum", "sqrt", "max", "last",
                                  "first"])
def test_sequence_pool_matches_jax(pool):
    j, t = _seq_pair()
    want = np.asarray(jops.sequence_pool(j, pool))
    got = _np(tops.sequence_pool(t, pool))
    nonempty = np.asarray(LENS) > 0
    close(got[nonempty], want[nonempty], pool)
    # the empty sequence: equal to the JAX op, -inf for max (C7)
    close_inf(got[~nonempty], want[~nonempty], pool + " (empty)")
    if pool == "max":
        assert np.isneginf(got[~nonempty]).all()


def test_sequence_concat_slice_reshape_match_jax():
    ja, ta = _seq_pair(seed=1)
    jb, tb = _seq_pair([2, 3, 0, 1], seed=2)
    _same_seq(tops.sequence_concat(ta, tb), jops.sequence_concat(ja, jb),
              "concat")
    off = np.asarray([1, 0, 2, 3], np.int32)
    size = np.asarray([3, 1, 4, 2], np.int32)
    _same_seq(tops.sequence_slice(ta, torch.from_numpy(off),
                                  torch.from_numpy(size)),
              jops.sequence_slice(ja, off, size), "slice")
    _same_seq(tops.sequence_slice(ta, 1, 2), jops.sequence_slice(ja, 1, 2),
              "slice, scalars")
    _same_seq(tops.sub_seq(ta, torch.from_numpy(off),
                           torch.from_numpy(size)),
              jops.sub_seq(ja, off, size), "sub_seq")
    jr, tr = _both(_ragged([4, 0, 2], d=4, seed=3))
    _same_seq(tops.sequence_reshape(tr, 2), jops.sequence_reshape(jr, 2),
              "reshape")


def test_sequence_conv_row_conv_and_instances_match_jax():
    j, t = _seq_pair(seed=4)
    r = np.random.RandomState(6)
    w = r.randn(9, 5).astype(np.float32)
    _same_seq(tops.sequence_conv(t, torch.from_numpy(w), -1, 3),
              jops.sequence_conv(j, jnp.asarray(w), -1, 3), "sequence_conv")
    wr = r.randn(3, 3).astype(np.float32)
    _same_seq(tops.row_conv(t, torch.from_numpy(wr)),
              jops.row_conv(j, jnp.asarray(wr)), "row_conv")
    close(_np(tops.sequence_last_instance(t)),
          np.asarray(jops.sequence_last_instance(j)), "last")
    close(_np(tops.sequence_first_instance(t)),
          np.asarray(jops.sequence_first_instance(j)), "first")
    x = r.randn(4, 6).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tops.max_id(torch.from_numpy(x), 3)),
        np.asarray(jops.max_id(jnp.asarray(x), 3)))


def test_sequence_op_gradients_match_jax():
    """Gradients of sum(out · cotangent) through concat, slice and
    row_conv in the sequence data and the weights."""
    rows_a, rows_b = _ragged(seed=7), _ragged([2, 3, 0, 1], seed=8)
    wr = np.random.RandomState(9).randn(3, 3).astype(np.float32)
    ja, jb = jseq.pad_batch(rows_a), jseq.pad_batch(rows_b)
    ta, tb = tseq.pad_batch(rows_a), tseq.pad_batch(rows_b)

    def jfn(da, db, w):
        a, b = ja.with_data(da), jb.with_data(db)
        c = jops.sequence_concat(a, b).data
        s = jops.sequence_slice(a, 1, 2).data
        rc = jops.row_conv(b, w).data
        return jnp.sum(c * jnp.cos(c)) + jnp.sum(s ** 2) + jnp.sum(rc * 0.3)

    gj = jax.grad(jfn, argnums=(0, 1, 2))(ja.data, jb.data, jnp.asarray(wr))
    da = ta.data.clone().requires_grad_(True)
    db = tb.data.clone().requires_grad_(True)
    w = torch.from_numpy(wr).requires_grad_(True)
    a, b = ta.with_data(da), tb.with_data(db)
    c = tops.sequence_concat(a, b).data
    s = tops.sequence_slice(a, 1, 2).data
    rc = tops.row_conv(b, w).data
    out = torch.sum(c * torch.cos(c)) + torch.sum(s ** 2) + torch.sum(rc * .3)
    gt = torch.autograd.grad(out, [da, db, w])
    for g, want, what in zip(gt, gj, ("a", "b", "w")):
        close(_np(g), np.asarray(want), "gradient of " + what)


def test_kmax_and_max_id_take_the_lower_index_among_ties():
    """Planted ties: lax.top_k puts the lower index first; so does the
    port (torch.topk promises no order)."""
    scores = np.array([[1, 3, 3, 0, 3, 2, 3, 3],
                       [2, 2, 2, 2, 2, 2, 2, 2],
                       [0, 5, 1, 5, 1, 5, 1, 5]], np.float32)[..., None]
    lens = np.array([8, 6, 7], np.int32)
    j = jseq.SequenceBatch(jnp.asarray(scores), jnp.asarray(lens))
    t = tseq.SequenceBatch(torch.from_numpy(scores), torch.from_numpy(lens))
    for k in (1, 2, 3, 5):
        want = np.asarray(jops.kmax_seq_score(j, k))
        np.testing.assert_array_equal(_np(tops.kmax_seq_score(t, k)), want)
    np.testing.assert_array_equal(
        _np(tops.kmax_seq_score(t, 3)), [[1, 2, 4], [0, 1, 2], [1, 3, 5]])
    x = scores[..., 0]
    for k in (1, 2, 4):
        np.testing.assert_array_equal(
            _np(tops.max_id(torch.from_numpy(x), k)),
            np.asarray(jops.max_id(jnp.asarray(x), k)))
    # a larger row with many ties, through the layer's op
    r = np.random.RandomState(10)
    x = r.randint(0, 3, (16, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tops.max_id(torch.from_numpy(x), 7)),
        np.asarray(jops.max_id(jnp.asarray(x), 7)))


def test_sequence_ops_are_registered_under_the_jax_names():
    def names(registry):
        ents = {n for n, d in registry._entries.items()
                if d.fn.__module__.rsplit(".", 1)[-1] == "sequence_ops"}
        return ents, {a: n for a, n in registry._aliases.items()
                      if n in ents}
    assert names(TOPS) == names(JOPS)
    assert len(names(TOPS)[0]) == 13


# --------------------------------------------------- core/sequence.py
def test_nested_batch_and_its_masks_match_jax():
    r = np.random.RandomState(11)
    nested = [[r.randn(n, 2).astype(np.float32) for n in sub]
              for sub in ([3, 1], [], [2, 5, 1])]
    j = jseq.pad_nested_batch(nested)
    t = tseq.pad_nested_batch(nested)
    for f in ("data", "num_subseq", "sub_length"):
        np.testing.assert_array_equal(_np(getattr(t, f)),
                                      np.asarray(getattr(j, f)), f)
    np.testing.assert_array_equal(_np(t.subseq_mask()),
                                  np.asarray(j.subseq_mask()))
    np.testing.assert_array_equal(_np(t.token_mask()),
                                  np.asarray(j.token_mask()))
    _same_seq(t.flatten_to_subseq(), j.flatten_to_subseq(), "flatten",
              exact=True)
    _same_seq(t.outer(), j.outer(), "outer", exact=True)
    assert t.batch_size == j.batch_size == 3
    j2 = jseq.pad_nested_batch(nested, max_sub=2, max_len=2)
    t2 = tseq.pad_nested_batch(nested, max_sub=2, max_len=2)
    np.testing.assert_array_equal(_np(t2.sub_length),
                                  np.asarray(j2.sub_length))
    np.testing.assert_array_equal(_np(t2.data), np.asarray(j2.data))
    moved = t.to("cpu")
    assert isinstance(moved, tseq.NestedSequenceBatch)
    x = torch.ones(3, 2)
    assert tseq.value_of(t) is t.data
    assert isinstance(tseq.like(t, t.data * 2), tseq.NestedSequenceBatch)
    assert tseq.like(x, x) is x


def test_sequence_batch_helpers_and_lod_match_jax():
    rows = _ragged([4, 0, 2, 5], seed=12)
    j, t = _both(rows)
    close(_np(t.masked_data(-1.0)), np.asarray(j.masked_data(-1.0)),
          "masked_data")
    assert int(t.total_tokens()) == int(j.total_tokens()) == 11
    assert t.batch_size == j.batch_size == 4
    close(_np(t.first_valid()), np.asarray(j.first_valid()), "first")
    offs = [0, 4, 4, 6, 11]
    np.testing.assert_array_equal(tseq.lod_to_lengths(offs),
                                  jseq.lod_to_lengths(offs))
    np.testing.assert_array_equal(tseq.lengths_to_lod([4, 0, 2, 5]),
                                  jseq.lengths_to_lod([4, 0, 2, 5]))
    flat = np.concatenate(rows)
    _same_seq(tseq.flat_to_padded(flat, offs), jseq.flat_to_padded(flat, offs),
              "flat_to_padded", exact=True)
    tf, toffs = tseq.padded_to_flat(t)
    jf, joffs = jseq.padded_to_flat(j)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(toffs, joffs)
    with pytest.raises(Exception, match="start at 0"):
        tseq.lod_to_lengths([1, 3])
