"""The port's sequence costs (``paddle_tpu_torch/ops/crf_ops.py``, the
``crf``, ``crf_decoding``, ``ctc`` / ``warp_ctc`` and
``cross_entropy_over_beam`` layers) against the JAX package's, on the
CPU.

The CRF's NLL against the JAX op and against a brute-force sum over
every path (``tests/test_ops.py``'s template), with gradients; Viterbi
paths exactly equal, with planted ties and rows of length 0 and 1; CTC
against the JAX op (``optax.ctc_loss``) with repeated labels, ``blank``
2, ``norm_by_times`` and an impossible alignment (optax's finite
``log_epsilon`` loss and its gradient); the beam CE in its three
regimes (gold kept to the end, dropped at the first expansion, dropped
at a middle one).  The layers run the JAX sweep's cases
(``test_torch_dense_layers.check_parity``).

Tolerance (fp32): rtol 1e-5, atol 1e-6 · max(1, max|ref|); ids and
paths exact.  ~25 s alone (the JAX side jitted).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_layer_grad_sweep as sweep
from layer_grad_util import build_single_layer_net
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.ops import crf_ops as jcrf
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.ops import crf_ops as tcrf
from paddle_tpu_torch.ops.registry import OPS as TOPS
from test_torch_dense_layers import (carried_params, check_parity, close,
                                     jax_feed, numpy_feed, port_net,
                                     torch_feed)

#: the types this file holds (the closure test reads it)
COST_SEQ_TYPES = ["crf", "crf_decoding", "ctc", "warp_ctc",
                  "cross_entropy_over_beam"]


# ------------------------------------------------------------ helpers
def _ragged(lens, d, seed, t=None):
    r = np.random.RandomState(seed)
    data = np.zeros((len(lens), t or max(lens), d), np.float32)
    for i, n in enumerate(lens):
        data[i, :n] = r.randn(n, d)
    return data, np.asarray(lens, np.int32)


def _op_parity(jfn, tfn, arrays, grads):
    """``jfn`` / ``tfn`` of the same numpy arrays (those in ``grads``
    differentiated) → both values and the gradients of their sum against
    a ramp, compared; the JAX side jitted."""

    def jobj(*g):
        out = jfn(**dict(arrays, **dict(zip(grads, g))))
        r = jnp.cos(0.3 * jnp.arange(out.size)).reshape(out.shape)
        return jnp.sum(out * r), out
    (_, jout), jg = jax.jit(jax.value_and_grad(jobj, argnums=tuple(
        range(len(grads))), has_aux=True))(*[jnp.asarray(arrays[k])
                                            for k in grads])
    leaves = {k: torch.from_numpy(arrays[k].copy()).requires_grad_(True)
              for k in grads}
    tout = tfn(**dict(arrays, **leaves))
    ramp = torch.cos(0.3 * torch.arange(tout.numel(), dtype=torch.float32))
    tg = torch.autograd.grad(torch.sum(tout * ramp.reshape(tout.shape)),
                             list(leaves.values()))
    close(tout.detach().numpy(), jout, "value")
    for k, a, b in zip(grads, tg, jg):
        close(a.numpy(), b, f"gradient of {k}")
    return tout.detach().numpy()


def _seqs(data, lens):
    return (JSeq(jnp.asarray(data), jnp.asarray(lens)),
            TSeq(torch.as_tensor(data), torch.from_numpy(lens)))


# ---------------------------------------------------------------- CRF
def test_crf_nll_matches_jax_and_brute_force():
    n, t = 3, 4
    x, lens = _ragged([4, 1, 0, 3], n, 0)
    r = np.random.RandomState(1)
    w = r.randn(n + 2, n).astype(np.float32)
    tags = r.randint(0, n, (4, t)).astype(np.int32)

    def jfn(x, w, tags, lens):
        return jcrf.crf_nll(JSeq(x, jnp.asarray(lens)),
                            JSeq(jnp.asarray(tags), jnp.asarray(lens)), w)

    def tfn(x, w, tags, lens):
        return tcrf.crf_nll(TSeq(x, torch.from_numpy(lens)),
                            TSeq(torch.from_numpy(tags),
                                 torch.from_numpy(lens)), w)
    got = _op_parity(jfn, tfn, {"x": x, "w": w, "tags": tags, "lens": lens},
                     ["x", "w"])
    a, b, trans = w[0], w[1], w[2:]
    for row, m in enumerate(lens):
        m = max(int(m), 1)      # step 0 enters every row, as in JAX

        def score(path):
            s = a[path[0]] + x[row, 0, path[0]]
            for i in range(1, m):
                s += trans[path[i - 1], path[i]] + x[row, i, path[i]]
            return s + b[path[-1]]
        paths = list(itertools.product(range(n), repeat=m))
        logz = np.log(np.sum(np.exp([score(p) for p in paths])))
        close(got[row], logz - score(tags[row, :m]), f"brute force {row}")
        if lens[row] > 0:
            best = max(paths, key=score)
            dec = tcrf.crf_decode(TSeq(torch.from_numpy(x),
                                       torch.from_numpy(lens)),
                                  torch.from_numpy(w))
            np.testing.assert_array_equal(dec.data.numpy()[row, :m], best)


def test_crf_label_buffer_shorter_than_the_emissions_matches_jax():
    x, lens = _ragged([5, 3], 4, 2)
    w = np.random.RandomState(3).randn(6, 4).astype(np.float32)
    tags = np.array([[1, 2, 3], [0, 0, 1]], np.int32)
    j = jcrf.crf_nll(JSeq(jnp.asarray(x), jnp.asarray(lens)),
                     JSeq(jnp.asarray(tags), jnp.asarray([3, 3])),
                     jnp.asarray(w))
    t = tcrf.crf_nll(TSeq(torch.from_numpy(x), torch.from_numpy(lens)),
                     TSeq(torch.from_numpy(tags), torch.tensor([3, 3])),
                     torch.from_numpy(w))
    close(t.numpy(), j, "padded label buffer")


def test_crf_decode_ties_and_short_rows_match_jax():
    """Planted ties (equal emissions and transitions, so every step ties
    and the first index wins), lengths 0, 1 and 5."""
    n = 4
    x, lens = _ragged([5, 0, 1, 5, 3], n, 4)
    x[3] = 0.5                                 # a whole row of ties
    x[4, :, 1] = x[4, :, 2]                    # two tags tie everywhere
    w = np.random.RandomState(5).randn(n + 2, n).astype(np.float32)
    w[:, 2] = w[:, 1]
    w[2 + 2] = w[2 + 1]
    wt = w.copy()
    wt[2:] = 0.0                               # the first row's ties
    for weights in (w, wt):
        js, ts = _seqs(x, lens)
        want = jcrf.crf_decode(js, jnp.asarray(weights))
        got = tcrf.crf_decode(ts, torch.from_numpy(weights))
        assert got.data.dtype == torch.int32
        np.testing.assert_array_equal(got.data.numpy(),
                                      np.asarray(want.data))
        np.testing.assert_array_equal(got.length.numpy(), lens)
    assert (got.data.numpy()[4] != 2).all()    # the lower index of a tie


@pytest.mark.parametrize("name", ["crf", "ctc", "cross_entropy_over_beam"])
def test_sweep_case_matches_jax(name):
    kwargs, feed_fn, _ = sweep.CASES[name]
    check_parity(build_single_layer_net(name, **kwargs),
                 numpy_feed(feed_fn()), jit=True)


def test_crf_weighted_cost_matches_jax():
    """The per-sequence weight (third input) and ``coeff``, through the
    network's objective."""
    net = build_single_layer_net("crf", size=3, input_sizes=[3, 1, 1],
                                 attrs={"coeff": 0.5})
    x, lens = _ragged([4, 2, 3], 3, 6)
    tags = np.random.RandomState(7).randint(0, 3, (3, 4)).astype(np.int32)
    check_parity(net, {"in0": (x, lens), "in1": (tags, lens),
                       "in2": np.array([[1.0], [0.25], [2.0]], np.float32)},
                 objective="loss", jit=True)


@pytest.mark.parametrize("with_label", [False, True])
def test_crf_decoding_layer_matches_jax(with_label):
    """The best path, or with the tags as a second input the error mask
    (1.0 where the decoded tag differs, 0 past each length)."""
    sizes = [3, 1] if with_label else [3]
    net = build_single_layer_net("crf_decoding", size=3, input_sizes=sizes)
    x, lens = _ragged([4, 1, 3], 3, 8)
    feed = {"in0": (x, lens)}
    if with_label:
        feed["in1"] = (np.random.RandomState(9).randint(
            0, 3, (3, 4)).astype(np.int32), lens)
    tnet = port_net(net)
    jp, tp = carried_params(net, tnet)
    jv = net.forward(jp, jax_feed(feed), is_training=False)[0]["test"]
    tv = tnet.forward(tp, torch_feed(feed), is_training=False)[0]["test"]
    np.testing.assert_array_equal(tv.data.numpy(), np.asarray(jv.data))
    np.testing.assert_array_equal(tv.length.numpy(), np.asarray(jv.length))
    assert tv.data.dtype == (torch.float32 if with_label else torch.int32)


# ---------------------------------------------------------------- CTC
CTC_CASES = {
    # name: (frame lengths, label rows, blank, norm_by_times)
    "repeats": ([8, 6, 7], [[1, 1, 3], [2, 4], [4, 4, 4]], 0, False),
    "blank 2": ([7, 5, 6], [[1, 3], [0, 0, 4], [3]], 2, False),
    "norm_by_times": ([8, 3, 6], [[1, 2, 1], [3], [2, 2]], 0, True),
    # 4 repeats need 7 frames; row 0 has 5: impossible, a finite loss
    "impossible": ([5, 6, 4], [[3, 3, 3, 3], [1, 2], [2, 2]], 0, False),
}


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_ctc_matches_optax_through_the_jax_op(case):
    frames, rows, blank, norm = CTC_CASES[case]
    x, flens = _ragged(frames, 5, 10)
    llens = np.array([len(r) for r in rows], np.int32)
    labels = np.zeros((3, max(llens)), np.int32)
    for i, r in enumerate(rows):
        labels[i, :len(r)] = r

    def jfn(x, labels, flens, llens):
        return jcrf.ctc_loss(JSeq(x, jnp.asarray(flens)),
                             JSeq(jnp.asarray(labels), jnp.asarray(llens)),
                             blank=blank, norm_by_times=norm)

    def tfn(x, labels, flens, llens):
        return tcrf.ctc_loss(TSeq(x, torch.from_numpy(flens)),
                             TSeq(torch.from_numpy(labels),
                                  torch.from_numpy(llens)),
                             blank=blank, norm_by_times=norm)
    got = _op_parity(jfn, tfn, {"x": x, "labels": labels, "flens": flens,
                                "llens": llens}, ["x"])
    assert np.isfinite(got).all()
    if case == "impossible":
        assert got[0] > 1e4 and got[1] < 100


def test_warp_ctc_layer_takes_blank_and_norm_by_times():
    net = build_single_layer_net("warp_ctc", size=4, input_sizes=[4, 1],
                                 attrs={"blank": 3, "norm_by_times": True})
    x, flens = _ragged([6, 5], 4, 11)
    check_parity(net, {"in0": (x, flens),
                       "in1": (np.array([[0, 1], [2, 2]], np.int32),
                               np.array([2, 1], np.int32))}, jit=True)


# ------------------------------------------------------- beam CE
def test_cross_entropy_over_beam_regimes_match_jax():
    """Three expansions of a beam of 3; row 0 keeps gold to the end, row
    1 drops it at the first expansion, row 2 at the second."""
    r = np.random.RandomState(12)
    feed = {}
    ids = [np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32),
           np.array([[1, 2, 0], [5, 4, 3], [7, 1, 3]], np.int32),
           np.array([[2, 0, 1], [4, 3, 5], [1, 2, 0]], np.int32)]
    gold = [np.array([1, 9, 7], np.int32), np.array([2, 4, 6], np.int32),
            np.array([0, 3, 1], np.int32)]
    for e in range(3):
        feed[f"in{3 * e}"] = r.randn(3, 3).astype(np.float32)
        feed[f"in{3 * e + 1}"] = ids[e]
        feed[f"in{3 * e + 2}"] = gold[e]
    net = build_single_layer_net("cross_entropy_over_beam", size=1,
                                 input_sizes=[3, 3, 1] * 3)
    tnet = check_parity(net, feed, jit=True)
    out = tnet.forward({}, torch_feed(feed), is_training=False)[0]["test"]
    s = [feed[f"in{3 * e}"] for e in range(3)]

    def ce(scores, g):
        return -(g - np.log(np.exp(scores).sum()))
    want = [ce(s[2][0], s[2][0, 1]),                  # gold kept: slot 1
            ce(np.append(s[0][1], 0.0), 0.0),         # dropped at once
            ce(np.append(s[1][2], s[0][2, 1]), s[0][2, 1])]
    close(out.numpy()[:, 0], np.array(want, np.float32), "the regimes")


def test_crf_ops_are_registered_under_the_jax_names():
    def names(registry):
        ents = {n for n, d in registry._entries.items()
                if d.fn.__module__.rsplit(".", 1)[-1] == "crf_ops"}
        return ents, {a: n for a, n in registry._aliases.items()
                      if n in ents}
    assert names(TOPS) == names(JOPS)
    assert names(TOPS) == ({"linear_chain_crf", "crf_decoding", "warpctc"},
                           {"ctc": "warpctc"})
