"""The port's SSD detection ops and layers (``paddle_tpu_torch/ops/
detection_ops.py``, ``layers/detection.py``) against the JAX package's,
on the CPU.

``tests/test_detection.py``'s cases against the JAX ops: IoU, encode /
decode (with gradients), the prior layout (with the reference's nested
max-size loop), bipartite matching, the loss with planted mining ties
(equal scores among the negatives, ranked by a stable sort) and its
gradients, no ground truth giving 0, NMS suppression and the fixed-shape
output; the sweep's three detection cases through
``test_torch_dense_layers.check_parity``; and SSD300's prior layout
(six heads over 300², 8732 priors) with the loss and the decode at B 2.

Tolerance (fp32): rtol 1e-5, atol 1e-6 · max(1, max|ref|); matches,
mined negatives and kept rows exact.  ~25 s alone (the JAX side jitted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_layer_grad_sweep as sweep
from layer_grad_util import build_single_layer_net
from paddle_tpu.ops import detection_ops as JD
from paddle_tpu_torch.ops import detection_ops as TD
from test_torch_dense_layers import (check_parity, close, numpy_feed,
                                     port_net, torch_feed)

#: the types this file holds (the closure test reads it)
DETECTION_TYPES = ["priorbox", "multibox_loss", "detection_output"]

#: SSD300's prior layout (PaddlePaddle/models ``ssd``, VOC): the six
#: heads' cells, min and max sizes and aspect ratios over 300²
SSD_CELLS = (38, 19, 10, 5, 3, 1)
SSD_MIN = (30, 60, 111, 162, 213, 264)
SSD_MAX = (60, 111, 162, 213, 264, 315)
SSD_AR = ([2.], [2., 3.], [2., 3.], [2., 3.], [2.], [2.])
VAR = [0.1, 0.1, 0.2, 0.2]


def _boxes(rng, *lead):
    """Corner boxes (xmin, ymin, xmax, ymax) in the unit square."""
    return np.sort(rng.rand(*lead, 2, 2), axis=-2).reshape(*lead, 4) \
        .astype(np.float32)


def ssd_priors(mod):
    return np.concatenate([
        mod.prior_boxes(c, c, 300, 300, [mn], [mx], ar, VAR)
        for c, mn, mx, ar in zip(SSD_CELLS, SSD_MIN, SSD_MAX, SSD_AR)])


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ geometry
def test_iou_encode_decode_match_jax():
    rng = np.random.RandomState(7)
    a, b = _boxes(rng, 5), _boxes(rng, 3)
    close(TD.iou_matrix(_t(a), _t(b)).numpy(),
          JD.iou_matrix(jnp.asarray(a), jnp.asarray(b)), "iou")
    priors, gt = _boxes(rng, 6), _boxes(rng, 6)
    var = np.tile(VAR, (6, 1)).astype(np.float32)
    loc = 0.3 * rng.randn(6, 4).astype(np.float32)

    def jf(p, g, l):
        e = JD.encode_boxes(p, jnp.asarray(var), g)
        d = JD.decode_boxes(p, jnp.asarray(var), l)
        return jnp.sum(e * jnp.cos(e)) + jnp.sum(d * d), (e, d)

    (_, (je, jd)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(priors), jnp.asarray(gt), jnp.asarray(loc))
    leaves = [_t(x).requires_grad_(True) for x in (priors, gt, loc)]
    te = TD.encode_boxes(leaves[0], _t(var), leaves[1])
    td = TD.decode_boxes(leaves[0], _t(var), leaves[2])
    tg = torch.autograd.grad(torch.sum(te * torch.cos(te))
                             + torch.sum(td * td), leaves)
    close(te.detach().numpy(), je, "encode")
    close(td.detach().numpy(), jd, "decode")
    for n, g, w in zip(("priors", "gt", "loc"), tg, jg):
        close(g.numpy(), w, f"gradient of {n}")


def test_prior_layout_is_jax_with_the_nested_max_loop():
    args = (3, 2, 120, 90, [10, 30], [20, 40], [2.0, 3.0], VAR)
    got, want = TD.prior_boxes(*args), JD.prior_boxes(*args)
    assert got.dtype == np.float32 and got.shape == (3 * 2 * 10, 8)
    np.testing.assert_array_equal(got, want)
    assert TD.num_priors_per_cell([10, 30], [20, 40], [2.0, 3.0]) == 10


def test_ssd300_prior_layout_has_8732_priors():
    got = ssd_priors(TD)
    assert got.shape == (8732, 8)
    np.testing.assert_array_equal(got, ssd_priors(JD))


def test_bipartite_matching_matches_jax():
    priors = np.array([[0.0, 0.0, 0.4, 0.4], [0.05, 0.05, 0.45, 0.45],
                       [0.6, 0.6, 0.9, 0.9], [0.0, 0.6, 0.2, 0.9]],
                      np.float32)
    gt = np.array([[[0.0, 0.0, 0.4, 0.4], [0.62, 0.62, 0.88, 0.88]]] * 2,
                  np.float32)
    valid = np.array([[True, True], [True, False]])
    m, ov = TD.match_priors(_t(priors), _t(gt), _t(valid), 0.5)
    assert m.tolist() == [[0, 0, 1, -1], [0, 0, -1, -1]]
    rng = np.random.RandomState(3)
    priors, gt = _boxes(rng, 40), _boxes(rng, 3, 6)
    valid = np.arange(6)[None, :] < np.array([[6], [2], [0]])
    m, ov = TD.match_priors(_t(priors), _t(gt), _t(valid), 0.3)
    jm, jov = jax.vmap(lambda g, v: JD.match_priors(
        jnp.asarray(priors), g, v, 0.3))(jnp.asarray(gt), jnp.asarray(valid))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    close(ov.numpy(), jov, "match overlap")
    assert (m.numpy()[2] == -1).all() and (m.numpy()[0] >= 0).sum() >= 6


# ---------------------------------------------------------------- loss
def _loss_inputs(rng, b=3, p=24, g=4, c=5, ties=True):
    priors = np.concatenate([_boxes(rng, p),
                             np.tile(VAR, (p, 1)).astype(np.float32)], 1)
    conf = rng.randn(b, p, c).astype(np.float32)
    if ties:
        # equal logits on every prior of image 0: the mining ranks ties
        conf[0] = conf[0, :1]
    loc = 0.1 * rng.randn(b, p, 4).astype(np.float32)
    gt = np.zeros((b, g, 6), np.float32)
    gt[..., 0] = rng.randint(1, c, (b, g))
    gt[..., 1:5] = _boxes(rng, b, g)
    count = np.array([g, g - 1, 1][:b], np.int32)
    return conf, loc, priors, gt, count


def _jax_loss(conf, loc, priors, gt, count, **kw):
    def f(c, lo):
        return JD.multibox_loss(c, lo, jnp.asarray(priors), jnp.asarray(gt),
                                jnp.asarray(count), **kw)
    return jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        jnp.asarray(conf), jnp.asarray(loc))


def _torch_loss(conf, loc, priors, gt, count, **kw):
    c, lo = _t(conf).requires_grad_(True), _t(loc).requires_grad_(True)
    val = TD.multibox_loss(c, lo, _t(priors), _t(gt), _t(count), **kw)
    return val, torch.autograd.grad(val, [c, lo])


@pytest.mark.parametrize("kw", [
    dict(num_classes=5, overlap_threshold=0.3),
    dict(num_classes=5, overlap_threshold=0.2, neg_overlap=0.3,
         neg_pos_ratio=2.0, background_id=2)])
def test_multibox_loss_and_gradients_match_jax(kw):
    args = _loss_inputs(np.random.RandomState(11))
    jv, (jgc, jgl) = _jax_loss(*args, **kw)
    tv, (tgc, tgl) = _torch_loss(*args, **kw)
    close(float(tv.detach()), float(jv), "loss")
    close(tgc.numpy(), jgc, "gradient of conf")
    close(tgl.numpy(), jgl, "gradient of loc")
    assert float(tv.detach()) > 0 and np.abs(tgl.numpy()).sum() > 0


def test_mined_negatives_keep_index_order_among_ties():
    """Image 0's priors all score alike: the negatives mined are the
    first candidates in index order, as JAX's stable argsort ranks
    them; the loss's conf gradient is nonzero exactly on the positives
    and the mined negatives, as in JAX."""
    conf, loc, priors, gt, count = _loss_inputs(np.random.RandomState(11),
                                                p=40)
    match, pos, neg = TD.mine(_t(conf), _t(priors), _t(gt), _t(count),
                              0.3, neg_pos_ratio=1.0)
    valid = np.arange(gt.shape[1])[None, :] < count[:, None]
    m, ov = TD.match_priors(_t(priors[:, :4]), _t(gt[..., 1:5]),
                            _t(valid), 0.3)
    np.testing.assert_array_equal(m.numpy(), match.numpy())
    cand0 = np.flatnonzero(((m[0] < 0) & (ov[0] < 0.5)).numpy())
    n0 = int(neg[0].sum())
    assert 0 < n0 < len(cand0)
    np.testing.assert_array_equal(np.flatnonzero(neg[0].numpy()),
                                  cand0[:n0])
    _, (jgc, _) = _jax_loss(conf, loc, priors, gt, count, num_classes=5,
                            overlap_threshold=0.3, neg_pos_ratio=1.0)
    used = np.abs(np.asarray(jgc)).sum(-1) > 0
    np.testing.assert_array_equal(used, (pos | neg).numpy())


def test_multibox_loss_without_ground_truth_is_zero():
    conf, loc, priors, gt, _ = _loss_inputs(np.random.RandomState(2))
    zero = np.zeros(3, np.int32)
    tv, (tgc, tgl) = _torch_loss(conf, loc, priors, gt, zero,
                                 num_classes=5)
    jv, _ = _jax_loss(conf, loc, priors, gt, zero, num_classes=5)
    assert float(tv.detach()) == float(jv) == 0.0
    assert not tgc.any() and not tgl.any()


# ----------------------------------------------------------------- NMS
def test_detection_output_keeps_and_suppresses_as_jax():
    p, c = 3, 3
    priors = np.zeros((p, 8), np.float32)
    priors[:, :4] = [[0.1, 0.1, 0.4, 0.4], [0.11, 0.11, 0.41, 0.41],
                     [0.6, 0.6, 0.9, 0.9]]
    priors[:, 4:] = VAR
    conf = np.full((1, p, c), -5.0, np.float32)
    conf[0, 0, 1], conf[0, 1, 1], conf[0, 2, 2] = 5.0, 4.0, 5.0
    loc = np.zeros((1, p, 4), np.float32)
    got = TD.detection_output(_t(conf), _t(loc), _t(priors), c,
                              nms_threshold=0.5, keep_top_k=5).numpy()
    want = np.asarray(JD.detection_output(
        jnp.asarray(conf), jnp.asarray(loc), jnp.asarray(priors),
        num_classes=c, nms_threshold=0.5, keep_top_k=5))
    assert got.shape == (1, 5, 7)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    close(got, want, "rows")
    kept = got[0][got[0, :, 0] >= 0]
    assert sorted(kept[:, 1].tolist()) == [1.0, 2.0]
    assert (got[0, 2:] == -1).all()


def test_detection_output_matches_jax_with_score_ties():
    rng = np.random.RandomState(4)
    b, p, c = 2, 30, 4
    priors = np.concatenate([_boxes(rng, p) * 0.5 + 0.2,
                             np.tile(VAR, (p, 1)).astype(np.float32)], 1)
    conf = rng.randn(b, p, c).astype(np.float32)
    conf[1, 10:20] = conf[1, 10]          # equal scores across priors
    loc = 0.2 * rng.randn(b, p, 4).astype(np.float32)
    kw = dict(num_classes=c, background_id=1, conf_threshold=0.2,
              nms_top_k=12, nms_threshold=0.3, keep_top_k=40)
    got = TD.detection_output(_t(conf), _t(loc), _t(priors), **kw).numpy()
    want = np.asarray(jax.jit(lambda a, l: JD.detection_output(
        a, l, jnp.asarray(priors), **kw))(jnp.asarray(conf),
                                          jnp.asarray(loc)))
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    close(got, want, "rows")
    assert (got[..., 0] == -1).any() and (got[..., 0] >= 0).sum() > 4


# -------------------------------------------------------------- layers
@pytest.mark.parametrize("name", DETECTION_TYPES)
def test_sweep_case_matches_jax(name):
    kwargs, feed_fn, _ = sweep.CASES[name]
    jnet = build_single_layer_net(name, **kwargs)
    feed = numpy_feed(feed_fn())
    if name != "priorbox":
        check_parity(jnet, feed, jit=True)
        return
    # a constant of the attrs: no gradient to compare
    want = jnet.forward(jnet.init_params(3), {k: jnp.asarray(v) for k, v in
                                              feed.items()},
                        is_training=False)[0]["test"]
    tnet = port_net(jnet)
    got = tnet.forward({}, {k: _t(v) for k, v in feed.items()},
                       is_training=False)[0]["test"]
    assert got.shape == (1, 3 * 3 * 3 * 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ssd300_loss_and_decode_at_a_small_batch_match_jax():
    """SSD300's 8732 priors, 21 classes, B 2 with 3 and 1 ground-truth
    boxes: the loss, its gradients and a decode (NMS over the top 30 of
    each class) equal to JAX's."""
    rng = np.random.RandomState(0)
    priors = ssd_priors(TD)
    b, c, g = 2, 21, 3
    conf = rng.randn(b, 8732, c).astype(np.float32)
    loc = 0.1 * rng.randn(b, 8732, 4).astype(np.float32)
    gt = np.zeros((b, g, 6), np.float32)
    gt[..., 0] = rng.randint(1, c, (b, g))
    gt[..., 1:5] = _boxes(rng, b, g)
    count = np.array([3, 1], np.int32)
    jv, (jgc, jgl) = _jax_loss(conf, loc, priors, gt, count, num_classes=c)
    tv, (tgc, tgl) = _torch_loss(conf, loc, priors, gt, count,
                                 num_classes=c)
    close(float(tv.detach()), float(jv), "loss")
    close(tgc.numpy(), jgc, "gradient of conf")
    close(tgl.numpy(), jgl, "gradient of loc")
    kw = dict(num_classes=c, nms_top_k=30, keep_top_k=50)
    got = TD.detection_output(_t(conf), _t(loc), _t(priors), **kw).numpy()
    want = np.asarray(jax.jit(lambda a, l: JD.detection_output(
        a, l, jnp.asarray(priors), **kw))(jnp.asarray(conf),
                                          jnp.asarray(loc)))
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    close(got, want, "rows")


def test_multibox_loss_is_no_cost_layer_as_in_jax():
    """The JAX package's ``multibox_loss`` is not a cost layer, so a net
    whose only cost it is has no objective for ``NeuralNetwork.loss``;
    the port keeps that (ROADMAP queue C)."""
    from paddle_tpu.layers.network import NeuralNetwork as JNet
    from paddle_tpu_torch.utils import PaddleTpuError
    kwargs, feed_fn, _ = sweep.CASES["multibox_loss"]
    jnet = build_single_layer_net("multibox_loss", **kwargs)
    tnet = port_net(jnet)
    assert isinstance(jnet, JNet) and jnet.cost_layers == []
    assert tnet.cost_layers == []
    feed = numpy_feed(feed_fn())
    with pytest.raises(PaddleTpuError, match="no cost layer"):
        tnet.loss({}, torch_feed(feed), is_training=False)
