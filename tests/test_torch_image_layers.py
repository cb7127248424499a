"""The port's image and 3-D layers and ``nn_ops`` (``paddle_tpu_torch/
layers/conv.py``, ``layers/image3d.py``, ``ops/nn_ops.py``) against the
JAX package's, on the CPU.

The layers run the JAX sweep's cases (``test_layer_grad_sweep.CASES``)
through ``test_torch_dense_layers.check_parity``, the aliases their main
type's case under the alias.  The ops run direct cases at each place
where the JAX op does something a library call would not: a stride-2
transposed conv at odd sizes and ``lax.conv_transpose``'s SAME / VALID
sizes, NCHW convs and pools, asymmetric and SAME pool pads, global
pooling, ``max_pool2d_with_index`` with planted ties and windows wholly
in the padding, ``spp``'s floor bins at 5 × 7, ``lrn``'s undivided α,
``bilinear_interp`` up and down (half-pixel, antialiased), padded
``block_expand``, ``cross-channel-norm`` on a 4-D NHWC input (read as
CHW), and ``deconv3d`` at stride 2 / pad 1, whose shape is JAX's
(i − 1)·s + 2p − k + 2, pinned here.  The op registry holds every name
of JAX's ``nn_ops.py`` and ``detection_ops.py``.

Tolerance (fp32): rtol 1e-5, atol 1e-6 · max(1, max|ref|); indices
exact.  ~20 s alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_layer_grad_sweep as sweep
from layer_grad_util import build_single_layer_net
from paddle_tpu.ops import nn_ops as J
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.ops import nn_ops as T
from paddle_tpu_torch.ops.registry import OPS as TOPS
from test_torch_dense_layers import check_parity, close, numpy_feed

#: the sweep's image and 3-D types (the closure test reads it)
IMAGE_TYPES = ["exconvt", "norm", "maxout", "blockexpand", "spp", "pad",
               "crop", "rotate", "switch_order", "bilinear_interp",
               "cross-channel-norm", "conv3d", "deconv3d", "pool3d"]
#: alias → the type whose sweep case it runs
ALIASES = {"cudnn_convt": "exconvt", "mkldnn_conv": "exconv",
           "cudnn_pool": "pool", "mkldnn_pool": "pool",
           "mkldnn_batch_norm": "batch_norm"}


@pytest.mark.parametrize("name", IMAGE_TYPES)
def test_sweep_case_matches_jax(name):
    kwargs, feed_fn, _ = sweep.CASES[name]
    check_parity(build_single_layer_net(name, **kwargs),
                 numpy_feed(feed_fn()), jit=True)


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_alias_runs_its_types_case(alias):
    kwargs, feed_fn, _ = sweep.CASES[ALIASES[alias]]
    tnet = check_parity(build_single_layer_net(alias, **kwargs),
                        numpy_feed(feed_fn()), jit=True)
    assert tnet.layers["test"].layer_type == ALIASES[alias]


def test_cross_channel_norm_reads_an_nhwc_input_as_chw():
    """On a conv's 4-D NHWC output the layer reshapes (B, C, −1) over
    NHWC memory, as the JAX package does; a flat row is read as CHW."""
    x = np.random.RandomState(3).uniform(0.3, 1.0, (2, 3, 4, 5)) \
        .astype(np.float32)
    net = build_single_layer_net("cross-channel-norm", size=60,
                                 input_sizes=[60], attrs={"channels": 5})
    tnet = check_parity(net, {"in0": x}, jit=True)
    with torch.no_grad():
        p = {k: torch.ones_like(v) for k, v in
             tnet.init_params(3, "cpu").items()}
        out = tnet.forward(p, {"in0": torch.from_numpy(x)},
                           is_training=False)[0]["test"]
    chw = x.reshape(2, 5, -1)
    want = (chw / np.sqrt((chw ** 2).sum(1, keepdims=True) + 1e-6))
    close(out.numpy(), want.reshape(x.shape), "CHW reading of NHWC memory")


# ---------------------------------------------------------------- ops
def _run(fn, arrays, grads):
    """``fn`` of torch tensors made from ``arrays`` → (value, gradients of
    its finite entries against a cosine ramp in ``grads``)."""
    ts = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    for k in grads:
        ts[k].requires_grad_(True)
    out = fn(**ts)
    if not grads:
        return out, []
    ramp = torch.cos(0.3 * torch.arange(out.numel(), dtype=torch.float32))
    obj = torch.sum(torch.where(out.isfinite(), out, 0.0)
                    * ramp.reshape(out.shape))
    return out, torch.autograd.grad(obj, [ts[k] for k in grads])


def op_parity(jfn, tfn, arrays, grads=()):
    """``jfn`` / ``tfn`` on the same numpy arrays: values (infinities at
    the same places) and the gradients of a ramp readout in ``grads``."""

    def jobj(*g):
        out = jfn(**dict({k: jnp.asarray(v) for k, v in arrays.items()},
                         **dict(zip(grads, g))))
        r = jnp.cos(0.3 * jnp.arange(out.size)).reshape(out.shape)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * r), out

    gargs = [jnp.asarray(arrays[k]) for k in grads]
    if grads:
        (_, jout), jg = jax.jit(jax.value_and_grad(
            jobj, argnums=tuple(range(len(grads))), has_aux=True))(*gargs)
    else:
        jout, jg = jobj()[1], []
    tout, tg = _run(tfn, arrays, grads)
    jout, tout = np.asarray(jout), tout.detach().numpy()
    assert tout.shape == jout.shape
    fin = np.isfinite(jout)
    np.testing.assert_array_equal(tout[~fin], jout[~fin])
    close(tout[fin], jout[fin], "value")
    for k, a, b in zip(grads, tg, jg):
        close(a.numpy(), b, f"gradient of {k}")
    return tout


def _r(*shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


OPS_CASES = {
    # a stride-2 transposed conv at odd sizes, explicit pads, SAME, VALID
    "conv2d_transpose_s2_odd": (
        lambda m: lambda x, w: m.conv2d_transpose(x, w, 2, 1),
        dict(x=_r(2, 5, 7, 3), w=_r(3, 3, 4, 3, seed=1)), (2, 9, 13, 4)),
    "conv2d_transpose_asym": (
        lambda m: lambda x, w: m.conv2d_transpose(
            x, w, (2, 3), [(0, 2), (1, 0)]),
        dict(x=_r(2, 4, 3, 2), w=_r(3, 2, 3, 2, seed=1)), (2, 7, 7, 3)),
    "conv2d_transpose_same": (
        lambda m: lambda x, w: m.conv2d_transpose(x, w, 2, "SAME"),
        dict(x=_r(2, 5, 4, 3), w=_r(3, 3, 2, 3, seed=1)), (2, 10, 8, 2)),
    "conv2d_transpose_valid": (
        lambda m: lambda x, w: m.conv2d_transpose(x, w, 2, "VALID"),
        dict(x=_r(1, 3, 4, 2), w=_r(4, 3, 2, 2, seed=1)), (1, 8, 9, 2)),
    # NCHW convs and pools, asymmetric and SAME pads, global pooling
    "conv2d_nchw": (
        lambda m: lambda x, w: m.conv2d(x, w, (2, 1), [(1, 2), (0, 1)],
                                        data_format="NCHW"),
        dict(x=_r(2, 3, 7, 6), w=_r(3, 3, 3, 4, seed=1)), (2, 4, 4, 5)),
    "conv2d_nchw_same": (
        lambda m: lambda x, w: m.conv2d(x, w, 2, "SAME",
                                        data_format="NCHW"),
        dict(x=_r(2, 3, 7, 6), w=_r(3, 3, 3, 4, seed=1)), (2, 4, 4, 3)),
    "pool2d_nchw_max_asym": (
        lambda m: lambda x: m.pool2d(x, "max", 3, 2, [(0, 2), (2, 1)],
                                     data_format="NCHW"),
        dict(x=_r(2, 3, 7, 6)), (2, 3, 4, 4)),
    "pool2d_avg_same": (
        lambda m: lambda x: m.pool2d(x, "avg", 3, 2, "SAME"),
        dict(x=_r(2, 7, 6, 3)), (2, 4, 3, 3)),
    "pool2d_avg_wide_pad": (
        lambda m: lambda x: m.pool2d(x, "avg", 2, 1, 2),
        dict(x=_r(2, 3, 4, 2)), (2, 6, 7, 2)),
    "pool2d_global_max": (
        lambda m: lambda x: m.pool2d(x, "max", global_pooling=True),
        dict(x=_r(2, 5, 4, 3)), (2, 1, 1, 3)),
    "pool2d_global_avg_nchw": (
        lambda m: lambda x: m.pool2d(x, "avg", data_format="NCHW",
                                     global_pooling=True),
        dict(x=_r(2, 3, 5, 4)), (2, 3, 1, 1)),
    # 3-D: conv, the transposed conv at s 2 / p 1 (JAX's size), pools
    "conv3d": (
        lambda m: lambda x, w: m.conv3d(x, w, (1, 2, 1), 1),
        dict(x=_r(2, 3, 5, 4, 3), w=_r(2, 3, 2, 3, 4, seed=1)),
        (2, 4, 3, 5, 4)),
    "conv3d_transpose_s2_p1": (
        lambda m: lambda x, w: m.conv3d_transpose(x, w, 2, 1),
        dict(x=_r(2, 2, 3, 3, 2), w=_r(2, 2, 2, 2, 2, seed=1)),
        (2, 4, 6, 6, 2)),
    "conv3d_transpose_k3": (
        lambda m: lambda x, w: m.conv3d_transpose(x, w, (1, 2, 2),
                                                  [(0, 1), (2, 0), (1, 1)]),
        dict(x=_r(1, 2, 3, 2, 2), w=_r(3, 2, 3, 3, 2, seed=1)),
        (1, 1, 6, 3, 3)),
    "pool3d_avg_pad": (
        lambda m: lambda x: m.pool3d(x, "avg", 2, 2, 1),
        dict(x=_r(2, 3, 4, 5, 2)), (2, 2, 3, 3, 2)),
    "pool3d_max": (
        lambda m: lambda x: m.pool3d(x, "max", (2, 3, 2), (1, 2, 2), 1),
        dict(x=_r(2, 3, 4, 5, 2)), (2, 4, 2, 3, 2)),
    # the rest of the image ops
    "spp_5x7_max": (
        lambda m: lambda x: m.spatial_pyramid_pool(x, 3, "max"),
        dict(x=_r(2, 5, 7, 3)), (2, 63)),
    "spp_5x7_avg": (
        lambda m: lambda x: m.spatial_pyramid_pool(x, 3, "avg"),
        dict(x=_r(2, 5, 7, 3)), (2, 63)),
    "lrn_n5": (lambda m: lambda x: m.lrn(x, 5, 1.0, 0.3, 0.75),
               dict(x=_r(2, 3, 4, 7)), (2, 3, 4, 7)),
    "lrn_n4": (lambda m: lambda x: m.lrn(x, 4, 2.0, 1e-2, 0.6),
               dict(x=_r(2, 3, 2, 6)), (2, 3, 2, 6)),
    "maxout_nhwc": (lambda m: lambda x: m.maxout(x, 3),
                    dict(x=_r(2, 3, 4, 6)), (2, 3, 4, 2)),
    "maxout_nchw": (lambda m: lambda x: m.maxout(x, 2, "NCHW"),
                    dict(x=_r(2, 6, 3, 4)), (2, 3, 3, 4)),
    "prelu": (lambda m: lambda x, a: m.prelu(x, a),
              dict(x=_r(3, 5), a=_r(5, seed=1)), (3, 5)),
    "bilinear_up": (lambda m: lambda x: m.bilinear_interp(x, 9, 11),
                    dict(x=_r(2, 6, 6, 3)), (2, 9, 11, 3)),
    "bilinear_down": (lambda m: lambda x: m.bilinear_interp(x, 4, 3),
                      dict(x=_r(2, 6, 6, 3)), (2, 4, 3, 3)),
    "bilinear_up_down": (lambda m: lambda x: m.bilinear_interp(x, 9, 4),
                         dict(x=_r(2, 6, 6, 3)), (2, 9, 4, 3)),
    "block_expand_padded": (
        lambda m: lambda x: m.block_expand(x, 2, 3, 2, 2, 1, 1),
        dict(x=_r(2, 5, 6, 3)), (2, 9, 18)),
    "rotate": (lambda m: lambda x: m.rotate(x, 3, 4),
               dict(x=_r(2, 24)), (2, 24)),
    "switch_order_to_nhwc": (lambda m: lambda x: m.switch_order(x),
                             dict(x=_r(2, 3, 4, 5)), (2, 4, 5, 3)),
    "switch_order_to_nchw": (
        lambda m: lambda x: m.switch_order(x, "NCHW"),
        dict(x=_r(2, 4, 5, 3)), (2, 3, 4, 5)),
    "feature_map_expand": (
        lambda m: lambda x: m.feature_map_expand(x, 3, False),
        dict(x=_r(2, 4)), (2, 12)),
}


@pytest.mark.parametrize("name", sorted(OPS_CASES))
def test_op_matches_jax(name):
    make, arrays, shape = OPS_CASES[name]
    out = op_parity(make(J), make(T), arrays, tuple(arrays))
    assert out.shape == shape


def test_max_pool_with_index_ties_and_padding_match_jax():
    """Planted ties (small integers) keep the first of equal values in
    the window's row-major order (the reference's strict comparison); a
    window wholly in the padding gives −inf and index −1."""
    x = np.random.RandomState(5).randint(0, 3, (2, 5, 6, 3)) \
        .astype(np.float32)
    for window, stride, pad in ((3, 2, 1), (3, 3, 3), ((2, 3), (1, 2), 1),
                                (2, 2, 0)):
        jv, ji = J.max_pool2d_with_index(jnp.asarray(x), window, stride,
                                         pad)
        tv, ti = T.max_pool2d_with_index(torch.from_numpy(x), window,
                                         stride, pad)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ti.dtype == torch.int32
    assert (ti.numpy() >= 0).all()
    _, ji = J.max_pool2d_with_index(jnp.asarray(x), 3, 3, 3)
    assert (np.asarray(ji) == -1).any()


def test_max_pool_with_index_tie_order_of_padded_two_wide_windows():
    """XLA (CPU, JAX 0.9.0) reduces a padded window two columns wide in
    column-major order, so the JAX op takes the first tie down the
    columns there; the port keeps the row-major first everywhere."""
    x = np.zeros((1, 4, 4, 1), np.float32)
    x[0, 0, 1, 0] = x[0, 1, 0, 0] = 2.0          # flat 1 and 4 tie
    _, ji = J.max_pool2d_with_index(jnp.asarray(x), 2, 2, 2)
    _, ti = T.max_pool2d_with_index(torch.from_numpy(x), 2, 2, 2)
    assert (int(np.asarray(ji)[0, 1, 1, 0]), int(ti[0, 1, 1, 0])) == (4, 1)
    _, ji = J.max_pool2d_with_index(jnp.asarray(x), 2, 2, 0)
    assert int(np.asarray(ji)[0, 0, 0, 0]) == 1


def test_conv3d_transpose_keeps_jax_shape_not_the_reference_formula():
    """The sweep's deconv3d geometry (D, H, W 2, 3, 3; k 2) at s 2, p 1:
    JAX's (i − 1)·s + 2p − k + 2 = (4, 6, 6), where the reference's
    (i − 1)·s + k − 2p gives (2, 4, 4); at s 1, p 0, (1, 2, 2)."""
    x, w = _r(1, 2, 3, 3, 2), _r(2, 2, 2, 2, 2, seed=1)
    for (s, p), want in (((2, 1), (4, 6, 6)), ((1, 0), (1, 2, 2))):
        got = T.conv3d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                                 s, p)
        jgot = J.conv3d_transpose(jnp.asarray(x), jnp.asarray(w), s, p)
        assert tuple(got.shape[1:4]) == tuple(jgot.shape[1:4]) == want


def test_registry_holds_every_jax_nn_and_detection_op():
    """Every ``@register_op`` name of JAX's ``nn_ops.py`` (20) and
    ``detection_ops.py`` (4) is registered in the port with the same
    ``n_outputs``."""
    from paddle_tpu.ops import detection_ops as JD  # noqa: F401
    from paddle_tpu_torch.ops import detection_ops as TD  # noqa: F401
    want = {m: {n: d.n_outputs for n, d in JOPS._entries.items()
                if d.fn.__module__ == f"paddle_tpu.ops.{m}"}
            for m in ("nn_ops", "detection_ops")}
    assert (len(want["nn_ops"]), len(want["detection_ops"])) == (20, 4)
    for m, names in want.items():
        for name, n_out in names.items():
            d = TOPS.get(name)
            assert d.n_outputs == n_out, name
            assert d.fn.__module__ == f"paddle_tpu_torch.ops.{m}", name
