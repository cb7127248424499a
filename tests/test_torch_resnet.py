"""The port's ResNet training path against the JAX package's, on the CPU.

The same ``ModelConfig`` comes out of both packages (``resnet(50)``,
``resnet_cifar10``); the JAX ``init_params(0)`` and ``init_buffers()``
are carried into the port by name.  The JAX side runs its Pallas conv
kernels in interpret mode; the port runs its kernels' plain versions.

The small bottleneck net: a 7×7/s2 stem at 64 channels on 3×32×32, a
max pool, bottleneck(64, s1) and bottleneck(128, s2), an average pool
and a softmax fc — two fused 3×3 forward pairs (kernels 19/20) and two
1×1 GEMM-prologue pairs, as in ResNet-50.

Tolerances (fp32; sums in other orders): loss rtol 1e-5; gradients
1e-5 + 1e-4 * max|ref| (they pass through the batch statistics' 1/std);
running statistics 1e-6 + 1e-5 * max|ref|.  Adam steps (``bench.py``'s
optimizer, epsilon 1e-8): losses rtol 1e-5; each step's change of a
parameter within 1e-2 of that parameter's largest change (measured
5.5e-4), leaving out the elements whose gradient lies within the
gradient tolerance of 0 (measured: 0.3 % of them, and every element of
the conv biases that feed a batch norm).
bf16 (``use_bf16`` and ``bf16_activations``, ``bench.py``'s flags): the
two packages round to bf16 at the same places, but each conv sums in
its own order before it rounds; measured on the small net, loss rel
err 1.5e-4 (limit 5e-3).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.analysis import netcheck as jcheck
from paddle_tpu.config import dsl
from paddle_tpu.config.dsl import config_scope
from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.data.feeder import dense_vector, integer_value
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.models import image as jimage
from paddle_tpu.observe import counter
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu_torch.analysis import netcheck as tcheck
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.models import image as timage
from paddle_tpu_torch.ops import conv as tconv
from paddle_tpu_torch.ops import nn_ops as tn
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from paddle_tpu_torch.utils import FLAGS as TFLAGS
from paddle_tpu_torch.utils.jax_interop import (network_buffers_from_jax,
                                                network_params_from_jax)

FLAG_NAMES = ("use_bf16", "bf16_activations", "conv_bn_fuse",
              "conv_bn_fuse_fwd")
B, IMG, NCLS = 2, 32, 10
# the ResNet row's optimizer (bench.py:270-278: Adam, lr 1e-3, clip 25)
OPT = dict(learning_method="adam", learning_rate=1e-3,
           gradient_clipping_threshold=25.0)


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


# ------------------------------------------------------------ configs
def _small_jax(img, num_classes):
    net = jimage._bn_conv(img, 7, 64, 2, 3, channels=3)
    net = jimage._pool(net, 3, 2, 1)
    net = jimage._bottleneck(net, 64, 1)
    net = jimage._bottleneck(net, 128, 2)
    net = jimage._pool(net, 4, 1, 0, avg=True)
    return dsl.fc(net, size=num_classes, act=dsl.SoftmaxActivation())


def _small_port(img, num_classes):
    net = timage._bn_conv(img, 7, 64, 2, 3, channels=3)
    net = timage._pool(net, 3, 2, 1)
    net = timage._bottleneck(net, 64, 1)
    net = timage._bottleneck(net, 128, 2)
    net = timage._pool(net, 4, 1, 0, avg=True)
    return timage.fc(net, num_classes, act="softmax")


def _jax_config(body, img_size, ncls):
    with config_scope():
        img = dsl.data("image", dense_vector(3 * img_size * img_size),
                       height=img_size, width=img_size)
        lab = dsl.data("label", integer_value(ncls))
        cost = dsl.classification_cost(body(img, ncls), lab)
        return dsl.topology(cost)


CONFIGS = {
    "resnet50": (lambda i, k: jimage.resnet(i, depth=50, num_classes=k),
                 lambda: timage.resnet(50, 1000, 224), 224, 1000),
    "cifar20": (lambda i, k: jimage.resnet_cifar10(i, depth=20,
                                                   num_classes=k),
                lambda: timage.resnet_cifar10(20, 10, 32), 32, 10),
    "cifar8": (lambda i, k: jimage.resnet_cifar10(i, depth=8,
                                                  num_classes=k),
               lambda: timage.resnet_cifar10(8, 10, 32), 32, 10),
    "small": (_small_jax,
              lambda: timage.image_classifier(_small_port, IMG, NCLS),
              IMG, NCLS),
}


def _configs(name):
    jbody, tmake, img_size, ncls = CONFIGS[name]
    return _jax_config(jbody, img_size, ncls), tmake()


@pytest.mark.parametrize("name", ["resnet50", "cifar20"])
def test_config_param_and_buffer_specs_match_jax(name):
    jcfg, tcfg = _configs(name)
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
    jnet, tnet = JNet(jcfg), TNet(tcfg)
    assert {n: dataclasses.asdict(s) for n, s in tnet.param_specs.items()} \
        == {n: dataclasses.asdict(s) for n, s in jnet.param_specs.items()}
    want = {n: (tuple(b.shape), np.asarray(b).tolist())
            for n, b in jnet.init_buffers().items()}
    got = {n: (tuple(b.shape), b.tolist())
           for n, b in tnet.init_buffers("cpu").items()}
    assert got == want


@pytest.mark.parametrize("name,fwd,census", [
    ("resnet50", True, {"bwd_3x3": 0, "fwd_3x3": 16, "fwd_1x1": 16}),
    ("resnet50", False, {"bwd_3x3": 16, "fwd_3x3": 0, "fwd_1x1": 0}),
    ("cifar20", True, {"bwd_3x3": 10, "fwd_3x3": 9, "fwd_1x1": 0}),
    ("small", True, {"bwd_3x3": 0, "fwd_3x3": 2, "fwd_1x1": 2})])
def test_fusion_plan_and_census_match_jax(name, fwd, census):
    _set_both(conv_bn_fuse_fwd=fwd)
    jcfg, tcfg = _configs(name)
    assert tcheck.fusion_plan(tcfg, fuse_fwd=fwd) == \
        jcheck.fusion_plan(jcfg, fuse_fwd=fwd)
    assert tcheck.fused_pair_census(tcfg, fuse_fwd=fwd) == \
        jcheck.fused_pair_census(jcfg, fuse_fwd=fwd) == census
    assert TNet(tcfg).fused_pair_census == census


@pytest.mark.parametrize("name,fwd,census", [
    ("resnet50", True, {"bwd_3x3": 0, "fwd_3x3": 16, "fwd_1x1": 16}),
    ("resnet50", False, {"bwd_3x3": 0, "fwd_3x3": 0, "fwd_1x1": 0}),
    ("cifar20", True, {"bwd_3x3": 0, "fwd_3x3": 9, "fwd_1x1": 0})])
def test_fusion_plan_without_bwd_fusion_matches_jax(name, fwd, census):
    """``--conv_bn_fuse=false`` in both packages: no backward pair, the
    forward pairs as ``--conv_bn_fuse_fwd`` says."""
    _set_both(conv_bn_fuse=False, conv_bn_fuse_fwd=fwd)
    jcfg, tcfg = _configs(name)
    assert tcheck.fusion_plan(tcfg, fuse_bwd=False, fuse_fwd=fwd) == \
        jcheck.fusion_plan(jcfg, fuse_bwd=False, fuse_fwd=fwd)
    assert tcheck.fused_pair_census(tcfg, fuse_bwd=False, fuse_fwd=fwd) == \
        jcheck.fused_pair_census(jcfg, fuse_bwd=False, fuse_fwd=fwd) == census
    assert TNet(tcfg).fused_pair_census == census


# ------------------------------------------------------- network parity
def _feed(seed, b=B, img_size=IMG, ncls=NCLS):
    """bench.py's image feed: randn rows, then labels."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 3 * img_size * img_size).astype(np.float32),
            rng.randint(0, ncls, (b,)).astype(np.int32))


def _jax_dispatch():
    return {(s["labels"]["op"], s["labels"]["path"], s["labels"]["reason"]):
            s["value"] for s in counter("conv_dispatch_total").samples()}


def _jax_run(name, seed=0):
    """JAX init (params, buffers), loss, gradients, new buffers and the
    dispatch record of one traced training step."""
    jcfg, tcfg = _configs(name)
    jnet = JNet(jcfg)
    params, buffers = jnet.init_params(seed=0), jnet.init_buffers()
    img, lab = _feed(seed)
    feed = {"image": jnp.asarray(img), "label": jnp.asarray(lab)}

    def loss_fn(p):
        loss, (_, nb) = jnet.loss(p, feed, dict(buffers), is_training=True)
        return loss, nb
    before = _jax_dispatch()
    (loss, nb), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    after = _jax_dispatch()
    dispatch = {k: v - before.get(k, 0.0) for k, v in after.items()
                if v - before.get(k, 0.0)}
    as_np = lambda d: {k: np.asarray(v, np.float32)  # noqa: E731
                       for k, v in d.items()}
    return {"tcfg": tcfg, "params": as_np(params), "buffers": as_np(buffers),
            "loss": float(loss), "grads": as_np(grads),
            "new_buffers": as_np(nb), "dispatch": dispatch,
            "feed": (img, lab)}


def _port_run(ref):
    tnet = TNet(ref["tcfg"])
    params = {n: p.requires_grad_(True) for n, p in network_params_from_jax(
        ref["params"], tnet, "cpu").items()}
    buffers = network_buffers_from_jax(ref["buffers"], tnet, "cpu")
    img, lab = ref["feed"]
    tn.conv_dispatch.clear()
    tconv.reset_launch_counts()
    loss, (_, nb) = tnet.loss(params, {"image": torch.from_numpy(img),
                                       "label": torch.from_numpy(lab)},
                              buffers, is_training=True)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    assert all(fn.launches == 0 for fn in tconv.KERNEL_WRAPPERS)
    return float(loss.detach()), grads, nb, dict(tn.conv_dispatch)


def _grad_tol(g):
    """Gradient tolerance: they pass through the batch statistics' 1/std."""
    return 1e-5 + 1e-4 * float(np.abs(g).max())


def _check_against(ref, run):
    loss, grads, nb, dispatch = run
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    assert set(grads) == set(ref["grads"])
    for name, g in ref["grads"].items():
        np.testing.assert_allclose(grads[name].numpy(), g, rtol=0,
                                   atol=_grad_tol(g), err_msg=name)
    assert set(nb) == set(ref["new_buffers"])
    for name, b in ref["new_buffers"].items():
        np.testing.assert_allclose(nb[name].numpy(), b, rtol=0,
                                   atol=1e-6 + 1e-5 * float(np.abs(b).max()),
                                   err_msg=name)
    assert dispatch == ref["dispatch"]


@pytest.fixture(scope="module")
def small_ref():
    saved = {k: JFLAGS.get(k) for k in FLAG_NAMES}
    JFLAGS.set("use_bf16", False)
    try:
        return _jax_run("small")
    finally:
        for k, v in saved.items():
            JFLAGS.set(k, v)


def test_small_net_matches_jax(small_ref):
    _set_both(use_bf16=False)
    _check_against(small_ref, _port_run(small_ref))
    assert {k[:2]: v for k, v in small_ref["dispatch"].items()} == {
        ("affine_act_conv2d", "pallas3x3"): 2,
        ("affine_act_conv2d", "gemm1x1"): 2}


def test_small_net_without_forward_fusion_matches_jax():
    """The kill switch: ``--conv_bn_fuse_fwd=false`` in both packages
    sends the 3×3 pairs through ``conv2d_bn``'s fused path (kernel 18)."""
    _set_both(use_bf16=False, conv_bn_fuse_fwd=False)
    ref = _jax_run("small")
    _check_against(ref, _port_run(ref))
    assert {k[:2]: v for k, v in ref["dispatch"].items()} == {
        ("conv2d_bn", "fused"): 2}


def test_small_net_without_any_fusion_matches_jax():
    """``--conv_bn_fuse=false`` and ``--conv_bn_fuse_fwd=false`` in both
    packages: the plain composition, no fused op dispatched."""
    _set_both(use_bf16=False, conv_bn_fuse=False, conv_bn_fuse_fwd=False)
    ref = _jax_run("small")
    _check_against(ref, _port_run(ref))
    assert ref["dispatch"] == {}


def test_resnet_cifar10_matches_jax():
    """resnet_cifar10(8): the 64-channel basic block runs the chain op
    (kernels 19 and 21), the 16/32-channel pairs the unfused path."""
    _set_both(use_bf16=False)
    ref = _jax_run("cifar8")
    _check_against(ref, _port_run(ref))
    assert {k[:2]: v for k, v in ref["dispatch"].items()} == {
        ("conv2d_bn", "chain"): 1, ("conv2d_bn", "unfused"): 3}


def test_adam_steps_with_buffers_match_jax(small_ref):
    """Three Adam steps; the port carries its own buffers from step to
    step.  Each step starts the port from JAX's params and Adam moments:
    at epsilon 1e-8 Adam turns a gradient that is 0 up to rounding into
    a whole ±lr step of either sign, and from the third step on those
    steps would set the two packages' gradients apart.  Each step's change
    of every parameter is held against JAX's, except where the gradient
    (recovered from JAX's first moment) is 0 within its tolerance."""
    _set_both(use_bf16=False)
    jcfg, tcfg = _configs("small")
    jtr = JTrainer(JNet(jcfg), opt_config=JOpt(**OPT), seed=0)
    tnet = TNet(tcfg)
    ttr = TTrainer(tnet, opt_config=TOpt(**OPT), seed=0, device="cpu")
    ttr.buffers = network_buffers_from_jax(
        {n: np.array(v) for n, v in jtr.buffers.items()}, tnet, "cpu")
    names = sorted(jtr.params)     # the order of JAX's slot list
    beta1 = ttr.optimizer.beta1
    for step in range(3):
        before = {n: np.array(v) for n, v in jtr.params.items()}
        count, slots = jtr.opt_state
        m0 = {n: np.array(s[0]) for n, s in zip(names, slots)}
        ttr.params = network_params_from_jax(before, tnet, "cpu")
        ttr.opt_state = (torch.tensor(int(count), dtype=torch.int32),
                         {n: tuple(torch.from_numpy(np.array(x)) for x in s)
                          for n, s in zip(names, slots)})
        img, lab = _feed(10 + step)
        want = float(jtr.train_one_batch({"image": jnp.asarray(img),
                                          "label": jnp.asarray(lab)}))
        got = float(ttr.train_one_batch({"image": img, "label": lab}))
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"loss of step {step}")
        assert int(ttr.opt_state[0]) == int(jtr.opt_state[0])
        left_out, n_left, n_all = [], 0, 0
        for name, (m1, _) in zip(names, jtr.opt_state[1]):
            g = (np.asarray(m1) - beta1 * m0[name]) / (1 - beta1)
            keep = np.abs(g) > _grad_tol(g)
            if not keep.any():
                left_out.append(name)
                continue
            n_left += int((~keep).sum())
            n_all += keep.size
            want_d = np.asarray(jtr.params[name]) - before[name]
            got_d = ttr.params[name].numpy() - before[name]
            err = np.abs(got_d - want_d)[keep].max()
            assert err <= 1e-2 * np.abs(want_d).max(), \
                f"step {step}, {name}: change off by {err:.3e}"
        assert left_out == sorted(n for n in names if n.startswith(
            "___exconv_") and n.endswith(".wbias")), left_out
        assert n_left <= 0.01 * n_all, (step, n_left, n_all)
    for name, b in jtr.buffers.items():
        b = np.asarray(b)
        np.testing.assert_allclose(ttr.buffers[name].numpy(), b, rtol=0,
                                   atol=1e-6 + 1e-5 * float(np.abs(b).max()),
                                   err_msg=name)


def test_small_net_loss_under_bench_bf16_flags_matches_jax(small_ref):
    """``use_bf16`` and ``bf16_activations`` (``bench.py``'s flags) in
    both packages: bf16 convs and layer outputs, fp32 loss."""
    _set_both(use_bf16=True, bf16_activations=True)
    jcfg, tcfg = _configs("small")
    jnet, tnet = JNet(jcfg), TNet(tcfg)
    img, lab = small_ref["feed"]
    fc = [n for n in jnet.layers if n.startswith("__fc_")][0] + ".logits"

    def jf(p, b):
        loss, (vals, _) = jnet.loss(
            p, {"image": jnp.asarray(img), "label": jnp.asarray(lab)}, b,
            is_training=True)
        return loss, vals[fc]
    jloss, jlogits = jax.jit(jf)(
        {n: jnp.asarray(v) for n, v in small_ref["params"].items()},
        {n: jnp.asarray(v) for n, v in small_ref["buffers"].items()})
    params = network_params_from_jax(small_ref["params"], tnet, "cpu")
    buffers = network_buffers_from_jax(small_ref["buffers"], tnet, "cpu")
    loss, (values, _) = tnet.loss(params, {"image": torch.from_numpy(img),
                                           "label": torch.from_numpy(lab)},
                                  buffers)
    assert loss.dtype == torch.float32
    assert values[fc].dtype == torch.bfloat16
    assert jlogits.dtype == jnp.bfloat16
    np.testing.assert_allclose(float(loss), float(jloss), rtol=5e-3)
