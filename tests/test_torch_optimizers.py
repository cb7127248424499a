"""The port's optimizer catalogue (``optimizer/optimizers.py``), the
learning-rate schedules (``optimizer/schedules.py``), the pruning hooks
(``optimizer/hooks.py``) and ``trainer.optimizer_from_config`` against
the JAX package's, on the CPU.

Every rule of ``tests/test_optimizers.py`` runs in both packages from
the same parameters, gradients and state (made with numpy from a seed):
the ten registered rules through ``apply`` (with per-parameter lr
scales, L2, clipping, L1 and lazy row masks) and ``apply_rows``, each
parameter, slot and count within 4 float32 ulps an element per step;
``ModelAverage``; each schedule at several ``progress`` values within 4
ulps.  Then each schedule on SGD through the trainers of a small fc
classifier, at the Adam trajectory tolerance of
``tests/test_torch_train.py`` (loss rtol 1e-5, parameters atol 1e-5;
``tests/test_torch_optimizer_steps_*.py`` run each rule through the
LSTM classifier).  Fault C6: a pruning hook gives the same masks, the same
zeros and the same trajectory in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl
from paddle_tpu.config.dsl import config_scope
from paddle_tpu.config.model_config import ModelConfig as JModelConfig
from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.data.feeder import dense_vector, integer_value
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.optimizer import OPTIMIZERS as JOPTIMIZERS
from paddle_tpu.optimizer import ModelAverage as JModelAverage
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu.optimizer import make_schedule as j_schedule
from paddle_tpu.optimizer import hooks as jhooks
from paddle_tpu.trainer import checkpoint as jck
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu_torch.config.model_config import ModelConfig as TModelConfig
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.optimizer import OPTIMIZERS as TOPTIMIZERS
from paddle_tpu_torch.optimizer import SCHEDULES as TSCHEDULES
from paddle_tpu_torch.optimizer import ModelAverage as TModelAverage
from paddle_tpu_torch.optimizer import Momentum as TMomentum
from paddle_tpu_torch.optimizer import create_optimizer as t_create
from paddle_tpu_torch.optimizer import make_schedule as t_schedule
from paddle_tpu_torch.optimizer import hooks as thooks
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from paddle_tpu_torch.trainer.trainer import optimizer_from_config
from paddle_tpu_torch.utils import FLAGS as TFLAGS
from paddle_tpu_torch.utils import PaddleTpuError
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax

NAMES = ["adadelta", "adagrad", "adam", "adamax", "decayed_adagrad",
         "momentum", "proximal_adagrad", "proximal_gd", "rmsprop", "sgd"]
#: each rule's own hyperparameters, beside the common ones
RULE_KW = {"momentum": dict(momentum=0.9), "adagrad": dict(epsilon=1e-6),
           "adadelta": dict(rho=0.9, epsilon=1e-6),
           "rmsprop": dict(rho=0.9, epsilon=1e-6),
           "decayed_adagrad": dict(rho=0.9, epsilon=1e-6),
           "adam": dict(beta1=0.9, beta2=0.999, epsilon=1e-8),
           "adamax": dict(beta1=0.9, beta2=0.999, epsilon=1e-8),
           "proximal_gd": dict(l1=0.01, l2=0.1),
           "proximal_adagrad": dict(l1=0.01, l2=0.1, epsilon=1e-6)}
COMMON = dict(learning_rate=0.05, weight_decay=1e-3,
              gradient_clipping_threshold=1.5)
SCALES = {"b": 0.5, "emb": 2.0, "w": 1.0}
ULPS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def flags():
    names = ("init_model_path", "prefetch_depth", "save_dir",
             "sparse_grads")
    old_j = {k: getattr(JFLAGS, k) for k in names}
    old_t = {k: TFLAGS.get(k) for k in names}
    yield
    for k in names:
        JFLAGS.set(k, old_j[k])
        TFLAGS.set(k, old_t[k])


def assert_ulps(got, want, what="", n=ULPS):
    """Every element of ``got`` within ``n`` float32 ulps of ``want``'s
    (ulps of the larger magnitude of the two)."""
    got = np.asarray(got.detach().numpy() if hasattr(got, "detach")
                     else got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    big = np.maximum(np.abs(got), np.abs(want)).astype(np.float32)
    tol = n * np.spacing(big)
    bad = ~(np.abs(got.astype(np.float64) - want) <= tol) \
        & ~(np.isnan(got) & np.isnan(want))
    assert not bad.any(), (what, got[bad][:4], want[bad][:4])


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    params = {"b": rng.randn(3), "emb": rng.randn(6, 3), "w": rng.randn(4, 3)}
    params = {n: v.astype(np.float32) for n, v in params.items()}
    grads = [{n: (2 * rng.randn(*v.shape)).astype(np.float32)
              for n, v in params.items()} for _ in range(3)]
    return params, grads


def _both(name, **extra):
    kw = dict(COMMON, **RULE_KW.get(name, {}), **extra)
    return JOPTIMIZERS.create(name, **kw), t_create(name, **kw)


def _t(d):
    return {n: torch.from_numpy(np.array(v)) for n, v in d.items()}


def _assert_state(tp, tst, jp, jst, what):
    for n in jp:
        assert_ulps(tp[n], np.asarray(jp[n]), f"{what}: param {n}")
    jcount, jslots = jst
    tcount, tslots = tst
    assert int(tcount) == int(jcount) and tcount.dtype == torch.int32
    for n, js in zip(sorted(jp), jslots):
        assert len(tslots[n]) == len(js), (what, n)
        for i, (t, j) in enumerate(zip(tslots[n], js)):
            assert_ulps(t, np.asarray(j), f"{what}: slot {i} of {n}")


# --------------------------------------------------------------- rules
def test_registry_names_are_the_reference_names():
    assert TOPTIMIZERS.names() == JOPTIMIZERS.names() == NAMES
    assert TSCHEDULES.names() == sorted(
        ["constant", "poly", "caffe_poly", "exp", "discexp", "linear",
         "manual", "pass_manual"])
    with pytest.raises(PaddleTpuError, match="unknown optimizer"):
        t_create("lamb")


@pytest.mark.parametrize("l1", [0.0, 0.02], ids=["no_l1", "l1"])
@pytest.mark.parametrize("name", NAMES)
def test_apply_matches_jax(name, l1):
    """Three steps through ``apply``: per-parameter lr scales, L2,
    clipping and (when set) L1; the last step with lazy row masks on the
    ``emb`` table (rows 1 and 4 touched)."""
    jopt, topt = _both(name, l1_decay=l1)
    params, grads = _problem()
    jp, tp = {n: jnp.asarray(v) for n, v in params.items()}, _t(params)
    jst, tst = jopt.init_state(jp), topt.init_state(tp)
    rows = np.array([False, True, False, False, True, False])
    for step, g in enumerate(grads):
        jm = tm = None
        if step == 2:
            jm = {"b": None, "emb": jnp.asarray(rows), "w": None}
            tm = {"emb": torch.from_numpy(rows)}
            before = tp["emb"].clone()
        jp, jst = jopt.apply(jp, {n: jnp.asarray(v) for n, v in g.items()},
                             jst, 0.05, SCALES, jm)
        tp, tst = topt.apply(tp, _t(g), tst, 0.05, SCALES, tm)
        _assert_state(tp, tst, jp, jst, f"{name} step {step}")
    # the untouched rows kept their values bit for bit
    keep = ~torch.from_numpy(rows)
    assert torch.equal(tp["emb"][keep], before[keep])


@pytest.mark.parametrize("name", NAMES)
def test_apply_rows_matches_jax_and_masked_apply(name):
    """``apply_rows`` on rows {4, 0, 2} plus a -1 pad, with L1: the JAX
    package's ``apply_rows``, and the port's own ``apply`` with those
    rows' mask."""
    jopt, topt = _both(name, l1_decay=0.01)
    rng = np.random.RandomState(3)
    table = rng.randn(6, 3).astype(np.float32)
    rows = np.array([4, 0, 2, -1], np.int32)
    row_g = rng.randn(4, 3).astype(np.float32)
    jst = (jnp.zeros((), jnp.int32), jopt.init({"t": table})[0])
    tslot = topt.init_state({"t": torch.from_numpy(table)})[1]["t"]
    jt, tt = jnp.asarray(table), torch.from_numpy(table.copy())
    tst = (torch.zeros((), dtype=torch.int32), tslot)
    for step in range(2):
        jt, jst = jopt.apply_rows(jt, jnp.asarray(rows), jnp.asarray(row_g),
                                  jst, 0.05)
        tt, tst = topt.apply_rows(tt, torch.from_numpy(rows),
                                  torch.from_numpy(row_g), tst, 0.05)
        assert_ulps(tt, np.asarray(jt), f"{name} table step {step}")
        for i, (t, j) in enumerate(zip(tst[1], jst[1])):
            assert_ulps(t, np.asarray(j), f"{name} slot {i} step {step}")
    # the port's apply with the touched rows' mask, from the same start
    dense_g = np.zeros_like(table)
    dense_g[rows[:3]] = row_g[:3]
    mask = np.isin(np.arange(6), rows[:3])
    p, st = {"t": torch.from_numpy(table)}, topt.init_state(
        {"t": torch.from_numpy(table)})
    for _ in range(2):
        p, st = topt.apply(p, {"t": torch.from_numpy(dense_g)}, st, 0.05,
                           sparse_masks={"t": torch.from_numpy(mask)})
    assert_ulps(tt, p["t"].numpy(), f"{name}: apply_rows vs apply")


def test_reference_rules_by_formula():
    """``tests/test_optimizers.py``'s formulas, on the port."""
    params, grads = _problem(1)
    p, g = _t(params), _t(grads[0])
    w, gw = params["w"], grads[0]["w"]
    sgd = t_create("sgd", learning_rate=0.1)
    p1, st = sgd.apply(p, g, sgd.init_state(p))
    np.testing.assert_allclose(p1["w"].numpy(), w - 0.1 * gw, rtol=1e-6)
    assert int(st[0]) == 1
    mom = TMomentum(learning_rate=0.1, momentum=0.9)
    st = mom.init_state(p)
    p1, st = mom.apply(p, g, st)
    p2, st = mom.apply(p1, g, st)
    v1 = -0.1 * gw
    np.testing.assert_allclose(p2["w"].numpy(),
                               w + v1 + (0.9 * v1 - 0.1 * gw), rtol=1e-5)
    ada = t_create("adagrad", learning_rate=0.1, epsilon=1e-6)
    p1, _ = ada.apply(p, g, ada.init_state(p))
    np.testing.assert_allclose(p1["w"].numpy(),
                               w - 0.1 * gw / (np.abs(gw) + 1e-6), rtol=1e-5)
    adam = t_create("adam", learning_rate=0.01)
    p1, _ = adam.apply(p, g, adam.init_state(p))
    mhat, vhat = 0.1 * gw / 0.1, 0.001 * gw ** 2 / 0.001
    np.testing.assert_allclose(
        p1["w"].numpy(), w - 0.01 * mhat / (np.sqrt(vhat) + 1e-8), rtol=1e-5)
    x = {"x": torch.ones(4)}
    clip = t_create("sgd", learning_rate=0.1, weight_decay=0.5,
                    gradient_clipping_threshold=1.0)
    x1, _ = clip.apply(x, {"x": torch.full((4,), 10.0)},
                       clip.init_state(x))
    np.testing.assert_allclose(x1["x"].numpy(), 0.85, rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_every_rule_decreases_a_quadratic_as_jax_does(name):
    """f(p) = |p|^2 / 2 over 20 steps at lr 0.05, both packages."""
    x0 = np.random.RandomState(2).randn(8).astype(np.float32)
    jopt, topt = JOPTIMIZERS.create(name, learning_rate=0.05), \
        t_create(name, learning_rate=0.05)
    jp, tp = {"x": jnp.asarray(x0)}, {"x": torch.from_numpy(x0)}
    jst, tst = jopt.init_state(jp), topt.init_state(tp)
    for _ in range(20):
        jp, jst = jopt.apply(jp, {"x": jp["x"]}, jst)
        tp, tst = topt.apply(tp, {"x": tp["x"]}, tst)
    assert float((tp["x"] ** 2).sum()) < float((x0 ** 2).sum())
    np.testing.assert_allclose(tp["x"].numpy(), np.asarray(jp["x"]),
                               rtol=1e-5, atol=1e-6)


def test_model_average_matches_jax():
    for window, expect in ((100, 2.0), (3, 3.5)):
        jma, tma = JModelAverage(max_average_window=window), \
            TModelAverage(max_average_window=window)
        jst = jma.init({"x": jnp.zeros(3, jnp.float32)})
        tst = tma.init({"x": torch.zeros(3)})
        for i in range(1, 5):
            jst = jma.accumulate(jst, {"x": jnp.full(3, float(i))})
            tst = tma.accumulate(tst, {"x": torch.full((3,), float(i))})
        assert_ulps(tma.average(tst)["x"], np.asarray(jma.average(jst)["x"]),
                    f"window {window}")
        assert float(tst["count"]) == float(jst["count"])
        np.testing.assert_allclose(tma.average(tst)["x"].numpy(), expect)


# ----------------------------------------------------------- schedules
SCHEDULE_CASES = [
    ("constant", 0.0, 0.0, ""), ("poly", 1e-3, 0.75, ""),
    ("poly", 0.0, 0.0, ""), ("caffe_poly", 20000.0, 0.5, ""),
    ("exp", 0.5, 100.0, ""), ("discexp", 0.5, 100.0, ""),
    ("discexp", 0.0, 0.0, ""), ("linear", 1e-4, 1e-3, ""),
    ("manual", 0.0, 0.0, "100:1.0,200:0.5,300:0.1"),
    ("pass_manual", 0.0, 0.0, "3:1.0,7:0.3")]
PROGRESS = [0, 1, 3, 7, 64, 99, 100, 150, 199, 200, 250, 299, 300, 1000,
            12345, 250000]


@pytest.mark.parametrize("case", SCHEDULE_CASES,
                         ids=[c[0] + str(i) for i, c in
                              enumerate(SCHEDULE_CASES)])
def test_schedules_match_jax(case):
    name, a, b, args = case
    want = j_schedule(name, 0.1, a, b, args)
    got = t_schedule(name, 0.1, a, b, args)
    for p in PROGRESS:
        w = np.float32(want(jnp.asarray(p, jnp.float32)))
        g = got(p)
        assert isinstance(g, float)
        assert_ulps(np.float32(g), w, f"{name} at {p}")


def test_schedule_reference_values_and_unknown_name():
    s = t_schedule("exp", base_lr=1.0, decay_a=0.5, decay_b=100.0)
    np.testing.assert_allclose(s(200), 0.25, rtol=1e-6)
    s = t_schedule("discexp", base_lr=1.0, decay_a=0.5, decay_b=100.0)
    np.testing.assert_allclose(s(199), 0.5, rtol=1e-6)
    s = t_schedule("linear", base_lr=1.0, decay_a=0.001, decay_b=0.1)
    np.testing.assert_allclose(s(500), 0.5, rtol=1e-6)
    np.testing.assert_allclose(s(5000), 0.1, rtol=1e-6)
    s = t_schedule("manual", base_lr=1.0, args="100:1.0,200:0.5,300:0.1")
    assert (s(50), s(150), s(250)) == (1.0, 0.5, np.float32(0.1))
    with pytest.raises(PaddleTpuError, match="learning_rate_schedule"):
        t_schedule("cosine")


# ------------------------------------------------- optimizer_from_config
def test_optimizer_from_config_matches_jax():
    from paddle_tpu.trainer.trainer import optimizer_from_config as j_ofc
    import dataclasses
    for kw in (dict(learning_method="sgd", momentum=0.9),
               dict(learning_method="adamax", adam_beta1=0.8),
               dict(learning_method="rmsprop", ada_rou=0.9,
                    ada_epsilon=1e-5),
               dict(learning_method="adagrad", ada_epsilon=1e-4,
                    l1_weight_decay=1e-3, l2_weight_decay=1e-4,
                    gradient_clipping_threshold=5.0),
               dict(learning_rate_schedule="poly",
                    learning_rate_decay_a=0.1, learning_rate_decay_b=0.5)):
        (jo, js), (to, ts) = j_ofc(JOpt(**kw)), optimizer_from_config(
            TOpt(**kw))
        assert type(to).__name__ == type(jo).__name__
        assert dataclasses.asdict(to) == dataclasses.asdict(jo)
        assert ts(40) == float(js(jnp.float32(40)))
    assert [f.name for f in dataclasses.fields(TOpt)] == \
        [f.name for f in dataclasses.fields(JOpt)]
    assert dataclasses.asdict(TOpt()) == dataclasses.asdict(JOpt())
    # the local-SGD period and the parameter server's exchange periods
    # are accepted and leave the rule and its schedule as they are, as
    # in the JAX package (which never reads the two periods)
    base_o, base_s = optimizer_from_config(TOpt())
    for kw in (dict(local_sgd_steps=2), dict(num_batches_per_send_parameter=2),
               dict(num_batches_per_get_parameter=3)):
        (jo, js), (to, ts) = j_ofc(JOpt(**kw)), optimizer_from_config(
            TOpt(**kw))
        assert dataclasses.asdict(to) == dataclasses.asdict(jo) \
            == dataclasses.asdict(base_o)
        assert ts(40) == float(js(jnp.float32(40))) == base_s(40)


# ------------------------------------------------------ the trainer
SCHEDULED = {
    "constant": {}, "poly": dict(learning_rate_decay_a=0.1,
                                 learning_rate_decay_b=0.5),
    "caffe_poly": dict(learning_rate_decay_a=64.0, learning_rate_decay_b=1.0),
    "exp": dict(learning_rate_decay_a=0.5, learning_rate_decay_b=16.0),
    "discexp": dict(learning_rate_decay_a=0.5, learning_rate_decay_b=16.0),
    "linear": dict(learning_rate_decay_a=1e-3, learning_rate_decay_b=0.01),
    "manual": dict(learning_rate_args="8:1.0,24:0.5,1000:0.25")}


def _fc_cfgs(hook=None):
    """x 16 -> fc 32 (named ``hid``, with ``hook`` on its weight) -> fc 4
    softmax -> classification cost, from the JAX DSL into both
    packages."""
    attr = None if hook is None else dsl.ParamAttr(update_hooks=hook)
    with config_scope():
        x = dsl.data_layer("x", dense_vector(16))
        y = dsl.data_layer("label", integer_value(4))
        hid = dsl.fc_layer(x, size=32, name="hid", param_attr=attr)
        pred = dsl.fc_layer(hid, size=4, act=dsl.SoftmaxActivation())
        jcfg = dsl.topology(dsl.classification_cost(pred, y))
    return jcfg, TModelConfig.from_json(jcfg.to_json())


def _fc_feed(rng):
    x = rng.randn(8, 16).astype(np.float32)
    y = rng.randint(0, 4, (8,)).astype(np.int32)
    return ({"x": jnp.asarray(x), "label": jnp.asarray(y)},
            {"x": torch.from_numpy(x), "label": torch.from_numpy(y)})


@pytest.mark.parametrize("schedule", sorted(SCHEDULED))
def test_schedules_drive_the_trainer_as_in_jax(schedule):
    """Each schedule on SGD through the trainers of the fc classifier,
    from the same parameters: the rate follows ``samples_seen`` (8 a
    step); five steps' losses rtol 1e-5, parameters atol 1e-5."""
    jcfg, tcfg = _fc_cfgs()
    kw = dict(learning_rate=0.1, learning_rate_schedule=schedule,
              **SCHEDULED[schedule])
    jtr = JTrainer(JNet(jcfg), opt_config=JOpt(**kw), seed=0)
    tnet = TNet(tcfg)
    ttr = TTrainer(tnet, TOpt(**kw), seed=0, device="cpu")
    ttr.params = network_params_from_jax(
        {n: np.array(v) for n, v in jtr.params.items()}, tnet, "cpu")
    rng = np.random.RandomState(6)
    rates = []
    for step in range(5):
        jf, tf = _fc_feed(rng)
        rates.append(ttr.schedule(ttr.samples_seen))
        want = float(jtr.train_one_batch(jf))
        got = float(ttr.train_one_batch(tf))
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"loss of step {step}")
    for name, p in jtr.params.items():
        np.testing.assert_allclose(ttr.params[name].numpy(), np.asarray(p),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert ttr.samples_seen == jtr.samples_seen == 40
    assert (len(set(rates)) == 1) == (schedule == "constant"), rates


# --------------------------------------------------------- fault C6
def test_static_pruning_mask_matches_jax_with_ties():
    rng = np.random.RandomState(4)
    for v in (rng.choice([-1.0, 1.0, 0.5, -0.5, 0.0], (7, 9)),
              rng.randn(5, 6), np.zeros((3, 3))):
        v = v.astype(np.float32)
        for ratio in (0.0, 0.3, 0.6, 0.75, 1.0):
            want = np.asarray(jhooks.static_pruning_mask(jnp.asarray(v),
                                                         ratio))
            got = thooks.static_pruning_mask(torch.from_numpy(v), ratio)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"ratio {ratio}")


def test_pruning_hook_gives_the_jax_masks_zeros_and_trajectory(tmp_path,
                                                               flags):
    """Fault C6: both trainers warm-start from the same unpruned values
    (``--init_model_path``), make the same masks (int(size * 0.25) kept,
    ties broken alike), zero the same weights, and keep them exactly 0
    through five Momentum steps (the ``optimizer=`` argument) while the
    survivors move as the reference's do."""
    jcfg, tcfg = _fc_cfgs(dsl.HookAttribute("pruning", sparsity_ratio=0.75))
    start = JNet(jcfg).init_params(0)
    d = jck.save_checkpoint(str(tmp_path), 0, start)
    for f in (JFLAGS, TFLAGS):
        f.set("init_model_path", d)
    jtr = JTrainer(JNet(jcfg), optimizer=JMomentum(learning_rate=0.1,
                                                   momentum=0.9))
    ttr = TTrainer(TNet(tcfg), device="cpu",
                   optimizer=TMomentum(learning_rate=0.1, momentum=0.9))
    for f in (JFLAGS, TFLAGS):
        f.set("init_model_path", "")
    wname = "_hid.w0"
    assert set(ttr._prune_masks) == set(jtr._prune_masks) == {wname}
    mask = np.asarray(jtr._prune_masks[wname])
    np.testing.assert_array_equal(ttr._prune_masks[wname].numpy(), mask)
    assert int(mask.sum()) == int(mask.size * 0.25)
    for n, p in jtr.params.items():
        np.testing.assert_array_equal(ttr.params[n].numpy(), np.asarray(p))
    w0 = ttr.params[wname].numpy().copy()
    rng = np.random.RandomState(3)
    for step in range(5):
        x = rng.randn(8, 16).astype(np.float32)
        y = rng.randint(0, 4, (8,)).astype(np.int32)
        want = float(jtr.train_one_batch({"x": jnp.asarray(x),
                                          "label": jnp.asarray(y)}))
        got = float(ttr.train_one_batch({"x": torch.from_numpy(x),
                                         "label": torch.from_numpy(y)}))
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"loss of step {step}")
    w = ttr.params[wname].numpy()
    np.testing.assert_array_equal(w * (1 - mask), 0.0)
    np.testing.assert_array_equal(np.asarray(jtr.params[wname]) * (1 - mask),
                                  0.0)
    assert np.any((w != w0) & (mask > 0))
    for n, p in jtr.params.items():
        np.testing.assert_allclose(ttr.params[n].numpy(), np.asarray(p),
                                   rtol=0, atol=1e-5, err_msg=n)
    # a load makes the masks anew from the loaded values
    ttr.load(d)
    np.testing.assert_array_equal(ttr._prune_masks[wname].numpy(), mask)
    assert int((ttr.params[wname] != 0).sum()) == int(mask.sum())


def test_a_pruned_table_stays_out_of_the_sparse_exchange(flags):
    """A ``sparse_update`` table with a pruning hook takes the masked
    dense update, as the reference's exchange plan rules it out."""
    from paddle_tpu_torch.models.ctr import ctr_classifier
    for f in (JFLAGS, TFLAGS):
        f.set("sparse_grads", True)
    plans = {}
    for hooked in (False, True):
        cfg = ctr_classifier(64, 8)
        if hooked:
            cfg.parameters[0].update_hooks = [{"type": "pruning",
                                               "sparsity_ratio": 0.5}]
        ttr = TTrainer(TNet(cfg), device="cpu")
        jtr = JTrainer(JNet(JModelConfig.from_json(cfg.to_json())))
        plans[hooked] = (ttr._sparse_exchange_plan(),
                         jtr._sparse_exchange_plan())
    assert plans[False][0] == plans[False][1] and plans[False][0]
    assert plans[True][0] == plans[True][1] == {}
