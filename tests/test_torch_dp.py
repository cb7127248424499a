"""The port's data-parallel and tensor-parallel training (the ``Trainer``
on a mesh) against the JAX package on its virtual CPU mesh.

The port's ranks are two spawned processes joined over gloo
(``tests/torch_dist_workers.py``), spawned once for the module; every
case starts from the parameters the JAX trainer was built with (its
pass-00000 checkpoint, loaded through ``--init_model_path``) and takes
the same global batches.  The JAX oracle is the JAX trainer on a
two-device mesh of ``tests/conftest.py``'s virtual devices.

- ``test_dp_sharded_equals_single_device`` / ``test_tp_sharded_equals_
  replicated``: the cases of ``tests/test_distributed.py`` (two ranks on
  ``data``; two ranks on ``model`` under ``tp_rules``).
- The places where a per-rank port could part from GSPMD, one test each:
  batch-norm statistics over the global batch, dropout masks that are
  the global mask's rows, the mixed-precision step's finite check over
  every rank, gradient clipping of the reduced gradient, the lazy
  row-sparse update over the union of the ranks' rows (both settings of
  ``--sparse_grads``), and evaluators over the global batch.

Tolerances: the JAX test's rtol 1e-5 / atol 1e-6 for losses and
parameters (rtol 2e-4 for the TP losses, as there).  Dropout is the one
trap held port against port: its 2 ranks against the port's own
one-process run within the same rtol/atol, because the two packages'
random streams differ (JAX keys, torch generators), so no element of a
mask can be held against JAX's; the masks are held against the JAX
package's by statistics (the keep share overall and on each rank's
rows, and the scaling).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.config import dsl
from paddle_tpu.config.dsl import config_scope
from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.core.device import build_mesh, set_mesh
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.data.feeder import (dense_vector, integer_value,
                                    integer_value_sequence)
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.parallel import tp_rules
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils import FLAGS as JFLAGS

from torch_dist_workers import run_cases, run_ranks

RTOL, ATOL = 1e-5, 1e-6
#: the dropout op's draw held against the JAX package's by statistics
DROPOUT_MASK = {"shape": (512, 64), "rate": 0.3, "seed": 13}


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    mesh = build_mesh(axes, jax.devices()[:n])
    set_mesh(mesh)
    return mesh


def _jfeed(feed):
    return {k: JSeq(jnp.asarray(v[1]), jnp.asarray(v[2]))
            if isinstance(v, tuple) else jnp.asarray(v)
            for k, v in feed.items()}


# ------------------------------------------------------------ the nets
def _fc_net():
    with config_scope():
        x = dsl.data("x", dense_vector(12))
        lab = dsl.data("label", integer_value(3))
        h = dsl.fc(x, size=16, act=dsl.TanhActivation())
        p = dsl.fc(h, size=3, act=dsl.SoftmaxActivation())
        return dsl.topology(dsl.classification_cost(p, lab))


def _emb_net():
    with config_scope():
        ids = dsl.data("ids", integer_value_sequence(64))
        lab = dsl.data("label", integer_value(2))
        emb = dsl.embedding(ids, size=16)
        pooled = dsl.pooling(emb)
        p = dsl.fc(pooled, size=2, act=dsl.SoftmaxActivation())
        return dsl.topology(dsl.classification_cost(p, lab))


def _bn_net():
    with config_scope():
        x = dsl.data("x", dense_vector(8))
        lab = dsl.data("label", integer_value(3))
        h = dsl.fc(x, size=16, act=dsl.LinearActivation(), bias_attr=False)
        h = dsl.batch_norm(h, act=dsl.ReluActivation())
        p = dsl.fc(h, size=3, act=dsl.SoftmaxActivation())
        return dsl.topology(dsl.classification_cost(p, lab))


def _dropout_net():
    with config_scope():
        x = dsl.data("x", dense_vector(12))
        lab = dsl.data("label", integer_value(3))
        h = dsl.fc(x, size=32, act=dsl.TanhActivation(),
                   layer_attr=dsl.ExtraAttr(drop_rate=0.5))
        p = dsl.fc(h, size=3, act=dsl.SoftmaxActivation())
        return dsl.topology(dsl.classification_cost(p, lab))


def _sparse_net():
    with config_scope():
        x = dsl.data("ids", integer_value_sequence(64))
        lab = dsl.data("label", integer_value(2))
        emb = dsl.embedding(x, size=8, param_attr=dsl.ParamAttr(
            name="_slot_emb.w", sparse_update=True, initial_std=0.02))
        pooled = dsl.pooling(emb, pooling_type=dsl.SumPooling())
        p = dsl.fc(pooled, size=2, act=dsl.SoftmaxActivation())
        return dsl.topology(dsl.classification_cost(p, lab))


def _dense_feeds(rng, n, b, dim, classes, scale=1.0):
    return [{"x": (scale * rng.randn(b, dim)).astype(np.float32),
             "label": rng.randint(0, classes, (b,)).astype(np.int32)}
            for _ in range(n)]


def _seq_feeds(rng, n, b, t, vocab, lo=0, hi=None):
    """Sequence feeds; rows ``i < b // 2`` draw ids in ``[lo, hi)`` when
    given (rank 0's rows), the others the whole vocabulary."""
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab, (b, t)).astype(np.int32)
        if hi is not None:
            ids[:b // 2] = rng.randint(lo, hi, (b // 2, t))
            ids[b // 2:] = rng.randint(hi, vocab, (b - b // 2, t))
        out.append({"ids": ("seq", ids, rng.randint(
                        max(1, t // 2), t + 1, (b,)).astype(np.int32)),
                    "label": rng.randint(0, 2, (b,)).astype(np.int32)})
    return out


# ----------------------------------------------------------- the cases
def _jax_run(cfg, opt, mesh_axes, feeds, root, name, seed, rules=None,
             flags=None, test_feeds=None):
    """The JAX oracle: its pass-00000 (for the port to start from), then
    a step a feed; → (ckpt dir, losses, trainer, test metrics)."""
    old = {k: getattr(JFLAGS, k) for k in (flags or {})}
    try:
        for k, v in (flags or {}).items():
            JFLAGS.set(k, v)
        mesh = _mesh(mesh_axes)
        tr = JTrainer(JNet(cfg), opt_config=JOpt(**opt), mesh=mesh,
                      seed=seed, sharding_rules=rules)
        ckpt = tr.save(os.path.join(root, name), 0)
        losses = [float(tr.train_one_batch(_jfeed(f))) for f in feeds]
        test = tr.test(lambda: iter([_jfeed(f) for f in test_feeds])) \
            if test_feeds else None
        return ckpt, losses, tr, test
    finally:
        for k, v in old.items():
            JFLAGS.set(k, v)
        set_mesh(None)


ERR = {"type": "classification_error",
       "name": "__classification_error_evaluator_0__",
       "input_layer_name": "__fc_1__", "label_layer_name": "label"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX oracles, then every case on two port ranks (one spawn)."""
    root = str(tmp_path_factory.mktemp("dp"))
    rng = np.random.RandomState(5)
    jax_side, cases = {}, {}

    def add(name, cfg, opt, feeds, seed, port_mesh, jax_mesh=None,
            rules=None, flags=None, test_feeds=None, **extra):
        ckpt, losses, tr, test = _jax_run(
            cfg, opt, jax_mesh or {"data": 2}, feeds, root, name, seed,
            rules=rules, flags=flags, test_feeds=test_feeds)
        jax_side[name] = (losses, tr, test)
        cases[name] = {"config": cfg.to_json(), "opt": opt, "feeds": feeds,
                       "ckpt": ckpt, "mesh": port_mesh, "flags": flags or {},
                       "test_feeds": test_feeds, **extra}

    momentum = dict(learning_method="momentum", momentum=0.9,
                    learning_rate=0.05)
    add("dp", _fc_net(), momentum, _dense_feeds(rng, 4, 16, 12, 3), 11,
        {"data": 2})
    add("tp", _emb_net(), dict(learning_method="adam", learning_rate=0.01),
        _seq_feeds(rng, 3, 8, 6, 64), 7, {"data": 1, "model": 2},
        jax_mesh={"data": 2}, tp=True)
    add("bn", _bn_net(), momentum, _dense_feeds(rng, 3, 16, 8, 3), 3,
        {"data": 2})
    # rank 1's rows are infinite: its gradient is not finite
    inf_feed = _dense_feeds(rng, 1, 16, 12, 3)[0]
    inf_feed["x"][8:] = np.inf
    add("finite", _fc_net(), dict(momentum, precision="bf16"),
        [inf_feed] + _dense_feeds(rng, 1, 16, 12, 3), 4, {"data": 2})
    # a threshold the per-rank gradients pass and their mean does not
    add("clip", _fc_net(), dict(learning_method="sgd", learning_rate=0.5,
                                gradient_clipping_threshold=0.02),
        _dense_feeds(rng, 3, 16, 12, 3, scale=3.0), 6, {"data": 2})
    for sparse in (True, False):
        add(f"sparse_{sparse}", _sparse_net(),
            dict(learning_method="adam", learning_rate=0.05),
            _seq_feeds(rng, 3, 16, 4, 64, lo=0, hi=32), 2, {"data": 2},
            flags={"sparse_grads": sparse})
    cfg = _fc_net()
    cfg.evaluators.append(dict(ERR))
    add("eval", cfg, momentum, _dense_feeds(rng, 2, 16, 12, 3), 8,
        {"data": 2}, test_feeds=_dense_feeds(rng, 3, 16, 12, 3))
    cases["dropout"] = {"config": _dropout_net().to_json(), "opt": momentum,
                        "feeds": _dense_feeds(rng, 3, 16, 12, 3),
                        "mesh": {"data": 2}, "seed": 9, "single": True}
    # 15 rows do not divide over 2 ranks: the feed stays whole on both
    cases["dropout_odd"] = {**cases["dropout"],
                            "feeds": _dense_feeds(rng, 3, 15, 12, 3)}
    cases["dropout_mask"] = {"fn": "dropout_mask_case", **DROPOUT_MASK}
    port = run_ranks(run_cases, 2, cases, deadline_s=120.0)
    return jax_side, port


def _close_params(jtr, got, rtol=RTOL, atol=ATOL):
    for name, p in jtr.params.items():
        np.testing.assert_allclose(got["params"][name], np.asarray(p),
                                   rtol=rtol, atol=atol, err_msg=name)


def _same_on_ranks(port, case):
    for name, p in port[0][case]["params"].items():
        np.testing.assert_array_equal(p, port[1][case]["params"][name],
                                      err_msg=name)
    np.testing.assert_array_equal(port[0][case]["losses"],
                                  port[1][case]["losses"])


def test_dp_sharded_equals_single_device(runs):
    """Two ranks on ``data`` = the JAX trainer on identical global
    batches: the losses (every rank reports the global one) and the
    parameters after 4 momentum steps."""
    jax_side, port = runs
    losses, jtr, _ = jax_side["dp"]
    np.testing.assert_allclose(port[0]["dp"]["losses"], losses, rtol=RTOL)
    _close_params(jtr, port[0]["dp"])
    _same_on_ranks(port, "dp")
    assert port[0]["dp"]["placed"] == []


def test_tp_sharded_equals_replicated(runs):
    """Two ranks on ``model`` under ``tp_rules``: the table rows and the
    fc columns at rest sharded, the trajectory the replicated one's."""
    jax_side, port = runs
    losses, jtr, _ = jax_side["tp"]
    np.testing.assert_allclose(port[0]["tp"]["losses"], losses, rtol=2e-4)
    _close_params(jtr, port[0]["tp"], rtol=2e-4, atol=1e-5)
    assert port[0]["tp"]["placed"] == sorted(
        n for n in jtr.params if n.endswith(".w0"))
    full = sum(v.nbytes for v in port[0]["tp"]["params"].values())
    assert port[0]["tp"]["bytes"]["params"] < 0.6 * full


def test_batch_norm_statistics_span_the_global_batch(runs):
    jax_side, port = runs
    losses, jtr, _ = jax_side["bn"]
    np.testing.assert_allclose(port[0]["bn"]["losses"], losses, rtol=RTOL)
    _close_params(jtr, port[0]["bn"])
    for name, b in jtr.buffers.items():
        np.testing.assert_allclose(port[0]["bn"]["buffers"][name],
                                   np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    _same_on_ranks(port, "bn")


def _jax_dropout_mask(shape, rate, seed):
    """The JAX package's dropout of ones on a two-device ``data`` mesh
    (the batch dim sharded): one draw of the global shape."""
    from jax.sharding import NamedSharding, PartitionSpec
    from paddle_tpu.ops import nn_ops as jops
    mesh = _mesh({"data": 2})
    try:
        x = jax.device_put(jnp.ones(shape, jnp.float32),
                           NamedSharding(mesh, PartitionSpec("data")))
        return np.asarray(jax.jit(lambda v: jops.dropout(
            v, jax.random.PRNGKey(seed), rate))(x))
    finally:
        set_mesh(None)


def _dropout_matches_one_process(port, case):
    got, one = port[0][case], port[0][case]["single"]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=RTOL)
    for name, p in one["params"].items():
        np.testing.assert_allclose(got["params"][name], p, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    _same_on_ranks(port, case)


def test_dropout_masks_are_the_global_masks_rows(runs):
    """Each rank's mask is its rows of the one-process step's mask: two
    ranks train as the port does in one process.

    The masks are held against the JAX package's by statistics, not
    element by element (its keys are not the port's generators): on a
    [512, 64] tensor of ones at rate 0.3, the port's two ranks' rows
    together are its one-process draw bit for bit, the two ranks' rows
    differ, and in both packages every value is 0 or 1/0.7 and the kept
    share of the whole tensor and of each rank's half lies within 5
    binomial standard deviations of 0.7."""
    _, port = runs
    _dropout_matches_one_process(port, "dropout")
    spec = DROPOUT_MASK
    rows = [port[r]["dropout_mask"]["out"] for r in (0, 1)]
    mine = np.concatenate(rows)
    np.testing.assert_array_equal(mine, port[0]["dropout_mask"]["whole"])
    assert not np.array_equal(rows[0], rows[1])
    theirs = _jax_dropout_mask(spec["shape"], spec["rate"], spec["seed"])
    keep = 1.0 - spec["rate"]
    for m in (mine, theirs):
        assert m.shape == spec["shape"]
        vals = np.unique(m)
        np.testing.assert_allclose(vals, [0.0, np.float32(1.0) / keep],
                                   rtol=1e-6)
        for part in (m, m[:256], m[256:]):
            sigma = np.sqrt(keep * (1 - keep) / part.size)
            assert abs((part > 0).mean() - keep) < 5 * sigma


def test_dropout_on_an_undivided_batch_is_the_one_process_mask(runs):
    """15 rows do not divide over 2 ranks: the feed stays whole on both
    and each draws the one-process step's whole mask (no rank keeps rows
    of a larger draw), as the JAX step replicates such a leaf."""
    _dropout_matches_one_process(runs[1], "dropout_odd")


def test_mixed_precision_finite_check_is_global(runs):
    """Rank 1's rows are infinite: both ranks skip the step (parameters
    as loaded, the scale halved), as the JAX step over the global batch
    does; the next step is the JAX one's (bf16 compute: rtol 1e-2, atol
    1e-3)."""
    jax_side, port = runs
    losses, jtr, _ = jax_side["finite"]
    assert int(jtr._ls_state.skipped_total) == 1
    np.testing.assert_allclose(port[0]["finite"]["losses"][1], losses[1],
                               rtol=1e-2)
    _close_params(jtr, port[0]["finite"], rtol=1e-2, atol=1e-3)
    for r in (0, 1):
        assert port[r]["finite"]["loss_scale"] == \
            float(jtr._ls_state.scale)
    _same_on_ranks(port, "finite")


def test_gradient_clipping_clips_the_reduced_gradient(runs):
    jax_side, port = runs
    losses, jtr, _ = jax_side["clip"]
    np.testing.assert_allclose(port[0]["clip"]["losses"], losses, rtol=RTOL)
    _close_params(jtr, port[0]["clip"])


@pytest.mark.parametrize("sparse", [True, False], ids=["exchange", "masked"])
def test_sparse_update_uses_the_union_of_rows(runs, sparse):
    """Rank 0's rows touch ids < 32, rank 1's the rest: both ranks move
    the union's rows (and their Adam moments) as the JAX step does."""
    jax_side, port = runs
    losses, jtr, _ = jax_side[f"sparse_{sparse}"]
    got = port[0][f"sparse_{sparse}"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    _close_params(jtr, got, rtol=1e-4, atol=1e-6)
    _same_on_ranks(port, f"sparse_{sparse}")


def test_evaluators_run_over_the_global_batch(runs):
    jax_side, port = runs
    _, _, want = jax_side["eval"]
    for r in (0, 1):
        got = port[r]["eval"]["test"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
