"""The port's sparse embedding lane against the JAX package's, on the CPU:
``parallel/sparse.py``, the row gather (``ops/embedding.py``, kernel 22
on the card), ``Optimizer.apply(..., sparse_masks=)`` and
``Optimizer.apply_rows``, and the trainer's sparse gradient exchange and
masked path on ``bench.py``'s CTR net (``models/ctr.py``).

Inputs come from numpy seeds and go through both packages.  The JAX side
runs its Pallas gather in interpret mode where a test needs its kernel
decision (``--embedding_kernel_interpret``); the port runs on CPU
tensors, so its gather wrapper takes its plain version.

Tolerances: the dedupe, lookups, masks and gathers exact; ``apply_rows``
and the masked update within 1e-6 relative (elementwise rules, one
rounding order); the CTR trainer after 3 steps within rtol 1e-4, atol
1e-6 of the JAX trainer (``bench.py``'s in-lane equivalence bound; the
sums of the forward and backward run in other orders); untouched rows
and their Adam moments bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl
from paddle_tpu.config.dsl import config_scope
from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.data.feeder import integer_value, integer_value_sequence
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.observe import REGISTRY
from paddle_tpu.ops import pallas_embedding as jemb
from paddle_tpu.optimizer.optimizers import OPTIMIZERS as JOPTIMIZERS
from paddle_tpu.parallel import sparse as jsp
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu_torch.config.model_config import (LayerConfig, LayerInput,
                                                  OptimizationConfig as TOpt)
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.models import CTR_OPT, ctr_classifier
from paddle_tpu_torch.ops import embedding as temb
from paddle_tpu_torch.optimizer.optimizers import SGD, Adam
from paddle_tpu_torch.parallel import sparse as tsp
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from paddle_tpu_torch.utils import FLAGS as TFLAGS
from paddle_tpu_torch.utils.jax_interop import (network_params_from_jax,
                                                opt_state_from_jax)

FLAG_NAMES = ("sparse_grads", "sparse_grad_rows", "embedding_kernel",
              "precision", "loss_scale_init")
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = [(f, {k: f.get(k) for k in FLAG_NAMES})
             for f in (JFLAGS, TFLAGS)]
    saved_interp = JFLAGS.get("embedding_kernel_interpret")
    yield
    for f, values in saved:
        for k, v in values.items():
            f.set(k, v)
    JFLAGS.set("embedding_kernel_interpret", saved_interp)


def _set_both(**kw):
    for k, v in kw.items():
        JFLAGS.set(k, v)
        TFLAGS.set(k, v)


# ------------------------------------------------------------ parts
@pytest.mark.parametrize("capacity", [40, 24, 16, 6])
def test_unique_rows_sorted_matches_jax(capacity):
    """Capacity above, at (16 unique ids) and below the unique count:
    below it the smallest ids are kept, as ``jnp.unique(size=)`` keeps
    them."""
    rng = np.random.RandomState(0)
    ids = rng.choice(np.arange(5, 60, 3), size=(4, 6)).astype(np.int32)
    assert len(np.unique(ids)) == 16
    want = np.asarray(jsp.unique_rows_sorted(jnp.asarray(ids), capacity,
                                             64))
    got = tsp.unique_rows_sorted(torch.from_numpy(ids), capacity, 64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("capacity", [30, 16])
def test_unique_rows_matches_jax(capacity):
    rng = np.random.RandomState(1)
    ids = rng.choice(np.arange(5, 60, 3), size=(4, 6)).astype(np.int32)
    w_rows, w_inv = (np.asarray(x) for x in jsp.unique_rows(
        jnp.asarray(ids), capacity))
    rows, inv = tsp.unique_rows(torch.from_numpy(ids), capacity)
    np.testing.assert_array_equal(rows.numpy(), w_rows)
    np.testing.assert_array_equal(inv.numpy(), w_inv)
    np.testing.assert_array_equal(rows.numpy()[inv.numpy()], ids)


def test_lookup_rows_and_prefetch_match_jax():
    rng = np.random.RandomState(2)
    table = rng.randn(50, 8).astype(np.float32)
    ids = rng.randint(0, 50, (3, 7)).astype(np.int32)
    rows = jsp.unique_rows_sorted(jnp.asarray(ids), 21, 50)
    block = jemb.gather_rows_reference(jnp.asarray(table), rows)
    want = np.asarray(jsp.lookup_rows(rows, block, jnp.asarray(ids)))
    t_rows = tsp.unique_rows_sorted(torch.from_numpy(ids), 21, 50)
    t_block = temb.gather_rows_reference(torch.from_numpy(table), t_rows)
    got = tsp.lookup_rows(t_rows, t_block, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[ids])
    w_rows, w_block, w_inv = jsp.prefetch_rows(jnp.asarray(table),
                                               jnp.asarray(ids), 24)
    rows2, block2, inv2 = tsp.prefetch_rows(torch.from_numpy(table),
                                            torch.from_numpy(ids), 24)
    np.testing.assert_array_equal(
        tsp.sparse_embedding_lookup(block2, inv2).numpy(),
        np.asarray(jsp.sparse_embedding_lookup(w_block, w_inv)))
    np.testing.assert_array_equal(rows2.numpy(), np.asarray(w_rows))


def test_touched_row_mask_and_scatters_match_jax():
    rng = np.random.RandomState(3)
    g = np.zeros((30, 4), np.float32)
    g[[2, 7, 29]] = rng.randn(3, 4)
    g[11, 1] = -0.5
    np.testing.assert_array_equal(
        tsp.touched_row_mask(torch.from_numpy(g)).numpy(),
        np.asarray(jsp.touched_row_mask(jnp.asarray(g))))
    ids = np.asarray([[3, 3, 9], [0, 29, 9]], np.int32)
    np.testing.assert_array_equal(
        tsp.touched_row_mask(torch.from_numpy(g),
                             torch.from_numpy(ids)).numpy(),
        np.asarray(jsp.touched_row_mask(jnp.asarray(g), jnp.asarray(ids))))
    table = rng.randn(30, 4).astype(np.float32)
    rows = np.asarray([4, -1, 17, 0, -1], np.int32)
    vals = rng.randn(5, 4).astype(np.float32)
    np.testing.assert_array_equal(
        tsp.row_scatter_add(torch.from_numpy(table), torch.from_numpy(rows),
                            torch.from_numpy(vals)).numpy(),
        np.asarray(jsp.row_scatter_add(jnp.asarray(table), jnp.asarray(rows),
                                       jnp.asarray(vals))))
    np.testing.assert_array_equal(
        tsp.row_scatter_set(torch.from_numpy(table), torch.from_numpy(rows),
                            torch.from_numpy(vals)).numpy(),
        np.asarray(jsp.row_scatter_set(jnp.asarray(table), jnp.asarray(rows),
                                       jnp.asarray(vals))))
    # only pads (no real slot): nothing moves
    pads = torch.tensor([-1, 30, 31], dtype=torch.int32)
    assert torch.equal(tsp.row_scatter_set(torch.from_numpy(table), pads,
                                           torch.zeros(3, 4)),
                       torch.from_numpy(table))
    sel = tsp.SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals),
                           30).to_dense()
    np.testing.assert_array_equal(sel.numpy(), np.asarray(
        jsp.SelectedRows(jnp.asarray(rows), jnp.asarray(vals),
                         30).to_dense()))
    assert tsp.exchange_payload_bytes(16384, 64) == \
        jsp.exchange_payload_bytes(16384, 64) == 16384 * 260


# ----------------------------------------------------------- the gather
def _dispatch_delta(fn):
    c = REGISTRY.counter("embedding_dispatch_total")

    def snap():
        return {(s["labels"].get("path"), s["labels"].get("reason")):
                s["value"] for s in c.samples()}
    before = snap()
    out = fn()
    return out, {k: int(v - before.get(k, 0.0)) for k, v in snap().items()
                 if v != before.get(k, 0.0)}


def _gate_case(case):
    rng = np.random.RandomState(4)
    rows = np.asarray([0, 5, 95, 5, -1, 96], np.int32)   # dups and pads
    table = rng.randn(96, 128).astype(np.float32)
    flags, allow = {"embedding_kernel": True}, True
    if case == "flag_off":
        flags["embedding_kernel"] = False
    elif case == "sharded":
        allow = False
    elif case == "rank":
        rows = rows.reshape(2, 3)
    elif case == "unaligned":
        table = table[:, :64].copy()
    elif case == "dtype":
        return table, rows, flags, allow, True
    return table, rows, flags, allow, False


@pytest.mark.parametrize("case", ["kernel", "flag_off", "sharded", "rank",
                                  "unaligned", "dtype"])
def test_gather_rows_labels_and_bytes_match_jax(case):
    """Each decision of the gate carries the reference's label (the JAX
    side in interpret mode, so that its gate reaches the kernel step),
    and the gathered rows are bit-equal: pads clamp to a real row."""
    table, rows, flags, allow, bf16 = _gate_case(case)
    _set_both(**flags)
    JFLAGS.set("embedding_kernel_interpret", True)
    jt = jnp.asarray(table).astype(jnp.bfloat16 if bf16 else jnp.float32)
    tt = torch.from_numpy(table).to(torch.bfloat16 if bf16
                                    else torch.float32)
    want, want_labels = _dispatch_delta(lambda: np.asarray(
        jemb.gather_rows(jt, jnp.asarray(rows), allow).astype(jnp.float32)))
    temb.embedding_dispatch_total.clear()
    temb.reset_launch_counts()
    got = temb.gather_rows(tt, torch.from_numpy(rows), allow)
    assert dict(temb.embedding_dispatch_total) == want_labels
    assert temb.embedding_gather.launches == 0        # CPU: plain version
    assert want_labels == ({("kernel", ""): 1} if case == "kernel" else
                           {("dense", case): 1})
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(jemb.gather_rows_reference(
            jt, jnp.asarray(rows)).astype(jnp.float32)))


def test_gather_rows_backward_matches_jax():
    """The gather's gradient: row cotangents scatter-added into the table,
    duplicates accumulating, pads dropped."""
    rng = np.random.RandomState(5)
    table = rng.randn(40, 128).astype(np.float32)
    rows = np.asarray([3, 39, 3, -1, 40, 0], np.int32)
    cot = rng.randn(6, 128).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(
        jemb.gather_rows(t, jnp.asarray(rows)) * cot))(jnp.asarray(table)))
    tt = torch.from_numpy(table).requires_grad_(True)
    (temb.gather_rows(tt, torch.from_numpy(rows))
     * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), want, rtol=0, atol=1e-6)
    assert np.abs(want[4:39]).max() == 0 == np.abs(tt.grad.numpy()[4:39]).max()


def test_card_gather_launches_kernel_22_only_where_the_gate_says(
        monkeypatch):
    """On the card: D 128 fp32 launches kernel 22 once with the clamping
    left to it; D 64 (``unaligned``) and ``--embedding_kernel=false``
    take the plain gather, which is the reference's path there."""
    launched = []
    monkeypatch.setattr(temb, "_on_card", lambda tensors: True)
    monkeypatch.setattr(temb, "_launch", lambda symbol, device, *args:
                        launched.append((symbol, args)))
    temb.reset_launch_counts()
    temb.embedding_dispatch_total.clear()
    rows = torch.tensor([7, -1, 9, 40], dtype=torch.int32)
    temb.gather_rows(torch.zeros(40, 128), rows)
    assert [s for s, _ in launched] == ["embedding_gather"]
    assert launched[0][1][1] == rows.data_ptr()
    assert launched[0][1][3:] == (4, 40, 128)
    temb.gather_rows(torch.zeros(40, 64), rows)
    TFLAGS.set("embedding_kernel", False)
    temb.gather_rows(torch.zeros(40, 128), rows)
    assert len(launched) == 1 and temb.embedding_gather.launches == 1
    assert temb.embedding_dispatch_total == {
        ("kernel", ""): 1, ("dense", "unaligned"): 1,
        ("dense", "flag_off"): 1}
    temb.reset_launch_counts()


def test_embedding_gather_refuses_what_the_kernel_does_not_take():
    from paddle_tpu_torch.utils import PaddleTpuError
    rows = torch.zeros(3, dtype=torch.int32)
    for table, r in ((torch.zeros(8, 64), rows),
                     (torch.zeros(8, 128, dtype=torch.bfloat16), rows),
                     (torch.zeros(8, 128), rows.long())):
        with pytest.raises(PaddleTpuError):
            temb.embedding_gather(table, r)


# ------------------------------------------------------ the optimizers
def _opt_pair(method):
    kw = dict(learning_rate=0.05, gradient_clipping_threshold=0.3,
              weight_decay=1e-3)
    return JOPTIMIZERS.get(method)(**kw), {"sgd": SGD, "adam": Adam}[
        method](**kw)


def _adam_state(rng, v, d, count):
    m = rng.randn(v, d).astype(np.float32) * 0.1
    s = np.abs(rng.randn(v, d).astype(np.float32)) * 0.01
    return count, (m, s)


@pytest.mark.parametrize("method", ["sgd", "adam"])
def test_apply_rows_matches_jax(method):
    """Three row updates (the count threads through), from a state with
    non-zero moments; rows with pads at -1 and at V; within 1e-6
    relative of the JAX package's, and the rows outside untouched."""
    rng = np.random.RandomState(6)
    jopt, topt = _opt_pair(method)
    v, d = 50, 8
    table = rng.randn(v, d).astype(np.float32)
    count, slot = _adam_state(rng, v, d, 4) if method == "adam" \
        else (4, ())
    j_state = (jnp.asarray(count, jnp.int32),
               tuple(jnp.asarray(x) for x in slot))
    t_state = (torch.tensor(count, dtype=torch.int32),
               tuple(torch.from_numpy(x.copy()) for x in slot))
    jt, tt = jnp.asarray(table), torch.from_numpy(table.copy())
    touched = np.zeros(v, bool)
    for step in range(3):
        ids = rng.randint(0, v, (16,)).astype(np.int32)
        rows = np.array(jsp.unique_rows_sorted(jnp.asarray(ids), 20, v))
        rows[rng.rand(20) < 0.2] = -1
        g = rng.randn(20, d).astype(np.float32)
        jt, j_state = jopt.apply_rows(jt, jnp.asarray(rows), jnp.asarray(g),
                                      j_state)
        tt, t_state = topt.apply_rows(tt, torch.from_numpy(rows),
                                      torch.from_numpy(g), t_state)
        touched[rows[(rows >= 0) & (rows < v)]] = True
    assert int(t_state[0]) == int(j_state[0]) == 7
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(tt.numpy()[~touched], table[~touched])
    for a, b, s0 in zip(t_state[1], j_state[1], slot):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_array_equal(a.numpy()[~touched], s0[~touched])


@pytest.mark.parametrize("method", ["sgd", "adam"])
def test_masked_apply_matches_jax_and_apply_rows(method):
    """``apply(..., sparse_masks=)``: the lazy dense update equals the
    JAX package's and the port's ``apply_rows`` on the same rows."""
    rng = np.random.RandomState(7)
    jopt, topt = _opt_pair(method)
    v, d = 40, 6
    table = rng.randn(v, d).astype(np.float32)
    w = rng.randn(3, 5).astype(np.float32)
    rows = np.asarray([1, 4, 9, 33, -1, 40], np.int32)
    g_rows = rng.randn(6, d).astype(np.float32)
    g = np.array(jsp.SelectedRows(jnp.asarray(rows), jnp.asarray(g_rows),
                                    v).to_dense())
    gw = rng.randn(3, 5).astype(np.float32)
    count, slot = _adam_state(rng, v, d, 2) if method == "adam" \
        else (2, ())
    w_slot = tuple(np.ones_like(w) * 0.01 for _ in slot)
    mask = np.array(jsp.touched_row_mask(jnp.asarray(g)))
    jp, (jc, js) = jopt.apply(
        {"t": jnp.asarray(table), "w": jnp.asarray(w)},
        {"t": jnp.asarray(g), "w": jnp.asarray(gw)},
        (jnp.asarray(count, jnp.int32),
         [tuple(jnp.asarray(x) for x in slot),
          tuple(jnp.asarray(x) for x in w_slot)]),
        sparse_masks={"t": jnp.asarray(mask), "w": None})
    tp, (tc, ts) = topt.apply(
        {"t": torch.from_numpy(table), "w": torch.from_numpy(w)},
        {"t": torch.from_numpy(g), "w": torch.from_numpy(gw)},
        (torch.tensor(count, dtype=torch.int32),
         {"t": tuple(torch.from_numpy(x) for x in slot),
          "w": tuple(torch.from_numpy(x) for x in w_slot)}),
        sparse_masks={"t": torch.from_numpy(mask), "w": None})
    assert int(tc) == int(jc) == count + 1
    for name, i in (("t", 0), ("w", 1)):
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   rtol=1e-6, atol=1e-7)
        for a, b in zip(ts[name], js[i]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
    np.testing.assert_array_equal(tp["t"].numpy()[~mask], table[~mask])
    rt, (_, rs) = topt.apply_rows(
        torch.from_numpy(table.copy()), torch.from_numpy(rows),
        torch.from_numpy(g_rows),
        (torch.tensor(count, dtype=torch.int32),
         tuple(torch.from_numpy(x.copy()) for x in slot)))
    np.testing.assert_allclose(rt.numpy(), tp["t"].numpy(), rtol=1e-6,
                               atol=1e-7)
    for a, b in zip(rs, ts["t"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-9)


# ----------------------------------------------------- the CTR trainer
def _jax_ctr(vocab, emb_dim):
    """``bench.py``'s ``_sparse_trainer`` net through the JAX DSL."""
    with config_scope():
        x = dsl.data("ids", integer_value_sequence(vocab))
        lab = dsl.data("label", integer_value(2))
        emb = dsl.embedding(x, size=emb_dim, param_attr=dsl.ParamAttr(
            name="_slot_emb.w", sparse_update=True, initial_std=0.02))
        pooled = dsl.pooling(emb, pooling_type=dsl.SumPooling())
        tower = dsl.fc(pooled, size=32, act=dsl.ReluActivation())
        pred = dsl.fc(tower, size=2, act=dsl.SoftmaxActivation())
        return dsl.topology(dsl.classification_cost(pred, lab))


def test_ctr_config_matches_jax():
    assert ctr_classifier(1024, 64).to_json() == _jax_ctr(1024, 64).to_json()


def _feed(seed, vocab, b=16, t=8, hi=None):
    """``bench.py``'s feed: ids in [0, hi or V), full lengths, labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, hi or vocab, (b, t)).astype(np.int32)
    lab = rng.randint(0, 2, (b,)).astype(np.int32)
    ln = np.full((b,), t, np.int32)
    return ({"ids": JSeq(jnp.asarray(ids), jnp.asarray(ln)),
             "label": jnp.asarray(lab)},
            {"ids": TSeq(torch.from_numpy(ids), torch.from_numpy(ln)),
             "label": torch.from_numpy(lab)})


def _trainers(vocab, emb_dim, precision):
    opt = dict(CTR_OPT, precision=precision)
    jtr = JTrainer(JNet(_jax_ctr(vocab, emb_dim)), opt_config=JOpt(**opt),
                   seed=0)
    tnet = TNet(ctr_classifier(vocab, emb_dim))
    ttr = TTrainer(tnet, opt_config=TOpt(**opt), seed=0, device="cpu")
    ttr.params = network_params_from_jax(
        {n: np.array(v) for n, v in jtr.params.items()}, tnet, "cpu")
    return jtr, ttr


@pytest.mark.parametrize("sparse", [True, False], ids=["exchange", "masked"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("emb_dim", [64, 128])
def test_ctr_steps_match_jax(emb_dim, precision, sparse):
    """Three steps of the CTR net at V 1024, B 16, T 8 from the JAX
    trainer's parameters: the losses and every parameter within rtol
    1e-4, atol 1e-6; both take the same path (the exchange plan)."""
    _set_both(sparse_grads=sparse)
    jtr, ttr = _trainers(1024, emb_dim, precision)
    for step in range(3):
        jf, tf = _feed(3 + step, 1024)
        want = float(jtr.train_one_batch(jf))
        got = float(ttr.train_one_batch(tf))
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=str(step))
    plan = {"_slot_emb.w": ["ids"]} if sparse else {}
    assert ttr._sparse_exchange_plan() == jtr._sparse_exchange_plan() == plan
    for name, p in jtr.params.items():
        np.testing.assert_allclose(ttr.params[name].numpy(), np.asarray(p),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert int(ttr.opt_state[0]) == int(jtr.opt_state[0]) == 3


@pytest.mark.parametrize("sparse", [True, False], ids=["exchange", "masked"])
def test_untouched_rows_and_adam_moments_bit_identical(sparse):
    """Fault C3: a ``sparse_update`` table's rows that a batch does not
    touch keep their value and their (non-zero) Adam moments bit for
    bit.  The port and JAX start from the JAX trainer's parameters and
    moments after one step over the whole vocabulary, then take one
    step on ids 0..9 only.  Before the fix the port gave the table the
    dense update, and Adam moved every row with a non-zero moment."""
    _set_both(sparse_grads=sparse)
    jtr, ttr = _trainers(64, 8, "fp32")
    for seed in (20, 22, 23):
        jtr.train_one_batch(_feed(seed, 64)[0])
    names = sorted(jtr.params)
    count, slots = jtr.opt_state
    before = {n: np.array(v) for n, v in jtr.params.items()}
    m0 = [np.array(x) for x in slots[names.index("_slot_emb.w")]]
    ttr.params = network_params_from_jax(before, ttr.network, "cpu")
    ttr.opt_state = opt_state_from_jax(
        int(count), {n: s for n, s in zip(names, slots)}, ttr.params, "cpu")
    # moments off zero on most untouched rows
    assert (np.abs(m0[0][10:]).max(axis=1) > 0).mean() > 0.9
    jf, tf = _feed(21, 64, hi=10)
    jtr.train_one_batch(jf)
    ttr.train_one_batch(tf)
    table = ttr.params["_slot_emb.w"].numpy()
    np.testing.assert_array_equal(table[10:], before["_slot_emb.w"][10:])
    assert np.abs(table[:10] - before["_slot_emb.w"][:10]).max() > 0
    for got, m in zip(ttr.opt_state[1]["_slot_emb.w"], m0):
        np.testing.assert_array_equal(got.numpy()[10:], m[10:])
    for got, want in zip(ttr.opt_state[1]["_slot_emb.w"],
                         jtr.opt_state[1][names.index("_slot_emb.w")]):
        np.testing.assert_array_equal(got.numpy()[10:],
                                      np.asarray(want)[10:])
    np.testing.assert_allclose(table, np.asarray(jtr.params["_slot_emb.w"]),
                               rtol=RTOL, atol=ATOL)


def test_exchange_differentiates_the_block_not_the_table(monkeypatch):
    """The exchange step's gradient is a [K, D] block (K = the batch's
    id count, ``--sparse_grad_rows`` 0), the table never enters autograd,
    and the update goes through ``apply_rows``; a manual capacity sets
    K."""
    _set_both(sparse_grads=True)
    _, ttr = _trainers(1024, 64, "fp32")
    seen = []
    orig = ttr.optimizer.apply_rows

    def spy(table, rows, row_grads, state, lr=None, keep=None):
        seen.append((table.requires_grad, tuple(rows.shape),
                     tuple(row_grads.shape)))
        return orig(table, rows, row_grads, state, lr, keep)
    monkeypatch.setattr(ttr.optimizer, "apply_rows", spy)
    ttr.train_one_batch(_feed(5, 1024)[1])
    TFLAGS.set("sparse_grad_rows", 200)
    ttr.train_one_batch(_feed(6, 1024)[1])
    assert seen == [(False, (128,), (128, 64)), (False, (200,), (200, 64))]


def _dense_leg_nets(vocab):
    """The CTR net with a float input ``x`` into the tower, so a feed of
    inf overflows the bf16 step (the reference's ``dense_leg``)."""
    cfg = ctr_classifier(vocab, 8)
    tower = next(lc for lc in cfg.layers if lc.name == "__fc_3__")
    tower.inputs.append(LayerInput(input_layer_name="x"))
    cfg.layers.insert(0, LayerConfig(name="x", type="data", size=4))
    return TNet(cfg)


def test_bf16_exchange_skips_an_overflowing_step():
    """Under ``--precision=bf16`` a non-finite gradient skips the step
    on the exchange path too: params (the table's rows included) and
    optimizer state bit-identical, the scale halved."""
    _set_both(sparse_grads=True, loss_scale_init=1024.0)
    ttr = TTrainer(_dense_leg_nets(64), opt_config=TOpt(
        **CTR_OPT, precision="bf16"), seed=0, device="cpu")
    _, tf = _feed(30, 64)
    good = dict(tf, x=torch.randn(16, 4, generator=torch.Generator()
                                  .manual_seed(0)))
    ttr.train_one_batch(good)
    assert ttr._sparse_exchange_plan() == {"_slot_emb.w": ["ids"]}
    p0 = {n: p.clone() for n, p in ttr.params.items()}
    s0 = {n: tuple(x.clone() for x in s)
          for n, s in ttr.opt_state[1].items()}
    ttr.train_one_batch(dict(tf, x=torch.full((16, 4), float("inf"))))
    assert all(torch.equal(ttr.params[n], p) for n, p in p0.items())
    assert all(torch.equal(a, b) for n, s in s0.items()
               for a, b in zip(ttr.opt_state[1][n], s))
    assert int(ttr.opt_state[0]) == 1
    assert float(ttr._ls_state.scale) == 512.0
    ttr.train_one_batch(good)
    assert int(ttr.opt_state[0]) == 2
    assert not torch.equal(ttr.params["_slot_emb.w"], p0["_slot_emb.w"])


def test_card_exchange_step_launches_kernel_22_once(monkeypatch):
    """On the card the D 128 exchange step gathers its block with kernel
    22, once a step; at D 64 the gate says ``unaligned`` and the plain
    gather runs, no launch."""
    launched = []
    monkeypatch.setattr(temb, "_on_card", lambda tensors: True)
    monkeypatch.setattr(temb, "_launch", lambda symbol, device, *args:
                        launched.append(symbol))
    _set_both(sparse_grads=True)
    for emb_dim, want in ((128, {("kernel", ""): 2}),
                          (64, {("dense", "unaligned"): 2})):
        launched.clear()
        temb.reset_launch_counts()
        temb.embedding_dispatch_total.clear()
        ttr = TTrainer(TNet(ctr_classifier(256, emb_dim)), opt_config=TOpt(
            **CTR_OPT), seed=0, device="cpu")
        for step in range(2):
            ttr.train_one_batch(_feed(40 + step, 256)[1])
        assert temb.embedding_dispatch_total == want
        assert len(launched) == temb.embedding_gather.launches == \
            (2 if emb_dim == 128 else 0)
    temb.reset_launch_counts()
