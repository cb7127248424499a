"""The port's training loop (``Trainer.train``, ``test``, ``time_job``,
``check_gradients``) against the JAX package's, on the CPU.

The LSTM text classifier at V 200, E 16, H 128, 2 LSTMs (the fused
tier: the JAX side runs its Pallas kernels in interpret mode, the port
its kernels' plain versions), with a ``classification_error`` entry on
``__fc_3__`` / ``label`` appended to ``ModelConfig.evaluators``.  JAX's
``init_params(0)`` is carried into the port by name; the readers yield
raw ``(ids, label)`` samples drawn from a numpy seed, batched by 8 and
padded to the one bucket 16, so the JAX side compiles each step once.

Tolerances: every ``EndIteration.cost``, ``EndPass`` cost and
``test_cost`` within rtol 1e-5 (the Adam trajectory's tolerance of
``test_torch_train.py``); ``classification_error`` and the list of
(event, pass, batch) equal; the port's costs bit-identical between
``--prefetch_depth`` 0 and 2, each held against the JAX loop at its
default depth 2 (``tests/test_pipeline.py`` pins the JAX loop's depths
to each other).  ``check_gradients`` at ``rtol=-1`` logs
every check: the (name, index) lists are equal, ``auto`` within rtol
1e-3 + 1e-5 (the gradient atol of ``test_torch_train.py``), ``fd``
within rtol 1e-3 plus 4 quanta of a float32 central difference (ulp of
the loss / (2 eps): the two packages' losses may round an ulp apart).
The JAX side's check runs its loss jitted (eager interpret-mode
forwards take a minute); the function computed is the same.
"""

import logging
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.data import feeder as jfeed
from paddle_tpu.evaluators import create_evaluator as j_create
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.models import lstm_text_classifier as j_classifier
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.data import feeder as tfeed
from paddle_tpu_torch.evaluators import create_evaluator as t_create
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.models import lstm_text_classifier as t_classifier
from paddle_tpu_torch.trainer import events as tev
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from paddle_tpu_torch.utils import FLAGS as TFLAGS
from paddle_tpu_torch.utils import PaddleTpuError
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax

V, E, H, C, B, T = 200, 16, 128, 2, 8, 16
OPT = dict(learning_method="adam", learning_rate=2e-3, l2_weight_decay=8e-4,
           gradient_clipping_threshold=25.0)
ERR = {"type": "classification_error",
       "name": "__classification_error_evaluator_0__",
       "input_layer_name": "__fc_3__", "label_layer_name": "label"}
LOOP_FLAGS = ("save_dir", "log_period", "prefetch_depth")


def _samples(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = int(rng.randint(4, T + 1))
        out.append((rng.randint(0, V, t).tolist(), int(rng.randint(0, C))))
    return out


def _reader(samples):
    def batches():
        for i in range(0, len(samples) - B + 1, B):
            yield samples[i:i + B]
    return batches


TRAIN, TEST = _samples(3 * B, 1), _samples(2 * B, 2)


def _feeders():
    return (jfeed.DataFeeder([("data", jfeed.integer_value_sequence(V)),
                              ("label", jfeed.integer_value(C))],
                             buckets=[T]),
            tfeed.DataFeeder([("data", tfeed.integer_value_sequence(V)),
                              ("label", tfeed.integer_value(C))],
                             buckets=[T]))


@pytest.fixture
def loop_flags():
    """Save and restore the loop's flags of both packages."""
    old_j = {k: getattr(JFLAGS, k) for k in LOOP_FLAGS}
    old_t = {k: TFLAGS.get(k) for k in LOOP_FLAGS}
    try:
        yield
    finally:
        for k in LOOP_FLAGS:
            JFLAGS.set(k, old_j[k])
            TFLAGS.set(k, old_t[k])


def _set_flags(**kw):
    for k, v in kw.items():
        JFLAGS.set(k, v)
        TFLAGS.set(k, v)


def _pair(evaluators=(ERR,)):
    """A JAX trainer and a port trainer on the CPU from the same
    parameters."""
    jcfg, tcfg = j_classifier(V, E, H, 2, C), t_classifier(V, E, H, 2, C)
    jcfg.evaluators.extend(dict(e) for e in evaluators)
    tcfg.evaluators.extend(dict(e) for e in evaluators)
    jtr = JTrainer(JNet(jcfg), opt_config=JOpt(**OPT), seed=0)
    tnet = TNet(tcfg)
    ttr = TTrainer(tnet, opt_config=TOpt(**OPT), seed=0, device="cpu")
    ttr.params = network_params_from_jax(
        {n: np.array(v) for n, v in jtr.params.items()}, tnet, "cpu")
    return jtr, ttr


def _record(events):
    def handle(e):
        payload = getattr(e, "cost", None) if type(e).__name__ == \
            "EndIteration" else dict(getattr(e, "metrics", {}))
        events.append((type(e).__name__, e.pass_id,
                       getattr(e, "batch_id", None), payload))
    return handle


def _train(trainer, feeder, depth):
    _set_flags(save_dir="", log_period=1, prefetch_depth=depth)
    events = []
    trainer.train(_reader(TRAIN), num_passes=2, event_handler=_record(events),
                  feeder=feeder, test_reader=_reader(TEST))
    return events


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread, so that
    workers sharing the machine's cores do not oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def loop_runs():
    """The JAX loop at its default --prefetch_depth 2, and the port's
    at 0 and 2, from the same parameters; also the JAX trainer, whose
    step is compiled by then."""
    old_j = {k: getattr(JFLAGS, k) for k in LOOP_FLAGS}
    old_t = {k: TFLAGS.get(k) for k in LOOP_FLAGS}
    runs = {}
    try:
        jtr, _ = _pair()
        jf, _ = _feeders()
        runs["jax"] = _train(jtr, jf, 2)
        for depth in (0, 2):
            _, ttr = _pair()
            _, tf = _feeders()
            runs[("torch", depth)] = _train(ttr, tf, depth)
    finally:
        for k in LOOP_FLAGS:
            JFLAGS.set(k, old_j[k])
            TFLAGS.set(k, old_t[k])
    runs["jax_trainer"] = jtr
    return runs


def _kinds(events):
    return [e[:3] for e in events]


@pytest.mark.parametrize("depth", [0, 2])
def test_train_events_costs_and_metrics_match_jax(loop_runs, depth):
    want, got = loop_runs["jax"], loop_runs[("torch", depth)]
    assert _kinds(got) == _kinds(want)
    assert _kinds(got)[:3] == [("BeginPass", 0, None),
                               ("BeginIteration", 0, 0),
                               ("EndIteration", 0, 0)]
    assert sum(k == "EndPass" for k, *_ in got) == 2
    for (kind, p, b, g), (_, _, _, w) in zip(got, want):
        if kind == "EndIteration":
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       err_msg=f"cost of {p}/{b}")
        elif kind == "EndPass":
            assert set(g) == {"cost", "test_cost", "classification_error"}
            assert set(g) == set(w)
            np.testing.assert_allclose(g["cost"], w["cost"], rtol=1e-5)
            np.testing.assert_allclose(g["test_cost"], w["test_cost"],
                                       rtol=1e-5)
            assert g["classification_error"] == w["classification_error"]


def test_prefetch_depth_leaves_costs_bit_identical(loop_runs):
    assert loop_runs[("torch", 0)] == loop_runs[("torch", 2)]


def test_test_with_config_and_explicit_evaluators_matches_jax(loop_flags):
    """Config evaluators (two auto-named of one type: the second's
    metric is prefixed on collision; an explicitly named one: always
    prefixed; an auc) and explicit evaluators (no entry: they read the
    prediction layer)."""
    entries = (ERR, dict(ERR, name="__classification_error_evaluator_1__"),
               dict(ERR, name="err"),
               {"type": "auc", "name": "__auc_evaluator_3__",
                "input_layer_name": "__fc_3__", "label_layer_name": "label"})
    jtr, ttr = _pair(entries)
    jf, tf = _feeders()
    _set_flags(prefetch_depth=0)
    reader = _reader(_samples(2 * B, 3))
    want, got = jtr.test(reader, jf), ttr.test(reader, tf)
    assert set(got) == {"test_cost", "classification_error",
                        "classification_error_evaluator_1."
                        "classification_error", "err.classification_error",
                        "auc"}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for k in ("classification_error", "err.classification_error"):
        assert got[k] == want[k]
    want = jtr.test(reader, jf, [j_create("classification_error"),
                                 j_create("classification_error"),
                                 j_create("auc")])
    got = ttr.test(reader, tf, [t_create("classification_error"),
                                t_create("classification_error"),
                                t_create("auc")])
    assert set(got) == set(want) == {"test_cost", "classification_error",
                                     ".classification_error", "auc"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_test_reads_probabilities_not_logits(loop_flags):
    """The softmax fc's values reach the evaluators (the cost's logits
    peephole leaves ``values['__fc_3__']`` the probabilities)."""
    _, ttr = _pair()
    _, tf = _feeders()
    seen = []

    class Spy:
        def start(self):
            pass

        def eval_batch(self, output, label, weight=None):
            seen.append(output)

        def finish(self):
            return {}

    _set_flags(prefetch_depth=0)
    ttr.test(_reader(_samples(B, 4)), tf, [Spy()])
    probs = seen[0]
    assert probs.shape == (B, C) and probs.device.type == "cpu"
    torch.testing.assert_close(probs.sum(-1), torch.ones(B))
    assert bool((probs >= 0).all())


def test_time_job_keys_and_batch_count(loop_runs, loop_flags):
    jtr, (_, ttr) = loop_runs["jax_trainer"], _pair()
    jf, tf = _feeders()
    reader = _reader(_samples(5 * B, 5))
    want = jtr.time_job(reader, jf, warmup=2, batches=3)
    got = ttr.time_job(reader, tf, warmup=2, batches=3)
    assert set(got) == set(want) == {"ms_per_batch", "samples_per_sec",
                                     "batches"}
    assert got["batches"] == want["batches"] == 3
    assert got["ms_per_batch"] > 0 and got["samples_per_sec"] > 0
    assert ttr.samples_seen == 5 * B
    with pytest.raises(PaddleTpuError, match="not enough batches"):
        ttr.time_job(reader, tf, warmup=5, batches=3)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


_CHECK = re.compile(r"checkgrad FAIL (.+)\[(\d+)\]: auto=(\S+) fd=(\S+)")


def _checks(logger_name, fn):
    h = _Lines()
    logger = logging.getLogger(logger_name)
    logger.addHandler(h)
    try:
        ok = fn()
    finally:
        logger.removeHandler(h)
    rows = [_CHECK.fullmatch(line).groups() for line in h.lines]
    return ok, [(n, int(i), float(a), float(f)) for n, i, a, f in rows]


def _jit_loss(jnet):
    loss = jnet.loss
    jitted = jax.jit(lambda p, f, b: loss(p, f, b, is_training=False)[0])
    jnet.loss = lambda p, f, b, is_training=True: (jitted(p, f, b), None)


def test_check_gradients_matches_jax():
    jtr, ttr = _pair()
    _jit_loss(jtr.network)
    rng = np.random.RandomState(6)
    ids = rng.randint(0, V, (B, T)).astype(np.int32)
    lengths = rng.randint(4, T + 1, B).astype(np.int32)
    labels = rng.randint(0, C, B).astype(np.int32)
    jfeed_ = {"data": JSeq(jnp.asarray(ids), jnp.asarray(lengths)),
              "label": jnp.asarray(labels)}
    tfeed_ = {"data": TSeq(torch.from_numpy(ids), torch.from_numpy(lengths)),
              "label": torch.from_numpy(labels)}
    ok_j, want = _checks("paddle_tpu.trainer",
                         lambda: jtr.check_gradients(jfeed_, rtol=-1))
    ok_t, got = _checks("paddle_tpu_torch.trainer",
                        lambda: ttr.check_gradients(tfeed_, rtol=-1))
    assert ok_j is ok_t is False
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert len(got) == sum(min(4, p.numel()) for p in ttr.params.values())
    loss = float(ttr.network.loss(ttr.params, tfeed_, ttr.buffers,
                                  is_training=False)[0])
    quantum = float(np.spacing(np.float32(loss))) / (2 * 1e-2)
    for (name, idx, a, f), (_, _, wa, wf) in zip(got, want):
        assert abs(a - wa) <= 1e-3 * abs(wa) + 1e-5, (name, idx, a, wa)
        assert abs(f - wf) <= 1e-3 * abs(wf) + 4 * quantum, (name, idx, f, wf)
    assert jtr.check_gradients(jfeed_) and ttr.check_gradients(tfeed_)


@pytest.mark.parametrize("flag, value, match", [
    ("show_parameter_stats_period", 3, None),
    ("roofline_dump", "/dev/null", "roofline_dump.*A10b")])
def test_train_refuses_unported_pieces_before_any_step(flag, value, match):
    """``--roofline_dump`` refuses by name before any step (A10b).
    ``--show_parameter_stats_period`` is ported: at 3 (a pass of 3
    batches) ``train`` logs the stats once, after the third step, and
    the lines are the JAX package's ``parameter_stats`` of the same
    parameters."""
    from paddle_tpu.utils.profiler import parameter_stats as j_stats
    _, ttr = _pair()
    _, tf = _feeders()
    old = {k: TFLAGS.get(k) for k in ("save_dir", flag)}
    TFLAGS.set("save_dir", "")
    TFLAGS.set(flag, value)
    events = []
    h = _Lines()
    h.setLevel(logging.INFO)
    logger = logging.getLogger("paddle_tpu_torch.trainer")
    logger.addHandler(h)
    try:
        if match is not None:
            with pytest.raises(PaddleTpuError, match=match):
                ttr.train(_reader(TRAIN), 1, _record(events), tf)
        else:
            ttr.train(_reader(TRAIN), 1, _record(events), tf)
    finally:
        logger.removeHandler(h)
        for k, v in old.items():
            TFLAGS.set(k, v)
    stats = [ln for ln in h.lines if ln.startswith("parameter stats:")]
    if match is not None:
        assert events == [] and ttr.samples_seen == 0 and stats == []
        return
    assert ttr.samples_seen == len(TRAIN)
    want = j_stats({n: jnp.asarray(p.numpy()) for n, p in ttr.params.items()})
    assert stats == ["parameter stats:\n" + want]


def test_train_saves_at_the_default_save_dir(loop_runs, loop_flags,
                                             tmp_path, monkeypatch):
    """At the reference's default ``--save_dir="./output"`` and
    ``--saving_period`` 1, ``train`` writes a verified ``pass-%05d`` a
    pass after the pass's ``test`` and before its ``EndPass``; the events
    and costs are the JAX loop's, bit for bit those of the port's loop
    without saving."""
    from paddle_tpu.trainer import checkpoint as jck
    from paddle_tpu_torch.trainer import checkpoint as tck
    monkeypatch.chdir(tmp_path)
    assert TFLAGS.get("save_dir") == "./output"     # the reference default
    assert TFLAGS.get("saving_period") == 1
    TFLAGS.set("log_period", 1)
    TFLAGS.set("prefetch_depth", 0)
    _, ttr = _pair()
    _, tf = _feeders()
    out = tmp_path / "output"
    seen = []
    run_test = ttr.test

    def test(*a, **k):
        seen.append(("test", sorted(os.listdir(out)) if out.exists()
                     else []))
        return run_test(*a, **k)

    ttr.test = test
    events = []
    record = _record(events)

    def handle(e):
        record(e)
        if type(e).__name__ == "EndPass":
            seen.append(("EndPass", sorted(os.listdir(out))))

    ttr.train(_reader(TRAIN), 2, handle, tf, test_reader=_reader(TEST))
    assert seen == [("test", []), ("EndPass", ["pass-00000"]),
                    ("test", ["pass-00000"]),
                    ("EndPass", ["pass-00000", "pass-00001"])]
    assert _kinds(events) == _kinds(loop_runs["jax"])
    assert events == loop_runs[("torch", 0)]
    for p, n in (("pass-00000", 3 * B), ("pass-00001", 6 * B)):
        d = str(out / p)
        assert tck.verify_checkpoint(d) and jck.verify_checkpoint(d)
        man = jck.load_manifest(d)
        assert man["format"] == 2 and man["samples_seen"] == n
    for name, v in jck.load_params(str(out / "pass-00001")).items():
        np.testing.assert_array_equal(v, ttr.params[name].numpy())


def test_saving_period_past_the_last_pass_writes_none(loop_flags, tmp_path,
                                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, ttr = _pair(())
    _, tf = _feeders()
    TFLAGS.set("saving_period", 3)
    TFLAGS.set("prefetch_depth", 0)
    try:
        events = []
        ttr.train(_reader(TRAIN), 2, _record(events), tf)
    finally:
        TFLAGS.set("saving_period", 1)
    assert events[-1][0] == "EndPass" and ttr.samples_seen == 2 * 3 * B
    assert os.listdir(tmp_path) == []


def test_other_unported_pieces_refuse_by_name(tmp_path):
    from paddle_tpu_torch.data import reader as treader
    from paddle_tpu_torch.data.download import convert
    # record files are ported (tests/test_torch_recordio.py): a read-back
    convert(str(tmp_path), lambda: iter(TRAIN), 10, "train")
    assert sorted(treader.recordio(str(tmp_path / "train-*"))()) == \
        sorted(TRAIN)
    with pytest.raises(PaddleTpuError, match="A9"):
        treader.cloud_reader(["x"], master=None)
    # sub-sequence feeds are ported (tests/test_torch_nested_groups.py)
    nested = tfeed.DataFeeder([("s", tfeed.integer_value_sub_sequence(5))]
                              ).convert([([[1, 2], [3]],)])["s"]
    assert tuple(nested.sub_length.tolist()) == ([2, 1],)
    with pytest.raises(PaddleTpuError, match="local_sgd_steps.*A9"):
        TTrainer(TNet(t_classifier(V, E, H, 2, C)),
                 TOpt(local_sgd_steps=2), device="cpu")


def test_events_are_the_reference_dataclasses():
    from paddle_tpu.trainer import events as jev
    for name in ("WithMetric", "BeginPass", "EndPass", "BeginIteration",
                 "EndIteration", "TestResult"):
        jf = [(f.name, f.default) for f in
              jev.__dict__[name].__dataclass_fields__.values()]
        tf = [(f.name, f.default) for f in
              tev.__dict__[name].__dataclass_fields__.values()]
        assert repr(tf) == repr(jf), name


def test_lookup_table_matches_a_masked_index_select():
    """The table lookup (``F.embedding``, a fixed-order table gradient on
    the card) reads and differentiates as the masked ``index_select`` it
    replaced: out-of-range ids and ``padding_idx`` read zeros and pass no
    gradient, duplicates sum."""
    from paddle_tpu_torch.ops.embedding_ops import lookup_table
    rng = np.random.RandomState(8)
    table = torch.from_numpy(rng.randn(7, 5).astype(np.float32))
    ids = torch.tensor([[0, 3, 3, -1], [7, 6, 3, 2]])
    cot = torch.from_numpy(rng.randn(2, 4, 5).astype(np.float32))
    for pad in (None, 2):
        t1 = table.clone().requires_grad_(True)
        out = lookup_table(t1, ids, padding_idx=pad)
        (g1,) = torch.autograd.grad((out * cot).sum(), [t1])
        valid = (ids >= 0) & (ids < 7)
        if pad is not None:
            valid &= ids != pad
        t2 = table.clone().requires_grad_(True)
        ref = t2.index_select(0, torch.where(valid, ids, 0).reshape(-1))
        ref = ref.reshape(2, 4, 5) * valid[..., None]
        (g2,) = torch.autograd.grad((ref * cot).sum(), [t2])
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-6)
