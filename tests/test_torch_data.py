"""The port's feeding path and evaluators against the JAX package's, on
the CPU: ``core/sequence.bucket_length`` / ``pad_batch``,
``data/feeder.DataFeeder``, the reader decorators of ``data/reader.py``,
``@provider``, the async pipeline's contract (``data/pipeline.py``, the
cases of ``tests/test_pipeline.py``) and the 16 evaluators.

Inputs come from numpy seeds and go through both packages.  Tolerances:
feeds, lengths and sample sequences equal (a bfloat16 dense feed equal
after widening to float32); evaluator counts equal and floats within
1e-12 (both compute in numpy on the host from the same float32
arrays); printer lines equal.
"""

import random
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import sequence as jseq
from paddle_tpu.data import feeder as jfeed
from paddle_tpu.data.provider import provider as j_provider
from paddle_tpu.data import reader as jreader
from paddle_tpu.data.pipeline import AsyncPipeline as JPipeline
from paddle_tpu.evaluators import EVALUATORS as J_EVALUATORS
from paddle_tpu.evaluators import create_evaluator as j_create
from paddle_tpu_torch.core import sequence as tseq
from paddle_tpu_torch.data import feeder as tfeed
from paddle_tpu_torch.data.provider import CacheType
from paddle_tpu_torch.data.provider import provider as t_provider
from paddle_tpu_torch.data import reader as treader
from paddle_tpu_torch.data.pipeline import (IO_THREAD_PREFIX, AsyncPipeline,
                                            PipelineClosed, prefetch_reader)
from paddle_tpu_torch.evaluators import EVALUATORS as T_EVALUATORS
from paddle_tpu_torch.evaluators import create_evaluator as t_create


def _np(x):
    """A feed value of either package as numpy (data, lengths or None)."""
    if isinstance(x, (jseq.SequenceBatch, tseq.SequenceBatch)):
        return _np(x.data)[0], _np(x.length)[0]
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 \
            else x.numpy(), None
    x = np.asarray(x)
    return (x.astype(np.float32) if x.dtype.name == "bfloat16" else x), None


def _assert_feed_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        (gd, gl), (wd, wl) = _np(got[k]), _np(want[k])
        assert gd.dtype == wd.dtype and gd.shape == wd.shape, k
        np.testing.assert_array_equal(gd, wd, err_msg=k)
        assert (gl is None) == (wl is None)
        if wl is not None:
            assert gl.dtype == wl.dtype
            np.testing.assert_array_equal(gl, wl, err_msg=k)


# ----------------------------------------------------------- sequences
@pytest.mark.parametrize("n, buckets", [(1, None), (8, None), (9, None),
                                        (100, None), (5, [16, 4]),
                                        (20, [16, 4]), (3, [4])])
def test_bucket_length_matches_jax(n, buckets):
    assert tseq.bucket_length(n, buckets) == jseq.bucket_length(n, buckets)


def test_pad_batch_matches_jax():
    rng = np.random.RandomState(0)
    seqs = [rng.randn(int(t), 3).astype(np.float32) for t in (5, 0, 11, 7)]
    for kw in ({}, {"buckets": [8, 16]}, {"max_len": 6, "pad_value": -1},
               {"dtype": np.float16}):
        got, want = tseq.pad_batch(seqs, **kw), jseq.pad_batch(seqs, **kw)
        assert got.data.device.type == "cpu"
        _assert_feed_equal({"x": got}, {"x": want})


# -------------------------------------------------------------- feeder
def _sparse_rows(rng, n, dim, weighted):
    rows = []
    for _ in range(n):
        ids = rng.choice(dim, size=int(rng.randint(0, 5)), replace=False)
        rows.append([(int(i), float(rng.randn())) for i in ids] if weighted
                    else [int(i) for i in ids])
    return rows


def _samples(seed, n=5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = int(rng.randint(1, 12))
        out.append((
            int(rng.randint(0, 10)),                        # index
            rng.randn(4).astype(np.float32),                # dense
            _sparse_rows(rng, 1, 6, False)[0],              # sparse bin
            _sparse_rows(rng, 1, 6, True)[0],               # sparse float
            rng.randint(0, 50, t).tolist(),                 # index seq
            rng.randn(t, 3).astype(np.float32),             # dense seq
            _sparse_rows(rng, t, 7, False),                 # sparse bin seq
            _sparse_rows(rng, t, 7, True),                  # sparse f seq
            rng.randn(4).astype(np.float32)))               # dense bf16
    return out


def _feeding(m):
    return [("idx", m.integer_value(10)), ("dense", m.dense_vector(4)),
            ("sb", m.sparse_binary_vector(6)),
            ("sf", m.sparse_float_vector(6)),
            ("idx_seq", m.integer_value_sequence(50)),
            ("dense_seq", m.dense_vector_sequence(3)),
            ("sb_seq", m.sparse_binary_vector_sequence(7)),
            ("sf_seq", m.sparse_float_vector_sequence(7)),
            ("bf16", m.dense_vector(4, dtype="bfloat16"))]


@pytest.mark.parametrize("buckets", [None, [8, 16]])
def test_feeder_convert_matches_jax(buckets):
    batch = _samples(1)
    got = tfeed.DataFeeder(_feeding(tfeed), buckets=buckets).convert(batch)
    want = jfeed.DataFeeder(_feeding(jfeed), buckets=buckets).convert(batch)
    _assert_feed_equal(got, want)
    assert got["bf16"].dtype == torch.bfloat16
    assert all(t.device.type == "cpu" for v in got.values()
               for t in ((v.data, v.length) if hasattr(v, "length")
                         else (v,)))


def test_feeder_takes_dict_samples_and_one_shot_iterators():
    def batch():
        return [{"idx": 3, "idx_seq": iter([1, 2, 3])},
                {"idx": 4, "idx_seq": map(int, ["5", "6"])}]

    for buckets in (None, [4]):
        got = tfeed.DataFeeder(
            [("idx", tfeed.integer_value(10)),
             ("idx_seq", tfeed.integer_value_sequence(10))],
            buckets=buckets).convert(batch())
        want = jfeed.DataFeeder(
            [("idx", jfeed.integer_value(10)),
             ("idx_seq", jfeed.integer_value_sequence(10))],
            buckets=buckets).convert(batch())
        _assert_feed_equal(got, want)


def test_input_types_match_jax():
    for name in ("dense_vector", "dense_vector_sequence",
                 "sparse_binary_vector", "sparse_binary_vector_sequence",
                 "sparse_float_vector", "sparse_float_vector_sequence",
                 "integer_value", "integer_value_sequence",
                 "integer_value_sub_sequence", "dense_vector_sub_sequence"):
        got, want = getattr(tfeed, name)(7), getattr(jfeed, name)(7)
        assert (got.dim, got.seq_level, got.kind, got.dtype) == \
            (want.dim, want.seq_level, want.kind, want.dtype), name


# ------------------------------------------------------------- readers
def _pairs(tmp_path):
    """(name, port reader, JAX reader) for each decorator."""
    path = tmp_path / "lines.txt"
    path.write_text("a\nbb\n\nccc\n")
    data = list(range(23))
    other = [f"s{i}" for i in range(23)]
    cases = []
    for m in (treader, jreader):
        r, s = m.np_array(data), m.np_array(other)
        short = m.firstn(r, 5)
        cases.append([
            ("np_array", r),
            ("text_file", m.text_file(str(path))),
            ("map_readers", m.map_readers(lambda a, b: (a, b), r, s)),
            ("shuffle", m.shuffle(r, 7, seed=3)),
            ("shuffle_whole", m.shuffle(r, 100, seed=11)),
            ("chain", m.chain(r, s)),
            ("compose", m.compose(r, m.map_readers(lambda x: (x, x), s))),
            ("compose_unaligned", m.compose(r, short,
                                            check_alignment=False)),
            ("buffered", m.buffered(r, 3)),
            ("firstn", short),
            ("cache", m.cache(m.shuffle(r, 5, seed=1))),
            ("xmap_ordered", m.xmap_readers(lambda x: x * x, r, 3, 4,
                                            order=True)),
            ("batch", m.batch(r, 5)),
            ("batch_keep_last", m.batch(r, 5, drop_last=False)),
            ("mix_readers", m.mix_readers([r, s, short], [1.0, 2.0, 0.5],
                                          main=1)),
        ])
    return [(a[0], a[1], b[1]) for a, b in zip(*cases)]


def test_reader_decorators_match_jax(tmp_path):
    for name, got, want in _pairs(tmp_path):
        first = list(got())
        assert first == list(want()), name
        assert list(got()) == first, name      # a reader re-invokes


def test_xmap_unordered_maps_every_sample():
    r = treader.np_array(range(40))
    got = list(treader.xmap_readers(lambda x: -x, r, 4, 5, order=False)())
    assert sorted(got) == sorted(-x for x in range(40))


def test_reader_faults_reach_the_consumer():
    def bad():
        yield 1
        raise ValueError("boom")

    for make in (lambda r: treader.buffered(r, 2),
                 lambda r: treader.xmap_readers(lambda x: x, r, 2, 2)):
        with pytest.raises(ValueError, match="boom"):
            list(make(bad)())
    with pytest.raises(ZeroDivisionError):
        list(treader.xmap_readers(lambda x: 1 // x, treader.np_array(
            [1, 0, 2]), 2, 2, order=True)())
    _wait_no_io_threads()


# ------------------------------------------------------------ provider
def _provider_pair(**kw):
    def gen(settings, fname):
        for i in range(6):
            yield (fname, i, [i] * (i % 3))

    return (t_provider(input_types=["x"], **kw)(gen),
            j_provider(input_types=["x"], **kw)(gen))


@pytest.mark.parametrize("kw", [dict(should_shuffle=False),
                                dict(should_shuffle=False, cache=True),
                                dict(should_shuffle=True, cache=True)])
def test_provider_matches_jax(kw):
    tp, jp = _provider_pair(**kw)
    assert tp.input_types == jp.input_types == ["x"]
    assert tp.settings.slots == ["x"]
    for _ in range(2):                           # the cache replays
        random.seed(5)
        got = list(tp.reader("f1", "f2")())
        random.seed(5)
        want = list(jp.reader("f1", "f2")())
        assert got == want
    assert CacheType.CACHE_PASS_IN_MEM == 1
    assert CacheType.NO_CACHE == 0


def test_provider_init_hook_sees_files():
    seen = {}

    def hook(settings, file_list, **kw):
        seen["files"] = file_list
        settings.slots = ["y"]

    @t_provider(init_hook=hook, should_shuffle=False)
    def gen(settings, fname):
        yield fname

    assert list(gen.reader("a", "b")()) == ["a", "b"]
    assert seen["files"] == ("a", "b") and gen.settings.input_types == ["y"]


# ------------------------------------------------------------ pipeline
def _io_threads():
    return [t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(IO_THREAD_PREFIX)]


def _wait_no_io_threads(budget_s: float = 3.0):
    deadline = time.monotonic() + budget_s
    while _io_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not _io_threads(), [t.name for t in _io_threads()]


def test_pipeline_order_matches_the_reader_and_jax():
    """Batches come out in reader order whatever the worker count and
    the convert latencies, as from the JAX package's pipeline."""
    def convert(b):
        time.sleep(0.003 if b % 7 == 0 else 0.0)
        return {"x": np.asarray([b])}

    want = [int(f["x"][0]) for f in JPipeline(iter(range(40)), convert,
                                              depth=4, workers=3)]
    for workers in (1, 2, 4):
        pipe = AsyncPipeline(iter(range(40)), convert_fn=convert,
                             place_fn=lambda f: {"y": f["x"] + 1},
                             depth=4, workers=workers)
        got = [int(f["y"][0]) - 1 for f in pipe]
        assert got == want == list(range(40))
    _wait_no_io_threads()


def test_pipeline_bounds_the_batches_in_flight():
    pulled = []

    def src():
        for i in range(100):
            pulled.append(i)
            yield i

    pipe = AsyncPipeline(src(), depth=3, workers=2)
    it = iter(pipe)
    next(it)
    time.sleep(0.3)          # give workers every chance to overrun
    assert len(pulled) <= 1 + 3, pulled
    it.close()
    _wait_no_io_threads()


def test_pipeline_faults_reraise_at_their_position():
    def bad():
        for i in range(10):
            if i == 5:
                raise ValueError("boom@5")
            yield i

    got = []
    with pytest.raises(ValueError, match="boom@5"):
        for x in AsyncPipeline(bad(), depth=3, workers=3):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]
    got = []
    with pytest.raises(ZeroDivisionError):
        for x in AsyncPipeline(iter(range(10)),
                               convert_fn=lambda x: 1 / (x - 3),
                               depth=2, workers=2):
            got.append(x)
    assert len(got) == 3
    _wait_no_io_threads()


def test_pipeline_close_joins_workers_and_closes_the_source():
    state = {"closed": False}

    def src():
        try:
            for i in range(10_000):
                yield i
        finally:
            state["closed"] = True

    for i, _ in enumerate(AsyncPipeline(src(), depth=3, workers=3)):
        if i == 2:
            break                    # abandons the generator → close()
    _wait_no_io_threads()
    assert state["closed"] is True
    pipe = AsyncPipeline(iter(range(10)), depth=2, workers=2)
    next(iter(pipe))
    pipe.close()
    pipe.close()                     # idempotent
    with pytest.raises(PipelineClosed):
        pipe.get()
    pipe = AsyncPipeline(iter(range(3)), depth=2, workers=2)
    assert [pipe.get() for _ in range(3)] == [0, 1, 2]
    with pytest.raises(StopIteration):
        pipe.get()
    pipe.close()
    with pytest.raises(ValueError, match="depth"):
        AsyncPipeline(iter(()), depth=0)
    r = prefetch_reader(lambda: iter(range(5)), depth=2, workers=2)
    assert list(r()) == list(r()) == list(range(5))
    _wait_no_io_threads()


# ---------------------------------------------------------- evaluators
def _seq(data, lengths):
    """The same padded sequence for each package."""
    return (tseq.SequenceBatch(torch.from_numpy(data),
                               torch.from_numpy(lengths)),
            jseq.SequenceBatch(jnp.asarray(data), jnp.asarray(lengths)))


def _arr(x):
    return torch.from_numpy(x), jnp.asarray(x)


def _batches(name, rng):
    """Two batches of (kwargs of the evaluator, [(port args, port kw),
    ...], [(jax args, jax kw), ...]) for evaluator ``name``."""
    n, c, b, t = 12, 4, 3, 7

    def probs(*shape):
        return rng.rand(*shape).astype(np.float32)

    def labels(hi, *shape):
        return rng.randint(0, hi, shape).astype(np.int32)

    def lens(lo=0):
        return rng.randint(lo, t + 1, b).astype(np.int32)

    calls = []
    for _ in range(2):
        if name in ("classification_error", "precision_recall",
                    "classification_error_printer", "maxid_printer"):
            args = [_arr(probs(n, c)), _arr(labels(c, n))]
        elif name in ("auc", "rankauc"):
            args = [_arr(probs(n, 2)), _arr(labels(2, n))]
        elif name in ("sum", "value_printer", "gradient_printer",
                      "column_sum"):
            args = [_seq(probs(b, t, 3), lens())
                    if not calls else _arr(probs(n, 3))]
        elif name == "maxframe_printer":
            args = [_seq(probs(b, t, c), lens())]
        elif name == "pnpair":
            args = [_arr(probs(n)), _arr(labels(3, n))]
            q = labels(3, n)
            calls.append(([a[0] for a in args], {"query_id": torch.from_numpy(
                q)}, [a[1] for a in args], {"query_id": jnp.asarray(q)}))
            continue
        elif name == "chunk":
            ids = labels(2 * 2 + 1, b, t)            # 2 types, 'O' = 4
            args = [_seq(ids, lens()), _arr(labels(5, b, t))] if not calls \
                else [_seq(probs(b, t, 5), lens()), _arr(labels(5, b, t))]
        elif name == "ctc_edit_distance":
            args = [_seq(probs(b, t, 5), lens()),
                    _seq(labels(5, b, 4), rng.randint(0, 5, b).astype(
                        np.int32))]
        elif name == "seq_text_printer":
            args = [_seq(probs(b, t, 5), lens())]
        elif name == "detection_map":
            gt = np.zeros((b, 4, 6), np.float32)
            gt[..., 0] = labels(3, b, 4)
            xy = rng.rand(b, 4, 2).astype(np.float32) * 0.5
            gt[..., 1:3], gt[..., 3:5] = xy, xy + 0.3
            gt[..., 5] = rng.rand(b, 4) > 0.8
            det = np.zeros((b, 6, 7), np.float32)
            det[..., 0] = rng.randint(-1, 2, (b, 6))
            det[..., 1] = labels(3, b, 6)
            det[..., 2] = rng.rand(b, 6)
            pick = rng.randint(0, 4, (b, 6))
            box = np.take_along_axis(gt[..., 1:5], pick[..., None], 1)
            det[..., 3:7] = box + rng.randn(b, 6, 4).astype(np.float32) * 0.05
            args = [_arr(det), _seq(gt, rng.randint(1, 5, b).astype(
                np.int32))]
        else:
            raise AssertionError(name)
        kw_t, kw_j = {}, {}
        if name == "classification_error" and calls:
            w = probs(n)
            kw_t, kw_j = {"weight": torch.from_numpy(w)}, \
                {"weight": jnp.asarray(w)}
        calls.append(([a[0] for a in args], kw_t, [a[1] for a in args],
                      kw_j))
    return calls


def _configs(name, tmp_path):
    if name == "chunk":
        return [dict(chunk_scheme=s, num_chunk_types=2)
                for s in ("IOB", "IOE")]
    if name == "detection_map":
        return [dict(ap_type="11point"),
                dict(ap_type="integral", evaluate_difficult=True,
                     background_id=1, overlap_threshold=0.3)]
    if name == "seq_text_printer":
        words = tmp_path / "dict.txt"
        words.write_text("zero\none\ntwo\n")
        return [{}, dict(dict_file=str(words))]
    return [{}]


def test_all_16_evaluators_registered_alike():
    assert T_EVALUATORS.names() == J_EVALUATORS.names()
    assert len(T_EVALUATORS.names()) == 16


@pytest.mark.parametrize("name", sorted(T_EVALUATORS.names()))
def test_evaluator_matches_jax(name, tmp_path, capsys):
    for cfg_i, cfg in enumerate(_configs(name, tmp_path)):
        rng = np.random.RandomState(7 + cfg_i)
        te, je = t_create(name, **cfg), j_create(name, **cfg)
        for targs, tkw, jargs, jkw in _batches(name, rng):
            te.eval_batch(*targs, **tkw)
            je.eval_batch(*jargs, **jkw)
        if hasattr(je, "lines"):
            assert te.lines == je.lines and te.lines
        got, want = te.finish(), je.finish()
        assert set(got) == set(want), name
        for k, w in want.items():
            g = got[k]
            if isinstance(w, list):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
            elif isinstance(w, (int, np.integer)):
                assert g == w, (name, k)
            else:
                assert abs(g - w) <= 1e-12, (name, k, g, w)
    capsys.readouterr()


def test_evaluators_take_cuda_shaped_inputs_on_the_host():
    """``_to_np`` reads tensors of any dtype the port produces, a bf16
    output widened exactly."""
    out = torch.tensor([[0.25, 0.75], [0.5, 0.125]], dtype=torch.bfloat16)
    e = t_create("classification_error")
    e.eval_batch(out, torch.tensor([1, 1]))
    assert e.finish() == {"classification_error": 0.5}
    data, mask = e._to_np(tseq.SequenceBatch(out[None],
                                             torch.tensor([1])))
    assert data.dtype == np.float32 and mask.tolist() == [[1.0, 0.0]]
