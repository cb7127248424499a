"""The port's serving stack (``paddle_tpu_torch.serving``) against the
JAX package's (``paddle_tpu.serving``) on the CPU.

Same seed, same weights (both draw from numpy's ``default_rng``), same
prompts: prefill/decode logits agree to atol 1e-4 (fp32 with different
summation orders) with identical next tokens and KV pools; the port's
server generates the JAX server's tokens, continuous equal to
sequential; int8 decoder artifacts move between the packages in both
directions.  The page-pool cases are those of
``tests/test_serving_server.py``, run against the port's copy.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.serving import model as jm
from paddle_tpu_torch.serving import model as tm
from paddle_tpu_torch.serving.pagepool import (PagePool, PagePoolExhausted,
                                               SCRATCH_PAGE, TornSnapshot)
from paddle_tpu_torch.utils import FLAGS, PaddleTpuError

CFG = dict(vocab=64, dim=32, heads=2, layers=2, ffn=64, max_context=64,
           eos_id=1)
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    params = jm.init_decoder_params(jm.DecoderConfig(**CFG), seed=0)
    return (jm.DecoderModel(params, jm.DecoderConfig(**CFG)),
            tm.DecoderModel(params, tm.DecoderConfig(**CFG), device="cpu"))


def _prompts(n, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, CFG["vocab"], rng.randint(2, 12)).tolist()
            for _ in range(n)]


# ------------------------------------------------------------------ model
def test_init_params_same_as_jax():
    want = jm.init_decoder_params(jm.DecoderConfig(**CFG), seed=5)
    got = tm.init_decoder_params(tm.DecoderConfig(**CFG), seed=5)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_prefill_and_decode_match_jax(models):
    mj, mt = models
    rng = np.random.default_rng(0)
    toks = rng.integers(2, CFG["vocab"], (3, 16)).astype(np.int32)
    lengths = np.array([7, 16, 0], np.int32)      # incl. an empty row
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 0], [7, 0, 0, 0]], np.int32)
    kj, vj = mj.new_pools(9, 8)
    kt, vt = mt.new_pools(9, 8)
    nj, lj, kj, vj = mj.prefill(kj, vj, toks, lengths, tables)
    nt, lt, kt, vt = mt.prefill(kt, vt, toks, lengths, tables)
    np.testing.assert_allclose(lt.numpy(), lj, atol=ATOL)
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
    # a fixed-width step: two live rows, one padded slot on scratch page
    active = np.array([True, True, False, False])
    tokens = np.array([nj[0], nj[1], 0, 0], np.int32)
    lens = np.array([8, 17, 1, 1], np.int32)
    tb = np.concatenate([tables[:2], np.zeros((2, 4), np.int32)])
    for _ in range(3):
        nj, lj, kj, vj = mj.decode(kj, vj, tokens, tb, lens, active)
        nt, lt, kt, vt = mt.decode(kt, vt, tokens, tb, lens, active)
        np.testing.assert_allclose(lt.numpy(), lj, atol=ATOL)
        np.testing.assert_array_equal(nt, nj)
        assert list(nt[2:]) == [CFG["eos_id"]] * 2      # frozen slots
        tokens, lens = nt.copy(), lens + active
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)


# ----------------------------------------------------------------- server
def _serve(model, prompts, server_cls, max_new=6, **kw):
    kw.setdefault("n_pages", 33)
    kw.setdefault("page_size", 8)
    with server_cls(model, max_batch=4, **kw) as srv:
        reqs = [srv.submit(p, max_new) for p in prompts]
        return [srv.result(r, timeout=120.0) for r in reqs]


def test_server_tokens_match_jax(models):
    from paddle_tpu.serving.server import InferenceServer as JaxServer
    from paddle_tpu_torch.serving.server import InferenceServer
    mj, mt = models
    prompts = _prompts(4)
    want = _serve(mj, prompts, JaxServer, continuous=True)
    cont = _serve(mt, prompts, InferenceServer, continuous=True)
    seq = _serve(mt, prompts, InferenceServer, continuous=False)
    assert cont == want
    assert seq == cont


def test_kill_switch_flag_driven(models):
    from paddle_tpu_torch.serving.server import InferenceServer
    _, mt = models
    prompts = _prompts(4, seed=11)
    saved = FLAGS.get("serve_continuous")
    outs = {}
    try:
        for flag in (False, True):
            FLAGS.set("serve_continuous", flag)
            with InferenceServer(mt, max_batch=4, n_pages=33,
                                 page_size=8) as srv:
                assert srv.continuous is flag
                reqs = [srv.submit(p, 5) for p in prompts]
                outs[flag] = [srv.result(r, timeout=120.0) for r in reqs]
    finally:
        FLAGS.set("serve_continuous", saved)
    assert outs[False] == outs[True]


def test_admission_backpressure_and_validation(models):
    from paddle_tpu_torch.serving.server import (DECODE_THREAD_NAME,
                                                 InferenceServer)
    _, mt = models
    # 4 pages of 8 tokens: about one request at a time, all still served
    outs = _serve(mt, _prompts(6, seed=5), InferenceServer, n_pages=5)
    assert len(outs) == 6 and all(1 <= len(t) <= 6 for t in outs)
    with InferenceServer(mt, max_batch=2, n_pages=17, page_size=8) as srv:
        for bad in (([], 4), ([2, 3], 0), ([2] * 60, 10), ([99], 2)):
            with pytest.raises(PaddleTpuError):
                srv.submit(*bad)
        assert DECODE_THREAD_NAME in [t.name for t in threading.enumerate()]
    assert DECODE_THREAD_NAME not in [t.name for t in threading.enumerate()]


def test_concurrent_submitters_stress(models):
    """More client threads than cores submit at once against a pool that
    forces backpressure, with a short switch interval: every request is
    served with the tokens it gets alone, and no page leaks."""
    import sys
    from paddle_tpu_torch.serving.server import InferenceServer
    _, mt = models
    prompts = _prompts(24, seed=21)
    want = _serve(mt, prompts, InferenceServer, max_new=4, continuous=False)
    got = [None] * len(prompts)
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with InferenceServer(mt, max_batch=4, n_pages=9,
                             page_size=8) as srv:
            def client(i):
                try:
                    got[i] = srv.generate(prompts[i], 4, timeout=120.0)
                except Exception as e:  # noqa: BLE001 - asserted below
                    errors.append(e)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120.0)
            assert not any(t.is_alive() for t in threads)
            assert srv.served == len(prompts)
            srv.pool.verify()
            assert srv.pool.free_pages() == srv.pool.capacity
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert got == want


def test_http_front(models):
    from paddle_tpu_torch.serving.server import InferenceServer
    _, mt = models
    with InferenceServer(mt, max_batch=2, n_pages=17, page_size=8) as srv:
        port = srv.start_http(0)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate",
            data=json.dumps({"prompt": [2, 3, 4],
                             "max_new_tokens": 3}).encode(),
            headers={"Content-Type": "application/json"})
        body = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert body["tokens"] == srv.generate([2, 3, 4], 3, timeout=60.0)
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10).read())
        assert health["status"] == "ok" and health["served"] >= 2
        for key in ("queue_depth", "active", "free_pages", "used_pages"):
            assert key in health


# -------------------------------------------------------------- artifacts
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_int8_artifact_crosses_packages(models, tmp_path, direction):
    mj, _ = models
    params = jm.init_decoder_params(jm.DecoderConfig(**CFG), seed=0)
    art = str(tmp_path / "art")
    if direction == "jax_to_torch":
        jm.export_decoder(params, jm.DecoderConfig(**CFG), art,
                          quantize="int8")
    else:
        tm.export_decoder(params, tm.DecoderConfig(**CFG), art,
                          quantize="int8")
    a = jm.DecoderModel.from_artifact(art)
    b = tm.DecoderModel.from_artifact(art, device="cpu")
    assert tuple(b.cfg) == tuple(a.cfg)
    toks = np.array([[2, 3, 4, 5, 0, 0, 0, 0]], np.int32)
    ln = np.array([4], np.int32)
    tab = np.array([[1, 2]], np.int32)
    na, la, _, _ = a.prefill(*a.new_pools(4, 8), toks, ln, tab)
    nb, lb, _, _ = b.prefill(*b.new_pools(4, 8), toks, ln, tab)
    np.testing.assert_allclose(lb.numpy(), la, atol=ATOL)
    np.testing.assert_array_equal(nb, na)
    # int8 really quantized: logits moved off the fp32 model's
    _, lf, _, _ = mj.prefill(*mj.new_pools(4, 8), toks, ln, tab)
    assert not np.array_equal(la, lf)


def test_torn_artifact_refused(tmp_path):
    from paddle_tpu.testing.fault import corrupt_artifact
    from paddle_tpu_torch.serving.loader import TornArtifact
    params = tm.init_decoder_params(tm.DecoderConfig(**CFG), seed=0)
    art = tm.export_decoder(params, tm.DecoderConfig(**CFG),
                            str(tmp_path / "art"))
    corrupt_artifact(art, mode="bitflip")
    with pytest.raises(TornArtifact):
        tm.DecoderModel.from_artifact(art, device="cpu")


# -------------------------------------------------------------- page pool
def _pool_roundtrip(tmp_path):
    pool = PagePool(n_pages=17, page_size=8)
    assert pool.capacity == 16
    a = pool.alloc("a", 20)
    b = pool.alloc("b", 8)
    assert len(a) == 3 and len(b) == 1
    assert SCRATCH_PAGE not in a + b and not set(a) & set(b)
    assert pool.used_pages() == 4 and pool.free_pages() == 12
    assert pool.table_of("a") == a and pool.length_of("a") == 20
    pool.verify()
    assert pool.release("a") == 3
    assert pool.release("a") == 0
    assert pool.free_pages() == 15
    pool.verify()


def _pool_churn(tmp_path):
    pool = PagePool(n_pages=33, page_size=4)
    rng = np.random.RandomState(7)
    live = {}
    for i in range(600):
        if live and rng.rand() < 0.45:
            owner = rng.choice(sorted(live))
            pool.release(owner)
            del live[owner]
        else:
            tokens = int(rng.randint(1, 40))
            owner = f"r{i}"
            if pool.pages_needed(tokens) <= pool.free_pages():
                live[owner] = pool.alloc(owner, tokens)
            else:
                with pytest.raises(PagePoolExhausted):
                    pool.alloc(owner, tokens)
        if i % 97 == 0:
            pool.verify()
    pool.verify()
    seen = set()
    for owner, pages in live.items():
        assert pool.table_of(owner) == pages
        assert SCRATCH_PAGE not in pages and not seen & set(pages)
        seen |= set(pages)


def _pool_heavy_reuse(tmp_path):
    pool = PagePool(n_pages=9, page_size=2)
    first = [tuple(pool.alloc(f"g0.{j}", 4)) for j in range(4)]
    issued = set().union(*map(set, first))
    for j in range(4):
        pool.release(f"g0.{j}")
    for gen in range(1, 50):
        tables = [pool.alloc(f"g{gen}.{j}", 4) for j in range(4)]
        assert pool.free_pages() == 0
        assert set().union(*map(set, tables)) == issued
        pool.verify()
        for j in range(4):
            pool.release(f"g{gen}.{j}")
    assert pool.free_pages() == pool.capacity


def _pool_exhaustion(tmp_path):
    pool = PagePool(n_pages=5, page_size=8)
    pool.alloc("a", 24)
    free_before = pool.free_pages()
    with pytest.raises(PagePoolExhausted):
        pool.alloc("b", 17)
    assert pool.free_pages() == free_before
    assert pool.owners() == ["a"]
    pool.verify()


def _pool_extend(tmp_path):
    pool = PagePool(n_pages=9, page_size=4)
    t = pool.alloc("a", 3)
    assert pool.extend("a", 4) == t
    t2 = pool.extend("a", 5)
    assert t2[:1] == t and len(t2) == 2
    assert pool.length_of("a") == 5
    with pytest.raises(PaddleTpuError):
        pool.extend("a", 2)
    pool.alloc("b", 24)
    with pytest.raises(PagePoolExhausted):
        pool.extend("a", 100)
    pool.verify()


def _pool_snapshot_roundtrip(tmp_path):
    pool = PagePool(n_pages=17, page_size=8)
    pool.alloc("a", 20)
    pool.alloc("b", 5)
    pool.release("a")
    path = str(tmp_path / "pool.json")
    pool.snapshot(path)
    back = PagePool.restore(path)
    back.verify()
    assert back.owners() == ["b"]
    assert back.table_of("b") == pool.table_of("b")
    assert back.length_of("b") == 5
    assert back.free_pages() == pool.free_pages()
    assert [f for f in os.listdir(tmp_path)
            if f.startswith(".pagepool-")] == []


def _pool_torn(mode):
    def case(tmp_path):
        from paddle_tpu.testing.fault import corrupt_checkpoint
        pool = PagePool(n_pages=17, page_size=8)
        pool.alloc("a", 40)
        pool.snapshot(str(tmp_path / "pool.json"))
        corrupt_checkpoint(str(tmp_path), "pool.json", mode=mode)
        with pytest.raises(TornSnapshot):
            PagePool.restore(str(tmp_path / "pool.json"))
    return case


def _pool_invariant_violation(tmp_path):
    pool = PagePool(n_pages=9, page_size=4)
    pool.alloc("a", 4)
    path = str(tmp_path / "pool.json")
    pool.snapshot(path)
    with open(path) as f:
        doc = json.load(f)
    doc.pop("checksum")
    doc["tables"]["b"] = list(doc["tables"]["a"])     # alias a's pages
    doc["lengths"]["b"] = doc["lengths"]["a"]
    doc["checksum"] = PagePool._checksum(doc)
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(TornSnapshot):
        PagePool.restore(path)


@pytest.mark.parametrize("case", [
    _pool_roundtrip, _pool_churn, _pool_heavy_reuse, _pool_exhaustion,
    _pool_extend, _pool_snapshot_roundtrip, _pool_torn("truncate"),
    _pool_torn("bitflip"), _pool_invariant_violation,
], ids=["roundtrip", "churn", "heavy_reuse", "exhaustion", "extend",
        "snapshot_roundtrip", "torn_truncate", "torn_bitflip",
        "invariant_violation"])
def test_page_pool(case, tmp_path):
    case(tmp_path)


def test_server_restores_pool_snapshot(models, tmp_path):
    """A restart from a valid snapshot releases the orphaned tables and
    serves from a clean pool; a torn snapshot gives a fresh pool."""
    from paddle_tpu_torch.serving.server import InferenceServer
    _, mt = models
    path = str(tmp_path / "pool.json")
    pool = PagePool(n_pages=17, page_size=8)
    pool.alloc("orphan", 30)
    pool.snapshot(path)
    srv = InferenceServer(mt, max_batch=2, n_pages=17, page_size=8,
                          snapshot_path=path)
    assert srv.pool.owners() == [] and srv.pool.free_pages() == 16
    with open(path, "w") as f:
        f.write("{not json")
    srv = InferenceServer(mt, max_batch=2, n_pages=17, page_size=8,
                          snapshot_path=path)
    assert srv.pool.free_pages() == 16
    assert isinstance(srv._k_pool, torch.Tensor)


# ------------------------------------------- prefill attention dispatch
# The packed prefill takes the reference's `_fa_forward` decisions: the
# two attention flags, the tiling gate at blocks of 512 over the B·T
# packed tokens, and the slot hint's label.  The reference's prefill is
# jitted, so its counter moves once per traced shape; its `_prefill_impl`
# is run eagerly here, so that each call runs the dispatch once a layer.
PREFILL_FLAGS = {"defaults": {},
                 "flash_off": {"flash_kernel": False},
                 "block_sparse_off": {"flash_block_sparse": False}}
# (B, T): B > 1 at B·T <= 512 makes the slot hint unusable (one block
# spans every slot); B = 1 keeps it usable; 10 x 60 = 600 tokens tile
# at no block the gate takes (untileable)
PREFILL_SHAPES = [(3, 16), (1, 16), (10, 60)]


def _jax_dispatch_counts():
    import re
    from paddle_tpu import observe
    pat = re.compile(r'attention_dispatch_total\{path="([^"]*)",'
                     r'reason="([^"]*)"\}')
    out = {}
    for key, val in observe.REGISTRY.flat(kinds=("counter",)).items():
        m = pat.fullmatch(key)
        if m:
            out[(m.group(1), m.group(2))] = val
    return out


@pytest.fixture
def attention_flags():
    from paddle_tpu.utils import FLAGS as JFLAGS
    names = ("flash_kernel", "flash_block_sparse")
    saved = [(f, {n: f.get(n) for n in names}) for f in (JFLAGS, FLAGS)]

    def set_both(**kw):
        for f, _ in saved:
            for n in names:
                f.set(n, kw.get(n, True))
    yield set_both
    for f, values in saved:
        for n, v in values.items():
            f.set(n, v)


def _prefill_case(b, t, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, CFG["vocab"], (b, t)).astype(np.int32)
    lengths = rng.integers(1, t + 1, b).astype(np.int32)
    lengths[0] = t
    per_row = -(-CFG["max_context"] // 8)
    tables = (1 + np.arange(b * per_row, dtype=np.int32)).reshape(b, per_row)
    return toks, lengths, tables, 1 + b * per_row


@pytest.mark.parametrize("shape", PREFILL_SHAPES,
                         ids=[f"{b}x{t}" for b, t in PREFILL_SHAPES])
@pytest.mark.parametrize("flags", list(PREFILL_FLAGS))
def test_prefill_dispatch_matches_jax(models, attention_flags, flags, shape):
    """One eager prefill of each package under each flag setting: the
    same ``attention_dispatch_total`` increments, label for label (one
    decision a layer), the same next tokens, logits within ATOL."""
    import jax.numpy as jnp
    from paddle_tpu_torch.ops import attention as ta
    mj, mt = models
    attention_flags(**PREFILL_FLAGS[flags])
    toks, lengths, tables, n_pages = _prefill_case(*shape)
    kj, vj = mj.new_pools(n_pages, 8)
    kt, vt = mt.new_pools(n_pages, 8)
    before = _jax_dispatch_counts()
    nj, lj, _, _ = jm._prefill_impl(
        mj.params, kj, vj, jnp.asarray(toks), jnp.asarray(lengths),
        jnp.asarray(tables), mj.cfg)
    after = _jax_dispatch_counts()
    want = {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}
    ta.attention_dispatch_total.clear()
    nt, lt, _, _ = mt.prefill(kt, vt, toks, lengths, tables)
    assert dict(ta.attention_dispatch_total) == want
    assert sum(want.values()) == CFG["layers"]
    if flags == "defaults":
        b, t = shape
        label = ("dense", "untileable shape (lse/kv block constraints)") \
            if b * t > 512 else \
            ("packed", "slot hint unusable (blocks straddle slots)") \
            if b > 1 else ("packed", "")
        assert want == {label: CFG["layers"]}
    np.testing.assert_array_equal(nt, np.asarray(nj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)


@pytest.mark.parametrize("flags", list(PREFILL_FLAGS))
def test_card_prefill_launches_follow_the_dispatch(models, attention_flags,
                                                   monkeypatch, flags):
    """On the card (device test and launcher spied), the prefill launches
    kernel 1's serving form once a layer under the defaults and never
    under either kill switch, where the plain composition runs."""
    from paddle_tpu_torch.ops import attention as ta
    _, mt = models
    launched = []
    monkeypatch.setattr(ta, "_kernel_ready", lambda tensors, d: True)
    monkeypatch.setattr(ta, "_launch", lambda symbol, device, *args:
                        launched.append(symbol))
    ta.reset_launch_counts()
    attention_flags(**PREFILL_FLAGS[flags])
    toks, lengths, tables, n_pages = _prefill_case(3, 16)
    kt, vt = mt.new_pools(n_pages, 8)
    mt.prefill(kt, vt, toks, lengths, tables)
    want = CFG["layers"] if flags == "defaults" else 0
    assert launched == ["flash_packed_fwd"] * want
    assert ta.prefill_attention_packed.launches == want
    ta.reset_launch_counts()
