"""The port's runtime lock-order checker
(``paddle_tpu_torch/analysis/lockorder.py``) on the cases of
``tests/test_static_analysis.py``'s runtime half (edges, cycles across
threads, the raise mode, peers and re-entrant locks, conditions, the
disabled mode, the environment switch), then the port's own locks under
the checker: the async input pipeline (``pipeline.source`` and
``pipeline.queue``, with tracing and metrics on), the page pool
(``serve.pagepool``) and the inference server's admission condition
(``serve.admission``) serving requests, held acyclic.

Each test resets the checker, the port's registry and its trace in a
fixture of this file.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from paddle_tpu_torch import observe
from paddle_tpu_torch.analysis import lockorder
from paddle_tpu_torch.observe import trace
from paddle_tpu_torch.utils.logger import reset_warn_once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_state():
    yield
    lockorder.disable()
    lockorder.reset()
    observe.stop_global()
    observe.REGISTRY.reset()
    reset_warn_once()


@pytest.fixture
def lock_checker():
    lockorder.reset()
    lockorder.enable(raise_on_violation=False)
    yield lockorder
    lockorder.disable()
    lockorder.reset()


def test_lockorder_records_edges_and_stays_quiet(lock_checker):
    a, b = lockorder.named_lock("t.a"), lockorder.named_lock("t.b")
    with a:
        with b:
            pass
    assert lock_checker.edges() == {"t.a": {"t.b"}}
    assert lock_checker.violations() == []
    lock_checker.check_acyclic()        # no raise


def test_lockorder_flags_opposite_order_cycle(lock_checker):
    a, b = lockorder.named_lock("t.a"), lockorder.named_lock("t.b")
    with a:
        with b:
            pass
    with b:
        with a:                         # reverse order: the hazard
            pass
    v = lock_checker.violations()
    assert len(v) == 1 and "cycle" in v[0]
    assert "t.a" in v[0] and "t.b" in v[0]
    with pytest.raises(lockorder.LockOrderError):
        lock_checker.check_acyclic()


def test_lockorder_raise_mode_reports_before_blocking(lock_checker):
    """Re-acquiring a held non-reentrant lock would block forever; the
    checker raises from _before_acquire instead of demonstrating it."""
    lockorder.enable(raise_on_violation=True)
    c = lockorder.named_lock("t.c")
    try:
        with c:
            with pytest.raises(lockorder.LockOrderError,
                               match="self-deadlock"):
                c.acquire()
    finally:
        lockorder.enable(raise_on_violation=False)
    # the lock survived: still usable after the refused acquire
    with c:
        pass


def test_lockorder_peers_and_rlock_are_exempt(lock_checker):
    p1, p2 = lockorder.named_lock("t.peer"), lockorder.named_lock("t.peer")
    with p1:
        with p2:                        # distinct instances, one name
            pass
    r = lockorder.named_lock("t.r", reentrant=True)
    with r:
        with r:                         # RLock re-entry is legal
            pass
    assert lock_checker.violations() == []


def test_lockorder_condition_waits_track(lock_checker):
    cond = lockorder.named_condition("t.cond")
    hits = []

    def waiter():
        with cond:
            while not hits:
                cond.wait(1.0)

    t = threading.Thread(target=waiter, name="ptpu-test-cond")
    t.start()
    with cond:
        hits.append(1)
        cond.notify()
    t.join(2.0)
    assert not t.is_alive()
    assert lock_checker.violations() == []


def test_lockorder_cross_thread_orders_compose(lock_checker):
    """Thread 1 witnesses a->b, thread 2 witnesses b->a: the cycle is
    caught even though neither thread ever deadlocks alone."""
    a, b = lockorder.named_lock("t.x"), lockorder.named_lock("t.y")

    def t1():
        with a:
            with b:
                pass

    th = threading.Thread(target=t1, name="ptpu-test-order")
    th.start()
    th.join(2.0)
    with b:
        with a:
            pass
    v = lock_checker.violations()
    assert len(v) == 1 and "cycle" in v[0]


def test_lockorder_disabled_is_transparent():
    lockorder.reset()
    assert not lockorder.enabled()
    a = lockorder.named_lock("t.off")
    with a:
        pass
    assert lockorder.edges() == {}
    assert a.locked() is False


def test_lockorder_env_var_enables():
    """PADDLE_TPU_LOCK_ORDER_CHECK=1, the reference's switch, enables the
    port's checker at import."""
    code = ("from paddle_tpu_torch.analysis import lockorder; "
            "import sys; sys.exit(0 if lockorder.enabled() else 3)")
    env = dict(os.environ, PADDLE_TPU_LOCK_ORDER_CHECK="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          timeout=120)
    assert proc.returncode == 0


def test_pipeline_and_serving_locks_stay_acyclic(lock_checker):
    """The port's pipeline (two workers, tracing and metrics on, a fault
    mid-stream), a page pool churned from four threads, and a tiny
    inference server serving six requests in continuous mode, all under
    the checker: the named locks' graph has the expected edges and no
    cycle."""
    from paddle_tpu_torch.data.pipeline import AsyncPipeline
    from paddle_tpu_torch.serving import model as tm
    from paddle_tpu_torch.serving.pagepool import PagePool
    from paddle_tpu_torch.serving.server import InferenceServer

    trace.enable(ring_size=512)
    with trace.span("train_pass"):
        assert list(AsyncPipeline(iter(range(12)), convert_fn=lambda x: x,
                                  depth=3, workers=2)) == list(range(12))

    def bad():
        yield 1
        raise ValueError("reader fault")

    with pytest.raises(ValueError):
        list(AsyncPipeline(bad(), depth=2, workers=2))

    pool = PagePool(33, 4)

    def churn(k):
        for i in range(50):
            pool.alloc(f"o{k}-{i}", 9)
            pool.release(f"o{k}-{i}")

    threads = [threading.Thread(target=churn, args=(k,),
                                name=f"ptpu-test-churn-{k}")
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    pool.verify()

    cfg = tm.DecoderConfig(vocab=64, dim=32, heads=2, layers=1, ffn=64,
                           max_context=64)
    model = tm.DecoderModel(tm.init_decoder_params(cfg, seed=0), cfg,
                            device="cpu")
    rng = np.random.RandomState(0)
    with InferenceServer(model, max_batch=4, n_pages=33, page_size=8) as srv:
        reqs = [srv.submit(rng.randint(2, 64, int(rng.randint(3, 9))), 4)
                for _ in range(6)]
        outs = [srv.result(r, timeout=60) for r in reqs]
    assert all(1 <= len(o) <= 4 for o in outs)
    edges = lock_checker.edges()
    assert "pipeline.queue" in edges.get("pipeline.source", set())
    assert "serve.pagepool" in edges.get("serve.admission", set())
    lock_checker.check_acyclic()
    assert observe.counter("serve_requests").value() == 6
    assert observe.gauge("serve_page_pool_pages").value(state="used") == 0
