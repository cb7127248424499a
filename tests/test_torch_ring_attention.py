"""Sequence-parallel attention in the port (``parallel/ring_attention.py``)
against the JAX package's ``tests/test_ring_attention.py``: ring and
Ulysses attention on four spawned ranks over gloo
(``tests/torch_dist_workers.py``, once for the module), each holding a
quarter of the sequence, against the JAX functions on a 4-device mesh —
the outputs (rtol 2e-5, atol 2e-5, the JAX test's) and the gradients
with respect to every rank's q/k/v block of a random cotangent's dot
product (rtol 5e-4, atol 5e-5, the JAX gradient test's), from
``jax.grad`` of ``full_attention``.  ``test_ring_gradients_match`` is the
JAX test's gradient case (its loss ``sum(out ** 2)``, causal), slow as
there.  Its flash cases are ``tests/test_torch_flash_train.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.core.device import build_mesh
from paddle_tpu.parallel import (full_attention, ring_attention,
                                 ulysses_attention)

from torch_dist_workers import run_cases, run_ranks

WORLD = 4
CASES = [(kind, causal) for kind in ("ring", "ulysses")
         for causal in (False, True)]


def _qkv(rng, b=2, t=32, h=8, d=16):
    return tuple(rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module")
def runs():
    rng = np.random.RandomState(0)
    q, k, v = _qkv(rng)
    cot = rng.randn(*q.shape).astype(np.float32)
    cases = {f"{kind}_{causal}": {"fn": "attention_case", "kind": kind,
                                  "causal": causal, "q": q, "k": k, "v": v,
                                  "cot": cot}
             for kind, causal in CASES}
    lq, lk, lv = _qkv(rng, b=1, t=1024, h=4, d=8)
    cases["long"] = {"fn": "attention_case", "kind": "ring", "causal": True,
                     "q": lq, "k": lk, "v": lv, "cot": None}
    gq, gk, gv = _qkv(rng, t=16)
    cases["grad"] = {"fn": "attention_case", "kind": "ring", "causal": True,
                     "q": gq, "k": gk, "v": gv, "cot": None}
    port = run_ranks(run_cases, WORLD, cases, deadline_s=120.0)
    return cases, port


def _whole(port, case, key):
    return np.concatenate([port[r][case][key] for r in range(WORLD)], axis=1)


@pytest.mark.parametrize("kind,causal", CASES)
def test_ring_and_ulysses_match_jax_with_gradients(runs, kind, causal):
    cases, port = runs
    spec = cases[f"{kind}_{causal}"]
    q, k, v, cot = (jnp.asarray(spec[n]) for n in ("q", "k", "v", "cot"))
    mesh = build_mesh({"data": WORLD}, jax.devices()[:WORLD])
    jfn = ring_attention if kind == "ring" else ulysses_attention
    want = jfn(q, k, v, mesh, axis="data", causal=causal)
    np.testing.assert_allclose(_whole(port, f"{kind}_{causal}", "out"),
                               np.asarray(want), rtol=2e-5, atol=2e-5)
    grads = jax.grad(lambda a, b, c: jnp.sum(
        full_attention(a, b, c, causal=causal) * cot),
        argnums=(0, 1, 2))(q, k, v)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_whole(port, f"{kind}_{causal}", name),
                                   np.asarray(g), rtol=5e-4, atol=5e-5,
                                   err_msg=name)


def test_ring_long_sequence_memory_shape(runs):
    """T 1024 over 4 ranks: each holds T/4 of the output, finite."""
    _, port = runs
    for r in range(WORLD):
        assert port[r]["long"]["out"].shape == (1, 1024 // WORLD, 4, 8)
        assert np.isfinite(port[r]["long"]["out"]).all()


@pytest.mark.slow
def test_ring_gradients_match(runs):
    cases, port = runs
    q, k, v = (jnp.asarray(cases["grad"][n]) for n in ("q", "k", "v"))
    grads = jax.grad(lambda a, b, c: jnp.sum(
        full_attention(a, b, c, causal=True) ** 2),
        argnums=(0, 1, 2))(q, k, v)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_whole(port, "grad", name),
                                   np.asarray(g), rtol=5e-4, atol=5e-5,
                                   err_msg=name)
