"""The port's training attention (``paddle_tpu_torch.ops.attention``:
``flash_attention``, ``flash_attention_packed``, their dispatch and
gradients) against the JAX package's (``paddle_tpu.ops.
pallas_attention``) on the CPU.

Inputs come from a numpy seed and go through both.  The JAX side runs as
its own tests run it here: the block-sparse Pallas kernels in interpret
mode.  The port runs on CPU tensors, so its kernel wrappers take their
plain versions; which kernels a call on the card reaches is checked with
the device test and the launcher monkeypatched.

Tolerances: fp32 outputs and lse within 2e-5 (summation order), fp32
gradients within 1e-4 * max|ref|.  bf16 (both packages compute in f32
from the bf16 inputs and round once): outputs and gradients within one
bf16 ulp of the larger value plus 1e-2 * max|ref| (the reference's
kernels sum the tiles in another order, and a sum near a rounding
boundary rounds the other way).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import observe
from paddle_tpu.config.model_config import LayerConfig as JConf
from paddle_tpu.config.model_config import LayerInput as JIn
from paddle_tpu.config.model_config import ModelConfig as JModel
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.ops import pallas_attention as jpa
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu_torch.config.model_config import (LayerConfig, LayerInput,
                                                  ModelConfig)
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.ops import attention as ta
from paddle_tpu_torch.utils import FLAGS as TFLAGS
from paddle_tpu_torch.utils import PaddleTpuError
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax

FLAG_NAMES = ("flash_kernel", "flash_block_sparse", "attention_packing")
F32_ATOL, F32_GRAD_RTOL, BF16_RTOL = 2e-5, 1e-4, 1e-2


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


def _inputs(b, tq, tk, h=2, d=16, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, tq, h, d).astype(np.float32) * 0.5
    k, v = (rng.randn(b, tk, h, d).astype(np.float32) * 0.5
            for _ in range(2))
    cot = rng.randn(b, tq, h, d).astype(np.float32)
    return q, k, v, cot


def _jax_run(q, k, v, cot, idx, causal, bq, bk, packed, slot, dtype):
    """JAX output, lse and (dq, dk, dv) for ``sum(out * cot)``."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(x).astype(jd) for x in (q, k, v)]
    ji = None if idx is None else jnp.asarray(idx)
    if packed:
        fn = lambda *a: jpa.flash_attention_packed(*a, ji, causal, bq, bk,
                                                   slot)
        _, lse = jpa._fa_forward(*args, None, causal, bq, bk, segments=ji,
                                 slot=slot)
    else:
        fn = lambda *a: jpa.flash_attention(*a, ji, causal, bq, bk)
        _, lse = jpa._fa_forward(*args, ji, causal, bq, bk)
    out = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a).astype(jnp.float32) * cot),
                     argnums=(0, 1, 2))(*args)
    f32 = lambda x: np.asarray(x.astype(jnp.float32))       # noqa: E731
    return f32(out), np.asarray(lse), [f32(g) for g in grads]


def _port_run(q, k, v, cot, idx, causal, bq, bk, packed, slot, dtype):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True)
          for x in (q, k, v)]
    ti = None if idx is None else torch.from_numpy(np.array(idx))
    if packed:
        out = ta.flash_attention_packed(*ts, ti, causal, bq, bk, slot)
        _, lse, path, _ = ta._fa_forward(*(t.detach() for t in ts), None,
                                         causal, bq, bk, ti, slot)
    else:
        out = ta.flash_attention(*ts, ti, causal, bq, bk)
        _, lse, path, _ = ta._fa_forward(*(t.detach() for t in ts), ti,
                                         causal, bq, bk)
    assert path == "sparse"
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == dtype
    return (out.detach().float().numpy(), lse.numpy(),
            [t.grad.float().numpy() for t in ts])


def _close(got, want, dtype, grad=False):
    if dtype == torch.bfloat16:
        top = np.maximum(np.abs(got), np.abs(want))
        ulp = np.ldexp(1.0, np.frexp(top)[1] - 8)
        tol = ulp + BF16_RTOL * np.abs(want).max()
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    elif grad:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=F32_GRAD_RTOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def _compare(case_args, dtype):
    want_out, want_lse, want_g = _jax_run(*case_args, dtype)
    out, lse, grads = _port_run(*case_args, dtype)
    _close(out, want_out, dtype)
    np.testing.assert_allclose(lse, want_lse, rtol=0,
                               atol=F32_ATOL if dtype == torch.float32
                               else 1e-4)
    for g, w in zip(grads, want_g):
        _close(g, w, dtype, grad=True)
    return out, grads


# ------------------------------------------------------------ padded rows
LENGTHS = np.asarray([256, 93, 64, 0], np.int32)   # the oracle's cases


@pytest.mark.parametrize("causal", [False, True])
def test_block_sparse_padded_matches_jax(causal):
    q, k, v, cot = _inputs(4, 256, 256)
    out, grads = _compare((q, k, v, cot, LENGTHS, causal, 128, 16, False, 0),
                          torch.float32)
    # the zero-length row: zero output, zero dk/dv for its keys
    assert np.abs(out[3]).max() == 0.0
    assert np.abs(grads[1][3]).max() == 0.0 == np.abs(grads[2][3]).max()


def test_block_sparse_cross_attention_matches_jax():
    """Tq 128 != Tk 256 (non-causal cross attention) with key lengths."""
    q, k, v, cot = _inputs(2, 128, 256, seed=1)
    _compare((q, k, v, cot, np.asarray([256, 70], np.int32), False, 128, 16,
              False, 0), torch.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_t100_matches_jax(causal):
    """T 100: tileable only as one block the size of T (bq = tq)."""
    q, k, v, cot = _inputs(3, 100, 100, seed=2)
    assert ta._tiling_ok(100, 100, ta._choose_block(100, 128),
                         ta._choose_block(100, 128))
    _compare((q, k, v, cot, np.asarray([100, 37, 0], np.int32), causal, 128,
              128, False, 0), torch.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_jax(causal):
    q, k, v, cot = _inputs(2, 256, 256, seed=3)
    _compare((q, k, v, cot, np.asarray([256, 93], np.int32), causal, 128,
              16, False, 0), torch.bfloat16)


def test_lengths_none_equals_full_lengths():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 64, 64, seed=4))
    a = ta.flash_attention(q, k, v, None, True, 64, 64)
    b = ta.flash_attention(q, k, v, torch.tensor([64, 64]), True, 64, 64)
    assert torch.equal(a, b)


# -------------------------------------------------------------- packing
@pytest.mark.parametrize("causal", [False, True])
def test_packed_matches_jax(causal):
    """Segments from lengths with interleaved padding and a zero-length
    row, the layer's ``slot`` hint; padding tokens give exact zeros."""
    lengths = np.asarray([100, 0, 64, 30], np.int32)
    slot = 128
    seg = np.asarray(jpa.segments_from_lengths(jnp.asarray(lengths), 4,
                                               slot))
    np.testing.assert_array_equal(
        ta.segments_from_lengths(torch.from_numpy(lengths), 4, slot).numpy(),
        seg)
    q, k, v, cot = _inputs(1, 4 * slot, 4 * slot, seed=5)
    out, grads = _compare((q, k, v, cot, seg, causal, 128, 16, True, slot),
                          torch.float32)
    pad = seg[0] < 0
    assert np.all(out[0, pad] == 0.0)
    assert all(np.all(g[0, pad] == 0.0) for g in grads)


def test_packed_general_segments_match_jax():
    """Irregular runs with padding between them, not from lengths."""
    seg = np.full((1, 256), -1, np.int32)
    rng = np.random.RandomState(6)
    pos, sid = 3, 0
    while pos < 250:
        n = int(rng.randint(1, 60))
        seg[0, pos:pos + n] = sid
        pos += n + int(rng.randint(0, 3))
        sid += 1
    q, k, v, cot = _inputs(1, 256, 256, seed=7)
    _compare((q, k, v, cot, seg, True, 128, 16, True, 0), torch.float32)


@pytest.mark.parametrize("lengths,tile", [([100, 64, 30], 64),
                                          ([100, 0, 64, 30], 64),
                                          ([200, 7], 64),
                                          ([1, 127, 128], 32)])
def test_segment_windows_match_jax(lengths, tile):
    """The kernels' packed windows are the reference's ``_segment_windows``
    at the kernels' tile (exclusive hi, empty as lo >= hi)."""
    ln = np.asarray(lengths, np.int32)
    seg = jpa.segments_from_lengths(jnp.asarray(ln), len(ln), 128)
    lo_j, hi_j = (np.asarray(x) for x in jpa._segment_windows(
        seg, seg, tile, tile))
    lo, hi = ta._segment_windows(torch.from_numpy(np.array(seg)), tile)
    live = lo_j <= hi_j
    np.testing.assert_array_equal(lo.numpy()[live], lo_j[live])
    np.testing.assert_array_equal(hi.numpy()[live], hi_j[live] + 1)
    assert np.all(lo.numpy()[~live] >= hi.numpy()[~live])


def test_tile_windows_padded():
    """Padded windows: key tiles below each row's length (q-major); every
    q tile for a key tile starting below it, none past it (k-major)."""
    (lo_q, hi_q), (lo_k, hi_k) = ta.tile_windows(
        torch.tensor([130, 0, 64], dtype=torch.int32), None, 3, 100, 200,
        "cpu")
    assert lo_q.tolist() == [[0, 0]] * 3
    assert hi_q.tolist() == [[3, 3], [0, 0], [1, 1]]
    assert lo_k.tolist() == [[0] * 4] * 3
    assert hi_k.tolist() == [[2, 2, 2, 0], [0] * 4, [2, 0, 0, 0]]
    assert all(x.dtype == torch.int32 and x.is_contiguous()
               for x in (lo_q, hi_q, lo_k, hi_k))


# ------------------------------------------------------------- dispatch
def _jax_counts():
    pat = re.compile(r'attention_dispatch_total\{path="([^"]*)",'
                     r'reason="([^"]*)"\}')
    out = {}
    for key, val in observe.REGISTRY.flat(kinds=("counter",)).items():
        m = pat.fullmatch(key)
        if m:
            out[(m.group(1), m.group(2))] = val
    return out


def _mha_nets(t, causal, packed, block):
    conf = dict(name="attn", type="scaled_dot_product_attention", size=16,
                with_bias=True, attrs={"num_heads": 2, "causal": causal,
                                       "packed": packed, "block_q": block,
                                       "block_k": block})
    jlayers = [JConf(name="x", type="data", size=16),
               JConf(inputs=[JIn(input_layer_name="x")], **conf)]
    tlayers = [LayerConfig(name="x", type="data", size=16),
               LayerConfig(inputs=[LayerInput(input_layer_name="x")],
                           **conf)]
    jnet = JNet(JModel(layers=jlayers, input_layer_names=["x"],
                       output_layer_names=["attn"]))
    tnet = TNet(ModelConfig(layers=tlayers, input_layer_names=["x"],
                            output_layer_names=["attn"]))
    return jnet, tnet


GRID = [(fk, bs, ap) for fk in (True, False) for bs in (True, False)
        for ap in (True, False)]


@pytest.mark.parametrize("shape", ["padded", "packed", "causal",
                                   "untileable"])
def test_dispatch_labels_match_jax(shape):
    """Over the three flags, the port's ``attention_dispatch_total``
    decisions (one layer forward) equal the reference counter's
    increments, label for label and count for count."""
    t, block = (100, 64) if shape == "untileable" else (128, 128)
    jnet, tnet = _mha_nets(t, shape == "causal",
                           shape in ("packed", "untileable"), block)
    jp = jnet.init_params(seed=0)
    tp = network_params_from_jax({n: np.asarray(v) for n, v in jp.items()},
                                 tnet, "cpu")
    rng = np.random.RandomState(8)
    x = rng.randn(2, t, 16).astype(np.float32)
    ln = np.asarray([t, t // 2], np.int32)
    for fk, bs, ap in GRID:
        _set_both(flash_kernel=fk, flash_block_sparse=bs,
                  attention_packing=ap)
        before = _jax_counts()
        jnet.forward(jp, {"x": JSeq(jnp.asarray(x), jnp.asarray(ln))},
                     is_training=False)
        after = _jax_counts()
        want = {k: v - before.get(k, 0) for k, v in after.items()
                if v != before.get(k, 0)}
        ta.attention_dispatch_total.clear()
        tnet.forward(tp, {"x": TSeq(torch.from_numpy(x),
                                    torch.from_numpy(ln))})
        assert dict(ta.attention_dispatch_total) == want, (fk, bs, ap)


def test_direct_dispatch_labels_match_jax():
    """The op-level decisions of the reference's own counter test: block
    sparse, legacy grid, dense by kill switch, dense untileable."""
    q, k, v, _ = _inputs(2, 256, 256, seed=9)
    qs = np.zeros((1, 48, 1, 8), np.float32)
    calls = [((q, k, v), True, 128, 16, {}),
             ((q, k, v), True, 128, 16, {"flash_block_sparse": False}),
             ((q, k, v), True, 128, 16, {"flash_kernel": False}),
             ((qs, qs, qs), False, 16, 12, {})]
    for args, causal, bq, bk, flags in calls:
        _set_both(**{"flash_kernel": True, "flash_block_sparse": True,
                     **flags})
        before = _jax_counts()
        jpa.flash_attention(*(jnp.asarray(a) for a in args), None, causal,
                            bq, bk)
        after = _jax_counts()
        want = {k_: n - before.get(k_, 0) for k_, n in after.items()
                if n != before.get(k_, 0)}
        ta.attention_dispatch_total.clear()
        ta.flash_attention(*(torch.from_numpy(a) for a in args), None,
                           causal, bq, bk)
        assert dict(ta.attention_dispatch_total) == want, flags


def test_legacy_and_dense_paths_match_jax_on_cpu():
    """The legacy grid decision takes the plain version on the CPU; the
    dense kill switch is the plain composition: both equal JAX's."""
    q, k, v, cot = _inputs(2, 256, 256, seed=10)
    ln = np.asarray([256, 100], np.int32)
    for flags in ({"flash_block_sparse": False}, {"flash_kernel": False}):
        _set_both(**{"flash_kernel": True, "flash_block_sparse": True,
                     **flags})
        want_out, _, want_g = _jax_run(q, k, v, cot, ln, True, 128, 16,
                                       False, 0, torch.float32)
        ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out = ta.flash_attention(*ts, torch.from_numpy(ln), True, 128, 16)
        (out * torch.from_numpy(cot)).sum().backward()
        _close(out.detach().numpy(), want_out, torch.float32)
        for t_, w in zip(ts, want_g):
            _close(t_.grad.numpy(), w, torch.float32, grad=True)


def test_causal_and_packed_need_square_shapes():
    q = torch.zeros(1, 32, 1, 8)
    k = torch.zeros(1, 64, 1, 8)
    with pytest.raises(PaddleTpuError, match="32/64"):
        ta.flash_attention(q, k, k, None, True, 32, 32)
    with pytest.raises(PaddleTpuError, match="32/64"):
        ta.flash_attention_packed(q, k, k, torch.zeros(1, 32, dtype=torch.
                                                       int32))


# --------------------------------------------------- routing on the card
def _spy_card(monkeypatch):
    """Pretend the CPU tensors lie on the card: the wrappers' device test
    and the dispatch's say CUDA, and each launch is recorded (symbol and
    its shape ints) instead of run."""
    launched = []
    monkeypatch.setattr(ta, "_on_card", lambda tensors, d: True)
    monkeypatch.setattr(ta, "_is_cuda", lambda x: True)
    monkeypatch.setattr(ta, "_launch", lambda symbol, device, *args:
                        launched.append((symbol, args)))
    ta.reset_launch_counts()
    ta.attention_dispatch_total.clear()
    return launched


def _grad_inputs(b=2, t=128, h=2, d=64):
    qkv = torch.zeros(b, t, 3 * h * d, requires_grad=True)
    q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    return qkv, q, k, v


def test_card_block_sparse_launches_kernels_1_3_4(monkeypatch):
    """A block-sparse call on the card launches kernel 1 forward, then
    kernel 3 and kernel 4 in the backward, once each, on the q/k/v views
    of one projection (token stride 3·H·D)."""
    launched = _spy_card(monkeypatch)
    qkv, q, k, v = _grad_inputs()
    out = ta.flash_attention(q, k, v, torch.tensor([128, 60],
                                                   dtype=torch.int32))
    out.sum().backward()
    assert [s for s, _ in launched] == ["flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv"]
    assert launched[0][1][9:13] == (2, 128, 128, 2)       # B, Tq, Tk, H
    assert launched[0][1][15:21] == (128 * 384, 384) * 3    # q/k/v strides
    assert [fn.launches for fn in ta.KERNEL_WRAPPERS] == [0, 0, 1, 1, 1, 0,
                                                          0, 0]
    assert ta.attention_dispatch_total == {("block_sparse", ""): 1}
    ta.reset_launch_counts()


def test_card_packed_launches_kernels_1_3_4(monkeypatch):
    launched = _spy_card(monkeypatch)
    _, q, k, v = _grad_inputs(1, 256)
    seg = ta.segments_from_lengths(torch.tensor([100, 128]), 2, 128)
    ta.flash_attention_packed(q, k, v, seg, True, 128, 128, 128) \
        .sum().backward()
    assert [s for s, _ in launched] == ["flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv"]
    assert ta.attention_dispatch_total == {("packed", ""): 1}
    ta.reset_launch_counts()


def test_card_legacy_grid_launches_kernels_2_5_6(monkeypatch):
    """Under ``--flash_block_sparse=false`` a padded call on the card
    launches kernel 2 forward, then kernels 5 and 6 in the backward,
    once each, and none of the block-sparse kernels."""
    launched = _spy_card(monkeypatch)
    TFLAGS.set("flash_block_sparse", False)
    qkv, q, k, v = _grad_inputs()
    ta.flash_attention(q, k, v, torch.tensor([128, 60], dtype=torch.int32),
                       True).sum().backward()
    assert [s for s, _ in launched] == ["flash_fwd_legacy",
                                        "flash_bwd_dq_legacy",
                                        "flash_bwd_dkv_legacy"]
    assert [fn.launches for fn in ta.KERNEL_WRAPPERS] == [0, 0, 0, 0, 0, 1,
                                                          1, 1]
    assert ta.attention_dispatch_total == {
        ("legacy_grid", "kill_switch:flash_block_sparse"): 1}
    assert qkv.grad is not None
    ta.reset_launch_counts()


def test_card_flash_off_runs_the_dense_path(monkeypatch):
    launched = _spy_card(monkeypatch)
    TFLAGS.set("flash_kernel", False)
    qkv, q, k, v = _grad_inputs()
    ta.flash_attention(q, k, v).sum().backward()
    assert launched == [] and qkv.grad is not None
    assert ta.attention_dispatch_total == {("dense",
                                            "kill_switch:flash_kernel"): 1}


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("bad", ["fp16", "mixed", "shape"])
def test_wrappers_reject_bad_inputs(bad):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 16, 16))
    if bad == "fp16":
        q, k, v = (x.half() for x in (q, k, v))
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    else:
        v = v[:, :8]
    with pytest.raises(PaddleTpuError):
        ta.flash_fwd(q, k, v)
    with pytest.raises(PaddleTpuError):
        ta.flash_attention(q, k, v)


def test_card_rejects_what_the_kernels_do_not_take(monkeypatch):
    """On the card: a head dim the kernels are not built for, and a token
    stride off 16 bytes, raise before any launch."""
    launched = _spy_card(monkeypatch)
    monkeypatch.setattr(ta, "_on_card", lambda tensors, d: ta._check_card(
        [x for x in tensors if x is not None], d) or True)
    with pytest.raises(PaddleTpuError, match="head dim"):
        ta.flash_fwd(*(torch.zeros(1, 8, 1, 48) for _ in range(3)))
    odd = torch.zeros(1, 8, 1, 66)[..., :64]          # token stride 66
    with pytest.raises(PaddleTpuError, match="16-byte"):
        ta.flash_fwd(odd, odd, odd)
    assert launched == []
