"""Rules the port (``paddle_tpu_torch``) keeps.

- It imports neither JAX nor anything of the JAX package, and importing
  its telemetry core (``observe``) loads no torch.
- Its entry points run on CUDA unless asked for the CPU, and raise when
  CUDA is absent instead of moving to the CPU; importing the serving
  loader loads no layer engine.
- Its kernel wrappers count launches only where a kernel is launched
  (never on CPU tensors), and check dtype and contiguity first.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.ops import attention as ta
from paddle_tpu_torch.serving import model as tm
from paddle_tpu_torch.utils import PaddleTpuError

PORT = pathlib.Path(paddle_tpu_torch.__file__).parent
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu"}
CFG = tm.DecoderConfig(vocab=64, dim=32, heads=2, layers=1, ffn=64,
                       max_context=64)


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_nor_jax_package():
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"] \
        + sorted((PORT.parent / "tools").glob("*.py"))
    assert len(files) > 10
    bad = {str(f.relative_to(PORT.parent)): sorted(
        set(_imported_roots(f)) & FORBIDDEN) for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


#: queue A10a, the telemetry core: the JAX package's files and the port's
#: counterparts at the same paths
A10A_FILES = ("analysis/lockorder.py", "utils/stat.py", "utils/profiler.py",
              "observe/__init__.py", "observe/metrics.py", "observe/report.py",
              "observe/trace.py", "observe/http.py", "observe/dump.py",
              "observe/shutdown.py", "observe/memory.py")


def test_telemetry_core_files_are_ported_and_scanned():
    jax_pkg = PORT.parent / "paddle_tpu"
    scanned = {str(f.relative_to(PORT)) for f in PORT.rglob("*.py")}
    for rel in A10A_FILES:
        assert (jax_pkg / rel).is_file()
        assert rel in scanned


#: queue A6's remainder: the JAX package's files and the port's
#: counterparts at the same paths
A6_FILES = ("serving/rollout.py", "observe/slo.py", "testing/__init__.py",
            "testing/fault.py")


def test_rollout_slo_and_testing_files_are_ported_and_scanned():
    jax_pkg = PORT.parent / "paddle_tpu"
    scanned = {str(f.relative_to(PORT)) for f in PORT.rglob("*.py")}
    for rel in A6_FILES:
        assert (jax_pkg / rel).is_file()
        assert rel in scanned
        assert not set(_imported_roots(PORT / rel)) & FORBIDDEN


#: queue A9, multi-device: the JAX package's files and the port's
#: counterparts at the same paths (core/device.py holds the mesh half)
A9_FILES = ("parallel/sharding.py", "parallel/rule_tables.py",
            "parallel/local_sgd.py", "parallel/ring_attention.py",
            "distributed/__init__.py", "distributed/master.py",
            "distributed/launch.py", "distributed/elastic.py",
            "core/device.py")


def test_multi_device_files_are_ported_and_scanned():
    """The eight A9 files and the mesh half of ``core/device.py`` exist
    at the JAX package's paths, the AST scan covers them, none imports
    JAX or the JAX package, and no port file refuses anything by the
    queue's name any more."""
    jax_pkg = PORT.parent / "paddle_tpu"
    scanned = {str(f.relative_to(PORT)) for f in PORT.rglob("*.py")}
    for rel in A9_FILES:
        assert (jax_pkg / rel).is_file()
        assert rel in scanned
        assert not set(_imported_roots(PORT / rel)) & FORBIDDEN
    from paddle_tpu_torch.core import device
    for name in ("parse_mesh_shape", "build_mesh", "get_mesh", "set_mesh",
                 "data_sharding", "replicated", "num_data_shards",
                 "DATA_AXIS", "MODEL_AXIS"):
        assert hasattr(device, name), name
    assert not [str(f) for f in PORT.rglob("*.py") if "queue A9" in
                f.read_text()]


def test_importing_the_loader_loads_no_layer_engine():
    """A process that only loads artifacts imports no ``layers``,
    ``config``, ``trainer`` or ``framework`` (the reference's capi
    boundary); the kernel-op module is imported at ``ServedModel.load``."""
    import subprocess
    import sys
    code = ("import sys, paddle_tpu_torch.serving.loader; "
            "bad = [m for m in sys.modules if m.startswith(tuple("
            "'paddle_tpu_torch.' + p for p in ('layers', 'config', "
            "'trainer', 'framework')))]; "
            "sys.exit(3 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(PORT.parent),
                          timeout=120)
    assert proc.returncode == 0


def test_serving_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """``ServedModel.load`` and the hot swap's model build run on the
    card unless the CPU is asked for (the swap builds on the serving
    model's device)."""
    from paddle_tpu_torch.serving import ServedModel, export_inference_fn
    from paddle_tpu_torch.serving.rollout import swap_from_artifact
    from paddle_tpu_torch.serving.server import InferenceServer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path / "fn")
    export_inference_fn(lambda feed: {"y": feed["x"] * 2},
                        {"x": np.ones((2, 3), np.float32)}, d, ["y"])
    for device in (None, "cuda"):
        with pytest.raises(PaddleTpuError, match="no CUDA device"):
            ServedModel.load(d, device=device)
    assert ServedModel.load(d, device="cpu")(
        x=np.ones((2, 3), np.float32))["y"].tolist() == [[2.0] * 3] * 2
    art = str(tmp_path / "dec")
    tm.export_decoder(tm.init_decoder_params(CFG, seed=1), CFG, art)
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        tm.DecoderModel.from_artifact(art)
    srv = InferenceServer(tm.DecoderModel(tm.init_decoder_params(CFG), CFG,
                                          device="cpu"),
                          max_batch=2, n_pages=17, page_size=8)
    with srv:
        assert swap_from_artifact(srv, art)["result"] == "ok"
        assert all(t.device.type == "cpu"
                   for t in srv.model.params.values())


def test_unported_rollout_pieces_refuse_by_name(tmp_path):
    from paddle_tpu_torch.serving.rollout import RollingCoordinator
    from paddle_tpu_torch.testing import fault
    with pytest.raises(PaddleTpuError, match="A10b"):
        RollingCoordinator("127.0.0.1:1", [])
    with pytest.raises(PaddleTpuError, match="A10b"):
        fault.FleetPusherProcess("127.0.0.1:1", "x")
    with pytest.raises(PaddleTpuError, match="fleet_addr.*A10b"):
        fault.TrainerLoopProcess("/nonexistent", fleet_addr="h:1")
    # the master's injectors are ported: a served child master, and a
    # client whose dropped connections are replayed
    from paddle_tpu_torch.distributed import MasterClient
    with fault.MasterServerProcess(str(tmp_path / "snap")) as srv:
        with MasterClient(srv.addr, retry_max=3) as c:
            c.set_dataset(["a", "b"])
            with fault.drop_master_connection(c, every=2) as stats:
                assert [c.get_task()[1] for _ in range(2)] == ["a", "b"]
            assert stats["dropped"] == 1


def test_importing_observe_loads_no_torch():
    """The port's counterpart of the JAX package's import-time rule for
    ``observe``: importing it (and recording a counter and a span) loads
    no torch."""
    import subprocess
    import sys
    code = ("import sys, paddle_tpu_torch.observe as o; "
            "o.counter('x').inc(); o.trace.enable(); "
            "o.trace.span('s').__enter__(); "
            "sys.exit(3 if 'torch' in sys.modules else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(PORT.parent),
                          timeout=120)
    assert proc.returncode == 0


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = tm.init_decoder_params(CFG, seed=0)
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        tm.DecoderModel(params, CFG, device=None)
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        tm.DecoderModel(params, CFG, device="cuda")
    m = tm.DecoderModel(params, CFG, device="cpu")
    assert all(t.device.type == "cpu" for t in m.params.values())


def test_launch_counters_stay_zero_on_cpu():
    ta.reset_launch_counts()
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 16, 2, 8)).astype(np.float32)) for _ in range(3))
    seg = ta.segments_from_lengths(torch.tensor([5, 8], dtype=torch.int32),
                                   2, 8)
    ta.prefill_attention_packed(q, k, v, seg, causal=True)
    kp = torch.zeros((4, 4, 2, 8))
    ta.paged_decode_attention(q[:, :2].reshape(2, 1, 2, 8).contiguous(),
                              kp, kp, torch.ones((2, 2), dtype=torch.int32),
                              torch.tensor([3, 1], dtype=torch.int32))
    ta.flash_attention(q, k, v, torch.tensor([16], dtype=torch.int32),
                       True).sum()
    assert ta.prefill_attention_packed.launches == 0
    assert all(fn.launches == 0 for fn in ta.KERNEL_WRAPPERS)


def _packed_args():
    q = torch.zeros((1, 8, 2, 8))
    seg = torch.zeros((1, 8), dtype=torch.int32)
    return [q, q.clone(), q.clone(), seg]


def _decode_args():
    return [torch.zeros((2, 1, 2, 8)), torch.zeros((4, 4, 2, 8)),
            torch.zeros((4, 4, 2, 8)), torch.ones((2, 2), dtype=torch.int32),
            torch.ones((2,), dtype=torch.int32)]


@pytest.mark.parametrize("wrapper,make,pos,bad", [
    (ta.prefill_attention_packed, _packed_args, 0,
     lambda t: t.to(torch.bfloat16)),
    (ta.prefill_attention_packed, _packed_args, 1,
     lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)),
    (ta.prefill_attention_packed, _packed_args, 3,
     lambda t: t.to(torch.int64)),
    (ta.paged_decode_attention, _decode_args, 0,
     lambda t: t.to(torch.float16)),
    (ta.paged_decode_attention, _decode_args, 1,
     lambda t: t.transpose(0, 1).contiguous().transpose(0, 1)),
    (ta.paged_decode_attention, _decode_args, 3,
     lambda t: t.t().contiguous().t()),
    (ta.paged_decode_attention, _decode_args, 4,
     lambda t: t.to(torch.int64)),
], ids=["packed_q_bf16", "packed_k_noncontig", "packed_seg_int64",
        "decode_q_fp16", "decode_pages_noncontig", "decode_table_noncontig",
        "decode_lengths_int64"])
def test_wrappers_reject_bad_inputs(wrapper, make, pos, bad):
    args = make()
    wrapper(*args)                       # the good inputs run
    args[pos] = bad(args[pos])
    with pytest.raises(PaddleTpuError):
        wrapper(*args)


# ------------------------------------------------------------ training slice
from paddle_tpu_torch.entry import entry as lstm_entry  # noqa: E402
from paddle_tpu_torch.layers.network import NeuralNetwork  # noqa: E402
from paddle_tpu_torch.models import lstm_text_classifier  # noqa: E402
from paddle_tpu_torch.ops import lstm as tl  # noqa: E402
from paddle_tpu_torch.ops import recurrent_ops as tro  # noqa: E402
from paddle_tpu_torch.core.sequence import SequenceBatch  # noqa: E402
from paddle_tpu_torch.trainer.trainer import Trainer  # noqa: E402


def test_scan_covers_the_training_slice():
    scanned = {str(f.relative_to(PORT)) for f in PORT.rglob("*.py")}
    assert {"ops/lstm.py", "ops/recurrent_ops.py", "layers/network.py",
            "ops/attention.py", "layers/attention.py", "models/text.py",
            "trainer/trainer.py", "optimizer/optimizers.py", "entry.py",
            "utils/jax_interop.py", "core/dtypes.py", "ops/math_ops.py",
            "optimizer/loss_scale.py"} <= scanned
    assert (PORT.parent / "tools" / "lstm_blocked_probe.py").exists()


def test_training_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = NeuralNetwork(lstm_text_classifier(50, 8, 16, 1, 2))
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        net.init_params(0)
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        Trainer(net, seed=0)
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        lstm_entry()
    tr = Trainer(net, seed=0, device="cpu")
    assert all(p.device.type == "cpu" for p in tr.params.values())


def _lstm_fwd_args(b=3, t=4, h=8):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(b, t, 4 * h, generator=g), torch.ones(b, t),
            torch.randn(h, 4 * h, generator=g) * 0.1, torch.zeros(3, h),
            torch.zeros(b, h), torch.zeros(b, h)]


def _lstm_bwd_args(b=3, t=4, h=8):
    fwd = _lstm_fwd_args(b, t, h)
    hseq, cseq, gates = tl.lstm_fwd(*fwd)
    xw, mask, w, ck, h0, c0 = fwd
    return [gates, hseq, cseq, h0, c0, mask, w, ck, torch.ones_like(hseq),
            torch.ones_like(cseq)]


def test_lstm_launch_counters_stay_zero_on_cpu():
    """A fused-tier shape (the reference's rule: B % 8 == 0, H % 128 ==
    0) runs the plain versions on CPU tensors: no count."""
    tl.reset_launch_counts()
    xw = torch.randn(8, 5, 512, requires_grad=True)
    seq = SequenceBatch(xw, torch.tensor([5, 0, 2, 5, 1, 3, 4, 5],
                                         dtype=torch.int32))
    out, final = tro.lstm_sequence(seq, None, torch.randn(128, 512) * 0.1)
    (out.data.sum() + final.c.sum()).backward()
    assert xw.grad is not None
    assert tl.lstm_fwd.launches == 0 and tl.lstm_bwd.launches == 0


def test_blocked_lstm_launch_counters_stay_zero_on_cpu():
    tl.reset_launch_counts()
    xw = torch.randn(8, 3, 4 * 640, requires_grad=True)
    seq = SequenceBatch(xw, torch.tensor([3, 1] * 4, dtype=torch.int32))
    out, final = tro.lstm_sequence(seq, None, torch.randn(640, 4 * 640) * 0.05)
    (out.data.sum() + final.c.sum()).backward()
    assert xw.grad is not None
    assert all(fn.launches == 0 for fn in tl.KERNEL_WRAPPERS)


def _lstm_bwd_blocked_args(b=3, t=4, h=8):
    gates, hseq, cseq, h0, c0, mask, w, ck, dy, dyc = _lstm_bwd_args(b, t, h)
    return [gates, cseq, c0, mask, w, ck, dy, dyc]


def _lstm_dw_blocked_args(b=3, t=4, h=8):
    gates, hseq, cseq, h0, c0, mask, *_ = _lstm_bwd_args(b, t, h)
    return [hseq, h0, gates, mask]


@pytest.mark.parametrize("wrapper,make,pos,bad", [
    (tl.lstm_fwd_blocked, _lstm_fwd_args, 0, lambda t: t.to(torch.bfloat16)),
    (tl.lstm_fwd_blocked, _lstm_fwd_args, 2,
     lambda t: t.t().contiguous().t()),
    (tl.lstm_bwd_blocked, _lstm_bwd_blocked_args, 1,
     lambda t: t.transpose(0, 1).contiguous().transpose(0, 1)),
    (tl.lstm_bwd_blocked, _lstm_bwd_blocked_args, 6,
     lambda t: t.to(torch.bfloat16)),
    (tl.lstm_dw_blocked, _lstm_dw_blocked_args, 2, lambda t: t[:, :, :-4]),
], ids=["fwd_xw_bf16", "fwd_whh_noncontig", "bwd_cseq_noncontig",
        "bwd_dy_bf16", "dw_dxw_shape"])
def test_blocked_lstm_wrappers_reject_bad_inputs(wrapper, make, pos, bad):
    args = make()
    wrapper(*args)                       # the good inputs run
    args[pos] = bad(args[pos])
    with pytest.raises(PaddleTpuError):
        wrapper(*args)


def test_blocked_lstm_bwd_card_path_hands_its_scratch(monkeypatch):
    """On CUDA the blocked backward (kernel 11) hands its kernel the
    scratch it writes: the pull-back's sums by K slice [S, B, H] f32 (S
    from ``bwd_blocked_slices``), each step's row ranks and counts (T*B
    + T int32), w_hh's and a step's dgates' hi and lo bf16 planes [2, H,
    Kp] and [2, B, Kp] (Kp = 4H rounded up to 64).  The device test and
    the launch are monkeypatched so the CPU reaches the launch; nothing
    is launched, and the wrapper's input checks still run first."""
    b, t, h = 3, 4, 9
    args = _lstm_bwd_blocked_args(b, t, h)
    monkeypatch.setattr(tl, "_on_card", lambda tensors: True)
    monkeypatch.setattr(tl, "fused_tier", lambda *a: "fused_blocked")
    launched, made = [], []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(
        (tuple(a[0]) if a and isinstance(a[0], tuple) else a, k["dtype"]))
        or real_empty(*a, **k))
    monkeypatch.setattr(tl, "_launch", lambda sym, ptrs, ints, dev:
                        launched.append((sym, len(ptrs), ints)))
    monkeypatch.setattr(tl.lstm_bwd_blocked, "launches", 0)
    tl.lstm_bwd_blocked(*args)
    s = tl.bwd_blocked_slices(b, h)
    assert launched == [("lstm_bwd_blocked", 17, (b, t, h, s))]
    assert tl.lstm_bwd_blocked.launches == 1
    assert made == [((s, b, h), torch.float32), ((t * b + t,), torch.int32),
                    ((2, h, 64), torch.bfloat16),
                    ((2, b, 64), torch.bfloat16)]
    bad = list(args)
    bad[6] = bad[6].to(torch.bfloat16)
    with pytest.raises(PaddleTpuError):
        tl.lstm_bwd_blocked(*bad)
    assert len(launched) == 1


def _spy_card_launch(monkeypatch, tier):
    """Monkeypatch the device test, the tier and the launch so that the
    CPU reaches a wrapper's launch: returns the lists of launches (symbol,
    pointer count, ints) and of the scratch made with ``torch.empty``
    (shape, dtype)."""
    monkeypatch.setattr(tl, "_on_card", lambda tensors: True)
    monkeypatch.setattr(tl, "fused_tier", lambda *a: tier)
    launched, made = [], []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(
        (tuple(a[0]) if a and isinstance(a[0], tuple) else a, k["dtype"]))
        or real_empty(*a, **k))
    monkeypatch.setattr(tl, "_launch", lambda sym, ptrs, ints, dev:
                        launched.append((sym, len(ptrs), ints)))
    return launched, made


def test_lstm_bwd_card_path_hands_its_scratch(monkeypatch):
    """On CUDA the single-block backward (kernel 9) hands its kernel the
    scratch it writes: the peephole products [3, B, H] f32, the
    pull-back's sums by K slice [S, B, H] (S from
    ``bwd_blocked_slices``), each step's row ranks and counts (T*B + T
    int32), the valid rows' list (B*T int32), w_hh's and a step's
    dgates' hi and lo bf16 planes [2, H, Kp] and [2, B, Kp] (Kp = 4H
    rounded up to 64), one dW sum a split [n_split, H, 4H] (none at one
    split).  Nothing is launched, and the input checks still run
    first."""
    b, t, h = 3, 4, 9
    args = _lstm_bwd_args(b, t, h)
    launched, made = _spy_card_launch(monkeypatch, "fused")
    monkeypatch.setattr(tl.lstm_bwd, "launches", 0)
    tl.lstm_bwd(*args)
    s, n_split = tl.bwd_blocked_slices(b, h), tl.bwd_dw_splits(h)
    assert n_split == tl.MAX_DW_SPLIT
    assert launched == [("lstm_bwd", 24, (b, t, h, s, n_split))]
    assert tl.lstm_bwd.launches == 1
    assert made == [((3, b, h), torch.float32), ((s, b, h), torch.float32),
                    ((t * b + t,), torch.int32), ((b * t,), torch.int32),
                    ((2, h, 64), torch.bfloat16),
                    ((2, b, 64), torch.bfloat16),
                    ((n_split, h, 4 * h), torch.float32)]
    bad = list(args)
    bad[8] = bad[8].to(torch.bfloat16)
    with pytest.raises(PaddleTpuError):
        tl.lstm_bwd(*bad)
    assert len(launched) == 1


def test_blocked_lstm_fwd_card_path_hands_its_scratch(monkeypatch):
    """On CUDA the blocked forward (kernel 10) hands its kernel the
    scratch it writes: the step product's sums by K slice [S, B, N] f32
    (S from ``fwd_blocked_slices``, N = 4 x H rounded up to 32), each
    step's row ranks and counts (T*B + T int32), the hi and lo bf16
    planes of w_hh's transpose [2, N, Kp] and of a step's h [2, B, Kp]
    (Kp = H rounded up to 64).  w_hh itself is not copied.  Nothing is
    launched, and the input checks still run first."""
    b, t, h = 3, 4, 9
    args = _lstm_fwd_args(b, t, h)
    launched, made = _spy_card_launch(monkeypatch, "fused_blocked")
    monkeypatch.setattr(tl.lstm_fwd_blocked, "launches", 0)
    tl.lstm_fwd_blocked(*args)
    s = tl.fwd_blocked_slices(b, h)
    assert launched == [("lstm_fwd_blocked", 13, (b, t, h, s))]
    assert tl.lstm_fwd_blocked.launches == 1
    assert made == [((b, t, h), torch.float32), ((s, b, 128), torch.float32),
                    ((t * b + t,), torch.int32),
                    ((2, 128, 64), torch.bfloat16),
                    ((2, b, 64), torch.bfloat16)]
    bad = list(args)
    bad[0] = bad[0].to(torch.bfloat16)
    with pytest.raises(PaddleTpuError):
        tl.lstm_fwd_blocked(*bad)
    assert len(launched) == 1


def test_lstm_fwd_card_path_hands_its_planes(monkeypatch):
    """On CUDA the single-block forward (kernel 8) hands its kernel the
    scratch it writes: h's hi and lo bf16 planes in two buffers by step
    parity [2, 2, B, Kp] (Kp = H rounded up to 64; every row, no ranks),
    with U from ``units_per_cta``.  w_hh is not copied: each CTA writes
    its own columns' planes into shared memory.  Nothing is launched,
    and the input checks still run first."""
    b, t, h = 3, 4, 70
    args = _lstm_fwd_args(b, t, h)
    launched, made = _spy_card_launch(monkeypatch, "fused")
    monkeypatch.setattr(tl.lstm_fwd, "launches", 0)
    tl.lstm_fwd(*args)
    assert launched == [("lstm_fwd", 10, (b, t, h, tl.units_per_cta(h)))]
    assert tl.lstm_fwd.launches == 1
    assert made == [((b, t, h), torch.float32),
                    ((2, 2, b, 128), torch.bfloat16)]
    bad = list(args)
    bad[5] = bad[5].to(torch.bfloat16)
    with pytest.raises(PaddleTpuError):
        tl.lstm_fwd(*bad)
    assert len(launched) == 1


#: (b, h, sms) -> the tier the LSTM and GRU tests assert, before and after
#: kernels 8 and 16 moved onto the tensor cores; the GRU's single-block
#: tier serves any batch on any number of SMs since kernel 13 runs in
#: clusters (B 4096 at H 8, and 127 SMs at H 512, are "fused")
_LSTM_TIERS = {(128, 512, 132): "fused", (5, 96, 132): "fused",
               (8, 128, 132): "fused", (6, 200, 132): "fused",
               (200, 50, 132): "fused", (3, 64, 132): "fused",
               (128, 513, 132): "fused_blocked",
               (128, 640, 132): "fused_blocked",
               (128, 1280, 132): "fused_blocked",
               (128, 2048, 132): "fused_blocked",
               (7, 700, 132): "fused_blocked",
               (8192, 512, 132): None, (128, 512, 114): None}
_GRU_TIERS = {(128, 512, 132): "fused", (3, 50, 132): "fused",
              (128, 513, 132): "fused_blocked",
              (3, 1024, 132): "fused_blocked",
              (16, 520, 132): "fused_blocked",
              (5, 514, 132): "fused_blocked",
              (4096, 8, 132): "fused", (128, 512, 127): "fused"}


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_fused_tier_answers_as_before(kind):
    """``fused_tier`` gives the same label at every shape the LSTM and GRU
    tests assert, now that kernel 8's shared memory is its resident
    planes, ring and carries (at B 8192, H 512 the carries of U = 4 units
    leave no room: no tier, as before), kernel 16 runs on the blocked
    tier's 193 KB ring and kernel 13's shared memory does not grow with
    the batch."""
    mod, tiers = (tl, _LSTM_TIERS) if kind == "lstm" else (tgru, _GRU_TIERS)
    for (b, h, sms), want in tiers.items():
        assert mod.fused_tier(b, h, sms) == want, (b, h, sms)
    assert mod.fused_tier(128, mod.MAX_BLOCKED_HIDDEN + 1) is None
    if kind == "lstm":
        assert tl.units_per_cta(512) == 4 and tl.units_per_cta(128) == 1
        assert max(tl.smem_bytes(128, 512, 4)) <= tl.SMEM_BYTES


@pytest.mark.parametrize("wrapper,make,pos,bad", [
    (tl.lstm_fwd, _lstm_fwd_args, 0, lambda t: t.to(torch.bfloat16)),
    (tl.lstm_fwd, _lstm_fwd_args, 2,
     lambda t: t.t().contiguous().t()),
    (tl.lstm_fwd, _lstm_fwd_args, 4, lambda t: t.to(torch.bfloat16)),
    (tl.lstm_bwd, _lstm_bwd_args, 0,
     lambda t: t.transpose(0, 1).contiguous().transpose(0, 1)),
    (tl.lstm_bwd, _lstm_bwd_args, 8, lambda t: t.to(torch.bfloat16)),
], ids=["fwd_xw_bf16", "fwd_whh_noncontig", "fwd_h0_bf16",
        "bwd_gates_noncontig", "bwd_dy_bf16"])
def test_lstm_wrappers_reject_bad_inputs(wrapper, make, pos, bad):
    args = make()
    wrapper(*args)                       # the good inputs run
    args[pos] = bad(args[pos])
    with pytest.raises(PaddleTpuError):
        wrapper(*args)


def test_fused_tier_from_hopper_resources():
    assert tl.fused_tier(128, 512) == "fused"       # the bench row
    assert tl.fused_tier(5, 96) == "fused"          # no tiling gate
    assert tl.fused_tier(128, 513) == "fused_blocked"   # kernels 10-12
    assert tl.fused_tier(128, 1280) == "fused_blocked"
    assert tl.fused_tier(128, tl.MAX_BLOCKED_HIDDEN + 1) is None
    assert tl.fused_tier(8192, 512) is None         # shared memory
    assert tl.units_per_cta(512) == 4 and tl.units_per_cta(128) == 1
    assert tl.units_per_cta(512, sms=114) is None


def test_card_path_rejects_hidden_beyond_the_fused_tier(monkeypatch):
    """On CUDA a kernel raises on a shape its tier does not serve: the
    single-block forward at H = 640, and the blocked tier past its
    widest H (lowered here to 600), through ``lstm_sequence`` too.  The
    device test is monkeypatched so the CPU reaches that branch."""
    monkeypatch.setattr(tl, "_on_card", lambda tensors: True)
    with pytest.raises(PaddleTpuError, match="do not serve"):
        tl.lstm_fwd(*_lstm_fwd_args(b=2, t=2, h=640))
    monkeypatch.setattr(tl, "MAX_BLOCKED_HIDDEN", 600)
    with pytest.raises(PaddleTpuError, match="do not serve"):
        tl.lstm_fwd_blocked(*_lstm_fwd_args(b=2, t=2, h=640))
    seq = SequenceBatch(torch.zeros(8, 2, 4 * 640),
                        torch.tensor([2, 1] * 4, dtype=torch.int32))
    with pytest.raises(PaddleTpuError, match="do not serve"):
        tro.lstm_sequence(seq, None, torch.zeros(640, 4 * 640))


# --------------------------------------------------------------- image slice
from paddle_tpu_torch.models import image as timage  # noqa: E402
from paddle_tpu_torch.ops import conv as tconv  # noqa: E402


def test_scan_covers_the_image_slice():
    scanned = {str(f.relative_to(PORT)) for f in PORT.rglob("*.py")}
    assert {"ops/conv.py", "ops/nn_ops.py", "layers/conv.py",
            "analysis/netcheck.py", "models/image.py"} <= scanned
    assert {"conv3x3_common.cuh", "conv3x3_dx.cu", "conv3x3_fwd.cu",
            "conv3x3_fwd_bwd.cu", "conv3x3_chain_bwd.cu"} <= \
        {f.name for f in (PORT / "csrc").iterdir()}


def _small_resnet():
    return NeuralNetwork(timage.resnet_cifar10(8, 10, 32))


def test_image_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = _small_resnet()
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        net.init_params(0)
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        net.init_buffers()
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        Trainer(net, seed=0)
    tr = Trainer(net, seed=0, device="cpu")
    assert all(b.device.type == "cpu" for b in tr.buffers.values())
    assert len(tr.buffers) == 2 * 9          # mean and var of 9 batch norms


def test_conv_launch_counters_stay_zero_on_cpu():
    """A training step of resnet_cifar10(8) runs the chain op's forward
    and backward (kernels 19 and 21) on CPU tensors: plain versions, no
    count."""
    tconv.reset_launch_counts()
    net = _small_resnet()
    tr = Trainer(net, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    loss = tr.train_one_batch({
        "image": rng.randn(2, 3 * 32 * 32).astype(np.float32),
        "label": rng.randint(0, 10, (2,)).astype(np.int32)})
    assert np.isfinite(float(loss))
    assert all(fn.launches == 0 for fn in tconv.KERNEL_WRAPPERS)


def _conv_args(name, n=1, h=3, w=4, cin=64, cout=64):
    g = torch.Generator().manual_seed(0)
    z = torch.randn(n, h, w, cin, generator=g)
    dy = torch.randn(n, h, w, cout, generator=g)
    wt = torch.randn(3, 3, cin, cout, generator=g) * 0.05
    aff, co = torch.ones(2, cin), torch.ones(3, cout)
    return {"fwd": [z, aff, wt, True], "fwd_bwd": [dy, z, aff, wt, True],
            "dx": [dy, dy.clone(), co, wt],
            "chain": [dy, dy.clone(), co, z, aff, wt, True]}[name]


_CONV = {"fwd": tconv.conv3x3_fwd, "fwd_bwd": tconv.conv3x3_fwd_bwd,
         "dx": tconv.conv3x3_dx, "chain": tconv.conv3x3_chain_bwd}


@pytest.mark.parametrize("name,pos,bad", [
    ("fwd", 0, lambda t: t.to(torch.float16)),
    ("fwd", 1, lambda t: t.to(torch.bfloat16)),
    ("fwd", 2, lambda t: t.to(torch.bfloat16)),
    ("fwd", 0, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)),
    ("fwd_bwd", 0, lambda t: t[..., :32].contiguous()),
    ("fwd_bwd", 3, lambda t: t[:, :2].contiguous()),
    ("dx", 1, lambda t: t.to(torch.bfloat16)),
    ("dx", 2, lambda t: t[:2].contiguous()),
    ("chain", 3, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)),
    ("chain", 4, lambda t: t[:1].contiguous()),
], ids=["fwd_z_fp16", "fwd_aff_bf16", "fwd_w_dtype", "fwd_z_noncontig",
        "fwdbwd_dy_shape", "fwdbwd_w_not3x3", "dx_z_dtype", "dx_coeffs_rows",
        "chain_z1_noncontig", "chain_ci_rows"])
def test_conv_wrappers_reject_bad_inputs(name, pos, bad):
    args = _conv_args(name)
    _CONV[name](*args)                   # the good inputs run
    args[pos] = bad(args[pos])
    with pytest.raises(PaddleTpuError):
        _CONV[name](*args)


def test_conv_card_path_rejects_channels_off_the_tile(monkeypatch):
    """On CUDA the kernels take channels that are multiples of 64 and
    raise otherwise (no fallback).  The device test is monkeypatched so
    the CPU reaches that check."""
    monkeypatch.setattr(tconv, "_on_card", lambda tensors: True)
    with pytest.raises(PaddleTpuError, match="multiples of 64"):
        tconv.conv3x3_fwd(*_conv_args("fwd", cin=48))
    with pytest.raises(PaddleTpuError, match="multiples of 64"):
        tconv.conv3x3_dx(*_conv_args("dx", cout=96))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("name,pos", [("fwd", 2), ("dx", 3), ("chain", 5),
                                      ("fwd_bwd", 3)])
def test_conv_card_path_hands_tc_weights(monkeypatch, name, pos, dtype):
    """Kernels 19, 18, 21 and 20 run on the tensor-core loop: on CUDA
    their wrappers hand it the weights -- the forward weights for 19, the
    flipped, I/O-transposed ones for 18, 20 and 21 -- as bf16, or for
    fp32 as hi and lo bf16 planes [2, 3, 3, K, N].  The device test and
    the launch are monkeypatched so the CPU reaches the launch."""
    monkeypatch.setattr(tconv, "_on_card", lambda tensors: True)
    monkeypatch.setattr(_CONV[name], "launches", 0)
    handed, launched = [], []
    real = tconv._tc_weights
    monkeypatch.setattr(tconv, "_tc_weights",
                        lambda w: handed.append(real(w)) or handed[-1])
    monkeypatch.setattr(tconv, "_launch", lambda sym, ptrs, ints, dev:
                        launched.append((sym, ptrs)))
    args = [a.to(dtype) if torch.is_tensor(a) and a.dim() == 4 else a
            for a in _conv_args(name, cin=64, cout=128)]
    _CONV[name](*args)
    w = args[pos]
    if name != "fwd":
        w = torch.flip(w, (0, 1)).permute(0, 1, 3, 2)
    (wt,) = handed
    assert [sym for sym, _ in launched] == [_CONV[name].__name__]
    assert wt.data_ptr() in launched[0][1]
    assert wt.dtype == torch.bfloat16 and _CONV[name].launches == 1
    if dtype == torch.bfloat16:
        assert torch.equal(wt, w)
    else:
        assert wt.shape == (2,) + tuple(w.shape)
        assert torch.equal(wt[0], w.to(torch.bfloat16))
        assert torch.equal(wt[1], (w - wt[0].float()).to(torch.bfloat16))


# ------------------------------------------------------------ seq2seq slice
from paddle_tpu_torch.models import seq2seq_config  # noqa: E402
from paddle_tpu_torch.ops import gru as tgru  # noqa: E402
from paddle_tpu_torch.optimizer import loss_scale as tls  # noqa: E402


def test_scan_covers_the_seq2seq_slice():
    scanned = {str(f.relative_to(PORT)) for f in PORT.rglob("*.py")}
    assert {"ops/gru.py", "ops/sequence_ops.py", "layers/recurrent_group.py",
            "models/seq2seq.py", "layers/rnn.py", "layers/cost.py"} <= scanned
    assert {"gru_fwd.cu", "gru_bwd.cu", "gru_fwd_blocked.cu",
            "gru_bwd_blocked.cu", "gru_dw_blocked.cu"} <= \
        {f.name for f in (PORT / "csrc").iterdir()}


def _s2s_feed(b=3):
    rng = np.random.RandomState(0)
    lens = torch.tensor(([4, 2, 1, 3] * 2)[:b], dtype=torch.int32)
    return {name: SequenceBatch(torch.from_numpy(
        rng.randint(2, 30, (b, 4)).astype(np.int32)), lens)
        for name in ("source", "target", "target_next")}


def test_seq2seq_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = NeuralNetwork(seq2seq_config(30, 8, 16))
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        Trainer(net, seed=0)
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        tls.init_state()
    assert tls.init_state(device="cpu").scale.device.type == "cpu"


def _gru_step_counts(hidden):
    tgru.reset_launch_counts()
    tr = Trainer(NeuralNetwork(seq2seq_config(30, 8, hidden)), seed=0,
                 device="cpu")
    assert np.isfinite(float(tr.train_one_batch(_s2s_feed(8))))
    return [fn.launches for fn in tgru.KERNEL_WRAPPERS]


def test_gru_launch_counters_stay_zero_on_cpu():
    """A seq2seq training step (B 8, H 128: the reference's fused gate)
    runs both GRU kernels' plain versions on CPU tensors: no count."""
    assert _gru_step_counts(128) == [0] * 5


def test_blocked_gru_launch_counters_stay_zero_on_cpu():
    """The same at H 640, the blocked tier (kernels 15-17)."""
    assert _gru_step_counts(640) == [0] * 5


def _gru_fwd_args(b=3, t=4, h=8):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(b, t, 3 * h, generator=g), torch.ones(b, t),
            torch.randn(h, 2 * h, generator=g) * 0.1,
            torch.randn(h, h, generator=g) * 0.1, torch.zeros(b, h)]


def _gru_bwd_args(b=3, t=4, h=8):
    xw, mask, wg, wc, h0 = _gru_fwd_args(b, t, h)
    hseq, gates = tgru.gru_fwd(xw, mask, wg, wc, h0)
    return [gates, hseq, h0, mask, wg, wc, torch.ones_like(hseq)]


@pytest.mark.parametrize("wrapper,make,pos,bad", [
    (tgru.gru_fwd, _gru_fwd_args, 0, lambda t: t.to(torch.bfloat16)),
    (tgru.gru_fwd, _gru_fwd_args, 2, lambda t: t.t().contiguous().t()),
    (tgru.gru_fwd, _gru_fwd_args, 3, lambda t: t[:, :4].contiguous()),
    (tgru.gru_bwd, _gru_bwd_args, 1,
     lambda t: t.transpose(0, 1).contiguous().transpose(0, 1)),
    (tgru.gru_bwd, _gru_bwd_args, 6, lambda t: t.to(torch.bfloat16)),
], ids=["fwd_xw_bf16", "fwd_wgates_noncontig", "fwd_wcand_shape",
        "bwd_hseq_noncontig", "bwd_dy_bf16"])
def test_gru_wrappers_reject_bad_inputs(wrapper, make, pos, bad):
    args = make()
    wrapper(*args)                       # the good inputs run
    args[pos] = bad(args[pos])
    with pytest.raises(PaddleTpuError):
        wrapper(*args)


def _gru_dw_blocked_args(b=3, t=4, h=8):
    gates, hseq, h0, mask, *_ = _gru_bwd_args(b, t, h)
    return [hseq, h0, gates[..., h:2 * h].contiguous(), gates, mask]


@pytest.mark.parametrize("wrapper,make,pos,bad", [
    (tgru.gru_fwd_blocked, _gru_fwd_args, 0, lambda t: t.to(torch.bfloat16)),
    (tgru.gru_fwd_blocked, _gru_fwd_args, 3,
     lambda t: t.t().contiguous().t()),
    (tgru.gru_bwd_blocked, _gru_bwd_args, 0,
     lambda t: t.transpose(0, 1).contiguous().transpose(0, 1)),
    (tgru.gru_bwd_blocked, _gru_bwd_args, 6, lambda t: t.to(torch.bfloat16)),
    (tgru.gru_dw_blocked, _gru_dw_blocked_args, 2, lambda t: t[:, :, :-1]),
    (tgru.gru_dw_blocked, _gru_dw_blocked_args, 3,
     lambda t: t.to(torch.bfloat16)),
], ids=["fwd_xw_bf16", "fwd_wcand_noncontig", "bwd_gates_noncontig",
        "bwd_dy_bf16", "dw_rh_shape", "dw_dxw_bf16"])
def test_blocked_gru_wrappers_reject_bad_inputs(wrapper, make, pos, bad):
    args = make()
    wrapper(*args)                       # the good inputs run
    args[pos] = bad(args[pos])
    with pytest.raises(PaddleTpuError):
        wrapper(*args)


def test_blocked_gru_bwd_card_path_hands_its_scratch(monkeypatch):
    """On CUDA the blocked BPTT (kernel 16) hands its kernel the scratch
    it writes: the two products' sums by K slice [max(Sc, Sg), B, H] f32
    (Sc, Sg from ``bwd_blocked_slices``), each step's row ranks and
    counts (T*B + T int32), and the hi and lo bf16 planes of w_cand [2,
    H, Kc], w_gates [2, H, Kg], a step's dc_pre [2, B, Kc] and dg [2, B,
    Kg] (Kc, Kg = H, 2H rounded up to 64).  The device test and the
    launch are monkeypatched so the CPU reaches the launch; nothing is
    launched, and the input checks still run first."""
    b, t, h = 3, 4, 40
    args = _gru_bwd_args(b, t, h)
    monkeypatch.setattr(tgru, "_on_card", lambda tensors: True)
    monkeypatch.setattr(tgru, "fused_tier", lambda *a: "fused_blocked")
    launched, made = [], []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(
        (tuple(a[0]) if a and isinstance(a[0], tuple) else a, k["dtype"]))
        or real_empty(*a, **k))
    monkeypatch.setattr(tgru, "_launch", lambda sym, ptrs, ints, dev:
                        launched.append((sym, len(ptrs), ints)))
    monkeypatch.setattr(tgru.gru_bwd_blocked, "launches", 0)
    tgru.gru_bwd_blocked(*args)
    s_c, s_g = tgru.bwd_blocked_slices(b, h)
    assert (s_c, s_g) == (1, 1)
    assert launched == [("gru_bwd_blocked", 18, (b, t, h, s_c, s_g))]
    assert tgru.gru_bwd_blocked.launches == 1
    assert made == [((max(s_c, s_g), b, h), torch.float32),
                    ((t * b + t,), torch.int32),
                    ((2, h, 64), torch.bfloat16),
                    ((2, h, 128), torch.bfloat16),
                    ((2, b, 64), torch.bfloat16),
                    ((2, b, 128), torch.bfloat16)]
    bad = list(args)
    bad[6] = bad[6].to(torch.bfloat16)
    with pytest.raises(PaddleTpuError):
        tgru.gru_bwd_blocked(*bad)
    assert len(launched) == 1


def _spy_gru_card_launch(monkeypatch, tier):
    """``_spy_card_launch`` for the GRU wrappers: returns the lists of
    launches (symbol, pointer count, ints) and of the scratch made with
    ``torch.empty`` (shape, dtype)."""
    monkeypatch.setattr(tgru, "_on_card", lambda tensors: True)
    monkeypatch.setattr(tgru, "fused_tier", lambda *a: tier)
    launched, made = [], []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(
        (tuple(a[0]) if a and isinstance(a[0], tuple) else a, k["dtype"]))
        or real_empty(*a, **k))
    monkeypatch.setattr(tgru, "_launch", lambda sym, ptrs, ints, dev:
                        launched.append((sym, len(ptrs), ints)))
    return launched, made


def test_gru_bwd_card_path_hands_its_scratch(monkeypatch):
    """On CUDA the single-block BPTT (kernel 14, kernel 16's template
    with dW) hands its kernel kernel 16's scratch -- the two products'
    sums by K slice [max(Sc, Sg), B, H] f32 (Sc, Sg from ``bwd_slices``:
    one chunk a slice), each step's row ranks and
    counts (T*B + T int32), the hi and lo bf16 planes of w_cand [2, H,
    Kc], w_gates [2, H, Kg], a step's dc_pre [2, B, Kc] and dg [2, B,
    Kg] -- and its own: the valid rows' list (B*T int32) and one [H, 3H]
    dW sum a split of it [n_split, H, 3H] (none at one split).  The
    weights are not copied.  Nothing is launched, and the input checks
    still run first."""
    b, t, h = 3, 4, 40
    args = _gru_bwd_args(b, t, h)
    launched, made = _spy_gru_card_launch(monkeypatch, "fused")
    monkeypatch.setattr(tgru.gru_bwd, "launches", 0)
    tgru.gru_bwd(*args)
    s_c, s_g = tgru.bwd_slices(b, h)
    n_split = tgru.bwd_dw_splits(h)
    assert (s_c, s_g, n_split) == (1, 2, tgru.MAX_DW_SPLIT)
    assert launched == [("gru_bwd", 22, (b, t, h, s_c, s_g, n_split))]
    assert tgru.gru_bwd.launches == 1
    assert made == [((max(s_c, s_g), b, h), torch.float32),
                    ((t * b + t,), torch.int32),
                    ((2, h, 64), torch.bfloat16),
                    ((2, h, 128), torch.bfloat16),
                    ((2, b, 64), torch.bfloat16),
                    ((2, b, 128), torch.bfloat16),
                    ((b * t,), torch.int32),
                    ((n_split, h, 3 * h), torch.float32)]
    bad = list(args)
    bad[6] = bad[6].to(torch.bfloat16)
    with pytest.raises(PaddleTpuError):
        tgru.gru_bwd(*bad)
    assert len(launched) == 1


def test_blocked_gru_fwd_card_path_hands_its_scratch(monkeypatch):
    """On CUDA the blocked forward (kernel 15) hands its kernel the
    scratch it writes: a product's sums by K slice (max(Sg Ng, Sc H) x B
    f32, Sg and Sc from ``fwd_blocked_slices``, Ng = 2 x H rounded up to
    64), each step's row ranks and counts (T*B + T int32), the hi and lo
    bf16 planes of w_gates' transpose [2, Ng, Kp], of w_cand's [2, H,
    Kp], of a step's h_prev and r h_prev [2, B, Kp] (Kp = H rounded up to
    64).  The weights are not copied (no transposes).  Nothing is
    launched, and the input checks still run first."""
    b, t, h = 3, 4, 40
    args = _gru_fwd_args(b, t, h)
    launched, made = _spy_gru_card_launch(monkeypatch, "fused_blocked")
    monkeypatch.setattr(tgru.gru_fwd_blocked, "launches", 0)
    tgru.gru_fwd_blocked(*args)
    s_g, s_c = tgru.fwd_blocked_slices(b, h)
    assert (s_g, s_c) == (1, 1)
    assert launched == [("gru_fwd_blocked", 13, (b, t, h, s_g, s_c))]
    assert tgru.gru_fwd_blocked.launches == 1
    assert made == [((b, t, h), torch.float32),
                    ((max(s_g * 128, s_c * h) * b,), torch.float32),
                    ((t * b + t,), torch.int32),
                    ((2, 128, 64), torch.bfloat16),
                    ((2, h, 64), torch.bfloat16),
                    ((2, b, 64), torch.bfloat16),
                    ((2, b, 64), torch.bfloat16)]
    bad = list(args)
    bad[4] = bad[4].to(torch.bfloat16)
    with pytest.raises(PaddleTpuError):
        tgru.gru_fwd_blocked(*bad)
    assert len(launched) == 1


def _gru_tier_before(b, h, sms=132):
    """``gru.fused_tier``'s arithmetic before kernels 14 and 15 moved onto
    the tensor cores (``--fused_rnn_hblock`` on): the single-block
    kernels' shared memory was kernel 13's and kernel 14's fp32 weight
    rows, staging tiles, partial sums and per-row state; the blocked
    kernels' at most 193 KB."""
    if h > 512:
        return "fused_blocked" if h <= tgru.MAX_BLOCKED_HIDDEN else None
    fixed = 3 * 128 * 68 + 8 * 128 * 4 + 3 * b * 4
    hr, h2r = -(-h // 64) * 64, -(-2 * h // 64) * 64
    smem = 4 * max(hr * 12 + fixed, (hr + h2r) * 4 + fixed)
    return "fused" if -(-h // 4) <= sms and smem <= 232448 else None


def test_gru_fused_tier_answers_as_before_at_every_dispatched_shape():
    """Wherever the reference's rule (``recurrent_ops.dispatch_tier``)
    sends a GRU to a fused tier, B <= 1024 in steps of 8 and H <= 4096 in
    steps of 128, ``fused_tier`` gives the label it gave before kernels
    14 and 15 took the tensor-core ring (kernel 13 still sets the
    single-block tier's bounds)."""
    n = 0
    for b in range(8, 1025, 8):
        for h in range(128, 4097, 128):
            if tro.dispatch_tier(b, h, 3) is None:
                continue
            n += 1
            assert tgru.fused_tier(b, h) == _gru_tier_before(b, h), (b, h)
    assert n >= 128 * 4


# ------------------------------------------------------ config front end
from paddle_tpu_torch import cli as tcli  # noqa: E402
from paddle_tpu_torch import compat as tcompat  # noqa: E402
from paddle_tpu_torch.utils import ConfigError  # noqa: E402

from test_torch_config_parser import RNN, paddle_aliases  # noqa: E402,F401


def test_scan_covers_the_config_front_end():
    scanned = {str(f.relative_to(PORT)) for f in PORT.rglob("*.py")}
    assert {"config/dsl.py", "config/config_parser.py",
            "config/layer_math.py", "config/recurrent_units.py",
            "compat/__init__.py", "v2/__init__.py", "v2/networks.py",
            "utils/model_diagram.py", "cli.py", "__main__.py",
            "configs/rnn.py", "configs/provider.py", "ops/detection_ops.py",
            "layers/image3d.py", "layers/detection.py",
            "configs/image.py"} <= scanned
    # the configs import only the paddle.* aliases and numpy
    for name in ("rnn.py", "provider.py", "image.py"):
        roots = set(_imported_roots(PORT / "configs" / name))
        assert roots <= {"paddle", "numpy"}, (name, roots)
    assert not (PORT / "configs" / "__init__.py").exists()


def test_scan_covers_the_v2_api_and_data_formats():
    scanned = {str(f.relative_to(PORT)) for f in PORT.rglob("*.py")}
    v2 = {f"v2/{m}.py" for m in (
        "activation", "attr", "data_type", "dataset", "evaluator", "event",
        "image", "inference", "layer", "master", "model", "optimizer",
        "parameters", "plot", "pooling", "reader", "topology", "trainer")}
    assert v2 | {"data/recordio.py", "data/download.py",
                 "data/datasets.py"} <= scanned
    # PIL, scipy and matplotlib stay out of the module level
    for name in ("data/datasets.py", "v2/image.py", "v2/plot.py"):
        tree = ast.parse((PORT / name).read_text())
        top = {a.name.split(".")[0] for n in tree.body
               if isinstance(n, ast.Import) for a in n.names} | \
            {n.module.split(".")[0] for n in tree.body
             if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert not top & {"PIL", "scipy", "matplotlib"}, (name, top)


def test_v2_entry_points_raise_without_cuda(monkeypatch):
    from paddle_tpu_torch import v2
    from paddle_tpu_torch.config.dsl import config_scope
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with config_scope():
        x = v2.layer.data("x", v2.data_type.dense_vector(4))
        y = v2.layer.data("y", v2.data_type.dense_vector(1))
        pred = v2.layer.fc(x, size=1)
        cost = v2.layer.square_error_cost(pred, y)
        for device in (None, "cuda"):
            with pytest.raises(PaddleTpuError, match="no CUDA device"):
                v2.trainer.SGD(cost, device=device)
            with pytest.raises(PaddleTpuError, match="no CUDA device"):
                v2.infer(output_layer=pred, input=[], device=device)
        sgd = v2.trainer.SGD(cost, device="cpu")
        assert all(p.device.type == "cpu" for p in sgd.core.params.values())
        feed = {"x": np.ones((2, 4), np.float32)}
        out = v2.infer(output_layer=pred, parameters=sgd.parameters,
                       input=[feed], device="cpu")
        assert out.shape == (2, 1)


def test_cli_train_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["train", "--config", RNN],
                 ["train", "--config", RNN, "--device", "cuda",
                  "--job", "test"]):
        with pytest.raises(PaddleTpuError, match="no CUDA device"):
            tcli.main(argv)


def test_compat_install_refuses_a_foreign_paddle(paddle_aliases):  # noqa: F811
    import sys
    import types
    with paddle_aliases():
        foreign = types.ModuleType("paddle")
        sys.modules["paddle"] = foreign
        with pytest.raises(ConfigError, match="did not make"):
            tcompat.install()
        assert sys.modules["paddle"] is foreign


def test_port_registers_every_jax_layer_type():
    """Every layer type name the JAX package registers (entries and
    aliases, 110) is registered in the port, and no other."""
    from paddle_tpu.layers import LAYERS as JLAYERS
    from paddle_tpu_torch.layers import network  # noqa: F401
    from paddle_tpu_torch.layers.base import LAYERS as TLAYERS
    jtypes = set(JLAYERS._entries) | set(JLAYERS._aliases)
    assert set(TLAYERS) == jtypes
    assert len(jtypes) == 110
