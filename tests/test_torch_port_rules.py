"""Rules the port (``paddle_tpu_torch``) keeps.

- It imports neither JAX nor anything of the JAX package.
- Its entry points run on CUDA unless asked for the CPU, and raise when
  CUDA is absent instead of moving to the CPU.
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
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(PORT.parent)): sorted(
        set(_imported_roots(f)) & FORBIDDEN) for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


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
    ta.flash_attention_packed(q, k, v, seg, causal=True)
    kp = torch.zeros((4, 4, 2, 8))
    ta.paged_decode_attention(q[:, :2].reshape(2, 1, 2, 8).contiguous(),
                              kp, kp, torch.ones((2, 2), dtype=torch.int32),
                              torch.tensor([3, 1], dtype=torch.int32))
    assert ta.flash_attention_packed.launches == 0
    assert ta.paged_decode_attention.launches == 0


def _packed_args():
    q = torch.zeros((1, 8, 2, 8))
    seg = torch.zeros((1, 8), dtype=torch.int32)
    return [q, q.clone(), q.clone(), seg]


def _decode_args():
    return [torch.zeros((2, 1, 2, 8)), torch.zeros((4, 4, 2, 8)),
            torch.zeros((4, 4, 2, 8)), torch.ones((2, 2), dtype=torch.int32),
            torch.ones((2,), dtype=torch.int32)]


@pytest.mark.parametrize("wrapper,make,pos,bad", [
    (ta.flash_attention_packed, _packed_args, 0,
     lambda t: t.to(torch.bfloat16)),
    (ta.flash_attention_packed, _packed_args, 1,
     lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)),
    (ta.flash_attention_packed, _packed_args, 3,
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
