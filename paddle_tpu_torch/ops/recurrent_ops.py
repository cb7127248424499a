"""LSTM, GRU and the plain recurrence over padded sequences
(counterpart of ``paddle_tpu/ops/recurrent_ops.py``), registered under
the JAX names ``lstm``, ``gru``, ``recurrent``, ``lstm_unit`` and
``gru_unit``.

The input projection for all timesteps is one product outside the time
loop; the recurrence runs either in fused kernels (default activations:
:mod:`paddle_tpu_torch.ops.lstm`, :mod:`paddle_tpu_torch.ops.gru`, each
with a single-block tier for H <= 512 and a hidden-blocked tier above)
or in a per-step loop, :func:`lstm_scan` / :func:`gru_scan`.  Padding
keeps the state unchanged through masked steps.  Peephole ("check")
weights follow the reference LSTM; the GRU's gate layout is (u, r, c).
The plain recurrence (:func:`simple_rnn`) and the cell functions
(:func:`lstm_unit`, :func:`gru_unit`) have no kernel in either package:
they are per-step loops of library ops.

Which shapes take the fused kernels is the reference's rule
(:func:`dispatch_tier`, a copy of ``pallas_lstm.fused_tier``): B % 8 == 0,
H % 128 == 0, and above H = 512 the blocked tier's gate.  Every other
shape, and every non-default activation, takes the scan, on the card as
on the CPU, as the reference takes its ``lax.scan``.  Each decision is
counted in :data:`rnn_dispatch_total` and in the registry's
``rnn_dispatch_total`` counter (``observe/``) with the reference's
labels, once per call, and a default-activation shape sent to the scan
logs a one-time warning.

Precision, as in the JAX package: the input projection and the gate
bias are in the policy compute dtype; the fused kernels compute in fp32
whatever the policy; outputs and final states come back in the policy
output dtype.  The scan carries its state in the output dtype.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.dtypes import current_policy, record_op_precision
from ..core.sequence import SequenceBatch
from ..observe import counter
from ..utils import FLAGS
from ..utils.logger import get_logger, warn_once
from . import gru
from .activations import get_activation, sigmoid
from .lstm import lstm_fused_sequence, lstm_fused_sequence_blocked
from .math_ops import matmul
from .registry import register_op

_log = get_logger("ops.recurrent")

# ------------------------------------------------------------- dispatch
# The reference's rule (paddle_tpu/ops/pallas_lstm.py:48-110): which
# function is computed at which shape.  Its numbers describe the TPU
# kernels' VMEM, not Hopper's memory; they stay as they are so that both
# packages send every shape the same way.  Which Hopper kernels can serve
# a shape is ``lstm.fused_tier`` / ``gru.fused_tier``: where this rule
# says fused and they cannot, the kernel wrappers raise on CUDA.

#: Hidden-block width of the reference's blocked tier.
HBLOCK = 128
#: The reference's budget for its blocked kernels' VMEM residents.
_BLOCKED_VMEM_CAP = 14 * 1024 * 1024


def _blocked_vmem_bytes(b: int, h: int, n_gates: int) -> int:
    """The reference's estimate of its blocked kernels' VMEM residents,
    in bytes: five [B, H] f32 state scratches and the double-buffered
    [H, n_gates * HBLOCK] f32 weight column block."""
    return 5 * b * h * 4 + 2 * h * n_gates * HBLOCK * 4


def dispatch_tier(b: int, h: int, n_gates: int = 4) -> Optional[str]:
    """The reference's dispatch predicate (``pallas_lstm.fused_tier``;
    the GRU passes ``n_gates=3``, as ``pallas_gru.fused_tier`` does):
    ``"fused"`` for h <= 512, ``"fused_blocked"`` for 512 < h under
    ``--fused_rnn_hblock`` within the VMEM estimate, ``None`` (the scan)
    when b % 8 or h % 128 or otherwise.  It defines which function runs
    at which shape; it says nothing about Hopper's memory."""
    if b % 8 or h % 128:
        return None
    if h <= 512:
        return "fused"
    if not FLAGS.get("fused_rnn_hblock"):
        return None
    if h % HBLOCK or _blocked_vmem_bytes(b, h, n_gates) > _BLOCKED_VMEM_CAP:
        return None
    return "fused_blocked"


#: RNN lowering decisions counted by ``(kind, path, reason)``, with the
#: labels of the JAX package's ``rnn_dispatch_total`` counter (which
#: counts once per traced call; this one once per call).
rnn_dispatch_total: "collections.Counter" = collections.Counter()


def _record_dispatch(kind: str, path: str, reason: str = "") -> None:
    """Count one lowering decision here and in the registry's
    ``rnn_dispatch_total{kind,path,reason}``."""
    rnn_dispatch_total[(kind, path, reason)] += 1
    counter(
        "rnn_dispatch_total",
        "RNN lowering decisions by tier (trace-time; reason labels "
        "match the one-time fallback warnings)",
    ).inc(kind=kind, path=path, reason=reason)


def _fallback_reason(b: int, h: int) -> str:
    """Why a default-activation (B, H) shape is off the fused tiers (the
    reference's label strings)."""
    if b % 8:
        return "batch not a multiple of 8 (sublane tiling)"
    if h % 128:
        return "hidden not a multiple of 128 (lane tiling)"
    if h > 512 and not FLAGS.get("fused_rnn_hblock"):
        return ("hidden>512 with the blocked tier disabled "
                "(--fused_rnn_hblock=false)")
    return ("hidden>512 and past even the blocked tier's "
            "streamed-VMEM budget")


def _warn_scan_fallback(kind: str, b: int, h: int) -> str:
    """One-time warning per (kind, B, H) when a default-activation
    sequence takes the scan; returns the reason label."""
    reason = _fallback_reason(b, h)
    warn_once(f"fused_{kind}_fallback:{b}x{h}",
              "fused_%s_fallback: scan path taken for batch=%d hidden=%d "
              "(%s)", kind, b, h, reason, logger=_log)
    return reason


def _dispatch(kind: str, b: int, h: int, default_acts: bool
              ) -> Optional[str]:
    """The path of one ``lstm_sequence`` / ``gru_sequence`` call: the
    fused tier by :func:`dispatch_tier`, or ``None`` for the scan; the
    decision is counted in :data:`rnn_dispatch_total`."""
    if not default_acts:
        _record_dispatch(kind, "scan", "non-default activations")
        return None
    tier = dispatch_tier(b, h, 3 if kind == "gru" else 4)
    if tier is None:
        _record_dispatch(kind, "scan", _warn_scan_fallback(kind, b, h))
    else:
        _record_dispatch(kind, tier)
    return tier


class LstmState(NamedTuple):
    h: torch.Tensor
    c: torch.Tensor


def lstm_gate_step(xw: torch.Tensor, state: LstmState,
                   w_hh: torch.Tensor,
                   check_i: Optional[torch.Tensor] = None,
                   check_f: Optional[torch.Tensor] = None,
                   check_o: Optional[torch.Tensor] = None,
                   gate_act: str = "sigmoid", cell_act: str = "tanh",
                   out_act: str = "tanh") -> Tuple[LstmState, torch.Tensor]:
    """One LSTM step.  xw: [B, 4H] pre-projected input (gate order i, f,
    c, o); returns (new_state, h).  The recurrent product runs in the
    policy compute dtype and is cast to xw's dtype; ``w_hh=None`` skips
    it (``LstmStepLayer``: the input already holds every
    contribution)."""
    if w_hh is None:
        gates = xw
    else:
        cd = current_policy().compute_dtype
        gates = xw + (state.h.to(cd) @ w_hh.to(cd)).to(xw.dtype)
    i, f, c_in, o = torch.chunk(gates, 4, dim=-1)
    ga = get_activation(gate_act)
    ca = get_activation(cell_act)
    oa = get_activation(out_act)
    if check_i is not None:
        i = i + state.c * check_i.to(xw.dtype)
        f = f + state.c * check_f.to(xw.dtype)
    i = ga(i)
    f = ga(f)
    c = f * state.c + i * ca(c_in)
    if check_o is not None:
        o = o + c * check_o.to(xw.dtype)
    o = ga(o)
    h = o * oa(c)
    return LstmState(h=h, c=c), h


def lstm_scan(xw, mask, w_hh, check_i=None, check_f=None, check_o=None,
              h0=None, c0=None, gate_act: str = "sigmoid",
              cell_act: str = "tanh", out_act: str = "tanh"):
    """The per-step loop, with the contract of
    :func:`~paddle_tpu_torch.ops.lstm.lstm_fused_sequence`: xw
    ``[B, T, 4H]``, mask ``[B, T]`` → (y, cy ``[B, T, H]`` masked,
    final_h, final_c).  It is the plain version of the fused kernels;
    autograd through it is the plain backward."""
    b, t, hd4 = xw.shape
    hd = hd4 // 4
    carry = current_policy().output_dtype
    state = LstmState(
        h=xw.new_zeros((b, hd), dtype=carry) if h0 is None else h0.to(carry),
        c=xw.new_zeros((b, hd), dtype=carry) if c0 is None else c0.to(carry))
    ys, cys = [], []
    for s in range(t):
        new, h = lstm_gate_step(xw[:, s], state, w_hh, check_i, check_f,
                                check_o, gate_act, cell_act, out_act)
        m = mask[:, s, None]
        state = LstmState(h=m * new.h + (1 - m) * state.h,
                          c=m * new.c + (1 - m) * state.c)
        ys.append(m * h)
        cys.append(m * new.c)
    return torch.stack(ys, 1), torch.stack(cys, 1), state.h, state.c


@register_op("lstm")
def lstm_sequence(seq: SequenceBatch, w_ih, w_hh, bias=None,
                  check_i=None, check_f=None, check_o=None,
                  h0=None, c0=None, reverse: bool = False,
                  gate_act: str = "sigmoid", cell_act: str = "tanh",
                  out_act: str = "tanh", return_cells: bool = False):
    """Run an LSTM over a padded sequence batch.

    seq.data: [B, T, D]; w_ih: [D, 4H] (``None``: the input is already
    projected to 4H, the lstmemory convention); w_hh: [H, 4H]; bias:
    [4H].  Returns (hidden SequenceBatch [B, T, H], final LstmState),
    plus the per-step cell SequenceBatch when ``return_cells``.

    The path is the reference's (:func:`dispatch_tier`): its fused
    shapes run the fused kernels (on the CPU their plain versions), the
    single-block tier for H <= 512 and the hidden-blocked tier above; on
    a CUDA tensor whose shape the Hopper tier does not serve this raises
    (``ops.lstm.fused_tier``) — it never loops quietly on the card.
    Every other shape and every non-default activation takes
    :func:`lstm_scan`, as the reference takes its scan.
    """
    b, t, _ = seq.data.shape
    hd = w_hh.shape[0]
    pol = current_policy()
    record_op_precision("lstm")
    cd = pol.compute_dtype
    xw = seq.data.to(cd) if w_ih is None else \
        (seq.data.reshape(b * t, -1).to(cd) @ w_ih.to(cd)).reshape(
            b, t, 4 * hd)
    if bias is not None:
        xw = xw + bias.to(cd)
    mask = seq.mask(xw.dtype)
    if reverse:
        xw = torch.flip(xw, (1,))
        mask = torch.flip(mask, (1,))
    tier = _dispatch("lstm", b, hd, gate_act == "sigmoid"
                     and cell_act == "tanh" and out_act == "tanh")
    if tier is not None:
        fn = lstm_fused_sequence_blocked if tier == "fused_blocked" \
            else lstm_fused_sequence
        y, cy, fh, fc = fn(xw.contiguous(), mask, w_hh, check_i, check_f,
                           check_o, h0, c0)
    else:
        y, cy, fh, fc = lstm_scan(xw, mask, w_hh, check_i, check_f, check_o,
                                  h0, c0, gate_act, cell_act, out_act)

    def pack(arr):
        arr = arr.to(pol.output_dtype)
        if reverse:
            arr = torch.flip(arr, (1,))
        return SequenceBatch(data=arr, length=seq.length)

    final = LstmState(h=fh.to(pol.output_dtype), c=fc.to(pol.output_dtype))
    if return_cells:
        return pack(y), final, pack(cy)
    return pack(y), final


def gru_scan(xw, mask, w_gates, w_cand, h0=None, gate_act: str = "sigmoid",
             act: str = "tanh") -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-step loop of ``recurrent_ops.gru_sequence``'s scan, with
    the contract of :func:`~paddle_tpu_torch.ops.gru.gru_fused_sequence`:
    xw ``[B, T, 3H]``, mask ``[B, T]`` → (y ``[B, T, H]`` masked, final
    kept state).  The products run in the policy compute dtype and the
    carry in the output dtype.  It is the plain version of the fused
    kernels; autograd through it is the plain backward."""
    b, t, hd3 = xw.shape
    cd = current_policy().compute_dtype
    carry = current_policy().output_dtype
    wg, wc = w_gates.to(cd), w_cand.to(cd)
    ga, ca = get_activation(gate_act), get_activation(act)
    h = xw.new_zeros((b, hd3 // 3), dtype=carry) if h0 is None \
        else h0.to(carry)
    ys = []
    for s in range(t):
        x = xw[:, s]
        xu, xr, xc = torch.chunk(x, 3, dim=-1)
        hu, hr = torch.chunk((h.to(cd) @ wg).to(x.dtype), 2, dim=-1)
        u = ga(xu + hu)
        r = ga(xr + hr)
        c = ca(xc + ((r * h).to(cd) @ wc).to(x.dtype))
        # reference GruCompute: h_new = u * h_prev + (1 - u) * c
        h_new = u * h + (1.0 - u) * c
        m = mask[:, s, None]
        h = m * h_new + (1 - m) * h
        ys.append(m * h_new)
    return torch.stack(ys, 1), h


@register_op("gru")
def gru_sequence(seq: SequenceBatch, w_ih, w_hh, bias=None, h0=None,
                 reverse: bool = False, gate_act: str = "sigmoid",
                 act: str = "tanh") -> Tuple[SequenceBatch, torch.Tensor]:
    """GRU over a padded batch (reference ``GruCompute``): w_ih ``[D,
    3H]`` (``None``: the input is already projected to 3H, the grumemory
    convention), w_hh ``[H, 3H]`` packing w_gates ``[H, 2H]`` (u | r) and
    w_cand ``[H, H]``, bias ``[3H]``.  Returns (hidden SequenceBatch
    ``[B, T, H]``, final state ``[B, H]``) in the policy output dtype.

    The path is the reference's (:func:`dispatch_tier` with three
    gates): its fused shapes run the fused kernels (on the CPU their
    plain versions), the single-block tier (kernels 13-14) for H <= 512
    and the hidden-blocked tier (kernels 15-17) above; on a CUDA tensor
    whose shape the Hopper tier does not serve this raises
    (``ops.gru.fused_tier``) — it never loops quietly on the card.
    Every other shape and every non-default activation takes
    :func:`gru_scan`, as the JAX package takes its scan."""
    b, t, _ = seq.data.shape
    hd = w_hh.shape[0]
    pol = current_policy()
    record_op_precision("gru")
    cd = pol.compute_dtype
    xw = seq.data.to(cd) if w_ih is None else \
        (seq.data.reshape(b * t, -1).to(cd) @ w_ih.to(cd)).reshape(
            b, t, 3 * hd)
    if bias is not None:
        xw = xw + bias.to(cd)
    mask = seq.mask(xw.dtype)
    if reverse:
        xw = torch.flip(xw, (1,))
        mask = torch.flip(mask, (1,))
    w_gates, w_cand = w_hh[:, :2 * hd], w_hh[:, 2 * hd:]
    tier = _dispatch("gru", b, hd, gate_act == "sigmoid" and act == "tanh")
    if tier is not None:
        fn = gru.gru_fused_sequence_blocked if tier == "fused_blocked" \
            else gru.gru_fused_sequence
        y, fh = fn(xw.contiguous(), mask, w_gates, w_cand, h0)
    else:
        y, fh = gru_scan(xw, mask, w_gates, w_cand, h0, gate_act, act)
    y = y.to(pol.output_dtype)
    if reverse:
        y = torch.flip(y, (1,))
    return SequenceBatch(data=y, length=seq.length), fh.to(pol.output_dtype)


@register_op("recurrent")
def simple_rnn(seq: SequenceBatch, w_hh, bias=None, h0=None,
               reverse: bool = False, act: str = "tanh"
               ) -> Tuple[SequenceBatch, torch.Tensor]:
    """The plain recurrent layer's op (``RecurrentLayer``): the input is
    already projected; h_t = act(x_t + h_{t-1} W + b) over ``[B, T, H]``
    with the length mask (a padded step keeps the carry, its output row
    is 0).  The input and the product in the policy compute dtype, the
    carry and the sum in the output dtype.  Returns (hidden
    SequenceBatch, final state ``[B, H]``)."""
    b, t, hd = seq.data.shape
    pol = current_policy()
    record_op_precision("recurrent")
    cd, carry = pol.compute_dtype, pol.output_dtype
    x = seq.data.to(cd)
    if bias is not None:
        x = x + bias.to(cd)
    mask = seq.mask(x.dtype)
    if reverse:
        x = torch.flip(x, (1,))
        mask = torch.flip(mask, (1,))
    a = get_activation(act)
    w = w_hh.to(cd)
    h = x.new_zeros((b, hd), dtype=carry) if h0 is None else h0.to(carry)
    ys = []
    for s in range(t):
        h_new = a(x[:, s].to(carry) + (h.to(cd) @ w).to(carry))
        m = mask[:, s, None]
        h = m * h_new + (1 - m) * h
        ys.append(m * h_new)
    hs = torch.stack(ys, 1).to(pol.output_dtype) if t else \
        x.new_zeros((b, 0, hd), dtype=pol.output_dtype)
    if reverse:
        hs = torch.flip(hs, (1,))
    return SequenceBatch(data=hs, length=seq.length), h.to(pol.output_dtype)


@register_op("lstm_unit", n_outputs=2)
def lstm_unit(x_proj, c_prev, forget_bias: float = 0.0):
    """Stateless LSTM cell math (``lstm_unit_op.cc``): ``x_proj`` ``[B,
    4H]`` already holds W x + W h, **gate order (i, f, o, j)** (not
    :func:`lstm_gate_step`'s (i, f, c, o)); returns (c, h)."""
    i, f, o, j = torch.chunk(x_proj, 4, dim=-1)
    c = sigmoid(f + forget_bias) * c_prev + sigmoid(i) * torch.tanh(j)
    return c, sigmoid(o) * torch.tanh(c)


@register_op("gru_unit", n_outputs=1)
def gru_unit(x_proj, h_prev, w_hh, gate_act: str = "sigmoid",
             act: str = "tanh") -> torch.Tensor:
    """Single GRU step given the pre-projected input ``[B, 3H]``
    (``gru_unit_op``); the products under the precision policy."""
    hd = h_prev.shape[-1]
    xu, xr, xc = torch.chunk(x_proj, 3, dim=-1)
    hu, hr = torch.chunk(matmul(h_prev, w_hh[:, :2 * hd]), 2, dim=-1)
    ga, ca = get_activation(gate_act), get_activation(act)
    u = ga(xu + hu)
    r = ga(xr + hr)
    c = ca(xc + matmul(r * h_prev, w_hh[:, 2 * hd:]))
    return u * h_prev + (1.0 - u) * c
