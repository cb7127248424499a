"""LSTM over padded sequences (counterpart of
``paddle_tpu/ops/recurrent_ops.py``, its LSTM part).

The input projection for all timesteps is one product outside the time
loop; the recurrence runs either in the fused kernels of
:mod:`paddle_tpu_torch.ops.lstm` (default activations: the single-block
tier for H <= 512, the hidden-blocked tier above) or in the per-step
loop :func:`lstm_scan` (other activations, or ``--fused_rnn_hblock=false``
for H > 512).  Padding keeps the state unchanged through masked steps.
Peephole ("check") weights follow the reference LSTM.

Precision, as in the JAX package: the input projection and the gate
bias are in the policy compute dtype; the fused kernels compute in fp32
whatever the policy; outputs and final states come back in the policy
output dtype.  The scan carries its state in the output dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.dtypes import current_policy
from ..core.sequence import SequenceBatch
from ..utils import FLAGS
from .activations import get_activation
from .lstm import (MAX_HIDDEN, lstm_fused_sequence,
                   lstm_fused_sequence_blocked)


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
    policy compute dtype and is cast to xw's dtype."""
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

    Default activations run the fused kernels (on the CPU their plain
    versions): the single-block tier for H <= 512, the hidden-blocked
    tier above.  On a CUDA tensor whose shape the tier does not serve
    this raises (``ops.lstm.fused_tier``) — it never loops quietly on
    the card.  Other activations take :func:`lstm_scan`, as the
    reference takes its scan, and so does H > 512 under
    ``--fused_rnn_hblock=false`` (the JAX package's kill switch).
    """
    b, t, _ = seq.data.shape
    hd = w_hh.shape[0]
    pol = current_policy()
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
    fused = gate_act == "sigmoid" and cell_act == "tanh" \
        and out_act == "tanh" \
        and (hd <= MAX_HIDDEN or FLAGS.get("fused_rnn_hblock"))
    if fused:
        fn = lstm_fused_sequence if hd <= MAX_HIDDEN \
            else lstm_fused_sequence_blocked
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
