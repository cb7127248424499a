"""Linear-chain CRF and CTC ops (counterpart of
``paddle_tpu/ops/crf_ops.py``): the CRF's negative log-likelihood and
its Viterbi decoding (``LinearChainCRF``, ``CRFLayer``,
``CRFDecodingLayer``), and the CTC loss (``WarpCTCLayer`` /
``CTCLayer``).

Each is a loop over time on the padded layout in log space, in fp32
whatever the policy, as the JAX ops' ``lax.scan`` loops are; neither
package has a kernel for them.  The CRF weight is the reference's
``[N+2, N]``: row 0 the start scores, row 1 the end scores, rows 2.. the
transitions ``[from, to]``.

The JAX CTC calls ``optax.ctc_loss``; :func:`ctc_loss` is the same
log-semiring program (blank and repeated-label transitions, optax's
``log_epsilon`` = −1e5 for log 0), so an impossible alignment gives
the same large finite loss and the same gradient.  ``F.ctc_loss`` is
not it: it returns inf there (0 under ``zero_infinity``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.sequence import SequenceBatch
from .registry import register_op

#: optax's stand-in for log(0)
LOG_EPSILON = -1e5


def _split_w(w: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return w[0], w[1], w[2:]


@register_op("linear_chain_crf")
def crf_nll(emissions: SequenceBatch, labels: SequenceBatch,
            w: torch.Tensor) -> torch.Tensor:
    """Negative log-likelihood of each sequence ``[B]``
    (``CRFLayer::forward``): emissions ``[B, T, N]`` unnormalised,
    labels ``[B, T]`` int (a shorter label buffer is padded with 0), w
    ``[N+2, N]``.  Step 0 enters every row, an empty one too (as in the
    JAX op); later steps past a row's length keep its state."""
    a, b, trans = _split_w(w)
    x = emissions.data.to(torch.float32)
    ids = labels.data.to(torch.int64)
    mask = emissions.mask(torch.float32)
    t = x.shape[1]
    ids = F.pad(ids, (0, t - ids.shape[1])) if ids.shape[1] < t \
        else ids[:, :t]
    # the log partition: the forward algorithm
    alpha = a[None, :] + x[:, 0]
    for s in range(1, t):
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + x[:, s]
        m = mask[:, s, None]
        alpha = m * new + (1 - m) * alpha
    logz = torch.logsumexp(alpha + b[None, :], dim=-1)
    # the gold path's score
    prev = ids[:, 0]
    gold = a[prev] + torch.gather(x[:, 0], 1, ids[:, :1])[:, 0]
    for s in range(1, t):
        y, m = ids[:, s], mask[:, s]
        emit = torch.gather(x[:, s], 1, y[:, None])[:, 0]
        gold = gold + m * (emit + trans[prev, y])
        prev = torch.where(m > 0, y, prev)
    return logz - (gold + b[prev])


@register_op("crf_decoding")
def crf_decode(emissions: SequenceBatch, w: torch.Tensor) -> SequenceBatch:
    """Viterbi decoding (``CRFDecodingLayer``) → the best tags ``[B, T]``
    int32 with the emissions' lengths.  Ties go to the first index, as
    ``jnp.argmax``'s do; a step past a row's length keeps its
    scores and points back to the same tag."""
    a, b, trans = _split_w(w)
    x = emissions.data.to(torch.float32)
    mask = emissions.mask(torch.float32)
    bsz, t, n = x.shape
    ident = torch.arange(n, device=x.device).expand(bsz, n)
    alpha = a[None, :] + x[:, 0]
    back = []
    for s in range(1, t):
        scores = alpha[:, :, None] + trans[None]
        new = torch.amax(scores, dim=1) + x[:, s]
        m = mask[:, s, None]
        alpha = m * new + (1 - m) * alpha
        back.append(torch.where(m > 0, torch.argmax(scores, dim=1), ident))
    tag = torch.argmax(alpha + b[None, :], dim=-1)
    tags = [tag]
    for bp in reversed(back):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        tags.append(tag)
    return SequenceBatch(data=torch.stack(tags[::-1], 1).to(torch.int32),
                         length=emissions.length)


class _LogAddExp(torch.autograd.Function):
    """``torch.logaddexp`` with ``jnp.logaddexp``'s gradient rule, dx =
    g · exp(x − out): near log 0 (−1e5, where a float32's step is 2^-7)
    the rule decides the rounding, and an impossible alignment's
    gradient is made of such terms."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def _add_phi(phi: torch.Tensor, added: torch.Tensor) -> torch.Tensor:
    """``phi[:, 1:]`` plus ``added`` in log space (optax's
    ``update_phi_score``)."""
    return torch.cat([phi[:, :1], _LogAddExp.apply(phi[:, 1:], added)], -1)


@register_op("warpctc", "ctc")
def ctc_loss(logits: SequenceBatch, labels: SequenceBatch, blank: int = 0,
             norm_by_times: bool = False) -> torch.Tensor:
    """CTC loss of each sequence ``[B]`` (``WarpCTCLayer`` / ``CTCLayer``):
    logits ``[B, T, C]`` unnormalised (``log_softmax`` inside), labels
    ``[B, L]`` int; ``norm_by_times`` divides by max(T_b, 1).

    optax's program (``ctc_loss_with_forward_probs``): the blank-state
    and label-state log-alphas over the L + 1 / L label positions, a
    padded frame keeping both, log 0 as :data:`LOG_EPSILON`, a repeated
    label (``labels[n] == labels[n + 1]``, padding included) taking the
    way through a blank only."""
    x = logits.data.to(torch.float32)
    ids = labels.data.to(torch.int64)
    bsz, t, k = x.shape
    n_lab = ids.shape[1]
    logit_pad = 1.0 - logits.mask(torch.float32)
    label_lens = labels.mask(torch.float32).sum(1).to(torch.int64)
    eps = LOG_EPSILON
    logp = torch.log_softmax(x, dim=-1)
    repeat = F.pad((ids[:, :-1] == ids[:, 1:]).to(torch.float32), (0, 1))
    # each label's log-probability at each frame (an id outside [0, C)
    # emits log 1, as optax's one-hot product gives)
    inside = (ids >= 0) & (ids < k)
    emit = torch.gather(logp, 2, ids.clamp(0, k - 1)[:, None, :].expand(
        bsz, t, n_lab))
    emit = torch.where(inside[:, None, :], emit,
                       torch.zeros((), device=x.device))
    phi = torch.full((bsz, n_lab + 1), eps, device=x.device)
    phi[:, 0] = 0.0
    em = torch.full((bsz, n_lab), eps, device=x.device)
    for s in range(t):
        p_emit, p_blank = emit[:, s], logp[:, s, blank, None]
        # label to blank, except towards a repetition
        through = _add_phi(phi, em + eps * repeat)
        next_em = _LogAddExp.apply(through[:, :-1] + p_emit, em + p_emit)
        # the blank's self-loop, and label to blank only before a
        # repetition
        next_phi = _add_phi(through + p_blank,
                            em + p_blank + eps * (1.0 - repeat))
        pad = logit_pad[:, s, None]
        em = pad * em + (1.0 - pad) * next_em
        phi = pad * phi + (1.0 - pad) * next_phi
    last = _add_phi(phi, em)
    per_seq = -torch.gather(last, 1, label_lens[:, None])[:, 0]
    if norm_by_times:
        per_seq = per_seq / torch.clamp(logits.length.to(torch.float32),
                                        min=1.0)
    return per_seq
