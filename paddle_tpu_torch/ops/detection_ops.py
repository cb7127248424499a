"""SSD detection ops (counterpart of ``paddle_tpu/ops/detection_ops.py``):
prior boxes, IoU, box encoding, prior matching, the multibox loss and the
detection output.

Reference semantics: ``paddle/gserver/layers/DetectionUtil.cpp``
(``jaccardOverlap``, ``encodeBBoxWithVar``, ``decodeBBoxWithVar``,
``matchBBox``, ``getDetectionIndices``, ``getDetectionOutput``),
``PriorBox.cpp`` and ``MultiBoxLossLayer.cpp``.  Shapes are fixed as in
the JAX package: ground truth arrives as a padded ``[B, G, 6]`` tensor
with a count a row, matching is a G-step bipartite pass and a per-prior
pass, the mined negatives are a rank mask, and the output keeps
``keep_top_k`` rows an image with −1 rows where nothing is left.

Orders are the JAX package's: the argmaxes take the first of equal
values, the mining ranks by a stable sort (the −inf non-candidates in
index order), and the NMS candidates and the global top-k take
``lax.top_k``'s order (``math_ops.top_k``).  The JAX package runs NMS
one image and class at a time, a candidate a step; here the images and
classes are one batch and only the candidates are a loop: candidate i
is kept where its score is above the threshold and no kept j < i
overlaps it above ``nms_threshold``.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .math_ops import top_k
from .registry import register_op


# --------------------------------------------------------------- priors
def prior_boxes(layer_h: int, layer_w: int, img_h: int, img_w: int,
                min_sizes: Sequence[float], max_sizes: Sequence[float],
                aspect_ratios: Sequence[float],
                variances: Sequence[float]) -> np.ndarray:
    """``[num_priors, 8]`` (4 clipped corners, 4 variances) in
    ``PriorBoxLayer::forward``'s order: cell-major, then a cell's
    min-size box, its max-size boxes, its aspect-ratio boxes."""
    ratios = [1.0]
    for r in aspect_ratios:
        ratios += [r, 1.0 / r]
    step_w = img_w / layer_w
    step_h = img_h / layer_h
    rows: List[List[float]] = []

    def emit(cx, cy, bw, bh):
        rows.append([(cx - bw / 2.0) / img_w, (cy - bh / 2.0) / img_h,
                     (cx + bw / 2.0) / img_w, (cy + bh / 2.0) / img_h]
                    + list(variances))

    for h in range(layer_h):
        for w in range(layer_w):
            cx = (w + 0.5) * step_w
            cy = (h + 0.5) * step_h
            for mn in min_sizes:
                emit(cx, cy, mn, mn)
                # PriorBox.cpp:119 runs the whole max-size loop inside
                # each min-size step: every (min, max) pair emits a box
                for mx in max_sizes:
                    s = math.sqrt(mn * mx)
                    emit(cx, cy, s, s)
            mn = min_sizes[-1]
            for r in ratios:
                if abs(r - 1.0) < 1e-6:
                    continue
                emit(cx, cy, mn * math.sqrt(r), mn / math.sqrt(r))
    out = np.asarray(rows, np.float32)
    out[:, :4] = np.clip(out[:, :4], 0.0, 1.0)
    return out


def num_priors_per_cell(min_sizes, max_sizes, aspect_ratios) -> int:
    return (len(min_sizes) * (1 + len(max_sizes))
            + 2 * len(aspect_ratios))


# ------------------------------------------------------------- geometry
def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Jaccard overlap of every pair: a ``[..., P, 4]``, b ``[..., G,
    4]`` → ``[..., P, G]``."""
    ax1, ay1, ax2, ay2 = (a[..., i, None] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    ix1 = torch.maximum(ax1, bx1)
    iy1 = torch.maximum(ay1, by1)
    ix2 = torch.minimum(ax2, bx2)
    iy2 = torch.minimum(ay2, by2)
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    area_a = torch.clamp(ax2 - ax1, min=0) * torch.clamp(ay2 - ay1, min=0)
    area_b = torch.clamp(bx2 - bx1, min=0) * torch.clamp(by2 - by1, min=0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, 0.0)


def _center_form(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cy = (boxes[..., 1] + boxes[..., 3]) / 2.0
    return cx, cy, w, h


@register_op("encode_bbox")
def encode_boxes(priors: torch.Tensor, variances: torch.Tensor,
                 gt: torch.Tensor) -> torch.Tensor:
    """``encodeBBoxWithVar``: corner boxes → variance-scaled offsets."""
    pcx, pcy, pw, ph = _center_form(priors)
    gcx, gcy, gw, gh = _center_form(gt)
    pw = torch.clamp(pw, min=1e-8)
    ph = torch.clamp(ph, min=1e-8)
    return torch.stack([
        (gcx - pcx) / pw / variances[..., 0],
        (gcy - pcy) / ph / variances[..., 1],
        torch.log(torch.clamp(torch.abs(gw / pw), min=1e-8))
        / variances[..., 2],
        torch.log(torch.clamp(torch.abs(gh / ph), min=1e-8))
        / variances[..., 3]], dim=-1)


@register_op("decode_bbox")
def decode_boxes(priors: torch.Tensor, variances: torch.Tensor,
                 loc: torch.Tensor) -> torch.Tensor:
    """``decodeBBoxWithVar``: offsets → corner boxes."""
    pcx, pcy, pw, ph = _center_form(priors)
    cx = variances[..., 0] * loc[..., 0] * pw + pcx
    cy = variances[..., 1] * loc[..., 1] * ph + pcy
    w = torch.exp(variances[..., 2] * loc[..., 2]) * pw
    h = torch.exp(variances[..., 3] * loc[..., 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


# ------------------------------------------------------------- matching
def match_priors(prior_corners: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_valid: torch.Tensor, overlap_threshold: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``matchBBox`` for a batch: the bipartite pass (G steps, each the
    first largest overlap left claims its prior and retires its row and
    column), then the per-prior pass (an unmatched prior with overlap ≥
    ``overlap_threshold`` takes its best ground truth).

    prior_corners ``[P, 4]``; gt_boxes ``[B, G, 4]``; gt_valid ``[B, G]``
    bool → (match ``[B, P]`` int32, −1 unmatched; its best overlap
    ``[B, P]``)."""
    b, g = gt_boxes.shape[0], gt_boxes.shape[1]
    p = prior_corners.shape[0]
    ov = iou_matrix(prior_corners.expand(b, p, 4), gt_boxes)   # [B, P, G]
    ov = torch.where(gt_valid[:, None, :], ov, 0.0)
    match_overlap = ov.amax(dim=2)
    best_gt = torch.argmax(ov, dim=2).to(torch.int32)
    match = torch.full((b, p), -1, dtype=torch.int32, device=ov.device)
    p_ids = torch.arange(p, device=ov.device)
    g_ids = torch.arange(g, device=ov.device)
    ovc = ov
    for _ in range(g):
        flat = torch.argmax(ovc.reshape(b, p * g), dim=1)
        pi, gi = flat // g, flat % g
        valid = torch.gather(ovc.reshape(b, p * g), 1, flat[:, None]) > 1e-6
        row = (p_ids[None, :] == pi[:, None]) & valid          # [B, P]
        col = (g_ids[None, :] == gi[:, None]) & valid          # [B, G]
        match = torch.where(row, gi[:, None].to(torch.int32), match)
        # retire the claimed prior's row and the ground truth's column
        ovc = torch.where(row[:, :, None] | col[:, None, :], -1.0, ovc)
    take = (match < 0) & (match_overlap >= overlap_threshold)
    return torch.where(take, best_gt, match), match_overlap


def mine(conf: torch.Tensor, priors: torch.Tensor, gt: torch.Tensor,
         gt_count: torch.Tensor, overlap_threshold: float = 0.5,
         neg_overlap: float = 0.5, neg_pos_ratio: float = 3.0,
         background_id: int = 0):
    """The matching and hard-negative mining of :func:`multibox_loss`:
    (match ``[B, P]``, positives, mined negatives).  A negative is an
    unmatched prior of best overlap below ``neg_overlap``, ranked by its
    largest non-background probability; an image keeps
    min(⌊ratio · positives⌋, candidates) of them."""
    b, p, c = conf.shape
    g = gt.shape[1]
    gt_valid = torch.arange(g, device=gt.device)[None, :] < \
        gt_count.to(gt.device)[:, None]
    match, match_ov = match_priors(priors[:, :4], gt[..., 1:5], gt_valid,
                                   overlap_threshold)
    pos = match >= 0
    with torch.no_grad():
        probs = torch.softmax(conf.float(), dim=-1)
        if c > 1:
            probs[..., background_id] = 0.0
        mine_score = probs.amax(dim=-1)
        cand = ~pos & (match_ov < neg_overlap)
        n_cand = cand.sum(dim=1)
        n_neg = torch.minimum(
            (neg_pos_ratio * pos.sum(dim=1).to(torch.float32))
            .to(torch.int32), n_cand)
        scores = torch.where(cand, mine_score, -math.inf)
        order = torch.argsort(-scores, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        neg = cand & (rank < n_neg[:, None])
    return match, pos, neg


@register_op("multibox_loss")
def multibox_loss(conf: torch.Tensor, loc: torch.Tensor,
                  priors: torch.Tensor, gt: torch.Tensor,
                  gt_count: torch.Tensor, num_classes: int,
                  overlap_threshold: float = 0.5, neg_overlap: float = 0.5,
                  neg_pos_ratio: float = 3.0,
                  background_id: int = 0) -> torch.Tensor:
    """SSD loss (``MultiBoxLossLayer``): smooth-L1 on the matched priors'
    offsets plus softmax cross-entropy on the positives and the mined
    negatives, over the batch's match count; 0 when nothing matched.

    conf ``[B, P, C]``; loc ``[B, P, 4]``; priors ``[P, 8]``; gt ``[B, G,
    6]`` (class, xmin, ymin, xmax, ymax, difficult) padded; gt_count
    ``[B]``."""
    match, pos, neg = mine(conf, priors, gt, gt_count, overlap_threshold,
                           neg_overlap, neg_pos_ratio, background_id)
    num_pos = pos.sum()
    safe = torch.clamp(match, min=0).to(torch.int64)
    gt_for_prior = torch.gather(gt[..., 1:5], 1,
                                safe[..., None].expand(*safe.shape, 4))
    target = encode_boxes(priors[None, :, :4], priors[None, :, 4:],
                          gt_for_prior)
    diff = torch.abs(loc.float() - target)
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    loc_loss = torch.sum(torch.where(pos[..., None], sl1, 0.0))
    logp = torch.log_softmax(conf.float(), dim=-1)
    cls_for_prior = torch.gather(gt[..., 0].to(torch.int64), 1, safe)
    pos_ce = -torch.gather(logp, -1, cls_for_prior[..., None])[..., 0]
    neg_ce = -logp[..., background_id]
    conf_loss = torch.sum(torch.where(pos, pos_ce, 0.0)) \
        + torch.sum(torch.where(neg, neg_ce, 0.0))
    total = (loc_loss + conf_loss) / torch.clamp(num_pos, min=1).float()
    return torch.where(num_pos > 0, total, 0.0)


# ----------------------------------------------------------------- NMS
def _nms(boxes: torch.Tensor, scores: torch.Tensor, top_k_: int,
         conf_threshold: float, nms_threshold: float):
    """``applyNMSFast`` over a batch of rows: boxes ``[B, P, 4]``, scores
    ``[B, K, P]`` (a row an image and class) → (keep ``[B, K, k]``, the
    candidates' scores ``[B, K, k]`` and boxes ``[B, K, k, 4]``)."""
    k = min(top_k_, scores.shape[-1])
    top_scores, top_idx = top_k(scores, k)
    b, kc = scores.shape[0], scores.shape[1]
    cand = torch.gather(boxes[:, None].expand(b, kc, *boxes.shape[1:]), 2,
                        top_idx.to(torch.int64)[..., None]
                        .expand(b, kc, k, 4))
    with torch.no_grad():
        over = iou_matrix(cand, cand) > nms_threshold          # [B,K,k,k]
        above = top_scores > conf_threshold
        keep = torch.zeros_like(above)
        for i in range(k):
            sup = torch.any(keep[..., :i] & over[..., i, :i], dim=-1)
            keep[..., i] = above[..., i] & ~sup
    return keep, top_scores, cand


@register_op("detection_output")
def detection_output(conf: torch.Tensor, loc: torch.Tensor,
                     priors: torch.Tensor, num_classes: int,
                     background_id: int = 0, conf_threshold: float = 0.01,
                     nms_top_k: int = 400, nms_threshold: float = 0.45,
                     keep_top_k: int = 200) -> torch.Tensor:
    """``DetectionOutputLayer``: decode, per-class NMS, the global top
    ``keep_top_k`` an image → ``[B, keep_top_k, 7]`` rows (image, class,
    score, xmin, ymin, xmax, ymax), −1 rows where nothing is left."""
    b = conf.shape[0]
    probs = torch.softmax(conf.float(), dim=-1)
    boxes = decode_boxes(priors[:, :4], priors[:, 4:], loc)       # [B,P,4]
    classes = [c for c in range(num_classes) if c != background_id]
    scores = probs[..., classes].transpose(1, 2)                  # [B,K,P]
    keep, top_scores, cand = _nms(boxes, scores, nms_top_k,
                                  conf_threshold, nms_threshold)
    kc, k = keep.shape[1], keep.shape[2]
    sc = torch.where(keep, top_scores, -math.inf)
    dev = conf.device
    rows = torch.cat([
        torch.arange(b, dtype=torch.float32, device=dev)
        .reshape(b, 1, 1, 1).expand(b, kc, k, 1),
        torch.tensor(classes, dtype=torch.float32, device=dev)
        .reshape(1, kc, 1, 1).expand(b, kc, k, 1),
        sc[..., None], torch.clamp(cand, 0.0, 1.0)], dim=-1)
    sc, rows = sc.reshape(b, kc * k), rows.reshape(b, kc * k, 7)
    kk = min(keep_top_k, kc * k)
    top_sc, top_i = top_k(sc, kk)
    out = torch.gather(rows, 1, top_i.to(torch.int64)[..., None]
                       .expand(b, kk, 7))
    out = torch.where(torch.isfinite(top_sc)[..., None], out, -1.0)
    if kk < keep_top_k:
        out = torch.cat([out, out.new_full((b, keep_top_k - kk, 7), -1.0)],
                        dim=1)
    return out
