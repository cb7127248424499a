"""Streaming evaluators (counterpart of
``paddle_tpu/evaluators/evaluators.py``).

Reference: ``paddle/gserver/evaluators/Evaluator.h:42`` — start/eval/finish
lifecycle with values accumulated across batches.  The 16 registered
names match the reference: classification_error, sum, column_sum,
precision_recall, auc, rankauc, pnpair, chunk (IOB/IOE),
ctc_edit_distance, detection_map and the six printers.

The statistics are the JAX package's, line for line: numpy on the host
(Python floats and float64 sums), so the same outputs give the same
values.  ``eval_batch`` takes CUDA or CPU tensors or SequenceBatches of
either; ``Trainer.test`` moves each batch's outputs and labels to the
host once and hands the host copies to every evaluator.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

import torch

from ..core.sequence import SequenceBatch, value_of
from ..utils.registry import Registry

EVALUATORS: Registry = Registry("evaluator")


def _host(x) -> np.ndarray:
    """A tensor's values as a numpy array on the host (bfloat16 widened
    to float32, exactly); anything else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Evaluator:
    name = "evaluator"

    def __init__(self, **kwargs):
        self.kw = kwargs
        self.start()

    def start(self) -> None:
        raise NotImplementedError

    def eval_batch(self, output, label, weight=None) -> None:
        raise NotImplementedError

    def get_value(self) -> Dict[str, float]:
        raise NotImplementedError

    def finish(self) -> Dict[str, float]:
        return self.get_value()

    @staticmethod
    def _to_np(x):
        """``(data, mask or None)`` as host numpy arrays from a CUDA or
        CPU tensor, a SequenceBatch of either, or an array."""
        if isinstance(x, SequenceBatch):
            return _host(x.data), _host(x.mask())
        return _host(value_of(x)), None


@EVALUATORS.register("classification_error")
class ClassificationErrorEvaluator(Evaluator):
    def start(self):
        self.wrong = 0.0
        self.total = 0.0

    def eval_batch(self, output, label, weight=None):
        out, mask = self._to_np(output)
        lab, _ = self._to_np(label)
        if out.ndim == 3:  # sequence: flatten valid steps
            pred = out.argmax(-1)
            valid = mask > 0
            self.wrong += ((pred != lab[..., : pred.shape[1]]) & valid).sum()
            self.total += valid.sum()
        else:
            pred = out.argmax(-1)
            w = np.ones_like(pred, np.float64) if weight is None \
                else _host(weight).reshape(-1)
            self.wrong += (w * (pred != lab.reshape(-1))).sum()
            self.total += w.sum()

    def get_value(self):
        return {"classification_error":
                float(self.wrong / max(self.total, 1.0))}


@EVALUATORS.register("sum")
class SumEvaluator(Evaluator):
    def start(self):
        self.sum = 0.0
        self.n = 0

    def eval_batch(self, output, label=None, weight=None):
        out, mask = self._to_np(output)
        if mask is not None:
            m = mask.reshape(mask.shape + (1,) * (out.ndim - 2))
            self.sum += (out * m).sum()
            self.n += int(mask.sum())
        else:
            self.sum += out.sum()
            self.n += out.shape[0]

    def get_value(self):
        return {"sum": float(self.sum), "mean": float(self.sum / max(self.n, 1))}


@EVALUATORS.register("column_sum")
class ColumnSumEvaluator(Evaluator):
    def start(self):
        self.sum = None
        self.n = 0

    def eval_batch(self, output, label=None, weight=None):
        out, _ = self._to_np(output)
        s = out.reshape(-1, out.shape[-1]).sum(0)
        self.sum = s if self.sum is None else self.sum + s
        self.n += out.reshape(-1, out.shape[-1]).shape[0]

    def get_value(self):
        if self.sum is None:
            return {"column_sum": []}
        return {"column_sum": (self.sum / max(self.n, 1)).tolist()}


@EVALUATORS.register("precision_recall")
class PrecisionRecallEvaluator(Evaluator):
    """Per-class (or binary w/ positive label) precision/recall/F1."""

    def start(self):
        self.tp = {}
        self.fp = {}
        self.fn = {}

    def eval_batch(self, output, label, weight=None):
        out, _ = self._to_np(output)
        lab, _ = self._to_np(label)
        pred = out.argmax(-1).reshape(-1)
        lab = lab.reshape(-1)[: pred.size]
        for p, l in zip(pred, lab):
            p, l = int(p), int(l)
            if p == l:
                self.tp[p] = self.tp.get(p, 0) + 1
            else:
                self.fp[p] = self.fp.get(p, 0) + 1
                self.fn[l] = self.fn.get(l, 0) + 1

    def get_value(self):
        classes = set(self.tp) | set(self.fp) | set(self.fn)
        precs, recs = [], []
        for c in classes:
            tp, fp, fn = self.tp.get(c, 0), self.fp.get(c, 0), self.fn.get(c, 0)
            precs.append(tp / max(tp + fp, 1))
            recs.append(tp / max(tp + fn, 1))
        p = float(np.mean(precs)) if precs else 0.0
        r = float(np.mean(recs)) if recs else 0.0
        f1 = 2 * p * r / max(p + r, 1e-12)
        return {"precision": p, "recall": r, "F1": f1}


@EVALUATORS.register("auc")
class AucEvaluator(Evaluator):
    """Binary AUC by rank statistic over accumulated scores."""

    def start(self):
        self.scores = []
        self.labels = []

    def eval_batch(self, output, label, weight=None):
        out, _ = self._to_np(output)
        lab, _ = self._to_np(label)
        score = out[:, -1] if out.ndim == 2 and out.shape[1] > 1 else out.reshape(-1)
        self.scores.append(score)
        self.labels.append(lab.reshape(-1)[: score.size])

    def get_value(self):
        if not self.scores:
            return {"auc": 0.5}
        s = np.concatenate(self.scores)
        y = np.concatenate(self.labels)
        order = np.argsort(s)
        ranks = np.empty_like(order, np.float64)
        ranks[order] = np.arange(1, len(s) + 1)
        npos = (y == 1).sum()
        nneg = (y == 0).sum()
        if npos == 0 or nneg == 0:
            return {"auc": 0.5}
        auc = (ranks[y == 1].sum() - npos * (npos + 1) / 2) / (npos * nneg)
        return {"auc": float(auc)}


@EVALUATORS.register("rankauc")
class RankAucEvaluator(AucEvaluator):
    def get_value(self):
        v = super().get_value()
        return {"rankauc": v["auc"]}


@EVALUATORS.register("pnpair")
class PnpairEvaluator(Evaluator):
    """Positive/negative pair ratio within query groups
    (``PnpairEvaluator``): inputs (score, label, query_id)."""

    def start(self):
        self.rows = []

    def eval_batch(self, output, label, weight=None, query_id=None):
        out, _ = self._to_np(output)
        lab, _ = self._to_np(label)
        qid = np.zeros(out.shape[0]) if query_id is None else \
            _host(value_of(query_id)).reshape(-1)
        for s, l, q in zip(out.reshape(-1), lab.reshape(-1), qid):
            self.rows.append((q, l, s))

    def get_value(self):
        from collections import defaultdict

        groups = defaultdict(list)
        for q, l, s in self.rows:
            groups[q].append((l, s))
        pos, neg = 0.0, 0.0
        for items in groups.values():
            for i in range(len(items)):
                for j in range(i + 1, len(items)):
                    (l1, s1), (l2, s2) = items[i], items[j]
                    if l1 == l2:
                        continue
                    better = (s1 > s2) == (l1 > l2)
                    if s1 == s2:
                        pos += 0.5
                        neg += 0.5
                    elif better:
                        pos += 1
                    else:
                        neg += 1
        return {"pnpair": float(pos / max(neg, 1e-12)),
                "pairs": pos + neg}


@EVALUATORS.register("chunk")
class ChunkEvaluator(Evaluator):
    """Chunk F1 for sequence labeling with IOB/IOE schemes
    (``ChunkEvaluator.cpp``)."""

    def start(self):
        self.correct = 0
        self.output_chunks = 0
        self.label_chunks = 0

    def _extract(self, tags, scheme, num_chunk_types):
        chunks = []
        start = None
        cur_type = None
        for i, t in enumerate(list(tags) + [-1]):
            if scheme == "IOB":
                # tag = chunk_type * 2 + {0: B, 1: I}; last id = O
                if t == -1 or t == num_chunk_types * 2:
                    tag_type, pos = None, None
                else:
                    tag_type, pos = divmod(int(t), 2)
                if start is not None and (
                        pos == 0 or tag_type != cur_type or pos is None):
                    chunks.append((start, i - 1, cur_type))
                    start = None
                if pos == 0:
                    start, cur_type = i, tag_type
                elif pos == 1 and start is None:
                    start, cur_type = i, tag_type
            else:  # IOE
                if t == -1 or t == num_chunk_types * 2:
                    tag_type, pos = None, None
                else:
                    tag_type, pos = divmod(int(t), 2)
                if start is None and pos is not None:
                    start, cur_type = i, tag_type
                if start is not None and (pos is None or tag_type != cur_type):
                    chunks.append((start, i - 1, cur_type))
                    start = None
                elif start is not None and pos == 1:  # E ends chunk
                    chunks.append((start, i, cur_type))
                    start = None
        return set(chunks)

    def eval_batch(self, output, label, weight=None):
        scheme = self.kw.get("chunk_scheme", "IOB")
        nct = self.kw.get("num_chunk_types", 1)
        out, mask = self._to_np(output)
        lab, _ = self._to_np(label)
        pred = out.argmax(-1) if out.ndim == 3 else out
        for b in range(pred.shape[0]):
            n = int(mask[b].sum()) if mask is not None else pred.shape[1]
            pc = self._extract(pred[b, :n], scheme, nct)
            lc = self._extract(lab[b, :n], scheme, nct)
            self.correct += len(pc & lc)
            self.output_chunks += len(pc)
            self.label_chunks += len(lc)

    def get_value(self):
        p = self.correct / max(self.output_chunks, 1)
        r = self.correct / max(self.label_chunks, 1)
        return {"precision": p, "recall": r,
                "F1-score": 2 * p * r / max(p + r, 1e-12)}


@EVALUATORS.register("ctc_edit_distance")
class CTCErrorEvaluator(Evaluator):
    """Sequence error via edit distance after CTC collapse
    (``CTCErrorEvaluator.cpp``)."""

    def start(self):
        self.total_dist = 0.0
        self.total_len = 0

    @staticmethod
    def _collapse(ids, blank=0):
        out = []
        prev = None
        for t in ids:
            if t != prev and t != blank:
                out.append(int(t))
            prev = t
        return out

    @staticmethod
    def _edit_distance(a, b):
        dp = np.arange(len(b) + 1, dtype=np.int64)
        for i in range(1, len(a) + 1):
            prev = dp.copy()
            dp[0] = i
            for j in range(1, len(b) + 1):
                dp[j] = min(prev[j] + 1, dp[j - 1] + 1,
                            prev[j - 1] + (a[i - 1] != b[j - 1]))
        return int(dp[-1])

    def eval_batch(self, output, label, weight=None):
        out, mask = self._to_np(output)
        lab_np, lab_mask = self._to_np(label)
        pred = out.argmax(-1)
        for b in range(pred.shape[0]):
            n = int(mask[b].sum()) if mask is not None else pred.shape[1]
            hyp = self._collapse(pred[b, :n])
            if lab_mask is not None:
                m = int(lab_mask[b].sum())
                ref = [int(x) for x in lab_np[b, :m]]
            else:
                ref = [int(x) for x in lab_np[b]]
            self.total_dist += self._edit_distance(hyp, ref)
            self.total_len += max(len(ref), 1)

    def get_value(self):
        return {"ctc_edit_distance":
                float(self.total_dist / max(self.total_len, 1))}


def create_evaluator(name: str, **kwargs) -> Evaluator:
    return EVALUATORS.create(name, **kwargs)


@EVALUATORS.register("detection_map")
class DetectionMAPEvaluator(Evaluator):
    """SSD mean-average-precision (``DetectionMAPEvaluator.cpp``): streams
    (score, TP/FP) pairs per class, AP by 11-point or natural integral.

    ``eval_batch(output, label)`` takes the ``detection_output`` layer's
    [B, K, 7] rows (image,class,score,xmin,ymin,xmax,ymax; image -1 =
    empty slot) and the padded GT SequenceBatch [B, G, 6]."""

    def __init__(self, overlap_threshold: float = 0.5,
                 background_id: int = 0, evaluate_difficult: bool = False,
                 ap_type: str = "11point", **kw):
        self.overlap_threshold = overlap_threshold
        self.background_id = background_id
        self.evaluate_difficult = evaluate_difficult
        self.ap_type = ap_type
        super().__init__(**kw)

    def start(self):
        self.score_tp = {}      # class -> list of (score, is_tp)
        self.num_gt = {}        # class -> count

    @staticmethod
    def _iou(a, b):
        ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
        ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
        inter = max(ix2 - ix1, 0.0) * max(iy2 - iy1, 0.0)
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def eval_batch(self, output, label, weight=None):
        det, _ = self._to_np(output)
        gt, gt_mask = self._to_np(label)
        B = gt.shape[0]
        for b in range(B):
            n = int(gt_mask[b].sum()) if gt_mask is not None else gt.shape[1]
            rows = gt[b, :n]
            for r in rows:
                c = int(r[0])
                difficult = len(r) > 5 and r[5] > 0.5
                if self.evaluate_difficult or not difficult:
                    self.num_gt[c] = self.num_gt.get(c, 0) + 1
            matched = [False] * n
            dets = det[b]
            dets = dets[dets[:, 0] >= 0]
            # evaluate detections best-score first (reference sorts)
            for d in dets[np.argsort(-dets[:, 2])]:
                c = int(d[1])
                if c == self.background_id:
                    continue
                best, best_i = 0.0, -1
                for i, r in enumerate(rows):
                    if int(r[0]) != c:
                        continue
                    ov = self._iou(d[3:7], r[1:5])
                    if ov > best:
                        best, best_i = ov, i
                tp = False
                if best > self.overlap_threshold and best_i >= 0:
                    difficult = len(rows[best_i]) > 5 and rows[best_i][5] > 0.5
                    if difficult and not self.evaluate_difficult:
                        continue   # reference skips difficult matches
                    if not matched[best_i]:
                        tp = True
                        matched[best_i] = True
                self.score_tp.setdefault(c, []).append((float(d[2]), tp))

    def _average_precision(self, pairs, n_gt):
        if not pairs or n_gt == 0:
            return 0.0
        pairs = sorted(pairs, key=lambda p: -p[0])
        tp = np.cumsum([1.0 if t else 0.0 for _, t in pairs])
        fp = np.cumsum([0.0 if t else 1.0 for _, t in pairs])
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1e-12)
        if self.ap_type == "11point":
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                mask = recall >= t
                ap += (precision[mask].max() if mask.any() else 0.0) / 11.0
            return float(ap)
        # natural integral
        ap, prev_r = 0.0, 0.0
        for r, p in zip(recall, precision):
            ap += p * (r - prev_r)
            prev_r = r
        return float(ap)

    def get_value(self):
        aps = [self._average_precision(self.score_tp.get(c, []), n)
               for c, n in self.num_gt.items() if n > 0]
        return {"detection_map": float(np.mean(aps) * 100) if aps else 0.0}


class _PrinterEvaluator(Evaluator):
    """Base for the printer family (``Evaluator.cpp`` toString
    evaluators): accumulates printable lines, logs at finish."""

    def start(self):
        self.lines = []

    def get_value(self):
        for line in self.lines:
            print(line)
        return {}


@EVALUATORS.register("value_printer")
class ValuePrinterEvaluator(_PrinterEvaluator):
    def eval_batch(self, output, label=None, weight=None):
        out, _ = self._to_np(output)
        self.lines.append(f"value: {np.array2string(out, threshold=64)}")


@EVALUATORS.register("gradient_printer")
class GradientPrinterEvaluator(_PrinterEvaluator):
    def eval_batch(self, output, label=None, weight=None):
        out, _ = self._to_np(output)
        self.lines.append(f"gradient: {np.array2string(out, threshold=64)}")


@EVALUATORS.register("maxid_printer")
class MaxIdPrinterEvaluator(_PrinterEvaluator):
    def eval_batch(self, output, label=None, weight=None):
        out, _ = self._to_np(output)
        ids = out.argmax(-1)
        self.lines.append(f"maxid: {np.array2string(ids, threshold=64)}")


@EVALUATORS.register("maxframe_printer")
class MaxFramePrinterEvaluator(_PrinterEvaluator):
    def eval_batch(self, output, label=None, weight=None):
        out, mask = self._to_np(output)
        frames = out.max(-1) if out.ndim > 2 else out
        self.lines.append(f"maxframe: {np.array2string(frames, threshold=64)}")


@EVALUATORS.register("seq_text_printer")
class SeqTextPrinterEvaluator(_PrinterEvaluator):
    """Prints id sequences, optionally mapped through a dict file
    (``--dict_file`` in the reference)."""

    def __init__(self, dict_file=None, **kw):
        self.id2word = None
        if dict_file:
            with open(dict_file) as f:
                self.id2word = [w.rstrip("\n") for w in f]
        super().__init__(**kw)

    def eval_batch(self, output, label=None, weight=None):
        out, mask = self._to_np(output)
        ids = out.argmax(-1) if out.ndim == 3 else out.astype(np.int64)
        for b in range(ids.shape[0]):
            n = int(mask[b].sum()) if mask is not None else ids.shape[1]
            toks = [int(t) for t in np.atleast_1d(ids[b])[:n]]
            if self.id2word:
                words = [self.id2word[t] if 0 <= t < len(self.id2word)
                         else "<unk>" for t in toks]
                self.lines.append(" ".join(words))
            else:
                self.lines.append(" ".join(map(str, toks)))


@EVALUATORS.register("classification_error_printer")
class ClassificationErrorPrinterEvaluator(_PrinterEvaluator):
    def eval_batch(self, output, label, weight=None):
        out, _ = self._to_np(output)
        lab, _ = self._to_np(label)
        err = (out.argmax(-1) != lab.squeeze().astype(np.int64))
        self.lines.append(
            f"classification_error: {np.array2string(err.astype(np.float32))}")
