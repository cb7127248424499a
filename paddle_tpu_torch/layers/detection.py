"""SSD detection layers (counterpart of ``paddle_tpu/layers/detection.py``):
``priorbox``, ``multibox_loss`` and ``detection_output``.

Reference: ``PriorBox.cpp``, ``MultiBoxLossLayer.cpp``,
``DetectionOutputLayer.cpp``.  The math is in
:mod:`paddle_tpu_torch.ops.detection_ops`; the layers adapt the config's
inputs:

- ``priorbox``: inputs [feature, image]; the geometry comes from the
  attrs the DSL records.  The output is the constant ``[1, P·8]`` prior
  tensor, on the feature's device.
- ``multibox_loss``: inputs [priorbox, label, loc…, conf…]
  (``input_num`` loc layers, then as many conf layers); the label is a
  padded ``SequenceBatch`` ``[B, G, 6]`` (class, xmin, ymin, xmax, ymax,
  difficult).  Every output row holds the whole loss, as the reference
  writes it.  As in the JAX package the layer is not a cost layer
  (``is_cost``): a net whose only cost it is has no objective for
  ``NeuralNetwork.loss``.
- ``detection_output``: inputs [priorbox, loc…, conf…].
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.sequence import SequenceBatch, value_of
from ..ops import detection_ops
from ..utils import ConfigError, enforce
from .base import Layer, register_layer


def _priors_from_attrs(conf) -> np.ndarray:
    a = conf.attrs
    for k in ("layer_width", "layer_height", "image_width", "image_height"):
        if a.get(k) is None:
            raise ConfigError(f"priorbox layer: missing attr {k!r}")
    return detection_ops.prior_boxes(
        a["layer_height"], a["layer_width"],
        a["image_height"], a["image_width"],
        a.get("min_size", [1.0]), a.get("max_size", []),
        a.get("aspect_ratio", []), a.get("variance", [0.1, 0.1, 0.2, 0.2]))


@register_layer("priorbox")
class PriorBoxLayer(Layer):
    def forward(self, params, inputs, ctx):
        priors = _priors_from_attrs(self.conf)
        return torch.from_numpy(priors.reshape(1, -1)).to(
            value_of(inputs[0]).device)


def _prior_tensor(v) -> torch.Tensor:
    """Priors are batch-independent: ``[1|B, P·8]`` or ``[P·8]`` →
    ``[P, 8]``."""
    v = value_of(v)
    if v.dim() == 2:
        v = v[0]
    return v.reshape(-1, 8)


def _as_loc(v) -> torch.Tensor:
    """``[B, ...]`` (a conv's NHWC output or flat prior-major rows) →
    ``[B, P, 4]``."""
    v = value_of(v)
    return v.reshape(v.shape[0], -1, 4)


def _as_conf(v, num_classes: int) -> torch.Tensor:
    v = value_of(v)
    return v.reshape(v.shape[0], -1, num_classes)


def _heads(inputs, first: int, input_num: int, num_classes: int):
    """The loc and conf heads from ``inputs[first:]``, each concatenated
    over the prior axis."""
    locs = torch.cat([_as_loc(v) for v in
                      inputs[first:first + input_num]], dim=1)
    confs = torch.cat([_as_conf(v, num_classes) for v in
                       inputs[first + input_num:first + 2 * input_num]],
                      dim=1)
    return locs, confs


@register_layer("multibox_loss")
class MultiBoxLossLayer(Layer):
    def forward(self, params, inputs, ctx):
        a = self.conf.attrs
        num_classes = a["num_classes"]
        label = inputs[1]
        enforce(isinstance(label, SequenceBatch),
                "multibox_loss label must be a sequence of GT box rows")
        locs, confs = _heads(inputs, 2,
                             a.get("input_num", (len(inputs) - 2) // 2),
                             num_classes)
        loss = detection_ops.multibox_loss(
            confs, locs, _prior_tensor(inputs[0]), label.data,
            label.length, num_classes=num_classes,
            overlap_threshold=a.get("overlap_threshold", 0.5),
            neg_overlap=a.get("neg_overlap", 0.5),
            neg_pos_ratio=a.get("neg_pos_ratio", 3.0),
            background_id=a.get("background_id", 0))
        # MultiBoxLossLayer.cpp writes the whole (already match-count
        # normalised) loss into every row
        b = value_of(inputs[2]).shape[0]
        return loss.reshape(1, 1).expand(b, 1)


@register_layer("detection_output")
class DetectionOutputLayer(Layer):
    def forward(self, params, inputs, ctx):
        a = self.conf.attrs
        num_classes = a["num_classes"]
        locs, confs = _heads(inputs, 1, a.get("input_num", 1), num_classes)
        return detection_ops.detection_output(
            confs, locs, _prior_tensor(inputs[0]), num_classes=num_classes,
            background_id=a.get("background_id", 0),
            conf_threshold=a.get("confidence_threshold", 0.01),
            nms_top_k=a.get("nms_top_k", 400),
            nms_threshold=a.get("nms_threshold", 0.45),
            keep_top_k=a.get("keep_top_k", 200))
