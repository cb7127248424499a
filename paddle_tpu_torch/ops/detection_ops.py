"""SSD detection ops (counterpart of ``paddle_tpu/ops/detection_ops.py``).

This file holds only :func:`num_priors_per_cell`, the integer helper the
config DSL's ``priorbox_layer`` sizes its output with.  The prior boxes,
matching, multibox loss and detection output come with queue A14, which
fills the rest of this file.
"""

from __future__ import annotations


def num_priors_per_cell(min_sizes, max_sizes, aspect_ratios) -> int:
    return (len(min_sizes) * (1 + len(max_sizes))
            + 2 * len(aspect_ratios))
