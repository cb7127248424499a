"""3-D image layers (counterpart of ``paddle_tpu/layers/image3d.py``).

This file holds only :func:`conv3d_out_shape`, the geometry the config
DSL's ``img_conv3d_layer`` and ``img_pool3d_layer`` size their outputs
with.  The ``conv3d``, ``deconv3d`` and ``pool3d`` layers come with
queue A14, which fills the rest of this file; until then the network
refuses those types by name.
"""

from __future__ import annotations

from .conv import conv_out_size


def conv3d_out_shape(d, h, w, filt, pad, stride, caffe_mode=True):
    """Output (D, H, W) for a z/y/x triple of filter/pad/stride."""
    return tuple(conv_out_size(i, f, p, s, caffe_mode)
                 for i, f, p, s in zip((d, h, w), filt, pad, stride))
