"""Composite networks (``python/paddle/v2/framework/nets.py``).

Counterpart of ``paddle_tpu/framework/nets.py``, the same code.
"""

from __future__ import annotations

from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, pool_type="max",
                         main_program=None, startup_program=None):
    conv_out = layers.conv2d(input, num_filters=num_filters,
                             filter_size=filter_size, act=act,
                             main_program=main_program,
                             startup_program=startup_program)
    return layers.pool2d(conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         main_program=main_program,
                         startup_program=startup_program)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=None,
                   pool_stride=1, pool_type="max", main_program=None,
                   startup_program=None):
    tmp = input
    if isinstance(conv_padding, int):
        conv_padding = [conv_padding] * len(conv_num_filter)
    if conv_batchnorm_drop_rate is None:
        conv_batchnorm_drop_rate = [0.0] * len(conv_num_filter)
    if isinstance(conv_with_batchnorm, bool):
        conv_with_batchnorm = [conv_with_batchnorm] * len(conv_num_filter)
    for i, nf in enumerate(conv_num_filter):
        tmp = layers.conv2d(tmp, num_filters=nf,
                            filter_size=conv_filter_size,
                            padding=conv_padding[i],
                            act=None if conv_with_batchnorm[i]
                            else conv_act,
                            main_program=main_program,
                            startup_program=startup_program)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(tmp, act=conv_act,
                                    main_program=main_program,
                                    startup_program=startup_program)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(tmp,
                                     conv_batchnorm_drop_rate[i],
                                     main_program=main_program)
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride,
                         main_program=main_program)


def sequence_conv_pool(input, num_filters, filter_size, act="tanh",
                       pool_type="MAX", main_program=None,
                       startup_program=None):
    conv_out = layers.sequence_conv(input, num_filters=num_filters,
                                    filter_size=filter_size, act=act,
                                    main_program=main_program,
                                    startup_program=startup_program)
    return layers.sequence_pool(conv_out, pool_type=pool_type,
                                main_program=main_program)
