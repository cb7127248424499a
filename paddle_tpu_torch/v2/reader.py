"""``paddle.v2.reader`` (counterpart of ``paddle_tpu/v2/reader.py``): the
reader creators and decorators; ``creator.recordio`` reads record files,
``creator.cloud_reader`` refuses by name (queue A9)."""

from ..data.pipeline import prefetch_reader  # noqa: F401
from ..data.reader import (  # noqa: F401
    batch,
    buffered,
    cache,
    chain,
    cloud_reader,
    compose,
    firstn,
    map_readers,
    np_array,
    recordio,
    shuffle,
    text_file,
    xmap_readers,
)

creator = type("creator", (), {"np_array": staticmethod(np_array),
                               "text_file": staticmethod(text_file),
                               "recordio": staticmethod(recordio),
                               "cloud_reader": staticmethod(cloud_reader)})
