from .error import PaddleTpuError, enforce  # noqa: F401
from .flags import FLAGS  # noqa: F401
from .logger import get_logger, warn_once  # noqa: F401
