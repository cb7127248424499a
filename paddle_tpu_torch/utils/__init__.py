from .error import ConfigError, PaddleTpuError, enforce  # noqa: F401
from .flags import FLAGS  # noqa: F401
from .logger import get_logger, set_log_level, warn_once  # noqa: F401
from .stat import StatSet, global_stat  # noqa: F401
