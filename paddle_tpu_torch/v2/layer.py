"""``paddle.v2.layer`` (counterpart of ``paddle_tpu/v2/layer.py``): the
port's config DSL re-exported; ``parse_network`` is ``topology``."""

from ..config.dsl import *  # noqa: F401,F403
from ..config.dsl import (  # noqa: F401
    LayerOutput,
    StepInput,
    memory,
    mixed,
    recurrent_group,
    topology,
)

# parse_network equivalent
parse_network = topology
