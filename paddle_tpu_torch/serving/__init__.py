"""Deployment and serving (counterpart of ``paddle_tpu/serving``).

The reference's C inference API (``paddle/capi/gradient_machine.h:
36-88``) runs trained models in processes that embed none of the
training framework.  The port's artifact is a ``torch.export`` program
(the JAX package's is a StableHLO module) with the JAX package's
manifest:

- :mod:`paddle_tpu_torch.serving.export` — build the artifact from a
  trained network (``export_network``) or a traceable function
  (``export_inference_fn``), fp32 or int8 weights-only;
- :mod:`paddle_tpu_torch.serving.loader` — the standalone loader
  (``ServedModel``; imports torch, numpy, the stdlib and the kernel-op
  module, never the layer engine).

The request-serving half:

- :mod:`paddle_tpu_torch.serving.pagepool` — the shared KV page pool
  with atomic checksummed snapshots;
- :mod:`paddle_tpu_torch.serving.model` — the decoder transformer whose
  prefill runs kernel 1 (serving form) and whose decode step runs kernel
  7 over the pool; decoder artifacts, which move between the two
  packages in both directions;
- :mod:`paddle_tpu_torch.serving.server` — the continuous-batching
  :class:`InferenceServer` (admission, fixed-width decode batch, the
  sequential kill switch, HTTP front, telemetry, the hot swap);
- :mod:`paddle_tpu_torch.serving.rollout` — the zero-downtime
  train→serve pipeline: checkpoint watcher, hot swap with rollback and
  the canary bake (the fleet's rolling coordinator is queue A10b).
"""

from .export import export_inference_fn, export_network  # noqa: F401
from .loader import (ServedModel, TornArtifact,  # noqa: F401
                     artifact_digest, verify_artifact)
from .pagepool import (PagePool, PagePoolExhausted,  # noqa: F401
                       TornSnapshot)

# The decoder/server half pulls in the attention kernels and the
# trainer's checkpoints — resolved lazily (PEP 562), so that a process
# that only LOADS artifacts keeps the loader contract: importing
# paddle_tpu_torch.serving.loader never drags in the layer engine.
_LAZY = {
    "DecoderConfig": "model", "DecoderModel": "model",
    "export_decoder": "model", "init_decoder_params": "model",
    "InferenceServer": "server", "Request": "server",
    "SwapTicket": "server",
    "CheckpointWatcher": "rollout", "RollingCoordinator": "rollout",
    "swap_from_artifact": "rollout", "export_checkpoint": "rollout",
    "latest_valid_artifact": "rollout", "sweep_export_dir": "rollout",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
