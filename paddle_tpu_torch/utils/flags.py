"""Runtime flags this slice reads (counterpart of
``paddle_tpu/utils/flags.py``): same names and defaults, settable from
code (``FLAGS.set``) or the environment (``PADDLE_TPU_<NAME>``)."""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Tuple


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "on")


class FlagRegistry:
    def __init__(self) -> None:
        self._parsers: Dict[str, Callable[[str], Any]] = {}
        self._values: Dict[str, Any] = {}
        #: name -> (default, help text)
        self.specs: Dict[str, Tuple[Any, str]] = {}

    def define(self, name: str, default: Any, help: str = "") -> None:
        if name in self._parsers:
            raise ValueError(f"flag {name!r} is already registered")
        if isinstance(default, bool):
            parser: Callable[[str], Any] = _parse_bool
        elif isinstance(default, (int, float)):
            parser = type(default)
        else:
            parser = str
        self._parsers[name] = parser
        self.specs[name] = (default, help)
        env = os.environ.get("PADDLE_TPU_" + name.upper())
        self._values[name] = parser(env) if env is not None else default

    def get(self, name: str) -> Any:
        return self._values[name]

    def set(self, name: str, value: Any) -> None:
        if name not in self._parsers:
            raise KeyError(f"unknown flag {name!r}")
        self._values[name] = value


FLAGS = FlagRegistry()

FLAGS.define("serve_port", 0,
             "serving HTTP endpoint: POST /v1/generate, GET /healthz; "
             "0 picks a free port")
FLAGS.define("serve_bind", "",
             "bind host for the serving endpoint; empty = loopback only")
FLAGS.define("serve_max_batch", 8,
             "continuous-batching decode width: at most this many "
             "requests share one paged_decode_attention launch")
FLAGS.define("serve_continuous", True,
             "continuous batching in the inference server; false = "
             "sequential single-request serving, byte-for-byte the same "
             "generated tokens")
FLAGS.define("kv_pool_pages", 128,
             "physical pages in the shared serving KV pool")
FLAGS.define("kv_page_size", 16, "tokens per KV page")
# precision policy (core/dtypes.py) and the mixed-precision train step
FLAGS.define("use_bf16", True, "run matmul compute in bfloat16")
FLAGS.define("bf16_activations", False,
             "store layer activations in bfloat16 (params and losses stay "
             "fp32)")
FLAGS.define("precision", "fp32",
             "end-to-end training precision policy: fp32 | bf16.  bf16 = "
             "fp32 master weights cast to bfloat16 at the train-step "
             "boundary, fp32 optimizer state, dynamic loss scaling with "
             "skipped steps on non-finite gradients; it overrides "
             "--use_bf16.  fp32 leaves the --use_bf16/--bf16_activations "
             "resolution as it is")
FLAGS.define("loss_scale_init", 32768.0,
             "initial dynamic loss scale under --precision=bf16 (grows 2x "
             "every --loss_scale_growth_interval overflow-free steps, "
             "halves - floor 1.0 - and skips the step on inf/nan "
             "gradients)")
FLAGS.define("loss_scale_growth_interval", 2000,
             "overflow-free steps between dynamic loss-scale doublings")
FLAGS.define("conv_bn_fuse", True,
             "fuse linear-conv->batch_norm pairs: the 3x3 backward-data "
             "kernel forms the BN backward's affine as it loads "
             "(ops/conv.py); off = the plain composition")
FLAGS.define("conv_bn_fuse_fwd", True,
             "fuse batch_norm(+relu)->conv pairs on the forward side: the "
             "BN's per-channel affine + ReLU formed as the consuming conv "
             "reads its input (3x3 kernel / 1x1 GEMM prologue, ops/conv.py "
             "and ops/nn_ops.py) instead of materializing the normalized "
             "activation; off = the backward fusion alone")
FLAGS.define("flash_kernel", True,
             "run attention through the flash kernels (ops/attention.py); "
             "off = the exact dense attention composition, for A/B traffic "
             "measurement")
FLAGS.define("flash_block_sparse", True,
             "block-sparse flash attention: compact the KV walk per q-block "
             "so blocks fully above the causal diagonal or past a row's "
             "length are neither loaded nor visited (fwd + both backward "
             "kernels); off = the legacy full (B*H, q_blocks, k_blocks) grid "
             "that fetched every block and only skipped the compute, for "
             "one-flag revert / A/B traffic measurement")
FLAGS.define("attention_packing", True,
             "sequence packing for attention layers with packed=True: "
             "mixed-length rows share one [total_tokens] segment-id layout "
             "where padding and cross-sequence blocks do zero work; off = "
             "the layer ignores the packed attr and runs the exact padded "
             "per-row lowering")
FLAGS.define("fused_rnn_hblock", True,
             "the hidden-blocked LSTM tier for 512 < H (ops/lstm.py); off "
             "= such shapes take the per-step scan")
# the sparse embedding lane (parallel/sparse.py, ops/embedding.py,
# trainer/trainer.py).  The reference's --embedding_kernel_interpret
# (its Pallas gather in interpret mode off the TPU) has no counterpart:
# on CPU tensors ops/embedding.gather_rows takes its plain version.
FLAGS.define("sparse_grads", True,
             "sparse gradient exchange for ParamAttr(sparse_update="
             "True) embedding tables (parallel/sparse.py): the train step "
             "carries each table's gradient as a fixed-capacity (rows, "
             "values) pair — batch ids deduped once, row cotangents "
             "segment-summed by autograd — and applies it through "
             "Optimizer.apply_rows, so the dense [V, D] gradient is never "
             "materialized.  false is the kill switch: the legacy dense "
             "gradient + lazy row masking")
FLAGS.define("sparse_grad_rows", 0,
             "fixed row capacity K of the sparse gradient exchange per "
             "table: rows/values ship as [K]/[K, D] whatever the batch "
             "touches.  0 (default) = auto — the batch's total id count, "
             "which can never overflow.  A manual K below the unique-id "
             "count of a batch drops the LARGEST ids from the update (the "
             "smallest K are kept) — size it >= the worst-case unique ids "
             "per batch")
FLAGS.define("embedding_kernel", True,
             "gather embedding rows through the row-gather kernel "
             "(ops/embedding.py, kernel 22): only the touched rows are "
             "read; false = the plain index_select gather, byte-for-byte, "
             "for one-flag revert / A/B traffic measurement")
# the training loop (trainer/trainer.py: train, test, time_job,
# check_gradients) and its input pipeline (data/pipeline.py)
FLAGS.define("log_period", 100, "log every N batches")
FLAGS.define("show_parameter_stats_period", 0,
             "dump param stats every N batches")
FLAGS.define("checkgrad_eps", 1e-2,
             "finite-difference step for --job=checkgrad")
FLAGS.define("saving_period", 1, "checkpoint every N passes")
FLAGS.define("start_pass", 0, "first pass number (resume)")
FLAGS.define("save_dir", "./output", "checkpoint output dir")
# checkpoints (trainer/checkpoint.py, Trainer.save / load / resume)
FLAGS.define("load_missing_parameter_strategy", "fail", "fail|rand|zero")
FLAGS.define("init_model_path", "", "checkpoint dir to warm-start from")
FLAGS.define("ckpt_keep", 5,
             "checkpoint retention: keep the newest N pass-* dirs after "
             "each save and delete older ones; 0 disables the sweep "
             "(keep everything, the legacy behavior)")
FLAGS.define("ckpt_verify", True,
             "verify per-file SHA-256 digests from the checkpoint "
             "manifest on load, and make resume scan backward past "
             "corrupt checkpoints (quarantined as .corrupt-*); off = "
             "the legacy blind latest-checkpoint load")
FLAGS.define("ckpt_export_lease_s", 600.0,
             "stale-mtime expiry for .exporting-<pid> checkpoint pin "
             "markers (trainer/checkpoint.py): the retention sweep "
             "honors a fresher marker (never reaps a checkpoint "
             "mid-export) and ignores older ones — a SIGKILLed "
             "exporter cannot pin a checkpoint forever")
FLAGS.define("roofline_dump", "",
             "write the attributed per-region roofline/cost report of the "
             "train step to this JSON path at the end of the first "
             "training pass; empty = off")
FLAGS.define("prefetch_depth", 2,
             "async input pipeline depth (data/pipeline.py): max batches "
             "in flight between the reader and the train step — reader "
             "IO, DataFeeder.convert, and the host->device transfer run "
             "on worker threads and overlap the running step; 0 restores "
             "the fully synchronous loop (read -> convert -> step)")
FLAGS.define("reader_workers", 2,
             "reader/convert worker threads per async input pipeline "
             "(clamped to prefetch_depth; reading from the source is "
             "serialized, convert+transfer parallelize)")
