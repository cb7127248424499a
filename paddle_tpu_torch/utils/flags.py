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
# check_gradients), its input pipeline (data/pipeline.py) and the CLI
# (cli.py, config/config_parser.py)
FLAGS.define("log_period", 100, "log every N batches")
FLAGS.define("test_period", 0, "test every N batches (0: per pass)")
FLAGS.define("seed", 1, "global RNG seed (0: nondeterministic)")
FLAGS.define("config_args", "", "comma-sep k=v pairs visible to configs")
FLAGS.define("log_level", "",
             "framework log level: debug|info|warning|error|fatal "
             "(empty = PADDLE_TPU_LOG_LEVEL env var, else INFO); "
             "applied by the entry points after flag parsing via "
             "utils.logger.set_log_level")
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
# the telemetry core (observe/, utils/stat.py, utils/profiler.py)
FLAGS.define("metrics_jsonl", "",
             "telemetry JSONL sink path: when set, a background "
             "reporter appends one self-describing snapshot line "
             "(typed metrics + StatSet timer table) every "
             "--metrics_interval_s seconds (observe/report.py); "
             "empty = no sink, instrumentation stays near-zero cost "
             "and the trainer skips its step-fencing time split")
FLAGS.define("metrics_interval_s", 10.0,
             "flush interval for the --metrics_jsonl reporter")
FLAGS.define("trace_jsonl", "",
             "span-trace sink path (observe/trace.py): when set, every "
             "span (trainer step phases, pipeline workers, checkpoint "
             "ops, serving requests) streams to this file as Chrome "
             "trace-event JSON — load it directly in Perfetto / "
             "chrome://tracing; empty = no stream, span() is a shared "
             "no-op")
FLAGS.define("trace_ring_size", 4096,
             "flight-recorder capacity: the last N spans of a live run "
             "kept in a bounded in-memory ring, served by the "
             "--metrics_port /trace endpoint and the SIGUSR2 debug "
             "dump")
FLAGS.define("metrics_port", 0,
             "live observability endpoint (observe/http.py): serve GET "
             "/metrics (Prometheus text), /healthz (liveness JSON) and "
             "/trace (flight-recorder dump as Chrome trace-event JSON) "
             "on this loopback port; 0 (the default) starts no server "
             "thread")
FLAGS.define("metrics_bind", "",
             "bind address for the --metrics_port observability "
             "endpoint (empty = 127.0.0.1).  Non-loopback is an "
             "EXPLICIT opt-in for same-host-only/container scraping "
             "and logs a loud structured warning: the endpoint is "
             "diagnostics, NOT an external API — no auth, no TLS, "
             "never expose it past a trusted network boundary")
FLAGS.define("debug_dump_signal", False,
             "install a SIGUSR2 handler that dumps Prometheus text + "
             "the flight-recorder trace of the LIVE run to timestamped "
             "files under --debug_dump_dir (kill -USR2 <pid>) — "
             "post-mortem for wedged runs without a debugger")
FLAGS.define("debug_dump_dir", "",
             "output directory for --debug_dump_signal dumps (empty = "
             "the process's temp directory, $TMPDIR)")
FLAGS.define("sigterm_flush", True,
             "install a chaining SIGTERM hook when any telemetry "
             "surface is configured (observe/shutdown.py): the final "
             "metrics interval is flushed and the --trace_jsonl array "
             "is finalized before the previous handler (or the default "
             "die-by-signal disposition) runs; off = the atexit-only "
             "flush, which a SIGTERM-then-SIGKILL orchestrator window "
             "can lose")
FLAGS.define("enable_timers", True,
             "collect named wall timers (utils/stat.py, the Stat.h "
             "equivalent); false makes every StatSet.timer a no-op")
