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
FLAGS.define("serve_slo_ms", 0.0,
             "optional p99 TTFT SLO in milliseconds: when > 0 the "
             "server's stats() and /healthz report ttft_p99_ms and "
             "slo_met from the serve_ttft_seconds windowed p99 (last "
             "60 s); 0 leaves /healthz byte-identical")
FLAGS.define("slo", "",
             "declarative serving SLOs evaluated on the reporter thread "
             "(observe/slo.py): objectives joined with ',' or ';' in "
             "metric:statOPthreshold:window grammar, e.g. "
             "'serve_ttft_seconds:p99<0.5:60s' (stat pNN or rate, OP < "
             "or >, window Ns or Nm); empty = no engine")
FLAGS.define("rollout", True,
             "the train->serve pipeline (serving/rollout.py): checkpoint "
             "watcher and hot swap of exported artifacts into the live "
             "InferenceServer between decode steps, with rollback on a "
             "failed verify/load/probe; false is the kill switch "
             "(request_swap refuses, POST /v1/swap is an unknown path, "
             "/healthz keeps its pre-rollout body)")
FLAGS.define("rollout_poll_s", 5.0,
             "checkpoint-watcher poll interval in seconds")
FLAGS.define("rollout_inflight", "drain",
             "in-flight requests at the swap's flip: 'drain' finishes "
             "them on the old model first (admissions pause), "
             "'reprefill' flips at once and restarts them from the "
             "prompt on the new model")
FLAGS.define("rollout_quantize", "int8",
             "serving-artifact quantization of the watcher's export "
             "(int8 per-channel weights, or 'none')")
FLAGS.define("rollout_export_dir", "",
             "where the checkpoint watcher writes model-<digest> "
             "artifacts; empty = <save_dir>/export")
FLAGS.define("rollout_canary", False,
             "bake a swapped-in model for --rollout_bake_s and roll "
             "back to its predecessor when its windowed p99 TTFT or "
             "error rate exceeds --rollout_canary_factor x the "
             "pre-swap baseline")
FLAGS.define("rollout_bake_s", 0.0,
             "canary bake duration in seconds (--rollout_canary)")
FLAGS.define("rollout_canary_factor", 2.0,
             "canary breach threshold: factor x baseline p99 TTFT or "
             "error rate (any errors breach an error-free baseline)")
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
FLAGS.define("fleet_addr", "",
             "fleet aggregator address (host:port, observe/fleet.py): "
             "when set, this process pushes one self-describing "
             "telemetry frame — metrics snapshot, recent "
             "flight-recorder spans, health digest — every "
             "--metrics_interval_s seconds from the reporter thread.  "
             "A dead/version-skewed aggregator degrades the push sink "
             "(warn-once, exponential backoff + jitter) and never "
             "touches the training loop; empty (default) = no push "
             "client, no reporter thread, zero new work")
FLAGS.define("fleet_port", 0,
             "host the fleet aggregator in THIS process on this port "
             "(observe/fleet.py): serves GET /fleet/metrics (merged "
             "Prometheus with role/pid/node labels), /fleet/healthz "
             "(cluster rollup with staleness detection), /fleet/trace "
             "(all processes' spans merged into one Chrome trace-event "
             "timeline) and /fleet/topology, plus POST /fleet/push "
             "frame intake; 0 (default) hosts nothing")
FLAGS.define("fleet_bind", "",
             "bind address for the --fleet_port aggregator (empty = "
             "127.0.0.1).  Non-loopback is an explicit opt-in and "
             "warns loudly — same not-an-external-API rule as "
             "--metrics_bind")
FLAGS.define("fleet_id", "",
             "logical fleet identity of this process (e.g. trainer-0):"
             " the key the aggregator's staleness tracking uses, so a "
             "restarted process with the same id supersedes its dead "
             "entry and the /fleet/healthz rollup recovers.  Empty = "
             "derived role@node:pid (a restart then registers as a "
             "NEW process and the old entry stays missing)")
FLAGS.define("fleet_role", "trainer",
             "fleet role this process registers as (trainer | "
             "master-client | serving | bench by convention); the "
             "elastic trainer, serving loader and bench override this "
             "programmatically")
FLAGS.define("fleet_stale_factor", 3.0,
             "staleness multiplier for the /fleet/healthz rollup: a "
             "process that has not pushed for this many multiples of "
             "its own advertised interval is reported 'missing' "
             "(a restarted process pushing under the same --fleet_id "
             "flips it back to ok)")
FLAGS.define("fleet_ring_size", 4096,
             "per-process span retention in the hosted aggregator: "
             "the newest N spans of each registered process kept for "
             "the merged /fleet/trace timeline")
FLAGS.define("fleet_push_timeout_s", 2.0,
             "socket timeout for one fleet push POST; a slow or dead "
             "aggregator costs the reporter thread at most this long "
             "before the degrade/backoff path takes over")
FLAGS.define("sigterm_flush", True,
             "install a chaining SIGTERM hook when any telemetry "
             "surface is configured (observe/shutdown.py): the final "
             "metrics interval is flushed, a last going-down fleet "
             "frame is pushed, and the --trace_jsonl array is "
             "finalized before the previous handler (or the default "
             "die-by-signal disposition) runs; off = the atexit-only "
             "flush, which a SIGTERM-then-SIGKILL orchestrator window "
             "can lose")
FLAGS.define("health_interval", 0,
             "training-health telemetry (observe/health.py): every N "
             "steps drain the on-device per-layer accumulators — "
             "gradient/parameter norms, update ratios ||dw||/||w||, "
             "non-finite localization — into observe gauges, /metrics "
             "and the host-side detectors (loss spike/plateau, "
             "dead/exploding layers).  The step folds its per-layer "
             "sums into a few device tensors and never reads them "
             "back; the drain's one device-to-host copy is the only "
             "fence, amortized over N steps.  0 (default) = off: the "
             "step runs without any of it")
FLAGS.define("health_window", 32,
             "rolling window (in drains) for the loss median/MAD "
             "robust statistics behind the spike/plateau detectors")
FLAGS.define("health_spike_mad", 8.0,
             "loss-spike threshold: alert when loss exceeds the "
             "rolling median by this many robust sigmas (1.4826*MAD)")
FLAGS.define("health_plateau_rtol", 1e-4,
             "loss-plateau threshold: alert when the loss window's "
             "full range stays within this relative tolerance of the "
             "median for a whole window")
FLAGS.define("health_dead_ratio", 1e-10,
             "dead-layer threshold: alert when a layer's update ratio "
             "||dw||/||w|| stays at or below this for "
             "--health_patience consecutive drains")
FLAGS.define("health_explode_ratio", 0.5,
             "exploding-layer threshold: alert when a layer's update "
             "ratio exceeds this for --health_patience consecutive "
             "drains")
FLAGS.define("health_patience", 2,
             "consecutive drains a dead/exploding condition must "
             "persist before its alert fires")
FLAGS.define("enable_timers", True,
             "collect named wall timers (utils/stat.py, the Stat.h "
             "equivalent); false makes every StatSet.timer a no-op")
# the multi-device flags: the JAX package's names and
# defaults.  One process drives one device, so ``mesh_shape`` names the
# axes over the processes of the job (``PADDLE_NUM_NODES`` of them).
FLAGS.define("trainer_count", 1,
             "data-parallel replicas (mesh 'data' axis size)")
FLAGS.define("trainer_id", 0, "index of this host in a multi-host job")
FLAGS.define("num_hosts", 1, "number of hosts in the job")
FLAGS.define("master_retry_max", 5,
             "reconnect attempts per master RPC: on connection loss the "
             "TCP MasterClient re-dials with exponential backoff + jitter "
             "and replays the request up to this many times; 0 restores "
             "the legacy fail-fast behavior (first drop raises "
             "PaddleTpuError)")
FLAGS.define("mesh_shape", "",
             "mesh as 'data=8' or 'data=4,model=2' over the job's "
             "processes, one device each (auto if empty: every process "
             "on 'data')")
FLAGS.define("fsdp", False,
             "shard parameters AND optimizer slots over the 'data' mesh "
             "axis (FSDP): each rank holds 1/N of them, gathers each "
             "parameter before use and reduce-scatters its gradient; "
             "placement comes from the trainer's fsdp_rules table "
             "(parallel/rule_tables.py for zoo models) else the "
             "largest-divisible-dim heuristic.  --fsdp=false is the kill "
             "switch: the replicated path, byte-for-byte")
FLAGS.define("fsdp_min_size", 1024,
             "parameters below this many elements stay replicated under "
             "the FSDP auto heuristic (norm gains, biases); rule-table "
             "entries are exempt")
FLAGS.define("parallel_nn", False,
             "per-layer device placement (sharding annotations)")
FLAGS.define("port", 7164, "data-task coordinator service port")
FLAGS.define("ports_num", 1, "kept for config compatibility; unused")
FLAGS.define("num_gradient_servers", 1, "kept for config compatibility")
FLAGS.define("rdma_tcp", "tcp", "kept for config compatibility; unused")
