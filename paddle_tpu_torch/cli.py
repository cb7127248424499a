"""``paddle`` CLI — the ``paddle train`` entry point
(``paddle/trainer/TrainerMain.cpp:32`` + ``paddle/scripts/submit_local.sh.in``;
counterpart of ``paddle_tpu/cli.py``).

Jobs: train / test / time / checkgrad (``--job=``, ``Trainer.cpp:299``,
``TrainerBenchmark.cpp``), plus ``merge_model``, ``dump_config``,
``diagram``, ``master`` (the standalone data-task master) and
``version``.  Config files use the v1 protocol (see
:mod:`paddle_tpu_torch.config.config_parser`).

Usage:
    python -m paddle_tpu_torch train --config=conf.py --job=time \
        --config_args batch_size=64 --num_passes=2 --save_dir=./out

``train`` runs on CUDA; ``--device cpu`` asks for the plain PyTorch
versions on the CPU.  With no CUDA device and no ``--device cpu`` it
raises.  A data-parallel job is one process a device, each running the
same command with ``PADDLE_COORDINATOR`` / ``PADDLE_NUM_NODES`` /
``PADDLE_NODE_ID`` set (``distributed.launch``); ``--mesh_shape`` names
the mesh over them (default every process on ``data``), ``--fsdp``
shards parameters and optimizer state over ``data``, and
``local_sgd_steps`` in the config selects local SGD
(``parallel.local_sgd.make_trainer``).  The telemetry options ``--metrics_jsonl``,
``--metrics_interval_s``, ``--trace_jsonl``, ``--metrics_port``,
``--metrics_bind`` and ``--debug_dump_signal`` set their flags, and
``observe.start_from_flags`` starts what they configure before the job
runs, as the reference's CLI does.  What the port lacks refuses by name
before a job runs: the fleet and health options (``--fleet_addr``,
``--fleet_port``, ``--fleet_id``, ``--health_interval``; queue A10b),
and a test every ``--test_period`` batches of ``--job train`` (queue
A8): the job tests once a pass when the config's data source has a
``test_list``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
from typing import List, Optional

from .utils import FLAGS, PaddleTpuError, get_logger

log = get_logger("cli")

#: train options of the fleet and health telemetry, refused when set
#: (A10b)
_FLEET_OPTIONS = ("fleet_addr", "fleet_port", "fleet_id", "health_interval")
#: train options of the telemetry core that set the flag of their name
_OBSERVE_OPTIONS = ("metrics_jsonl", "metrics_interval_s", "trace_jsonl",
                    "metrics_port", "metrics_bind", "debug_dump_signal")


def _build_reader(ds, opt, test: bool = False):
    """Data source spec → batched reader (PyDataProvider2 protocol)."""
    from .data.reader import batch as batch_reader

    file_list: List[str] = []
    lst = ds.test_list if test and ds.test_list else ds.train_list
    if lst and os.path.exists(lst):
        with open(lst) as f:
            file_list = [ln.strip() for ln in f if ln.strip()]
    mod = importlib.import_module(ds.module)
    provider = getattr(mod, ds.obj)
    reader = provider.reader(*file_list, **ds.args)
    return batch_reader(reader, opt.batch_size), provider


def _feeder_for(provider, model):
    from .data.feeder import DataFeeder

    # init_hook providers fill settings.input_types when reader() is built
    types = provider.input_types or \
        getattr(provider.settings, "input_types", None)
    if isinstance(types, dict):
        pairs = list(types.items())
    else:
        data_layers = [l for l in model.layers if l.type == "data"]
        pairs = [(dl.name, t) for dl, t in zip(data_layers, types)]
    return DataFeeder(pairs)


def _refuse_unported(args) -> None:
    """Refuse, by name and before a job runs, what the port lacks."""
    if args.command == "master":
        for name in ("fleet_port", "fleet_bind"):
            if getattr(args, name) not in (None, ""):
                raise PaddleTpuError(
                    f"master --{name} is not ported yet (the fleet "
                    "aggregator, observe/fleet.py, queue A10b); leave it "
                    "unset")
        return
    if args.command != "train":
        return
    if args.job == "train" and args.test_period:
        raise PaddleTpuError(
            "--test_period > 0 for --job train (a test every N batches) is "
            "not ported yet (queue A8); --test_period 0 tests once a pass "
            "when the config's data source has a test_list")
    for name in _FLEET_OPTIONS:
        if getattr(args, name) not in (None, "", False):
            raise PaddleTpuError(
                f"--{name} is not ported yet (the fleet and health "
                "telemetry, observe/fleet.py and observe/health.py, queue "
                "A10b); leave it unset")


def _require_cuda(args) -> None:
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise PaddleTpuError(
            "no CUDA device available; pass --device cpu to run the plain "
            "PyTorch versions on the CPU")


def cmd_train(args) -> int:
    from .config.config_parser import parse_config
    from .core.device import get_mesh, resolve_device
    from .distributed.launch import cluster_env, initialize_cluster
    from .layers.network import NeuralNetwork
    from .parallel.local_sgd import make_trainer

    _require_cuda(args)
    if cluster_env() or args.distributed:
        # PADDLE_COORDINATOR set (or --distributed): join the job's
        # process group, one process a device
        env = cluster_env()
        if env and env["coordinator_address"] and not (
                env["num_processes"] and env["process_id"] is not None):
            log.error("PADDLE_COORDINATOR requires PADDLE_NUM_NODES "
                      "and PADDLE_NODE_ID")
            return 2
        # a device with no index: the process takes card
        # PADDLE_NODE_ID mod the host's card count
        initialize_cluster(device=args.device)
    # after initialize_cluster, ``cuda`` resolves to this process's card
    dev = resolve_device(args.device)
    model, opt, ds = parse_config(args.config, args.config_args)
    log.info("config parsed: %d layers, batch_size=%d, method=%s",
             len(model.layers), opt.batch_size, opt.learning_method)
    # the job sees the config's directory (its provider module) and
    # --save_dir; both are put back after it, for in-process callers
    saved_path, saved_dir = list(sys.path), FLAGS.get("save_dir")
    sys.path.insert(0, os.path.dirname(os.path.abspath(args.config)))
    try:
        net = NeuralNetwork(model)
        # honors OptimizationConfig.local_sgd_steps (local-SGD mode), on
        # the mesh of this job's processes (--mesh_shape)
        trainer = make_trainer(net, opt, device=dev,
                               mesh=get_mesh(refresh=True))
        # restore parameters BEFORE any job runs (test must see them)
        if args.init_model_path:
            trainer.load(args.init_model_path)
        if args.save_dir:
            FLAGS.set("save_dir", args.save_dir)
            trainer.resume(args.save_dir)
        return _run_job(args, trainer, model, opt, ds)
    finally:
        sys.path[:] = saved_path
        FLAGS.set("save_dir", saved_dir)


def _run_job(args, trainer, model, opt, ds) -> int:
    reader, provider = _build_reader(ds, opt, test=(args.job == "test"))
    feeder = _feeder_for(provider, model)

    if args.job == "time":
        # --test_period is the number of timed batches, as in
        # paddle_tpu/cli.py
        metrics = trainer.time_job(reader, feeder,
                                   batches=args.test_period or 20)
        print(json.dumps({"job": "time", **{k: round(v, 3)
                                            for k, v in metrics.items()}}))
        return 0
    if args.job == "checkgrad":
        batch = next(iter(reader()))
        misses = trainer.gradient_misses(feeder.convert(batch))
        failed = sum(1 for n in misses.values() if n)
        print(json.dumps({"job": "checkgrad", "checked": len(misses),
                          "failed": failed}))
        return 1 if failed else 0
    if args.job == "test":
        metrics = trainer.test(reader, feeder)
        print(json.dumps({"job": "test", **metrics}))
        return 0

    test_reader = _build_reader(ds, opt, test=True)[0] if ds.test_list \
        else None
    trainer.train(reader, num_passes=args.num_passes, feeder=feeder,
                  test_reader=test_reader)
    # Trainer.train saved every --saving_period passes; the last pass
    # is saved here unless it already was
    last = int(FLAGS.get("start_pass")) + args.num_passes - 1
    period = FLAGS.get("saving_period")
    if args.save_dir and not (period and (last + 1) % period == 0):
        trainer.save(args.save_dir, last)
    return 0


def cmd_merge_model(args) -> int:
    """``paddle_merge_model`` (``paddle/trainer/MergeModel.cpp``): config
    + trained parameters → ONE self-contained model file."""
    from .config.config_parser import parse_config
    from .trainer import interop

    model, _opt, _ds = parse_config(args.config_file, args.config_args)
    model = interop.with_full_param_specs(model)
    params = interop.checkpoint_to_params(args.model_dir)
    if not params:  # reference raw-buffer pass-%05d layout
        params = interop.load_reference_model_dir(args.model_dir, model)
    missing = [p.name for p in model.parameters if p.name not in params]
    if missing:
        log.error("model_dir %s lacks parameters: %s", args.model_dir,
                  missing)
        return 1
    interop.merge_model(model, params, args.model_file)
    print(json.dumps({"job": "merge_model", "out": args.model_file,
                      "parameters": len(model.parameters)}))
    return 0


def cmd_dump_config(args) -> int:
    """``dump_config``/``show_pb`` equivalent
    (``python/paddle/utils/dump_config.py``): print the parsed model
    config (``--whole`` adds optimization + data config)."""
    from .config.config_parser import parse_config

    model, opt, ds = parse_config(args.config, args.config_args)
    if args.whole:
        payload = {"model": json.loads(model.to_json()),
                   "opt": dataclasses.asdict(opt),
                   "data": dataclasses.asdict(ds) if ds else None}
        print(json.dumps(payload, indent=1))
    else:
        print(model.to_json())
    return 0


def cmd_diagram(args) -> int:
    """``make_model_diagram.py`` equivalent: config → graphviz DOT."""
    from .config.config_parser import parse_config
    from .utils.model_diagram import model_to_dot

    model, _, _ = parse_config(args.config, args.config_args)
    print(model_to_dot(model))
    return 0


def cmd_master(args) -> int:
    """Standalone data-task master (the reference's standalone
    coordinator binaries: ``paddle pserver`` / ``go/cmd/master``) — serve
    the C++ task-lease service over TCP for remote trainers."""
    import signal
    import time

    from .data import recordio as rio
    from .distributed import Master

    m = Master(timeout_s=args.task_timeout, failure_max=args.failure_max,
               snapshot_path=args.snapshot or "")
    if args.dataset:
        payloads = rio.chunk_payloads(args.dataset) if args.chunked \
            else rio.expand_paths(args.dataset)
        m.set_dataset(payloads)
        print(f"dataset: {len(payloads)} task(s)")
    port = m.serve(args.port, bind_any=not args.local_only)
    print(f"master serving on :{port}", flush=True)
    stop = []
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    signal.signal(signal.SIGINT, lambda *_: stop.append(1))
    last_snap = time.time()
    while not stop:
        time.sleep(0.5)
        if args.snapshot and time.time() - last_snap >= args.snapshot_period:
            m.snapshot()
            last_snap = time.time()
    if args.snapshot:
        m.snapshot()
    return 0


def cmd_version(_args) -> int:
    import torch

    from . import __version__
    device = torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "no CUDA device"
    print(f"paddle_tpu_torch {__version__} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {device})")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="paddle",
                                     description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)

    tp = sub.add_parser("train", help="train/test/time/checkgrad a config")
    tp.add_argument("--config", required=True)
    tp.add_argument("--job", default="train",
                    choices=["train", "test", "time", "checkgrad"])
    tp.add_argument("--config_args", default=FLAGS.get("config_args"),
                    help=FLAGS.specs["config_args"][1])
    tp.add_argument("--num_passes", type=int, default=1)
    tp.add_argument("--save_dir", default="")
    tp.add_argument("--init_model_path", default="")
    tp.add_argument("--test_period", type=int,
                    default=FLAGS.get("test_period"),
                    help="--job train: 0 tests once a pass (N > 0 is not "
                         "ported); --job time: the number of timed "
                         "batches (0: 20)")
    tp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the CUDA card (default) or, asked for, "
                         "the plain PyTorch versions on the CPU")
    tp.add_argument("--distributed", action="store_true",
                    help="join the job's process group from the "
                         "PADDLE_* environment (one process a device)")
    tp.add_argument("--mesh_shape", default="",
                    help="e.g. data=4,model=2 over the job's processes "
                         "(replaces --trainer_count)")
    tp.add_argument("--fsdp", action="store_true", default=None,
                    help="shard parameters and optimizer state over the "
                         "'data' axis (sets the --fsdp flag)")
    tp.add_argument("--log_level", default="",
                    help="framework log level "
                         "(debug|info|warning|error|fatal)")
    # the telemetry core's options, and the fleet and health options
    # (not ported: A10b)
    for name in ("metrics_jsonl", "trace_jsonl", "metrics_bind",
                 "fleet_addr", "fleet_id"):
        tp.add_argument(f"--{name}", default=None)
    for name in ("metrics_port", "fleet_port", "health_interval"):
        tp.add_argument(f"--{name}", type=int, default=None)
    tp.add_argument("--metrics_interval_s", type=float, default=None)
    tp.add_argument("--debug_dump_signal", action="store_true")
    tp.set_defaults(fn=cmd_train)

    mp = sub.add_parser(
        "merge_model",
        help="fuse config + trained parameters into one model file")
    mp.add_argument("--model_dir", required=True,
                    help="pass-%%05d checkpoint dir (ours or reference "
                         "raw-buffer layout)")
    mp.add_argument("--config_file", required=True)
    mp.add_argument("--model_file", required=True,
                    help="output merged model path")
    mp.add_argument("--config_args", default=FLAGS.get("config_args"))
    mp.set_defaults(fn=cmd_merge_model)

    dp = sub.add_parser("dump_config",
                        help="parse a config file and print the model IR")
    dp.add_argument("config")
    dp.add_argument("config_args", nargs="?",
                    default=FLAGS.get("config_args"))
    dp.add_argument("--whole", action="store_true",
                    help="include optimization + data config")
    dp.set_defaults(fn=cmd_dump_config)

    gp = sub.add_parser("diagram",
                        help="emit a graphviz DOT diagram of a config")
    gp.add_argument("config")
    gp.add_argument("config_args", nargs="?",
                    default=FLAGS.get("config_args"))
    gp.set_defaults(fn=cmd_diagram)

    sp = sub.add_parser(
        "master",
        help="serve the standalone data-task master (pserver-era "
             "coordinator)")
    sp.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral, printed on start)")
    sp.add_argument("--dataset", nargs="*", default=[],
                    help="task payloads: file paths / globs")
    sp.add_argument("--chunked", action="store_true",
                    help="expand record files into per-chunk tasks")
    sp.add_argument("--task_timeout", type=float, default=60.0)
    sp.add_argument("--failure_max", type=int, default=3)
    sp.add_argument("--snapshot", default="",
                    help="snapshot/recover state file (written every "
                         "--snapshot_period seconds and on shutdown)")
    sp.add_argument("--snapshot_period", type=float, default=30.0)
    sp.add_argument("--local_only", action="store_true",
                    help="bind loopback instead of all interfaces")
    sp.add_argument("--fleet_port", type=int, default=None,
                    help="the fleet telemetry aggregator (not ported: "
                         "A10b)")
    sp.add_argument("--fleet_bind", default=None,
                    help="aggregator bind address (not ported: A10b)")
    sp.set_defaults(fn=cmd_master)

    vp = sub.add_parser("version", help="print build info")
    vp.set_defaults(fn=cmd_version)

    args = parser.parse_args(argv)
    _refuse_unported(args)
    if getattr(args, "mesh_shape", ""):
        FLAGS.set("mesh_shape", args.mesh_shape)
    if getattr(args, "fsdp", None) is not None:
        FLAGS.set("fsdp", bool(args.fsdp))
    if getattr(args, "log_level", "") or FLAGS.get("log_level"):
        from .utils import set_log_level
        if getattr(args, "log_level", ""):
            FLAGS.set("log_level", args.log_level)
        set_log_level(FLAGS.get("log_level"))
    for name in _OBSERVE_OPTIONS:
        value = getattr(args, name, None)
        if value not in (None, "", False):
            FLAGS.set(name, value)
    # umbrella: --metrics_jsonl reporter, --trace_jsonl span sink,
    # --metrics_port endpoint, --debug_dump_signal handler — each a
    # no-op when its flag is unset (no thread starts)
    from . import observe
    observe.start_from_flags()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
