"""The port's ``paddle train`` CLI (``python -m paddle_tpu_torch``,
``paddle_tpu_torch/cli.py``) against the JAX package's
(``python -m paddle_tpu``), on ``configs/rnn.py``.

- ``dump_config --whole``: the same standard output, byte for byte.
- ``train``: both CLIs train one pass of a tiny ``configs/rnn.py`` (H 16,
  V 50, B 8, 32 samples of 100 ids) from one checkpoint the JAX trainer
  wrote (``--init_model_path``); their pass-00000 ``params.npz`` agree
  within atol 1e-5, and the port's ``--job test`` from it gives the JAX
  trainer's ``test_cost`` within rtol 1e-5 (the Adam trajectory's
  tolerances of ``test_torch_train.py``).  The port's ``train`` job writes the bytes
  ``Trainer(seed=1).train`` writes in process.
- ``--job test`` / ``time`` / ``checkgrad`` print the reference CLI's
  JSON keys; ``diagram`` and ``merge_model`` write what the reference's
  helpers write; the telemetry options (the fleet and health ones
  too) set their flags and start their surfaces; a test every
  ``--test_period`` batches refuses, as neither CLI has one.
- The cluster options: ``--distributed`` with no ``PADDLE_COORDINATOR``
  trains in the one process, ``--mesh_shape`` names a mesh that must
  match the process count (the JAX package's check), a coordinator
  without ``PADDLE_NUM_NODES`` / ``PADDLE_NODE_ID`` is exit code 2, the
  ``master`` subcommand serves a record file's chunks over TCP, and a
  config's ``local_sgd_steps`` selects ``LocalSGDTrainer``.

The port's CLI runs in process inside the :func:`paddle_aliases`
block (its ``paddle`` aliases and the config's ``provider`` module are
moved aside and restored), and with ``--device cpu``.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from paddle_tpu.config import config_parser as jparser
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu_torch import cli
from paddle_tpu_torch.utils import FLAGS, PaddleTpuError

from test_torch_config_parser import RNN, paddle_aliases  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "hidden_size=16,vocab_size=50,batch_size=8,num_samples=32"
#: costs rtol 1e-5 and parameters after the pass atol 1e-5: the Adam
#: trajectory's tolerances of test_torch_train.py (Adam divides each
#: gradient by its own root mean square, so a parameter of small
#: magnitude has no relative bound)
RTOL, PARAM_ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's CPU path at H 16 is thousands of tiny ops a step: one
    intra-op thread each, so a loaded machine's other workers do not
    stall them."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(module, *argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    r = subprocess.run([sys.executable, "-m", module, *argv],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture
def port_cli(paddle_aliases, capsys):  # noqa: F811
    """``cli.main`` in process inside the alias block, ``sys.path`` and
    the flags the CLI sets put back after it: the JSON of its last
    line (None when it printed none)."""
    saved_path = list(sys.path)
    saved = {k: FLAGS.get(k) for k in ("save_dir", "log_level")}

    def run(*argv):
        capsys.readouterr()
        with paddle_aliases():
            rc = cli.main(list(argv))
        out = capsys.readouterr().out.strip().splitlines()
        return rc, (json.loads(out[-1]) if out else None)

    yield run
    sys.path[:] = saved_path
    for k, v in saved.items():
        FLAGS.set(k, v)


def test_dump_config_stdout_equals_the_jax_cli():
    argv = ("dump_config", "--whole", RNN, "hidden_size=16,lstm_num=3")
    assert _run("paddle_tpu_torch", *argv) == _run("paddle_tpu", *argv)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """pass-00000 of the JAX trainer on the tiny config (its own init,
    seed 3, before any step)."""
    model, opt, _ = jparser.parse_config(RNN, TINY)
    root = tmp_path_factory.mktemp("jax_init")
    JTrainer(JNet(model), opt_config=opt, seed=3).save(str(root), 0)
    return str(root / "pass-00000")


def test_cli_training_matches_the_jax_cli(port_cli, jax_checkpoint,
                                          tmp_path):
    common = ("train", "--config", RNN, "--config_args", TINY,
              "--num_passes", "1", "--init_model_path", jax_checkpoint)
    _run("paddle_tpu", *common, "--save_dir", str(tmp_path / "j"))
    rc, _ = port_cli(*common, "--save_dir", str(tmp_path / "t"),
                     "--device", "cpu")
    assert rc == 0
    with np.load(tmp_path / "j" / "pass-00000" / "params.npz") as j, \
            np.load(tmp_path / "t" / "pass-00000" / "params.npz") as t:
        assert sorted(t.files) == sorted(j.files) and len(j.files) == 9
        init = np.load(os.path.join(jax_checkpoint, "params.npz"))
        for k in j.files:
            assert not np.array_equal(j[k], init[k]), k
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)

    # --job test from the port's trained checkpoint against the JAX
    # trainer's test on it (the provider's samples, drawn here)
    ckpt = str(tmp_path / "t" / "pass-00000")
    rc, got = port_cli("train", "--job", "test", "--config", RNN,
                       "--config_args", TINY, "--init_model_path", ckpt,
                       "--device", "cpu")
    assert rc == 0 and set(got) == {"job", "test_cost"}
    from paddle_tpu.data.feeder import (DataFeeder, integer_value,
                                        integer_value_sequence)
    from paddle_tpu.data.reader import batch
    rng = np.random.RandomState(0)
    samples = [(rng.randint(0, 50, 100).tolist(), int(rng.randint(2)))
               for _ in range(32)]
    model, opt, _ = jparser.parse_config(RNN, TINY)
    jtr = JTrainer(JNet(model), opt_config=opt, seed=3)
    jtr.load(ckpt)
    want = jtr.test(batch(lambda: iter(samples), 8), DataFeeder(
        [("data", integer_value_sequence(50)), ("label", integer_value(2))]))
    np.testing.assert_allclose(got["test_cost"], want["test_cost"],
                               rtol=RTOL)


def test_time_and_checkgrad_jobs_print_the_reference_keys(port_cli):
    rc, out = port_cli("train", "--job", "time", "--config", RNN,
                       "--config_args", TINY + ",num_samples=40",
                       "--test_period", "2", "--device", "cpu")
    assert rc == 0
    assert out.keys() == {"job", "ms_per_batch", "samples_per_sec",
                          "batches"}
    assert out["job"] == "time" and out["batches"] == 2
    rc, out = port_cli("train", "--job", "checkgrad", "--config", RNN,
                       "--config_args", TINY, "--device", "cpu")
    assert (rc, out) == (0, {"job": "checkgrad", "checked": 9,
                             "failed": 0})


def test_train_job_is_trainer_train(port_cli, paddle_aliases,  # noqa: F811
                                    tmp_path):
    """``train --save_dir D`` writes the pass-00000 ``params.npz`` that
    ``Trainer(seed=1).train`` writes in process from the same config and
    provider samples, byte for byte (the CPU counterpart of
    chip_smoke's 4z-cli)."""
    import importlib
    from paddle_tpu_torch import compat
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.data import (DataFeeder, integer_value,
                                       integer_value_sequence, reader)
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import lstm_text_classifier
    from paddle_tpu_torch.trainer.trainer import Trainer
    cli_dir, own_dir = tmp_path / "cli", tmp_path / "own"
    assert port_cli("train", "--config", RNN, "--config_args", TINY,
                    "--device", "cpu", "--save_dir", str(cli_dir))[0] == 0
    sys.path.insert(0, os.path.dirname(RNN))
    try:
        with paddle_aliases():
            compat.install()
            provider = importlib.import_module("provider").process_rnn
    finally:
        sys.path.remove(os.path.dirname(RNN))
    trainer = Trainer(
        NeuralNetwork(lstm_text_classifier(50, 128, 16, 2, 2)),
        OptimizationConfig(batch_size=8, learning_method="adam",
                           learning_rate=2e-3, l2_weight_decay=8e-4,
                           gradient_clipping_threshold=25),
        seed=1, device="cpu")
    feeder = DataFeeder([("data", integer_value_sequence(50)),
                         ("label", integer_value(2))])
    FLAGS.set("save_dir", str(own_dir))
    trainer.train(reader.batch(provider.reader(
        vocab_size=50, maxlen=100, num_samples=32), 8), 1, lambda e: None,
        feeder)
    got, want = (open(d / "pass-00000" / "params.npz", "rb").read()
                 for d in (cli_dir, own_dir))
    assert got == want


@pytest.mark.parametrize("saving_period", [1, 2])
def test_train_job_tests_each_pass_and_saves_the_last_once(
        port_cli, monkeypatch, tmp_path, saving_period):
    """A config whose data source has a ``test_list`` is tested once a
    pass by ``--job train``, and the last pass is written once, by
    ``Trainer.train`` at ``--saving_period`` 1 and by the CLI after it
    otherwise."""
    import shutil
    from paddle_tpu_torch.trainer.trainer import Trainer
    shutil.copy(os.path.join(os.path.dirname(RNN), "provider.py"), tmp_path)
    config = tmp_path / "rnn_test_list.py"
    text = open(RNN).read()
    assert "define_py_data_sources2(None, None," in text
    config.write_text(text.replace("define_py_data_sources2(None, None,",
                                   "define_py_data_sources2(None, 'test.list',"))
    calls = []
    test, save = Trainer.test, Trainer.save
    monkeypatch.setattr(Trainer, "test", lambda self, *a, **k: (
        calls.append("test"), test(self, *a, **k))[1])
    monkeypatch.setattr(Trainer, "save", lambda self, d, pass_id: (
        calls.append(("save", pass_id)), save(self, d, pass_id))[1])
    old = FLAGS.get("saving_period")
    FLAGS.set("saving_period", saving_period)
    try:
        rc, _ = port_cli("train", "--config", str(config), "--config_args",
                         "hidden_size=16,vocab_size=50,batch_size=8,"
                         "num_samples=16", "--num_passes", "1",
                         "--save_dir", str(tmp_path / "out"),
                         "--device", "cpu")
    finally:
        FLAGS.set("saving_period", old)
    assert rc == 0 and calls == ["test", ("save", 0)]
    assert os.listdir(tmp_path / "out") == ["pass-00000"]


def test_config_args_and_test_period_default_to_their_flags(port_cli):
    old = {k: FLAGS.get(k) for k in ("config_args", "test_period")}
    FLAGS.set("config_args", TINY + ",num_samples=40")
    FLAGS.set("test_period", 2)
    try:
        rc, out = port_cli("train", "--job", "time", "--config", RNN,
                           "--device", "cpu")
    finally:
        for k, v in old.items():
            FLAGS.set(k, v)
    assert rc == 0 and out["batches"] == 2


def test_diagram_is_the_reference_dot(paddle_aliases, capsys):  # noqa: F811
    from paddle_tpu.utils.model_diagram import model_to_dot
    model, _, _ = jparser.parse_config(RNN, TINY)
    capsys.readouterr()
    with paddle_aliases():
        assert cli.main(["diagram", RNN, TINY]) == 0
    assert capsys.readouterr().out.strip() == model_to_dot(model).strip()


def test_merge_model_of_a_jax_checkpoint(port_cli, jax_checkpoint,
                                         tmp_path):
    from paddle_tpu.trainer import interop as jinterop
    out = tmp_path / "model.bin"
    rc, printed = port_cli("merge_model", "--model_dir", jax_checkpoint,
                           "--config_file", RNN, "--config_args", TINY,
                           "--model_file", str(out))
    assert rc == 0 and printed == {"job": "merge_model", "out": str(out),
                                   "parameters": 9}
    model, params = jinterop.load_merged_model(str(out))
    with np.load(os.path.join(jax_checkpoint, "params.npz")) as want:
        assert sorted(params) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(params[k], want[k])


def test_version_names_torch(capsys):
    import torch
    assert cli.main(["version"]) == 0
    out = capsys.readouterr().out
    assert "paddle_tpu_torch" in out and torch.__version__ in out


@pytest.mark.parametrize("extra,queue", [
    pytest.param(["--test_period", "2"],
                 "reference's CLI has no such test", id="extra6-A8")])
def test_unported_train_options_refuse_by_name(extra, queue):
    """A test every ``--test_period`` batches of ``--job train`` refuses
    before the job runs: neither CLI has one."""
    with pytest.raises(PaddleTpuError, match=queue):
        cli.main(["train", "--config", RNN, "--device", "cpu", *extra])


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("option", ["fleet_addr", "fleet_port", "fleet_id",
                                    "health_interval"])
def test_fleet_and_health_options_set_their_flags(option, monkeypatch):
    """``train --fleet_addr / --fleet_port / --fleet_id /
    --health_interval`` set the flag of their name before the job runs,
    as the reference's CLI does, and ``observe.start_from_flags`` starts
    the push client or the aggregator they configure."""
    from paddle_tpu_torch import observe
    value = {"fleet_addr": f"127.0.0.1:{_free_port()}",
             "fleet_port": _free_port(), "fleet_id": "trainer-7",
             "health_interval": 5}[option]
    seen = {}
    monkeypatch.setattr(cli, "cmd_train", lambda args: seen.update(
        value=FLAGS.get(option), reporter=observe.report._global,
        hosting=observe.fleet.hosting()) or 0)
    saved = FLAGS.get(option)
    try:
        assert cli.main(["train", "--config", RNN, "--device", "cpu",
                         f"--{option}", str(value)]) == 0
    finally:
        observe.stop_global()
        FLAGS.set(option, saved)
    assert seen["value"] == value
    if option == "fleet_addr":
        assert seen["reporter"].fleet.addr == value
    assert seen["hosting"] == (option == "fleet_port")


@pytest.mark.parametrize("extra", [["--distributed"],
                                   ["--mesh_shape", "data=2"]])
def test_cluster_train_options(port_cli, tmp_path, extra):
    """``--distributed`` without ``PADDLE_COORDINATOR`` joins nothing
    and trains in this process; ``--mesh_shape data=2`` in a one-process
    job fails the mesh's device count, as the JAX package's does."""
    from paddle_tpu_torch.core import device
    saved = FLAGS.get("mesh_shape")
    argv = ("train", "--config", RNN, "--config_args", TINY, "--device",
            "cpu", "--num_passes", "1", "--save_dir", str(tmp_path / "out"),
            *extra)
    try:
        if extra[0] == "--distributed":
            assert port_cli(*argv)[0] == 0
        else:
            with pytest.raises(PaddleTpuError,
                               match=r"mesh \{'data': 2\} needs 2 devices, "
                                     r"have 1"):
                port_cli(*argv)
    finally:
        FLAGS.set("mesh_shape", saved)
        device.set_mesh(None)


def _free_port():
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.status, r.read().decode()


@pytest.fixture
def observe_state():
    """The telemetry flags and the process-wide surfaces put back after
    the test (the reporter, trace sink, endpoint, SIGUSR2 handler and
    SIGTERM hook the CLI starts)."""
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.observe import dump
    from paddle_tpu_torch.utils.logger import reset_warn_once
    names = ("metrics_jsonl", "metrics_interval_s", "trace_jsonl",
             "metrics_port", "metrics_bind", "debug_dump_signal")
    old = {k: FLAGS.get(k) for k in names}
    old_usr2 = signal.getsignal(signal.SIGUSR2)
    yield
    observe.stop_global()
    signal.signal(signal.SIGUSR2, old_usr2)
    dump._installed = False
    for k, v in old.items():
        FLAGS.set(k, v)
    observe.REGISTRY.reset()
    reset_warn_once()


@pytest.mark.parametrize("option", [
    "metrics_jsonl", "metrics_interval_s", "trace_jsonl", "metrics_port",
    "metrics_bind", "debug_dump_signal"])
def test_ported_observability_options_take_effect(option, tmp_path,
                                                  monkeypatch,
                                                  observe_state):
    """Each of the six telemetry options of ``train`` sets its flag and
    starts what it configures before the job runs (the job is stubbed
    here; ``Trainer.train``'s own wiring is tested in
    test_torch_observe.py)."""
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.observe import dump, http as ohttp, report, trace
    sink, tr_path, port = (str(tmp_path / "m.jsonl"),
                           str(tmp_path / "t.json"), _free_port())
    argv = {"metrics_jsonl": ["--metrics_jsonl", sink],
            "metrics_interval_s": ["--metrics_jsonl", sink,
                                   "--metrics_interval_s", "0.25"],
            "trace_jsonl": ["--trace_jsonl", tr_path],
            "metrics_port": ["--metrics_port", str(port)],
            "metrics_bind": ["--metrics_port", str(port),
                             "--metrics_bind", "localhost"],
            "debug_dump_signal": ["--debug_dump_signal"]}[option]
    seen = {}

    def job(args):
        seen.update(active=observe.active(), tracing=trace.enabled(),
                    fences=trace.fences_steps(), serving=ohttp.serving(),
                    dump=dump._installed,
                    usr2=signal.getsignal(signal.SIGUSR2),
                    reporter=report._global)
        if seen["serving"]:
            seen["healthz"] = _get(port, "/healthz")
        return 0

    monkeypatch.setattr(cli, "cmd_train", job)
    assert cli.main(["train", "--config", RNN, "--device", "cpu",
                     *argv]) == 0
    want = {"metrics_jsonl": sink, "metrics_interval_s": 0.25,
            "trace_jsonl": tr_path, "metrics_port": port,
            "metrics_bind": "localhost", "debug_dump_signal": True}[option]
    assert FLAGS.get(option) == want
    if option in ("metrics_jsonl", "metrics_interval_s"):
        assert seen["active"]
        assert seen["reporter"].interval_s == FLAGS.get("metrics_interval_s")
        with open(sink) as f:                 # the start-up probe's line
            assert "metrics" in json.loads(f.readline())
    elif option == "trace_jsonl":
        assert seen["tracing"] and seen["fences"]
        observe.stop_global()
        with open(tr_path) as f:
            assert json.load(f) == []
    elif option in ("metrics_port", "metrics_bind"):
        assert seen["serving"] and not seen["tracing"]
        code, body = seen["healthz"]
        assert code == 200 and json.loads(body)["status"] == "ok"
    else:
        assert seen["dump"] and seen["usr2"] is dump._handler
        assert not seen["active"] and not seen["serving"]


def test_coordinator_and_master_refuse_by_name(monkeypatch, tmp_path):
    """``master --chunked`` serves a record file's chunks as tasks over
    TCP (the JAX package's client leases them) and snapshots on SIGTERM;
    ``PADDLE_COORDINATOR`` without ``PADDLE_NUM_NODES`` /
    ``PADDLE_NODE_ID`` is exit code 2 before any step, as in the JAX
    CLI.  ``master --fleet_port`` hosts the fleet aggregator beside the
    master."""
    from paddle_tpu.distributed.master import MasterClient as JClient
    from paddle_tpu_torch.data import recordio as rio
    rec = str(tmp_path / "d.rec")
    with rio.Writer(rec, max_records_per_chunk=2) as w:
        for i in range(5):
            w.write(str(i).encode())
    snap = str(tmp_path / "snap")
    fport = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "master", "--port", "0",
         "--dataset", rec, "--chunked", "--local_only", "--snapshot", snap,
         "--fleet_port", str(fport)],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "dataset: 3 task(s)"
        port = int(proc.stdout.readline().strip().rsplit(":", 1)[1])
        with JClient(f"127.0.0.1:{port}", retry_max=0) as c:
            tid, payload = c.get_task()
            assert payload == f"{rec}\t{rio.load_index(rec)[0][0]}"
            assert c.counts() == {"todo": 2, "pending": 1, "done": 0,
                                  "failed": 0}
        from paddle_tpu_torch.observe import fleet
        assert json.loads(fleet._http_get(f"127.0.0.1:{fport}",
                                          "/fleet/healthz"))["status"] \
            == "empty"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    assert os.path.exists(snap)
    monkeypatch.setenv("PADDLE_COORDINATOR", "localhost:1")
    monkeypatch.delenv("PADDLE_NUM_NODES", raising=False)
    assert cli.main(["train", "--config", RNN, "--device", "cpu"]) == 2


@pytest.mark.parametrize("rank", [0, 1, 5])
def test_distributed_train_puts_each_rank_on_its_card(monkeypatch, rank):
    """``train --distributed`` on CUDA: rank r of the job joins the
    process group on card ``r mod <card count>`` (one process a device),
    not on the current card.  The card and the process group are stubbed:
    the job stops at ``init_process_group``."""
    import torch
    import torch.distributed as dist

    class Joined(Exception):
        pass

    seen = {}

    def init_process_group(**kw):
        seen.update(kw)
        raise Joined

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.setdefault("card", torch.device(d)))
    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    monkeypatch.setenv("PADDLE_COORDINATOR", "localhost:1")
    monkeypatch.setenv("PADDLE_NUM_NODES", "6")
    monkeypatch.setenv("PADDLE_NODE_ID", str(rank))
    with pytest.raises(Joined):
        cli.main(["train", "--config", RNN, "--distributed"])
    assert seen["card"] == torch.device("cuda", rank % 4)
    assert seen["backend"] == "nccl" and seen["rank"] == rank
    assert seen["world_size"] == 6


def test_local_sgd_setting_refuses_by_name(port_cli, monkeypatch, tmp_path):
    """A config's ``local_sgd_steps`` selects ``LocalSGDTrainer`` (the
    JAX CLI's ``make_trainer``); on one process it trains as the plain
    trainer does."""
    from paddle_tpu_torch.parallel import local_sgd
    made = []
    real = local_sgd.make_trainer

    def spy(net, opt, **kw):
        made.append(real(net, opt, **kw))
        return made[-1]

    monkeypatch.setattr(local_sgd, "make_trainer", spy)
    cfg_dir = os.path.dirname(RNN)
    with open(RNN) as f:
        text = f.read().replace("settings(", "settings(local_sgd_steps=2, ")
    path = tmp_path / "rnn_local_sgd.py"
    path.write_text(text)
    shutil.copy(os.path.join(cfg_dir, "provider.py"), tmp_path)
    rc, _ = port_cli("train", "--config", str(path), "--device", "cpu",
                     "--config_args", TINY, "--save_dir",
                     str(tmp_path / "out"))
    assert rc == 0
    assert type(made[0]).__name__ == "LocalSGDTrainer"
    assert made[0].local_steps == 2 and made[0]._step_count == 4
