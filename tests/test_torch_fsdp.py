"""FSDP over the ``data`` axis in the port (``Trainer(fsdp=True)``,
``parallel/sharding.py``, ``parallel/rule_tables.py``, the sharded
checkpoint of ``trainer/checkpoint.py``) against the JAX package's
``tests/test_fsdp.py``, case for case.

Without processes: ``fsdp_spec``, ``match_partition_rules``, the
rank fall-through warning, the five zoo tables (verified clean on an
8-way mesh shape, their specs the JAX tables', the big parameters
sharded), the unknown-family error, and the kill switch: ``--fsdp`` on a
``{data: 1}`` mesh resolves to nothing and trains byte for byte as
``--fsdp=false``.

Four spawned port ranks over gloo (once for the module,
``tests/torch_dist_workers.py``), on the JAX test's transformer (T 8,
D 64, 2 heads, 1 layer, ffn 128, V 512, B 16) with
``transformer_fsdp_rules``, from the JAX trainer's parameters:

- the parameters and Adam slots rest sharded (DTensors);
- the per-rank ``hbm_category_bytes{params,opt_state}`` gauges fall
  ≥ 3.5× at 4 ranks (the JAX test asks ≥ 4× at 8);
- the loss trajectory equals the replicated run's (rtol 2e-5, atol
  1e-7, the JAX test's) and the JAX FSDP trainer's on a 4-device mesh
  (rtol 1e-4: two packages' transformer forwards);
- sharded checkpoints: the manifest's digests cover every shard file; a
  4-way port checkpoint loads into the JAX trainer on 8 and 1 devices
  and into a one-process port trainer, byte for byte; an 8-way JAX
  checkpoint loads onto the 4 ranks (re-placed, sharded again);
- a flipped bit in one shard file quarantines the whole dir, and resume
  lands on the previous checkpoint.
"""

import os

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.core.device import build_mesh as jbuild_mesh
from paddle_tpu.core.device import set_mesh as jset_mesh
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.data.feeder import dense_vector, integer_value
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.models import lstm_text_classifier as j_lstm
from paddle_tpu.models import transformer_text_classifier as j_transformer
from paddle_tpu.models.image import resnet_cifar10 as j_resnet_cifar10
from paddle_tpu import parallel as jpar
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu_torch import parallel as tpar
from paddle_tpu_torch.analysis import netcheck
from paddle_tpu_torch.config.model_config import ModelConfig
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.core.device import DATA_AXIS, Mesh, P
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.testing import fault
from paddle_tpu_torch.trainer import checkpoint as tck
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from paddle_tpu_torch.utils import logger as tlogger

from torch_dist_workers import run_cases, run_ranks, to_feed

T, D, HEADS, L, F, V, B = 8, 64, 2, 1, 128, 512, 16
OPT = dict(learning_method="adam", learning_rate=1e-3,
           gradient_clipping_threshold=25.0)


def _cfg():
    return j_transformer(vocab_size=V, model_dim=D, num_heads=HEADS,
                         num_layers=L, ffn_dim=F, num_classes=2, max_len=T)


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"data": ("seq", rng.randint(0, V, (B, T)).astype(np.int32),
                     np.full((B,), T, np.int32)),
            "label": rng.randint(0, 2, (B,)).astype(np.int32)}


def _jfeed(feed):
    return {k: JSeq(jax.numpy.asarray(v[1]), jax.numpy.asarray(v[2]))
            if isinstance(v, tuple) else jax.numpy.asarray(v)
            for k, v in feed.items()}


def _jtrainer(n, fsdp=True, axes=None):
    mesh = jbuild_mesh(axes or {"data": n}, jax.devices()[:n])
    jset_mesh(mesh)
    return JTrainer(JNet(_cfg()), opt_config=JOpt(**OPT), mesh=mesh,
                    seed=0, fsdp=fsdp,
                    fsdp_rules=jpar.transformer_fsdp_rules())


# ===================================================== rule plumbing
def test_fsdp_spec_shards_largest_divisible_dim():
    assert tpar.fsdp_spec((1024, 30), 8) == P(DATA_AXIS, None)
    assert tpar.fsdp_spec((30, 1024), 8) == P(None, DATA_AXIS)
    assert tpar.fsdp_spec((7, 5), 8) == P()
    assert tpar.fsdp_spec((8, 8), 8, min_size=1024) == P()
    assert tpar.fsdp_spec((8, 8), 8, min_size=1) == P(DATA_AXIS, None)
    assert tpar.fsdp_spec((), 8) == P()
    for shape in [(1024, 30), (30, 1024), (64, 64), (96, 48, 8), (7, 5),
                  (4096,), (12, 512, 3), (2048, 4096)]:
        for n in (2, 4, 8):
            assert tuple(tpar.fsdp_spec(shape, n)) == \
                tuple(jpar.fsdp_spec(shape, n)), (shape, n)


def test_match_partition_rules_resolves_per_name():
    dims = {"___embedding_1__.w0": (V, D), "_attn0._ln_q.wbias": (D,),
            "_ffn0_in.w0": (D, F)}
    got = tpar.match_partition_rules(tpar.transformer_fsdp_rules(), dims)
    want = jpar.match_partition_rules(jpar.transformer_fsdp_rules(), dims)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    assert got["___embedding_1__.w0"] == P(DATA_AXIS, None)


def test_spec_for_rank_fallthrough_warns_once():
    tlogger.reset_warn_once()
    rules = tpar.ShardingRules([(r"emb", P(None, DATA_AXIS)), (r".", P())])
    assert rules.spec_for("emb.w0", 1) == P()
    keys = [k for k in tlogger._warned
            if k.startswith("sharding.rank_excluded")]
    assert len(keys) == 1 and "emb.w0" in keys[0]
    assert rules.spec_for("emb.w0", 1) == P()
    assert len([k for k in tlogger._warned
                if k.startswith("sharding.rank_excluded")]) == 1
    assert rules.spec_for("emb.w0", 2) == P(None, DATA_AXIS)


@pytest.fixture(scope="module")
def zoo_dims():
    dims = {"transformer": tpar.param_dims_of(TNet(ModelConfig.from_json(
                _cfg().to_json()))),
            "lstm": tpar.param_dims_of(TNet(ModelConfig.from_json(j_lstm(
                vocab_size=1024, embed_dim=64, hidden_size=64, lstm_num=2,
                num_classes=2).to_json())))}
    with jdsl.config_scope():
        img = jdsl.data("image", dense_vector(3 * 32 * 32), height=32,
                        width=32)
        cost = jdsl.classification_cost(
            j_resnet_cifar10(img, depth=20, num_classes=10),
            jdsl.data("label", integer_value(10)))
        dims["resnet"] = tpar.param_dims_of(TNet(ModelConfig.from_json(
            jdsl.topology(cost).to_json())))
    dims["ctr"] = {"_slot_emb.w0": [100000, 16], "_fc_wide.w0": [13, 16],
                   "_fc_wide.wbias": [16], "_fc_1.w0": [16, 32],
                   "_fc_2.w0": [48, 32], "_ctr_head.w0": [32, 2],
                   "_ctr_head.wbias": [2]}
    dims["recommender"] = {"_usr_emb.w0": [80000, 32],
                           "_mov_emb.w0": [40000, 32],
                           "___embedding_3__.w0": [2, 8],
                           "___fc_2__.w0": [32, 32],
                           "___fc_2__.wbias": [32]}
    return dims


def test_zoo_rule_tables_verify_clean_on_8way_mesh(zoo_dims):
    """Every table verifies with no error on ``{data: 8}``, its findings
    are the JAX verifier's, and each parameter resolves to the JAX
    table's spec."""
    assert sorted(tpar.ZOO_FSDP_RULES) == sorted(jpar.ZOO_FSDP_RULES)
    for family, rules_fn in tpar.ZOO_FSDP_RULES.items():
        issues = rules_fn().verify(zoo_dims[family], {"data": 8})
        assert not netcheck.errors(issues), family
        jissues = jpar.ZOO_FSDP_RULES[family]().verify(zoo_dims[family],
                                                       {"data": 8})
        assert [i.render() for i in issues] == \
            [i.render() for i in jissues]
        for name, dims in zoo_dims[family].items():
            assert tuple(rules_fn().spec_for(name, len(dims))) == \
                tuple(jpar.ZOO_FSDP_RULES[family]().spec_for(
                    name, len(dims))), (family, name)
    bad = tpar.ShardingRules([(r".", P(None, "model"))])
    with pytest.raises(tpar.sharding.PaddleTpuError,
                       match="does not exist"):
        tpar.verify_rules_or_raise(bad, {"a.w0": [4, 4]}, {"data": 8})


def test_zoo_rule_tables_actually_shard_the_big_params(zoo_dims):
    for family, rules_fn in tpar.ZOO_FSDP_RULES.items():
        rules = rules_fn()
        sharded = total = 0
        for name, dims in zoo_dims[family].items():
            n = int(np.prod(dims)) if dims else 1
            total += n
            if any(ax is not None for ax in rules.spec_for(name, len(dims))):
                sharded += n
        assert sharded / total > 0.5, family


def test_zoo_fsdp_rules_unknown_family_raises():
    with pytest.raises(KeyError) as ei:
        tpar.zoo_fsdp_rules("diffusion")
    assert "transformer" in str(ei.value)


def test_fsdp_kill_switch_single_chip_byte_identical():
    """``--fsdp`` on a ``{data: 1}`` mesh resolves to nothing: the same
    steps as ``--fsdp=false``, parameters byte for byte after 3."""
    torch.set_num_threads(2)
    net = ModelConfig.from_json(_cfg().to_json())
    on = TTrainer(TNet(net), TOpt(**OPT), seed=0, device="cpu",
                  mesh=Mesh({"data": 1}), fsdp=True,
                  fsdp_rules=tpar.transformer_fsdp_rules())
    off = TTrainer(TNet(net), TOpt(**OPT), seed=0, device="cpu",
                   mesh=Mesh({"data": 1}), fsdp=False)
    assert on._resolve_specs() is None
    for _ in range(3):
        on.train_one_batch(to_feed(_feed()))
        off.train_one_batch(to_feed(_feed()))
    for name, p in off.params.items():
        assert torch.equal(on.params[name], p), name


# ==================================================== the sharded step
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp")
    # the JAX trainers: the starting point, the 4-device FSDP trajectory,
    # an 8-way sharded checkpoint
    jtr = _jtrainer(4)
    init = jtr.save(str(root / "init"), 0)
    jlosses = [float(jtr.train_one_batch(_jfeed(_feed()))) for _ in range(5)]
    j8 = _jtrainer(8)
    j8.train_one_batch(_jfeed(_feed(1)))
    j8_ckpt = j8.save(str(root / "jax8"), 0)
    jset_mesh(None)
    base = {"config": _cfg().to_json(), "opt": OPT, "ckpt": init,
            "mesh": {"data": 4}, "feeds": [_feed()] * 5,
            "fsdp_rules": "transformer", "fn": "fsdp_case", "seed": 0}
    cases = {"fsdp": {**base, "fsdp": True,
                      "save_dir": str(root / "port"), "load": j8_ckpt},
             "rep": {**base, "fsdp": False}}
    # the health telemetry over sharded and replicated parameters: one
    # drain after two steps, and the same steps in one process
    for name, fsdp in (("fsdp_health", True), ("rep_health", False)):
        cases[name] = {**base, "fn": "train_case", "fsdp": fsdp,
                       "feeds": [_feed()] * 2, "single": fsdp,
                       "flags": {"health_interval": 2}}
    port = run_ranks(run_cases, 4, cases, deadline_s=150.0)
    return {"jlosses": jlosses, "j8": j8, "j8_ckpt": j8_ckpt,
            "root": root}, port


def test_fsdp_places_params_and_adam_slots_sharded(runs):
    _, port = runs
    got = port[0]["fsdp"]
    assert len(got["placed"]) >= 7, got["placed"]
    assert any("embedding" in n for n in got["placed"])
    assert got["placed_slots"] == got["placed"]
    assert port[0]["rep"]["placed"] == []


def test_fsdp_per_chip_hbm_gauges_show_4x_win(runs):
    """The gauges of every rank: params and opt_state each ≥ 3.5× below
    the replicated figures at 4 ranks (the JAX test asks ≥ 4× at 8)."""
    _, port = runs
    for r in range(4):
        f, rep = port[r]["fsdp"]["gauges"], port[r]["rep"]["gauges"]
        assert f["params"] > 0 and f["opt_state"] > 0
        assert rep["params"] / f["params"] >= 3.5, (rep, f)
        assert rep["opt_state"] / f["opt_state"] >= 3.5, (rep, f)
        # the gauges count the local shards (opt_state: the slots and
        # the step count's 4 bytes)
        assert port[r]["fsdp"]["bytes"]["params"] == f["params"]
        assert port[r]["fsdp"]["bytes"]["opt_state"] + 4 == f["opt_state"]


def test_fsdp_loss_trajectory_matches_replicated(runs):
    jax_side, port = runs
    np.testing.assert_allclose(port[0]["fsdp"]["losses"],
                               port[0]["rep"]["losses"], rtol=2e-5,
                               atol=1e-7)
    np.testing.assert_allclose(port[0]["fsdp"]["losses"],
                               jax_side["jlosses"], rtol=1e-4)
    for r in range(1, 4):
        assert port[r]["fsdp"]["losses"] == port[0]["fsdp"]["losses"]


def test_sharded_ckpt_manifest_covers_shard_files(runs):
    _, port = runs
    ckpt = port[0]["fsdp"]["saved"]
    names = os.listdir(ckpt)
    shard_files = [n for n in names if ".shard-" in n]
    assert sorted(n for n in shard_files if n.startswith("params.")) == [
        f"params.shard-{i:05d}-of-00004.npz" for i in range(4)]
    assert any(n.startswith("opt_state.shard-") for n in shard_files)
    man = tck.load_manifest(ckpt)
    assert man["format"] >= 2
    for n in shard_files:
        assert n in man["files"], n
    for ent in man["shards"]["params"].values():
        assert ent["shards"] == 4 and "dim" in ent
    assert tck.verify_checkpoint(ckpt)


@pytest.mark.parametrize("dst", [8, 1], ids=["jax8", "jax1"])
def test_sharded_ckpt_reshards_across_mesh_shapes(runs, dst):
    """The port's 4-way checkpoint loads into the JAX trainer on 8 and on
    1 devices (sharded again on 8), byte for byte; the 8-way JAX one
    loads onto the 4 ranks, byte for byte, sharded, and trains on."""
    jax_side, port = runs
    ckpt = port[0]["fsdp"]["saved"]
    jtr = _jtrainer(dst)
    jtr.load(ckpt)
    one = TTrainer(TNet(ModelConfig.from_json(_cfg().to_json())),
                   TOpt(**OPT), seed=5, device="cpu",
                   mesh=Mesh({"data": 1}))
    one.load(ckpt)
    for name, p in jtr.params.items():
        np.testing.assert_array_equal(np.asarray(p),
                                      one.params[name].numpy(), err_msg=name)
    if dst > 1:
        assert sum(any(ax is not None for ax in p.sharding.spec)
                   for p in jtr.params.values()) >= 7
    got = port[0]["fsdp"]["loaded"]
    for name, p in jax_side["j8"].params.items():
        np.testing.assert_array_equal(got["params"][name], np.asarray(p),
                                      err_msg=name)
    assert len(got["placed"]) >= 7
    assert np.isfinite(port[0]["fsdp"]["loaded_loss"])
    jset_mesh(None)


def test_sharded_ckpt_bitflip_one_shard_quarantines_whole_dir(runs):
    _, port = runs
    save_dir = os.path.dirname(port[0]["fsdp"]["saved"])
    newest = port[0]["fsdp"]["saved_1"]
    shard_file = sorted(n for n in os.listdir(newest)
                        if n.startswith("params.shard-"))[3]
    fault.corrupt_checkpoint(newest, fname=shard_file, mode="bitflip")
    assert tck.verify_checkpoint(newest) is False
    tr = TTrainer(TNet(ModelConfig.from_json(_cfg().to_json())),
                  TOpt(**OPT), seed=99, device="cpu")
    assert tr.resume(save_dir) is True
    assert tr.samples_seen == tck.load_manifest(
        os.path.join(save_dir, "pass-00000"))["samples_seen"]
    dirs = sorted(os.listdir(save_dir))
    assert ".corrupt-pass-00001" in dirs and "pass-00001" not in dirs
    assert shard_file in os.listdir(
        os.path.join(save_dir, ".corrupt-pass-00001"))


def test_health_norms_of_sharded_params_are_whole_param_norms(runs):
    """``--health_interval`` under FSDP and replicated on 4 ranks: each
    rank folds the sums of squares of the shards it owns, the drain
    all-reduces them once, and every rank's report gives the one-process
    trainer's per-layer norms (counts exactly; norms within rtol 1e-4:
    the sharded step's rounding) — no parameter summed twice or
    missed."""
    _, port = runs
    want = port[0]["fsdp_health"]["single"]["health"]
    assert want["steps"] == 2 and len(want["layers"]) >= 5
    for case in ("fsdp_health", "rep_health"):
        for r in range(4):
            got = port[r][case]["health"]
            assert got["steps"] == 2 and sorted(got["layers"]) == \
                sorted(want["layers"])
            for layer, w in want["layers"].items():
                g = got["layers"][layer]
                for k in ("nonfinite_steps", "benign_nonfinite_steps",
                          "first_nonfinite"):
                    assert g[k] == w[k], (case, r, layer, k)
                for k in ("grad_norm", "param_norm", "update_norm"):
                    np.testing.assert_allclose(
                        g[k], w[k], rtol=1e-4, err_msg=f"{case} {r} "
                        f"{layer} {k}")
