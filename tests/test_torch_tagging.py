"""The sequence-tagging demo's config (``paddle_tpu_torch/configs/
tagging.py``: embedding → bi-GRU → fc → ``crf``; ``crf_decoding`` under
``is_decoding=1``) through the port against the JAX package, on the
CPU, at the demo's widths (vocabulary 50, 5 tags, embedding 16, hidden
32, length 12, batch 16, Adam lr 0.02).

- Both packages parse the config to the same ``to_json()``, equal to
  the topology ``demo/sequence_tagging/train.py`` builds (its CRF
  weight shared through the layers' name: the demo's ``param_attr`` on
  ``crf`` raises in both DSLs, pinned here), for training and for
  decoding.
- Three Adam steps of the port's ``Trainer`` from the JAX
  ``Trainer(seed=3)``'s parameters on the demo's batches give JAX's
  costs and parameters; the decoding net on the trained parameters
  (``_crf.w0`` shared by name) gives JAX's Viterbi paths.
- A format-2 checkpoint of the net written by either package loads into
  the other bit for bit, and saves back with equal digests.

Tolerances (fp32): costs rtol 1e-5; parameters after 3 Adam steps
within 1e-4 (a tenth of one step at lr 0.02 is 2e-3: Adam turns a
rounding difference in a gradient near 0 into a share of a step); paths
exact.  ~25 s alone (the JAX step's compile).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import config_parser as jparser
from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.data.feeder import integer_value_sequence
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.v2.networks import simple_gru
from paddle_tpu_torch.config import config_parser as tparser
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax
from test_torch_checkpoint import _assert_same_state, _digests
from test_torch_config_parser import REPO

TAGGING = os.path.join(REPO, "paddle_tpu_torch", "configs", "tagging.py")
VOCAB, TAGS, EMB, HID, T = 50, 5, 16, 32, 12


def _port_parse(args):
    from paddle_tpu_torch import compat
    with compat.swapped(extra=("provider",)):
        return tparser.parse_config(TAGGING, args)


def sample_batch(rng, bs=16):
    """``demo/sequence_tagging/train.py``'s batch: words, tags = f(word
    class, previous class), lengths in [T/2, T]."""
    words = rng.randint(0, VOCAB, (bs, T)).astype(np.int32)
    cls = words % TAGS
    tags = np.zeros_like(cls)
    tags[:, 0] = cls[:, 0]
    for t in range(1, T):
        tags[:, t] = (cls[:, t] + (cls[:, t - 1] == cls[:, t])) % TAGS
    lens = rng.randint(T // 2, T + 1, (bs,)).astype(np.int32)
    return words, tags.astype(np.int32), lens


def _demo_topology(decoding, share_by_attr=False):
    """The demo's own calls (``train.py:46-80``) through the JAX DSL,
    the CRF weight shared by naming both CRF layers ``crf`` (or, as the
    demo writes it, by ``param_attr``)."""
    with jdsl.config_scope():
        word = jdsl.data("word", integer_value_sequence(VOCAB))
        emb = jdsl.embedding(word, size=EMB)
        fwd = simple_gru(emb, size=HID, name="gf")
        bwd = simple_gru(emb, size=HID, name="gb", reverse=True)
        feat = jdsl.fc(jdsl.concat([fwd, bwd]), size=TAGS,
                       act=jdsl.LinearActivation(), name="emission")
        kw = {"param_attr": jdsl.ParamAttr(name="_crf_w")} \
            if share_by_attr else {"name": "crf"}
        if decoding:
            return jdsl.topology(jdsl.crf_decoding(feat, size=TAGS, **kw))
        target = jdsl.data("target", integer_value_sequence(TAGS))
        return jdsl.topology(jdsl.crf(feat, target, size=TAGS, **kw))


@pytest.mark.parametrize("args", ["", "is_decoding=1"])
def test_config_matches_the_jax_package_and_the_demo(args):
    jmodel, jopt, _ = jparser.parse_config(TAGGING, args)
    tmodel, topt, tdata = _port_parse(args)
    assert tmodel.to_json() == jmodel.to_json()
    assert jmodel.to_json() == _demo_topology(bool(args)).to_json()
    assert (topt.batch_size, topt.learning_rate, topt.learning_method) == \
        (jopt.batch_size, jopt.learning_rate, jopt.learning_method) == \
        (16, 0.02, "adam")
    assert (tdata.module, tdata.obj) == ("provider", "process_tagging")
    types = [l.type for l in tmodel.layers]
    assert types[-1] == ("crf_decoding" if args else "crf")
    assert types.count("gated_recurrent") == 2


def test_crf_with_a_param_attr_raises_in_both_dsls():
    """The demo's ``crf(feat, target, param_attr=...)``: both DSLs pair
    the one attribute with the two inputs and raise (the JAX package's
    behaviour, copied); ``crf_decoding`` takes it."""
    from paddle_tpu_torch.config import dsl as tdsl
    from paddle_tpu_torch.data.feeder import integer_value_sequence as tis
    with pytest.raises(IndexError):
        _demo_topology(False, share_by_attr=True)
    _demo_topology(True, share_by_attr=True)
    with tdsl.config_scope():
        feat = tdsl.data("feat", tis(TAGS))
        target = tdsl.data("target", tis(TAGS))
        with pytest.raises(IndexError):
            tdsl.crf(feat, target, size=TAGS,
                     param_attr=tdsl.ParamAttr(name="_crf_w"))


def _feeds(words, tags, lens):
    return ({"word": JSeq(jnp.asarray(words), jnp.asarray(lens)),
             "target": JSeq(jnp.asarray(tags), jnp.asarray(lens))},
            {"word": TSeq(torch.from_numpy(words), torch.from_numpy(lens)),
             "target": TSeq(torch.from_numpy(tags), torch.from_numpy(lens))})


@pytest.fixture(scope="module")
def trained():
    """Three steps of both trainers from JAX's seed-3 parameters."""
    jmodel, jopt, _ = jparser.parse_config(TAGGING, "")
    tmodel, topt, _ = _port_parse("")
    jtr = JTrainer(JNet(jmodel), opt_config=jopt, seed=3)
    tnet = TNet(tmodel)
    ttr = TTrainer(tnet, opt_config=topt, seed=3, device="cpu")
    ttr.params = network_params_from_jax(
        {n: np.array(v) for n, v in jtr.params.items()}, tnet, "cpu")
    rng = np.random.RandomState(0)
    costs = []
    for _ in range(3):
        jf, tf = _feeds(*sample_batch(rng))
        costs.append((float(ttr.train_one_batch(tf)),
                      float(jtr.train_one_batch(jf))))
    return jtr, ttr, costs


def test_three_adam_steps_match_jax(trained):
    jtr, ttr, costs = trained
    for step, (got, want) in enumerate(costs):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"cost of step {step}")
    assert set(ttr.params) == set(jtr.params)
    assert tuple(ttr.params["_crf.w0"].shape) == (TAGS + 2, TAGS)
    for name, p in jtr.params.items():
        diff = np.abs(ttr.params[name].numpy() - np.asarray(p))
        assert diff.max() <= 1e-4, (name, diff.max())


def test_viterbi_paths_match_jax(trained):
    jtr, ttr, _ = trained
    jdec = JNet(jparser.parse_config(TAGGING, "is_decoding=1")[0])
    tdec = TNet(_port_parse("is_decoding=1")[0])
    assert set(tdec.param_specs) == set(jdec.init_params(0)) \
        <= set(ttr.params)
    # JAX's trained parameters in both: the paths are compared on the
    # same weights
    jp = {n: jtr.params[n] for n in tdec.param_specs}
    tp = network_params_from_jax({n: np.asarray(v) for n, v in jp.items()},
                                 tdec, "cpu")
    words, tags, lens = sample_batch(np.random.RandomState(5), bs=32)
    jf, tf = _feeds(words, tags, lens)
    name = tdec.output_names[0]
    jv = jdec.forward(jp, {"word": jf["word"]}, is_training=False)[0][name]
    with torch.no_grad():
        tv = tdec.forward(tp, {"word": tf["word"]}, is_training=False)[0][
            name]
    assert tv.data.dtype == torch.int32
    np.testing.assert_array_equal(tv.data.numpy(), np.asarray(jv.data))
    np.testing.assert_array_equal(tv.length.numpy(), lens)


def test_checkpoint_crosses_packages(trained, tmp_path):
    """JAX save -> port load (bit for bit) -> port save (equal digests);
    port save -> JAX load -> JAX save (equal digests)."""
    jtr, ttr, _ = trained
    a = jtr.save(str(tmp_path / "jax"), 0)
    tmodel, topt, _ = _port_parse("")
    other = TTrainer(TNet(tmodel), opt_config=topt, seed=11, device="cpu")
    other.load(a)
    _assert_same_state(jtr, other)
    assert _digests(other.save(str(tmp_path / "port"), 0)) == _digests(a)
    b = ttr.save(str(tmp_path / "port2"), 1)
    jmodel, jopt, _ = jparser.parse_config(TAGGING, "")
    jtr2 = JTrainer(JNet(jmodel), opt_config=jopt, seed=7)
    jtr2.load(b)
    _assert_same_state(jtr2, ttr)
    assert _digests(jtr2.save(str(tmp_path / "jax2"), 1)) == _digests(b)
