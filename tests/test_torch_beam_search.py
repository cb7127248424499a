"""The port's beam-search generation (``paddle_tpu_torch/layers/
beam_search.py``, generating groups in ``layers/network.py``,
``models.seq2seq_generator_config``) against the JAX package's, on the
CPU, at the seqToseq demo's widths (V 32, E 16, H 48; demo/seqToseq/
train.py:32-34).

The JAX generation net is built with the JAX DSL from the same calls
(the demo's ``build_gen`` with the seq2seq row's names); its
``init_params(0)`` goes into the port by name.  Ids and lengths must be
equal, scores within rtol 1e-5 (fp32; the two packages sum in other
orders).  A tie among candidate scores is broken towards the lower flat
index, as ``lax.top_k`` breaks it: zero ``dec_prob`` weights tie every
candidate.  The memory's ``boot_bias`` (a key neither DSL writes, read
from JSON) boots a memory without a boot layer, as in the JAX group.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl
from paddle_tpu.config.dsl import (GeneratedInput, ParamAttr, StaticInput,
                                   StepInput, config_scope)
from paddle_tpu.config.model_config import ModelConfig as JModel
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.data.feeder import (dense_vector_sequence,
                                    integer_value_sequence)
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.v2.networks import simple_attention, simple_gru
from paddle_tpu_torch.config.model_config import ModelConfig as TModel
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.models import (seq2seq_config,
                                     seq2seq_generator_config)
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax

V, E, H = 32, 16, 48                 # demo/seqToseq/train.py:32
BOS, EOS = 0, 1
RTOL = 1e-5


def _jax_generator(vocab, embed, hidden, beam, max_len, adjust=None,
                   drop=None):
    """``seq2seq_generator_config``'s calls through the JAX DSL."""
    with config_scope():
        src = dsl.data("source", integer_value_sequence(vocab))
        src_emb = dsl.embedding(src, size=embed, name="src_emb",
                                param_attr=ParamAttr(name="_src_emb"),
                                vocab_size=vocab)
        fwd = simple_gru(src_emb, size=hidden, name="enc_fwd")
        bwd = simple_gru(src_emb, size=hidden, name="enc_bwd", reverse=True)
        enc = dsl.concat([fwd, bwd], name="enc_seq")
        enc_proj = dsl.fc(enc, size=hidden, act=dsl.LinearActivation(),
                          bias_attr=False, name="enc_proj")
        boot = dsl.fc(dsl.last_seq(bwd), size=hidden,
                      act=dsl.TanhActivation(), name="dec_boot")

        def step(e, ep, b, w):
            mem = dsl.memory(name="dec_gru", size=hidden, boot_layer=b)
            context = simple_attention(e, ep, mem.out, name="att")
            inp = dsl.fc([context, w], size=hidden * 3,
                         act=dsl.LinearActivation(), bias_attr=False,
                         name="dec_inproj")
            h = dsl.gru_step_layer(inp, mem.out, size=hidden, name="dec_gru")
            return dsl.fc(h, size=vocab, act=dsl.SoftmaxActivation(),
                          name="dec_prob")

        gen = dsl.beam_search(
            step, input=[StaticInput(enc), StaticInput(enc_proj),
                         StaticInput(boot),
                         GeneratedInput(size=vocab, embedding_name="_trg_emb",
                                        embedding_size=embed)],
            bos_id=BOS, eos_id=EOS, beam_size=beam, max_length=max_len,
            candidate_adjust=adjust, candidate_drop=drop)
        return dsl.topology(gen)


def _sources(lengths, seed=0):
    r = np.random.RandomState(seed)
    ids = r.randint(2, V, (len(lengths), max(lengths))).astype(np.int32)
    return ids, np.asarray(lengths, np.int32)


def _generate_both(beam, max_len, lengths, seed=0, tweak=None,
                   jhooks=None, thooks=None):
    jcfg = _jax_generator(V, E, H, beam, max_len, **(jhooks or {}))
    jnet = JNet(jcfg)
    jp = jnet.init_params(0)
    if tweak is not None:
        jp = {k: tweak(k, v) for k, v in jp.items()}
    tcfg = seq2seq_generator_config(V, E, H, beam, max_len, BOS, EOS)
    tcfg.sub_models[-1].generator.update(thooks or {})
    tnet = TNet(tcfg)
    tp = network_params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                 tnet, "cpu")
    ids, lens = _sources(lengths, seed)
    jv, _ = jnet.forward(jp, {"source": JSeq(jnp.asarray(ids),
                                             jnp.asarray(lens))},
                         {}, is_training=False)
    with torch.no_grad():
        tv, _ = tnet.forward(tp, {"source": TSeq(torch.from_numpy(ids),
                                                 torch.from_numpy(lens))},
                             is_training=False)
    name = jcfg.output_layer_names[0]
    assert tnet.output_names == [name]
    got = {k: tv[name + s].numpy() for k, s in
           (("ids", ""), ("scores", ".scores"), ("lengths", ".lengths"))}
    want = {k: np.asarray(jv[name + s]) for k, s in
            (("ids", ""), ("scores", ".scores"), ("lengths", ".lengths"))}
    return got, want


def _same(got, want):
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=RTOL)
    assert got["ids"].dtype == np.int32 and got["lengths"].dtype == np.int32


@pytest.mark.parametrize("beam,lengths", [
    (1, [6, 6, 6, 6]), (4, [6, 6, 6, 6]), (4, [6, 3, 1, 5])],
    ids=["greedy", "beam4", "ragged"])
def test_generation_matches_jax(beam, lengths):
    got, want = _generate_both(beam, 8, lengths)
    _same(got, want)
    assert got["ids"].shape == (4, beam, 8)
    assert (np.diff(got["scores"], axis=1) <= 0).all()


def test_ties_break_towards_the_lower_index_as_jax():
    """Zero softmax weights give every token the same probability: each
    step's K·V candidates tie in runs, and the port keeps JAX's lower
    flat indices (EOS is token 1, so beams close early)."""
    def zero_prob(k, v):
        return jnp.zeros_like(v) if k.startswith("_dec_prob") else v
    got, want = _generate_both(3, 6, [6, 4, 5], tweak=zero_prob)
    _same(got, want)
    # step 0 keeps tokens 0, 1, 2; the EOS beam then scores best
    assert (got["ids"][:, 0, 0] == EOS).all()
    assert (got["lengths"][:, 0] == 1).all()


def test_candidate_hooks_and_eos_freezing_match_jax():
    """``candidate_drop`` bans token 5 everywhere; ``candidate_adjust``
    boosts EOS at step 2, so every beam closes there: length 3, EOS
    after it, its score frozen."""
    def jdrop(logp, tokens, t):
        return jnp.zeros(logp.shape, bool).at[:, :, 5].set(True)

    def tdrop(logp, tokens, t):
        mask = torch.zeros(logp.shape, dtype=torch.bool)
        mask[:, :, 5] = True
        return mask

    def jadjust(logp, tokens, t):
        return logp.at[:, :, EOS].add(jnp.where(t == 2, 50.0, 0.0))

    def tadjust(logp, tokens, t):
        logp = logp.clone()
        if t == 2:
            logp[:, :, EOS] += 50.0
        return logp

    got, want = _generate_both(
        3, 7, [6, 2, 4], jhooks=dict(adjust=jadjust, drop=jdrop),
        thooks=dict(candidate_adjust=tadjust, candidate_drop=tdrop))
    _same(got, want)
    assert 5 not in got["ids"]
    assert (got["lengths"] <= 3).all()
    closed = got["lengths"] == 3
    assert closed.any()
    assert (got["ids"][closed][:, 3:] == EOS).all()
    assert (got["ids"][closed][:, 2] == EOS).all()
    # a closed beam's score stays: the same decode cut at 3 steps
    short, _ = _generate_both(
        3, 3, [6, 2, 4], jhooks=dict(adjust=jadjust, drop=jdrop),
        thooks=dict(candidate_adjust=tadjust, candidate_drop=tdrop))
    np.testing.assert_allclose(short["scores"], got["scores"], rtol=1e-6)


def test_generator_config_is_the_jax_dsl_calls_at_full_width():
    """``seq2seq_generator_config()`` (V 30000, E 512, H 512, beam 3,
    max length 250) gives the JAX DSL's JSON and declares only
    parameters of ``seq2seq_config`` with their shapes."""
    tcfg = seq2seq_generator_config()
    jcfg = _jax_generator(30000, 512, 512, 3, 250)
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
    gen = TNet(tcfg).param_specs
    train = TNet(seq2seq_config()).param_specs
    assert set(gen) <= set(train)
    assert {k: gen[k].dims for k in gen} == {k: train[k].dims for k in gen}
    assert "_trg_emb" in gen and "_dec_prob.w0" in gen
    g = tcfg.sub_models[-1].generator
    assert (g["beam_size"], g["max_length"], g["bos_id"], g["eos_id"]) \
        == (3, 250, 0, 1)


def _boot_bias_configs(bias):
    with config_scope():
        x = dsl.data("x", dense_vector_sequence(3))

        def step(xt):
            mem = dsl.memory(name="h", size=4)
            return dsl.fc([xt, mem.out], size=4, act=dsl.TanhActivation(),
                          name="h")
        cfg = dsl.topology(dsl.recurrent_group(step, StepInput(x),
                                               name="rnn"))
    spec = json.loads(cfg.to_json())
    (mem,) = [m for sm in spec["sub_models"] for m in sm["memories"]]
    mem["boot_bias"] = bias
    text = json.dumps(spec)
    return JModel.from_json(text), TModel.from_json(text)


def test_memory_boot_bias_boots_the_memory_as_in_jax():
    """A memory without a boot layer starts at zeros plus its
    ``boot_bias``: the first step differs from a zero boot."""
    bias = 0.5               # a scalar: the JAX group adds it to an array
    jcfg, tcfg = _boot_bias_configs(bias)
    jnet, tnet = JNet(jcfg), TNet(tcfg)
    jp = jnet.init_params(0)
    tp = network_params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                 tnet, "cpu")
    r = np.random.RandomState(1)
    data = r.randn(2, 4, 3).astype(np.float32)
    lens = np.asarray([4, 2], np.int32)
    jv, _ = jnet.forward(jp, {"x": JSeq(jnp.asarray(data),
                                        jnp.asarray(lens))},
                         is_training=False)
    tv, _ = tnet.forward(tp, {"x": TSeq(torch.from_numpy(data),
                                        torch.from_numpy(lens))},
                         is_training=False)
    name = jcfg.output_layer_names[0]
    want = np.asarray(jv[name].data)
    np.testing.assert_allclose(tv[name].data.detach().numpy(), want,
                               rtol=1e-5, atol=1e-6)
    # the bias reached the first step
    w = np.asarray(jp["_h.w1"])
    first = np.tanh(data[:, 0] @ np.asarray(jp["_h.w0"])
                    + np.full(4, bias, np.float32) @ w
                    + np.asarray(jp["_h.wbias"]))
    np.testing.assert_allclose(want[:, 0], first, rtol=1e-5, atol=1e-6)
