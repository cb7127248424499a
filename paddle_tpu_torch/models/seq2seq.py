"""The seq2seq model configurations (counterpart of the topology
``bench.py``'s ``seq2seq_setup`` builds through the JAX package's config
DSL: the demo/seqToseq training net, and the generation net of
``demo/seqToseq/train.py``'s ``build_gen``).

:func:`seq2seq_config` makes the same DSL calls through the port's DSL:
an embedded source through a bidirectional GRU encoder (``simple_gru``
twice, the second reversed), a decoder boot state from the backward
encoder's last step, and a ``decoder`` recurrent group stepping over the
embedded target — ``simple_attention`` over the encoder sequence, an
input projection from the context and the target word, a ``gru_step``
on the memory ``dec_gru``, and a softmax projection to the vocabulary —
then a classification cost against the next target word.

:func:`seq2seq_generator_config` is the same encoder and decoder step
decoded by beam search: the decoder reads the previous generated word
through the training net's target table ``_trg_emb``, so the generator
declares only parameters the training net declares, of the same
shapes, and runs on its weights.
"""

from __future__ import annotations

from ..config import dsl
from ..config.dsl import GeneratedInput, ParamAttr, StaticInput, StepInput
from ..config.model_config import ModelConfig
from ..data.feeder import integer_value_sequence
from ..v2.networks import simple_attention, simple_gru


def _encoder(src, V: int, E: int, H: int):
    """Source embedding → bi-GRU → (encoder sequence, its projection,
    the decoder's boot state)."""
    src_emb = dsl.embedding(src, size=E, name="src_emb",
                            param_attr=ParamAttr(name="_src_emb"),
                            vocab_size=V)
    fwd = simple_gru(src_emb, size=H, name="enc_fwd")
    bwd = simple_gru(src_emb, size=H, name="enc_bwd", reverse=True)
    enc = dsl.concat([fwd, bwd], name="enc_seq")
    enc_proj = dsl.fc(enc, size=H, act=dsl.LinearActivation(),
                      bias_attr=False, name="enc_proj")
    boot = dsl.fc(dsl.last_seq(bwd), size=H, act=dsl.TanhActivation(),
                  name="dec_boot")
    return enc, enc_proj, boot


def _decoder_step(V: int, H: int):
    """The decoder's step: attention, input projection, GRU step and the
    softmax over the vocabulary."""
    def step(e, ep, b, w):
        mem = dsl.memory(name="dec_gru", size=H, boot_layer=b)
        context = simple_attention(e, ep, mem.out, name="att")
        inp = dsl.fc([context, w], size=H * 3, act=dsl.LinearActivation(),
                     bias_attr=False, name="dec_inproj")
        hidden = dsl.gru_step_layer(inp, mem.out, size=H, name="dec_gru")
        return dsl.fc(hidden, size=V, act=dsl.SoftmaxActivation(),
                      name="dec_prob")
    return step


def seq2seq_config(vocab: int = 30000, embed: int = 512,
                   hidden: int = 512) -> ModelConfig:
    """``bench.py``'s seq2seq topology (``seq2seq_setup``, its defaults:
    V 30000, E 512, H 512) as a ModelConfig."""
    V, E, H = vocab, embed, hidden
    with dsl.config_scope():
        src = dsl.data("source", integer_value_sequence(V))
        trg = dsl.data("target", integer_value_sequence(V))
        trg_next = dsl.data("target_next", integer_value_sequence(V))
        enc, enc_proj, boot = _encoder(src, V, E, H)
        trg_emb = dsl.embedding(trg, size=E, name="trg_emb",
                                param_attr=ParamAttr(name="_trg_emb"),
                                vocab_size=V)
        probs = dsl.recurrent_group(
            _decoder_step(V, H), [enc, enc_proj, boot, StepInput(trg_emb)],
            name="decoder")
        return dsl.topology(dsl.classification_cost(probs, trg_next))


def seq2seq_generator_config(vocab: int = 30000, embed: int = 512,
                             hidden: int = 512, beam_size: int = 3,
                             max_length: int = 250, bos_id: int = 0,
                             eos_id: int = 1) -> ModelConfig:
    """The translation net of :func:`seq2seq_config`'s model: the
    ``build_gen`` calls of ``demo/seqToseq/train.py`` with the training
    net's names.  Beam 3 and max length 250 are the reference's
    ``gru_encoder_decoder`` defaults (``seqToseq_net.py``); bos 0 and eos
    1 are the WMT-14 dictionary's ``<s>`` and ``<e>``.  The net's value
    is the ``beam_gen`` layer's: ids ``[B, K, max_length]`` with
    ``.scores`` and ``.lengths``."""
    V, E, H = vocab, embed, hidden
    with dsl.config_scope():
        src = dsl.data("source", integer_value_sequence(V))
        enc, enc_proj, boot = _encoder(src, V, E, H)
        gen = dsl.beam_search(
            _decoder_step(V, H),
            input=[StaticInput(enc), StaticInput(enc_proj),
                   StaticInput(boot),
                   GeneratedInput(size=V, embedding_name="_trg_emb",
                                  embedding_size=E)],
            bos_id=bos_id, eos_id=eos_id, beam_size=beam_size,
            max_length=max_length)
        return dsl.topology(gen)
