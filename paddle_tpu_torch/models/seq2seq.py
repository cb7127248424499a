"""The seq2seq model configuration (counterpart of the topology
``bench.py``'s ``seq2seq_setup`` builds through the JAX package's config
DSL: the demo/seqToseq training net).

:func:`seq2seq_config` makes the same DSL calls through the port's DSL:
an embedded source through a bidirectional GRU encoder (``simple_gru``
twice, the second reversed), a decoder boot state from the backward
encoder's last step, and a ``decoder`` recurrent group stepping over the
embedded target — ``simple_attention`` over the encoder sequence, an
input projection from the context and the target word, a ``gru_step``
on the memory ``dec_gru``, and a softmax projection to the vocabulary —
then a classification cost against the next target word.
"""

from __future__ import annotations

from ..config import dsl
from ..config.dsl import ParamAttr, StepInput
from ..config.model_config import ModelConfig
from ..data.feeder import integer_value_sequence
from ..v2.networks import simple_attention, simple_gru


def seq2seq_config(vocab: int = 30000, embed: int = 512,
                   hidden: int = 512) -> ModelConfig:
    """``bench.py``'s seq2seq topology (``seq2seq_setup``, its defaults:
    V 30000, E 512, H 512) as a ModelConfig."""
    V, E, H = vocab, embed, hidden
    with dsl.config_scope():
        src = dsl.data("source", integer_value_sequence(V))
        trg = dsl.data("target", integer_value_sequence(V))
        trg_next = dsl.data("target_next", integer_value_sequence(V))
        src_emb = dsl.embedding(src, size=E, name="src_emb",
                                param_attr=ParamAttr(name="_src_emb"),
                                vocab_size=V)
        fwd = simple_gru(src_emb, size=H, name="enc_fwd")
        bwd = simple_gru(src_emb, size=H, name="enc_bwd", reverse=True)
        enc = dsl.concat([fwd, bwd], name="enc_seq")
        enc_proj = dsl.fc(enc, size=H, act=dsl.LinearActivation(),
                          bias_attr=False, name="enc_proj")
        boot = dsl.fc(dsl.last_seq(bwd), size=H,
                      act=dsl.TanhActivation(), name="dec_boot")
        trg_emb = dsl.embedding(trg, size=E, name="trg_emb",
                                param_attr=ParamAttr(name="_trg_emb"),
                                vocab_size=V)

        def step(e, ep, b, w):
            mem = dsl.memory(name="dec_gru", size=H, boot_layer=b)
            context = simple_attention(e, ep, mem.out, name="att")
            inp = dsl.fc([context, w], size=H * 3,
                         act=dsl.LinearActivation(), bias_attr=False,
                         name="dec_inproj")
            hidden = dsl.gru_step_layer(inp, mem.out, size=H,
                                        name="dec_gru")
            return dsl.fc(hidden, size=V, act=dsl.SoftmaxActivation(),
                          name="dec_prob")

        probs = dsl.recurrent_group(
            step, [enc, enc_proj, boot, StepInput(trg_emb)],
            name="decoder")
        return dsl.topology(dsl.classification_cost(probs, trg_next))
