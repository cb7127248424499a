"""The seq2seq model configuration (counterpart of the topology
``bench.py``'s ``seq2seq_setup`` builds through the JAX package's config
DSL: the demo/seqToseq training net).

:func:`seq2seq_config` writes out, layer for layer and name for name,
the ``ModelConfig`` that DSL build produces, so parameters are carried
across by name: an embedded source through a bidirectional GRU encoder
(``simple_gru`` twice: fc 3H + ``gated_recurrent``, the second
reversed), a decoder boot state from the backward encoder's last step,
and a ``decoder`` recurrent group stepping over the embedded target —
``simple_attention`` over the encoder sequence, an input projection
from the context and the target word, a ``gru_step`` on the memory
``dec_gru``, and a softmax projection to the vocabulary — then a
classification cost against the next target word.  Unnamed layers are
``__<type>_<k>__``, k counting the DSL's unnamed layers in creation
order.
"""

from __future__ import annotations

from typing import Dict, List

from ..config.model_config import (LayerConfig, LayerInput, ModelConfig,
                                   ParameterConfig, SubModelConfig)

_DECODER = ["att_transform", "__expand_2__", "att_combine", "att_weight",
            "att_scale", "att_context", "dec_inproj", "dec_gru", "dec_prob"]


def _data(name: str, dim: int) -> LayerConfig:
    return LayerConfig(name=name, type="data", size=dim,
                       attrs={"height": 0, "width": 0, "seq_level": 1,
                              "kind": "index"})


def _layer(name: str, ltype: str, size: int, inputs: List[str],
           act: str = "", with_bias: bool = False, attrs: Dict = None,
           param: str = "") -> LayerConfig:
    ins = [LayerInput(input_layer_name=i) for i in inputs]
    if param:
        ins[0].input_parameter_name = param
    return LayerConfig(name=name, type=ltype, size=size, active_type=act,
                       inputs=ins, with_bias=with_bias, attrs=attrs or {})


def _gru(name: str, hidden: int, reverse: bool) -> List[LayerConfig]:
    """``simple_gru``: fc(3H, linear, no bias) + gated_recurrent."""
    return [_layer(f"{name}_transform", "fc", 3 * hidden, ["src_emb"]),
            _layer(name, "gated_recurrent", hidden, [f"{name}_transform"],
                   act="tanh", with_bias=True,
                   attrs={"reversed": reverse,
                          "active_gate_type": "sigmoid"})]


def seq2seq_config(vocab: int = 30000, embed: int = 512,
                   hidden: int = 512) -> ModelConfig:
    """``bench.py``'s seq2seq topology (``seq2seq_setup``, its defaults:
    V 30000, E 512, H 512) as a ModelConfig."""
    emb = {"vocab_size": vocab, "sharded": False}
    mem = "dec_gru@pre@decoder"
    layers = [
        _data("target", vocab),
        _layer("trg_emb", "embedding", embed, ["target"], attrs=emb,
               param="_trg_emb"),
        _data("source", vocab),
        _layer("src_emb", "embedding", embed, ["source"], attrs=dict(emb),
               param="_src_emb"),
        *_gru("enc_bwd", hidden, True),
        _layer("__seqlastins_1__", "seqlastins", hidden, ["enc_bwd"],
               attrs={"stride": -1}),
        _layer("dec_boot", "fc", hidden, ["__seqlastins_1__"], act="tanh",
               with_bias=True),
        *_gru("enc_fwd", hidden, False),
        _layer("enc_seq", "concat", 2 * hidden, ["enc_fwd", "enc_bwd"]),
        _layer("enc_proj", "fc", hidden, ["enc_seq"]),
        # the decoder step (simple_attention, then the GRU step)
        _layer("__expand_2__", "expand", hidden,
               ["att_transform", "enc_proj"]),
        _layer("att_combine", "addto", hidden, ["enc_proj", "__expand_2__"],
               act="tanh"),
        _layer("att_weight", "fc", 1, ["att_combine"],
               act="sequence_softmax"),
        _layer("att_scale", "scaling", 2 * hidden, ["att_weight", "enc_seq"]),
        _layer("att_context", "average", 2 * hidden, ["att_scale"],
               attrs={"stride": -1, "average_strategy": "sum"}),
        _layer("dec_inproj", "fc", 3 * hidden, ["att_context", "trg_emb"]),
        _layer("dec_gru", "gru_step", hidden, ["dec_inproj", mem],
               act="tanh", with_bias=True,
               attrs={"active_gate_type": "sigmoid"}),
        _layer("att_transform", "fc", hidden, [mem]),
        _layer("dec_prob", "fc", vocab, ["dec_gru"], act="softmax",
               with_bias=True),
        _data("target_next", vocab),
        _layer("__multi-class-cross-entropy_3__",
               "multi-class-cross-entropy", 1, ["dec_prob", "target_next"],
               attrs={"coeff": 1.0}),
    ]
    decoder = SubModelConfig(
        name="decoder", layer_names=list(_DECODER), in_links=["trg_emb"],
        out_links=["dec_prob"],
        memories=[{"layer_name": "dec_gru", "link_name": mem,
                   "size": hidden, "boot_layer_name": "dec_boot"}])
    return ModelConfig(
        layers=layers,
        parameters=[ParameterConfig(name=n, initial_smart=True)
                    for n in ("_src_emb", "_trg_emb")],
        input_layer_names=["target", "source", "target_next"],
        output_layer_names=["__multi-class-cross-entropy_3__"],
        sub_models=[SubModelConfig(name="root"), decoder])
