"""Text model configurations (counterpart of
``paddle_tpu/models/text.py``).

``lstm_text_classifier`` (data → embedding → N × (fc 4H → lstmemory) →
last_seq → fc softmax → classification cost) and
``transformer_text_classifier`` build the same ``ModelConfig`` as the
JAX package's functions, layer for layer and name for name — parameters
are carried across by name.  The JAX package gets there through its
config DSL; these models need only a few layer kinds, so they are
written out here, with the DSL's naming: unnamed layers are
``__<type>_<k>__``, k counting the unnamed layers in creation order.
"""

from __future__ import annotations

from typing import Dict, List

from ..config.model_config import LayerConfig, LayerInput, ModelConfig


def _data(name: str, dim: int, seq_level: int) -> LayerConfig:
    return LayerConfig(name=name, type="data", size=dim,
                       attrs={"height": 0, "width": 0,
                              "seq_level": seq_level, "kind": "index"})


def _layer(name: str, ltype: str, size: int, inputs: List[str],
           act: str = "", with_bias: bool = False,
           attrs: Dict = None) -> LayerConfig:
    return LayerConfig(name=name, type=ltype, size=size, active_type=act,
                       inputs=[LayerInput(input_layer_name=i)
                               for i in inputs],
                       with_bias=with_bias, attrs=attrs or {})


def lstm_text_classifier(vocab_size: int = 30000, embed_dim: int = 128,
                         hidden_size: int = 512, lstm_num: int = 2,
                         num_classes: int = 2) -> ModelConfig:
    """Build the benchmark LSTM text classifier as a ModelConfig."""
    emb = "__embedding_1__"
    layers = [_data("data", vocab_size, 1),
              _layer(emb, "embedding", embed_dim, ["data"],
                     attrs={"vocab_size": vocab_size, "sharded": False})]
    prev, prev_size = emb, embed_dim
    for i in range(lstm_num):
        # simple_lstm: fc(4H, linear, no bias) + lstmemory
        layers.append(_layer(f"lstm{i}_transform", "fc", 4 * hidden_size,
                             [prev]))
        layers.append(_layer(
            f"lstm{i}", "lstmemory", hidden_size, [f"lstm{i}_transform"],
            act="tanh", with_bias=True,
            attrs={"reversed": False, "active_gate_type": "sigmoid",
                   "active_state_type": "tanh"}))
        prev, prev_size = f"lstm{i}", hidden_size
    last, fc, cost = ("__seqlastins_2__", "__fc_3__",
                      "__multi-class-cross-entropy_4__")
    layers += [
        _layer(last, "seqlastins", prev_size, [prev],
               attrs={"stride": -1}),
        _layer(fc, "fc", num_classes, [last], act="softmax", with_bias=True),
        _data("label", num_classes, 0),
        _layer(cost, "multi-class-cross-entropy", 1, [fc, "label"],
               attrs={"coeff": 1.0}),
    ]
    return ModelConfig(layers=layers, input_layer_names=["data", "label"],
                       output_layer_names=[cost])


def transformer_text_classifier(vocab_size: int = 30000,
                                model_dim: int = 128, num_heads: int = 4,
                                num_layers: int = 2, ffn_dim: int = 512,
                                num_classes: int = 2,
                                max_len: int = 2048,
                                causal: bool = False,
                                packed: bool = False,
                                block_q: int = 512,
                                block_k: int = 512) -> ModelConfig:
    """Pre-LN transformer encoder classifier: embedding + position table
    → N × (LN → multi-head attention → residual; LN → ffn → residual) →
    final LN → masked mean pool → fc softmax → classification cost."""
    emb, pos = "__embedding_1__", "__position_embedding_2__"
    ln = dict(with_bias=True, attrs={"epsilon": 1e-5})
    layers = [_data("data", vocab_size, 1),
              _layer(emb, "embedding", model_dim, ["data"],
                     attrs={"vocab_size": vocab_size, "sharded": False}),
              _layer(pos, "position_embedding", model_dim, [emb],
                     attrs={"max_len": max_len})]
    net = pos
    for i in range(num_layers):
        layers += [
            _layer(f"ln{i}a", "layer_norm", model_dim, [net], **ln),
            _layer(f"attn{i}", "scaled_dot_product_attention", model_dim,
                   [f"ln{i}a"], with_bias=True,
                   attrs={"num_heads": num_heads, "causal": causal,
                          "block_q": block_q, "block_k": block_k,
                          "packed": packed}),
            _layer(f"res{i}a", "addto", model_dim, [net, f"attn{i}"]),
            _layer(f"ln{i}f", "layer_norm", model_dim, [f"res{i}a"], **ln),
            _layer(f"ffn{i}_in", "fc", ffn_dim, [f"ln{i}f"], act="relu",
                   with_bias=True),
            _layer(f"ffn{i}_out", "fc", model_dim, [f"ffn{i}_in"],
                   with_bias=True),
            _layer(f"res{i}f", "addto", model_dim,
                   [f"res{i}a", f"ffn{i}_out"])]
        net = f"res{i}f"
    avg, cost = "__average_3__", "__multi-class-cross-entropy_4__"
    layers += [
        _layer("ln_final", "layer_norm", model_dim, [net], **ln),
        _layer(avg, "average", model_dim, ["ln_final"],
               attrs={"stride": -1, "average_strategy": "average"}),
        _layer("cls", "fc", num_classes, [avg], act="softmax",
               with_bias=True),
        _data("label", num_classes, 0),
        _layer(cost, "multi-class-cross-entropy", 1, ["cls", "label"],
               attrs={"coeff": 1.0}),
    ]
    return ModelConfig(layers=layers, input_layer_names=["data", "label"],
                       output_layer_names=[cost])
