"""Text model builders (counterpart of ``paddle_tpu/models/text.py``).

``lstm_text_classifier`` mirrors the reference's RNN benchmark config
(``benchmark/paddle/rnn/rnn.py``: data → embedding(128) → N × simple_lstm
→ last_seq → fc softmax → classification_cost) and
``transformer_text_classifier`` the pre-LN transformer classifier.  Both
are the JAX package's config-DSL calls made through the port's DSL, so
they build the same ``ModelConfig`` and parameters carry across by name.
"""

from __future__ import annotations

from ..config import dsl
from ..config.model_config import ModelConfig
from ..data.feeder import integer_value, integer_value_sequence
from ..v2.networks import simple_lstm


def transformer_classifier_cost(vocab_size: int, model_dim: int = 128,
                                num_heads: int = 4, num_layers: int = 2,
                                ffn_dim: int = 512, num_classes: int = 2,
                                max_len: int = 2048,
                                causal: bool = False,
                                packed: bool = False,
                                block_q: int = 512,
                                block_k: int = 512,
                                data_name: str = "data"):
    """The transformer classifier's cost, built inside an open
    ``config_scope``: embedding + position table → N × (LN → multi-head
    attention → residual; LN → ffn → residual) → final LN → masked mean
    pool → fc softmax → classification_cost."""
    net = dsl.data(data_name, integer_value_sequence(vocab_size))
    net = dsl.embedding(net, size=model_dim)
    net = dsl.position_embedding(net, max_len=max_len)
    for i in range(num_layers):
        att = dsl.scaled_dot_product_attention(
            dsl.layer_norm(net, name=f"ln{i}a"), size=model_dim,
            num_heads=num_heads, causal=causal, packed=packed,
            block_q=block_q, block_k=block_k,
            name=f"attn{i}", bias_attr=True)
        net = dsl.addto([net, att], name=f"res{i}a")
        ffn = dsl.fc(dsl.layer_norm(net, name=f"ln{i}f"),
                     size=ffn_dim, act=dsl.Activation("relu"),
                     name=f"ffn{i}_in")
        ffn = dsl.fc(ffn, size=model_dim, name=f"ffn{i}_out")
        net = dsl.addto([net, ffn], name=f"res{i}f")
    net = dsl.layer_norm(net, name="ln_final")
    net = dsl.pooling_layer(net, pooling_type=dsl.AvgPooling())
    net = dsl.fc(net, size=num_classes,
                 act=dsl.Activation("softmax"), name="cls")
    lab = dsl.data("label", integer_value(num_classes))
    return dsl.classification_cost(net, lab)


def transformer_text_classifier(vocab_size: int = 30000,
                                model_dim: int = 128, num_heads: int = 4,
                                num_layers: int = 2, ffn_dim: int = 512,
                                num_classes: int = 2,
                                max_len: int = 2048,
                                causal: bool = False,
                                packed: bool = False,
                                block_q: int = 512,
                                block_k: int = 512) -> ModelConfig:
    """Pre-LN transformer encoder classifier over the flash-attention
    layer (:func:`transformer_classifier_cost`) as a ModelConfig."""
    with dsl.config_scope():
        return dsl.topology(transformer_classifier_cost(
            vocab_size, model_dim, num_heads, num_layers, ffn_dim,
            num_classes, max_len, causal, packed,
            block_q=block_q, block_k=block_k))


def lstm_text_classifier(vocab_size: int = 30000, embed_dim: int = 128,
                         hidden_size: int = 512, lstm_num: int = 2,
                         num_classes: int = 2) -> ModelConfig:
    """Build the benchmark LSTM text classifier as a ModelConfig."""
    with dsl.config_scope():
        net = dsl.data("data", integer_value_sequence(vocab_size))
        net = dsl.embedding(net, size=embed_dim)
        for i in range(lstm_num):
            net = simple_lstm(net, size=hidden_size, name=f"lstm{i}")
        net = dsl.last_seq(net)
        net = dsl.fc(net, size=num_classes, act=dsl.Activation("softmax"))
        lab = dsl.data("label", integer_value(num_classes))
        cost = dsl.classification_cost(net, lab)
        return dsl.topology(cost)
