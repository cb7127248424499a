"""Sequence tagging with a linear-chain CRF (reference
``demo/sequence_tagging``, the CRF NER demo; the topology of
``demo/sequence_tagging/train.py:46-80``), in the reference's config
idiom: it imports only ``paddle.trainer_config_helpers``, so the port's
and the JAX package's ``parse_config`` both run it.

    from paddle_tpu_torch.config.config_parser import parse_config
    model, opt, _ = parse_config("paddle_tpu_torch/configs/tagging.py", "")
    dec, _, _ = parse_config("paddle_tpu_torch/configs/tagging.py",
                             "is_decoding=1")

word ids → embedding ``emb_size`` → ``simple_gru(hidden_size)`` forward
and reversed → concat → fc (linear) to ``num_tags`` emissions → ``crf``
against the tags.  ``is_decoding=1`` gives the same net ending in
``crf_decoding`` (Viterbi), its transitions shared with training by
name: both layers are named ``crf``, so both weights are ``_crf.w0``.
(The demo names the weight with ``param_attr``; ``crf_layer`` with a
``param_attr`` raises ``IndexError`` in both packages' DSLs, which pair
one attribute with two inputs.)  The defaults are the demo's:
vocabulary 50, 5 tags, embedding 16, hidden 32, length 12, batch 16,
Adam lr 0.02.  The samples come from ``provider.py`` beside this file
(``process_tagging``: tag = f(word class, previous word class)).
"""
from paddle.trainer_config_helpers import *  # noqa: F401,F403

is_decoding = get_config_arg("is_decoding", bool, False)
vocab_size = get_config_arg("vocab_size", int, 50)
num_tags = get_config_arg("num_tags", int, 5)
emb_size = get_config_arg("emb_size", int, 16)
hidden_size = get_config_arg("hidden_size", int, 32)
seq_len = get_config_arg("seq_len", int, 12)
batch_size = get_config_arg("batch_size", int, 16)
num_samples = get_config_arg("num_samples", int, 1024)

define_py_data_sources2(None, None, module="provider", obj="process_tagging",
                        args={"vocab_size": vocab_size, "num_tags": num_tags,
                              "seq_len": seq_len,
                              "num_samples": num_samples})

settings(batch_size=batch_size, learning_rate=0.02,
         learning_method=AdamOptimizer())

word = data_layer("word", integer_value_sequence(vocab_size))
emb = embedding_layer(word, size=emb_size)
fwd = simple_gru(emb, size=hidden_size, name="gf")
bwd = simple_gru(emb, size=hidden_size, name="gb", reverse=True)
feat = fc_layer(concat_layer([fwd, bwd]), size=num_tags,
                act=LinearActivation(), name="emission")
if not is_decoding:
    target = data_layer("target", integer_value_sequence(num_tags))
    outputs(crf_layer(feat, target, size=num_tags, name="crf"))
else:
    outputs(crf_decoding_layer(feat, size=num_tags, name="crf"))
