"""IMDB-shaped LSTM text classifier (reference
``benchmark/paddle/rnn/rnn.py``), in the reference's config idiom: it
imports only ``paddle.trainer_config_helpers``, so the port's and the JAX
package's ``parse_config`` and ``paddle train`` CLIs both run it.

    python -m paddle_tpu_torch train \
        --config paddle_tpu_torch/configs/rnn.py --device cpu \
        --config_args hidden_size=16,vocab_size=50,batch_size=8,num_samples=32

data (ids over ``vocab_size``) → embedding 128 → ``lstm_num`` ×
``simple_lstm(hidden_size)`` → last_seq → fc softmax over 2 classes →
classification cost; Adam lr 2e-3, L2 8e-4, gradient clipping 25.  The
samples come from ``provider.py`` beside this file: ``num_samples``
sequences of 100 ids each, from ``RandomState(0)``.
"""

from paddle.trainer_config_helpers import *  # noqa: F401,F403

num_class = 2
fixedlen = 100
vocab_size = get_config_arg('vocab_size', int, 30000)
batch_size = get_config_arg('batch_size', int, 128)
lstm_num = get_config_arg('lstm_num', int, 2)
hidden_size = get_config_arg('hidden_size', int, 512)
num_samples = get_config_arg('num_samples', int, 2048)

args = {'vocab_size': vocab_size, 'maxlen': fixedlen,
        'num_samples': num_samples}
define_py_data_sources2(None, None, module="provider", obj="process_rnn",
                        args=args)

settings(
    batch_size=batch_size,
    learning_rate=2e-3,
    learning_method=AdamOptimizer(),
    regularization=L2Regularization(8e-4),
    gradient_clipping_threshold=25)

net = data_layer("data", integer_value_sequence(vocab_size))
net = embedding_layer(net, size=128)
for i in range(lstm_num):
    net = simple_lstm(net, size=hidden_size, name=f"lstm{i}")
net = last_seq(net)
net = fc_layer(net, size=num_class, act=SoftmaxActivation())
lab = data_layer("label", integer_value(num_class))
loss = classification_cost(net, lab)
outputs(loss)
