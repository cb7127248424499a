"""Entry point of the port (counterpart of ``__graft_entry__.entry()``).

    python -m paddle_tpu_torch.entry          # on CUDA
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

VOCAB, NCLASS, BATCH, SEQLEN = 4000, 2, 8, 32


def _make_feed(batch, seqlen, vocab, nclass, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(batch, seqlen)).astype(np.int32)
    lengths = rng.randint(max(1, seqlen // 2), seqlen + 1,
                          size=(batch,)).astype(np.int32)
    labels = rng.randint(0, nclass, size=(batch,)).astype(np.int32)
    return ids, lengths, labels


def entry(device: Optional[Union[str, torch.device]] = None):
    """Return (fn, example_args) for a forward step of the flagship
    model (the LSTM text classifier at B = 8, T = 32, H = 128, E = 64,
    V = 4000): ``fn(*example_args)`` is the scalar loss.  Runs on CUDA
    unless ``device="cpu"``; raises when CUDA is absent."""
    from .core.device import resolve_device
    from .core.sequence import SequenceBatch
    from .layers.network import NeuralNetwork
    from .models import lstm_text_classifier

    dev = resolve_device(device)
    cfg = lstm_text_classifier(vocab_size=VOCAB, embed_dim=64,
                               hidden_size=128, lstm_num=2,
                               num_classes=NCLASS)
    net = NeuralNetwork(cfg)
    params = net.init_params(seed=0, device=dev)

    def forward(params, ids, lengths, labels):
        feed = {"data": SequenceBatch(ids, lengths), "label": labels}
        with torch.no_grad():
            loss, _ = net.loss(params, feed)
        return loss

    ids, lengths, labels = (torch.from_numpy(a).to(dev) for a in
                            _make_feed(BATCH, SEQLEN, VOCAB, NCLASS))
    return forward, (params, ids, lengths, labels)


if __name__ == "__main__":
    fn, args = entry()
    print("entry loss:", float(fn(*args)))
