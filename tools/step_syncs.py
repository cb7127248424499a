#!/usr/bin/env python3
"""Host-synchronizing CUDA runtime calls in one training step of the LSTM
row, for a tree of the port — the parent side of ``chip_smoke.py``'s
phase 4z-obs (b).

    python3 tools/step_syncs.py [--tree DIR] [--steps N]

Imports ``paddle_tpu_torch`` from ``--tree`` (default: this checkout; an
older tree unpacked into a gitignored directory, ``git archive <commit> |
tar -x -C build/parent``), builds phase 4d's trainer (4d's model, feed,
optimizer and flags, fp32, seed 0) on the card, takes 3 warm steps, then
counts ``chip_smoke.SYNC_CALLS`` in each of ``--steps`` profiled steps
with the telemetry off (``chip_smoke.step_sync_calls``).  Prints one JSON
line: the tree, the count of every step and the calls' names.  Compare
two trees in one run on the card, in turns (parent, this, this, parent).
Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE,
                    help="root of the tree whose paddle_tpu_torch is counted")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, tree)
    import torch
    import paddle_tpu_torch
    if os.path.dirname(os.path.dirname(
            os.path.abspath(paddle_tpu_torch.__file__))) != tree:
        raise SystemExit(f"step_syncs: imported {paddle_tpu_torch.__file__}, "
                         f"not the tree {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("step_syncs: no CUDA device")
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import lstm_text_classifier
    from paddle_tpu_torch.trainer.trainer import Trainer
    cs.set_flags(use_bf16=False, bf16_activations=False, precision="fp32")
    dev = torch.device("cuda")
    trainer = Trainer(NeuralNetwork(lstm_text_classifier(**cs.TRAIN)),
                      OptimizationConfig(**cs.TRAIN_OPT, precision="fp32"),
                      seed=0, device=dev)
    feed = cs.train_feed(0, cs.TRAIN_B, cs.TRAIN_T, cs.TRAIN["vocab_size"],
                         dev)
    for _ in range(3):
        trainer.train_one_batch(feed)
    counts, names, launches = [], [], []
    for _ in range(args.steps):
        syncs, n_launch = cs.step_sync_calls(trainer, feed)
        counts.append(len(syncs))
        names.append(syncs)
        launches.append(n_launch)
    print(json.dumps({"tree": args.tree, "syncs_per_step": counts,
                      "calls": names, "launch_calls": launches,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
