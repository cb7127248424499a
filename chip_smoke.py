#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero, without the final ``ok`` line):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build every kernel from ``paddle_tpu_torch/csrc`` with ``nvcc``;
3. hold each kernel against its plain PyTorch version on the card
   (fp32, atol 2e-5): packed causal prefill at T_total in {16, 48*3,
   96*8} with a zero-length row and general segments, windows longer
   than one chunk of staged rows (D 256), and each prompt of the 96*8
   pack alone at its own bucket bit for bit against its rows in the
   pack (out and lse); paged decode at Tq in {1, 4} with rows shorter
   than Tq and inactive slots;
3b. the fused LSTM kernels (forward and BPTT, through their
   ``autograd.Function``) against autograd through the plain per-step
   scan on the same CUDA tensors: outputs within atol 1e-4, every
   gradient (xw, w_hh, bias, peepholes, h0, c0) within 1e-5 + 1e-4 *
   max|ref| (the recurrence compounds rounding over T), at (B, T, H) =
   (8, 12, 128) forward and reversed with peepholes, boot state, a cell
   cotangent and lengths 0 and T; (5, 7, 96); (6, 9, 200), reversed,
   where a forward CTA owns 2 units; (200, 5, 50), two row blocks and
   rows of 50 floats (H % 4 != 0: the dW tile's scalar staging); (3, 1,
   64); and (128, 100, 512) — through ``lstm_sequence``
   where the reference's dispatch rule (``recurrent_ops.dispatch_tier``)
   sends the shape to the fused kernels, else through the tier's fused
   entry called directly (so in 3c, 3e and 3f too);
4. the main path: the full-width decoder server (``bench.py``'s serving
   config, weights from ``init_decoder_params(seed=0)``) over 48 mixed
   prompts in continuous and in sequential mode — identical tokens,
   every kernel launched in each mode's timed pass (counts set to 0
   just before it, read just after), req/s, TTFT p50/p99, tokens/s —
   identical tokens again on a second prompt stream, every prefill
   decision one of the reference's default labels; then the continuous
   server under ``--flash_kernel=false`` and under
   ``--flash_block_sparse=false`` (fault C4): no launch of the prefill
   kernel, the reference's kill-switch label for every prefill layer,
   the default run's tokens; plus the same model on the CPU (plain
   versions) against the card on a small input; then the RMS mean
   checked row-invariant across row counts;
4d. the training main path: the LSTM text classifier at the width of
   ``bench.py``'s first row (V 30000, E 128, H 512, 2 LSTMs; B 128,
   T 100, lengths in [50, 100]; Adam lr 2e-3, L2 8e-4, clip 25; the
   port's own init, seed 0): 3 warm steps, then 20 timed steps between
   CUDA events with the counts set to 0 just before them — finite
   losses, exactly 2 forward and 2 backward LSTM launches per step,
   ms/step and samples/s; the same model on the CPU (plain versions)
   and the card at (B, T, H) = (8, 12, 128): loss and every gradient
   within the tolerances of 3b;
3c. the hidden-blocked LSTM kernels 10-12 (forward, BPTT, dW): through
   their ``autograd.Function`` against autograd through the plain scan,
   and each wrapper against its plain version, at (B, T, H) = (8, 5,
   640) with lengths 0, 1 and T; (200, 4, 700), B = 200 and H not a
   multiple of 128, reversed; (3, 1, 642), one step and H % 4 != 0;
   (128, 100, 1280) and (128, 100, 2048) with the bench feed's lengths;
   tolerances of 3b;
4g. the blocked main path: the classifier at H 1280 (``bench.py``'s
   ``bench_lstm_1280`` row: its feed, its optimizer) under its flags
   ``use_bf16`` and ``bf16_activations``: 3 warm and 10 timed steps,
   counts set to 0 just before them — finite losses, exactly 2 launches
   of each blocked kernel a step and none of kernels 8-9, ms/step,
   samples/s, host wall, peak memory;
4h. a profile of 3 H 1280 steps (kernels 10-12's device time a step);
4i. 3 ``--precision=bf16`` steps (fp32 masters, dynamic loss scale) of
   the same model: finite losses, the scale;
4j. 2 steps at H 2048 (``bench.py``'s scaling row);
4k. the card against the CPU plain path at H = 640, B 8, T 12, same
   parameters, fp32: loss and every gradient within the tolerances of
   3b;
3d. the fused conv/BN kernels 18-21 against their plain versions, fp32
   and bf16, ReLU and linear prologues: the four ResNet-50 stage shapes
   at N = 4, N = 1 with H != W and Cin != Cout both ways, a large C
   offset (the zero border lies in the transformed space), a pixel
   count off the 128-pixel tile and W 140 (the tensor-core loop's band
   mode), against the plain versions with their
   conv summed in float64: fp32 within 1e-5 * max|ref| + 1e-6, bf16
   within that plus 1 bf16 ulp;
4l. the ResNet-50 main path: ``bench.py``'s row (B 128, 3x224x224, 1000
   classes, its feed, Adam lr 1e-3 clip 25, under ``use_bf16`` and
   ``bf16_activations``; the port's own init, seed 0): 2 warm and 10
   timed steps, counts set to 0 just before them — finite losses,
   exactly 16 launches of kernel 19 and 16 of kernel 20 a step and none
   of 18 and 21, ms/step, samples/s, host wall, peak memory;
4m. a profile of 3 ResNet-50 steps;
4n. ResNet-50 under ``--conv_bn_fuse_fwd=false``, 2 steps: 16 launches
   of kernel 18 a step, none of 19-21; then a profile of 3 steps;
4o. ``resnet_cifar10(20)`` at B 128, 3x32x32, 2 steps: 3 launches each
   of kernels 19 and 21 a step (the 64-channel chain pairs); then a
   profile of 3 steps;
4p. the small bottleneck net of the CPU tests in fp32 on the card and on
   the CPU (plain versions), same parameters and buffers: loss (rtol
   1e-5), every gradient (tolerances of 3b), the new buffers (1e-5);
3e. the fused GRU kernels 13 and 14 through ``gru_sequence`` against
   autograd through the plain per-step scan, and each wrapper against
   its plain version, fp32: outputs within 2e-5, every gradient (xw,
   w_hh, bias, h0) within 3e-5 + 3e-4 * max|ref| (the tolerances of
   ``tests/test_pallas_gru.py``; a bf16 gradient also within one bf16
   ulp), at the seq2seq row's encoder shape (B 128, T 30, H 512) in
   both directions; rows of length 0, 1 and T with a nonzero h0; B = 3
   without h0; H 384; B 200 (seven of kernel 13's clusters of 32 rows,
   the last part-filled); H 50 (scalar loads, a part-filled CTA); and a
   bf16 xw;
3f. the hidden-blocked GRU kernels 15-17 (forward, BPTT, dW) the same
   way, with the tolerances of 3e, at (B, T, H) = (128, 30, 1024) in
   both directions (the H 1024 encoder's shape); (8, 12, 640) with
   lengths 0, 1 and T, reversed; (3, 5, 640) without h0; (16, 7, 520),
   H off the 128-lane tiling; (128, 4, 2048); (5, 6, 514) with lengths
   0, 1 and T, H % 4 != 0 (the dW tile's scalar staging); and a bf16 xw;
4q. the seq2seq main path: ``bench.py``'s row (``seq2seq_setup``: B 128,
   source and target length 30, V 30000, E 512, H 512, its feed, Adam lr
   5e-4 clip 25, under ``use_bf16`` and ``bf16_activations``; the port's
   own init, seed 0): 2 warm and 10 timed steps, counts set to 0 just
   before them — finite losses, exactly 2 launches each of kernels 13
   and 14 a step (the two encoder directions) and no other kernel,
   ms/step, target tokens/s (``bench.py``'s metric), host wall, peak
   memory;
4r. a profile of 3 seq2seq steps;
4t. the slice's main path at the blocked GRU tier: the same model, feed,
   flags and optimizer at H 1024 (no ``bench.py`` row reaches the tier):
   2 warm and 10 timed steps — finite losses, exactly 2 launches each
   of kernels 15, 16 and 17 a step and no other kernel, every
   ``rnn_dispatch_total`` decision ``fused_blocked``, ms/step, target
   tokens/s, host wall, peak memory; then a profile of 3 steps;
4v. fault C1 on the card: ``gru_sequence`` at (6, 10, 128) under the
   bench flags takes the reference's bf16 scan (one decision, path scan,
   the reference's reason, no kernel launched) and agrees with the same
   call on the CPU (outputs within 1e-2, gradients within 1e-5 + 2e-2 *
   max|ref|);
4s. a small seq2seq net (B 8, S 6, T 5, V 50, E 16, H 128, source and
   target lengths varied) in fp32 on the card and on the CPU (plain
   versions), same parameters: loss and every gradient within 1e-4 of
   the reference's (of max|ref| for a gradient), 2 launches each of
   kernels 13 and 14; 4u the same at H 640, 2 launches each of kernels
   15-17;
3g. the flash kernels 1 (training form), 3 and 4 against their plain
   versions on the card (f32 arithmetic on the same inputs), through
   ``flash_attention`` / ``flash_attention_packed`` and autograd and
   each wrapper alone: (16, 2048, 8, 64) bf16 non-causal and causal;
   key lengths 0, 1, 64 and 1000; Tq 384 != Tk 1000; T 100; packed rows
   of mixed lengths at slot 2048, and packed causal; fp32; D 32 and 128
   — bf16 outputs within one bf16 ulp plus 1e-3 * max|ref|, fp32 within
   2e-4 * max|ref| + 1e-6, lse within 1e-4, masked rows and keys exactly
   0;
4w. the transformer main path: ``bench.py``'s attention row
   (``_attention_workload``: ``transformer_text_classifier`` V 30000, D
   512, 8 heads, 4 layers, ffn 2048, blocks 512; B 16, T 2048, its feed;
   Adam lr 1e-3 clip 25; ``use_bf16`` + ``bf16_activations``; the port's
   own init, seed 0): 2 warm and 10 timed steps — finite losses,
   exactly 4 launches each of kernels 1-train, 3 and 4 a step and no
   other kernel, every ``attention_dispatch_total`` decision
   ``block_sparse``, ms/step, tokens/s (``transformer_tokens_per_sec``),
   host wall, peak memory; then a profile of 3 steps;
4x. the row's ``padded_mixed`` reading (lengths in [T/4, T], seed 1),
   padded and packed (``packed`` decisions), 3 timed steps each: valid
   tokens/s, the same launch counts;
4y. ``causal_t2048`` in block_skip mode, 3 timed steps; then in legacy
   mode (``--flash_block_sparse=false``), 3 timed steps: exactly 4
   launches each of kernels 2, 5 and 6 a step, none of 1-train, 3 and
   4, every decision ``legacy_grid``;
4z. the small transformer of the CPU tests, padded and packed, fp32 and
   bench flags, card against the CPU plain path: loss and every
   gradient (fp32: loss rtol 1e-5, gradients 1e-4 * max|ref|; bench
   flags: 1e-3 and 5e-2), 2 launches each of kernels 1-train, 3 and 4;
   then the same under ``--flash_block_sparse=false``: 2 launches each
   of kernels 2, 5 and 6 (the layer does not pack under that flag);
3h. kernels 2, 5 and 6 (the legacy grid) on 3g's unpacked cases and
   inputs, through ``flash_attention`` and autograd and each wrapper
   alone, against their plain versions and against kernels 1-train, 3
   and 4 on the same inputs, with 3g's tolerances;
3i. kernel 22 (the embedding row gather) against ``index_select`` of
   the clamped rows, byte for byte: pads at the height and at -1,
   duplicates, row V-1, one row, D 128 and 256, a 1e7 x 128 table;
4-sparse. ``bench.py``'s sparse lane at bench scale (fp32): the lookup
   composite (``unique_rows_sorted`` -> ``gather_rows`` ->
   ``lookup_rows``) against ``index_select`` at 1e5, 1e6 and 1e7 x 128,
   8192 ids, byte for byte, lookups/s; the CTR net's train A/B at V 1e7,
   D 64, B 1024, T 16 with ``--sparse_grads`` on and off (ms/step,
   samples/s, exchanged gradient bytes, peak memory; kernel 22 launched
   0 times, its gate says ``unaligned``), the host syncs of one exchange
   step (sync debug mode) and profiles of both; the same net at D 128
   (one launch of kernel 22 a step); the kill-switch contracts
   (``--embedding_kernel`` on and off byte-identical; ``--sparse_grads``
   on and off within rtol 1e-4, atol 1e-6 after 3 steps at V 1024);
5. each kernel at its main path's shapes: its time, its plain version's,
   one PyTorch yardstick call's where one computes the same function
   (SDPA for attention; ``torch.matmul`` for the blocked dW; none for
   the other LSTM kernels: cuDNN's LSTM has no peepholes or length mask;
   for kernels 18-21 ``F.conv2d`` / ``conv2d_input`` of the already
   formed operand, the conv's share only, at each ResNet-50 stage shape
   in bf16) and the card's bound, printed as one ``{"kernels": [...]}``
   line with the launches of each path's timed run (serving continuous,
   serving sequential, training at H 512, training at H 1280, ResNet-50,
   ResNet-50 without the forward fusion, resnet_cifar10, seq2seq,
   seq2seq at H 1024, the transformer's five runs, the sparse
   lane's lookups, A/B and D 128 step); kernels 13 and 14
   at the seq2seq encoder's shape, no library call (cuDNN's GRU applies
   the reset gate after the recurrent product); kernels 15-17 at the
   H 1024 encoder's shape,
   ``torch.matmul`` of the two dW products as 17's yardstick; kernels
   1-train, 3 and 4 at the transformer step's shape (q/k/v bf16 [16,
   2048, 8, 64], views of one projection), SDPA's forward as 1's
   yardstick and its backward, one call, as that of 3 and 4 together;
   kernels 2, 5 and 6 at ``causal_t2048``'s (the same, causal), in turns
   with kernels 1-train, 3 and 4 on the same inputs, SDPA causal as the
   yardsticks; kernel 22 at the lane's 8192 rows of the 1e7 x 128
   table, ``torch.index_select`` as its yardstick; beside them, an empty
   kernel timed the same way (the launch floor).  The conv and flash
   rows also carry the achieved TFLOP/s on the contract's flops and the
   share of the bound rate; kernels 18, 19 and 21 are bound by two bf16
   tensor-core passes (the f32 operand as hi + lo, ``CONV_BOUND_BASIS``),
   kernel 20 by one (its bf16 dy as it is), or by their bytes, whichever
   is larger; kernels 8-17 by three bf16 passes (hi*hi + hi*lo + lo*hi
   of their f32 operands, ``GRU_BOUND_BASIS``, ``LSTM_BOUND_BASIS``).

Phases 3b-4f are PR 2's H 512 phases and run in fp32 (``use_bf16``
off), so their readings stay comparable.  The order of the run: 1-3f,
3g-3i, 4-4k, 4l-4p, 4q-4r, 4t, 4v, 4s, 4u, 4w-4z, 4-sparse, 5.

Also printed, for information: a ``torch.profiler`` window over one
continuous pass and one over 3 training steps (device time by kernel,
the device's busy share; the LSTM rows' kernels 8 and 9 (4f) and 10-12
(4h) by name, a step), and ``torch.nn.LSTM(512, 512)`` forward +
backward at B 128, T 100 on full-length rows (cuDNN; it also does the
input product, and is no function of the port).

The last line is ``{"ok": true, "device": {...}}``.  Needs one card;
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
ATOL = 2e-5                    # kernel vs plain version, fp32
# fused LSTM kernels vs their plain versions: outputs within LSTM_ATOL,
# gradients within LSTM_GRAD_ATOL + LSTM_GRAD_RTOL * max|ref| (fp32; the
# recurrence compounds rounding differences over T steps)
LSTM_ATOL, LSTM_GRAD_ATOL, LSTM_GRAD_RTOL = 1e-4, 1e-5, 1e-4

# bench.py's serving config (DecoderConfig(4000, 256, 8, 4, 1024, 512)),
# 48 prompts with T in [16, 96], max_new 32, batch 8, 512 pages x 16
CFG = dict(vocab=4000, dim=256, heads=8, layers=4, ffn=1024,
           max_context=512, eos_id=1)
N_REQ, T_LO, T_HI, MAX_NEW, MAX_BATCH, POOL_PAGES, PAGE = \
    48, 16, 96, 32, 8, 512, 16
# bench.py's first row (_bench_lstm_row at hidden 512, its optimizer)
TRAIN = dict(vocab_size=30000, embed_dim=128, hidden_size=512, lstm_num=2,
             num_classes=2)
TRAIN_B, TRAIN_T, WARM_STEPS, TIMED_STEPS = 128, 100, 3, 20
TRAIN_OPT = dict(learning_method="adam", learning_rate=2e-3,
                 l2_weight_decay=8e-4, gradient_clipping_threshold=25.0)
SERVING_KERNELS = ("flash_packed_fwd", "paged_decode")
TRAINING_KERNELS = ("lstm_fwd", "lstm_bwd")
# bench.py's bench_lstm_1280 row (and its 2048 scaling row), under its
# flags (bench.py:292, 352-368)
BLOCKED = dict(TRAIN, hidden_size=1280)
BLOCKED_STEPS, MIXED_STEPS = 10, 3
BENCH_FLAGS = dict(use_bf16=True, bf16_activations=True)
BLOCKED_KERNELS = ("lstm_fwd_blocked", "lstm_bwd_blocked", "lstm_dw_blocked")
# bench.py's ResNet row (_bench_resnet_once, bench.py:371-415): ResNet-50,
# B 128, 3x224x224, 1000 classes, Adam lr 1e-3, clip 25, under BENCH_FLAGS;
# and its small image config, resnet_cifar10(20) at 3x32x32
RESNET_B, RESNET_IMG, RESNET_CLASSES = 128, 224, 1000
RESNET_WARM, RESNET_STEPS = 2, 10
RESNET_OPT = dict(learning_method="adam", learning_rate=1e-3,
                  gradient_clipping_threshold=25.0)
# bench.py's seq2seq row (seq2seq_setup / bench_seq2seq, bench.py:455-545):
# B 128, source and target length 30, V 30000, E 512, H 512, Adam lr 5e-4,
# clip 25, under BENCH_FLAGS
S2S = dict(B=128, S=30, T=30, V=30000, E=512, H=512)
S2S_OPT = dict(learning_method="adam", learning_rate=5e-4,
               gradient_clipping_threshold=25.0)
S2S_WARM, S2S_STEPS = 2, 10
GRU_KERNELS = ("gru_fwd", "gru_bwd")
# the slice's main path at the hidden-blocked GRU tier: the seq2seq row's
# model, feed, optimizer and flags at H 1024 (no bench.py row reaches it)
S2S_WIDE_H = 1024
GRU_BLOCKED_KERNELS = ("gru_fwd_blocked", "gru_bwd_blocked",
                       "gru_dw_blocked")
# fused GRU kernels vs their plain versions (fp32): outputs within
# GRU_ATOL, gradients within GRU_GRAD_ATOL + GRU_GRAD_RTOL * max|ref|
# (the tolerances of tests/test_pallas_gru.py)
GRU_ATOL, GRU_GRAD_ATOL, GRU_GRAD_RTOL = 2e-5, 3e-5, 3e-4
# bench.py's attention row (_attention_workload / bench_attention,
# bench.py:561-593, 705, 746): transformer_text_classifier(V 30000, D 512,
# 8 heads, 4 layers, ffn 2048, 2 classes, max_len 2048, blocks 512), B 16,
# T 2048, Adam lr 1e-3 clip 25 (_mk_trainer), under BENCH_FLAGS
ATTN = dict(vocab_size=30000, model_dim=512, num_heads=8, num_layers=4,
            ffn_dim=2048, num_classes=2, max_len=2048, block_q=512,
            block_k=512)
ATTN_B, ATTN_T = 16, 2048
ATTN_OPT = dict(learning_method="adam", learning_rate=1e-3,
                gradient_clipping_threshold=25.0)
ATTN_WARM, ATTN_STEPS, ATTN_AB_STEPS = 2, 10, 3
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# kernels 1-train, 3 and 4 against their plain versions on the card (f32
# arithmetic on the same inputs): a bf16 output within one bf16 ulp of the
# larger of the two values plus FLASH_BF16_RTOL * max|ref| (the hi/lo
# split keeps ~16 bits of p and ds, and the kernel sums in another
# order); an fp32 output within FLASH_F32_RTOL * max|ref| + 1e-6 (q, k, v
# held as hi + lo bf16: ~16 bits each); lse within FLASH_LSE_ATOL
FLASH_BF16_RTOL, FLASH_F32_RTOL, FLASH_LSE_ATOL = 1e-3, 2e-4, 1e-4
# the legacy full grid (--flash_block_sparse=false): kernels 2, 5, 6
LEGACY_KERNELS = ("flash_fwd_legacy", "flash_bwd_dq_legacy",
                  "flash_bwd_dkv_legacy")
LEGACY_DECISION = ("legacy_grid", "kill_switch:flash_block_sparse")
# the small transformer of the CPU tests, card vs CPU: loss rtol and
# gradient tolerance (of max|ref|) in fp32 and under BENCH_FLAGS
SMALL_ATTN_TOL = {"fp32": (1e-5, 1e-4), "bench": (1e-3, 5e-2)}
# bench.py's sparse embedding lane at bench scale (_sparse_shapes,
# bench.py:1427-1438; _sparse_trainer :1441-1476, its CTR net and
# optimizer, models/ctr.py): lookup tables 1e5, 1e6, 1e7 x 128 fp32 over
# 8192 ids; the train A/B at V 1e7, D 64, B 1024, T 16; fp32 (the lane
# sets no bf16 flag, and kernel 22's gate takes fp32 tables only)
SPARSE_SCAN, SPARSE_DIM, SPARSE_IDS = (10 ** 5, 10 ** 6, 10 ** 7), 128, 8192
SPARSE_V, SPARSE_D, SPARSE_B, SPARSE_T = 10 ** 7, 64, 1024, 16
SPARSE_WARM, SPARSE_STEPS = 2, 5
# the --sparse_grads on/off contract (bench.py:1606-1622): V 1024, B 16,
# seed 3, 3 steps, every parameter within rtol 1e-4 atol 1e-6
SPARSE_EQ_RTOL, SPARSE_EQ_ATOL = 1e-4, 1e-6
# the small seq2seq net, card vs CPU (fp32; rounding order through the
# GRU kernels and 5 decoder steps): loss and gradients relative to max|ref|
S2S_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ------------------------------------------------------------------ timing
def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a
    CUDA graph and replayed ``rounds`` times between CUDA events, so
    host launch overhead is not counted."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


def reset_counts() -> None:
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import conv as C
    from paddle_tpu_torch.ops import embedding as E
    from paddle_tpu_torch.ops import gru as G
    from paddle_tpu_torch.ops import lstm as L
    A.reset_launch_counts()
    L.reset_launch_counts()
    C.reset_launch_counts()
    G.reset_launch_counts()
    E.reset_launch_counts()


def read_counts():
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import conv as C
    from paddle_tpu_torch.ops import embedding as E
    from paddle_tpu_torch.ops import gru as G
    from paddle_tpu_torch.ops import lstm as L
    counts = {"flash_packed_fwd": A.prefill_attention_packed.launches,
              "paged_decode": A.paged_decode_attention.launches}
    counts.update({fn.__name__: fn.launches for fn in
                   A.KERNEL_WRAPPERS[2:] + L.KERNEL_WRAPPERS
                   + C.KERNEL_WRAPPERS + G.KERNEL_WRAPPERS
                   + E.KERNEL_WRAPPERS})
    return counts


def timed_steps(trainer, feed, steps):
    """``steps`` training steps between CUDA events, every launch count
    set to 0 just before them: (launches, losses, device ms a step, host
    wall ms a step, peak memory in GB)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    t0 = time.perf_counter()
    start.record()
    losses = [trainer.train_one_batch(feed) for _ in range(steps)]
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    return (launches, [float(x) for x in losses],
            start.elapsed_time(end) / steps, wall * 1e3 / steps,
            torch.cuda.max_memory_allocated() / 1e9)


def set_flags(**kw) -> None:
    from paddle_tpu_torch.utils import FLAGS
    for k, v in kw.items():
        FLAGS.set(k, v)


def time_events_ms(fn, reps: int = 5) -> float:
    """Device time of one ``fn()`` call between CUDA events, without a
    graph (for work with a backward pass, which a graph does not take
    here)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- inputs
def packed_case(rng, lengths, slot, h, d, dev):
    """Packed [1, B*slot] q/k/v and segments from per-row lengths."""
    import torch
    from paddle_tpu_torch.ops.attention import segments_from_lengths
    b = len(lengths)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, b * slot, h, d)).astype(np.float32)).to(dev) for _ in range(3))
    seg = segments_from_lengths(
        torch.tensor(lengths, dtype=torch.int32, device=dev), b, slot)
    return q, k, v, seg.contiguous()


def decode_case(rng, lengths, t_q, h, d, n_pages, page, max_pages, dev):
    """Random pools, per-row page tables drawn without replacement, and
    inactive rows (length 1 over the scratch page 0) where length < 0."""
    import torch
    b = len(lengths)
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n_pages, page, h, d)).astype(np.float32)).to(dev) for _ in range(2))
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((b, max_pages), np.int32)
    lens = np.ones((b,), np.int32)
    used = 0
    for i, ln in enumerate(lengths):
        if ln < 0:
            continue                       # inactive: scratch table
        need = max(-(-ln // page), 1)
        tables[i, :need] = perm[used:used + need]
        used += need
        lens[i] = ln
    q = torch.from_numpy(rng.standard_normal(
        (b, t_q, h, d)).astype(np.float32)).to(dev)
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(lens).to(dev))


def prefill_work(seg: np.ndarray, h: int, d: int):
    """(bytes, flops) a packed causal prefill must move / do: q, k, v and
    segments read once, out and lse written once; 4*D flops per (query,
    visible key) per head."""
    t = seg.size
    n_bytes = 4 * (4 * t * h * d + t + h * t)
    pairs = 0
    for s in np.unique(seg[seg >= 0]):
        n = int((seg == s).sum())
        pairs += n * (n + 1) // 2
    return n_bytes, 4 * d * h * pairs


def decode_work(lengths: np.ndarray, t_q: int, h: int, d: int,
                max_pages: int):
    """(bytes, flops) of one decode call: q read and out written once,
    each row's visible K/V rows read once, tables and lengths read."""
    b = lengths.size
    keys = np.maximum(lengths, 0)
    n_bytes = 4 * (2 * b * t_q * h * d + 2 * int(keys.sum()) * h * d
                   + b * max_pages + b)
    vis = sum(max(int(ln) - t_q + r + 1, 0)
              for ln in lengths for r in range(t_q))
    return n_bytes, 4 * d * h * vis


# ------------------------------------------------------------------ phases
def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: " + smi.stderr.strip()
    log(f"card: {line}")
    log(f"torch: {torch.__version__} cuda {torch.version.cuda}; device "
        f"{torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}")
    return line


def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"build: {len(paths)} kernels in {time.perf_counter() - t0:.2f} s "
        f"(nvcc -gencode arch=compute_90a,code=sm_90a, parallel)")
    for stem, info in sorted(_build.build_info.items()):
        log(f"  {stem}: {info['seconds']:.2f} s")
        for ln in info["ptxas"].splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"    {ln.strip()}")


def phase_check(dev):
    import torch
    from paddle_tpu_torch.ops import attention as A
    rng = np.random.default_rng(1)
    errs = {"flash_packed_fwd": 0.0, "paged_decode": 0.0}
    h, d = CFG["heads"], CFG["dim"] // CFG["heads"]
    launched = A.prefill_attention_packed.launches
    mixed = [int(x) for x in rng.integers(T_LO, T_HI + 1, 7)] + [0]
    cases = [([11], 16, True), ([48, 0, 17], 48, True), (mixed, 96, True),
             ([48, 0, 17], 48, False)]
    for lengths, slot, causal in cases:
        q, k, v, seg = packed_case(rng, lengths, slot, h, d, dev)
        out, lse = A.prefill_attention_packed(q, k, v, seg, causal=causal)
        ref, ref_lse = A._dense_forward(q, k, v, None, causal, seg)
        sync(dev)
        valid = (seg >= 0)[0]
        e = max((out - ref).abs().max().item(),
                (lse - ref_lse)[:, :, valid].abs().max().item())
        log(f"  prefill T={seg.shape[1]} lengths={lengths} causal={causal}:"
            f" max abs err {e:.3e}")
        errs["flash_packed_fwd"] = max(errs["flash_packed_fwd"], e)
        if lengths is mixed:
            prefill_alone_check(A, q, k, v, out, lse, lengths, slot, dev)
    # general segments: irregular runs, padding between, not slot-aligned
    seg_np = np.full((1, 144), -1, np.int32)
    pos, sid = 3, 0
    while pos < 140:
        n = int(rng.integers(1, 30))
        seg_np[0, pos:pos + n] = sid
        pos += n + int(rng.integers(0, 3))
        sid += 1
    q, k, v, _ = packed_case(rng, [144], 144, h, d, dev)
    seg = torch.from_numpy(seg_np).to(dev)
    out, lse = A.prefill_attention_packed(q, k, v, seg, causal=True)
    ref, ref_lse = A._dense_forward(q, k, v, None, True, seg)
    sync(dev)
    e = (out - ref).abs().max().item()
    log(f"  prefill T=144 general segments ({sid} runs): max abs err {e:.3e}")
    errs["flash_packed_fwd"] = max(errs["flash_packed_fwd"], e)
    for t_q, lengths in ((1, [1, 37, 300, 512, -1, 16, 0, -1]),
                         (4, [2, 3, 4, 130, 511, -1, 0, 77])):
        args = decode_case(rng, lengths, t_q, h, d, POOL_PAGES, PAGE, 32,
                           dev)
        out = A.paged_decode_attention(*args)
        ref = A.paged_decode_reference(*args)
        sync(dev)
        e = (out - ref).abs().max().item()
        log(f"  decode Tq={t_q} lengths={lengths}: max abs err {e:.3e}")
        errs["paged_decode"] = max(errs["paged_decode"], e)
    # the other compiled head-dim variants (R = 2, 4, 8; D = 36 ragged)
    for d2 in (36, 64, 128, 256):
        q, k, v, seg = packed_case(rng, [20, 0, 9], 32, 2, d2, dev)
        out, lse = A.prefill_attention_packed(q, k, v, seg, causal=True)
        ref, _ = A._dense_forward(q, k, v, None, True, seg)
        args = decode_case(rng, [1, 40, -1, 0], 2, 2, d2, 64, PAGE, 4, dev)
        e1 = (out - ref).abs().max().item()
        e2 = (A.paged_decode_attention(*args)
              - A.paged_decode_reference(*args)).abs().max().item()
        sync(dev)
        log(f"  head dim {d2}: prefill max abs err {e1:.3e}, decode Tq=2 "
            f"{e2:.3e}")
        errs["flash_packed_fwd"] = max(errs["flash_packed_fwd"], e1)
        errs["paged_decode"] = max(errs["paged_decode"], e2)
    # windows longer than one chunk of staged rows (35 rows at D 256), so
    # the kernel stages and walks them in three chunks
    for causal in (True, False):
        q, k, v, seg = packed_case(rng, [100, 37], 112, 2, 256, dev)
        out, lse = A.prefill_attention_packed(q, k, v, seg, causal=causal)
        ref, ref_lse = A._dense_forward(q, k, v, None, causal, seg)
        sync(dev)
        valid = (seg >= 0)[0]
        e = max((out - ref).abs().max().item(),
                (lse - ref_lse)[:, :, valid].abs().max().item())
        log(f"  prefill T=224 head dim 256 lengths=[100, 37] causal={causal}"
            f" (chunked rows): max abs err {e:.3e}")
        errs["flash_packed_fwd"] = max(errs["flash_packed_fwd"], e)
    # 4 + 1 + 4 + 2 prefill calls above and one alone for each prompt of
    # the mixed case, each at a shape the dispatch sends to the kernel
    if A.prefill_attention_packed.launches - launched \
            != 11 + sum(n > 0 for n in mixed):
        fail("a prefill check did not launch flash_packed_fwd")
    for name, e in errs.items():
        if not e <= ATOL:
            fail(f"{name} disagrees with its plain version: {e} > {ATOL}")
    return errs


def prefill_alone_check(A, q, k, v, out, lse, lengths, slot, dev):
    """Each prompt of a pack alone (B 1 at its own bucket of 16 tokens)
    must give the same bits as its rows in the pack, out and lse: the
    serving prefill is batch invariant."""
    import torch
    for i, n in enumerate(lengths):
        if n == 0:
            continue
        bucket = -(-n // 16) * 16
        rows = slice(i * slot, i * slot + bucket)
        seg = A.segments_from_lengths(
            torch.tensor([n], dtype=torch.int32, device=dev), 1, bucket)
        o, l = A.prefill_attention_packed(
            *(x[:, rows].contiguous() for x in (q, k, v)),
            seg.contiguous(), causal=True)
        mine = slice(i * slot, i * slot + n)
        if not (torch.equal(o[:, :n], out[:, mine])
                and torch.equal(l[:, :, :n], lse[:, :, mine])):
            fail(f"prefill: prompt {i} (length {n}) alone differs from its "
                 "rows in the pack")
    log(f"  prefill: each of the {sum(n > 0 for n in lengths)} prompts alone "
        "(at its bucket) == its rows in the pack, bit for bit")


def _serve(model, prompts, continuous, warm=True):
    """One timed pass of ``prompts`` through a fresh server (after a warm
    pass when ``warm``).  The launch counts are set to 0 just before the
    timed pass and read just after it."""
    from paddle_tpu_torch.serving.server import InferenceServer
    srv = InferenceServer(model, max_batch=MAX_BATCH, n_pages=POOL_PAGES,
                          page_size=PAGE, continuous=continuous).start()
    try:
        if warm:
            for r in [srv.submit(p, MAX_NEW) for p in prompts]:
                srv.result(r, timeout=600.0)
        reset_counts()
        t0 = time.perf_counter()
        reqs = [srv.submit(p, MAX_NEW) for p in prompts]
        tokens = [srv.result(r, timeout=600.0) for r in reqs]
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        srv.stop()
    ttft = np.array([r.ttft_s for r in reqs]) * 1e3
    n_tok = sum(len(t) for t in tokens)
    return tokens, {"req_per_s": len(prompts) / wall,
                    "ttft_p50_ms": float(np.percentile(ttft, 50)),
                    "ttft_p99_ms": float(np.percentile(ttft, 99)),
                    "tokens_per_s": n_tok / wall, "tokens": n_tok,
                    "wall_s": wall, "launches": launches}


def _prompts(seed, n, vocab):
    # ids start at 2: never the eos id, as in bench.py's serving lane
    rng = np.random.RandomState(seed)
    return [rng.randint(2, vocab, rng.randint(T_LO, T_HI + 1)).tolist()
            for _ in range(n)]


def _check_equal(cont_tokens, seq_tokens, what):
    if cont_tokens != seq_tokens:
        bad = [i for i, (a, b) in enumerate(zip(cont_tokens, seq_tokens))
               if a != b]
        fail(f"continuous and sequential tokens differ for requests {bad} "
             f"({what})")
    log(f"  continuous == sequential tokens for all {len(cont_tokens)} "
        f"requests ({what})")


def phase_serve(dev):
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.serving.model import (DecoderConfig, DecoderModel,
                                                init_decoder_params)
    cfg = DecoderConfig(**CFG)
    params = init_decoder_params(cfg, seed=0)
    model = DecoderModel(params, cfg, device=dev)
    prompts = _prompts(0, N_REQ, cfg.vocab)
    A.attention_dispatch_total.clear()
    cont_tokens, cont = _serve(model, prompts, continuous=True)
    seq_tokens, seq = _serve(model, prompts, continuous=False)
    # the prefill's decisions (warm and timed passes of both modes): the
    # reference's labels at these shapes -- kernel 1 in serving form, or
    # dense where B*T packed tokens tile at no block the gate takes
    decisions = dict(A.attention_dispatch_total)
    log(f"  prefill decisions (defaults, both modes): {decisions}")
    if not set(decisions) <= set(PREFILL_DEFAULT_LABELS) or not any(
            path == "packed" for path, _ in decisions):
        fail(f"prefill decisions under the defaults: {decisions}")
    for mode, m in (("continuous", cont), ("sequential", seq)):
        log(f"  {mode}: {m['req_per_s']:.3f} req/s, TTFT p50 "
            f"{m['ttft_p50_ms']:.3f} ms p99 {m['ttft_p99_ms']:.3f} ms, "
            f"{m['tokens_per_s']:.1f} tokens/s ({m['tokens']} tokens in "
            f"{m['wall_s']:.3f} s); launches in the timed pass "
            f"{m['launches']}")
        for name in SERVING_KERNELS:
            if m["launches"][name] <= 0:
                fail(f"kernel {name} was not launched on the {mode} path")
    _check_equal(cont_tokens, seq_tokens, "prompt seed 0")
    kill = phase_serve_kill_switches(model, prompts, cont_tokens, cfg)
    if not all(1 <= len(t) <= MAX_NEW and all(0 <= x < cfg.vocab for x in t)
               for t in cont_tokens):
        fail("generated tokens out of range")
    # the equality also rests on argmax margins (the projections are not
    # row-invariant), so hold it on a second prompt stream as well
    more = _prompts(1, 16, cfg.vocab)
    _check_equal(_serve(model, more, True, warm=False)[0],
                 _serve(model, more, False, warm=False)[0], "prompt seed 1")
    launches = {name: {"serving_continuous": cont["launches"][name],
                       "serving_sequential": seq["launches"][name]}
                for name in cont["launches"]}

    # the same model on the CPU (plain versions) on a small input
    cpu = DecoderModel(params, cfg, device="cpu")
    small = [p[:20] for p in prompts[:2]]
    lengths = np.array([len(p) for p in small], np.int32)
    toks = np.zeros((2, 32), np.int32)
    for i, p in enumerate(small):
        toks[i, :len(p)] = p
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    worst = 0.0
    state = {}
    for name, m in (("cuda", model), ("cpu", cpu)):
        kp, vp = m.new_pools(9, PAGE)
        nxt, logits, kp, vp = m.prefill(kp, vp, toks, lengths, tables)
        seq_n, seq_l = [nxt], [logits.float().cpu().numpy()]
        ln = lengths.copy()
        for _ in range(4):
            ln = ln + 1
            nxt, logits, kp, vp = m.decode(kp, vp, nxt, tables, ln,
                                           np.ones(2, bool))
            seq_n.append(nxt)
            seq_l.append(logits.float().cpu().numpy())
        state[name] = (seq_n, seq_l)
    for a, b in zip(state["cuda"][1], state["cpu"][1]):
        if a.shape != (2, cfg.vocab) or not np.isfinite(a).all():
            fail(f"logits shape {a.shape} or non-finite values")
        worst = max(worst, float(np.abs(a - b).max()))
    same = all(np.array_equal(a, b) for a, b in
               zip(state["cuda"][0], state["cpu"][0]))
    log(f"  card vs CPU plain path, 2 prompts x (prefill + 4 decode steps):"
        f" max |logit diff| {worst:.3e}, tokens equal {same}")
    if worst > 1e-3 or not same:
        fail("card and CPU reference disagree")
    lens = [len(p) for p in prompts]
    for m in (cont, seq):
        del m["launches"]
    return launches, {"continuous": cont, "sequential": seq,
                      "prompt_lengths": lens, "kill_switches": kill}, \
        model, prompts


#: the prefill's labels under the default flags: one block spans the
#: slots (B > 1), a usable slot hint (B = 1), an untileable B*T
PREFILL_DEFAULT_LABELS = (
    ("packed", ""), ("packed", "slot hint unusable (blocks straddle slots)"),
    ("dense", "untileable shape (lse/kv block constraints)"))
#: flag switched off -> the reference's label for every prefill layer
PREFILL_KILL_LABELS = {
    "flash_kernel": ("dense", "kill_switch:flash_kernel"),
    "flash_block_sparse": ("dense", "kill_switch:flash_block_sparse(packed)")}


def phase_serve_kill_switches(model, prompts, want_tokens, cfg):
    """The continuous server under each attention kill switch (one pass
    each, set to 0 just before it): the prefill never launches kernel 1's
    serving form, every prefill layer records the reference's label, and
    the tokens are the default run's (fault C4)."""
    from paddle_tpu_torch.ops import attention as A
    rows = {}
    for flag, label in PREFILL_KILL_LABELS.items():
        set_flags(**{flag: False})
        try:
            A.attention_dispatch_total.clear()
            tokens, m = _serve(model, prompts, continuous=True, warm=False)
            decisions = dict(A.attention_dispatch_total)
        finally:
            set_flags(**{flag: True})
        n = m["launches"]["flash_packed_fwd"]
        log(f"  --{flag}=false: {m['req_per_s']:.3f} req/s, TTFT p50 "
            f"{m['ttft_p50_ms']:.3f} ms; flash_packed_fwd launches {n}, "
            f"paged_decode {m['launches']['paged_decode']}; prefill "
            f"decisions {decisions}; tokens equal the default run's "
            f"{tokens == want_tokens}")
        if n != 0 or set(decisions) != {label} \
                or decisions[label] % cfg.layers:
            fail(f"--{flag}=false: the prefill launched kernel 1 {n} times "
                 f"or took decisions {decisions}, not {label} a layer")
        if tokens != want_tokens:
            fail(f"--{flag}=false: tokens differ from the default run's")
        rows[flag] = {"req_per_s": m["req_per_s"],
                      "ttft_p50_ms": m["ttft_p50_ms"],
                      "flash_packed_fwd_launches": n,
                      "prefill_layers": decisions[label]}
    return rows


def phase_rms_invariance(dev):
    """The RMS mean (x^2 over the model width) must give a row the same
    bits at every row count the server runs, or continuous and
    sequential serving would diverge before the first projection."""
    import torch
    x = torch.randn(768, CFG["dim"], generator=torch.Generator()
                    .manual_seed(0)).to(dev)
    bits = {m: x[:m].square().mean(-1)[0].item()
            for m in (1, 8, 16, 144, 768)}
    if len(set(bits.values())) != 1:
        fail(f"RMS mean of row 0 changes with the row count: {bits}")
    log(f"  RMS mean of row 0 equal at row counts {sorted(bits)}")


def device_rows(prof):
    """(name, device µs, count) of every device-side item (kernels and
    copies) in a profile; the host ops that launched them carry the same
    device time and are left out, so the sum is the device's busy time."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


#: the serving kernels' device-side names in a profile
SERVING_PROFILE_MARKS = {"kernel 1": "flash_packed_fwd_kernel",
                         "kernel 7": "paged_decode_kernel"}


def phase_profile(model, prompts):
    """One continuous pass under torch.profiler: device time by
    kernel and the device's busy share of the pass's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving.server import InferenceServer
    srv = InferenceServer(model, max_batch=MAX_BATCH, n_pages=POOL_PAGES,
                          page_size=PAGE, continuous=True).start()
    try:
        for r in [srv.submit(p, MAX_NEW) for p in prompts]:     # warm pass
            srv.result(r, timeout=600.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for r in [srv.submit(p, MAX_NEW) for p in prompts]:
                srv.result(r, timeout=600.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        srv.stop()
    rows = device_rows(prof)
    busy_us = sum(r[1] for r in rows)
    log(f"  profiled continuous pass: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / (wall * 1e6):.1f} %)")
    rows.sort(key=lambda r: -r[1])
    # the largest items, and every copy (host-to-device traffic per step)
    for key, us, n in rows[:14] + [r for r in rows[14:] if "Memcpy" in r[0]]:
        log(f"    {us / 1e3:9.3f} ms  {n:6d} x  {key[:90]}")
    for label, mark in SERVING_PROFILE_MARKS.items():
        us = sum(r[1] for r in rows if mark in r[0])
        n = sum(r[2] for r in rows if mark in r[0])
        log(f"  {label} ({mark}): {us / 1e3:.3f} ms over {n} launches")


def phase_time(dev, launches, serve):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import attention as A
    rng = np.random.default_rng(2)
    h, d = CFG["heads"], CFG["dim"] // CFG["heads"]
    rows = []

    # prefill: the first admission round, 8 prompts packed at their bucket
    lens = serve["prompt_lengths"][:MAX_BATCH]
    slot = -(-max(lens) // 16) * 16
    q, k, v, seg = packed_case(rng, lens, slot, h, d, dev)
    out, lse = A.prefill_attention_packed(q, k, v, seg, causal=True)
    ref, _ = A._dense_forward(q, k, v, None, True, seg)
    err = (out - ref).abs().max().item()
    t = seg.shape[1]
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    s = seg[0]
    idx = torch.arange(t, device=dev)
    mask = ((s[:, None] == s[None, :]) & (s[:, None] >= 0)
            & (idx[:, None] >= idx[None, :]))[None, None]
    ms = time_ms(lambda: A.prefill_attention_packed(q, k, v, seg,
                                                  causal=True))
    plain_ms = time_ms(lambda: A._dense_forward(q, k, v, None, True, seg))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    nb, nf = prefill_work(seg.cpu().numpy(), h, d)
    b_ms, b_by = bound_ms(nb, nf)
    rows.append({"name": "flash_packed_fwd", "route": "cuda",
                 "source": "paddle_tpu_torch/csrc/flash_packed_fwd.cu",
                 "replaces": "paddle_tpu/ops/pallas_attention.py:255",
                 "launches": sum(launches["flash_packed_fwd"].values()),
                 "launches_by_path": launches["flash_packed_fwd"],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                 "shape": f"q [1,{t},{h},{d}] causal, {len(lens)} segments"})

    # decode: 8 active rows mid-generation over the main path's pool
    dl = [ln + MAX_NEW // 2 for ln in lens]
    max_pages = -(-CFG["max_context"] // PAGE)
    q, kp, vp, tables, lengths = decode_case(
        rng, dl, 1, h, d, POOL_PAGES, PAGE, max_pages, dev)
    out = A.paged_decode_attention(q, kp, vp, tables, lengths)
    ref = A.paged_decode_reference(q, kp, vp, tables, lengths)
    err = (out - ref).abs().max().item()
    n_max = max_pages * PAGE
    gk = kp[tables.reshape(-1).long()].reshape(
        len(dl), n_max, h, d).transpose(1, 2).contiguous()
    gv = vp[tables.reshape(-1).long()].reshape(
        len(dl), n_max, h, d).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()
    kmask = (torch.arange(n_max, device=dev)[None, :]
             < lengths[:, None])[:, None, None, :]
    ms = time_ms(lambda: A.paged_decode_attention(q, kp, vp, tables,
                                                  lengths))
    plain_ms = time_ms(lambda: A.paged_decode_reference(
        q, kp, vp, tables, lengths))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, gk, gv, attn_mask=kmask))
    nb, nf = decode_work(np.array(dl), 1, h, d, max_pages)
    b_ms, b_by = bound_ms(nb, nf)
    rows.append({"name": "paged_decode", "route": "cuda",
                 "source": "paddle_tpu_torch/csrc/paged_decode.cu",
                 "replaces": "paddle_tpu/ops/pallas_attention.py:1174",
                 "launches": sum(launches["paged_decode"].values()),
                 "launches_by_path": launches["paged_decode"],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                 "shape": f"q [8,1,{h},{d}], pool [{POOL_PAGES},{PAGE},{h},"
                          f"{d}], {max_pages} pages/row, lengths {dl}"})
    from paddle_tpu_torch.ops import _build
    floor = _build.kernel("launch_floor")
    floor_ms = time_ms(lambda: floor(torch.cuda.current_stream().cuda_stream))
    log(f"  launch floor (an empty kernel, the same graph replay): "
        f"{floor_ms * 1e3:.2f} us")
    for r in rows:
        if not r["max_abs_err"] <= ATOL:
            fail(f"{r['name']} disagrees at the main path's shapes")
        log(f"  {r['name']}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us, SDPA {r['library_ms'] * 1e3:.2f}"
            f" us, bound {r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}); "
            f"{r['shape']}")
    return rows


# ------------------------------------------------------------ LSTM phases
def lstm_case(b, t, h, lengths, seed, dev):
    """Random LSTM inputs (xw, w_hh, gate bias, peepholes, boot state) and
    cotangents on (y, cells, final h, final c); lengths int32 [B]."""
    import torch
    rng = np.random.default_rng(seed)

    def f(*shape, sc=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * sc)
                                .astype(np.float32)).to(dev)
    p = {"xw": f(b, t, 4 * h, sc=0.3), "w": f(h, 4 * h, sc=h ** -0.5),
         "bias": f(4 * h, sc=0.1), "ci": f(h, sc=0.1), "cf": f(h, sc=0.1),
         "co": f(h, sc=0.1), "h0": f(b, h, sc=0.5), "c0": f(b, h, sc=0.5)}
    cot = [f(b, t, h), f(b, t, h), f(b, h), f(b, h)]
    return p, cot, torch.tensor(lengths, dtype=torch.int32, device=dev)


def rnn_route(kind, b, h):
    """How a kernel check reaches the fused kernels at (b, h): through
    ``lstm_sequence`` / ``gru_sequence`` where the reference's dispatch
    rule sends the shape to them, else by calling the tier's fused entry
    directly (the kernels still serve odd shapes)."""
    from paddle_tpu_torch.ops import recurrent_ops as R
    tier = R.dispatch_tier(b, h, 3 if kind == "gru" else 4)
    if tier is not None:
        return "sequence"
    return "fused" if h <= 512 else "blocked"


def lstm_run(p, cot, lengths, reverse, route):
    """(y, cells, final h, final c) and the gradient of every input under
    sum(output * cotangent): through ``lstm_sequence`` (``route``
    "sequence": the fused kernels on the card), the fused entry called
    directly ("fused", "blocked"), or the per-step scan ("scan")."""
    import torch
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.ops import lstm as L
    from paddle_tpu_torch.ops import recurrent_ops as R
    q = {n: v.detach().clone().requires_grad_(True) for n, v in p.items()}
    seq = SequenceBatch(q["xw"], lengths)
    if route != "sequence":
        fn = {"scan": R.lstm_scan, "fused": L.lstm_fused_sequence,
              "blocked": L.lstm_fused_sequence_blocked}[route]
        xw, mask = q["xw"] + q["bias"], seq.mask()
        if reverse:
            xw, mask = torch.flip(xw, (1,)), torch.flip(mask, (1,))
        y, cy, fh, fc = fn(xw, mask, q["w"], q["ci"], q["cf"], q["co"],
                           q["h0"], q["c0"])
        if reverse:
            y, cy = torch.flip(y, (1,)), torch.flip(cy, (1,))
    else:
        out, final, cells = R.lstm_sequence(
            seq, None, q["w"], q["bias"], q["ci"], q["cf"], q["co"],
            h0=q["h0"], c0=q["c0"], reverse=reverse, return_cells=True)
        y, cy, fh, fc = out.data, cells.data, final.h, final.c
    outs = (y, cy, fh, fc)
    loss = sum((o * c).sum() for o, c in zip(outs, cot))
    grads = torch.autograd.grad(loss, list(q.values()))
    return [o.detach() for o in outs], dict(zip(q, grads))


def grad_errors(got, want, atol=LSTM_GRAD_ATOL, rtol=LSTM_GRAD_RTOL):
    """(max abs error, worst error / tolerance) over gradients by name:
    tolerance atol + rtol * max|ref| per gradient, plus one bf16 ulp of
    the larger value where the gradient is bf16 (a bf16 input gets its
    gradient rounded to bf16 on both paths)."""
    import torch
    err, ratio = 0.0, 0.0
    for name, w in want.items():
        g, w = got[name].float(), w.float()
        d = (g - w).abs()
        tol = atol + rtol * w.abs().max().item()
        if want[name].dtype == torch.bfloat16:
            tol = tol + torch.maximum(g.abs(), w.abs()) * 2.0 ** -7
        err = max(err, d.max().item())
        ratio = max(ratio, (d / tol).max().item())
    return err, ratio


def phase_lstm_check(dev):
    rng = np.random.RandomState(3)
    main_lens = rng.randint(TRAIN_T // 2, TRAIN_T + 1, TRAIN_B).tolist()
    cases = [((8, 12, 128), [12, 0, 7, 12, 3, 1, 9, 12], False),
             ((8, 12, 128), [12, 0, 7, 12, 3, 1, 9, 12], True),
             ((5, 7, 96), [7, 0, 3, 7, 5], False),
             ((6, 9, 200), [9, 0, 4, 9, 1, 7], True),      # 2 units a CTA
             # > 128 rows (two row chunks), H % 4 != 0 (scalar staging)
             ((200, 5, 50), [5, 0] + [1 + i % 5 for i in range(198)], False),
             ((3, 1, 64), [1, 0, 1], False),                # one step
             ((TRAIN_B, TRAIN_T, TRAIN["hidden_size"]), main_lens, False)]
    errs = {"lstm_fwd": 0.0, "lstm_bwd": 0.0}
    for i, ((b, t, h), lengths, reverse) in enumerate(cases):
        p, cot, ln = lstm_case(b, t, h, lengths, 10 + i, dev)
        route = rnn_route("lstm", b, h)
        got_o, got_g = lstm_run(p, cot, ln, reverse, route)
        want_o, want_g = lstm_run(p, cot, ln, reverse, "scan")
        sync(dev)
        e_out = max((g - w).abs().max().item()
                    for g, w in zip(got_o, want_o))
        e_grad, ratio = grad_errors(got_g, want_g)
        log(f"  lstm B={b} T={t} H={h} reverse={reverse} ({route}): "
            f"outputs max abs "
            f"err {e_out:.3e}; gradients max abs err {e_grad:.3e} "
            f"({ratio:.3f} of tolerance)")
        if not e_out <= LSTM_ATOL:
            fail(f"lstm_fwd disagrees with the plain scan at B={b} T={t} "
                 f"H={h}: {e_out} > {LSTM_ATOL}")
        if not ratio <= 1.0:
            fail(f"lstm_bwd disagrees with autograd through the plain scan "
                 f"at B={b} T={t} H={h}: {ratio:.3f} of tolerance")
        errs["lstm_fwd"] = max(errs["lstm_fwd"], e_out)
        errs["lstm_bwd"] = max(errs["lstm_bwd"], e_grad)
    return errs


def train_feed(seed, b, t, vocab, dev):
    """bench.py's LSTM feed: ids, lengths in [T/2, T], labels, drawn in
    that order from ``RandomState(seed)``."""
    import torch
    from paddle_tpu_torch.core.sequence import SequenceBatch
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, t)).astype(np.int32)
    lengths = rng.randint(t // 2, t + 1, (b,)).astype(np.int32)
    labels = rng.randint(0, 2, (b,)).astype(np.int32)
    return {"data": SequenceBatch(torch.from_numpy(ids),
                                  torch.from_numpy(lengths)).to(dev),
            "label": torch.from_numpy(labels).to(dev)}


def phase_train(dev, dims=TRAIN, steps=TIMED_STEPS, precision="fp32",
                kernels=TRAINING_KERNELS, idle=()):
    """A training main path at full width: warm steps, then the timed
    steps with every launch count set to 0 just before them; each of
    ``kernels`` must launch once per LSTM layer per step, each of
    ``idle`` never."""
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import lstm_text_classifier
    from paddle_tpu_torch.trainer.trainer import Trainer
    net = NeuralNetwork(lstm_text_classifier(**dims))
    trainer = Trainer(net, OptimizationConfig(**TRAIN_OPT,
                                              precision=precision),
                      seed=0, device=dev)
    feed = train_feed(0, TRAIN_B, TRAIN_T, dims["vocab_size"], dev)
    warm = [float(trainer.train_one_batch(feed)) for _ in range(WARM_STEPS)]
    launches, losses, ms, wall_ms, peak = timed_steps(trainer, feed, steps)
    m = {"ms_per_step": ms, "samples_per_s": TRAIN_B * 1e3 / ms,
         "host_wall_ms_per_step": wall_ms, "peak_mem_gb": peak,
         "warm_losses": warm, "losses": losses}
    if trainer._ls_state is not None:
        m["loss_scale"] = float(trainer._ls_state.scale)
        m["skipped_steps"] = int(trainer._ls_state.skipped_total)
    from paddle_tpu_torch.utils import FLAGS
    mode = f"precision {precision}, use_bf16 {FLAGS.get('use_bf16')}, " \
        f"bf16_activations {FLAGS.get('bf16_activations')}"
    log(f"  {steps} timed steps ({mode}): {ms:.3f} ms/step (CUDA "
        f"events), {m['samples_per_s']:.1f} samples/s, host wall "
        f"{m['host_wall_ms_per_step']:.3f} ms/step, peak memory "
        f"{m['peak_mem_gb']:.2f} GB; launches "
        f"{ {k: v for k, v in launches.items() if v} }"
        + (f"; loss scale {m['loss_scale']}, skipped {m['skipped_steps']}"
           if "loss_scale" in m else ""))
    log(f"  losses: warm {[round(x, 6) for x in warm]}, timed "
        f"{[round(x, 6) for x in losses]}")
    if not all(np.isfinite(warm + losses)):
        fail("non-finite training loss")
    for name in kernels:
        want = dims["lstm_num"] * steps
        if launches[name] != want:
            fail(f"{name}: {launches[name]} launches in {steps} steps, "
                 f"expected {want} (one per LSTM layer per step)")
    for name in idle:
        if launches[name]:
            fail(f"{name} launched {launches[name]} times on a path that "
                 "must not run it")
    return launches, m, trainer, feed


def phase_train_small(dev, hidden=128):
    """The same model on the CPU (plain versions) and on the card at
    (B, T) = (8, 12), from the same parameters: loss and every
    gradient."""
    import torch
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import lstm_text_classifier
    net = NeuralNetwork(lstm_text_classifier(**dict(TRAIN,
                                                    hidden_size=hidden)))
    cpu_params = net.init_params(seed=0, device="cpu")
    res = {}
    for where in ("cpu", dev):
        params = {n: p.to(where).requires_grad_(True)
                  for n, p in cpu_params.items()}
        loss, _ = net.loss(params, train_feed(1, 8, 12, TRAIN["vocab_size"],
                                              where))
        grads = torch.autograd.grad(loss, list(params.values()))
        res[str(where)] = (loss.detach().cpu(),
                           {n: g.cpu() for n, g in zip(params, grads)})
    (l_cpu, g_cpu), (l_dev, g_dev) = res["cpu"], res[str(dev)]
    e_loss = abs(float(l_dev) - float(l_cpu))
    e_grad, ratio = grad_errors(g_dev, g_cpu)
    log(f"  card vs CPU plain path, B=8 T=12 H={hidden}: loss "
        f"{float(l_dev):.6f} vs {float(l_cpu):.6f}; gradients max abs err "
        f"{e_grad:.3e} ({ratio:.3f} of tolerance)")
    if not np.isfinite(float(l_dev)) \
            or e_loss > LSTM_GRAD_ATOL + LSTM_GRAD_RTOL * abs(float(l_cpu)) \
            or ratio > 1.0:
        fail("card and CPU reference disagree on the training step")


#: substrings of the port's own kernels' symbols in a profile
PORT_KERNEL_MARKS = ("conv3x3", "lstm", "gru_", "flash_", "paged_decode",
                     "embedding_gather", "compact_rows", "reduce_splits")


#: the LSTM kernels by the marks of their symbols in a profile
LSTM_PROFILE_MARKS = {"kernel 8": "lstm_fwd_wg_kernel<",
                      "kernel 9": "lstm_bwd_wg_kernel<256",
                      "kernel 10": "lstm_fwd_blocked_kernel",
                      "kernel 11": "lstm_bwd_wg_kernel<384",
                      "kernel 12": "lstm_dw_blocked_kernel<"}
#: the GRU kernels by the marks of their symbols in a profile
#: (kernels 14 and 16 are one template, gru_bwd_wg_kernel, told apart
#: by its CTA: 256 threads for 14, 384 for 16)
GRU_PROFILE_MARKS = {"kernel 13": "gru_fwd_cluster_kernel",
                     "kernel 14": "gru_bwd_wg_kernel<256",
                     "kernel 15": "gru_fwd_blocked_kernel",
                     "kernel 16": "gru_bwd_wg_kernel<384",
                     "kernel 17": "gru_dw_blocked_kernel"}


def phase_profile_train(trainer, feed, named=()):
    """3 training steps under torch.profiler: device time by kernel (the
    14 largest, and the port's own kernels further down), the device's
    busy share, and the device time a step of each kernel in ``named``
    (keys of ``LSTM_PROFILE_MARKS`` or ``GRU_PROFILE_MARKS``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.train_one_batch(feed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_us = sum(r[1] for r in rows)
    log(f"  profiled 3 steps: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / (wall * 1e6):.1f} %), "
        f"{sum(r[2] for r in rows) / 3:.0f} device items (kernels and "
        "copies) a step")
    rows.sort(key=lambda r: -r[1])
    for key, us, n in rows[:14] + [
            r for r in rows[14:] if any(m in r[0] for m in PORT_KERNEL_MARKS)]:
        log(f"    {us / 1e3:9.3f} ms ({us / 3e3:8.3f} a step)  {n:6d} x  "
            f"{key[:90]}")
    for label in named:
        mark = {**LSTM_PROFILE_MARKS, **GRU_PROFILE_MARKS}[label]
        us = sum(r[1] for r in rows if mark in r[0])
        n = sum(r[2] for r in rows if mark in r[0])
        log(f"  {label} ({mark}): {us / 3e3:.3f} ms a step, {n / 3:.0f} "
            "launches a step")


def lstm_work(b, t, h, n_valid, backward):
    """(bytes, flops) of one LSTM kernel call: every input read once and
    every output written once; the recurrent products of the valid
    (row, step) pairs (padded steps do no needed work)."""
    full, gates, state = b * t, b * t * 4 * h, b * t * h
    if not backward:   # xw, mask, w, checks, h0, c0 -> H, C, gates
        n = 2 * gates + 2 * state + full + h * 4 * h + 3 * h + 2 * b * h
        return 4 * n, 2 * n_valid * h * 4 * h
    # gates, H, C, h0, c0, mask, w, checks, dy, dyc -> dxw, dw, dck, dh0, dc0
    n = 2 * gates + 4 * state + full + 2 * h * 4 * h + 6 * h + 4 * b * h
    return 4 * n, 2 * 2 * n_valid * h * 4 * h


def phase_time_lstm(dev, launches):
    import torch
    from paddle_tpu_torch.ops import lstm as L
    b, t, h = TRAIN_B, TRAIN_T, TRAIN["hidden_size"]
    rng = np.random.RandomState(0)
    rng.randint(0, TRAIN["vocab_size"], (b, t))       # bench feed order
    lengths = rng.randint(t // 2, t + 1, (b,))
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, sc=1.0):
        return torch.randn(*shape, generator=g, device=dev) * sc
    mask = (torch.arange(t, device=dev)[None, :]
            < torch.from_numpy(lengths).to(dev)[:, None]).float()
    xw, w = rnd(b, t, 4 * h, sc=0.3), rnd(h, 4 * h, sc=h ** -0.5)
    checks, h0, c0 = rnd(3, h, sc=0.1), rnd(b, h, sc=0.5), rnd(b, h, sc=0.5)
    fwd_args = (xw, mask, w, checks, h0, c0)
    hseq, cseq, gates = L.lstm_fwd(*fwd_args)
    ref = L.lstm_fwd_reference(*fwd_args)
    e_fwd = max((a - r).abs().max().item()
                for a, r in zip((hseq, cseq, gates), ref))
    dy, dyc = rnd(b, t, h), rnd(b, t, h)
    bwd_args = (gates, hseq, cseq, h0, c0, mask, w, checks, dy, dyc)
    got = L.lstm_bwd(*bwd_args)
    want = L.lstm_bwd_reference(*bwd_args)
    e_bwd, ratio = grad_errors(dict(enumerate(got)), dict(enumerate(want)))
    if not (e_fwd <= LSTM_ATOL and ratio <= 1.0):
        fail(f"LSTM kernels disagree with their plain versions at the main "
             f"shapes: forward {e_fwd}, backward {ratio:.3f} of tolerance")
    rows = []
    n_valid = int(lengths.sum())
    for name, fn, plain, args, bwd, line in (
            ("lstm_fwd", L.lstm_fwd, L.lstm_fwd_reference, fwd_args, False,
             146),
            ("lstm_bwd", L.lstm_bwd, L.lstm_bwd_reference, bwd_args, True,
             219)):
        ms = time_ms(lambda: fn(*args), reps=5, rounds=4)
        plain_ms = time_ms(lambda: plain(*args), reps=2, rounds=2)
        n_bytes, n_flops = lstm_work(b, t, h, n_valid, bwd)
        passes, rate = LSTM_BOUND_BASIS[name]
        b_ms, b_by = bound_ms(n_bytes, passes * n_flops, rate)
        rows.append({"name": name, "route": "cuda",
                     "source": f"paddle_tpu_torch/csrc/{name}.cu",
                     "replaces": f"paddle_tpu/ops/pallas_lstm.py:{line}",
                     "launches": sum(launches[name].values()),
                     "launches_by_path": launches[name],
                     "max_abs_err": e_bwd if bwd else e_fwd, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "shape": f"B {b}, T {t}, H {h}, {n_valid} valid steps"})
    for r in rows:
        passes, rate = LSTM_BOUND_BASIS[r["name"]]
        fp32_ms = bound_ms(*lstm_work(b, t, h, n_valid,
                                      r["name"] == "lstm_bwd"))[0]
        log(f"  {r['name']}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f}"
            f" us by {r['bound_by']}, {passes} pass(es) at "
            f"{rate * 1e-12:.0f} TFLOP/s; at the fp32 rate "
            f"{fp32_ms * 1e3:.3f} us); {r['shape']}")
    # for information only: cuDNN's LSTM (no peepholes, no length mask,
    # and it also does the input product) forward + backward
    lstm = torch.nn.LSTM(h, h, batch_first=True).to(dev)
    x = rnd(b, t, h).requires_grad_(True)

    def cudnn_step():
        y, _ = lstm(x)
        y.sum().backward()
    log(f"  for information: torch.nn.LSTM({h}, {h}) forward + backward at "
        f"B {b}, T {t}, full-length rows (cuDNN): "
        f"{time_events_ms(cudnn_step) * 1e3:.2f} us")
    return rows


# ------------------------------------------------ blocked LSTM phases
def bench_lengths(b, t, seed=0):
    """The bench feed's lengths (drawn after the ids, as train_feed)."""
    rng = np.random.RandomState(seed)
    rng.randint(0, TRAIN["vocab_size"], (b, t))
    return rng.randint(t // 2, t + 1, (b,))


def blocked_args(b, t, h, lengths, seed, dev):
    """Inputs of kernels 10-12 (forward, then the forward's residuals
    with random cotangents) on the card."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, sc=1.0):
        return torch.randn(*shape, generator=g, device=dev) * sc
    mask = (torch.arange(t, device=dev)[None, :] < torch.as_tensor(
        np.asarray(lengths), device=dev)[:, None]).float()
    fwd = (rnd(b, t, 4 * h, sc=0.3), mask, rnd(h, 4 * h, sc=h ** -0.5),
           rnd(3, h, sc=0.1), rnd(b, h, sc=0.5), rnd(b, h, sc=0.5))
    return fwd, rnd(b, t, h), rnd(b, t, h)


def blocked_kernel_errors(fwd, dy, dyc):
    """(forward max abs error, backward and dW worst error / tolerance)
    of each wrapper against its plain version on the same inputs."""
    from paddle_tpu_torch.ops import lstm as L
    xw, mask, w, checks, h0, c0 = fwd
    hseq, cseq, gates = L.lstm_fwd_blocked(*fwd)
    ref = L.lstm_fwd_blocked_reference(*fwd)
    e_fwd = max((a - r).abs().max().item()
                for a, r in zip((hseq, cseq, gates), ref))
    bwd = (gates, cseq, c0, mask, w, checks, dy, dyc)
    got = L.lstm_bwd_blocked(*bwd)
    want = L.lstm_bwd_blocked_reference(*bwd)
    e_bwd, r_bwd = grad_errors(dict(enumerate(got)), dict(enumerate(want)))
    dw = L.lstm_dw_blocked(hseq, h0, got[0], mask)
    e_dw, r_dw = grad_errors({0: dw},
                             {0: L.lstm_dw_blocked_reference(hseq, h0,
                                                             got[0], mask)})
    return e_fwd, (e_bwd, r_bwd), (e_dw, r_dw)


def phase_blocked_check(dev):
    """Kernels 10-12 through their autograd.Function against autograd
    through the plain scan, and each wrapper against its plain version
    (fp32; the tolerances of 3b)."""
    cases = [((8, 5, 640), [5, 0, 1, 5, 3, 5, 2, 4], False),
             ((200, 4, 700), [4, 0] + [1 + i % 4 for i in range(198)], True),
             ((3, 1, 642), [1, 0, 1], False),
             ((TRAIN_B, TRAIN_T, 1280),
              bench_lengths(TRAIN_B, TRAIN_T).tolist(), False),
             ((TRAIN_B, TRAIN_T, 2048),
              bench_lengths(TRAIN_B, TRAIN_T).tolist(), False)]
    errs = dict.fromkeys(BLOCKED_KERNELS, 0.0)
    for i, ((b, t, h), lengths, reverse) in enumerate(cases):
        p, cot, ln = lstm_case(b, t, h, lengths, 20 + i, dev)
        route = rnn_route("lstm", b, h)
        got_o, got_g = lstm_run(p, cot, ln, reverse, route)
        want_o, want_g = lstm_run(p, cot, ln, reverse, "scan")
        sync(dev)
        e_out = max((g - w).abs().max().item()
                    for g, w in zip(got_o, want_o))
        e_grad, ratio = grad_errors(got_g, want_g)
        fwd, dy, dyc = blocked_args(b, t, h, lengths, 30 + i, dev)
        e_fwd, (e_bwd, r_bwd), (e_dw, r_dw) = blocked_kernel_errors(
            fwd, dy, dyc)
        sync(dev)
        log(f"  blocked B={b} T={t} H={h} reverse={reverse} ({route}): "
            f"vs the scan: "
            f"outputs {e_out:.3e}, gradients {e_grad:.3e} ({ratio:.3f} of "
            f"tolerance); vs plain versions: fwd {e_fwd:.3e}, bwd "
            f"{e_bwd:.3e} ({r_bwd:.3f}), dW {e_dw:.3e} ({r_dw:.3f})")
        if not max(e_out, e_fwd) <= LSTM_ATOL:
            fail(f"lstm_fwd_blocked disagrees at B={b} T={t} H={h}: "
                 f"{max(e_out, e_fwd)} > {LSTM_ATOL}")
        if not max(ratio, r_bwd, r_dw) <= 1.0:
            fail(f"lstm_bwd_blocked / lstm_dw_blocked disagree at B={b} "
                 f"T={t} H={h}: {max(ratio, r_bwd, r_dw):.3f} of tolerance")
        errs["lstm_fwd_blocked"] = max(errs["lstm_fwd_blocked"], e_out, e_fwd)
        errs["lstm_bwd_blocked"] = max(errs["lstm_bwd_blocked"], e_bwd)
        errs["lstm_dw_blocked"] = max(errs["lstm_dw_blocked"], e_dw)
    return errs


#: the bound's basis of the LSTM kernels: (passes, rate) -- 8, 9, 10, 11
#: (the step products) and 9, 12 (dW) multiply their f32 operands on the
#: tensor cores as hi*hi + hi*lo + lo*hi, three bf16 passes
#: (csrc/lstm_fwd.cu, csrc/lstm_wg.cuh, csrc/dw_wg.cuh)
LSTM_BOUND_BASIS = {"lstm_fwd": (3, BF16_FLOPS_PER_S),
                    "lstm_bwd": (3, BF16_FLOPS_PER_S),
                    "lstm_fwd_blocked": (3, BF16_FLOPS_PER_S),
                    "lstm_bwd_blocked": (3, BF16_FLOPS_PER_S),
                    "lstm_dw_blocked": (3, BF16_FLOPS_PER_S)}


def blocked_work(name, b, t, h, n_valid):
    """(bytes, flops) of one call of a blocked kernel: each input read
    once, each output written once; the products of the valid row-steps
    (2 * n_valid * H * 4H flops each: padded steps carry zeros)."""
    full, gates, state, w = b * t, b * t * 4 * h, b * t * h, h * 4 * h
    flops = 2 * n_valid * h * 4 * h
    n = {  # xw, mask, w, checks, h0, c0 -> H, C, gates
        "lstm_fwd_blocked": 2 * gates + 2 * state + full + w + 3 * h
        + 2 * b * h,
        # gates, C, c0, mask, w, checks, dy, dyc -> dxw, dh0, dc0
        "lstm_bwd_blocked": 2 * gates + 3 * state + full + w + 3 * h
        + 3 * b * h,
        # H, h0, dxw, mask -> dW
        "lstm_dw_blocked": gates + state + b * h + full + w}[name]
    return 4 * n, flops


def phase_time_blocked(dev, launches):
    """Kernels 10-12 at the H 1280 main path's shapes (the bench feed's
    lengths), each against its plain version; torch.matmul of the dW
    product as kernel 12's yardstick; the bounds on the basis of
    ``LSTM_BOUND_BASIS`` (at the fp32 rate too, in the log only)."""
    import torch
    from paddle_tpu_torch.ops import lstm as L
    b, t, h = TRAIN_B, TRAIN_T, BLOCKED["hidden_size"]
    lengths = bench_lengths(b, t)
    fwd, dy, dyc = blocked_args(b, t, h, lengths, 0, dev)
    e_fwd, (e_bwd, r_bwd), (e_dw, r_dw) = blocked_kernel_errors(fwd, dy,
                                                                dyc)
    if not (e_fwd <= LSTM_ATOL and max(r_bwd, r_dw) <= 1.0):
        fail("blocked LSTM kernels disagree with their plain versions at "
             "the main shapes")
    xw, mask, w, checks, h0, c0 = fwd
    hseq, cseq, gates = L.lstm_fwd_blocked(*fwd)
    bwd = (gates, cseq, c0, mask, w, checks, dy, dyc)
    dxw = L.lstm_bwd_blocked(*bwd)[0]
    h_prev = torch.cat([h0[:, None], hseq[:, :-1]], 1).reshape(-1, h)
    g2 = dxw.reshape(-1, 4 * h)
    n_valid = int(lengths.sum())
    rows = []
    for name, fn, plain, args, err, line, lib in (
            ("lstm_fwd_blocked", L.lstm_fwd_blocked,
             L.lstm_fwd_blocked_reference, fwd, e_fwd, 402, None),
            ("lstm_bwd_blocked", L.lstm_bwd_blocked,
             L.lstm_bwd_blocked_reference, bwd, e_bwd, 490, None),
            ("lstm_dw_blocked", L.lstm_dw_blocked,
             L.lstm_dw_blocked_reference, (hseq, h0, dxw, mask), e_dw, 602,
             lambda: torch.matmul(h_prev.t(), g2))):
        ms = time_ms(lambda: fn(*args), reps=3, rounds=3)
        plain_ms = time_ms(lambda: plain(*args), reps=2, rounds=2)
        lib_ms = time_ms(lib, reps=3, rounds=3) if lib else None
        n_bytes, n_flops = blocked_work(name, b, t, h, n_valid)
        passes, rate = LSTM_BOUND_BASIS[name]
        b_ms, b_by = bound_ms(n_bytes, passes * n_flops, rate)
        rows.append({"name": name, "route": "cuda",
                     "source": f"paddle_tpu_torch/csrc/{name}.cu",
                     "replaces": f"paddle_tpu/ops/pallas_lstm.py:{line}",
                     "launches": sum(launches[name].values()),
                     "launches_by_path": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "shape": f"B {b}, T {t}, H {h}, {n_valid} valid steps"})
    for r in rows:
        lib = "" if r["library_ms"] is None else \
            f", torch.matmul {r['library_ms'] * 1e3:.2f} us"
        passes, rate = LSTM_BOUND_BASIS[r["name"]]
        fp32_ms = bound_ms(*blocked_work(r["name"], b, t, h, n_valid))[0]
        log(f"  {r['name']}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us{lib}, bound "
            f"{r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}, {passes} "
            f"pass(es) at {rate * 1e-12:.0f} TFLOP/s; at the fp32 rate "
            f"{fp32_ms * 1e3:.3f} us); {r['shape']}")
    return rows


# ------------------------------------------------------- conv/BN phases
def conv_case(n, h, w, cin, cout, dtype, seed, dev, c_off=0.0):
    """Random inputs of kernels 18-21 at one shape: z [N,H,W,Cin] (the
    prologue's input), dy and z2 [N,H,W,Cout], HWIO weights at the
    fan-in scale, the prologue affine (A, C + c_off) and the BN-backward
    coefficients (A, B, C + c_off); a large c_off makes a wrong border
    (act(C) or C where 0 belongs) show."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, sc=1.0):
        return torch.randn(*shape, generator=g, device=dev) * sc
    aff = torch.stack([rnd(cin, sc=0.5) + 1.0, rnd(cin, sc=0.5) + c_off])
    co = torch.stack([rnd(cout, sc=0.5) + 1.0, rnd(cout, sc=0.1),
                      rnd(cout, sc=0.5) + c_off])
    return {"z": rnd(n, h, w, cin).to(dtype), "dy": rnd(n, h, w, cout).to(dtype),
            "z2": rnd(n, h, w, cout).to(dtype),
            "w": rnd(3, 3, cin, cout, sc=(9 * cin) ** -0.5).to(dtype),
            "aff": aff, "co": co}


def conv_calls(case, relu):
    """(kernel name → (wrapper call, plain call)) for one case; the plain
    call takes the dtype its conv sums in (f32 by default)."""
    import torch
    from paddle_tpu_torch.ops import conv as C
    z, dy, z2, w, aff, co = (case[k] for k in ("z", "dy", "z2", "w", "aff",
                                               "co"))
    f32 = torch.float32
    return {"conv3x3_dx": (
                lambda: C.conv3x3_dx(dy, z2, co, w),
                lambda acc=f32: C.conv3x3_dx_reference(dy, z2, co, w, acc)),
            "conv3x3_fwd": (
                lambda: C.conv3x3_fwd(z, aff, w, relu),
                lambda acc=f32: C.conv3x3_fwd_reference(z, aff, w, relu,
                                                        acc)),
            "conv3x3_fwd_bwd": (
                lambda: C.conv3x3_fwd_bwd(dy, z, aff, w, relu),
                lambda acc=f32: C.conv3x3_fwd_bwd_reference(dy, z, aff, w,
                                                            relu, acc)),
            "conv3x3_chain_bwd": (
                lambda: C.conv3x3_chain_bwd(dy, z2, co, z, aff, w, relu),
                lambda acc=f32: C.conv3x3_chain_bwd_reference(
                    dy, z2, co, z, aff, w, relu, acc))}


#: kernels 18-21 against their plain versions with the conv summed in
#: float64, so that only the kernel's own rounding is compared.  An f32
#: output may be off by CONV_RTOL * max|ref| + 1e-6 (the kernel's f32
#: sums of up to 9*512 products, and dA/dC of up to 401408 pixels); a
#: bf16 output by that plus CONV_BF16_ULPS ulps of the larger of the two
#: values (the f32 result rounded once to bf16, against the exact one
#: rounded once).  The ratio reported is the worst error beyond those
#: ulps over the f32 allowance: it must be at most 1.
CONV_RTOL, CONV_BF16_ULPS = 1e-5, 1.0


def conv_error(got, want, rtol=CONV_RTOL, ulps=CONV_BF16_ULPS):
    """(max abs error, worst ratio) over a kernel's outputs, with the
    tolerance of ``CONV_RTOL`` and ``CONV_BF16_ULPS``."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = ratio = 0.0
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"kernel output {a.dtype} {tuple(a.shape)} vs plain "
                 f"{b.dtype} {tuple(b.shape)}")
        bf16 = a.dtype == torch.bfloat16
        a, b = a.float(), b.float()
        e = (a - b).abs()
        err = max(err, e.max().item())
        if bf16:   # one bf16 ulp of |x| in [2^(k-1), 2^k) is 2^(k-8)
            top = torch.maximum(a.abs(), b.abs())
            e = (e - ulps * torch.ldexp(torch.ones_like(b), torch.frexp(
                top).exponent - 8)).clamp_min(0.0)
        ratio = max(ratio, e.max().item()
                    / (rtol * b.abs().max().item() + 1e-6))
    return err, ratio


#: phase 3d: the four ResNet-50 stage shapes at N = 4, then edge cases —
#: N = 1 with H != W and Cin != Cout both ways, a large C offset (the
#: border test), 128 < N*H*W not a multiple of the 128-pixel tile, and
#: W 140 > 130, the tensor-core loop's band mode (a last partial tile)
CONV_CASES = [(4, 56, 56, 64, 64, 0.0), (4, 28, 28, 128, 128, 0.0),
              (4, 14, 14, 256, 256, 0.0), (4, 7, 7, 512, 512, 0.0),
              (1, 9, 13, 64, 128, 0.0), (1, 13, 9, 128, 64, 0.0),
              (2, 8, 8, 64, 64, 3.0), (3, 5, 7, 192, 64, -2.0),
              (2, 3, 140, 64, 128, 1.0)]


def phase_conv_check(dev):
    """Kernels 18-21 against their plain versions (conv summed in
    float64) on the card, fp32 and bf16, ReLU and linear prologues;
    tolerances of :func:`conv_error`; logs the worst ratio per dtype and,
    for fp32 inputs, how far the kernel's f32 sums and the plain
    version's (cuDNN's) lie from the float64 ones."""
    import torch
    from paddle_tpu_torch.ops import conv as C
    errs = dict.fromkeys((fn.__name__ for fn in C.KERNEL_WRAPPERS), 0.0)
    worst, f32_err = {}, {"kernel": 0.0, "plain f32": 0.0}

    def rel(got, want):
        got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
        return max(((a.double() - b.double()).abs().max()
                    / b.double().abs().max()).item()
                   for a, b in zip(got, want))
    for i, (n, h, w, cin, cout, c_off) in enumerate(CONV_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            case = conv_case(n, h, w, cin, cout, dtype, 40 + i, dev, c_off)
            line = []
            for relu in (True, False):
                for name, (kern, plain) in conv_calls(case, relu).items():
                    got, want = kern(), plain(torch.float64)
                    sync(dev)
                    e, ratio = conv_error(got, want)
                    worst[dtype] = max(worst.get(dtype, 0.0), ratio)
                    if dtype == torch.float32:
                        for k, v in (("kernel", got), ("plain f32", plain())):
                            f32_err[k] = max(f32_err[k], rel(v, want))
                    line.append(f"{name[8:]}{'' if relu else '/lin'} "
                                f"{e:.2e} ({ratio:.2f})")
                    if not ratio <= 1.0:
                        fail(f"{name} disagrees with its plain version at "
                             f"N={n} H={h} W={w} Cin={cin} Cout={cout} "
                             f"{dtype} relu={relu} C+{c_off}: {ratio:.3f} of "
                             "tolerance")
                    errs[name] = max(errs[name], e)
            log(f"  N={n} H={h} W={w} Cin={cin} Cout={cout} C+{c_off} "
                f"{str(dtype)[6:]}: " + ", ".join(line))
    log("  worst error / tolerance: " + ", ".join(
        f"{str(k)[6:]} {v:.3f}" for k, v in worst.items()))
    log("  f32 sums against float64, worst |err| / max|ref|: " + ", ".join(
        f"{k} {v:.3e}" for k, v in f32_err.items()))
    return errs


def image_feed(b, img, ncls, dev, seed=0):
    """bench.py's image feed (bench.py:388-392): randn rows of 3*img*img,
    then labels, from ``RandomState(seed)``."""
    import torch
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 3 * img * img).astype(np.float32)
    y = rng.randint(0, ncls, (b,)).astype(np.int32)
    return {"image": torch.from_numpy(x).to(dev),
            "label": torch.from_numpy(y).to(dev)}


def phase_train_image(dev, cfg, b, img, ncls, steps, warm, per_step):
    """An image training path: ``warm`` steps, then ``steps`` steps between
    CUDA events with every launch count set to 0 just before them; each
    kernel of ``per_step`` must launch exactly that many times a step."""
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.trainer.trainer import Trainer
    from paddle_tpu_torch.utils import FLAGS
    net = NeuralNetwork(cfg)
    trainer = Trainer(net, OptimizationConfig(**RESNET_OPT), seed=0,
                      device=dev)
    feed = image_feed(b, img, ncls, dev)
    t0 = time.perf_counter()
    warm_losses = [float(trainer.train_one_batch(feed)) for _ in range(warm)]
    warm_s = time.perf_counter() - t0
    launches, losses, ms, wall_ms, peak = timed_steps(trainer, feed, steps)
    m = {"ms_per_step": ms, "samples_per_s": b * 1e3 / ms,
         "host_wall_ms_per_step": wall_ms, "peak_mem_gb": peak,
         "warm_s": warm_s, "warm_losses": warm_losses, "losses": losses,
         "census": net.fused_pair_census,
         "flags": {k: FLAGS.get(k) for k in ("use_bf16", "bf16_activations",
                                             "conv_bn_fuse",
                                             "conv_bn_fuse_fwd")}}
    log(f"  {steps} timed steps (B {b}, {img}x{img}, flags {m['flags']}): "
        f"{ms:.3f} ms/step (CUDA events), {m['samples_per_s']:.1f} "
        f"samples/s, host wall {m['host_wall_ms_per_step']:.3f} ms/step, "
        f"peak memory {m['peak_mem_gb']:.2f} GB, {warm} warm steps "
        f"{warm_s:.1f} s; census {m['census']}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    log(f"  losses: warm {[round(x, 6) for x in warm_losses]}, timed "
        f"{[round(x, 6) for x in losses]}")
    if not all(np.isfinite(warm_losses + losses)):
        fail("non-finite training loss")
    for name, want in per_step.items():
        if launches[name] != want * steps:
            fail(f"{name}: {launches[name]} launches in {steps} steps, "
                 f"expected {want} a step")
    return launches, m, trainer, feed


def phase_image_small(dev):
    """The small bottleneck net of the CPU tests (stem, max pool,
    bottleneck(64, s1), bottleneck(128, s2); B 2, 3x32x32) in fp32 on the
    card (kernels 19 and 20) and on the CPU (plain versions), from the
    same parameters and buffers: loss, every gradient, the new buffers."""
    import torch
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import image as I
    from paddle_tpu_torch.ops import conv as C

    def body(img, k):
        net = I._bn_conv(img, 7, 64, 2, 3, channels=3)
        net = I._pool(net, 3, 2, 1)
        net = I._bottleneck(net, 64, 1)
        net = I._bottleneck(net, 128, 2)
        net = I._pool(net, 4, 1, 0, avg=True)
        return I.fc(net, k, act="softmax")
    net = NeuralNetwork(I.image_classifier(body, 32, 10))
    cpu_params = net.init_params(seed=0, device="cpu")
    res = {}
    for where in ("cpu", dev):
        params = {n: p.to(where).requires_grad_(True)
                  for n, p in cpu_params.items()}
        reset_counts()
        loss, (_, nb) = net.loss(params, image_feed(2, 32, 10, where, 1),
                                 net.init_buffers(where))
        grads = torch.autograd.grad(loss, list(params.values()))
        launched = {fn.__name__: fn.launches for fn in C.KERNEL_WRAPPERS}
        res[str(where)] = (loss.detach().cpu(),
                           {n: g.cpu() for n, g in zip(params, grads)},
                           {n: v.cpu() for n, v in nb.items()}, launched)
    (l_cpu, g_cpu, b_cpu, n_cpu), (l_dev, g_dev, b_dev, n_dev) = \
        res["cpu"], res[str(dev)]
    e_loss = abs(float(l_dev) - float(l_cpu))
    e_grad, ratio = grad_errors(g_dev, g_cpu)
    e_buf = max((b_dev[n] - b_cpu[n]).abs().max().item() for n in b_cpu)
    log(f"  card vs CPU plain path, small bottleneck net B=2 32x32 (fp32): "
        f"loss {float(l_dev):.6f} vs {float(l_cpu):.6f}; gradients max abs "
        f"err {e_grad:.3e} ({ratio:.3f} of tolerance); buffers {e_buf:.3e};"
        f" launches on the card {n_dev}")
    if not np.isfinite(float(l_dev)) or e_loss > 1e-5 * abs(float(l_cpu)) \
            or ratio > 1.0 or e_buf > 1e-5:
        fail("card and CPU reference disagree on the small ResNet")
    if any(n_cpu.values()) or not (n_dev["conv3x3_fwd"] == 2
                                   and n_dev["conv3x3_fwd_bwd"] == 2):
        fail(f"small net launches: CPU {n_cpu}, card {n_dev}")


def conv_work(name, n, h, w, cin, cout, elem):
    """(bytes, flops) of one call of kernel ``name``: each input read and
    each output written once (``elem`` bytes an activation or weight
    element, f32 affines and sums), 2 flops a multiply-add of the conv."""
    m = n * h * w
    wt = 9 * cin * cout * elem
    n_bytes = {
        "conv3x3_fwd": (m * cin + m * cout) * elem + wt + 4 * 2 * cin,
        "conv3x3_fwd_bwd": (m * cout + 3 * m * cin) * elem + wt
        + 4 * 4 * cin,
        "conv3x3_dx": (3 * m * cout + m * cin) * elem + wt + 4 * 3 * cout,
        "conv3x3_chain_bwd": (3 * m * cout + 3 * m * cin) * elem + wt
        + 4 * (3 * cout + 4 * cin)}[name]
    return n_bytes, 2 * m * 9 * cin * cout


#: the bound's basis for each kernel at the bf16 main path: (passes, rate)
#: -- kernel 20 multiplies its bf16 inputs as they are (dy and the
#: flipped weights), one bf16 tensor-core pass; kernels 19, 18 and 21
#: multiply an f32 operand formed on load (x = act(A·z + C), or
#: dz = A·dy + B·z + C), which the contract cannot round to bf16 once:
#: carried as hi + lo bf16, it takes two bf16 passes; all four on the
#: tensor-core loop (conv3x3_tc.cuh)
CONV_BOUND_BASIS = {"conv3x3_fwd": (2, BF16_FLOPS_PER_S),
                    "conv3x3_fwd_bwd": (1, BF16_FLOPS_PER_S),
                    "conv3x3_dx": (2, BF16_FLOPS_PER_S),
                    "conv3x3_chain_bwd": (2, BF16_FLOPS_PER_S)}
#: the ResNet-50 stage shapes of kernels 18-21 at the main path's B
RESNET_STAGES = [(56, 64), (28, 128), (14, 256), (7, 512)]
CONV_LINES = {"conv3x3_dx": 194, "conv3x3_fwd": 339, "conv3x3_fwd_bwd": 398,
              "conv3x3_chain_bwd": 509}


def phase_time_conv(dev, launches, names=tuple(CONV_LINES)):
    """Kernels 18-21 (or ``names``) at each ResNet-50 stage shape (B 128,
    bf16 as on the main path): µs per call (CUDA-graph replay), the plain
    version's, a library yardstick for the conv's share only —
    ``F.conv2d`` (19) or ``torch.nn.grad.conv2d_input`` (18, 20, 21) of
    the already-formed operand, cuDNN with TF32 off — the bound on the
    basis of ``CONV_BOUND_BASIS``, and the achieved TFLOP/s on the
    contract's flops (2 a multiply-add of the conv)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import conv as C
    rows = []
    dt = torch.bfloat16
    for name in names:
        stages = []
        for si, (hw, ch) in enumerate(RESNET_STAGES):
            case = conv_case(RESNET_B, hw, hw, ch, ch, dt, 60 + si, dev)
            kern, plain = conv_calls(case, True)[name]
            e, ratio = conv_error(kern(), plain(torch.float64))
            if not ratio <= 1.0:
                fail(f"{name} disagrees at the stage shape {hw}x{hw}x{ch}")
            z, dy, w = case["z"], case["dy"], case["w"]
            xn = z.permute(0, 3, 1, 2)
            wo = w.permute(3, 2, 0, 1)
            dyn = dy.permute(0, 3, 1, 2)
            lib = (lambda: F.conv2d(xn, wo, padding=1)) \
                if name == "conv3x3_fwd" else \
                (lambda: torch.nn.grad.conv2d_input(xn.shape, wo, dyn,
                                                    padding=1))
            ms = time_ms(kern, reps=3, rounds=3)
            plain_ms = time_ms(plain, reps=2, rounds=2)
            lib_ms = time_ms(lib, reps=3, rounds=3)
            n_bytes, n_flops = conv_work(name, RESNET_B, hw, hw, ch, ch, 2)
            passes, rate = CONV_BOUND_BASIS[name]
            b_ms, b_by = bound_ms(n_bytes, passes * n_flops, rate)
            stages.append({"shape": f"[{RESNET_B},{hw},{hw},{ch}] -> {ch}",
                           "ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "max_abs_err": e,
                           "tflops": n_flops / ms * 1e-9,
                           "bound_share": b_ms / ms})
            log(f"  {name} {stages[-1]['shape']} bf16: {ms * 1e3:.2f} us "
                f"(plain {plain_ms * 1e3:.1f} us, library conv share "
                f"{lib_ms * 1e3:.2f} us, bound {b_ms * 1e3:.1f} us by "
                f"{b_by}, {passes} pass(es) at {rate * 1e-12:.0f} TFLOP/s; "
                f"{n_flops / ms * 1e-9:.1f} TFLOP/s of the contract, "
                f"{100 * b_ms / ms:.1f} % of the bound rate); err {e:.2e} "
                f"({ratio:.2f} of tolerance)")
        first = stages[0]
        rows.append({"name": name, "route": "cuda",
                     "source": f"paddle_tpu_torch/csrc/{name}.cu",
                     "replaces": f"paddle_tpu/ops/pallas_conv.py:"
                                 f"{CONV_LINES[name]}",
                     "launches": sum(launches[name].values()),
                     "launches_by_path": launches[name],
                     "max_abs_err": max(s["max_abs_err"] for s in stages),
                     "ms": first["ms"], "plain_ms": first["plain_ms"],
                     "bound_ms": first["bound_ms"],
                     "bound_by": first["bound_by"],
                     "library_ms": first["library_ms"],
                     "tflops": first["tflops"],
                     "bound_share": first["bound_share"],
                     "shape": first["shape"] + " bf16 (row: stage 1; "
                                               "by_stage: all four)",
                     "by_stage": stages})
    return rows


def phase_resnet(dev, launches):
    """Phases 4l-4p: the ResNet-50 main path under bench.py's flags, its
    profile, the same net without the forward fusion, resnet_cifar10(20)
    (each with a profile), and the small net on the card against the
    CPU.  Adds each path's launches to ``launches``; returns the readings
    by path."""
    import torch
    from paddle_tpu_torch.models import resnet, resnet_cifar10
    out = {}
    set_flags(**BENCH_FLAGS)
    log("== phase 4l: ResNet-50 main path (bench.py's row: B 128, 224x224, "
        "1000 classes, use_bf16 + bf16_activations, Adam lr 1e-3 clip 25)")
    got, out["resnet50"], trainer, feed = phase_train_image(
        dev, resnet(50, RESNET_CLASSES, RESNET_IMG), RESNET_B, RESNET_IMG,
        RESNET_CLASSES, RESNET_STEPS, RESNET_WARM,
        {"conv3x3_fwd": 16, "conv3x3_fwd_bwd": 16, "conv3x3_dx": 0,
         "conv3x3_chain_bwd": 0})
    for name in launches:
        launches[name]["resnet50"] = got[name]
    log("== phase 4m: profile of 3 ResNet-50 steps")
    phase_profile_train(trainer, feed)
    del trainer, feed
    torch.cuda.empty_cache()
    log("== phase 4n: ResNet-50 under --conv_bn_fuse_fwd=false (2 steps)")
    set_flags(conv_bn_fuse_fwd=False)
    got, out["resnet50_fwd_fusion_off"], trainer, feed = phase_train_image(
        dev, resnet(50, RESNET_CLASSES, RESNET_IMG), RESNET_B, RESNET_IMG,
        RESNET_CLASSES, 2, 1,
        {"conv3x3_dx": 16, "conv3x3_fwd": 0, "conv3x3_fwd_bwd": 0,
         "conv3x3_chain_bwd": 0})
    log("== phase 4n: profile of 3 steps without the forward fusion")
    phase_profile_train(trainer, feed)
    set_flags(conv_bn_fuse_fwd=True)
    for name in launches:
        launches[name]["resnet50_fwd_fusion_off"] = got[name]
    del trainer, feed
    torch.cuda.empty_cache()
    log("== phase 4o: resnet_cifar10(20), B 128, 3x32x32 (2 steps)")
    got, out["resnet_cifar10_20"], trainer, feed = phase_train_image(
        dev, resnet_cifar10(20, 10, 32), RESNET_B, 32, 10, 2, 1,
        {"conv3x3_fwd": 3, "conv3x3_chain_bwd": 3, "conv3x3_dx": 0,
         "conv3x3_fwd_bwd": 0})
    for name in launches:
        launches[name]["resnet_cifar10_20"] = got[name]
    log("== phase 4o: profile of 3 resnet_cifar10(20) steps")
    phase_profile_train(trainer, feed)
    del trainer, feed
    torch.cuda.empty_cache()
    set_flags(use_bf16=False, bf16_activations=False)
    log("== phase 4p: small bottleneck net, card vs CPU plain path (fp32)")
    phase_image_small(dev)
    return out


# ------------------------------------------------------------ GRU phases
def gru_case(b, t, h, lengths, seed, dev, xw_dtype=None, boot=True):
    """Random GRU inputs (xw, w_hh [H, 3H], bias, boot state h0, or none)
    and cotangents on (y, final h); lengths int32 [B]."""
    import torch
    rng = np.random.default_rng(seed)

    def f(*shape, sc=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * sc)
                                .astype(np.float32)).to(dev)
    p = {"xw": f(b, t, 3 * h, sc=0.5), "w": f(h, 3 * h, sc=h ** -0.5),
         "bias": f(3 * h, sc=0.1)}
    if boot:
        p["h0"] = f(b, h, sc=0.5)
    if xw_dtype is not None:
        p["xw"] = p["xw"].to(xw_dtype)
    cot = [f(b, t, h), f(b, h)]
    return p, cot, torch.tensor(lengths, dtype=torch.int32, device=dev)


def gru_run(p, cot, lengths, reverse, route):
    """(y, final h) and the gradient of every input under sum(output *
    cotangent): through ``gru_sequence`` (``route`` "sequence": the fused
    kernels on the card), the fused entry called directly ("fused",
    "blocked"), or the per-step scan ("scan")."""
    import torch
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.ops import gru as G
    from paddle_tpu_torch.ops import recurrent_ops as R
    q = {n: v.detach().clone().requires_grad_(True) for n, v in p.items()}
    h = q["w"].shape[0]
    seq = SequenceBatch(q["xw"], lengths)
    if route != "sequence":
        fn = {"scan": R.gru_scan, "fused": G.gru_fused_sequence,
              "blocked": G.gru_fused_sequence_blocked}[route]
        xw, mask = q["xw"] + q["bias"], seq.mask()
        if reverse:
            xw, mask = torch.flip(xw, (1,)), torch.flip(mask, (1,))
        y, fh = fn(xw, mask, q["w"][:, :2 * h], q["w"][:, 2 * h:],
                   q.get("h0"))
        if reverse:
            y = torch.flip(y, (1,))
    else:
        out, fh = R.gru_sequence(seq, None, q["w"], q["bias"],
                                 h0=q.get("h0"), reverse=reverse)
        y = out.data
    loss = (y * cot[0]).sum() + (fh * cot[1]).sum()
    grads = torch.autograd.grad(loss, list(q.values()))
    return [y.detach(), fh.detach()], dict(zip(q, grads))


def gru_kernel_errors(b, t, h, lengths, seed, dev):
    """Each wrapper (kernels 13, 14) against its plain version on the
    same CUDA tensors: (forward max abs error, (backward max abs error,
    ratio to tolerance))."""
    import torch
    from paddle_tpu_torch.ops import gru as G
    p, cot, ln = gru_case(b, t, h, lengths, seed, dev)
    mask = (torch.arange(t, device=dev)[None, :] < ln[:, None]).float()
    fwd = (p["xw"], mask, p["w"][:, :2 * h].contiguous(),
           p["w"][:, 2 * h:].contiguous(), p["h0"])
    got, want = G.gru_fwd(*fwd), G.gru_fwd_reference(*fwd)
    e_fwd = max((a - r).abs().max().item() for a, r in zip(got, want))
    hseq, gates = want
    bwd = (gates, hseq, p["h0"], mask, fwd[2], fwd[3], cot[0])
    got, want = G.gru_bwd(*bwd), G.gru_bwd_reference(*bwd)
    return e_fwd, grad_errors(dict(enumerate(got)), dict(enumerate(want)),
                              GRU_GRAD_ATOL, GRU_GRAD_RTOL)


def phase_gru_check(dev):
    """Kernels 13 and 14 through ``gru_sequence`` (their autograd.Function)
    against autograd through the plain scan, and each wrapper against its
    plain version, fp32: outputs within GRU_ATOL, every gradient (xw,
    w_hh, bias, h0) within GRU_GRAD_ATOL + GRU_GRAD_RTOL * max|ref|."""
    import torch
    full = [S2S["T"]] * S2S["B"]
    cases = [((S2S["B"], S2S["T"], S2S["H"]), full, False, None, True),
             ((S2S["B"], S2S["T"], S2S["H"]), full, True, None, True),
             ((8, 12, 128), [12, 1, 7, 12, 3, 1, 9, 12], True, None, True),
             ((3, 5, 128), [5, 1, 3], False, None, False),        # B = 3
             ((16, 7, 384), [7, 0, 1] + [1 + i % 7 for i in range(13)],
              False, None, True),
             # kernel 13: seven clusters of 32 rows, the last part-filled;
             # H % 4 != 0 (scalar loads), a part-filled CTA
             ((200, 4, 256), [4, 0] + [1 + i % 4 for i in range(198)], True,
              None, True),
             ((5, 6, 50), [6, 1, 0, 6, 3], False, None, True),
             ((8, 12, 128), [12, 1, 7, 12, 3, 1, 9, 12], False,
              torch.bfloat16, True)]                           # bf16 xw
    errs = {"gru_fwd": 0.0, "gru_bwd": 0.0}
    for i, ((b, t, h), lengths, reverse, xdt, boot) in enumerate(cases):
        p, cot, ln = gru_case(b, t, h, lengths, 40 + i, dev, xdt, boot)
        route = rnn_route("gru", b, h)
        got_o, got_g = gru_run(p, cot, ln, reverse, route)
        want_o, want_g = gru_run(p, cot, ln, reverse, "scan")
        sync(dev)
        e_out = max((g - w).abs().max().item()
                    for g, w in zip(got_o, want_o))
        e_grad, ratio = grad_errors(got_g, want_g, GRU_GRAD_ATOL,
                                    GRU_GRAD_RTOL)
        e_fwd, (e_bwd, r_bwd) = gru_kernel_errors(b, t, h, lengths, 60 + i,
                                                  dev)
        sync(dev)
        log(f"  gru B={b} T={t} H={h} reverse={reverse} ({route}) xw "
            f"{'bf16' if xdt else 'fp32'} h0={'yes' if boot else 'no'}: vs "
            f"the scan: outputs {e_out:.3e}, gradients {e_grad:.3e} "
            f"({ratio:.3f} of tolerance); vs plain versions: fwd "
            f"{e_fwd:.3e}, bwd {e_bwd:.3e} ({r_bwd:.3f})")
        if not max(e_out, e_fwd) <= GRU_ATOL:
            fail(f"gru_fwd disagrees at B={b} T={t} H={h}: "
                 f"{max(e_out, e_fwd)} > {GRU_ATOL}")
        if not max(ratio, r_bwd) <= 1.0:
            fail(f"gru_bwd disagrees at B={b} T={t} H={h}: "
                 f"{max(ratio, r_bwd):.3f} of tolerance")
        errs["gru_fwd"] = max(errs["gru_fwd"], e_out, e_fwd)
        errs["gru_bwd"] = max(errs["gru_bwd"], e_bwd)
    return errs


def s2s_feed(b, s, t, v, dev, seed=0, lengths=None):
    """bench.py's seq2seq feed (bench.py:503-514): source, target and
    next-target ids drawn from ``RandomState(seed)`` in that order, every
    length full; or the given (source, target) lengths."""
    import torch
    from paddle_tpu_torch.core.sequence import SequenceBatch
    rng = np.random.RandomState(seed)
    ids = [rng.randint(2, v, (b, n)).astype(np.int32) for n in (s, t, t)]
    src_len, trg_len = lengths or (np.full((b,), s, np.int32),
                                   np.full((b,), t, np.int32))
    return {name: SequenceBatch(torch.from_numpy(x),
                                torch.from_numpy(ln.astype(np.int32))).to(dev)
            for name, x, ln in (("source", ids[0], src_len),
                                ("target", ids[1], trg_len),
                                ("target_next", ids[2], trg_len))}


def phase_seq2seq(dev, hidden=S2S["H"], kernels=GRU_KERNELS):
    """Phase 4q (4t at H 1024): the seq2seq main path at bench.py's row
    under its flags: warm steps, then the timed steps between CUDA events
    with every launch count and the RNN dispatch counter set to 0 just
    before them — finite losses, exactly 2 launches of each of
    ``kernels`` a step (the two encoder directions) and no other kernel,
    no scan decision, ms/step, target tokens/s."""
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import seq2seq_config
    from paddle_tpu_torch.ops import recurrent_ops as R
    from paddle_tpu_torch.trainer.trainer import Trainer
    b, steps = S2S["B"], S2S_STEPS
    net = NeuralNetwork(seq2seq_config(S2S["V"], S2S["E"], hidden))
    trainer = Trainer(net, OptimizationConfig(**S2S_OPT), seed=0, device=dev)
    feed = s2s_feed(b, S2S["S"], S2S["T"], S2S["V"], dev)
    t0 = time.perf_counter()
    warm = [float(trainer.train_one_batch(feed)) for _ in range(S2S_WARM)]
    warm_s = time.perf_counter() - t0
    R.rnn_dispatch_total.clear()
    launches, losses, ms, wall_ms, peak = timed_steps(trainer, feed, steps)
    decisions = dict(R.rnn_dispatch_total)
    m = {"ms_per_step": ms, "target_tokens_per_s": b * S2S["T"] * 1e3 / ms,
         "host_wall_ms_per_step": wall_ms, "peak_mem_gb": peak,
         "warm_s": warm_s, "warm_losses": warm, "losses": losses,
         "hidden": hidden,
         "rnn_dispatch": {"/".join(k): v for k, v in decisions.items()}}
    log(f"  rnn_dispatch_total over the timed steps: {decisions}")
    if any(path == "scan" for _, path, _ in decisions) or \
            sum(decisions.values()) != 2 * steps:
        fail(f"the seq2seq encoder left the fused tier: {decisions}")
    log(f"  {steps} timed steps (B {b}, S {S2S['S']}, T {S2S['T']}, V "
        f"{S2S['V']}, E {S2S['E']}, H {hidden}; use_bf16 + "
        f"bf16_activations): {ms:.3f} ms/step (CUDA events), "
        f"{m['target_tokens_per_s']:.1f} target tokens/s, host wall "
        f"{m['host_wall_ms_per_step']:.3f} ms/step, peak memory "
        f"{m['peak_mem_gb']:.2f} GB, {S2S_WARM} warm steps {warm_s:.1f} s; "
        f"launches { {k: v for k, v in launches.items() if v} }")
    log(f"  losses: warm {[round(x, 6) for x in warm]}, timed "
        f"{[round(x, 6) for x in losses]}")
    if not all(np.isfinite(warm + losses)):
        fail("non-finite seq2seq training loss")
    for name, n in launches.items():
        want = 2 * steps if name in kernels else 0
        if n != want:
            fail(f"{name}: {n} launches in {steps} seq2seq steps, expected "
                 f"{want}")
    return launches, m, trainer, feed


def phase_seq2seq_small(dev, hidden=128):
    """Phase 4s (4u at H 640): a small seq2seq net in fp32 on the CPU
    (plain versions) and on the card, same parameters, source and target
    lengths varied: the loss within S2S_RTOL of the CPU's, every gradient
    within S2S_RTOL * max|ref| + 1e-8; the card's encoder launches its
    GRU kernels."""
    import torch
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import seq2seq_config
    b, s, t, v = 8, 6, 5, 50
    net = NeuralNetwork(seq2seq_config(v, 16, hidden))
    cpu_params = net.init_params(seed=0, device="cpu")
    lengths = (np.array([6, 1, 3, 6, 5, 2, 4, 6]),
               np.array([5, 5, 1, 3, 2, 5, 4, 1]))
    res = {}
    for where in ("cpu", dev):
        params = {n: p.to(where).requires_grad_(True)
                  for n, p in cpu_params.items()}
        reset_counts()
        loss, _ = net.loss(params, s2s_feed(b, s, t, v, where, seed=1,
                                            lengths=lengths))
        grads = torch.autograd.grad(loss, list(params.values()))
        res[str(where)] = (float(loss.detach()),
                           {n: g.cpu() for n, g in zip(params, grads)})
    launched = {k: n for k, n in read_counts().items() if n}
    (l_cpu, g_cpu), (l_dev, g_dev) = res["cpu"], res[str(dev)]
    ratio = max(((g_dev[n] - w).abs().max().item()
                 / (S2S_RTOL * w.abs().max().item() + 1e-8))
                for n, w in g_cpu.items())
    log(f"  card vs CPU plain path, B {b} S {s} T {t} V {v} E 16 H {hidden}"
        f": loss {l_dev:.7f} vs {l_cpu:.7f}; gradients {ratio:.3f} of "
        f"tolerance; the card's launches {launched}")
    if not np.isfinite(l_dev) or abs(l_dev - l_cpu) > S2S_RTOL * abs(l_cpu) \
            or ratio > 1.0:
        fail("card and CPU reference disagree on the seq2seq step")
    want = GRU_BLOCKED_KERNELS if hidden > 512 else GRU_KERNELS
    if sorted(launched) != sorted(want) or \
            any(n != 2 for n in launched.values()):
        fail(f"the small seq2seq step on the card launched {launched}, "
             f"expected 2 each of {want}")


def gru_work(b, t, h, n_valid, backward):
    """(bytes, flops) of one GRU kernel call: every input read once and
    every output written once; the recurrent products of the valid (row,
    step) pairs (a padded step's products are not needed)."""
    seq, gates, w = b * t, b * t * 3 * h, 3 * h * h
    if not backward:   # xw, mask, w_gates, w_cand, h0 -> H, gates
        n = 2 * gates + seq + w + b * h + seq * h
        return 4 * n, 2 * n_valid * h * 3 * h
    # gates, H, h0, mask, w_gates, w_cand, dy -> dxw, dw_gates, dw_cand, dh0
    n = 2 * gates + 2 * seq * h + seq + 2 * w + 2 * b * h
    return 4 * n, 4 * n_valid * h * 3 * h


def phase_time_gru(dev, launches):
    """Kernels 13 and 14 at the seq2seq row's encoder shape (B 128, T 30,
    H 512, every step valid, h0 zero): against their plain versions, then
    timed with both; the bounds on the basis of ``GRU_BOUND_BASIS`` (at
    the fp32 rate too, in the log only), and how many of kernel 13's
    clusters the card holds at once."""
    import torch
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import gru as G
    b, t, h = S2S["B"], S2S["T"], S2S["H"]
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, sc=1.0):
        return torch.randn(*shape, generator=g, device=dev) * sc
    mask = torch.ones((b, t), device=dev)
    fwd_args = (rnd(b, t, 3 * h, sc=0.5), mask, rnd(h, 2 * h, sc=h ** -0.5),
                rnd(h, h, sc=h ** -0.5), torch.zeros((b, h), device=dev))
    got, ref = G.gru_fwd(*fwd_args), G.gru_fwd_reference(*fwd_args)
    e_fwd = max((a - r).abs().max().item() for a, r in zip(got, ref))
    hseq, gates = got
    bwd_args = (gates, hseq, fwd_args[4], mask, fwd_args[2], fwd_args[3],
                rnd(b, t, h))
    got, want = G.gru_bwd(*bwd_args), G.gru_bwd_reference(*bwd_args)
    e_bwd, ratio = grad_errors(dict(enumerate(got)), dict(enumerate(want)),
                               GRU_GRAD_ATOL, GRU_GRAD_RTOL)
    if not (e_fwd <= GRU_ATOL and ratio <= 1.0):
        fail(f"GRU kernels disagree with their plain versions at the main "
             f"shapes: forward {e_fwd}, backward {ratio:.3f} of tolerance")
    rows = []
    for name, fn, plain, args, bwd, line in (
            ("gru_fwd", G.gru_fwd, G.gru_fwd_reference, fwd_args, False, 58),
            ("gru_bwd", G.gru_bwd, G.gru_bwd_reference, bwd_args, True,
             115)):
        ms = time_ms(lambda: fn(*args), reps=10, rounds=4)
        plain_ms = time_ms(lambda: plain(*args), reps=2, rounds=2)
        n_bytes, n_flops = gru_work(b, t, h, b * t, bwd)
        passes, rate = GRU_BOUND_BASIS[name]
        b_ms, b_by = bound_ms(n_bytes, passes * n_flops, rate)
        rows.append({"name": name, "route": "cuda",
                     "source": f"paddle_tpu_torch/csrc/{name}.cu",
                     "replaces": f"paddle_tpu/ops/pallas_gru.py:{line}",
                     "launches": sum(launches[name].values()),
                     "launches_by_path": launches[name],
                     "max_abs_err": e_bwd if bwd else e_fwd, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "shape": f"B {b}, T {t}, H {h}, all steps valid"})
    log(f"  gru_fwd: {_build.kernel('gru_fwd_clusters')(h)} clusters of "
        f"{-(-h // G.UNITS)} CTAs at once on this card, "
        f"{-(-b // G.CLUSTER_ROWS)} in the launch")
    for r in rows:
        passes, rate = GRU_BOUND_BASIS[r["name"]]
        fp32_ms = bound_ms(*gru_work(b, t, h, b * t,
                                     r["name"] == "gru_bwd"))[0]
        log(f"  {r['name']}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f}"
            f" us by {r['bound_by']}, {passes} pass(es) at "
            f"{rate * 1e-12:.0f} TFLOP/s; at the fp32 rate "
            f"{fp32_ms * 1e3:.3f} us); {r['shape']}")
    return rows


# ---------------------------------------------------- blocked GRU phases
def gru_blocked_kernel_errors(b, t, h, lengths, seed, dev):
    """Each wrapper of kernels 15-17 against its plain version on the
    same CUDA tensors: (forward max abs error, (BPTT max abs error, ratio
    to tolerance), (dW max abs error, ratio))."""
    import torch
    from paddle_tpu_torch.ops import gru as G
    p, cot, ln = gru_case(b, t, h, lengths, seed, dev)
    mask = (torch.arange(t, device=dev)[None, :] < ln[:, None]).float()
    fwd = (p["xw"], mask, p["w"][:, :2 * h].contiguous(),
           p["w"][:, 2 * h:].contiguous(), p["h0"])
    got, want = G.gru_fwd_blocked(*fwd), G.gru_fwd_blocked_reference(*fwd)
    e_fwd = max((a - r).abs().max().item() for a, r in zip(got, want))
    hseq, gates = want
    bwd = (gates, hseq, p["h0"], mask, fwd[2], fwd[3], cot[0])
    got = G.gru_bwd_blocked(*bwd)
    want = G.gru_bwd_blocked_reference(*bwd)
    e_bwd = grad_errors(dict(enumerate(got)), dict(enumerate(want)),
                        GRU_GRAD_ATOL, GRU_GRAD_RTOL)
    dw_args = (hseq, p["h0"], want[2], want[0], mask)
    e_dw = grad_errors(dict(enumerate(G.gru_dw_blocked(*dw_args))),
                       dict(enumerate(G.gru_dw_blocked_reference(*dw_args))),
                       GRU_GRAD_ATOL, GRU_GRAD_RTOL)
    return e_fwd, e_bwd, e_dw


def phase_gru_blocked_check(dev):
    """Phase 3f: kernels 15-17 through their autograd.Function (by
    ``gru_sequence`` where the reference's rule sends the shape to the
    blocked tier, else ``gru_fused_sequence_blocked`` directly) against
    autograd through the plain scan, and each wrapper against its plain
    version, fp32: outputs within GRU_ATOL, every gradient within
    GRU_GRAD_ATOL + GRU_GRAD_RTOL * max|ref| (and one bf16 ulp for a bf16
    gradient)."""
    import torch
    b, t, h = S2S["B"], S2S["T"], S2S_WIDE_H
    cases = [((b, t, h), [t] * b, False, None, True),
             ((b, t, h), [t] * b, True, None, True),
             ((8, 12, 640), [12, 0, 1, 12, 5, 1, 9, 3], True, None, True),
             ((3, 5, 640), [5, 1, 3], False, None, False),        # B = 3
             ((16, 7, 520), [7, 0, 1] + [1 + i % 7 for i in range(13)],
              False, None, True),                                 # H % 128
             ((b, 4, 2048), [4] * b, False, None, True),
             ((5, 6, 514), [6, 0, 1, 6, 3], False, None, True),   # H % 4
             ((8, 12, 640), [12, 1, 7, 12, 3, 1, 9, 12], False,
              torch.bfloat16, True)]                              # bf16 xw
    errs = dict.fromkeys(GRU_BLOCKED_KERNELS, 0.0)
    for i, ((b, t, h), lengths, reverse, xdt, boot) in enumerate(cases):
        p, cot, ln = gru_case(b, t, h, lengths, 80 + i, dev, xdt, boot)
        route = rnn_route("gru", b, h)
        got_o, got_g = gru_run(p, cot, ln, reverse, route)
        want_o, want_g = gru_run(p, cot, ln, reverse, "scan")
        sync(dev)
        e_out = max((g - w).abs().max().item()
                    for g, w in zip(got_o, want_o))
        e_grad, ratio = grad_errors(got_g, want_g, GRU_GRAD_ATOL,
                                    GRU_GRAD_RTOL)
        e_fwd, (e_bwd, r_bwd), (e_dw, r_dw) = gru_blocked_kernel_errors(
            b, t, h, lengths, 100 + i, dev)
        sync(dev)
        log(f"  gru blocked B={b} T={t} H={h} reverse={reverse} ({route}) "
            f"xw {'bf16' if xdt else 'fp32'} h0={'yes' if boot else 'no'}: "
            f"vs the scan: outputs {e_out:.3e}, gradients {e_grad:.3e} "
            f"({ratio:.3f} of tolerance); vs plain versions: fwd "
            f"{e_fwd:.3e}, bwd {e_bwd:.3e} ({r_bwd:.3f}), dW {e_dw:.3e} "
            f"({r_dw:.3f})")
        if not max(e_out, e_fwd) <= GRU_ATOL:
            fail(f"gru_fwd_blocked disagrees at B={b} T={t} H={h}: "
                 f"{max(e_out, e_fwd)} > {GRU_ATOL}")
        if not max(ratio, r_bwd, r_dw) <= 1.0:
            fail(f"gru_bwd_blocked / gru_dw_blocked disagree at B={b} T={t} "
                 f"H={h}: {max(ratio, r_bwd, r_dw):.3f} of tolerance")
        errs["gru_fwd_blocked"] = max(errs["gru_fwd_blocked"], e_out, e_fwd)
        errs["gru_bwd_blocked"] = max(errs["gru_bwd_blocked"], e_bwd)
        errs["gru_dw_blocked"] = max(errs["gru_dw_blocked"], e_dw)
    return errs


def phase_c1_card(dev):
    """Phase 4v: fault C1 on the card.  ``gru_sequence`` at (6, 10, 128)
    under bench.py's flags takes the reference's path, the bf16 scan (one
    ``rnn_dispatch_total`` decision, path scan, the reference's reason;
    no kernel launched), and agrees with the same call on the CPU:
    outputs within 1e-2, gradients within 1e-5 + 2e-2 * max|ref| (the
    bench-flag parity tolerances of tests/test_torch_gru.py; both sides
    round to bf16 at the same places and sum in other orders)."""
    import torch
    from paddle_tpu_torch.ops import recurrent_ops as R
    b, t, h = 6, 10, 128
    lengths = [10, 9, 8, 7, 6, 5]
    res = {}
    for where in ("cpu", dev):
        p, cot, ln = gru_case(b, t, h, lengths, 120, where)
        R.rnn_dispatch_total.clear()
        reset_counts()
        res[str(where)] = gru_run(p, cot, ln, False, "sequence")
        decisions = dict(R.rnn_dispatch_total)
    launched = {k: n for k, n in read_counts().items() if n}
    reason = R._fallback_reason(b, h)
    (o_cpu, g_cpu), (o_dev, g_dev) = res["cpu"], res[str(dev)]
    e_out = max((g.cpu().float() - w.float()).abs().max().item()
                for g, w in zip(o_dev, o_cpu))
    e_grad, ratio = grad_errors({n: g.cpu() for n, g in g_dev.items()},
                                g_cpu, 1e-5, 2e-2)
    log(f"  gru_sequence B={b} T={t} H={h} (use_bf16 + bf16_activations): "
        f"decisions {decisions}, launches {launched}; card vs CPU: outputs "
        f"{e_out:.3e}, gradients {e_grad:.3e} ({ratio:.3f} of tolerance)")
    if decisions != {("gru", "scan", reason): 1} or launched:
        fail(f"C1: gru_sequence at ({b}, {t}, {h}) did not take the "
             f"reference's scan: {decisions}, launches {launched}")
    if not (e_out <= 1e-2 and ratio <= 1.0):
        fail("C1: the card's bf16 scan disagrees with the CPU's")
    return {"decisions": {"/".join(k): v for k, v in decisions.items()},
            "out_err": e_out, "grad_err": e_grad}


#: the bound's basis of the GRU kernels: (passes, rate) -- all five
#: multiply their f32 operands on the tensor cores as hi*hi + hi*lo +
#: lo*hi, three bf16 passes: 13 (csrc/gru_fwd.cu), 14, 15 and 16 (their
#: two step products, and 14's dW; csrc/lstm_wg.cuh) and 17
#: (csrc/dw_wg.cuh)
GRU_BOUND_BASIS = {"gru_fwd": (3, BF16_FLOPS_PER_S),
                   "gru_bwd": (3, BF16_FLOPS_PER_S),
                   "gru_fwd_blocked": (3, BF16_FLOPS_PER_S),
                   "gru_bwd_blocked": (3, BF16_FLOPS_PER_S),
                   "gru_dw_blocked": (3, BF16_FLOPS_PER_S)}


def gru_blocked_work(name, b, t, h, n_valid):
    """(bytes, flops) of one call of a blocked GRU kernel: each input read
    once, each output written once; the products of the valid row-steps
    (2 * n_valid * H * 3H flops each kernel)."""
    seq, gates, state = b * t, b * t * 3 * h, b * t * h
    w = 3 * h * h
    n = {  # xw, mask, w_gates, w_cand, h0 -> H, gates
        "gru_fwd_blocked": 2 * gates + seq + w + b * h + state,
        # gates, H, h0, mask, w_gates, w_cand, dy -> dxw, dh0, rh
        "gru_bwd_blocked": 2 * gates + 3 * state + seq + w + 2 * b * h,
        # H, h0, rh, dxw, mask -> dW_gates, dW_cand
        "gru_dw_blocked": 2 * state + b * h + gates + seq + w}[name]
    return 4 * n, 2 * n_valid * h * 3 * h


def phase_time_gru_blocked(dev, launches):
    """Kernels 15-17 at the H 1024 main path's encoder shape (B 128, T 30,
    every step valid, h0 zero), each against its plain version, then
    timed with it; ``torch.matmul`` of the two dW products as kernel 17's
    yardstick; the bounds on the basis of ``GRU_BOUND_BASIS`` (at the
    fp32 rate too, in the log only)."""
    import torch
    from paddle_tpu_torch.ops import gru as G
    b, t, h = S2S["B"], S2S["T"], S2S_WIDE_H
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, sc=1.0):
        return torch.randn(*shape, generator=g, device=dev) * sc
    mask = torch.ones((b, t), device=dev)
    fwd = (rnd(b, t, 3 * h, sc=0.5), mask, rnd(h, 2 * h, sc=h ** -0.5),
           rnd(h, h, sc=h ** -0.5), torch.zeros((b, h), device=dev))
    hseq, gates = G.gru_fwd_blocked(*fwd)
    e_fwd = max((a - r).abs().max().item() for a, r in
                zip((hseq, gates), G.gru_fwd_blocked_reference(*fwd)))
    bwd = (gates, hseq, fwd[4], mask, fwd[2], fwd[3], rnd(b, t, h))
    got = G.gru_bwd_blocked(*bwd)
    e_bwd, r_bwd = grad_errors(
        dict(enumerate(got)),
        dict(enumerate(G.gru_bwd_blocked_reference(*bwd))),
        GRU_GRAD_ATOL, GRU_GRAD_RTOL)
    dxw, _, rh = got
    dw_args = (hseq, fwd[4], rh, dxw, mask)
    e_dw, r_dw = grad_errors(
        dict(enumerate(G.gru_dw_blocked(*dw_args))),
        dict(enumerate(G.gru_dw_blocked_reference(*dw_args))),
        GRU_GRAD_ATOL, GRU_GRAD_RTOL)
    if not (e_fwd <= GRU_ATOL and max(r_bwd, r_dw) <= 1.0):
        fail(f"blocked GRU kernels disagree with their plain versions at "
             f"the main shapes: forward {e_fwd}, BPTT {r_bwd:.3f}, dW "
             f"{r_dw:.3f} of tolerance")
    h_prev = torch.cat([fwd[4][:, None], hseq[:, :-1]], 1).reshape(-1, h)
    d2 = dxw.reshape(-1, 3 * h)
    dg, dc, rh2 = d2[:, :2 * h], d2[:, 2 * h:], rh.reshape(-1, h)

    def library():
        torch.matmul(h_prev.t(), dg)
        torch.matmul(rh2.t(), dc)
    rows = []
    for name, fn, plain, args, err, line, lib in (
            ("gru_fwd_blocked", G.gru_fwd_blocked,
             G.gru_fwd_blocked_reference, fwd, e_fwd, 247, None),
            ("gru_bwd_blocked", G.gru_bwd_blocked,
             G.gru_bwd_blocked_reference, bwd, e_bwd, 334, None),
            ("gru_dw_blocked", G.gru_dw_blocked, G.gru_dw_blocked_reference,
             dw_args, e_dw, 448, library)):
        ms = time_ms(lambda: fn(*args), reps=5, rounds=4)
        plain_ms = time_ms(lambda: plain(*args), reps=2, rounds=2)
        lib_ms = time_ms(lib, reps=5, rounds=4) if lib else None
        n_bytes, n_flops = gru_blocked_work(name, b, t, h, b * t)
        passes, rate = GRU_BOUND_BASIS[name]
        b_ms, b_by = bound_ms(n_bytes, passes * n_flops, rate)
        rows.append({"name": name, "route": "cuda",
                     "source": f"paddle_tpu_torch/csrc/{name}.cu",
                     "replaces": f"paddle_tpu/ops/pallas_gru.py:{line}",
                     "launches": sum(launches[name].values()),
                     "launches_by_path": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "shape": f"B {b}, T {t}, H {h}, all steps valid"})
    for r in rows:
        lib = "" if r["library_ms"] is None else \
            f", torch.matmul {r['library_ms'] * 1e3:.2f} us"
        passes, rate = GRU_BOUND_BASIS[r["name"]]
        fp32_ms = bound_ms(*gru_blocked_work(r["name"], b, t, h, b * t))[0]
        log(f"  {r['name']}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us{lib}, bound "
            f"{r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}, {passes} "
            f"pass(es) at {rate * 1e-12:.0f} TFLOP/s; at the fp32 rate "
            f"{fp32_ms * 1e3:.3f} us); {r['shape']}")
    return rows


# ------------------------------------------------- transformer slice
def flash_case(b, tq, tk, h, d, dtype, seed, dev):
    """Random q [B, Tq, H, D], k and v [B, Tk, H, D] and a cotangent dO
    in ``dtype`` (q . k / sqrt(D) ~ N(0, 1))."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(t):
        return torch.randn(b, t, h, d, generator=g, device=dev).to(dtype)
    return rnd(tq), rnd(tk), rnd(tk), rnd(tq)


def flash_error(got, ref):
    """(max abs error, worst error / tolerance) of a kernel output against
    its plain version, with the tolerances of ``FLASH_BF16_RTOL`` /
    ``FLASH_F32_RTOL``."""
    import torch
    if got.dtype != ref.dtype or got.shape != ref.shape:
        fail(f"kernel output {got.dtype} {tuple(got.shape)} vs plain "
             f"{ref.dtype} {tuple(ref.shape)}")
    a, b = got.float(), ref.float()
    e = (a - b).abs()
    if got.dtype == torch.bfloat16:
        top = torch.maximum(a.abs(), b.abs())
        ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - 8)
        tol = ulp + FLASH_BF16_RTOL * b.abs().max().item()
    else:
        tol = FLASH_F32_RTOL * b.abs().max().item() + 1e-6
    return e.max().item(), (e / tol).max().item()


def masked_zeros(out, dq, dk, dv, lengths, seg):
    """True when what the masks leave nothing to is exactly 0: out and dq
    of a row with key length 0, dk and dv of keys at or past their row's
    length; packed, all four at padding tokens."""
    import torch
    if seg is not None:
        pad = seg[0] < 0
        return all(bool((x[0, pad] == 0).all()) for x in (out, dq, dk, dv))
    if lengths is None:
        return True
    dead_key = (torch.arange(dk.shape[1], device=dk.device)[None, :]
                >= lengths[:, None])
    dead_row = lengths == 0
    return all(bool((x[dead_key] == 0).all()) for x in (dk, dv)) and \
        all(bool((x[dead_row] == 0).all()) for x in (out, dq))


#: phase 3g cases: (label, B, Tq, Tk, H, D, dtype, causal, key lengths,
#: packed rows' lengths (then B = 1 and T = slot * rows))
def flash_cases():
    import torch
    bf, f32 = torch.bfloat16, torch.float32
    mixed = [int(x) for x in np.random.RandomState(1).randint(
        ATTN_T // 4, ATTN_T + 1, 4)] + [0]
    return [("headline", 16, 2048, 2048, 8, 64, bf, False, None, None),
            ("headline causal", 16, 2048, 2048, 8, 64, bf, True, None, None),
            ("lengths", 4, 1024, 1024, 4, 64, bf, False, [0, 1, 64, 1000],
             None),
            ("lengths causal", 4, 1024, 1024, 4, 64, bf, True,
             [0, 1, 64, 1000], None),
            ("cross", 2, 384, 1000, 4, 64, bf, False, [1000, 517], None),
            ("T 100", 3, 100, 100, 2, 64, bf, True, [100, 37, 0], None),
            ("packed", 1, 5 * ATTN_T, 5 * ATTN_T, 8, 64, bf, False, None,
             mixed),
            ("packed causal", 1, 3 * 256, 3 * 256, 2, 64, bf, True, None,
             [256, 0, 129]),
            ("fp32", 2, 256, 256, 2, 64, f32, False, [256, 93], None),
            ("fp32 causal", 2, 100, 100, 2, 64, f32, True, [100, 50], None),
            ("D 32", 2, 300, 300, 4, 32, bf, True, [300, 129], None),
            ("D 32 fp32", 2, 160, 160, 2, 32, f32, False, [160, 1], None),
            ("D 128", 2, 300, 300, 4, 128, bf, False, [300, 129], None),
            ("D 128 fp32", 2, 200, 200, 2, 128, f32, True, None, None)]


def phase_flash_check(dev):
    """Phase 3g: kernels 1-train, 3 and 4 against their plain versions
    on the card (f32 arithmetic on the same inputs): through
    ``flash_attention`` / ``flash_attention_packed`` and autograd (every
    decision on the block-sparse path), and each wrapper alone on the
    plain forward's lse and delta.  Returns the worst error per kernel."""
    import torch
    from paddle_tpu_torch.ops import attention as A
    errs = dict.fromkeys(FLASH_KERNELS, 0.0)
    for i, (label, b, tq, tk, h, d, dtype, causal, lengths, packed) in \
            enumerate(flash_cases()):
        q, k, v, do = flash_case(b, tq, tk, h, d, dtype, 10 + i, dev)
        ln = seg = None
        if lengths is not None:
            ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        if packed is not None:
            seg = A.segments_from_lengths(
                torch.tensor(packed, dtype=torch.int32, device=dev),
                len(packed), tq // len(packed)).contiguous()
        A.attention_dispatch_total.clear()
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        if seg is None:
            out = A.flash_attention(qg, kg, vg, ln, causal)
        else:
            out = A.flash_attention_packed(qg, kg, vg, seg, causal,
                                           slot=tq // len(packed))
        grads = torch.autograd.grad(out, (qg, kg, vg), do)
        if not masked_zeros(out, *grads, ln, seg):
            fail(f"flash case {label}: a masked row or key is not exactly 0")
        path = dict(A.attention_dispatch_total)
        if path != {("packed" if seg is not None else "block_sparse", ""):
                    1}:
            fail(f"flash case {label}: dispatch {path}")
        ref, ref_lse = A._dense_forward(q, k, v, ln, causal, seg)
        delta = A._delta(ref, do)
        ref_g = A._dense_grads(q, k, v, do, ref_lse, delta, ln, causal, seg)
        e2e = max(flash_error(a, r)[1] for a, r in
                  zip((out,) + grads, (ref,) + ref_g))
        alone_out, alone_lse = A.flash_fwd(q, k, v, ln, seg, causal)
        dq = A.flash_bwd_dq(q, k, v, do, ref_lse, delta, ln, seg, causal)
        dk, dv = A.flash_bwd_dkv(q, k, v, do, ref_lse, delta, ln, seg,
                                 causal)
        sync(dev)
        e_lse = (alone_lse - ref_lse).abs().max().item()
        alone = {"flash_fwd": flash_error(alone_out, ref),
                 "flash_bwd_dq": flash_error(dq, ref_g[0]),
                 "flash_bwd_dkv": max(flash_error(dk, ref_g[1]),
                                      flash_error(dv, ref_g[2]))}
        log(f"  {label}: B {b} Tq {tq} Tk {tk} H {h} D {d} "
            f"{str(dtype)[6:]} causal {causal} lengths {lengths} packed "
            f"{packed}: through autograd {e2e:.3f} of tolerance; alone "
            + ", ".join(f"{n} {e:.3e} ({r:.3f})" for n, (e, r) in
                        alone.items()) + f", lse {e_lse:.3e}")
        if not (e2e <= 1.0 and e_lse <= FLASH_LSE_ATOL
                and all(r <= 1.0 for _, r in alone.values())):
            fail(f"flash kernels disagree with their plain versions in "
                 f"case {label}")
        for n, (e, _) in alone.items():
            errs[n] = max(errs[n], e)
        del q, k, v, do, ref, ref_g, grads, out
        torch.cuda.empty_cache()
    return errs


def flash_work(name, b, tq, tk, h, d, pairs, elem):
    """(bytes, flops) of one call of a flash kernel: each input read once
    and each output written once (q/k/v/dO/out/dq/dk/dv ``elem`` bytes an
    element, lse and delta f32); 2*D flops per visible (query, key) pair
    and head for each T x T x D product (kernel 1: S and PV; kernel 3: S,
    dP, dQ; kernel 4: S, dV, dP, dK).  ``pairs``: visible pairs summed
    over the batch."""
    nq, nk = b * tq * h * d, b * tk * h * d
    rows = 4 * b * h * tq
    n_bytes, n_products = {
        "flash_fwd": (elem * (2 * nq + 2 * nk) + rows, 2),
        "flash_bwd_dq": (elem * (3 * nq + 2 * nk) + 2 * rows, 3),
        "flash_bwd_dkv": (elem * (2 * nq + 4 * nk) + 2 * rows, 4)}[name]
    return n_bytes, 2 * d * h * pairs * n_products


def phase_time_flash(dev, launches):
    """Kernels 1-train, 3 and 4 at the transformer step's shape (q, k, v
    bf16 [16, 2048, 8, 64], views of one [16, 2048, 1536] projection, all
    keys valid, non-causal): each against its plain version, then timed
    with it and with SDPA (forward for kernel 1; its backward, one call,
    for kernels 3 and 4 together)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import attention as A
    b, t, h = ATTN_B, ATTN_T, ATTN["num_heads"]
    size = ATTN["model_dim"]
    d = size // h
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(b, t, 3 * size, generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(size, dim=-1))
    do = torch.randn(b, t, h, d, generator=g, device=dev).to(torch.bfloat16)
    win_q, win_k = A.tile_windows(None, None, b, t, t, dev)
    out, lse = A.flash_fwd(q, k, v, None, None, False, win_q)
    delta = A._delta(out, do)
    calls = {
        "flash_fwd": (lambda: A.flash_fwd(q, k, v, None, None, False, win_q),
                      lambda: A._dense_forward(q, k, v, None, False)),
        "flash_bwd_dq": (
            lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, None, None,
                                   False, win_q),
            lambda: A._dense_grads(q, k, v, do, lse, delta, None, False,
                                   want="dq")),
        "flash_bwd_dkv": (
            lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, None, None,
                                    False, win_k),
            lambda: A._dense_grads(q, k, v, do, lse, delta, None, False,
                                   want="dkv"))}
    errs = {}
    for name, (kern, plain) in calls.items():
        got, want = kern(), plain()
        res = [flash_error(a, r) for a, r in
               zip(*((x,) if torch.is_tensor(x) else x for x in (got, want)))]
        errs[name] = (max(e for e, _ in res), max(r for _, r in res))
        del got, want
    if any(r > 1.0 for _, r in errs.values()):
        fail(f"flash kernels disagree at the main path's shape: {errs}")
    torch.cuda.empty_cache()
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    qr, kr, vr = (x.detach().requires_grad_(True) for x in (qh, kh, vh))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr)
    doh = do.transpose(1, 2)
    lib = {"flash_fwd": time_events_ms(
               lambda: F.scaled_dot_product_attention(qh, kh, vh), reps=10),
           "backward": time_events_ms(
               lambda: torch.autograd.grad(o_lib, (qr, kr, vr), doh,
                                           retain_graph=True), reps=10)}
    pairs = b * t * t
    rows = []
    for name, (kern, plain) in calls.items():
        ms = time_ms(kern, reps=10, rounds=3)
        plain_ms = time_events_ms(plain, reps=2)
        torch.cuda.empty_cache()
        work = flash_work(name, b, t, t, h, d, pairs, 2)
        b_ms, b_by = bound_ms(*work, BF16_FLOPS_PER_S)
        line = {"flash_fwd": 255, "flash_bwd_dq": 664,
                "flash_bwd_dkv": 701}[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{name}.cu",
            "replaces": f"paddle_tpu/ops/pallas_attention.py:{line}",
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name],
            "max_abs_err": errs[name][0], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "tflops": work[1] / ms * 1e-9, "bound_share": b_ms / ms,
            "library_ms": lib["flash_fwd" if name == "flash_fwd"
                              else "backward"],
            "library": "F.scaled_dot_product_attention forward"
                       if name == "flash_fwd" else
                       "F.scaled_dot_product_attention backward (one call "
                       "for kernels 3 and 4 together)",
            "shape": f"q/k/v bf16 [{b},{t},{h},{d}] (views of [{b},{t},"
                     f"{3 * size}]), non-causal, all keys valid"})
    for r in rows:
        log(f"  {r['name']}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us, {r['library']} "
            f"{r['library_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f}"
            f" us by {r['bound_by']}; {r['tflops']:.1f} TFLOP/s of the "
            f"contract, {r['bound_share'] * 100:.1f} % of the bound rate); "
            f"{r['shape']}")
    return rows


def attention_feed(b, t, vocab, dev, mixed=False, seed=0):
    """bench.py's attention feed (bench.py:581-588): with ``mixed``, valid
    lengths in [T/4, T] first, then token ids in [0, V) and labels in {0,
    1}, drawn in that order from ``RandomState(seed)``; also the count of
    valid tokens."""
    import torch
    from paddle_tpu_torch.core.sequence import SequenceBatch
    rng = np.random.RandomState(seed)
    lengths = rng.randint(t // 4, t + 1, (b,)) if mixed else np.full((b,), t)
    ids = rng.randint(0, vocab, (b, t)).astype(np.int32)
    labels = rng.randint(0, 2, (b,)).astype(np.int32)
    return ({"data": SequenceBatch(torch.from_numpy(ids), torch.from_numpy(
                lengths.astype(np.int32))).to(dev),
             "label": torch.from_numpy(labels).to(dev)},
            int(lengths.sum()))


def phase_transformer(dev, steps, warm, causal=False, packed=False,
                      mixed=False, seed=0, legacy=False):
    """Phases 4w-4y: the transformer classifier at bench.py's attention
    row under its flags: warm steps, then the timed steps between CUDA
    events with every launch count and the attention dispatch counter set
    to 0 just before them — finite losses, exactly one launch each of
    the path's three kernels per layer a step and no other kernel, every
    decision on the path (``block_sparse``, ``packed`` when the layer
    packs; with ``legacy``, ``--flash_block_sparse=false``: the legacy
    grid, kernels 2, 5 and 6), ms/step, tokens/s (valid tokens), host
    wall, peak memory."""
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import transformer_text_classifier
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.trainer.trainer import Trainer
    net = NeuralNetwork(transformer_text_classifier(
        **ATTN, causal=causal, packed=packed))
    trainer = Trainer(net, OptimizationConfig(**ATTN_OPT), seed=0,
                      device=dev)
    feed, valid = attention_feed(ATTN_B, ATTN_T, ATTN["vocab_size"], dev,
                                 mixed, seed)
    set_flags(flash_block_sparse=not legacy)
    try:
        t0 = time.perf_counter()
        warm_losses = [float(trainer.train_one_batch(feed))
                       for _ in range(warm)]
        warm_s = time.perf_counter() - t0
        A.attention_dispatch_total.clear()
        launches, losses, ms, wall_ms, peak = timed_steps(trainer, feed,
                                                          steps)
        decisions = dict(A.attention_dispatch_total)
    finally:
        set_flags(flash_block_sparse=True)
    per_step = ATTN["num_layers"] * steps
    m = {"ms_per_step": ms, "tokens_per_s": valid * 1e3 / ms,
         "valid_tokens": valid, "host_wall_ms_per_step": wall_ms,
         "peak_mem_gb": peak, "warm_s": warm_s, "warm_losses": warm_losses,
         "losses": losses, "causal": causal, "packed": packed,
         "legacy": legacy,
         "attention_dispatch": {"/".join(k): v for k, v in decisions.items()}}
    log(f"  {steps} timed steps (B {ATTN_B}, T {ATTN_T}, {valid} valid "
        f"tokens, causal {causal}, packed {packed}, legacy grid {legacy}; "
        f"use_bf16 + bf16_activations): {ms:.3f} ms/step (CUDA events), "
        f"{m['tokens_per_s']:.1f} tokens/s, host wall {wall_ms:.3f} "
        f"ms/step, peak memory {peak:.2f} GB, {warm} warm steps "
        f"{warm_s:.1f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }; "
        f"attention_dispatch_total {decisions}")
    log(f"  losses: warm {[round(x, 6) for x in warm_losses]}, timed "
        f"{[round(x, 6) for x in losses]}")
    if not all(np.isfinite(warm_losses + losses)):
        fail("non-finite transformer training loss")
    want = LEGACY_DECISION if legacy else \
        ("packed" if packed else "block_sparse", "")
    if decisions != {want: per_step}:
        fail(f"attention decisions {decisions}, expected {per_step} {want}")
    kernels = LEGACY_KERNELS if legacy else FLASH_KERNELS
    for name, n in launches.items():
        want_n = per_step if name in kernels else 0
        if n != want_n:
            fail(f"{name}: {n} launches in {steps} transformer steps, "
                 f"expected {want_n}")
    return launches, m, trainer, feed


def phase_transformer_small(dev, legacy=False):
    """Phase 4z: the small transformer of the CPU tests (V 50, D 64, 2
    heads, 2 layers, ffn 128, blocks 128; B 2, T 256, lengths 256 and 93)
    padded and packed, in fp32 and under bench.py's flags, on the CPU
    (plain versions) and on the card from the same parameters: loss and
    every gradient within SMALL_ATTN_TOL; the card launches each of
    kernels 1-train, 3 and 4 once per layer.  With ``legacy``
    (``--flash_block_sparse=false``) kernels 2, 5 and 6 instead, packed
    too: the layer does not pack under that flag (the reference's
    ``unpacked`` decision)."""
    import torch
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(0, 50, (2, 256)).astype(np.int32))
    labels = torch.from_numpy(rng.randint(0, 2, (2,)).astype(np.int32))
    lengths = torch.tensor([256, 93], dtype=torch.int32)
    out = {}
    set_flags(flash_block_sparse=not legacy)
    try:
        for flags in ("fp32", "bench"):
            set_flags(use_bf16=flags == "bench",
                      bf16_activations=flags == "bench")
            for packed in (False, True):
                out[f"{flags}{'_packed' if packed else ''}"] = \
                    _small_transformer_case(dev, ids, labels, lengths,
                                            flags, packed, legacy)
    finally:
        set_flags(flash_block_sparse=True)
    return out


def _small_transformer_case(dev, ids, labels, lengths, flags, packed,
                            legacy):
    import torch
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import transformer_text_classifier
    net = NeuralNetwork(transformer_text_classifier(
        vocab_size=50, model_dim=64, num_heads=2, num_layers=2,
        ffn_dim=128, max_len=256, block_q=128, block_k=128, packed=packed))
    cpu_params = net.init_params(seed=0, device="cpu")
    res = {}
    for where in ("cpu", dev):
        params = {n: p.to(where).requires_grad_(True)
                  for n, p in cpu_params.items()}
        feed = {"data": SequenceBatch(ids, lengths).to(where),
                "label": labels.to(where)}
        reset_counts()
        loss, _ = net.loss(params, feed)
        grads = torch.autograd.grad(loss, list(params.values()))
        res[str(where)] = (float(loss.detach()),
                           {n: g.float().cpu()
                            for n, g in zip(params, grads)})
    launched = {k: n for k, n in read_counts().items() if n}
    (l_cpu, g_cpu), (l_dev, g_dev) = res["cpu"], res[str(dev)]
    rtol, grtol = SMALL_ATTN_TOL[flags]
    ratio = max(((g_dev[n] - w).abs().max().item()
                 / (grtol * w.abs().max().item() + 1e-8))
                for n, w in g_cpu.items())
    log(f"  {flags}, packed {packed}, legacy grid {legacy}: loss "
        f"{l_dev:.7f} (card) vs {l_cpu:.7f} (CPU); gradients {ratio:.3f} "
        f"of tolerance; the card's launches {launched}")
    if not np.isfinite(l_dev) or abs(l_dev - l_cpu) > \
            rtol * abs(l_cpu) or ratio > 1.0:
        fail(f"card and CPU reference disagree on the small transformer "
             f"({flags}, packed {packed}, legacy grid {legacy})")
    kernels = LEGACY_KERNELS if legacy else FLASH_KERNELS
    if launched != dict.fromkeys(kernels, 2):
        fail(f"the small transformer on the card launched {launched}, "
             f"expected 2 each of {kernels}")
    return {"loss_rel_err": abs(l_dev - l_cpu) / abs(l_cpu),
            "grad_ratio": ratio}


# ------------------------------------------------- legacy attention grid
def phase_legacy_check(dev):
    """Phase 3h: kernels 2, 5 and 6 (the legacy full grid) on 3g's
    unpacked cases and inputs: through ``flash_attention`` and autograd
    under ``--flash_block_sparse=false`` (every decision ``legacy_grid``)
    and each wrapper alone, against their plain versions and against
    kernels 1-train, 3 and 4 on the same inputs, with 3g's tolerances.
    Returns the worst error per kernel against its plain version."""
    import torch
    from paddle_tpu_torch.ops import attention as A
    errs = dict.fromkeys(LEGACY_KERNELS, 0.0)
    for i, (label, b, tq, tk, h, d, dtype, causal, lengths, packed) in \
            enumerate(flash_cases()):
        if packed is not None:
            continue               # packed input stays dense under the flag
        q, k, v, do = flash_case(b, tq, tk, h, d, dtype, 10 + i, dev)
        ln = None if lengths is None else torch.tensor(
            lengths, dtype=torch.int32, device=dev)
        A.attention_dispatch_total.clear()
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        set_flags(flash_block_sparse=False)
        try:
            out = A.flash_attention(qg, kg, vg, ln, causal)
            grads = torch.autograd.grad(out, (qg, kg, vg), do)
        finally:
            set_flags(flash_block_sparse=True)
        if dict(A.attention_dispatch_total) != {LEGACY_DECISION: 1}:
            fail(f"legacy case {label}: dispatch "
                 f"{dict(A.attention_dispatch_total)}")
        if not masked_zeros(out, *grads, ln, None):
            fail(f"legacy case {label}: a masked row or key is not "
                 "exactly 0")
        ref, ref_lse = A._dense_forward(q, k, v, ln, causal)
        delta = A._delta(ref, do)
        ref_g = A._dense_grads(q, k, v, do, ref_lse, delta, ln, causal)
        e2e = max(flash_error(a, r)[1] for a, r in
                  zip((out,) + grads, (ref,) + ref_g))
        legacy = (A.flash_fwd_legacy(q, k, v, ln, causal),
                  A.flash_bwd_dq_legacy(q, k, v, do, ref_lse, delta, ln,
                                        causal),
                  A.flash_bwd_dkv_legacy(q, k, v, do, ref_lse, delta, ln,
                                         causal))
        sparse = (A.flash_fwd(q, k, v, ln, None, causal),
                  A.flash_bwd_dq(q, k, v, do, ref_lse, delta, ln, None,
                                 causal),
                  A.flash_bwd_dkv(q, k, v, do, ref_lse, delta, ln, None,
                                  causal))
        sync(dev)
        e_lse = (legacy[0][1] - ref_lse).abs().max().item()
        alone = {"flash_fwd_legacy": flash_error(legacy[0][0], ref),
                 "flash_bwd_dq_legacy": flash_error(legacy[1], ref_g[0]),
                 "flash_bwd_dkv_legacy": max(
                     flash_error(legacy[2][0], ref_g[1]),
                     flash_error(legacy[2][1], ref_g[2]))}
        pairs = [(legacy[0][0], sparse[0][0]), (legacy[1], sparse[1]),
                 (legacy[2][0], sparse[2][0]), (legacy[2][1], sparse[2][1])]
        vs_sparse = max(flash_error(a, r)[1] for a, r in pairs)
        vs_abs = max((a.float() - r.float()).abs().max().item()
                     for a, r in pairs + [(legacy[0][1], sparse[0][1])])
        log(f"  {label}: B {b} Tq {tq} Tk {tk} H {h} D {d} "
            f"{str(dtype)[6:]} causal {causal} lengths {lengths}: through "
            f"autograd {e2e:.3f} of tolerance; alone "
            + ", ".join(f"{n} {e:.3e} ({r:.3f})" for n, (e, r) in
                        alone.items())
            + f", lse {e_lse:.3e}; against kernels 1-train, 3, 4 "
              f"{vs_sparse:.3f} of tolerance (max |diff| {vs_abs:.3e})")
        if not (e2e <= 1.0 and e_lse <= FLASH_LSE_ATOL and vs_sparse <= 1.0
                and all(r <= 1.0 for _, r in alone.values())):
            fail(f"legacy kernels disagree in case {label}")
        for n, (e, _) in alone.items():
            errs[n] = max(errs[n], e)
        del q, k, v, do, ref, ref_g, grads, out, legacy, sparse
        torch.cuda.empty_cache()
    return errs


def causal_t2048_inputs(dev):
    """q/k/v bf16 [16, 2048, 8, 64], views of one [16, 2048, 1536]
    projection, and a cotangent: the causal_t2048 step's operands."""
    import torch
    b, t, h = ATTN_B, ATTN_T, ATTN["num_heads"]
    size = ATTN["model_dim"]
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(b, t, 3 * size, generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = (x.reshape(b, t, h, size // h) for x in qkv.split(size, -1))
    do = torch.randn(b, t, h, size // h, generator=g, device=dev).to(
        torch.bfloat16)
    return q, k, v, do


def phase_time_legacy(dev, launches):
    """Kernels 2, 5 and 6 at the causal_t2048 step's shape (q/k/v bf16
    [16, 2048, 8, 64], views of one projection, causal, all keys valid):
    each against its plain version, then timed with it, with kernels
    1-train, 3 and 4 on the same inputs, and with SDPA (causal forward
    for kernel 2; its backward, one call, for kernels 5 and 6)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import attention as A
    q, k, v, do = causal_t2048_inputs(dev)
    b, t, h, d = q.shape
    out, lse = A.flash_fwd_legacy(q, k, v, None, True)
    delta = A._delta(out, do)
    win_q, win_k = A.tile_windows(None, None, b, t, t, dev)
    calls = {
        "flash_fwd_legacy": (
            lambda: A.flash_fwd_legacy(q, k, v, None, True),
            lambda: A._dense_forward(q, k, v, None, True),
            lambda: A.flash_fwd(q, k, v, None, None, True, win_q)),
        "flash_bwd_dq_legacy": (
            lambda: A.flash_bwd_dq_legacy(q, k, v, do, lse, delta, None,
                                          True),
            lambda: A._dense_grads(q, k, v, do, lse, delta, None, True,
                                   want="dq"),
            lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, None, None, True,
                                   win_q)),
        "flash_bwd_dkv_legacy": (
            lambda: A.flash_bwd_dkv_legacy(q, k, v, do, lse, delta, None,
                                           True),
            lambda: A._dense_grads(q, k, v, do, lse, delta, None, True,
                                   want="dkv"),
            lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, None, None,
                                    True, win_k))}
    errs = {}
    for name, (kern, plain, _) in calls.items():
        got, want = kern(), plain()
        res = [flash_error(a, r) for a, r in
               zip(*((x,) if torch.is_tensor(x) else x for x in (got, want)))]
        errs[name] = (max(e for e, _ in res), max(r for _, r in res))
        del got, want
    if any(r > 1.0 for _, r in errs.values()):
        fail(f"legacy kernels disagree at the causal_t2048 shape: {errs}")
    torch.cuda.empty_cache()
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    qr, kr, vr = (x.detach().requires_grad_(True) for x in (qh, kh, vh))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    doh = do.transpose(1, 2)
    lib = {"fwd": time_events_ms(lambda: F.scaled_dot_product_attention(
               qh, kh, vh, is_causal=True), reps=10),
           "bwd": time_events_ms(
               lambda: torch.autograd.grad(o_lib, (qr, kr, vr), doh,
                                           retain_graph=True), reps=10)}
    pairs = b * t * (t + 1) // 2                # visible (query, key) pairs
    rows = []
    for (name, (kern, plain, sparse)), base, line in zip(
            calls.items(), FLASH_KERNELS, (467, 908, 936)):
        # in turns: legacy, block-sparse, block-sparse, legacy
        ms_a = time_ms(kern, reps=10, rounds=3)
        sp_a = time_ms(sparse, reps=10, rounds=3)
        sp_b = time_ms(sparse, reps=10, rounds=3)
        ms_b = time_ms(kern, reps=10, rounds=3)
        plain_ms = time_events_ms(plain, reps=2)
        torch.cuda.empty_cache()
        work = flash_work(base, b, t, t, h, d, pairs, 2)
        b_ms, b_by = bound_ms(*work, BF16_FLOPS_PER_S)
        ms = (ms_a + ms_b) / 2
        rows.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{base}.cu",
            "replaces": f"paddle_tpu/ops/pallas_attention.py:{line}",
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name],
            "max_abs_err": errs[name][0], "ms": ms,
            "ms_turns": [ms_a, ms_b], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "tflops": work[1] / ms * 1e-9, "bound_share": b_ms / ms,
            "library_ms": lib["fwd" if name == "flash_fwd_legacy"
                              else "bwd"],
            "library": "F.scaled_dot_product_attention causal forward"
                       if name == "flash_fwd_legacy" else
                       "F.scaled_dot_product_attention causal backward (one "
                       "call for kernels 5 and 6 together)",
            "block_sparse_ms": (sp_a + sp_b) / 2,
            "block_sparse_kernel": base,
            "shape": f"q/k/v bf16 [{b},{t},{h},{d}] (views of one "
                     f"projection), causal, all keys valid"})
    for r in rows:
        log(f"  {r['name']}: {r['ms'] * 1e3:.2f} us (turns "
            f"{r['ms_turns'][0] * 1e3:.2f}, {r['ms_turns'][1] * 1e3:.2f}; "
            f"{r['block_sparse_kernel']} on the same inputs "
            f"{r['block_sparse_ms'] * 1e3:.2f} us; plain "
            f"{r['plain_ms'] * 1e3:.2f} us, {r['library']} "
            f"{r['library_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f}"
            f" us by {r['bound_by']}; {r['tflops']:.1f} TFLOP/s of the "
            f"contract, {r['bound_share'] * 100:.1f} % of the bound rate); "
            f"{r['shape']}")
    return rows


# ------------------------------------------------- sparse embedding lane
def phase_gather_check(dev):
    """Phase 3i: kernel 22 against ``index_select`` of the clamped rows,
    byte for byte, directly and through ``gather_rows`` (every decision
    ``kernel``): pads at the height and at -1, duplicates, row V-1, one
    row, D 128 and 256, and the 1e7 x 128 table.  Returns the worst
    absolute difference (0 when every case is byte-identical)."""
    import torch
    from paddle_tpu_torch.ops import embedding as E
    g = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    cases = [("pads, duplicates, row V-1", 1000, 128,
              [5, 999, -1, 5, 1000, 0, 999, 1000]),
             ("one row", 1000, 128, [999]),
             ("D 256", 4096, 256, None),
             ("1e7 x 128", 10 ** 7, 128, None)]
    for label, vocab, d, rows in cases:
        table = torch.randn(vocab, d, generator=g, device=dev)
        if rows is None:
            rows = torch.randint(-1, vocab + 1, (SPARSE_IDS,), generator=g,
                                 device=dev, dtype=torch.int32)
        else:
            rows = torch.tensor(rows, dtype=torch.int32, device=dev)
        want = table.index_select(0, rows.long().clamp(0, vocab - 1))
        E.embedding_dispatch_total.clear()
        got = E.embedding_gather(table, rows)
        got2 = E.gather_rows(table, rows)
        sync(dev)
        diff = (got - want).abs().max().item()
        same = torch.equal(got, want) and torch.equal(got2, want)
        log(f"  {label}: table {vocab} x {d}, {rows.numel()} rows: "
            f"byte-identical {same}, max |diff| {diff:.3e}; decisions "
            f"{dict(E.embedding_dispatch_total)}")
        if not same or dict(E.embedding_dispatch_total) != {("kernel", ""): 1}:
            fail(f"kernel 22 disagrees with index_select ({label})")
        worst = max(worst, diff)
        del table
    torch.cuda.empty_cache()
    return worst


def ctr_feed(vocab, b, t, dev, seed=0):
    """bench.py's sparse feed (``_sparse_trainer``): ids in [0, V) then
    labels in {0, 1} from ``RandomState(seed)``, full lengths."""
    import torch
    from paddle_tpu_torch.core.sequence import SequenceBatch
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, t)).astype(np.int32)
    labels = rng.randint(0, 2, (b,)).astype(np.int32)
    return {"ids": SequenceBatch(torch.from_numpy(ids), torch.from_numpy(
                np.full((b,), t, np.int32))).to(dev),
            "label": torch.from_numpy(labels).to(dev)}


def ctr_trainer(vocab, emb_dim, dev, sparse):
    """The sparse lane's CTR trainer (``models/ctr.py``, Adam lr 1e-3 clip
    25, the port's init, seed 0) with ``--sparse_grads`` set as asked
    (the trainer reads it at its first step: train it before the flag
    changes again)."""
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import CTR_OPT, ctr_classifier
    from paddle_tpu_torch.trainer.trainer import Trainer
    set_flags(sparse_grads=sparse)
    return Trainer(NeuralNetwork(ctr_classifier(vocab, emb_dim)),
                   OptimizationConfig(**CTR_OPT), seed=0, device=dev)


def _ctr_run(trainer, feed, steps, warm, kernel, label):
    """Warm steps (the first reads ``--sparse_grads``), then ``steps``
    timed ones: finite losses, the exchange plan as asked, kernel 22
    launched once a step where ``kernel`` and never otherwise, every
    embedding decision the gate's (``kernel``; ``dense/unaligned`` at
    D 64) and only the path's kernel launched."""
    from paddle_tpu_torch.ops import embedding as E
    warm_losses = [float(trainer.train_one_batch(feed)) for _ in range(warm)]
    plan = trainer._sparse_exchange_plan()
    E.embedding_dispatch_total.clear()
    launches, losses, ms, wall_ms, peak = timed_steps(trainer, feed, steps)
    decisions = dict(E.embedding_dispatch_total)
    b = feed["label"].shape[0]
    m = {"ms_per_step": ms, "samples_per_s": b * 1e3 / ms,
         "host_wall_ms_per_step": wall_ms, "peak_mem_gb": peak,
         "warm_losses": warm_losses, "losses": losses,
         "exchange_plan": plan,
         "embedding_dispatch": {"/".join(k): v for k, v in decisions.items()},
         "launches": {k: v for k, v in launches.items() if v}}
    log(f"  {label}: {steps} timed steps {ms:.3f} ms/step (CUDA events), "
        f"{m['samples_per_s']:.1f} samples/s, host wall {wall_ms:.3f} "
        f"ms/step, peak memory {peak:.2f} GB; exchange plan {plan}; "
        f"embedding_dispatch_total {decisions}; launches {m['launches']}; "
        f"losses {[round(x, 6) for x in warm_losses + losses]}")
    if not all(np.isfinite(warm_losses + losses)):
        fail(f"non-finite CTR training loss ({label})")
    d = trainer.params["_slot_emb.w"].shape[1]
    want_dec = {} if not plan else \
        {("kernel", "") if d % 128 == 0 else ("dense", "unaligned"): steps}
    if decisions != want_dec:
        fail(f"embedding decisions {decisions}, expected {want_dec} "
             f"({label})")
    for name, n in launches.items():
        want = steps if kernel and name == "embedding_gather" else 0
        if n != want:
            fail(f"{name}: {n} launches in {steps} CTR steps, expected "
                 f"{want} ({label})")
    return launches, m


def phase_sparse(dev):
    """Phase 4-sparse: bench.py's sparse lane at bench scale, fp32.

    - Lookup rows: tables 1e5, 1e6, 1e7 x 128 (random, on the card),
      8192 ids from ``RandomState(V % 2**31)``: ``unique_rows_sorted`` ->
      ``gather_rows`` (kernel 22) -> ``lookup_rows`` against
      ``index_select`` of the raw ids, byte for byte; lookups/s of each.
    - The train A/B: the CTR net at V 1e7, D 64, B 1024, T 16 with
      ``--sparse_grads`` on, then off: ms/step, samples/s, exchanged
      gradient bytes, peak memory; D 64 is ``unaligned``, so kernel 22
      runs 0 times.  Whether one exchange step syncs the host
      (``torch.cuda.set_sync_debug_mode("warn")``).
    - Kernel 22 inside a step: the same net at D 128, sparse: one launch
      a step.
    - The kill-switch contracts: ``--embedding_kernel`` on and off give
      byte-identical gathers (table 32 x 128, 8 rows, seed 7);
      ``--sparse_grads`` on and off agree after 3 steps at V 1024, B 16,
      T 16, seed 3 (every parameter within rtol 1e-4, atol 1e-6).

    Returns (launches by path, readings)."""
    import warnings

    import torch
    from paddle_tpu_torch.ops import embedding as E
    from paddle_tpu_torch.parallel import sparse as P
    out = {"lookup": {}}
    lookup_launches = 0
    for vocab in SPARSE_SCAN:
        rng = np.random.RandomState(vocab % (2 ** 31))
        ids = torch.from_numpy(rng.randint(0, vocab, (SPARSE_IDS,)).astype(
            np.int32)).to(dev)
        g = torch.Generator(device=dev).manual_seed(vocab % (2 ** 31))
        table = torch.randn(vocab, SPARSE_DIM, generator=g, device=dev)

        def sparse_lookup():
            rows = P.unique_rows_sorted(ids, SPARSE_IDS, vocab)
            return P.lookup_rows(rows, E.gather_rows(table, rows), ids)

        def dense_lookup():
            return table.index_select(0, ids.long())

        E.embedding_dispatch_total.clear()
        reset_counts()
        same = torch.equal(sparse_lookup(), dense_lookup())
        sp_ms = time_events_ms(sparse_lookup, reps=20)
        d_ms = time_events_ms(dense_lookup, reps=20)
        calls = E.embedding_gather.launches
        lookup_launches += calls
        decisions = dict(E.embedding_dispatch_total)
        out["lookup"][f"v{vocab}"] = {
            "sparse": {"lookups_per_s": SPARSE_IDS / sp_ms * 1e3,
                       "call_ms": sp_ms},
            "dense": {"lookups_per_s": SPARSE_IDS / d_ms * 1e3,
                      "call_ms": d_ms}, "byte_identical": same}
        log(f"  lookup V {vocab} x {SPARSE_DIM}, {SPARSE_IDS} ids: sparse "
            f"composite {SPARSE_IDS / sp_ms * 1e3:.1f} lookups/s ({sp_ms:.4f}"
            f" ms a call), index_select {SPARSE_IDS / d_ms * 1e3:.1f} "
            f"lookups/s ({d_ms:.4f} ms); byte-identical {same}; decisions "
            f"{decisions}, kernel 22 launches {calls}")
        if not same or decisions != {("kernel", ""): calls} or calls == 0:
            fail(f"sparse lookup at V {vocab}: equal {same}, decisions "
                 f"{decisions}")
        del table
        torch.cuda.empty_cache()

    # the train A/B at V 1e7, D 64 (bench.py's headline A/B)
    feed = ctr_feed(SPARSE_V, SPARSE_B, SPARSE_T, dev)
    ab = {}
    ab_launches = {}
    for sparse in (True, False):
        tag = "sparse" if sparse else "dense"
        trainer = ctr_trainer(SPARSE_V, SPARSE_D, dev, sparse)
        ab_launches[tag], ab[tag] = _ctr_run(
            trainer, feed, SPARSE_STEPS, SPARSE_WARM, False,
            f"train A/B, --sparse_grads={str(sparse).lower()}, V "
            f"{SPARSE_V} D {SPARSE_D} B {SPARSE_B} T {SPARSE_T}")
        if bool(ab[tag]["exchange_plan"]) != sparse:
            fail(f"exchange plan {ab[tag]['exchange_plan']} with "
                 f"--sparse_grads={sparse}")
        if sparse:
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    trainer.train_one_batch(feed)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
            # the mode's own notice ("a prototype feature ...") is no sync
            syncs = [str(w.message).splitlines()[0] for w in caught
                     if "called a synchronizing" in str(w.message)]
            ab[tag]["host_syncs_in_one_step"] = len(syncs)
            log(f"  host syncs in one exchange step (sync debug mode): "
                f"{len(syncs)} {syncs[:3]}")
        log(f"  profile of 3 {tag} steps")
        phase_profile_train(trainer, feed)
        del trainer
        torch.cuda.empty_cache()
    sp_bytes = P.exchange_payload_bytes(SPARSE_B * SPARSE_T, SPARSE_D)
    d_bytes = SPARSE_V * SPARSE_D * 4
    ab["sparse"]["exchanged_grad_bytes"] = sp_bytes
    ab["dense"]["exchanged_grad_bytes"] = d_bytes
    ab["exchange_traffic_win"] = d_bytes / sp_bytes
    ab["loss_rel_diff"] = max(
        abs(a - b) / abs(b) for a, b in zip(
            ab["sparse"]["warm_losses"] + ab["sparse"]["losses"],
            ab["dense"]["warm_losses"] + ab["dense"]["losses"]))
    log(f"  exchanged gradient bytes a step: sparse {sp_bytes}, dense "
        f"{d_bytes} ({d_bytes / sp_bytes:.1f}x); sparse step "
        f"{ab['dense']['ms_per_step'] / ab['sparse']['ms_per_step']:.2f}x "
        f"faster; losses of the two runs within "
        f"{ab['loss_rel_diff']:.2e} relative")
    out["train_ab"] = ab

    # kernel 22 inside a step: the same net at D 128, sparse only
    trainer = ctr_trainer(SPARSE_V, SPARSE_DIM, dev, True)
    d128_launches, out["train_d128"] = _ctr_run(
        trainer, feed, SPARSE_STEPS, SPARSE_WARM, True,
        f"CTR step at D {SPARSE_DIM}, V {SPARSE_V}, --sparse_grads=true")
    del trainer
    torch.cuda.empty_cache()

    # the kill-switch contracts
    rng = np.random.RandomState(7)
    t_small = torch.from_numpy(rng.randn(32, 128).astype(np.float32)).to(dev)
    r_small = torch.from_numpy(rng.randint(0, 32, (8,)).astype(
        np.int32)).to(dev)
    E.embedding_dispatch_total.clear()
    a = E.gather_rows(t_small, r_small)
    set_flags(embedding_kernel=False)
    try:
        b = E.gather_rows(t_small, r_small)
    finally:
        set_flags(embedding_kernel=True)
    kill_equal = torch.equal(a, b)
    log(f"  --embedding_kernel on/off gathers byte-identical: {kill_equal}"
        f" (decisions {dict(E.embedding_dispatch_total)})")
    if not kill_equal or dict(E.embedding_dispatch_total) != {
            ("kernel", ""): 1, ("dense", "flag_off"): 1}:
        fail("embedding kernel kill-switch contract violated")
    eq_feed = ctr_feed(1024, 16, SPARSE_T, dev, seed=3)
    eq = {}
    for sparse in (True, False):
        tr = ctr_trainer(1024, SPARSE_D, dev, sparse)
        for _ in range(3):
            tr.train_one_batch(eq_feed)
        if bool(tr._sparse_exchange_plan()) != sparse:
            fail("the --sparse_grads contract ran the wrong path")
        eq[sparse] = {n: p.detach().cpu() for n, p in tr.params.items()}
    worst = max(((eq[True][n] - p).abs() / (SPARSE_EQ_ATOL + SPARSE_EQ_RTOL
                                            * p.abs())).max().item()
                for n, p in eq[False].items())
    log(f"  --sparse_grads on/off after 3 steps (V 1024, B 16, seed 3): "
        f"worst parameter difference {worst:.3f} of atol 1e-6 + rtol 1e-4")
    if worst > 1.0:
        fail("sparse exchange equivalence violated: --sparse_grads on/off "
             "diverged")
    out["kill_switch_equal"] = kill_equal
    out["sparse_dense_equiv_worst"] = worst
    set_flags(sparse_grads=True)
    launches = {name: {"sparse_lookup": lookup_launches
                       if name == "embedding_gather" else 0,
                       "ctr_train_ab_sparse": ab_launches["sparse"][name],
                       "ctr_train_ab_dense": ab_launches["dense"][name],
                       "ctr_d128": d128_launches[name]}
                for name in d128_launches}
    return launches, out


def phase_time_gather(dev, launches):
    """Kernel 22 at the lane's shape: 8192 sorted unique rows of the
    1e7 x 128 fp32 table (the lookup's deduped ids), against its plain
    version and ``torch.index_select`` of the same rows."""
    import torch
    from paddle_tpu_torch.ops import embedding as E
    from paddle_tpu_torch.parallel import sparse as P
    vocab = SPARSE_SCAN[-1]
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(vocab, SPARSE_DIM, generator=g, device=dev)
    rng = np.random.RandomState(vocab % (2 ** 31))
    ids = torch.from_numpy(rng.randint(0, vocab, (SPARSE_IDS,)).astype(
        np.int32)).to(dev)
    rows = P.unique_rows_sorted(ids, SPARSE_IDS, vocab)
    rows_l = rows.long().clamp(0, vocab - 1)
    got = E.embedding_gather(table, rows)
    err = (got - E.gather_rows_reference(table, rows)).abs().max().item()
    ms = time_ms(lambda: E.embedding_gather(table, rows), reps=50)
    plain_ms = time_ms(lambda: E.gather_rows_reference(table, rows), reps=50)
    lib_ms = time_ms(lambda: torch.index_select(table, 0, rows_l), reps=50)
    n_bytes = 2 * SPARSE_IDS * SPARSE_DIM * 4 + SPARSE_IDS * 4
    b_ms, b_by = bound_ms(n_bytes, 0.0)
    row = {"name": "embedding_gather", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/embedding_gather.cu",
           "replaces": "paddle_tpu/ops/pallas_embedding.py:62",
           "launches": sum(launches["embedding_gather"].values()),
           "launches_by_path": launches["embedding_gather"],
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
           "library": "torch.index_select",
           "shape": f"{SPARSE_IDS} rows (deduped, sorted, {vocab}-padded) "
                    f"of a {vocab} x {SPARSE_DIM} fp32 table"}
    log(f"  embedding_gather: {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f}"
        f" us, torch.index_select {lib_ms * 1e3:.2f} us, bound "
        f"{b_ms * 1e3:.3f} us by {b_by}; {b_ms / ms * 100:.1f} % of the "
        f"bound rate); {row['shape']}")
    del table
    torch.cuda.empty_cache()
    return [row]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    from paddle_tpu_torch.core.device import resolve_device

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    set_flags(use_bf16=False, bf16_activations=False, precision="fp32",
              fused_rnn_hblock=True)
    try:
        log("== phase 1: card")
        card = phase_card()
        log("== phase 2: build")
        phase_build()
        log("== phase 3: kernels vs plain versions (fp32, atol 2e-5)")
        phase_check(dev)
        log("== phase 3b: fused LSTM kernels vs the plain scan (fp32)")
        phase_lstm_check(dev)
        log("== phase 3c: blocked LSTM kernels 10-12 vs the plain scan and "
            "their plain versions (fp32)")
        phase_blocked_check(dev)
        log("== phase 3d: conv/BN kernels 18-21 vs their plain versions "
            "(fp32 and bf16)")
        phase_conv_check(dev)
        log("== phase 3e: fused GRU kernels 13-14 vs the plain scan and "
            "their plain versions (fp32)")
        phase_gru_check(dev)
        log("== phase 3f: blocked GRU kernels 15-17 vs the plain scan and "
            "their plain versions (fp32)")
        phase_gru_blocked_check(dev)
        log("== phase 3g: flash kernels 1-train, 3 and 4 vs their plain "
            "versions (bf16 and fp32)")
        phase_flash_check(dev)
        log("== phase 3h: legacy-grid kernels 2, 5 and 6 vs their plain "
            "versions and kernels 1-train, 3, 4 (3g's unpacked cases)")
        phase_legacy_check(dev)
        log("== phase 3i: embedding gather kernel 22 vs index_select, byte "
            "for byte")
        phase_gather_check(dev)
        log("== phase 4: main path, full-width server")
        launches, serve, model, prompts = phase_serve(dev)
        log("== phase 4b: row invariance of the RMS mean")
        phase_rms_invariance(dev)
        log("== phase 4c: profile of one continuous pass")
        phase_profile(model, prompts)
        log("== phase 4d: training main path, full-width LSTM classifier")
        train_launches, train, trainer, feed = phase_train(dev)
        for name in launches:
            launches[name]["training"] = train_launches[name]
        log("== phase 4e: training step, card vs CPU plain path")
        phase_train_small(dev)
        log("== phase 4f: profile of 3 training steps")
        phase_profile_train(trainer, feed, ("kernel 8", "kernel 9"))
        del trainer, feed
        log("== phase 4g: blocked main path, the classifier at H 1280 "
            "under bench.py's flags (use_bf16, bf16_activations)")
        set_flags(**BENCH_FLAGS)
        blk_launches, blocked, trainer, feed = phase_train(
            dev, BLOCKED, BLOCKED_STEPS, kernels=BLOCKED_KERNELS,
            idle=TRAINING_KERNELS)
        for name in launches:
            launches[name]["training_h1280"] = blk_launches[name]
        log("== phase 4h: profile of 3 H 1280 training steps")
        phase_profile_train(trainer, feed,
                            ("kernel 10", "kernel 11", "kernel 12"))
        del trainer, feed
        log("== phase 4i: --precision=bf16 steps at H 1280")
        _, mixed, trainer, feed = phase_train(
            dev, BLOCKED, MIXED_STEPS, precision="bf16",
            kernels=BLOCKED_KERNELS, idle=TRAINING_KERNELS)
        del trainer, feed
        log("== phase 4j: 2 steps at H 2048 under bench.py's flags")
        _, wide, trainer, feed = phase_train(
            dev, dict(BLOCKED, hidden_size=2048), 2,
            kernels=BLOCKED_KERNELS, idle=TRAINING_KERNELS)
        del trainer, feed
        set_flags(use_bf16=False, bf16_activations=False)
        log("== phase 4k: blocked training step, card vs CPU plain path "
            "(fp32)")
        phase_train_small(dev, hidden=640)
        resnet = phase_resnet(dev, launches)
        set_flags(**BENCH_FLAGS)
        log("== phase 4q: seq2seq main path (bench.py's row: B 128, S 30, "
            "T 30, V 30000, E 512, H 512, use_bf16 + bf16_activations, "
            "Adam lr 5e-4 clip 25)")
        s2s_launches, seq2seq, trainer, feed = phase_seq2seq(dev)
        for name in launches:
            launches[name]["seq2seq"] = s2s_launches[name]
        log("== phase 4r: profile of 3 seq2seq steps")
        phase_profile_train(trainer, feed, ("kernel 13", "kernel 14"))
        del trainer, feed
        torch.cuda.empty_cache()
        log(f"== phase 4t: seq2seq at H {S2S_WIDE_H} (the row's model, feed, "
            "flags and optimizer): the blocked GRU tier")
        wide_launches, seq2seq_wide, trainer, feed = phase_seq2seq(
            dev, S2S_WIDE_H, GRU_BLOCKED_KERNELS)
        for name in launches:
            launches[name]["seq2seq_h1024"] = wide_launches[name]
        log(f"  profile of 3 steps at H {S2S_WIDE_H}")
        phase_profile_train(trainer, feed,
                            ("kernel 15", "kernel 16", "kernel 17"))
        del trainer, feed
        torch.cuda.empty_cache()
        log("== phase 4v: C1 on the card: gru_sequence (6, 10, 128) under "
            "bench.py's flags takes the reference's scan")
        c1 = phase_c1_card(dev)
        set_flags(use_bf16=False, bf16_activations=False)
        log("== phase 4s: small seq2seq net, card vs CPU plain path (fp32)")
        phase_seq2seq_small(dev)
        log("== phase 4u: small seq2seq net at H 640 (the blocked tier), "
            "card vs CPU plain path (fp32)")
        phase_seq2seq_small(dev, 640)
        set_flags(**BENCH_FLAGS)
        log("== phase 4w: transformer main path (bench.py's attention row: "
            "B 16, T 2048, V 30000, D 512, 8 heads, 4 layers, ffn 2048, "
            "use_bf16 + bf16_activations, Adam lr 1e-3 clip 25)")
        attn_launches, transformer, trainer, feed = phase_transformer(
            dev, ATTN_STEPS, ATTN_WARM)
        for name in launches:
            launches[name]["transformer"] = attn_launches[name]
        log("  profile of 3 transformer steps")
        phase_profile_train(trainer, feed)
        del trainer, feed
        torch.cuda.empty_cache()
        log("== phase 4x: padded_mixed (lengths in [T/4, T], seed 1), "
            "padded and packed")
        attn_mixed = {}
        for packed in (False, True):
            tag = "packed" if packed else "padded"
            mix_launches, attn_mixed[tag], trainer, feed = phase_transformer(
                dev, ATTN_AB_STEPS, 1, packed=packed, mixed=True, seed=1)
            for name in launches:
                launches[name][f"transformer_{tag}_mixed"] = \
                    mix_launches[name]
            log(f"  profile of 3 {tag} steps")
            phase_profile_train(trainer, feed)
            del trainer, feed
            torch.cuda.empty_cache()
        log("== phase 4y: causal_t2048, block_skip mode")
        causal_launches, causal, trainer, feed = phase_transformer(
            dev, ATTN_AB_STEPS, 1, causal=True)
        for name in launches:
            launches[name]["transformer_causal"] = causal_launches[name]
        del trainer, feed
        torch.cuda.empty_cache()
        log("  causal_t2048, legacy mode (--flash_block_sparse=false)")
        legacy_launches, causal_legacy, trainer, feed = phase_transformer(
            dev, ATTN_AB_STEPS, 1, causal=True, legacy=True)
        for name in launches:
            launches[name]["transformer_causal_legacy"] = \
                legacy_launches[name]
        del trainer, feed
        torch.cuda.empty_cache()
        log("== phase 4z: small transformer, card vs CPU plain path (fp32 "
            "and bench.py's flags)")
        small_attn = phase_transformer_small(dev)
        log("  the same under --flash_block_sparse=false (the legacy grid)")
        small_attn_legacy = phase_transformer_small(dev, legacy=True)
        set_flags(use_bf16=False, bf16_activations=False)
        log("== phase 4-sparse: bench.py's sparse embedding lane (fp32): "
            "lookups, the V 1e7 train A/B, kernel 22 in the D 128 step, the "
            "kill-switch contracts")
        sparse_launches, sparse = phase_sparse(dev)
        for name in launches:
            launches[name].update(sparse_launches[name])
        log("== phase 5: kernel times at the main paths' shapes")
        rows = phase_time(dev, launches, serve) \
            + phase_time_lstm(dev, launches) \
            + phase_time_blocked(dev, launches) \
            + phase_time_conv(dev, launches) \
            + phase_time_gru(dev, launches) \
            + phase_time_gru_blocked(dev, launches) \
            + phase_time_flash(dev, launches) \
            + phase_time_legacy(dev, launches) \
            + phase_time_gather(dev, launches)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 1
    except Exception:  # noqa: BLE001 - any phase failing fails the run
        traceback.print_exc()
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"serving": {k: v for k, v in serve.items()
                                  if k != "prompt_lengths"},
                      "training": train, "training_h1280": blocked,
                      "training_h1280_mixed_bf16": mixed,
                      "training_h2048": wide, **resnet, "seq2seq": seq2seq,
                      "seq2seq_h1024": seq2seq_wide, "c1": c1,
                      "transformer": transformer,
                      "transformer_padded_mixed": attn_mixed["padded"],
                      "transformer_packed_mixed": attn_mixed["packed"],
                      "transformer_causal": causal,
                      "transformer_causal_legacy": causal_legacy,
                      "transformer_small": small_attn,
                      "transformer_small_legacy": small_attn_legacy,
                      "sparse": sparse, "card": card}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
