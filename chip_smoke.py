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
4z-loop. the training loop around that step, at its width, flags and
   optimizer: ``Trainer.train`` over a reader of 2048 raw samples (ids
   in [0, 30000), lengths 50-100, labels 0/1; numpy seed 0) in batches
   of 128 through ``DataFeeder`` (T padded to a multiple of 8), a test
   reader of 512 and the config's ``classification_error`` evaluator
   on ``__fc_3__``, 2 passes, ``--save_dir=""``; at ``--prefetch_depth``
   0 and 2, each at ``--log_period`` 1 and at the default 100, from
   the same parameters: the events in the reference's order, finite
   costs, bit-identical between the depths, exactly 2 x (32 + 8)
   launches of kernel 8 and 2 x 32 of kernel 9 a run, samples/s of
   each pass's training and of its test, the pass's wall; then
   ``time_job`` (warmup 3, 20 batches: 2 x 23 launches of each) beside
   4d's ms/step, and ``check_gradients`` on one batch at the
   reference's rtol 5e-2 and ``--checkgrad_eps``: True, its worst
   |auto - fd| as a share of the tolerance, exact launch counts;
4z-small. the same loop at B 8, T 12, H 128, 2 passes x 3 batches
   and 2 test batches on the CPU (plain versions) and on the card from
   the same parameters: every cost and ``test_cost`` within 4e's loss
   tolerance, ``classification_error`` equal;
4z-ckpt. checkpoints around that loop (4d's model, flags and Adam, the
   loop's samples and test reader, ``--saving_period`` 1 into a
   directory under ``build/``): (a) 2 passes saving each (A); (b) a
   fresh trainer of another seed loads A's pass-00000 through
   ``--init_model_path`` and trains pass 1 at ``--start_pass=1`` (B):
   B's pass-00001 ``.npz`` digests, ``samples_seen`` and events equal
   A's; (c) (a) and (b) again under ``--precision=bf16``, the
   ``loss_scale`` fields equal too; (e) A's pass-00001 loaded on the CPU
   plain path: one step there and on the card within 4e's loss
   tolerance; (d) a flipped byte of A's pass-00001: ``resume`` loads
   pass-00000 and quarantines ``.corrupt-pass-00001``; exact launches of
   kernels 8 and 9 in each run; readings: a checkpoint's bytes, ms a
   save and ms a load beside 4d's ms/step;
4z-opt. at 4z-small's width, 3 steps of each of the ten registered
   optimizers (L1 on momentum) and of each of the seven schedules on
   SGD, then of a net with a pruning hook (3/4 of ``_lstm0_transform.w0``
   pruned, Momentum), on the CPU (plain versions) and on the card from
   one checkpoint: every cost within 4e's loss tolerance, each
   parameter's change within 1e-2 of the CPU's in norm, the pruned
   elements exactly 0 on the card; exactly 2 launches each of kernels 8
   and 9 a step on the card;
4z-cli. the same model from a config file, the way a user starts it:
   ``paddle_tpu_torch.cli.main`` in process on ``configs/rnn.py`` (its
   defaults: V 30000, E 128, H 512, 2 LSTMs, B 128, Adam lr 2e-3, L2
   8e-4, clip 25; ``configs/provider.py``'s 2048 samples of 100 ids,
   ``RandomState(0)``; fp32): ``dump_config --whole`` equal to
   ``lstm_text_classifier(30000, 128, 512, 2, 2)`` and those settings;
   ``train --job time`` (20 batches after 3 warm-up ones) beside 4d's
   ms/step and 4z-loop's ``time_job``; ``train --num_passes 1
   --save_dir`` (16 steps) whose pass-00000 ``params.npz`` is bit for
   bit that of ``Trainer(seed=1).train`` in process on the same samples;
   ``train --job test --init_model_path`` that checkpoint, its
   ``test_cost`` equal to ``Trainer.test``'s; ``train --job checkgrad``
   at H 128, B 16: ``failed`` 0; exact launches of kernels 8 and 9 in
   each job;
4z-dense. the dense layers, costs, activations, dropout and the error
   clip, fp32 with TF32 off: (a) every layer type, projection, operator
   and cost the dense slice ported (46 one-layer nets at the sizes of
   the JAX package's layer sweep) and the 28 activations forward and
   backward on the card against the same code on the CPU, within rtol
   1e-4, atol 1e-5 * max(1, max|CPU|); (b) dropout at p 0.5 over
   [256, 4096]: the kept share within 5 sigma of the binomial, kept
   values exactly x / keep and the gradient mask / keep, the identity in
   eval, one seed one mask, two seeds or layers two, through a trainer
   at lr 0 the same losses twice at seed 0 and a new mask each step; the
   error clip's gradient clamp(dy, -t, t); (c) ``configs/vae.py`` (the
   VAE demo: x 784, hidden 128, z 100, B 32, Adam lr 1e-3) through
   ``parse_config`` -> ``NeuralNetwork`` -> ``Trainer(seed=0)`` as
   ``demo/vae/train.py`` runs it: 5 steps on the card against the CPU
   from the same parameters (losses rtol 1e-5, every weight within
   2e-4, all but 1 in 10^3 within 2e-5), 300 batches of binarised
   784-vectors and N(0, 1) noise from ``RandomState(0)`` (the loss
   falls; ms/batch, pass wall; every parameter, Adam moment and layer
   value on the card; no launch of the 22 kernels), then 16 samples of
   the ``is_generating=1`` topology on the trained parameters, finite
   and in [0, 1];
4z-gen. the sequence layers, nested batches, the sampled layers and
   beam-search generation, fp32 with TF32 off: (a) the 15 types of
   ``layers/seq.py`` the slice ported, strided and nested pooling of
   every pool type, the ten new sequence ops and six pool types, the
   eight types of ``layers/common.py`` (tensor, selective_fc, prelu,
   scale_shift, data_norm, hsigmoid, nce, print: it writes its input),
   ``hierarchical_sigmoid``, ``nce_loss`` and ``selective_fc`` forward
   and backward on the card against the same code on the CPU (rtol
   1e-4, atol 1e-5 * max(1, max|CPU|), ids exact, planted ties in
   lax.top_k's order); ``nce`` against the CPU op on the card's
   negatives, ``sampling_id`` against the CPU's Gumbel-max on the card's
   uniforms (2^16 draws a row, frequencies within 5 sigma of p); (b) the
   seqToseq demo's reversal task (V 32, E 16, H 48; 600 Adam steps at lr
   0.01, clip 5, seed 1) trained on the card, then beam 4: at least 3 of
   4 exact reversals, and the CPU's decode from the card's weights equal
   (ids, lengths; scores rtol 1e-4); (c) the main path of the slice: the
   seq2seq row's model translating through ``NeuralNetwork.forward`` of
   ``seq2seq_generator_config()`` (B 128 sources of 10-30 ids, beam 3,
   max length 250): ids [128, 3, 250] in [0, 30000), lengths in [1, 250],
   scores descending, beam 0 finite; rows 0-7 at max length 30 card
   against CPU (ids and lengths equal, scores rtol 1e-4; a divergence
   only where the CPU's K-th and (K+1)-th candidates lie within 1e-4,
   printed); exactly 2 launches of kernel 13 (the encoder's two GRUs)
   and none of any other kernel a call; every parameter, memory and step
   value on the card; ms per decode step, the call's wall and generated
   tokens/s beside the card's name and power limit;
4z-tag. the recurrent types, the sequence costs and nested groups, fp32
   with TF32 off: (a) ``recurrent`` (reversed too), ``lstm_step`` (its
   value and ``.state``), ``mdlstmemory`` in its four directions on a
   2x3 grid, ``simple_rnn``, ``lstm_unit``, ``crf`` (weighted too),
   ``crf_decoding`` with and without tags, ``ctc`` with an impossible
   alignment, ``warp_ctc`` (blank 3, norm_by_times),
   ``cross_entropy_over_beam`` (gold kept, dropped at the first and at
   the second expansion) and a nested group with an empty subsequence
   and a slot no row fills, forward and backward on the card against
   the same code on the CPU (4z-gen (a)'s tolerance, paths exact), and
   kernels 8 and 9 at B 64, H 512 against the plain scan on rows of
   length 0 and on a batch of them only (3b's tolerances); (b)
   ``configs/tagging.py`` at the CRF demo's widths (V 50, 5 tags, E 16,
   H 32, B 16) trained 250 Adam steps at lr 0.02 as
   ``demo/sequence_tagging/train.py`` trains it, then Viterbi over 32
   new rows: accuracy above 0.9 (the demo's gate), the CPU's paths from
   the card's weights equal, no kernel launched (the scan at H 32); (c)
   the same config at the seq2seq row's encoder width (B 128, V 30000,
   E 512, H 512, 23 tags, lengths 10-30 through ``DataFeeder``): the
   first step's loss and every gradient card against CPU (4s's
   tolerance), 50 timed steps (finite, falling NLL; ms/step, tokens/s,
   the busy share of a profiled step; exactly 2 launches each of
   kernels 13 and 14 a step and no other), then one timed Viterbi
   decode with 2 launches of kernel 13; (d) a nested group at the LSTM
   row's width: B 64 paragraphs of 2-8 sentences of 5-25 ids through
   ``DataFeeder``'s ``integer_value_sub_sequence``, emb 512 -> a group
   over sentences (fc 4H -> lstmemory H 512 -> last_seq, a memory
   summing sentence states) -> last_seq -> fc softmax -> CE: the
   sentence states and their gradients equal the flat net's over B*S
   rows on the card (``lstm.fused_tier`` serves both), card against CPU,
   3 Adam steps with exactly S launches each of kernels 8 and 9 a step;
4z-image. the image, 3-D and detection types and ops card vs CPU,
   SSD300's multibox loss and decode, ``configs/image.py``'s nets
   through ``python -m paddle_tpu_torch train --job time`` (fp32), and
   (d) ``model=resnet`` under 4l's flags after 4l;
4z-v2. the v2 API, fp32 with TF32 off: (a) the LSTM row's net (4d's
   widths) built through ``paddle_tpu_torch.v2`` in
   ``lstm_text_classifier``'s order — its ``ModelConfig`` equal to that
   function's, ``v2.optimizer.Adam(2e-3, L2Regularization(8e-4), clip
   25)``'s ``OptimizationConfig`` equal to 4d's; 4z-loop's 2048 samples
   written by ``download.convert`` into record files of 512 and read
   back in its order; one pass of ``v2.trainer.SGD.train`` over
   ``v2.reader.batch(reader.recordio(shards), 128)`` against
   ``Trainer.train`` over the same samples in memory in the same order,
   from the same parameters (set through ``Parameters``): every batch's
   cost bit-identical, exactly 2 x 16 launches each of kernels 8 and 9
   in the v2 pass, samples/s of both; ``SGD.test`` with
   ``v2.evaluator.classification_error()`` on 512 test samples equal to
   ``Trainer.test``'s metrics; ``v2.infer`` on 128 of them equal to
   ``NeuralNetwork.forward`` in eval mode bit for bit (2 launches of
   kernel 8); ``Parameters.to_tar`` -> ``from_tar`` ->
   ``v2.model.save_model`` -> ``load_model`` into another trainer:
   every array byte-equal; (b) the sentiment demo's net through
   ``paddle.v2`` after ``compat.install()`` (emb 64,
   ``stacked_lstm_net(hid_dim=64, stacked_num=3)``, B 32, Adam 2e-3, the
   imdb loader's surrogate, which it logs): card and CPU SGDs from the
   same parameters, the first 4 batches' costs and ``infer`` on one
   batch within 4z-small's tolerance, no launch of any kernel (H 64:
   the reference's scan), then a whole pass on the card (ms/batch) and
   one profiled batch (busy share);
4z-fw. the ``framework`` package (Program IR, the op registry, the eager
   Executor, backward, Adam, io), fp32 with TF32 off: (a) the LSTM row's
   net as a Fluid program (``data("words", [100], int64, lod_level=1)``
   -> ``embedding([30000, 128])`` -> ``sequence_conv(2048,
   filter_size=1)`` -> ``lstm(512)`` -> ``sequence_conv(2048, 1)`` ->
   ``lstm(512)`` -> ``sequence_pool("LAST")`` -> ``fc(2, "softmax")`` ->
   ``cross_entropy`` -> ``mean`` -> ``AdamOptimizer(2e-3)``; 4d's feed):
   ``Executor(place=cuda)`` runs the startup and main programs on the
   card; 2 Adam steps, each exactly 2 launches each of kernels 8 and 9,
   against the same program on the CPU plain path from the card's
   startup values (costs within 4e's loss tolerance, every parameter's
   change within 4z-opt's 1e-2 in norm); an ``is_test`` run of the
   pruned program (2 launches of kernel 8, none of 9);
   ``save_inference_model`` -> ``load_inference_model`` on the card bit
   for bit; 3 warm and 20 timed steps between CUDA events (exactly 40 +
   40 launches; the memory held after each step and the peak flat
   within 16 MiB of one step's), ms/step and samples/s beside 4d's, one
   profiled step's busy share; (b) ``tests/test_framework.py``'s book
   programs, 3 runs each card against CPU from the card's startup
   values (fit a line; the MNIST MLP 784-128-64-10 with momentum and
   the conv net of two 5x5 conv-pools (20, 50) with Adam, both at
   28x28, B 64; a StaticRNN trained through; a ``cond`` both ways):
   every fetch within 4e's loss tolerance, every parameter's change
   within 1e-2 in norm, no launch of the port's kernels;
4z-obs. the telemetry core (``observe/``, ``utils/stat.py``,
   ``utils/profiler.py``) around the LSTM row at 4d's width, fp32: (a)
   one ``Trainer.train`` pass over 1024 raw samples (8 batches, lengths
   50-100, ``--prefetch_depth`` 2) of a fresh seed-0 trainer with no
   telemetry, then of another with ``--metrics_jsonl``,
   ``--trace_jsonl`` and ``--metrics_port`` (loopback) on: every step's
   cost bit-identical, exactly 2 + 2 launches of kernels 8 and 9 a step
   in both, ``train_device_blocked_seconds`` empty off and one entry a
   step on, the last JSONL line's ``train_steps`` the pass's batches,
   the trace file a Chrome trace with one ``train_pass`` over the 8
   ``train_step`` spans (each the parent of ``feed``,
   ``step_dispatch``, ``fence``) and the ``input_wait`` and pipeline
   spans, ``GET /metrics`` with ``rnn_dispatch_total`` path ``fused``
   16 times and ``hbm_in_use_bytes`` equal to
   ``torch.cuda.memory_allocated()`` at a sample, ``/healthz`` ok, the
   debug dump's two files (called directly); (b) the host-synchronizing
   CUDA runtime calls of one profiled step (4d's feed), telemetry off,
   then with a sink on: exactly one more on, the fence's
   ``cudaEventSynchronize``, and off equal to the parent tree's count
   (``PARENT_STEP_SYNCS``, counted by ``tools/step_syncs.py``); (c) 20
   steps off and 20 with every sink on beside 4d's, and the cost of a
   span off and into the ring (readings); (d) ``utils.profiler.trace``
   around 2 steps: 2 ``train_step`` ranges with the 4 + 4 launches of
   kernels 8 and 9 inside them; (e) ``global_stat.timer(...,
   block_on=...)`` around a step reads at least its CUDA-event span;
4z-roll. the train->serve pipeline at phase 4's serving config: (a) the
   seed-0 and seed-1 decoders saved as checkpoints, ``CheckpointWatcher.
   poll_once`` exports each once as int8 artifacts A and B (a second poll
   exports nothing); each model alone gives the reference tokens of
   phase 4's 48 prompts and of 24 more (seed 1); a server on A serves a
   steady window of the 48, then the 48 again with
   ``swap_from_artifact(B, inflight="drain")`` on another thread after 8
   finished, then the 24 (96 new tokens each) with ``reprefill`` back to
   A after 1: every
   request's tokens are exactly one model's (drain: A before the flip, B
   after, in admission order; reprefill: the re-prefilled requests A's,
   B's only for those done before the flip), no request fails, kernels
   1 and 7 launch after each flip (counts set to 0 before each window);
   a bit-flipped copy of B rolls back (``/healthz`` rolled_back with the
   verify error, A's tokens still served); ``POST /v1/swap`` B, then
   ``unchanged`` on the re-POST; ``--rollout=false`` keeps the
   pre-rollout ``stats()`` keys.  Readings: build and flip-pause seconds,
   TTFT p50/p99 and req/s of each window, peak memory of each window;
   (b) the canary: with traffic on A, a seed-2 artifact carrying
   ``debug_prefill_delay_ms`` 150 rolls back to A after a 3 s bake
   (windowed p99 TTFT past 2x the baseline's), a normal seed-3 artifact
   is promoted, no request fails; (c) ``ServedModel`` in a fresh process
   that imports no ``layers``, ``config``, ``trainer`` or ``framework``,
   on the card: bench.py's serving_int8 row (the MLP 784 -> 3136 -> 3136
   -> 10, B 128, 30 calls, exported fp32 and int8 with the bf16 dequant;
   fp32 within 1e-6 of the in-process forward on the card, batch 64 of
   the polymorphic artifact; ms/call, top1_delta, loss_delta,
   size_ratio) and the LSTM row's classifier (B 128, T 100, H 512, fp32,
   a SequenceBatch feed: within ``LSTM_ATOL`` of the in-process forward,
   kernel 8 launched twice a call, the same ``model.pt2`` on the CPU
   within ``LSTM_ATOL``);
3c. the hidden-blocked LSTM kernels 10-12 (forward, BPTT, dW): through
   their ``autograd.Function`` against autograd through the plain scan,
   and each wrapper against its plain version, at (B, T, H) = (8, 5,
   640) with lengths 0, 1 and T; (200, 4, 700), B = 200 and H not a
   multiple of 128, reversed; (3, 1, 642), one step and H % 4 != 0;
   (128, 100, 1280) and (128, 100, 2048) with the bench feed's lengths;
   tolerances of 3b;
4z-dist. the multi-device slice at 4d's width (the LSTM row: B 128
   global, T 100, H 512, fp32, kernels 8 and 9), its child processes
   started together at the phase's start, each with a deadline: (a)
   world 1 over NCCL in this process (``initialize_cluster`` on the
   card, one all-reduce): ``--fsdp`` on and off under the ``{data: 1}``
   mesh, 3 steps each, bit-identical parameters, 3 x 2 launches each of
   kernels 8 and 9 each way; (b) two ranks sharing the card over gloo
   (``backend="gloo"``; PyTorch's gloo carries every collective the port
   uses on CUDA tensors but point-to-point sends, so ring attention is
   left to the CPU tests): 4 data-parallel steps of global B 128 (64 a
   rank) against one rank's run of the same 4 batches on the card —
   each rank's parameters within ``DIST_PARAM_RTOL`` of the one rank's
   (||d|| / ||update||, set between the honest reading and a planted
   fault's, rank 1 keeping its own gradient, which must exceed it), the
   losses within ``DIST_LOSS_RTOL``; the same under ``--fsdp`` with
   ``lstm_fsdp_rules``: params + opt_state bytes per rank <= 0.55 x the
   replicated run's, a sharded checkpoint whose parameters load into one
   rank bit for bit; 4 x 2 launches each of kernels 8 and 9 a rank and
   run; (c) ``python -m paddle_tpu_torch master`` with a snapshot file,
   the LSTM row's samples as a record file of 12 chunks of 128; a
   trainer child reads them through ``cloud_reader`` (checkpointing
   after each chunk) and is SIGKILLed after 4 chunks; a fresh child
   resumes under ``ElasticTrainer`` (True, samples_seen > 0) and drains
   the pass; the master ends with pending 0, no chunk failed, the epoch
   reset (12 to do, epoch 1); kernels 8 and 9 launched in both
   children.  Readings: ms/step of one rank alone and of two ranks
   sharing the card (no scaling figure: they share the SMs), the gloo
   all-reduce's ms a step, a pass of ``Trainer.train`` fed by the master
   through ``cloud_reader`` beside one over the same chunks in memory in
   the same child (samples/s), a lease RPC's us, the resume's seconds;
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
off), so their readings stay comparable, as do 4z-loop and 4z-small.
The order of the run: 1-3f, 3g-3i, 4-4f, 4z-loop, 4z-small, 4z-ckpt,
4z-opt, 4z-cli, 4z-dense, 4z-gen, 4z-tag, 4z-image, 4z-v2, 4z-fw,
4z-obs, 4z-roll, 4z-dist, 4g-4k, 4l-4p, 4z-image (d), 4q-4r, 4t, 4v, 4s, 4u,
4w-4z, 4-sparse, 5.  Each phase's wall seconds (keyed by the id of its
``== phase`` line; a phase logged again adds to its entry) and the
total are printed as one ``{"phase_seconds": {...}}`` line before the
results.

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


#: each phase's wall seconds, keyed by the id of its "== phase <id>" log
#: line (a phase logged again later adds to its entry); "current" is the
#: phase running and "t0" when it started
PHASES = {"current": None, "t0": 0.0, "seconds": {}}


def mark_phase(name) -> None:
    """Close the running phase's time and start ``name``'s (None: stop)."""
    now = time.perf_counter()
    if PHASES["current"] is not None:
        secs = PHASES["seconds"]
        secs[PHASES["current"]] = secs.get(PHASES["current"], 0.0) \
            + now - PHASES["t0"]
    PHASES["current"], PHASES["t0"] = name, now


def log(msg: str) -> None:
    if msg.startswith("== phase "):
        mark_phase(msg[len("== phase "):].split(":")[0].split(" ")[0])
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


# ------------------------------------------------ the training loop
#: phase 4z-loop: the 4d model, flags and optimizer around Trainer.train:
#: a reader of LOOP_SAMPLES raw (ids, label) samples (ids in [0, V),
#: lengths in LOOP_LENGTHS, labels 0/1, from a numpy seed) in batches of
#: TRAIN_B, a test reader of LOOP_TEST_SAMPLES, LOOP_PASSES passes;
#: phase 4z-small: the same loop at B 8, lengths 6-12 (padded to 12), H
#: 128, 3 batches a pass and 2 test batches, card vs CPU
LOOP_SAMPLES, LOOP_TEST_SAMPLES, LOOP_PASSES = 2048, 512, 2
LOOP_LENGTHS = (50, 100)
LOOP_EVALUATOR = {"type": "classification_error",
                  "name": "__classification_error_evaluator_0__",
                  "input_layer_name": "__fc_3__", "label_layer_name": "label"}
TIME_JOB_WARM, TIME_JOB_BATCHES = 3, 20
CHECKGRAD_RTOL = 5e-2          # the reference's default rtol
SMALL_LOOP = dict(b=8, lengths=(6, 12), bucket=12, hidden=128, batches=3,
                  test_batches=2)


def loop_samples(n, vocab, lengths, seed):
    """``n`` raw samples ``(ids list, label)``, drawn from
    ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = int(rng.randint(lengths[0], lengths[1] + 1))
        out.append((rng.randint(0, vocab, t).tolist(),
                    int(rng.randint(0, 2))))
    return out


def loop_setup(dims, dev, b, samples, test_samples, bucket=None, seed=0,
               opt=TRAIN_OPT):
    """A trainer of the classifier with the loop's evaluator entry (the
    port's own init, ``seed``; ``OptimizationConfig(**opt)``), the
    feeder and both batch readers."""
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.data import (DataFeeder, integer_value,
                                       integer_value_sequence, reader)
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import lstm_text_classifier
    from paddle_tpu_torch.trainer.trainer import Trainer
    cfg = lstm_text_classifier(**dims)
    cfg.evaluators.append(dict(LOOP_EVALUATOR))
    trainer = Trainer(NeuralNetwork(cfg), OptimizationConfig(**opt),
                      seed=seed, device=dev)
    feeder = DataFeeder([("data", integer_value_sequence(dims["vocab_size"])),
                         ("label", integer_value(2))],
                        buckets=[bucket] if bucket else None)
    return (trainer, feeder, reader.batch(reader.np_array(samples), b),
            reader.batch(reader.np_array(test_samples), b))


def expected_events(n_batches, passes, log_period):
    """The reference's (event, pass, batch) sequence of ``train``."""
    out = []
    for p in range(passes):
        out.append(("BeginPass", p, None))
        for i in range(n_batches):
            out.append(("BeginIteration", p, i))
            if (i + 1) % log_period == 0:
                out.append(("EndIteration", p, i))
        out.append(("EndPass", p, None))
    return out


def loop_run(trainer, feeder, train_reader, test_reader, depth,
             log_period, passes=LOOP_PASSES, save_dir=""):
    """``trainer.train`` once at ``--prefetch_depth`` ``depth``,
    ``--log_period`` ``log_period`` and ``--save_dir`` ``save_dir``
    (a checkpoint every pass when set), every launch count set to 0
    just before it: (events as (kind, pass, batch, payload), each pass's
    (train wall, test wall, pass wall) in s, launches).  A pass's train
    wall ends where its ``test`` starts, after a device sync."""
    import torch
    set_flags(prefetch_depth=depth, log_period=log_period,
              save_dir=save_dir, saving_period=1)
    events, stamps, tests = [], [], []

    def handle(e):
        kind = type(e).__name__
        payload = e.cost if kind == "EndIteration" else \
            dict(getattr(e, "metrics", {}))
        events.append((kind, e.pass_id, getattr(e, "batch_id", None),
                       payload))
        stamps.append(time.perf_counter())

    run_test = trainer.test

    def timed_test(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_test(*args, **kw)
        tests.append((t0, time.perf_counter()))
        return out

    trainer.test = timed_test
    torch.cuda.synchronize()
    reset_counts()
    try:
        trainer.train(train_reader, passes, handle, feeder, test_reader)
    finally:
        del trainer.test
    launches = read_counts()
    begins = [t for t, e in zip(stamps, events) if e[0] == "BeginPass"]
    ends = [t for t, e in zip(stamps, events) if e[0] == "EndPass"]
    walls = [(t0 - b, t1 - t0, e - b)
             for b, (t0, t1), e in zip(begins, tests, ends)]
    return events, walls, launches


def check_launches(launches, want, what):
    """Exactly ``want[name]`` launches of each kernel named, none of any
    other."""
    for name, count in launches.items():
        if count != want.get(name, 0):
            fail(f"{what}: {name} launched {count} times, expected "
                 f"{want.get(name, 0)}")


def phase_loop(dev, step):
    """Phase 4z-loop: ``Trainer.train`` at 4d's width at
    ``--prefetch_depth`` 0 and 2 (each at ``--log_period`` 1 for the
    events and every step's cost, and at the default 100 for the
    timing), then ``time_job`` and ``check_gradients``; ``step`` is
    phase 4d's metrics (``train_one_batch`` on the same model)."""
    import logging
    from paddle_tpu_torch.core.sequence import bucket_length
    from paddle_tpu_torch.data import reader
    from paddle_tpu_torch.utils import FLAGS
    v = TRAIN["vocab_size"]
    samples = loop_samples(LOOP_SAMPLES, v, LOOP_LENGTHS, 0)
    test_samples = loop_samples(LOOP_TEST_SAMPLES, v, LOOP_LENGTHS, 1)
    n_batches = LOOP_SAMPLES // TRAIN_B
    n_test = LOOP_TEST_SAMPLES // TRAIN_B
    ts = [bucket_length(max(len(s[0]) for s in samples[i:i + TRAIN_B]))
          for i in range(0, LOOP_SAMPLES, TRAIN_B)]
    log(f"  {LOOP_SAMPLES} samples in {n_batches} batches of {TRAIN_B} a "
        f"pass, lengths {LOOP_LENGTHS[0]}-{LOOP_LENGTHS[1]}: padded T "
        f"{ts}; "
        f"{LOOP_TEST_SAMPLES} test samples, {LOOP_PASSES} passes")
    want = {"lstm_fwd": 2 * LOOP_PASSES * (n_batches + n_test),
            "lstm_bwd": 2 * LOOP_PASSES * n_batches}
    old = {k: FLAGS.get(k) for k in ("prefetch_depth", "log_period",
                                     "save_dir")}
    runs, m, counts = {}, {"padded_T": ts}, {}
    try:
        for log_period in (1, 100):
            for depth in (0, 2):
                trainer, feeder, train_r, test_r = loop_setup(
                    TRAIN, dev, TRAIN_B, samples, test_samples)
                events, walls, launches = loop_run(
                    trainer, feeder, train_r, test_r, depth, log_period)
                del trainer
                tag = f"depth {depth}, log_period {log_period}"
                if [e[:3] for e in events] != expected_events(
                        n_batches, LOOP_PASSES, log_period):
                    fail(f"train ({tag}): events out of the reference's "
                         f"order: {[e[:3] for e in events][:8]}")
                check_launches(launches, want, f"train ({tag})")
                costs = [e[3] for e in events if e[0] == "EndIteration"]
                passes = [e[3] for e in events if e[0] == "EndPass"]
                if not all(np.isfinite(costs + [p[k] for p in passes
                                                for k in p])):
                    fail(f"train ({tag}): a non-finite cost or metric")
                runs[(depth, log_period)] = events
                for name, n in launches.items():
                    counts[name] = counts.get(name, 0) + n
                log(f"  train, {tag}: passes "
                    + "; ".join(
                        f"{LOOP_SAMPLES / tr:.1f} samples/s (train "
                        f"{tr * 1e3:.1f} ms, test {te * 1e3:.1f} ms = "
                        f"{LOOP_TEST_SAMPLES / te:.1f} samples/s, pass "
                        f"{pw * 1e3:.1f} ms)" for tr, te, pw in walls)
                    + f"; EndPass {passes}")
                if log_period == 1:
                    log(f"    costs {[round(c, 6) for c in costs]}")
                m[f"depth{depth}_log{log_period}"] = {
                    "train_samples_per_s": [LOOP_SAMPLES / w[0]
                                            for w in walls],
                    "test_samples_per_s": [LOOP_TEST_SAMPLES / w[1]
                                           for w in walls],
                    "train_wall_ms": [w[0] * 1e3 for w in walls],
                    "pass_wall_ms": [w[2] * 1e3 for w in walls],
                    "end_pass": passes}
        for log_period in (1, 100):
            if runs[(0, log_period)] != runs[(2, log_period)]:
                fail(f"train at log_period {log_period}: costs or metrics "
                     "differ between --prefetch_depth 0 and 2")
        log("  --prefetch_depth 0 and 2: events, every cost and the "
            "EndPass metrics bit-identical")

        log(f"== phase 4z-loop: time_job (warmup {TIME_JOB_WARM}, "
            f"{TIME_JOB_BATCHES} batches)")
        trainer, feeder, train_r, _ = loop_setup(
            TRAIN, dev, TRAIN_B, samples, test_samples)
        reset_counts()
        tj = trainer.time_job(reader.chain(train_r, train_r), feeder,
                              TIME_JOB_WARM, TIME_JOB_BATCHES)
        n = TIME_JOB_WARM + TIME_JOB_BATCHES
        tj_launches = read_counts()
        check_launches(tj_launches, {"lstm_fwd": 2 * n, "lstm_bwd": 2 * n},
                       "time_job")
        log(f"  time_job: {tj['ms_per_batch']:.3f} ms/batch, "
            f"{tj['samples_per_sec']:.1f} samples/s over {tj['batches']} "
            f"batches (T "
            f"{[ts[i % n_batches] for i in range(TIME_JOB_WARM, n)]}); "
            f"4d's train_one_batch {step['ms_per_step']:.3f} ms/step, "
            f"{step['samples_per_s']:.1f} samples/s (T {TRAIN_T}, CUDA "
            "events)")
        m["time_job"] = tj

        log("== phase 4z-loop: check_gradients on one full-width batch "
            f"(rtol {CHECKGRAD_RTOL}, eps {FLAGS.get('checkgrad_eps')})")
        feed = feeder.convert(samples[:TRAIN_B])
        lines = []

        class Lines(logging.Handler):
            def emit(self, record):
                lines.append(record.getMessage())

        handler = Lines(logging.WARNING)
        logger = logging.getLogger("paddle_tpu_torch.trainer")
        logger.addHandler(handler)
        try:
            reset_counts()
            trainer.check_gradients(feed, rtol=-1)    # logs every check
            every = read_counts()
            checks = [ln.split("checkgrad FAIL ")[1] for ln in lines]
            lines.clear()
            reset_counts()
            ok = trainer.check_gradients(feed)
            cg_launches = read_counts()
        finally:
            logger.removeHandler(handler)
        n_checks = sum(min(4, p.numel()) for p in trainer.params.values())
        want_cg = {"lstm_fwd": 2 * (1 + 2 * n_checks), "lstm_bwd": 2}
        check_launches(every, want_cg, "check_gradients (every check)")
        check_launches(cg_launches, want_cg, "check_gradients")
        if len(checks) != n_checks:
            fail(f"check_gradients at rtol -1 logged {len(checks)} checks, "
                 f"expected {n_checks}")
        shares = []
        for c in checks:
            auto = float(c.split("auto=")[1].split()[0])
            fd = float(c.split("fd=")[1])
            shares.append((abs(auto - fd)
                           / (CHECKGRAD_RTOL * max(abs(fd), 1e-3)), c))
        shares.sort(reverse=True)
        log(f"  T {feed['data'].max_len}; {n_checks} checks; worst "
            "|auto - fd| as a share of the tolerance: "
            + "; ".join(f"{sh:.4f} ({c})" for sh, c in shares[:5]))
        m["check_gradients"] = {"ok": ok, "checks": n_checks,
                                "worst_share": shares[0][0],
                                "worst": shares[0][1]}
        if not ok:
            fail(f"check_gradients returned False: {lines}")
        del trainer
    finally:
        set_flags(**old)
    m["launches"] = {"loop": counts, "time_job": tj_launches,
                     "check_gradients": {k: every[k] + cg_launches[k]
                                         for k in every}}
    log(f"  launches: loop {want} a run, time_job "
        f"{ {k: v for k, v in tj_launches.items() if v} }, check_gradients "
        f"{want_cg} a call")
    return m


def phase_loop_small(dev):
    """Phase 4z-small: the loop on the CPU (plain versions) and on the
    card from the same parameters: each pass's cost, every step's cost,
    ``test_cost`` within phase 4e's loss tolerance, and
    ``classification_error`` equal."""
    from paddle_tpu_torch.utils import FLAGS
    s = SMALL_LOOP
    dims = dict(TRAIN, hidden_size=s["hidden"])
    samples = loop_samples(s["b"] * s["batches"], TRAIN["vocab_size"],
                           s["lengths"], 2)
    test_samples = loop_samples(s["b"] * s["test_batches"],
                                TRAIN["vocab_size"], s["lengths"], 3)
    old = {k: FLAGS.get(k) for k in ("prefetch_depth", "log_period",
                                     "save_dir")}
    res = {}
    try:
        for where in ("cpu", dev):
            trainer, feeder, train_r, test_r = loop_setup(
                dims, where, s["b"], samples, test_samples, s["bucket"])
            events, _, launches = loop_run(trainer, feeder, train_r,
                                           test_r, 2, 1)
            if [e[:3] for e in events] != expected_events(
                    s["batches"], LOOP_PASSES, 1):
                fail(f"small loop on {where}: events out of order")
            res[str(where)] = (events, launches)
    finally:
        set_flags(**old)
    (ev_cpu, l_cpu), (ev_dev, l_dev) = res["cpu"], res[str(dev)]
    if any(l_cpu.values()):
        fail("the CPU loop launched a kernel")
    check_launches(l_dev, {
        "lstm_fwd": 2 * LOOP_PASSES * (s["batches"] + s["test_batches"]),
        "lstm_bwd": 2 * LOOP_PASSES * s["batches"]}, "small loop on the card")
    worst = 0.0
    for (kind, p, b, got), (_, _, _, want) in zip(ev_dev, ev_cpu):
        pairs = [(got, want)] if kind == "EndIteration" else \
            [(got[k], want[k]) for k in ("cost", "test_cost")] \
            if kind == "EndPass" else []
        for g, w in pairs:
            tol = LSTM_GRAD_ATOL + LSTM_GRAD_RTOL * abs(w)
            worst = max(worst, abs(g - w) / tol)
        if kind == "EndPass" and got["classification_error"] != \
                want["classification_error"]:
            fail(f"small loop pass {p}: classification_error "
                 f"{got['classification_error']} on the card, "
                 f"{want['classification_error']} on the CPU")
    passes = [(e[3], c[3]) for e, c in zip(ev_dev, ev_cpu)
              if e[0] == "EndPass"]
    log(f"  B {s['b']}, T {s['bucket']}, H {s['hidden']}, "
        f"{LOOP_PASSES} passes x {s['batches']} batches: EndPass card "
        f"{[p[0] for p in passes]}, CPU {[p[1] for p in passes]}; worst "
        f"cost error {worst:.3f} of the tolerance")
    if worst > 1.0:
        fail("the loop on the card and on the CPU disagree")
    return {"end_pass_card": [p[0] for p in passes],
            "end_pass_cpu": [p[1] for p in passes], "worst_share": worst}


# ------------------------------------------- checkpoints, optimizers
#: phase 4z-ckpt: 4d's model, flags and Adam around ``Trainer.train`` (the
#: loop's samples, batches of TRAIN_B, its test reader and evaluator),
#: a checkpoint a pass into a directory under the checkout's build/
CKPT_DIR = os.path.join("build", "chip_smoke_ckpt")
CKPT_FILES = ("params.npz", "opt_state.npz")
CKPT_READS = 3                 # timed saves and loads, each
#: phase 4z-opt: 4z-small's width (B 8, T 12, H 128), 3 steps of each
#: case on the CPU (plain versions) and on the card from the same
#: parameters and feeds: the ten registered rules with their config
#: fields (L1 on momentum), then each schedule on SGD, then a net whose
#: first fc weight carries a pruning hook (3/4 pruned) under Momentum
OPT_STEPS, OPT_B, OPT_T = 3, 8, 12
OPT_CASES = (
    ("sgd", dict(learning_rate=0.1)),
    ("momentum+l1", dict(learning_method="momentum", momentum=0.9,
                         learning_rate=0.05, l1_weight_decay=1e-3)),
    ("adagrad", dict(learning_method="adagrad", learning_rate=0.05)),
    ("adadelta", dict(learning_method="adadelta", learning_rate=1.0)),
    ("rmsprop", dict(learning_method="rmsprop", learning_rate=1e-3)),
    ("decayed_adagrad", dict(learning_method="decayed_adagrad",
                             learning_rate=1e-2)),
    ("adam", dict(learning_method="adam", learning_rate=2e-3)),
    ("adamax", dict(learning_method="adamax", learning_rate=2e-3)),
    ("proximal_gd", dict(learning_method="proximal_gd", learning_rate=0.1)),
    ("proximal_adagrad", dict(learning_method="proximal_adagrad",
                              learning_rate=0.05)),
    *((f"sgd/{name}", dict(learning_rate=0.1, learning_rate_schedule=name,
                           **kw)) for name, kw in (
        ("constant", {}),
        ("poly", dict(learning_rate_decay_a=0.1, learning_rate_decay_b=0.5)),
        ("caffe_poly", dict(learning_rate_decay_a=64.0,
                            learning_rate_decay_b=1.0)),
        ("exp", dict(learning_rate_decay_a=0.5, learning_rate_decay_b=16.0)),
        ("discexp", dict(learning_rate_decay_a=0.5,
                         learning_rate_decay_b=16.0)),
        ("linear", dict(learning_rate_decay_a=1e-3,
                        learning_rate_decay_b=0.01)),
        ("manual", dict(learning_rate_args="8:1.0,16:0.5,1000:0.25")))))
#: every case with 4d's L2 and clipping (gradients stay off zero)
OPT_COMMON = dict(l2_weight_decay=8e-4, gradient_clipping_threshold=25.0)
#: parameters, card against CPU: the change over the 3 steps agrees in
#: norm, ||d_card - d_cpu|| <= OPT_PARAM_RTOL * ||d_cpu|| for every
#: parameter (an Adam-like rule turns a gradient that rounding noise can
#: flip into a whole +-lr step, so an elementwise bound would be lr)
OPT_PARAM_RTOL = 1e-2
PRUNED_PARAM, PRUNE_RATIO = "_lstm0_transform.w0", 0.75
OPT_DIR = os.path.join("build", "chip_smoke_opt")
#: phase 4z-cli: the config file, its settings (OptimizationConfig
#: fields), the samples its provider yields by default, the time job's
#: samples (3 warm-up and 20 timed batches of 128), checkgrad's
#: --config_args, and the checkpoint directory under the checkout's build/
CLI_CONFIG = os.path.join("paddle_tpu_torch", "configs", "rnn.py")
CLI_OPT = dict(batch_size=TRAIN_B, learning_method="adam",
               learning_rate=2e-3, l2_weight_decay=8e-4,
               gradient_clipping_threshold=25)
CLI_SAMPLES, CLI_T = 2048, 100
CLI_TIME_SAMPLES = (TIME_JOB_WARM + TIME_JOB_BATCHES) * TRAIN_B
CLI_CHECKGRAD_ARGS, CLI_CHECKGRAD_DIMS = \
    "hidden_size=128,batch_size=16", dict(TRAIN, hidden_size=128)
CLI_DIR = os.path.join("build", "chip_smoke_cli")


def npz_digests(ckpt):
    """The manifest's SHA-256 of each ``.npz`` of a checkpoint dir."""
    from paddle_tpu_torch.trainer.checkpoint import load_manifest
    return {f: v["sha256"] for f, v in load_manifest(ckpt)["files"].items()}


def flip_byte(path):
    """XOR one byte in the middle of ``path`` (silent media damage)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


def phase_ckpt(dev, step):
    """Phase 4z-ckpt: (a) ``train`` two passes saving each (A); (b) a
    fresh trainer with another seed loads A's pass-00000 through
    ``--init_model_path`` and trains pass 1 at ``--start_pass=1`` (B):
    B's pass-00001 equal to A's (the three ``.npz`` digests,
    ``samples_seen``, the events), fp32 and ``--precision=bf16`` (the
    loss-scale fields too); (e) A's pass-00001 loaded on the CPU plain
    path: one step there and on the card within 4e's loss tolerance; (d)
    a flipped byte of A's pass-00001: ``resume`` lands on pass-00000 and
    quarantines it; readings: bytes, ms a save and ms a load beside
    4d's ms/step."""
    import shutil
    import torch
    from paddle_tpu_torch.ops import recurrent_ops
    from paddle_tpu_torch.trainer.checkpoint import (load_manifest,
                                                     verify_checkpoint)
    from paddle_tpu_torch.utils import FLAGS
    v = TRAIN["vocab_size"]
    samples = loop_samples(LOOP_SAMPLES, v, LOOP_LENGTHS, 0)
    test_samples = loop_samples(LOOP_TEST_SAMPLES, v, LOOP_LENGTHS, 1)
    n_batches = LOOP_SAMPLES // TRAIN_B
    n_test = LOOP_TEST_SAMPLES // TRAIN_B
    names = ("prefetch_depth", "log_period", "save_dir", "saving_period",
             "start_pass", "init_model_path", "precision")
    old = {k: FLAGS.get(k) for k in names}
    root = os.path.abspath(CKPT_DIR)
    shutil.rmtree(root, ignore_errors=True)
    m, counts = {}, {}
    try:
        for precision in ("fp32", "bf16"):
            set_flags(precision=precision, start_pass=0)
            a_dir = os.path.join(root, f"A_{precision}")
            b_dir = os.path.join(root, f"B_{precision}")
            trainer, feeder, train_r, test_r = loop_setup(
                TRAIN, dev, TRAIN_B, samples, test_samples)
            recurrent_ops.rnn_dispatch_total.clear()
            ev_a, _, la = loop_run(trainer, feeder, train_r, test_r, 2, 1,
                                   save_dir=a_dir)
            decisions = dict(recurrent_ops.rnn_dispatch_total)
            if [e[:3] for e in ev_a] != expected_events(
                    n_batches, LOOP_PASSES, 1):
                fail(f"ckpt A ({precision}): events out of order")
            check_launches(la, {
                "lstm_fwd": 2 * LOOP_PASSES * (n_batches + n_test),
                "lstm_bwd": 2 * LOOP_PASSES * n_batches},
                f"ckpt A ({precision})")
            if sorted(os.listdir(a_dir)) != ["pass-00000", "pass-00001"]:
                fail(f"ckpt A ({precision}): saved {os.listdir(a_dir)}")
            set_flags(init_model_path=os.path.join(a_dir, "pass-00000"),
                      start_pass=1)
            trainer_b, feeder, train_r, test_r = loop_setup(
                TRAIN, dev, TRAIN_B, samples, test_samples, seed=7)
            set_flags(init_model_path="")
            ev_b, _, lb = loop_run(trainer_b, feeder, train_r, test_r, 2, 1,
                                   passes=1, save_dir=b_dir)
            check_launches(lb, {"lstm_fwd": 2 * (n_batches + n_test),
                                "lstm_bwd": 2 * n_batches},
                           f"ckpt B ({precision})")
            for name in set(la) | set(lb):
                counts[name] = counts.get(name, 0) + la[name] + lb[name]
            pa, pb = (os.path.join(d, "pass-00001") for d in (a_dir, b_dir))
            da, db = npz_digests(pa), npz_digests(pb)
            ma, mb = load_manifest(pa), load_manifest(pb)
            if da != db:
                fail(f"ckpt ({precision}): B's pass-00001 digests {db} != "
                     f"A's {da}")
            keys = ["samples_seen"] + (["loss_scale"]
                                       if precision == "bf16" else [])
            for k in keys:
                if ma[k] != mb[k]:
                    fail(f"ckpt ({precision}): {k} {mb[k]} != {ma[k]}")
            if ev_b != [e for e in ev_a if e[1] == 1]:
                fail(f"ckpt ({precision}): B's events differ from A's pass 1")
            log(f"  {precision}: A 2 passes, B pass 1 from A's pass-00000 "
                f"(seed 7): pass-00001 digests equal "
                f"({ {f: d[:12] for f, d in da.items()} }), samples_seen "
                f"{mb['samples_seen']}"
                + (f", loss_scale {mb['loss_scale']}"
                   if precision == "bf16" else "")
                + f"; events and costs equal; launches A "
                f"{ {k: n for k, n in la.items() if n} }, B "
                f"{ {k: n for k, n in lb.items() if n} }; RNN decisions "
                f"{decisions}")
            rec = {"digests_equal": True, "samples_seen": mb["samples_seen"],
                   "launches_a": {k: n for k, n in la.items() if n},
                   "launches_b": {k: n for k, n in lb.items() if n},
                   "rnn_decisions": {"/".join(k): n
                                     for k, n in decisions.items()}}
            if precision == "bf16":
                rec["loss_scale"] = mb["loss_scale"]
            m[precision] = rec
            if precision != "fp32":
                continue
            # readings: a save and a load beside 4d's step
            nbytes = sum(os.path.getsize(os.path.join(pa, f))
                         for f in os.listdir(pa))
            scratch = os.path.join(root, "timed")
            torch.cuda.synchronize()
            saves, loads = [], []
            for i in range(CKPT_READS):
                t0 = time.perf_counter()
                trainer.save(scratch, i)
                saves.append((time.perf_counter() - t0) * 1e3)
            for _ in range(CKPT_READS):
                t0 = time.perf_counter()
                trainer.load(pa)
                torch.cuda.synchronize()
                loads.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            if not verify_checkpoint(pa):
                fail("ckpt: A's pass-00001 does not verify")
            verify_ms = (time.perf_counter() - t0) * 1e3
            log(f"  a checkpoint: {nbytes} bytes ("
                + ", ".join(f"{f} {os.path.getsize(os.path.join(pa, f))}"
                            for f in sorted(os.listdir(pa)))
                + f"); save {[round(x, 3) for x in saves]} ms, load "
                f"{[round(x, 3) for x in loads]} ms (of which the digest "
                f"check {verify_ms:.3f} ms; host clock, warm page cache); "
                f"4d's step {step['ms_per_step']:.3f} ms")
            m["bytes"] = nbytes
            m["save_ms"], m["load_ms"] = saves, loads
            m["verify_ms"] = verify_ms
            m["step_ms"] = step["ms_per_step"]
            # (e) A's pass-00001 on the CPU plain path, one step each side
            cpu, _, _, _ = loop_setup(TRAIN, "cpu", TRAIN_B, samples,
                                      test_samples, seed=3)
            cpu.load(pa)
            feed = feeder.convert(samples[:TRAIN_B])
            l_cpu = float(cpu.train_one_batch(feed))
            l_dev = float(trainer.train_one_batch(feed))
            tol = LSTM_GRAD_ATOL + LSTM_GRAD_RTOL * abs(l_cpu)
            log(f"  A's pass-00001 on the CPU plain path and on the card, "
                f"one step: loss {l_cpu:.7f} vs {l_dev:.7f} "
                f"({abs(l_dev - l_cpu) / tol:.3f} of 4e's tolerance)")
            if not abs(l_dev - l_cpu) <= tol:
                fail("ckpt: the loaded checkpoint's step on the card and on "
                     "the CPU disagree")
            m["cpu_step_share"] = abs(l_dev - l_cpu) / tol
            del cpu
            # (d) a flipped byte: resume falls back and quarantines
            flip_byte(os.path.join(pa, "params.npz"))
            trainer_d, _, _, _ = loop_setup(TRAIN, dev, TRAIN_B, samples,
                                            test_samples, seed=11)
            if not trainer_d.resume(a_dir):
                fail("ckpt: resume found no valid checkpoint")
            left = sorted(os.listdir(a_dir))
            want_seen = load_manifest(os.path.join(
                a_dir, "pass-00000"))["samples_seen"]
            if left != [".corrupt-pass-00001", "pass-00000"] \
                    or trainer_d.samples_seen != want_seen:
                fail(f"ckpt: after a flipped byte resume left {left}, "
                     f"samples_seen {trainer_d.samples_seen}")
            log(f"  a flipped byte in A's pass-00001: resume loaded "
                f"pass-00000 (samples_seen {want_seen}), dir now {left}")
            del trainer, trainer_b, trainer_d
    finally:
        set_flags(**old)
        shutil.rmtree(root, ignore_errors=True)
    m["launches"] = counts
    return m


def opt_feed(seed, where):
    return train_feed(seed, OPT_B, OPT_T, TRAIN["vocab_size"], where)


def phase_opt(dev):
    """Phase 4z-opt: each case of ``OPT_CASES`` and the pruned net, 3
    steps on the CPU plain path and on the card from the same
    parameters: every cost within 4e's loss tolerance, every
    parameter's change within ``OPT_PARAM_RTOL``; the pruned elements
    exactly 0 on the card.  Counts set to 0 at the start, read at the
    end (the CPU runs launch nothing)."""
    import dataclasses
    import shutil
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import lstm_text_classifier
    from paddle_tpu_torch.trainer.checkpoint import save_checkpoint
    from paddle_tpu_torch.trainer.trainer import Trainer
    dims = dict(TRAIN, hidden_size=SMALL_LOOP["hidden"])
    cfg = lstm_text_classifier(**dims)
    pruned_cfg = lstm_text_classifier(**dims)
    spec = NeuralNetwork(pruned_cfg).param_specs[PRUNED_PARAM]
    pruned_cfg.parameters.append(dataclasses.replace(
        spec, update_hooks=[{"type": "pruning",
                             "sparsity_ratio": PRUNE_RATIO}]))
    cases = [(label, cfg, dict(kw, **OPT_COMMON)) for label, kw in OPT_CASES]
    cases.append(("pruned/momentum", pruned_cfg,
                  dict(learning_method="momentum", momentum=0.9,
                       learning_rate=0.05, **OPT_COMMON)))
    # every trainer starts from one checkpoint (--init_model_path): the
    # same values on both sides, and the pruning masks made from them
    root = os.path.abspath(OPT_DIR)
    shutil.rmtree(root, ignore_errors=True)
    start = save_checkpoint(root, 0, NeuralNetwork(cfg).init_params(
        seed=0, device="cpu"))
    reset_counts()
    rows, worst_cost, worst_param = [], 0.0, 0.0
    for label, c, kw in cases:
        res = {}
        for where in ("cpu", dev):
            set_flags(init_model_path=start)
            try:
                tr = Trainer(NeuralNetwork(c), OptimizationConfig(**kw),
                             seed=0, device=where)
            finally:
                set_flags(init_model_path="")
            p0 = {n: p.detach().cpu().clone() for n, p in tr.params.items()}
            losses = [float(tr.train_one_batch(opt_feed(30 + i, where)))
                      for i in range(OPT_STEPS)]
            res[str(where)] = (losses, p0, {n: p.detach().cpu()
                                            for n, p in tr.params.items()},
                               tr)
        (lc, p0, pc, _), (ld, _, pd, tr_dev) = res["cpu"], res[str(dev)]
        if not all(np.isfinite(lc + ld)):
            fail(f"opt {label}: a non-finite cost")
        share = max(abs(a - b) / (LSTM_GRAD_ATOL + LSTM_GRAD_RTOL * abs(b))
                    for a, b in zip(ld, lc))
        perr = 0.0
        for n in pc:
            d_cpu, d_dev = pc[n] - p0[n], pd[n] - p0[n]
            den = float(d_cpu.norm())
            perr = max(perr, float((d_dev - d_cpu).norm()) / max(den, 1e-30))
        worst_cost, worst_param = max(worst_cost, share), max(worst_param,
                                                              perr)
        rows.append({"case": label, "costs_card": ld, "costs_cpu": lc,
                     "cost_share": share, "param_rel_err": perr})
        log(f"  {label:18s} costs card {[round(x, 6) for x in ld]} CPU "
            f"{[round(x, 6) for x in lc]} ({share:.3f} of the tolerance); "
            f"parameter change rel err {perr:.2e}")
        if share > 1.0 or perr > OPT_PARAM_RTOL:
            fail(f"opt {label}: card and CPU disagree")
        if label.startswith("pruned"):
            mask = tr_dev._prune_masks[PRUNED_PARAM].cpu()
            w = pd[PRUNED_PARAM]
            kept = int(mask.sum())
            if kept != int(mask.numel() * (1 - PRUNE_RATIO)) \
                    or bool((w[mask == 0] != 0).any()) \
                    or not bool((w != p0[PRUNED_PARAM])[mask != 0].any()):
                fail(f"opt {label}: the pruned elements of {PRUNED_PARAM} "
                     "are not all 0, or the kept ones did not move")
            log(f"  {PRUNED_PARAM}: {kept} of {mask.numel()} kept, the "
                f"other {mask.numel() - kept} exactly 0 on the card after "
                f"{OPT_STEPS} steps")
        del res, tr_dev
    launches = read_counts()
    shutil.rmtree(root, ignore_errors=True)
    n = 2 * OPT_STEPS * len(cases)
    check_launches(launches, {"lstm_fwd": n, "lstm_bwd": n}, "opt")
    log(f"  {len(cases)} cases: worst cost {worst_cost:.3f} of 4e's "
        f"tolerance, worst parameter-change rel err {worst_param:.2e} "
        f"(limit {OPT_PARAM_RTOL}); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return {"cases": rows, "worst_cost_share": worst_cost,
            "worst_param_rel_err": worst_param,
            "launches": {k: v for k, v in launches.items() if v}}


def run_cli(argv, want, what):
    """``cli.main(argv)`` in process with every launch count set to 0
    just before it: its standard output (the job's JSON line), after
    checking the exit code 0 and exactly ``want`` launches."""
    import contextlib
    import io
    import torch
    from paddle_tpu_torch import cli
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = read_counts()
    if rc != 0:
        fail(f"{what}: exit code {rc}: {out.getvalue()[-2000:]}")
    check_launches(launches, want, what)
    return out.getvalue(), launches


def phase_cli(dev, step, time_job):
    """Phase 4z-cli: the jobs of ``python -m paddle_tpu_torch`` on
    ``configs/rnn.py`` at 4d's width, in process; ``step`` is phase 4d's
    metrics and ``time_job`` 4z-loop's."""
    import dataclasses
    import importlib.util
    import shutil
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.data import (DataFeeder, integer_value,
                                       integer_value_sequence, reader)
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import lstm_text_classifier
    from paddle_tpu_torch.trainer.trainer import Trainer
    from paddle_tpu_torch.utils import FLAGS
    config = os.path.abspath(CLI_CONFIG)
    root = os.path.abspath(CLI_DIR)
    shutil.rmtree(root, ignore_errors=True)
    names = ("save_dir", "saving_period", "start_pass", "init_model_path",
             "log_period")
    old = {k: FLAGS.get(k) for k in names}
    n_batches = CLI_SAMPLES // TRAIN_B
    m, counts = {}, {}

    def add(launches):
        for name, n in launches.items():
            counts[name] = counts.get(name, 0) + n

    try:
        set_flags(saving_period=1, start_pass=0, init_model_path="")
        log("  dump_config --whole")
        out, launches = run_cli(["dump_config", "--whole", config], {},
                                "dump_config")
        whole = json.loads(out)
        want_model = json.loads(lstm_text_classifier(**TRAIN).to_json())
        if whole["model"] != want_model:
            fail("dump_config: the model differs from "
                 "lstm_text_classifier(30000, 128, 512, 2, 2)")
        if whole["opt"] != dataclasses.asdict(OptimizationConfig(**CLI_OPT)):
            fail(f"dump_config: the optimization section {whole['opt']} "
                 f"is not {CLI_OPT}")
        log(f"  model ({len(want_model['layers'])} layers) and optimization "
            f"equal; data {whole['data']}")

        n = TIME_JOB_WARM + TIME_JOB_BATCHES
        log(f"  train --job time ({TIME_JOB_WARM} warm-up and "
            f"{TIME_JOB_BATCHES} timed batches of {TRAIN_B})")
        out, launches = run_cli(
            ["train", "--job", "time", "--config", config, "--config_args",
             f"num_samples={CLI_TIME_SAMPLES}"],
            {"lstm_fwd": 2 * n, "lstm_bwd": 2 * n}, "train --job time")
        tj = json.loads(out.strip().splitlines()[-1])
        add(launches)
        m["time"] = tj
        log(f"  --job time: {tj['samples_per_sec']} samples/s, "
            f"{tj['ms_per_batch']} ms/batch (T {CLI_T}, padded to "
            f"{-(-CLI_T // 8) * 8}); 4z-loop's time_job "
            f"{time_job['samples_per_sec']:.1f} samples/s, "
            f"{time_job['ms_per_batch']:.3f} ms/batch; 4d's "
            f"train_one_batch {step['samples_per_s']:.1f} samples/s, "
            f"{step['ms_per_step']:.3f} ms/step")

        log(f"  train --num_passes 1 --save_dir ({n_batches} steps)")
        cli_dir = os.path.join(root, "cli")
        _, launches = run_cli(
            ["train", "--config", config, "--num_passes", "1",
             "--save_dir", cli_dir],
            {"lstm_fwd": 2 * n_batches, "lstm_bwd": 2 * n_batches},
            "train --num_passes 1")
        add(launches)
        # the same config, samples and seed through Trainer.train
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_provider",
            os.path.join(os.path.dirname(config), "provider.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        provider = module.process_rnn
        trainer = Trainer(NeuralNetwork(lstm_text_classifier(**TRAIN)),
                          OptimizationConfig(**CLI_OPT), seed=1, device=dev)
        feeder = DataFeeder([
            ("data", integer_value_sequence(TRAIN["vocab_size"])),
            ("label", integer_value(2))])

        def samples():
            return reader.batch(provider.reader(
                vocab_size=TRAIN["vocab_size"], maxlen=CLI_T,
                num_samples=CLI_SAMPLES), TRAIN_B)

        own_dir = os.path.join(root, "in_process")
        set_flags(save_dir=own_dir)
        trainer.train(samples(), 1, lambda e: None, feeder)
        got, want = (npz_digests(os.path.join(d, "pass-00000"))["params.npz"]
                     for d in (cli_dir, own_dir))
        if got != want:
            fail(f"the CLI's pass-00000 params.npz ({got[:16]}) is not the "
                 f"in-process Trainer.train's ({want[:16]})")
        log(f"  pass-00000 params.npz bit-identical to Trainer.train in "
            f"process (sha256 {got[:16]})")
        m["params_sha256"] = got

        log("  train --job test --init_model_path pass-00000")
        out, launches = run_cli(
            ["train", "--job", "test", "--config", config,
             "--init_model_path", os.path.join(cli_dir, "pass-00000")],
            {"lstm_fwd": 2 * n_batches}, "train --job test")
        add(launches)
        test = json.loads(out.strip().splitlines()[-1])
        own = trainer.test(samples(), feeder)
        if test["test_cost"] != own["test_cost"]:
            fail(f"--job test: test_cost {test['test_cost']!r}, "
                 f"Trainer.test {own['test_cost']!r}")
        log(f"  test_cost {test['test_cost']!r} equal to Trainer.test's")
        m["test"] = test
        del trainer

        net = NeuralNetwork(lstm_text_classifier(**CLI_CHECKGRAD_DIMS))
        n_checks = sum(min(4, p.numel())
                       for p in net.init_params(1, "cpu").values())
        want_cg = {"lstm_fwd": 2 * (1 + 2 * n_checks), "lstm_bwd": 2}
        log(f"  train --job checkgrad --config_args {CLI_CHECKGRAD_ARGS} "
            f"({n_checks} checks)")
        out, launches = run_cli(
            ["train", "--job", "checkgrad", "--config", config,
             "--config_args", CLI_CHECKGRAD_ARGS], want_cg,
            "train --job checkgrad")
        add(launches)
        cg = json.loads(out.strip().splitlines()[-1])
        if cg["failed"] != 0:
            fail(f"--job checkgrad: {cg}")
        log(f"  --job checkgrad: {cg}")
        m["checkgrad"] = cg
    finally:
        set_flags(**old)
    m["launches"] = {k: v for k, v in counts.items() if v}
    log(f"  launches: {m['launches']}")
    return m


# ------------------------------------------------ phase 4z-dense
#: phase 4z-dense (a): card against CPU on the same port code, fp32 with
#: TF32 off; another device sums in another order and has its own
#: transcendentals: every output and gradient within DENSE_RTOL and
#: DENSE_ATOL * max(1, max|CPU|)
DENSE_RTOL, DENSE_ATOL = 1e-4, 1e-5
#: (b): dropout at p 0.5 over [256, 4096]; the error clip at t
DROP_SHAPE, DROP_P, CLIP_T = (256, 4096), 0.5, 0.25
#: (c): the VAE demo (demo/vae/train.py:36-71) at its published widths
#: (x 784, hidden 128, z 100; B 32, Adam lr 1e-3), 300 batches of
#: binarised 784-vectors and N(0, 1) noise from RandomState(0); the first
#: 5 steps on the card against the port's own CPU run from the same
#: parameters: losses within rtol VAE_LOSS_RTOL, every weight within
#: VAE_W_ATOL (a fifth of one Adam step: Adam turns a rounding difference
#: in a gradient near 0 into a share of a step) and all but 1 in 10^3
#: within 2e-5
VAE_CONFIG = os.path.join("paddle_tpu_torch", "configs", "vae.py")
VAE_B, VAE_X, VAE_Z, VAE_BATCHES, VAE_CHECK = 32, 784, 100, 300, 5
VAE_LOSS_RTOL, VAE_W_ATOL = 1e-5, 2e-4


def _proj(typ, **kw):
    from paddle_tpu_torch.config.model_config import ProjConfig
    return ProjConfig(type=typ, **kw)


def _dense_cases():
    """(name, layer type, size, input sizes, feed makers, options) at
    the sizes of the JAX package's layer sweep
    (``tests/test_layer_grad_sweep.py::CASES``) and of the port's CPU
    parity cases (``tests/test_torch_dense_layers.py``,
    ``tests/test_torch_costs_ops.py``).  A feed maker takes a
    ``RandomState`` and gives numpy arrays, or (data, lengths) pairs for
    sequences."""
    def d(b, n, lo=-1.0, hi=1.0):
        return lambda r: r.uniform(lo, hi, (b, n)).astype(np.float32)

    def seq(lens, n, lo=-1.0, hi=1.0):
        def make(r):
            data = np.zeros((len(lens), max(lens), n), np.float32)
            for i, m in enumerate(lens):
                data[i, :m] = r.uniform(lo, hi, (m, n))
            return data, np.array(lens, np.int32)
        return make

    def iseq(lens, hi):
        def make(r):
            data = np.zeros((len(lens), max(lens)), np.int32)
            for i, m in enumerate(lens):
                data[i, :m] = r.randint(0, hi, m)
            return data, np.array(lens, np.int32)
        return make

    def probs(b, n):
        def make(r):
            e = np.exp(r.randn(b, n))
            return (e / e.sum(-1, keepdims=True)).astype(np.float32)
        return make

    def binary(b, n):
        return lambda r: (r.rand(b, n) > 0.5).astype(np.float32)

    def ints(vals):
        return lambda r: np.array(vals, np.int32)

    conv_op = {"type": "conv", "input_indices": (0, 1), "channels": 2,
               "img_size": 5, "img_size_y": 4, "filter_size": 3,
               "filter_size_y": 2, "num_filters": 3, "stride": 1,
               "stride_y": 2, "padding": 1, "padding_y": 0}
    cases = [
        ("fc", "fc", 5, [4], [d(3, 4)], dict(act="tanh", bias=True)),
        ("mkldnn_fc", "mkldnn_fc", 5, [4], [d(3, 4)],
         dict(act="softmax", bias=True)),
        ("addto_bias", "addto", 4, [4, 4], [d(3, 4), d(3, 4)],
         dict(act="tanh", bias=True)),
        ("concat_bias", "concat", 7, [3, 4], [d(3, 3), d(3, 4)],
         dict(act="relu", bias=True)),
        ("proj_fc", "mixed", 5, [4], [seq([3, 2], 4)],
         dict(act="sigmoid", bias=True,
              projs=[_proj("fc", input_size=4, output_size=5)])),
        ("proj_trans_fc", "mixed", 5, [4], [d(3, 4)],
         dict(projs=[_proj("trans_fc", input_size=4, output_size=5)])),
        ("proj_identity", "mixed", 4, [4], [d(3, 4)],
         dict(act="tanh",
              projs=[_proj("identity", input_size=4, output_size=4)])),
        ("proj_dot_mul", "mixed", 4, [4], [d(3, 4)],
         dict(projs=[_proj("dot_mul", input_size=4, output_size=4)])),
        ("proj_scaling", "mixed", 4, [4], [d(3, 4)],
         dict(projs=[_proj("scaling", input_size=4, output_size=4)])),
        ("proj_table", "mixed", 5, [9], [iseq([4, 2], 9)],
         dict(projs=[_proj("table", input_size=9, output_size=5)])),
        ("proj_context", "mixed", 12, [4], [seq([4, 2, 3], 4)],
         dict(projs=[_proj("context", input_size=4, context_start=-1,
                           context_length=3)])),
        ("proj_context_padding", "mixed", 16, [4], [seq([5, 1, 3], 4)],
         dict(bias=True,
              projs=[_proj("context", input_size=4, context_start=-2,
                           context_length=4, trainable_padding=True)])),
        ("proj_slices", "mixed", 3, [5], [d(3, 5)],
         dict(act="relu", projs=[_proj("slice", input_size=5,
                                       slices=[(0, 2), (3, 4)])])),
        ("operator_dot_mul", "mixed", 4, [4, 4], [d(3, 4), d(3, 4)],
         dict(act="exp", attrs={"operators": [
             {"type": "dot_mul", "scale": 0.5, "input_indices": (0, 1)}]})),
        ("operator_conv", "mixed", 30, [40, 36], [d(3, 40), d(3, 36)],
         dict(bias=True, attrs={"operators": [conv_op]})),
        ("concat2", "concat2", 7, [3, 4], [d(3, 3), d(3, 4)],
         dict(projs=[_proj("fc", input_size=3, output_size=3),
                     _proj("identity", input_size=4, output_size=4)])),
        ("interpolation", "interpolation", 4, [1, 4, 4],
         [d(3, 1, 0.1, 0.9), d(3, 4), d(3, 4)], {}),
        ("out_prod", "out_prod", 12, [3, 4], [d(2, 3), d(2, 4)], {}),
        ("power", "power", 4, [1, 4], [d(2, 1, 0.5, 2.0),
                                       d(2, 4, 0.5, 2.0)], {}),
        ("scaling", "scaling", 4, [1, 4], [d(3, 1), d(3, 4)], {}),
        ("slope_intercept", "slope_intercept", 4, [4], [d(3, 4)],
         dict(attrs={"slope": 1.5, "intercept": -0.2})),
        ("convex_comb", "convex_comb", 4, [3, 12], [d(2, 3), d(2, 12)], {}),
        ("cos", "cos", 1, [4, 4], [d(3, 4), d(3, 4)], {}),
        ("cos_vm", "cos_vm", 3, [4, 12], [d(2, 4), d(2, 12)], {}),
        ("sum_to_one_norm", "sum_to_one_norm", 4, [4], [d(3, 4, 0.2, 2.0)],
         {}),
        ("row_l2_norm", "row_l2_norm", 4, [4], [d(3, 4, 0.3, 2.0)], {}),
        ("trans", "trans", 3, [4], [d(3, 4)], {}),
        ("resize", "resize", 6, [12], [d(2, 12)], {}),
        ("clip", "clip", 4, [4], [d(3, 4)],
         dict(attrs={"min": -0.5, "max": 0.5})),
        ("multiplex", "multiplex", 4, [1, 4, 4],
         [ints([[0], [1], [0]]), d(3, 4), d(3, 4)], {}),
        ("dot_prod", "dot_prod", 1, [4, 4], [d(3, 4), d(3, 4)], {}),
        ("featmap_expand", "featmap_expand", 12, [4], [d(3, 4)],
         dict(attrs={"num_filters": 3})),
        ("conv_shift", "conv_shift", 6, [6, 3], [d(2, 6), d(2, 3)], {}),
        # costs: the sweep's feeds, a weight and coeff where taken
        ("multi-class-cross-entropy", "multi-class-cross-entropy", 1,
         [5, 1, 1], [probs(3, 5), ints([0, 2, 4]), d(3, 1, 0.2, 2.0)],
         dict(attrs={"coeff": 0.7})),
        ("ce_selfnorm", "multi_class_cross_entropy_with_selfnorm", 1,
         [5, 1], [probs(3, 5), ints([1, 0, 3])], {}),
        ("soft_binary", "soft_binary_class_cross_entropy", 1, [4, 4, 1],
         [d(3, 4, 0.2, 0.8), d(3, 4, 0.0, 1.0), d(3, 1, 0.2, 2.0)], {}),
        ("square_error_seq", "square_error", 1, [4, 4],
         [seq([3, 1, 2], 4), seq([3, 1, 2], 4)], {}),
        ("mse", "mse", 1, [4, 4], [d(3, 4), d(3, 4)],
         dict(attrs={"coeff": 2.5})),
        ("regression_cost", "regression_cost", 1, [4, 4],
         [d(3, 4), d(3, 4)], {}),
        ("rank-cost", "rank-cost", 1, [1, 1, 1],
         [d(3, 1), d(3, 1), lambda r: np.array([[1.0], [0.0], [1.0]],
                                               np.float32)],
         dict(attrs={"coeff": 0.3})),
        ("lambda_cost", "lambda_cost", 1, [1, 1],
         [seq([4, 3], 1), seq([4, 3], 1, 0.0, 3.0)],
         dict(attrs={"NDCG_num": 2})),
        ("multi_binary_ce", "multi_binary_label_cross_entropy", 1,
         [4, 4, 1], [d(3, 4, 0.2, 0.8), binary(3, 4), d(3, 1, 0.2, 2.0)],
         dict(attrs={"coeff": 0.7})),
        ("huber_regression", "huber_regression", 1, [1, 1],
         [d(3, 1, 1.0, 2.0), d(3, 1, -2.0, -1.0)],
         dict(attrs={"delta": 0.6})),
        ("huber_classification", "huber_classification", 1, [1, 1],
         [d(3, 1, 0.2, 0.6), lambda r: np.array([[1.0], [0.0], [1.0]],
                                                np.float32)], {}),
        ("smooth_l1", "smooth_l1", 1, [4, 4],
         [d(3, 4, 1.5, 2.5), d(3, 4, -0.5, 0.5)], {}),
        ("sum_cost", "sum_cost", 1, [4], [d(3, 4)], {}),
    ]
    return cases


def dense_net(ltype, size, in_sizes, act="", bias=False, attrs=None,
              projs=None):
    """A one-layer net ``test`` over data layers ``in0``, ``in1``, …"""
    from paddle_tpu_torch.config.model_config import (LayerConfig,
                                                      LayerInput,
                                                      ModelConfig)
    from paddle_tpu_torch.layers.network import NeuralNetwork
    layers = [LayerConfig(name=f"in{i}", type="data", size=s)
              for i, s in enumerate(in_sizes)]
    layers.append(LayerConfig(
        name="test", type=ltype, size=size, active_type=act, with_bias=bias,
        attrs=attrs or {},
        inputs=[LayerInput(input_layer_name=f"in{i}",
                           proj=projs[i] if projs and i < len(projs)
                           else None) for i in range(len(in_sizes))]))
    return NeuralNetwork(ModelConfig(
        layers=layers, input_layer_names=[f"in{i}" for i in
                                          range(len(in_sizes))],
        output_layer_names=["test"]))


def _dense_run(net, params, feed, where):
    """The layer's output and the gradients of its objective (the cost
    for a cost layer, else the output against a cosine ramp) in every
    parameter and float feed, computed on ``where``."""
    import torch
    from paddle_tpu_torch.core.sequence import SequenceBatch, value_of
    p = {k: v.to(where).requires_grad_(True) for k, v in params.items()}
    leaves, tfeed = dict(p), {}
    for k, v in feed.items():
        data = torch.from_numpy(v[0] if isinstance(v, tuple) else v) \
            .to(where)
        if data.is_floating_point():
            data.requires_grad_(True)
            leaves[f"feed:{k}"] = data
        tfeed[k] = SequenceBatch(data, torch.from_numpy(v[1]).to(where)) \
            if isinstance(v, tuple) else data
    if getattr(net.layers["test"], "is_cost", False):
        obj, (values, _) = net.loss(p, tfeed, is_training=False)
    else:
        values, _ = net.forward(p, tfeed, is_training=False)
        val = values["test"]
        out = value_of(val)
        if isinstance(val, SequenceBatch):
            m = val.mask(out.dtype)
            out = out * m.reshape(tuple(m.shape) + (1,) * (out.dim() - 2))
        ramp = torch.cos(0.1 * torch.arange(out.numel(), device=out.device,
                                            dtype=out.dtype))
        obj = torch.sum(out * ramp.reshape(out.shape))
    grads = torch.autograd.grad(obj, list(leaves.values()),
                                allow_unused=True)
    res = {"output": value_of(values["test"]).detach(), "objective":
           obj.detach()}
    res.update({f"grad {k}": torch.zeros_like(v) if g is None else g
                for (k, v), g in zip(leaves.items(), grads)})
    return {k: v.cpu() for k, v in res.items()}


def _dense_worst(got, want, what, limit=1.0):
    """The worst share of the card-vs-CPU tolerance over ``want``'s
    tensors; fails past ``limit``.  An infinity must stand on both sides
    with the same sign (an empty max pool's -inf); NaN always fails."""
    worst = 0.0
    for k, w in want.items():
        g = got[k].double()
        w = w.double()
        if g.shape != w.shape or not bool(
                ((g.isfinite() & w.isfinite()) | (g == w)).all()):
            fail(f"4z-dense {what}: {k} shape {tuple(g.shape)} vs "
                 f"{tuple(w.shape)}, or not finite where the CPU is, or "
                 "not its infinity")
        fin = w.isfinite()
        g, w = g[fin], w[fin]
        scale = max(1.0, float(w.abs().max()) if w.numel() else 1.0)
        tol = DENSE_ATOL * scale + DENSE_RTOL * w.abs()
        share = float(((g - w).abs() / tol).max()) if w.numel() else 0.0
        if share > limit:
            fail(f"4z-dense {what}: {k} card vs CPU off by "
                 f"{float((g - w).abs().max()):.3e} ({share:.2f} of the "
                 "tolerance)")
        worst = max(worst, share)
    return worst


def phase_dense_types(dev):
    """Phase 4z-dense (a): every newly ported layer type, projection,
    operator, cost and activation forward and backward on the card
    against the same code on the CPU."""
    import torch
    from paddle_tpu_torch.ops import activations as acts
    worst, n = {}, 0
    for name, ltype, size, in_sizes, makers, opt in _dense_cases():
        net = dense_net(ltype, size, in_sizes, **opt)
        r = np.random.RandomState(n)
        feed = {f"in{i}": mk(r) for i, mk in enumerate(makers)}
        params = {k: v + 0.01 * torch.from_numpy(
            np.random.RandomState(1).randn(*v.shape).astype(np.float32))
            for k, v in net.init_params(3, "cpu").items()}
        want = _dense_run(net, params, feed, "cpu")
        got = _dense_run(net, params, feed, dev)
        worst[name] = _dense_worst(got, want, name)
        n += 1
    for name in acts.ACTIVATIONS.names():
        r = np.random.RandomState(100 + n)
        lo = 0.3 if name in ("sqrt", "log", "reciprocal", "pow") else -8.0
        x = r.uniform(lo, 8.0, (64, 128)).astype(np.float32)
        cot = torch.from_numpy(r.randn(64, 128).astype(np.float32))
        res = {}
        for where in ("cpu", dev):
            xt = torch.from_numpy(x).to(where).requires_grad_(True)
            y = acts.get_activation(name)(xt)
            g, = torch.autograd.grad(torch.sum(y * cot.to(where)), [xt])
            res[str(where)] = {"output": y.detach().cpu(), "grad": g.cpu()}
        worst[f"act:{name}"] = _dense_worst(res[str(dev)], res["cpu"],
                                            f"activation {name}")
        n += 1
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    log(f"  (a) {n} cases (layer types, projections, operators, costs, 28 "
        f"activations) card vs CPU within rtol {DENSE_RTOL}, atol "
        f"{DENSE_ATOL} x max(1, max|CPU|); worst shares {top}")
    return {"cases": n, "worst_share": max(worst.values()),
            "worst": dict(top)}


def phase_dropout(dev):
    """Phase 4z-dense (b): dropout and the error clip on the card."""
    import torch
    from paddle_tpu_torch.layers.base import ForwardContext, _ClipError
    from paddle_tpu_torch.ops import nn_ops
    m = {}
    keep = 1.0 - DROP_P
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(DROP_SHAPE, generator=gen, device=dev) \
        .requires_grad_(True)
    out = nn_ops.dropout(x, ForwardContext(rng=torch.Generator(
        device=dev).manual_seed(11)).layer_rng("fc/drop"), DROP_P)
    g, = torch.autograd.grad(out.sum(), [x])
    if out.device != x.device:
        fail(f"dropout's output on {out.device}")
    kept = out != 0
    n = kept.numel()
    k = int(kept.sum())
    sigma = (n * keep * (1 - keep)) ** 0.5
    z = (k - n * keep) / sigma
    if abs(z) > 5:
        fail(f"dropout kept {k} of {n}: {z:.2f} sigma from the binomial")
    if not torch.equal(out[kept], (x / keep)[kept]) or \
            bool((out[~kept] != 0).any()):
        fail("dropout: kept values are not exactly x / keep")
    if not torch.equal(g, kept.float() / keep):
        fail("dropout: the gradient is not mask / keep")
    if nn_ops.dropout(x, gen, DROP_P, is_training=False) is not x:
        fail("dropout in eval is not the identity")

    def mask(seed, name="fc/drop"):
        lg = ForwardContext(rng=torch.Generator(device=dev).manual_seed(
            seed)).layer_rng(name)
        return nn_ops.dropout(torch.ones(DROP_SHAPE, device=dev), lg,
                              DROP_P) != 0

    if not torch.equal(mask(11), kept) or not torch.equal(mask(11),
                                                          mask(11)):
        fail("dropout: two runs at one seed drew different masks")
    if torch.equal(mask(11), mask(12)) or torch.equal(mask(11),
                                                      mask(11, "h/drop")):
        fail("dropout: two seeds (or two layers) drew the same mask")
    # the error clip: identity forward, the gradient clamped to ±t
    cot = 10.0 * torch.randn(DROP_SHAPE, generator=gen, device=dev)
    xc = x.detach().requires_grad_(True)
    y = _ClipError.apply(xc, CLIP_T)
    gc, = torch.autograd.grad(torch.sum(y * cot), [xc])
    if not torch.equal(y, xc) or not torch.equal(
            gc, torch.clamp(cot, -CLIP_T, CLIP_T)) or \
            float(gc.abs().max()) > CLIP_T:
        fail("the error clip's gradient is not clamp(dy, -t, t)")
    # through the trainer: an fc at drop_rate 0.5 with lr 0, so only the
    # masks move a loss; the step seeds are seed * 1000003 + samples_seen
    step_losses = [_dropout_trainer_losses(dev, seed) for seed in (0, 0, 1)]
    if step_losses[0] != step_losses[1] or \
            len(set(step_losses[0])) != len(step_losses[0]) or \
            step_losses[0] == step_losses[2]:
        fail(f"dropout through the trainer: losses {step_losses} (seeds 0, "
             "0, 1)")
    m.update(kept=k, of=n, sigma_from_binomial=z,
             trainer_losses=step_losses)
    log(f"  (b) dropout p {DROP_P} over {list(DROP_SHAPE)}: kept {k} of "
        f"{n} ({z:+.2f} sigma); kept values x / keep and gradient mask / "
        f"keep exact; eval the identity; one seed one mask, two seeds and "
        f"two layers two; through the trainer (lr 0) losses "
        f"{step_losses[0]} at seed 0 twice, {step_losses[2]} at seed 1; "
        f"the clip at t {CLIP_T}: max |dx| {float(gc.abs().max())}")
    return m


def _dropout_trainer_losses(dev, seed, steps=3):
    """``steps`` losses of x (64) → fc relu 256 at drop_rate 0.5 → fc 8
    → square_error at lr 0 on one feed, on the card."""
    import torch
    from paddle_tpu_torch.config.model_config import (LayerConfig,
                                                      LayerInput,
                                                      ModelConfig,
                                                      OptimizationConfig)
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.trainer.trainer import Trainer
    cfg = ModelConfig(layers=[
        LayerConfig(name="x", type="data", size=64),
        LayerConfig(name="t", type="data", size=8),
        LayerConfig(name="h", type="fc", size=256, active_type="relu",
                    drop_rate=0.5, inputs=[LayerInput(input_layer_name="x")]),
        LayerConfig(name="y", type="fc", size=8,
                    inputs=[LayerInput(input_layer_name="h")]),
        LayerConfig(name="cost", type="square_error", size=1,
                    inputs=[LayerInput(input_layer_name="y"),
                            LayerInput(input_layer_name="t")])],
        input_layer_names=["x", "t"], output_layer_names=["cost"])
    r = np.random.RandomState(4)
    feed = {"x": torch.from_numpy(r.randn(VAE_B, 64).astype(np.float32)),
            "t": torch.from_numpy(r.randn(VAE_B, 8).astype(np.float32))}
    tr = Trainer(NeuralNetwork(cfg), OptimizationConfig(
        learning_method="momentum", learning_rate=0.0), seed=seed,
        device=dev)
    return [float(tr.train_one_batch(feed)) for _ in range(steps)]


def _vae_feeds(n, b=VAE_B, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = (rng.rand(b, VAE_X) > 0.5).astype(np.float32)
        out.append((x, rng.randn(b, VAE_Z).astype(np.float32)))
    return out


def phase_vae(dev, card):
    """Phase 4z-dense (c): ``demo/vae/train.py``'s loop through the port
    at full width, then 16 samples from the generating topology."""
    import torch
    from paddle_tpu_torch.config.config_parser import parse_config
    from paddle_tpu_torch.core.sequence import value_of
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.trainer.trainer import Trainer
    model, opt, _ = parse_config(VAE_CONFIG, "")
    gen_model, _, _ = parse_config(VAE_CONFIG, "is_generating=1")
    feeds = _vae_feeds(VAE_BATCHES)
    m = {}
    # the first steps on the card against the CPU from the same params
    runs = {}
    for where in ("cpu", dev):
        tr = Trainer(NeuralNetwork(model), opt, seed=0, device=where)
        losses = [float(tr.train_one_batch({
            "x_batch": torch.from_numpy(x), "noise": torch.from_numpy(e)}))
            for x, e in feeds[:VAE_CHECK]]
        runs[str(where)] = (losses, {k: v.detach().cpu()
                                     for k, v in tr.params.items()})
        del tr
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(dev)]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    if loss_err > VAE_LOSS_RTOL:
        fail(f"VAE: card losses {lg} vs CPU {lc} (rtol {loss_err:.2e})")
    w_max, w_share = 0.0, 0.0
    for k, v in pc.items():
        diff = (pg[k] - v).abs()
        w_max = max(w_max, float(diff.max()))
        w_share = max(w_share, float((diff > 2e-5).float().mean()))
    if w_max > VAE_W_ATOL or w_share > 1e-3:
        fail(f"VAE: after {VAE_CHECK} steps a weight {w_max:.2e} from the "
             f"CPU's ({w_share:.2e} of a tensor past 2e-5)")
    log(f"  (c) VAE: {VAE_CHECK} steps card vs CPU: losses within rtol "
        f"{loss_err:.2e}, weights within {w_max:.2e} ({w_share:.2e} of a "
        f"tensor past 2e-5)")
    m["card_vs_cpu"] = {"loss_rtol": loss_err, "weight_max": w_max,
                        "weight_share_past_2e-5": w_share}

    # the demo's loop: 300 batches, then 16 samples
    trainer = Trainer(NeuralNetwork(model), opt, seed=0, device=dev)
    placed = [{"x_batch": torch.from_numpy(x), "noise": torch.from_numpy(e)}
              for x, e in feeds]
    torch.cuda.synchronize()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses = [float(trainer.train_one_batch(f)) for f in placed]
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts().items() if v}
    if launches:
        fail(f"VAE: the dense path launched kernels {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"VAE: the loss did not fall ({losses[0]} -> {losses[-1]})")
    net = trainer.network
    values, _ = net.forward(trainer.params, {
        k: v.to(dev) for k, v in placed[-1].items()}, is_training=False)
    count, slots = trainer.opt_state
    tensors = [*trainer.params.values(), count,
               *(s for ss in slots.values() for s in ss
                 if isinstance(s, torch.Tensor)),
               *(value_of(v) for v in values.values())]
    off = [t.device for t in tensors if t.device.type != "cuda"]
    if off:
        fail(f"VAE: {len(off)} parameters, moments or values off the card")
    gen_net = NeuralNetwork(gen_model)
    gen_params = {n: trainer.params[n] for n in gen_net.param_specs}
    z = torch.from_numpy(np.random.RandomState(1).randn(
        16, VAE_Z).astype(np.float32)).to(dev)
    with torch.no_grad():
        gv, _ = gen_net.forward(gen_params, {"noise": z}, is_training=False)
    samples = value_of(gv[gen_net.output_names[0]])
    if tuple(samples.shape) != (16, VAE_X) or samples.device.type != \
            "cuda" or not bool(samples.isfinite().all()) or \
            float(samples.min()) < 0 or float(samples.max()) > 1:
        fail(f"VAE: samples {tuple(samples.shape)} on {samples.device}, "
             f"range [{float(samples.min())}, {float(samples.max())}]")
    ms = wall * 1e3 / VAE_BATCHES
    dev_ms = start.elapsed_time(end) / VAE_BATCHES
    m.update(loss_first=losses[0], loss_last=losses[-1],
             ms_per_batch=ms, device_ms_per_batch=dev_ms, pass_wall_s=wall,
             samples_per_s=VAE_B / ms * 1e3, batches=VAE_BATCHES,
             sample_mean=float(samples.mean()), tensors_on_card=len(tensors),
             launches=launches, card=card)
    log(f"  (c) VAE {VAE_BATCHES} batches of {VAE_B} (x {VAE_X}, z "
        f"{VAE_Z}): loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
        f"{ms:.3f} ms/batch (host clock, float(loss) each batch as the "
        f"demo), {dev_ms:.3f} between CUDA events, pass wall {wall:.3f} s, "
        f"{m['samples_per_s']:.1f} samples/s; {len(tensors)} tensors on "
        f"the card; 16 samples in [{float(samples.min()):.4f}, "
        f"{float(samples.max()):.4f}], mean {m['sample_mean']:.4f}; no "
        f"kernel launched; {card}")
    return m


def phase_dense(dev, card):
    """Phase 4z-dense: (a) the new types card vs CPU, (b) dropout and the
    error clip, (c) the VAE demo's loop at full width."""
    import torch
    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")
    m = {"types": phase_dense_types(dev), "dropout": phase_dropout(dev),
         "vae": phase_vae(dev, card)}
    m["seconds"] = time.perf_counter() - t0
    log(f"  4z-dense took {m['seconds']:.1f} s")
    return m


# ------------------------------------------------ phase 4z-gen
#: phase 4z-gen (a): card against CPU on the same port code (fp32, TF32
#: off) for the sequence layers, nested batches, the sampled layers and
#: their ops: every float output and gradient within DENSE_RTOL and
#: DENSE_ATOL * max(1, max|CPU|), every id exact; sampling_id's
#: frequencies over 2^16 draws a row within 5 sigma of p
GEN_DRAWS = 2 ** 16
#: (b): the seqToseq demo's reversal task at its widths
#: (demo/seqToseq/train.py:32-34, :97-127): V 32, E 16, H 48, sources of
#: 6 ids in [2, 32), B 16, 600 Adam steps at lr 0.01, clip 5, trainer
#: seed 1, batches from RandomState(0); then beam 4, max length 8 on 4
#: new sources: at least 3 exact reversals (:151)
DEMO = dict(V=32, E=16, H=48, S=6, B=16, STEPS=600, BEAM=4)
DEMO_OPT = dict(learning_method="adam", learning_rate=0.01,
                gradient_clipping_threshold=5.0)
#: (c): the seq2seq row's model translating: B 128 sources from
#: RandomState(0), ids in [2, 30000), lengths in [10, 30]; beam 3, max
#: length 250 (the generator's defaults); rows 0-7 at max length 30 card
#: against CPU: ids and lengths equal, scores within GEN_SCORE_RTOL (fp32
#: sums of 30 log-probabilities in other orders, the encoder through
#: kernel 13's split products), a divergence accepted only at a step
#: where the CPU's K-th and (K+1)-th candidate scores lie within
#: GEN_TIE_GAP
GEN_B, GEN_LEN, GEN_CHECK_ROWS, GEN_CHECK_LEN = 128, (10, 30), 8, 30
GEN_SCORE_RTOL, GEN_TIE_GAP = 1e-4, 1e-4


def _gen_run(fn, arrays, where, ints=()):
    """``fn`` of tensors on ``where`` (numpy ``arrays``; float ones
    require grad unless named in ``ints``) → its output and, for a float
    output with a gradient, the gradients of its finite values against a
    cosine ramp, every tensor on the CPU."""
    import torch
    ts = {k: torch.from_numpy(np.array(v)).to(where)
          for k, v in arrays.items()}
    leaves = {k: t.requires_grad_(True) for k, t in ts.items()
              if t.is_floating_point() and k not in ints}
    out = fn(**ts)
    res = {"output": out.detach()}
    if out.is_floating_point() and leaves and out.requires_grad:
        ramp = torch.cos(0.1 * torch.arange(out.numel(), device=out.device,
                                            dtype=out.dtype))
        obj = torch.sum(torch.where(out.isfinite(), out, 0.0)
                        * ramp.reshape(out.shape))
        grads = torch.autograd.grad(obj, list(leaves.values()),
                                    allow_unused=True)
        res.update({f"grad {k}": torch.zeros_like(v) if g is None else g
                    for (k, v), g in zip(leaves.items(), grads)})
    return {k: v.cpu() for k, v in res.items()}


def _gen_layer(ltype, size, in_sizes, act="", bias=False, attrs=None):
    """(net, params on the CPU) of a one-layer net, params nudged off
    their init as the CPU tests do."""
    import torch
    net = dense_net(ltype, size, in_sizes, act=act, bias=bias, attrs=attrs)
    params = {k: v + 0.01 * torch.from_numpy(np.random.RandomState(1).randn(
        *v.shape).astype(np.float32))
        for k, v in net.init_params(3, "cpu").items()}
    return net, params


def _layer_fn(net, seqs=(), nested=(), key="test"):
    """A function of (params as ``p:name``, feeds ``in*``; a sequence as
    ``in*`` + ``in*_len``, a nested one as ``in*``, ``in*_n``,
    ``in*_sub``) → the value ``key`` of the net, masked where it is a
    sequence."""
    import torch
    from paddle_tpu_torch.core.sequence import (NestedSequenceBatch,
                                                SequenceBatch, value_of)

    def fn(**t):
        params = {k[2:]: v for k, v in t.items() if k.startswith("p:")}
        feed = {}
        for k, v in t.items():
            if k.startswith("p:") or "_" in k:
                continue
            if k in seqs:
                feed[k] = SequenceBatch(v, t[k + "_len"])
            elif k in nested:
                feed[k] = NestedSequenceBatch(v, t[k + "_n"], t[k + "_sub"])
            else:
                feed[k] = v
        val = net.forward(params, feed, is_training=False)[0][key]
        out = value_of(val)
        if isinstance(val, SequenceBatch):
            m = val.bool_mask()
            m = m.reshape(tuple(m.shape) + (1,) * (out.dim() - 2))
            out = torch.where(m, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))
        return out
    return fn


def _layer_case(name, ltype, size, in_sizes, feeds, seqs=(), ints=(),
                nested=(), key="test", **kw):
    """(name, fn, arrays, ints) of a one-layer net's case: its params
    (nudged off their init) and ``feeds`` as the arrays, every array
    named with a ``_`` (lengths) or in ``ints`` left without a
    gradient."""
    net, p = _gen_layer(ltype, size, in_sizes, **kw)
    arrays = {f"p:{k}": v.numpy() for k, v in p.items()}
    for f in feeds:
        arrays.update(f)
    return (name, _layer_fn(net, seqs, nested, key), arrays,
            tuple(ints) + tuple(k for k in arrays if "_" in k
                                and not k.startswith("p:")))


def _gen_cases():
    """(name, fn, arrays, ints) of phase 4z-gen (a) at the sizes of the
    JAX package's layer sweep and of the CPU parity tests."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.ops import embedding_ops as E
    from paddle_tpu_torch.ops import sequence_ops as S
    r = np.random.RandomState(0)

    def seq(lens, n, name="in0"):
        data = np.zeros((len(lens), max(max(lens), 1), n), np.float32)
        for i, m in enumerate(lens):
            data[i, :m] = r.uniform(-1, 1, (m, n))
        return {name: data, name + "_len": np.array(lens, np.int32)}

    def d(b, n, name="in0"):
        return {name: r.uniform(-1, 1, (b, n)).astype(np.float32)}

    cases = []

    def layer(*args, **kw):
        cases.append(_layer_case(*args, **kw))

    # layers of seq.py at the sweep's sizes
    for ltype, attrs in (("max", {}), ("seqfirstins", {}),
                         ("average", {"average_strategy": "squarerootn"})):
        layer(ltype + str(attrs), ltype, 4, [4], [seq([3, 2, 0], 4)],
              seqs=("in0",), act="tanh", attrs=attrs)
    for ltype, attrs in (("average", {}),
                         ("average", {"average_strategy": "sum"}),
                         ("average", {"average_strategy": "squarerootn"}),
                         ("max", {}), ("seqlastins", {}),
                         ("seqfirstins", {})):
        layer(f"strided {ltype}{attrs}", ltype, 4, [4],
              [seq([5, 3, 7, 1], 4)], seqs=("in0",), act="tanh",
              attrs=dict(attrs, stride=3))
        nd = r.uniform(-1, 1, (3, 3, 4, 4)).astype(np.float32)
        layer(f"nested {ltype}{attrs}", ltype, 4, [4],
              [{"in0": nd, "in0_n": np.array([3, 1, 2], np.int32),
                "in0_sub": np.array([[2, 4, 1], [3, 0, 0], [1, 2, 0]],
                                    np.int32)}],
              nested=("in0",), act="tanh", attrs=attrs)
    layer("seqconcat", "seqconcat", 4, [4, 4],
          [seq([3, 2, 0], 4), seq([2, 2, 3], 4, "in1")], seqs=("in0", "in1"))
    layer("seqreshape", "seqreshape", 8, [4], [seq([4, 2], 4)],
          seqs=("in0",))
    for ltype in ("seq_slice", "subseq"):
        layer(ltype, ltype, 4, [4, 1, 1],
              [seq([4, 3, 5], 4), {"in1": np.array([[1], [0], [2]],
                                                   np.int32),
                                   "in2": np.array([[2], [2], [3]],
                                                   np.int32)}],
              seqs=("in0",))
    layer("row_conv", "row_conv", 4, [4], [seq([4, 2, 0], 4)],
          seqs=("in0",), attrs={"context_length": 3})
    for ltype in ("get_output", "gather_agent", "scatter_agent", "print"):
        layer(ltype, ltype, 4, [4], [d(2, 4)])
    sc = seq([4, 3, 0], 1)
    sc["in0"][0, :, 0] = [0.5, 0.9, 0.9, 0.1]       # a planted tie
    layer("kmax_seq_score", "kmax_seq_score", 2, [1], [sc], seqs=("in0",),
          attrs={"beam_size": 2})
    for k in (1, 3):
        x = r.randint(0, 3, (5, 7)).astype(np.float32)    # ties
        layer(f"maxid beam {k}", "maxid", 1, [7], [{"in0": x}],
              attrs={"beam_size": k})
    layer("eos_id", "eos_id", 1, [1],
          [{"in0": np.array([[2], [1], [2]], np.int32)}],
          attrs={"eos_id": 2})
    layer("sub_nested_seq", "sub_nested_seq", 3, [3, 2],
          [{"in0": r.randn(2, 3, 4, 3).astype(np.float32),
            "in0_n": np.array([3, 2], np.int32),
            "in0_sub": np.array([[4, 3, 2], [2, 4, 0]], np.int32),
            "in1": np.array([[1, 0], [0, -1]], np.int32)}],
          nested=("in0",))
    # the sampled and parameter-owning types of common.py
    layer("tensor", "tensor", 3, [3, 4], [d(2, 3), d(2, 4, "in1")],
          bias=True, act="tanh")
    layer("selective_fc", "selective_fc", 6, [4], [d(3, 4)], bias=True)
    layer("selective_fc ids", "selective_fc", 6, [4, 2],
          [d(3, 4), {"in1": np.array([[0, 5], [2, 2], [4, 1]], np.int32)}],
          bias=True, act="softmax")
    layer("prelu", "prelu", 6, [6], [d(4, 6)], attrs={"partial_sum": 2})
    layer("scale_shift", "scale_shift", 4, [4], [d(3, 4)], bias=True)
    for strategy, attrs in (("z-score", {"mean": 0.5, "std": 2.0}),
                            ("min-max", {"min": -1.0, "max": 3.0}),
                            ("decimal-scaling", {"a": 10.0})):
        layer(f"data_norm {strategy}", "data_norm", 4, [4], [d(3, 4)],
              attrs=dict(attrs, data_norm_strategy=strategy))
    for n in (8, 13):
        layer(f"hsigmoid {n}", "hsigmoid", 1, [4, 1],
              [d(n, 4), {"in1": np.arange(n, dtype=np.int32)}],
              bias=True, attrs={"num_classes": n})
    # the ops: the ten sequence ops, the six pool types, the three
    # embedding ops
    a = seq([5, 0, 3, 7], 3, "a")
    b2 = seq([2, 3, 0, 1], 3, "b")
    sb = {"a": a["a"], "a_len": a["a_len"], "b": b2["b"],
          "b_len": b2["b_len"]}

    def sq(t, n):
        return SequenceBatch(t[n], t[n + "_len"])
    for pool in ("average", "sum", "sqrt", "max", "last", "first"):
        cases.append((f"sequence_pool {pool}",
                      lambda pool=pool, **t: S.sequence_pool(sq(t, "a"),
                                                             pool),
                      sb, ("a_len", "b_len")))
    ops = {
        "sequence_concat": lambda **t: S.sequence_concat(
            sq(t, "a"), sq(t, "b")).data,
        "sequence_slice": lambda **t: S.sequence_slice(
            sq(t, "a"), t["off"], t["size"]).data,
        "sub_seq": lambda **t: S.sub_seq(sq(t, "a"), t["off"],
                                         t["size"]).data,
        "sequence_reshape": lambda **t: S.sequence_reshape(
            sq(t, "b"), 1).data,
        "sequence_conv": lambda **t: S.sequence_conv(
            sq(t, "a"), t["w"], -1, 3).data,
        "row_conv (op)": lambda **t: S.row_conv(sq(t, "a"), t["wr"]).data,
        "sequence_last_instance": lambda **t: S.sequence_last_instance(
            sq(t, "a")),
        "sequence_first_instance": lambda **t: S.sequence_first_instance(
            sq(t, "a")),
        "kmax_seq_score (op)": lambda **t: S.kmax_seq_score(
            sq(t, "a"), 2),
        "max_id (op)": lambda **t: S.max_id(t["x"], 4),
    }
    extra = {"off": np.array([1, 0, 2, 3], np.int32),
             "size": np.array([3, 1, 4, 2], np.int32),
             "w": r.randn(9, 5).astype(np.float32),
             "wr": r.randn(3, 3).astype(np.float32),
             "x": r.randint(0, 4, (6, 9)).astype(np.float32)}
    for name, fn in ops.items():
        cases.append((name, fn, dict(sb, **extra),
                      ("a_len", "b_len", "off", "size", "x")))
    emb = {"x": r.uniform(-1, 1, (6, 5)).astype(np.float32),
           "labels": np.array([0, 4, 9, 3, 12, 7], np.int32),
           "w": r.randn(12, 5).astype(np.float32) * 0.3,
           "bias": r.randn(12).astype(np.float32) * 0.1,
           "wf": r.randn(5, 13).astype(np.float32) * 0.3,
           "bf": r.randn(13).astype(np.float32) * 0.1,
           "sel": r.randint(0, 13, (6, 4)).astype(np.int32)}
    cases.append(("hierarchical_sigmoid", lambda **t: E.hierarchical_sigmoid(
        t["x"], t["labels"], t["w"], t["bias"], 13), emb, ("labels", "sel")))
    cases.append(("selective_fc (op)", lambda **t: E.selective_fc(
        t["x"], t["wf"], t["bf"], t["sel"], act="softmax"), emb,
        ("labels", "sel")))
    return cases


def phase_gen_types(dev):
    """Phase 4z-gen (a): every new layer type, op and pool type forward
    and backward on the card against the same code on the CPU; nce and
    sampling_id given the card's draws."""
    import torch
    from paddle_tpu_torch.layers.base import ForwardContext
    from paddle_tpu_torch.ops import embedding_ops as E
    worst, n = {}, 0
    for name, fn, arrays, ints in _gen_cases():
        want = _gen_run(fn, arrays, "cpu", ints)
        got = _gen_run(fn, arrays, dev, ints)
        if not want["output"].is_floating_point():
            if not torch.equal(got["output"], want["output"]):
                fail(f"4z-gen {name}: card ids {got['output'].tolist()} vs "
                     f"CPU {want['output'].tolist()}")
            worst[name] = 0.0
        else:
            worst[name] = _dense_worst(got, want, name)
        n += 1
    # nce: the layer on the card, its negatives re-drawn from the same
    # card generator, the op on the CPU given them
    r = np.random.RandomState(7)
    net, p = _gen_layer("nce", 1, [4, 1], bias=True,
                        attrs={"num_classes": 7, "num_neg_samples": 3})
    x = r.uniform(-1, 1, (3, 4)).astype(np.float32)
    labels = np.array([1, 3, 6], np.int32)
    got = _gen_run(_layer_fn(net), {"in0": x, "in1": labels, **{
        f"p:{k}": v.numpy() for k, v in p.items()}}, dev, ("in1",))
    ids = torch.randint(0, 7, (3, 3), generator=ForwardContext().layer_rng(
        "test", dev), device=dev).cpu()
    want = _gen_run(lambda **t: E.nce_loss(
        t["x"], t["labels"], t["w"], t["b"], ids,
        torch.full((3, 3), 1 / 7.0)).reshape(-1, 1),
        {"x": x, "labels": labels, "w": p["_test.w0"].numpy(),
         "b": p["_test.wbias"].numpy()}, "cpu", ("labels",))
    want = {"output": want["output"], "grad in0": want["grad x"],
            "grad p:_test.w0": want["grad w"],
            "grad p:_test.wbias": want["grad b"]}
    worst["nce"] = _dense_worst(got, want, "nce")
    n += 1
    # sampling_id: one-hot rows exact through the layer; the card's ids
    # equal the CPU's Gumbel-max on the card's uniforms; frequencies
    net, _ = _gen_layer("sampling_id", 1, [5])
    onehot = np.eye(5, dtype=np.float32)[[3, 0, 4, 1, 1, 2]]
    ids = net.forward({}, {"in0": torch.from_numpy(onehot).to(dev)},
                      is_training=False)[0]["test"].cpu()
    if ids.tolist() != [3, 0, 4, 1, 1, 2]:
        fail(f"4z-gen sampling_id on one-hot rows: {ids.tolist()}")
    p = torch.tensor([0.05, 0.4, 0.0, 0.25, 0.3])
    probs = p.to(dev).repeat(GEN_DRAWS, 1)
    draws = E.sampling_id(torch.Generator(device=dev).manual_seed(5), probs)
    u = torch.rand(probs.shape, generator=torch.Generator(
        device=dev).manual_seed(5), device=dev).cpu()
    perturbed = torch.log(torch.clamp(p, 1e-20, 1.0)) - torch.log(
        -torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    top2 = torch.topk(perturbed, 2, -1)[0]
    # rows whose two best perturbed logits lie within 1e-5 may round the
    # other way on the other device
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5
    same = float((draws.cpu().long() == torch.argmax(perturbed, -1))[
        clear].double().mean())
    freq = np.bincount(draws.cpu().numpy(), minlength=5) / GEN_DRAWS
    sig = np.sqrt(p.numpy() * (1 - p.numpy()) / GEN_DRAWS)
    z = np.abs(freq - p.numpy()) / np.maximum(sig, 1e-12)
    if same < 1.0 or freq[2] != 0 or (z[sig > 0] > 5).any():
        fail(f"4z-gen sampling_id: {same:.6f} of the card's ids equal the "
             f"CPU's on its draws; frequencies {freq.tolist()} vs "
             f"{p.tolist()} ({z.max():.2f} sigma)")
    n += 1
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    log(f"  (a) {n} cases (15 seq.py types, strided and nested pools, the "
        f"ten sequence ops, six pool types, the eight types of common.py, "
        f"hierarchical_sigmoid, nce_loss, selective_fc, sampling_id) card "
        f"vs CPU within rtol {DENSE_RTOL}, atol {DENSE_ATOL} x max(1, "
        f"max|CPU|), ids exact; worst shares {top}; sampling_id over "
        f"{GEN_DRAWS} draws: the CPU's ids on the card's uniforms "
        f"(but {int((~clear).sum())} rows within 1e-5), "
        f"{z[sig > 0].max():.2f} sigma at worst")
    return {"cases": n, "worst_share": max(worst.values()),
            "worst": dict(top), "sampling_sigma": float(z[sig > 0].max())}


def _demo_feed(rng, dev, b=DEMO["B"]):
    """One batch of the demo's reversal task (demo/seqToseq/train.py:
    97-111) with the seq2seq row's feed names."""
    import torch
    from paddle_tpu_torch.core.sequence import SequenceBatch
    s = DEMO["S"]
    src = rng.randint(2, DEMO["V"], (b, s)).astype(np.int32)
    trg = src[:, ::-1]
    tin = np.concatenate([np.zeros((b, 1), np.int32), trg], 1)
    tlb = np.concatenate([trg, np.ones((b, 1), np.int32)], 1)

    def sq(x):
        return SequenceBatch(torch.from_numpy(np.ascontiguousarray(x)),
                             torch.full((b,), x.shape[1],
                                        dtype=torch.int32)).to(dev)
    return {"source": sq(src), "target": sq(tin), "target_next": sq(tlb)}


def _generate(net, params, feed, rows=None):
    """``net.forward`` of a generator under no_grad → (ids, scores,
    lengths) on the CPU."""
    import torch
    with torch.no_grad():
        values, _ = net.forward(params, feed, is_training=False)
    name = net.output_names[0]
    return tuple(values[name + s].cpu()
                 for s in ("", ".scores", ".lengths"))


def phase_gen_demo(dev):
    """Phase 4z-gen (b): the demo's reversal task trained on the card,
    then beam 4 on 4 new sources: at least 3 exact reversals, and the
    CPU's generation from the card's weights equal."""
    import torch
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import (seq2seq_config,
                                         seq2seq_generator_config)
    from paddle_tpu_torch.trainer.trainer import Trainer
    V, E_, H, S = DEMO["V"], DEMO["E"], DEMO["H"], DEMO["S"]
    rng = np.random.RandomState(0)
    trainer = Trainer(NeuralNetwork(seq2seq_config(V, E_, H)),
                      opt_config=OptimizationConfig(**DEMO_OPT), seed=1,
                      device=dev)
    t0 = time.perf_counter()
    losses = [float(trainer.train_one_batch(_demo_feed(rng, dev)))
              for _ in range(DEMO["STEPS"])]
    train_s = time.perf_counter() - t0
    gnet = NeuralNetwork(seq2seq_generator_config(
        V, E_, H, beam_size=DEMO["BEAM"], max_length=S + 2))
    missing = set(gnet.param_specs) - set(trainer.params)
    if missing:
        fail(f"4z-gen (b): generator parameters {sorted(missing)} are not "
             "the training net's")
    shared = {k: trainer.params[k].detach() for k in gnet.param_specs}
    src = rng.randint(2, V, (4, S)).astype(np.int32)
    feed = SequenceBatch(torch.from_numpy(src),
                         torch.full((4,), S, dtype=torch.int32))
    ids, scores, lengths = _generate(gnet, shared, {"source": feed.to(dev)})
    cids, cscores, clengths = _generate(
        gnet, {k: v.cpu() for k, v in shared.items()}, {"source": feed})
    correct = sum(ids[b, 0, :int(lengths[b, 0])].tolist()
                  == list(src[b, ::-1]) + [1] for b in range(4))
    rel = float(((scores - cscores).abs() / cscores.abs().clamp(
        min=1e-6)).max())
    log(f"  (b) demo reversal: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"over {DEMO['STEPS']} steps ({train_s:.1f} s, "
        f"{train_s / DEMO['STEPS'] * 1e3:.2f} ms/step); beam "
        f"{DEMO['BEAM']}: {correct}/4 exact reversals; CPU from the card's "
        f"weights: ids equal {torch.equal(ids, cids)}, lengths equal "
        f"{torch.equal(lengths, clengths)}, scores within rtol {rel:.2e}")
    if correct < 3:
        fail(f"4z-gen (b): {correct}/4 exact reversals (the demo needs 3)")
    if not (torch.equal(ids, cids) and torch.equal(lengths, clengths)
            and rel <= GEN_SCORE_RTOL):
        fail("4z-gen (b): the CPU's generation from the card's weights "
             f"differs (scores rtol {rel:.2e})")
    return {"loss_first": losses[0], "loss_last": losses[-1],
            "train_s": train_s, "correct": correct, "score_rtol": rel}


def _gen_source(dev=None):
    """The full-width feed of (c): B 128 sources from RandomState(0),
    ids in [2, 30000), lengths in [10, 30]."""
    import torch
    from paddle_tpu_torch.core.sequence import SequenceBatch
    rng = np.random.RandomState(0)
    lo, hi = GEN_LEN
    ids = rng.randint(2, S2S["V"], (GEN_B, hi)).astype(np.int32)
    lengths = rng.randint(lo, hi + 1, GEN_B).astype(np.int32)
    feed = SequenceBatch(torch.from_numpy(ids), torch.from_numpy(lengths))
    return feed if dev is None else feed.to(dev)


class _TopKTrace:
    """Records, at every beam step, the K+1 best candidate scores and the
    K chosen flat indices of each row (wraps the decoder's ``top_k``)."""

    def __init__(self):
        self.steps = []

    def __enter__(self):
        from paddle_tpu_torch.layers import beam_search
        from paddle_tpu_torch.ops.math_ops import top_k
        self._mod, self._orig = beam_search, beam_search.top_k

        def traced(x, k):
            vals, idx = top_k(x, k + 1)
            self.steps.append((vals.cpu(), idx[:, :k].cpu()))
            return vals[:, :k], idx[:, :k]
        beam_search.top_k = traced
        return self

    def __exit__(self, *exc):
        self._mod.top_k = self._orig


def phase_gen_full(dev, card):
    """Phase 4z-gen (c): the seq2seq row's model translating on the card
    through ``NeuralNetwork.forward`` of ``seq2seq_generator_config()``."""
    import torch
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import (seq2seq_config,
                                         seq2seq_generator_config)
    from paddle_tpu_torch.ops import gru as G
    V, E_, H = S2S["V"], S2S["E"], S2S["H"]
    params = NeuralNetwork(seq2seq_config(V, E_, H)).init_params(
        seed=0, device=dev)
    net = NeuralNetwork(seq2seq_generator_config(V, E_, H))
    gen = net.decoders[net.config.sub_models[-1].name]
    k, max_len = int(gen.gen["beam_size"]), int(gen.gen["max_length"])
    shared = {n: params[n] for n in net.param_specs}
    del params
    feed = _gen_source()

    # rows 0-7 at max length 30: card against CPU, with each step's K-th
    # and (K+1)-th candidate scores traced
    short = NeuralNetwork(seq2seq_generator_config(
        V, E_, H, max_length=GEN_CHECK_LEN))
    rows = GEN_CHECK_ROWS
    sub = type(feed)(feed.data[:rows], feed.length[:rows])
    with _TopKTrace() as card_trace:
        on_card = _generate(short, shared, {"source": sub.to(dev)})
    cpu_params = {n: v.cpu() for n, v in shared.items()}
    t0 = time.perf_counter()
    with _TopKTrace() as cpu_trace:
        cpu = _generate(short, cpu_params, {"source": sub})
    cpu_s = time.perf_counter() - t0
    del cpu_params
    diverged, worst_rel = [], 0.0
    for b in range(rows):
        first = next((t for t, (c, g) in enumerate(
            zip(cpu_trace.steps, card_trace.steps))
            if not torch.equal(c[1][b], g[1][b])), None)
        if first is not None:
            vals = cpu_trace.steps[first][0][b]
            gap = float(vals[k - 1] - vals[k])
            log(f"  (c) row {b} diverges at step {first}: the CPU's K-th "
                f"and (K+1)-th candidate scores {float(vals[k - 1]):.6f}, "
                f"{float(vals[k]):.6f} (gap {gap:.2e})")
            if gap > GEN_TIE_GAP:
                fail(f"4z-gen (c): row {b} diverges at step {first} with a "
                     f"gap of {gap:.2e} > {GEN_TIE_GAP}")
            diverged.append((b, first, gap))
            continue
        if not (torch.equal(on_card[0][b], cpu[0][b])
                and torch.equal(on_card[2][b], cpu[2][b])):
            fail(f"4z-gen (c): row {b}: ids or lengths differ card vs CPU")
        rel = float(((on_card[1][b] - cpu[1][b]).abs()
                     / cpu[1][b].abs().clamp(min=1e-6)).max())
        if rel > GEN_SCORE_RTOL:
            fail(f"4z-gen (c): row {b}: scores off by rtol {rel:.2e}")
        worst_rel = max(worst_rel, rel)
    log(f"  (c) rows 0-{rows - 1} at max length {GEN_CHECK_LEN}: card vs "
        f"CPU ids and lengths equal, scores within rtol {worst_rel:.2e} "
        f"(limit {GEN_SCORE_RTOL}); {len(diverged)} rows diverged at a "
        f"tie; the CPU run {cpu_s:.1f} s")

    # the full call: every memory and step value on the card
    seen = {"steps": 0, "off": 0}
    step = gen.group.step

    def checked_step(params, frame, mems, outer, ctx, order=None):
        new, values = step(params, frame, mems, outer, ctx, order)
        seen["steps"] += 1
        for v in [*mems, *new, *values.values()]:
            data = getattr(v, "data", v)
            if isinstance(data, torch.Tensor) and data.device.type != "cuda":
                seen["off"] += 1
        return new, values
    gen.group.step = checked_step
    src = feed.to(dev)
    try:
        _generate(net, shared, {"source": src})          # warm
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        seen.update(steps=0, off=0)
        reset_counts()
        t0 = time.perf_counter()
        start.record()
        ids, scores, lengths = _generate(net, shared, {"source": src})
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        gen.group.step = step
    device_ms = start.elapsed_time(end)
    if any(v.device.type != "cuda" for v in shared.values()) \
            or seen["off"] or seen["steps"] != max_len:
        fail(f"4z-gen (c): {seen['off']} step values off the card over "
             f"{seen['steps']} steps")
    if launches["gru_fwd"] != 2 or any(
            launches[n] for n in launches if n != "gru_fwd"):
        fail(f"4z-gen (c): launches {launches}; want 2 of gru_fwd (the "
             "encoder's two grumemory layers) and no other")
    if tuple(ids.shape) != (GEN_B, k, max_len) or int(ids.min()) < 0 \
            or int(ids.max()) >= V or int(lengths.min()) < 1 \
            or int(lengths.max()) > max_len \
            or not bool((scores[:, 1:] <= scores[:, :-1]).all()) \
            or not bool(scores[:, 0].isfinite().all()):
        fail(f"4z-gen (c): ids {tuple(ids.shape)} in [{int(ids.min())}, "
             f"{int(ids.max())}], lengths in [{int(lengths.min())}, "
             f"{int(lengths.max())}], scores not descending or not finite")
    busy = _profile_generate(net, shared, src, max_len)
    best = int(lengths[:, 0].sum())
    m = {"ms_per_step": wall * 1e3 / max_len, "wall_s": wall,
         "busy_share": busy,
         "device_ms": device_ms,
         "tokens_per_s": GEN_B * k * max_len / wall,
         "best_tokens_per_s": best / wall,
         "launches": launches, "diverged": diverged,
         "score_rtol": worst_rel, "cpu_rows_s": cpu_s,
         "best_lengths_mean": best / GEN_B}
    log(f"  (c) translation B {GEN_B}, beam {k}, max length {max_len}: "
        f"{m['ms_per_step']:.3f} ms per decode step, call wall "
        f"{wall:.3f} s (device {device_ms:.1f} ms between events), "
        f"{m['tokens_per_s']:.1f} generated tokens/s over every beam "
        f"({m['best_tokens_per_s']:.1f} in the best beams, mean length "
        f"{m['best_lengths_mean']:.1f}); gru_fwd launched "
        f"{launches['gru_fwd']} times; card: {card}")
    return m


def _profile_generate(net, params, src, steps):
    """One translation call under torch.profiler: the device's busy
    share, its device items a decode step and the 8 largest by device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _generate(net, params, {"source": src})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(device_rows(prof), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    log(f"  (c) profiled call: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / (wall * 1e6):.1f} %), "
        f"{sum(r[2] for r in rows) / steps:.0f} device items a decode step")
    for key, us, n in rows[:8]:
        log(f"    {us / 1e3:9.3f} ms ({us / steps:8.2f} us a step)  {n:6d} x"
            f"  {key[:90]}")
    return busy_us / (wall * 1e6)


def phase_gen(dev, card):
    """Phase 4z-gen: (a) the new types card vs CPU, (b) the demo's
    reversal task trained and decoded on the card, (c) the seq2seq row's
    model translating at full width."""
    import torch
    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")
    m = {"types": phase_gen_types(dev), "demo": phase_gen_demo(dev),
         "translate": phase_gen_full(dev, card)}
    m["seconds"] = time.perf_counter() - t0
    log(f"  4z-gen took {m['seconds']:.1f} s")
    return m


# ------------------------------------------------ phase 4z-tag
#: phase 4z-tag (a): card against CPU on the same port code (fp32, TF32
#: off) for the recurrent types and ops, the sequence costs and nested
#: groups, as 4z-gen (a): every float output and gradient within
#: DENSE_RTOL and DENSE_ATOL * max(1, max|CPU|), decoded paths exact;
#: kernels 8 and 9 against the plain scan on a nested step's batches
#: (rows of length 0, and rows of length 0 only) within 3b's tolerances
TAGGING_CONFIG = os.path.join("paddle_tpu_torch", "configs", "tagging.py")
#: (b): the sequence-tagging demo at its widths
#: (demo/sequence_tagging/train.py): V 50, 5 tags, E 16, H 32, T 12,
#: B 16, 250 Adam steps at lr 0.02 (the config's), trainer seed 3,
#: batches from RandomState(0), then Viterbi over 32 new rows: tagging
#: accuracy above 0.9 (the demo's exit gate)
TAG_DEMO = dict(V=50, N=5, T=12, B=16, STEPS=250, EVAL_B=32, ACC=0.9)
#: (c): the same config at the seq2seq row's encoder width
#: (bench.py:455-545): B 128, V 30000, E 512, H 512, lengths 10-30 and
#: ids from RandomState(0), 23 tags, fp32; the first step card vs CPU
#: (loss within S2S_RTOL, every gradient within S2S_RTOL * max|ref| +
#: 1e-8), then STEPS timed steps after WARM, then one Viterbi decode
TAG_FULL = dict(V=30000, N=23, E=512, H=512, B=128, LEN=(10, 30), WARM=3,
                STEPS=50)
#: (d): a nested group at the LSTM row's width (the shape of the
#: reference's sequence_nest_rnn.conf): B 64 paragraphs of 2-8
#: sentences of 5-25 ids in [0, 30000) from RandomState(0) through
#: DataFeeder; emb 512 -> a group over the sentences (fc 4H ->
#: lstmemory H 512 -> last_seq, a memory summing the sentence states) ->
#: last_seq -> fc softmax over 2 classes -> CE; Adam lr 1e-3
NEST = dict(V=30000, E=512, H=512, B=64, SENT=(2, 8), WORDS=(5, 25), C=2,
            STEPS=3)


def _nest_net(v, e, h, classes=2, flat=False, dense=None):
    """A nested net through the port's DSL: ids (or a dense input of
    width ``dense``) -> [emb] -> a group over subsequences whose step is
    fc 4H -> lstmemory -> last_seq ``sent``, with the memory ``para``
    summing the ``sent`` states -> last_seq -> fc softmax -> CE.
    ``flat``: the step's layers alone over a flat batch of the
    subsequences, ``sent`` its output."""
    from paddle_tpu_torch.config import dsl as d
    from paddle_tpu_torch.data import feeder as f
    from paddle_tpu_torch.layers.network import NeuralNetwork
    with d.config_scope():
        if dense:
            x = d.data("words", f.dense_vector(dense))
        else:
            x = d.data("words", f.integer_value_sequence(v) if flat
                       else f.integer_value_sub_sequence(v))
            x = d.embedding(x, size=e, name="emb")

        def sentence(frame):
            proj = d.fc(frame, size=4 * h, act=d.LinearActivation(),
                        bias_attr=False, name="proj")
            return d.last_seq(d.lstmemory(proj, name="lstm"), name="sent")
        if flat:
            return NeuralNetwork(d.topology(sentence(x)))

        def step(frame):
            mem = d.memory(name="para", size=h)
            sent = sentence(frame)
            return [sent, d.addto([sent, mem.out], name="para")]
        _, para = d.recurrent_group(step, [d.StepInput(x)],
                                    name="sentences")
        pred = d.fc(d.last_seq(para), size=classes,
                    act=d.SoftmaxActivation(), name="pred")
        label = d.data("label", f.integer_value(classes))
        return NeuralNetwork(d.topology(d.classification_cost(pred,
                                                              label)))


def _tag_cases():
    """(name, fn, arrays, ints) of phase 4z-tag (a) at the sizes of the
    JAX package's layer sweep and of the CPU parity tests."""
    import torch
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.ops import recurrent_ops as R
    r = np.random.RandomState(0)

    def seq(lens, n, name="in0", ids=0):
        """A float sequence of width n, or (``ids`` > 0) one of ids."""
        t = max(max(lens), 1)
        data = np.zeros((len(lens), t) if ids else (len(lens), t, n),
                        np.int32 if ids else np.float32)
        for i, m in enumerate(lens):
            data[i, :m] = r.randint(0, ids, m) if ids else \
                r.uniform(-1, 1, (m, n))
        return {name: data, name + "_len": np.array(lens, np.int32)}

    def d(b, n, name="in0"):
        return {name: r.uniform(-1, 1, (b, n)).astype(np.float32)}

    def ids(rows, name):
        lens = [len(x) for x in rows]
        data = np.zeros((len(rows), max(lens)), np.int32)
        for i, x in enumerate(rows):
            data[i, :len(x)] = x
        return {name: data, name + "_len": np.array(lens, np.int32)}

    cases = []

    def layer(*args, **kw):
        cases.append(_layer_case(*args, **kw))

    # the recurrent types at the sweep's sizes
    layer("recurrent", "recurrent", 4, [4], [seq([3, 2], 4)], seqs=("in0",),
          bias=True)
    layer("recurrent reversed relu", "recurrent", 4, [4],
          [seq([5, 0, 3, 6], 4)], seqs=("in0",), bias=True, act="relu",
          attrs={"reversed": True})
    for key in ("test", "test.state"):
        layer(f"lstm_step {key}", "lstm_step", 3, [12, 3],
              [d(2, 12), d(2, 3, "in1")], bias=True, key=key)
    for dirs in ([True, True], [False, True], [True, False],
                 [False, False]):
        layer(f"mdlstmemory 2x3 {dirs}", "mdlstmemory", 2, [60],
              [{"in0": r.uniform(-0.5, 0.5, (3, 60)).astype(np.float32)}],
              bias=True, attrs={"height": 2, "width": 3,
                                "directions": dirs})
    # the sequence costs
    layer("crf", "crf", 3, [3, 1], [seq([4, 2, 1], 3),
                                    seq([4, 2, 1], 0, "in1", ids=3)],
          seqs=("in0", "in1"))
    layer("crf weighted", "crf", 3, [3, 1, 1],
          [seq([4, 2, 3], 3), seq([4, 2, 3], 0, "in1", ids=3),
           {"in2": np.array([[1.0], [0.25], [2.0]], np.float32)}],
          seqs=("in0", "in1"), attrs={"coeff": 0.5})
    layer("crf_decoding", "crf_decoding", 3, [3], [seq([5, 1, 3, 0], 3)],
          seqs=("in0",))
    layer("crf_decoding with label", "crf_decoding", 3, [3, 1],
          [seq([5, 1, 3], 3), seq([5, 1, 3], 0, "in1", ids=3)],
          seqs=("in0", "in1"))
    layer("ctc", "ctc", 4, [4, 1], [seq([6, 5], 4),
                                    ids([[1, 2], [3, 3]], "in1")],
          seqs=("in0", "in1"))
    # row 0's three repeats need 5 frames and have 3: optax's finite
    # log-epsilon loss and its gradient
    layer("ctc impossible", "ctc", 4, [4, 1],
          [seq([3, 5], 4), ids([[1, 1, 1], [2]], "in1")],
          seqs=("in0", "in1"))
    layer("warp_ctc blank 3 norm_by_times", "warp_ctc", 4, [4, 1],
          [seq([6, 4], 4), ids([[0, 1], [2, 2]], "in1")],
          seqs=("in0", "in1"), attrs={"blank": 3, "norm_by_times": True})
    # gold kept (row 0), dropped at the first (row 1) and at the second
    # expansion (row 2)
    beam = {}
    for e, (cand, gold) in enumerate((
            ([[0, 1, 2], [3, 4, 5], [6, 7, 8]], [1, 9, 7]),
            ([[1, 2, 0], [5, 4, 3], [7, 1, 3]], [2, 4, 6]),
            ([[2, 0, 1], [4, 3, 5], [1, 2, 0]], [0, 3, 1]))):
        beam.update({f"in{3 * e}": r.randn(3, 3).astype(np.float32),
                     f"in{3 * e + 1}": np.array(cand, np.int32),
                     f"in{3 * e + 2}": np.array(gold, np.int32)})
    layer("cross_entropy_over_beam", "cross_entropy_over_beam", 1,
          [3, 3, 1] * 3, [beam])
    # the ops
    x = seq([4, 1, 0], 3, "x")
    ops = {"x": x["x"], "x_len": x["x_len"],
           "w": r.randn(3, 3).astype(np.float32) * 0.5,
           "b": r.randn(3).astype(np.float32) * 0.1,
           "h0": r.randn(3, 3).astype(np.float32),
           "xp": r.randn(3, 8).astype(np.float32),
           "c": r.randn(3, 2).astype(np.float32)}

    def rnn(reverse, **t):
        out, final = R.simple_rnn(SequenceBatch(t["x"], t["x_len"]), t["w"],
                                  t["b"], t["h0"], reverse=reverse)
        return torch.cat([out.data.reshape(3, -1), final], 1)
    for reverse in (False, True):
        cases.append((f"simple_rnn reverse {reverse}",
                      lambda reverse=reverse, **t: rnn(reverse, **t), ops,
                      ("x_len",)))
    cases.append(("lstm_unit", lambda **t: torch.cat(R.lstm_unit(
        t["xp"], t["c"], forget_bias=0.7), 1), ops, ("x_len",)))
    # nested groups: an empty subsequence, and a slot no row fills
    nd = r.randn(3, 5, 6, 5).astype(np.float32)
    nested = {"words": nd, "words_n": np.array([4, 1, 3], np.int32),
              "words_sub": np.array([[6, 0, 2, 5, 1], [3, 4, 1, 2, 2],
                                     [1, 6, 0, 4, 3]], np.int32),
              "label": np.array([0, 1, 1], np.int32)}
    net = _nest_net(0, 0, 7, dense=5)
    p = {f"p:{k}": v.numpy() + 0.05 * np.random.RandomState(1).randn(
        *v.shape).astype(np.float32)
        for k, v in net.init_params(4, "cpu").items()}
    for key in ("sent", "para"):
        cases.append((f"nested group {key}",
                      _layer_fn(net, nested=("words",), key=key),
                      dict(p, **nested), ("words_n", "words_sub", "label")))
    return cases


def _tag_lstm_kernels(dev):
    """Kernels 8 and 9 through ``lstm_sequence`` at a nested step's
    shape (B 64, H 512) against the plain scan: rows of length 0 among
    others, and a batch of length-0 rows only (a slot no paragraph
    fills)."""
    rng = np.random.RandomState(5)
    errs = []
    for i, lengths in enumerate((
            [0 if j % 5 == 0 else int(rng.randint(1, 26))
             for j in range(NEST["B"])], [0] * NEST["B"])):
        p, cot, ln = lstm_case(NEST["B"], 32, NEST["H"], lengths, 40 + i,
                               dev)
        reset_counts()
        got_o, got_g = lstm_run(p, cot, ln, False, "sequence")
        launches = read_counts()
        want_o, want_g = lstm_run(p, cot, ln, False, "scan")
        sync(dev)
        e_out = max((g - w).abs().max().item()
                    for g, w in zip(got_o, want_o))
        e_grad, ratio = grad_errors(got_g, want_g)
        if launches["lstm_fwd"] != 1 or launches["lstm_bwd"] != 1:
            fail(f"4z-tag (a): lstm_sequence at B {NEST['B']} H "
                 f"{NEST['H']} launched {launches}")
        if not (e_out <= LSTM_ATOL and ratio <= 1.0):
            fail(f"4z-tag (a): kernels 8/9 on lengths {lengths}: outputs "
                 f"{e_out:.3e}, gradients {ratio:.3f} of tolerance")
        errs.append((e_out, ratio))
    return errs


def phase_tag_types(dev):
    """Phase 4z-tag (a): every new type and op forward and backward on
    the card against the same code on the CPU; kernels 8 and 9 on a
    nested step's batches."""
    import torch
    worst, n = {}, 0
    for name, fn, arrays, ints in _tag_cases():
        want = _gen_run(fn, arrays, "cpu", ints)
        got = _gen_run(fn, arrays, dev, ints)
        if not want["output"].is_floating_point():
            if not torch.equal(got["output"], want["output"]):
                fail(f"4z-tag {name}: card {got['output'].tolist()} vs "
                     f"CPU {want['output'].tolist()}")
            worst[name] = 0.0
        else:
            worst[name] = _dense_worst(got, want, name)
        n += 1
    kern = _tag_lstm_kernels(dev)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    log(f"  (a) {n} cases (recurrent, lstm_step, mdlstmemory in four "
        f"directions, simple_rnn, lstm_unit, crf, crf_decoding, ctc with "
        f"an impossible alignment, warp_ctc, cross_entropy_over_beam's "
        f"three regimes, a nested group with an empty slot) card vs CPU "
        f"within rtol {DENSE_RTOL}, atol {DENSE_ATOL} x max(1, max|CPU|), "
        f"paths exact; worst shares {top}; kernels 8/9 at B {NEST['B']} "
        f"H {NEST['H']} with rows of length 0 and a batch of them only: "
        f"outputs {max(e for e, _ in kern):.3e}, gradients "
        f"{max(r for _, r in kern):.3f} of 3b's tolerance")
    return {"cases": n, "worst_share": max(worst.values()),
            "worst": dict(top), "lstm_kernels": kern}


def _tag_samples(rng, b, t_range, vocab, tags):
    """``b`` samples (words, tags) of the demo's task: lengths in
    ``t_range``, a tag its word's class (id mod ``tags``) moved on by one
    where the previous word's class is the same."""
    out = []
    for _ in range(b):
        n = int(rng.randint(t_range[0], t_range[1] + 1))
        words = rng.randint(0, vocab, n)
        cls = words % tags
        tag = cls.copy()
        tag[1:] = (cls[1:] + (cls[:-1] == cls[1:])) % tags
        out.append((words.tolist(), tag.tolist()))
    return out


def _demo_tag_batch(rng, dev, bs):
    """``demo/sequence_tagging/train.py``'s ``sample_batch``: (feed on
    ``dev``, tags, lengths)."""
    import torch
    from paddle_tpu_torch.core.sequence import SequenceBatch
    V, N, T = TAG_DEMO["V"], TAG_DEMO["N"], TAG_DEMO["T"]
    words = rng.randint(0, V, (bs, T)).astype(np.int32)
    cls = words % N
    tags = np.zeros_like(cls)
    tags[:, 0] = cls[:, 0]
    for t in range(1, T):
        tags[:, t] = (cls[:, t] + (cls[:, t - 1] == cls[:, t])) % N
    lens = rng.randint(T // 2, T + 1, (bs,)).astype(np.int32)
    ln = torch.from_numpy(lens)
    feed = {"word": SequenceBatch(torch.from_numpy(words), ln).to(dev),
            "target": SequenceBatch(torch.from_numpy(tags.astype(np.int32)),
                                    ln).to(dev)}
    return feed, tags, lens


def phase_tag_demo(dev):
    """Phase 4z-tag (b): ``configs/tagging.py`` at the demo's widths
    trained on the card as the demo trains it, then Viterbi decoding:
    accuracy above the demo's 0.9, the CPU's paths from the card's
    weights equal."""
    import torch
    from paddle_tpu_torch.config.config_parser import parse_config
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.trainer.trainer import Trainer
    model, opt, _ = parse_config(TAGGING_CONFIG, "")
    dmodel, _, _ = parse_config(TAGGING_CONFIG, "is_decoding=1")
    trainer = Trainer(NeuralNetwork(model), opt, seed=3, device=dev)
    rng = np.random.RandomState(0)
    reset_counts()
    t0 = time.perf_counter()
    losses = [float(trainer.train_one_batch(
        _demo_tag_batch(rng, dev, TAG_DEMO["B"])[0], placed=True))
        for _ in range(TAG_DEMO["STEPS"])]
    train_s = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts().items() if v}
    dnet = NeuralNetwork(dmodel)
    params = {k: trainer.params[k].detach() for k in dnet.param_specs}
    feed, tags, lens = _demo_tag_batch(rng, dev, TAG_DEMO["EVAL_B"])
    name = dnet.output_names[0]
    with torch.no_grad():
        pred = dnet.forward(params, {"word": feed["word"]},
                            is_training=False)[0][name].data.cpu()
        cpu = dnet.forward({k: v.cpu() for k, v in params.items()},
                           {"word": feed["word"].to("cpu")},
                           is_training=False)[0][name].data
    mask = np.arange(TAG_DEMO["T"])[None, :] < lens[:, None]
    acc = float(((pred.numpy() == tags) & mask).sum() / mask.sum())
    log(f"  (b) demo tagging (V {TAG_DEMO['V']}, {TAG_DEMO['N']} tags, E 16, "
        f"H 32, B {TAG_DEMO['B']}): CRF NLL {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {TAG_DEMO['STEPS']} steps ({train_s:.1f} s, "
        f"{train_s / TAG_DEMO['STEPS'] * 1e3:.2f} ms/step); Viterbi "
        f"accuracy {acc:.4f} over {TAG_DEMO['EVAL_B']} rows; CPU paths "
        f"from the card's weights equal {torch.equal(pred, cpu)}; launches "
        f"{launches or 'none'} (H 32 takes the scan in both packages)")
    if not acc > TAG_DEMO["ACC"]:
        fail(f"4z-tag (b): tagging accuracy {acc:.4f} <= {TAG_DEMO['ACC']}")
    if not torch.equal(pred, cpu):
        fail("4z-tag (b): the CPU's Viterbi paths from the card's weights "
             "differ")
    if launches:
        fail(f"4z-tag (b): launches {launches} at H 32 (the reference's "
             "dispatch takes the scan)")
    return {"loss_first": losses[0], "loss_last": losses[-1],
            "train_s": train_s, "accuracy": acc}


def _tag_full_config(decoding=False):
    from paddle_tpu_torch.config.config_parser import parse_config
    args = (f"vocab_size={TAG_FULL['V']},num_tags={TAG_FULL['N']},"
            f"emb_size={TAG_FULL['E']},hidden_size={TAG_FULL['H']},"
            f"batch_size={TAG_FULL['B']}")
    return parse_config(TAGGING_CONFIG, args + (",is_decoding=1"
                                                if decoding else ""))


def _card_vs_cpu_step(net, cpu_params, feed, dev, what):
    """The loss and every parameter's gradient of one ``net.loss`` on the
    CPU and on the card from the same parameters: (CPU loss, card loss,
    worst gradient error as a share of S2S_RTOL * max|ref| + 1e-8)."""
    import torch
    res = {}
    for where in ("cpu", dev):
        params = {n: p.to(where).requires_grad_(True)
                  for n, p in cpu_params.items()}
        f = {k: v.to(where) for k, v in feed.items()}
        loss, _ = net.loss(params, f)
        grads = torch.autograd.grad(loss, list(params.values()))
        res[str(where)] = (float(loss.detach()),
                           {n: g.cpu() for n, g in zip(params, grads)})
    (l_cpu, g_cpu), (l_dev, g_dev) = res["cpu"], res[str(dev)]
    ratio = max(((g_dev[n] - w).abs().max().item()
                 / (S2S_RTOL * w.abs().max().item() + 1e-8))
                for n, w in g_cpu.items())
    if not np.isfinite(l_dev) or abs(l_dev - l_cpu) > S2S_RTOL * abs(l_cpu) \
            or ratio > 1.0:
        fail(f"4z-tag {what}: card loss {l_dev} vs CPU {l_cpu}, gradients "
             f"{ratio:.3f} of tolerance")
    return l_cpu, l_dev, ratio


def _profile_busy(fn):
    """``fn()`` once under torch.profiler: (the device's busy share, its
    device items)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    return sum(r[1] for r in rows) / (wall * 1e6), sum(r[2] for r in rows)


def phase_tag_full(dev, card):
    """Phase 4z-tag (c): ``configs/tagging.py`` at the seq2seq row's
    encoder width on the card: the first step against the CPU, timed
    steps with exact launches of kernels 13 and 14, a Viterbi decode."""
    import torch
    from paddle_tpu_torch.data.feeder import (DataFeeder,
                                              integer_value_sequence)
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.trainer.trainer import Trainer
    model, opt, _ = _tag_full_config()
    dmodel, _, _ = _tag_full_config(decoding=True)
    V, N, B = TAG_FULL["V"], TAG_FULL["N"], TAG_FULL["B"]
    feeder = DataFeeder([("word", integer_value_sequence(V)),
                         ("target", integer_value_sequence(N))])
    feed = feeder.convert(_tag_samples(np.random.RandomState(0), B,
                                       TAG_FULL["LEN"], V, N))
    net = NeuralNetwork(model)
    cpu_params = net.init_params(seed=0, device="cpu")
    t0 = time.perf_counter()
    l_cpu, l_dev, ratio = _card_vs_cpu_step(net, cpu_params, feed, dev,
                                            "(c)")
    check_s = time.perf_counter() - t0
    trainer = Trainer(net, opt, seed=0, device=dev)
    trainer.params = {n: p.to(dev) for n, p in cpu_params.items()}
    placed = trainer._place_feed(feed)
    for _ in range(TAG_FULL["WARM"]):
        trainer.train_one_batch(placed, placed=True)
    steps = TAG_FULL["STEPS"]
    launches, losses, dev_ms, wall_ms, peak = timed_steps(trainer, placed,
                                                          steps)
    check_launches(launches, {"gru_fwd": 2 * steps, "gru_bwd": 2 * steps},
                   "4z-tag (c) timed steps")
    if not (all(np.isfinite(losses))
            and np.mean(losses[-5:]) < losses[0]):
        fail(f"4z-tag (c): NLL {losses[0]} -> {losses[-5:]} not finite "
             "and falling")
    busy, items = _profile_busy(
        lambda: trainer.train_one_batch(placed, placed=True))
    # one Viterbi decode of the batch through the decoding topology
    dnet = NeuralNetwork(dmodel)
    params = {n: trainer.params[n].detach() for n in dnet.param_specs}
    name = dnet.output_names[0]
    word = {"word": placed["word"]}
    with torch.no_grad():
        dnet.forward(params, word, is_training=False)          # warm
        torch.cuda.synchronize()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        paths = dnet.forward(params, word, is_training=False)[0][name]
        end.record()
        end.synchronize()
        dec_wall = (time.perf_counter() - t0) * 1e3
    dec_launches = read_counts()
    check_launches(dec_launches, {"gru_fwd": 2}, "4z-tag (c) decode")
    lens = paths.length.cpu().numpy()
    p = paths.data.cpu().numpy()
    if p.shape[0] != B or p.min() < 0 or p.max() >= N:
        fail(f"4z-tag (c): paths {p.shape} in [{p.min()}, {p.max()}]")
    tags = feed["target"].data.numpy()
    mask = np.arange(p.shape[1])[None, :] < lens[:, None]
    acc = float(((p == tags) & mask).sum() / mask.sum())
    m = {"loss_cpu": l_cpu, "loss_card": l_dev, "grad_share": ratio,
         "ms_per_step": dev_ms, "wall_ms_per_step": wall_ms,
         "tokens_per_s": float(feed["word"].length.sum()) / (wall_ms / 1e3),
         "peak_gb": peak, "busy_share": busy, "device_items": items,
         "loss_first": losses[0], "loss_last": losses[-1],
         "decode_ms": start.elapsed_time(end), "decode_wall_ms": dec_wall,
         "decode_accuracy": acc, "check_s": check_s,
         "launches": {k: v for k, v in launches.items() if v}}
    log(f"  (c) tagging at B {B}, V {V}, E {TAG_FULL['E']}, H "
        f"{TAG_FULL['H']}, {N} tags, T {feed['word'].max_len}: first step "
        f"card vs CPU loss {l_dev:.6f} vs {l_cpu:.6f}, gradients "
        f"{ratio:.3f} of tolerance ({check_s:.1f} s); {steps} steps "
        f"{dev_ms:.3f} ms/step between events (wall {wall_ms:.3f}, "
        f"{m['tokens_per_s']:.1f} tokens/s), NLL {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}, busy {100 * busy:.1f} % of a profiled step "
        f"({items} device items), peak {peak:.2f} GB; launches "
        f"{m['launches']}; Viterbi decode {m['decode_ms']:.3f} ms (wall "
        f"{dec_wall:.3f}), gru_fwd {dec_launches['gru_fwd']}, accuracy "
        f"{acc:.4f}; card: {card}")
    return m


def _nest_samples(rng, b):
    """``b`` samples (paragraph, label): 2-8 sentences of 5-25 ids."""
    out = []
    for _ in range(b):
        k = int(rng.randint(NEST["SENT"][0], NEST["SENT"][1] + 1))
        para = [rng.randint(0, NEST["V"], int(rng.randint(
            NEST["WORDS"][0], NEST["WORDS"][1] + 1))).tolist()
            for _ in range(k)]
        out.append((para, int(rng.randint(NEST["C"]))))
    return out


def phase_tag_nested(dev):
    """Phase 4z-tag (d): the nested group at the LSTM row's width fed by
    ``DataFeeder``: nested equal to flat on the card (the reference's
    defining test), card against CPU, training steps with S launches
    each of kernels 8 and 9 a step."""
    import torch
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.data.feeder import (DataFeeder, integer_value,
                                              integer_value_sub_sequence)
    from paddle_tpu_torch.ops import lstm as L
    from paddle_tpu_torch.trainer.trainer import Trainer
    V, E, H, B = NEST["V"], NEST["E"], NEST["H"], NEST["B"]
    feeder = DataFeeder([("words", integer_value_sub_sequence(V)),
                         ("label", integer_value(NEST["C"]))])
    feed = feeder.convert(_nest_samples(np.random.RandomState(0), B))
    words = feed["words"]
    S = int(words.data.shape[1])
    tiers = (L.fused_tier(B, H), L.fused_tier(B * S, H))
    if tiers != ("fused", "fused"):
        fail(f"4z-tag (d): lstm.fused_tier at B {B} and {B * S}: {tiers}")
    net = _nest_net(V, E, H, NEST["C"])
    flat = _nest_net(V, E, H, flat=True)
    cpu_params = net.init_params(seed=0, device="cpu")
    # nested = flat on the card: the sentence states and the gradients
    # of a ramp readout over the valid slots
    params = {n: p.to(dev).requires_grad_(True)
              for n, p in cpu_params.items()}
    shared = {n: params[n] for n in flat.param_specs}
    valid = words.subseq_mask().to(dev)                  # [B, S]
    ramp = torch.cos(0.1 * torch.arange(B * S * H, device=dev,
                                        dtype=torch.float32)
                     ).reshape(B, S, H) * valid[..., None]
    reset_counts()
    sent = net.forward(params, {"words": words.to(dev),
                                "label": feed["label"].to(dev)},
                       is_training=False)[0]["sent"].data * valid[..., None]
    g_nest = torch.autograd.grad(torch.sum(sent * ramp),
                                 list(shared.values()))
    nested_launches = read_counts()
    reset_counts()
    fsent = flat.forward(shared, {"words": words.flatten_to_subseq().to(
        dev)}, is_training=False)[0]["sent"].reshape(B, S, H) \
        * valid[..., None]
    g_flat = torch.autograd.grad(torch.sum(fsent * ramp),
                                 list(shared.values()))
    flat_launches = read_counts()
    out_err = float((sent - fsent).detach().abs().max())
    g_ratio = max(float((a - b).abs().max()
                        / (S2S_RTOL * b.abs().max() + 1e-8))
                  for a, b in zip(g_nest, g_flat))
    check_launches(nested_launches, {"lstm_fwd": S, "lstm_bwd": S},
                   "4z-tag (d) nested")
    check_launches(flat_launches, {"lstm_fwd": 1, "lstm_bwd": 1},
                   "4z-tag (d) flat")
    if out_err > LSTM_ATOL or g_ratio > 1.0:
        fail(f"4z-tag (d): nested vs flat on the card: outputs {out_err:.3e}"
             f", gradients {g_ratio:.3f} of tolerance")
    del params, shared, g_nest, g_flat
    # card against CPU, then training steps
    l_cpu, l_dev, ratio = _card_vs_cpu_step(net, cpu_params, feed, dev,
                                            "(d)")
    trainer = Trainer(net, OptimizationConfig(learning_method="adam",
                                              learning_rate=1e-3),
                      seed=0, device=dev)
    trainer.params = {n: p.to(dev) for n, p in cpu_params.items()}
    placed = trainer._place_feed(feed)
    trainer.train_one_batch(placed, placed=True)
    steps = NEST["STEPS"]
    launches, losses, dev_ms, wall_ms, _ = timed_steps(trainer, placed,
                                                       steps)
    check_launches(launches, {"lstm_fwd": S * steps, "lstm_bwd": S * steps},
                   "4z-tag (d) steps")
    if not all(np.isfinite(losses)):
        fail(f"4z-tag (d): losses {losses}")
    m = {"S": S, "nested_vs_flat_out": out_err,
         "nested_vs_flat_grad_share": g_ratio, "loss_cpu": l_cpu,
         "loss_card": l_dev, "grad_share": ratio, "ms_per_step": dev_ms,
         "wall_ms_per_step": wall_ms, "losses": losses,
         "launches": {k: v for k, v in launches.items() if v}}
    log(f"  (d) nested group B {B}, S {S} sentences (T "
        f"{words.data.shape[2]}), V {V}, E {E}, H {H}: nested vs flat "
        f"(B*S {B * S} rows) on the card: outputs {out_err:.3e}, "
        f"gradients {g_ratio:.3f} of tolerance; launches nested "
        f"{ {k: v for k, v in nested_launches.items() if v} }, flat "
        f"{ {k: v for k, v in flat_launches.items() if v} }; card vs CPU "
        f"loss {l_dev:.6f} vs {l_cpu:.6f}, gradients {ratio:.3f} of "
        f"tolerance; {steps} Adam steps {dev_ms:.3f} ms/step (wall "
        f"{wall_ms:.3f}), losses {[round(x, 5) for x in losses]}, launches "
        f"{m['launches']}")
    return m


def phase_tag(dev, card):
    """Phase 4z-tag: (a) the new types card vs CPU, (b) the tagging demo
    trained and decoded, (c) the tagging config at the seq2seq row's
    encoder width, (d) a nested group at the LSTM row's width."""
    import torch
    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")
    m = {"types": phase_tag_types(dev), "demo": phase_tag_demo(dev),
         "full": phase_tag_full(dev, card),
         "nested": phase_tag_nested(dev)}
    m["seconds"] = time.perf_counter() - t0
    log(f"  4z-tag took {m['seconds']:.1f} s")
    return m


# ------------------------------------------------ phase 4z-image
#: phase 4z-image (a): card against CPU on the same port code (fp32, TF32
#: off) for the image, 3-D and detection types at the JAX package's
#: sweep sizes (tests/test_layer_grad_sweep.py::CASES) and the nn_ops at
#: larger shapes (a C3D block: B 4, 64 -> 128 channels, 8x28x28, 3^3,
#: pad 1), as 4z-gen (a): every float output and gradient within
#: DENSE_RTOL and DENSE_ATOL * max(1, max|CPU|), indices exact; and the
#: port's NHWC stride-1 3x3 conv (B 4, 28x28, 64 -> 64) in fp32 against
#: the same code in float64 on the CPU within IMAGE_CONV_F64_LIMIT of
#: that tolerance: cuDNN's fp32 weight gradient reads 0.83-1.21 of it
#: from float64, the CPU's 0.02-0.08 (tools/image_probe.py)
IMAGE_C3D = dict(B=4, C=64, F=128, D=8, HW=28)
IMAGE_CONV_F64_LIMIT = 2.0
#: (b): SSD300's prior layout (PaddlePaddle/models ssd, VOC config): six
#: heads over 300x300 at 38, 19, 10, 5, 3, 1 cells with these min / max
#: sizes and aspect ratios (8732 priors), 21 classes, B 32, 1-10
#: ground-truth boxes an image, heads and boxes from RandomState(0); the
#: decode at nms_top_k 400, keep_top_k 200, thresholds 0.01 and 0.45
SSD = dict(IMG=300, CELLS=(38, 19, 10, 5, 3, 1),
           MIN=(30, 60, 111, 162, 213, 264),
           MAX=(60, 111, 162, 213, 264, 315),
           AR=([2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0], [2.0]),
           VAR=[0.1, 0.1, 0.2, 0.2], CLASSES=21, B=32, GT=(1, 10),
           PRIORS=8732, TOP_K=400, KEEP=200, CONF_T=0.01, NMS_T=0.45)
#: (c): configs/image.py's nets through `python -m paddle_tpu_torch train
#: --job time` at the config's B 64 (3 warm-up batches, then this many
#: timed ones; num_samples cut to those), after one step at B 4 card vs
#: CPU from the same parameters (dropout off: each device draws its own
#: masks): the loss within rtol VAE_LOSS_RTOL; every parameter's
#: gradient within IMAGE_GRAD_REL of the CPU's in norm,
#: ||g_card - g_cpu|| / ||g_cpu|| (ReLU and max-pool flips move a norm a
#: little, a wrong backward by O(1): on an H100 a 1e-7 nudge of the
#: weights moves it by up to 7.8e-3 on the CPU alone (alexnet), the card
#: reads up to 8.8e-3 (googlenet, cuDNN off), C8's average pool put back
#: 1.28 (smallnet); tools/image_probe.py); and every weight after one
#: step of the config's optimizer within VAE_W_ATOL, all but 1 in 10^3 of
#: a tensor within 2e-5
IMAGE_CONFIG = os.path.join("paddle_tpu_torch", "configs", "image.py")
IMAGE_NETS = dict(smallnet=20, alexnet=10, googlenet=5, vgg=5)
IMAGE_B, IMAGE_CHECK_B = 64, 4
IMAGE_GRAD_REL = 0.1
#: (d): model=resnet at 4l's B under 4l's flags, 3 warm-up and this many
#: timed batches: 4l's launches of kernels 19 and 20 a step
IMAGE_R50_TIMED = 5


def _image_cases():
    """(name, fn, arrays, ints) of phase 4z-image (a): the 22 types at the
    sweep's sizes, then the ops at larger shapes."""
    from paddle_tpu_torch.ops import nn_ops as N
    r = np.random.RandomState(77)
    f32 = np.float32

    def d(*shape, lo=-1.0, hi=1.0):
        return r.uniform(lo, hi, shape).astype(f32)

    def img(c, h, **kw):
        return dict(channels=c, img_size=h, img_size_y=h, **kw)

    def vol(c, z, h, **kw):
        return dict(img(c, h), img_size_z=z, **kw)

    def boxes(n):
        return np.sort(r.rand(n, 2, 2), axis=1).reshape(n, 4).astype(f32)

    cases = []

    def layer(name, size, in_sizes, feeds=None, ltype=None, **kw):
        feeds = feeds or [{f"in{i}": d(2, s)
                           for i, s in enumerate(in_sizes)}]
        cases.append(_layer_case(name, ltype or name, size, in_sizes, feeds,
                                 **kw))

    for t in ("exconvt", "cudnn_convt"):
        layer(t, 0, [32], attrs=img(2, 4, filter_size=3, num_filters=3,
                                    stride=2, padding=1))
    layer("mkldnn_conv", 0, [75], bias=True,
          attrs=img(3, 5, filter_size=3, num_filters=4, stride=1,
                    padding=1))
    for t in ("cudnn_pool", "mkldnn_pool"):
        layer(t, 0, [32], attrs=img(2, 4, pool_size=2, stride=2,
                                    pool_type="avg-projection"))
    layer("mkldnn_batch_norm", 6, [6], [{"in0": d(8, 6)}], bias=True,
          attrs={"channels": 6})
    layer("norm", 32, [32], attrs=img(2, 4, norm_size=3, scale=0.01,
                                      pow=0.75))
    layer("maxout", 18, [36], attrs=img(4, 3, groups=2))
    layer("blockexpand", 8, [32], attrs=img(2, 4, block_x=2, block_y=2,
                                            stride_x=2, stride_y=2))
    layer("spp", 0, [32], attrs=img(2, 4, pyramid_height=2,
                                    pool_type="avg"))
    layer("pad", 0, [18], attrs=img(2, 3, pad_c=[0, 0], pad_h=[1, 1],
                                    pad_w=[1, 1]))
    layer("crop", 0, [32], attrs=img(2, 4, crop_offsets=[1, 1],
                                     crop_shape=[2, 2]))
    layer("rotate", 12, [12], attrs={"height": 3, "width": 4})
    layer("switch_order", 0, [24],
          [{"in0": r.randn(2, 3, 4, 2).astype(f32)}],
          attrs={"reshape_axis": 3})
    layer("bilinear_interp", 0, [18], attrs=img(2, 3, out_size_x=5,
                                                out_size_y=5))
    layer("cross-channel-norm", 12, [12], [{"in0": d(2, 12, lo=0.3)}],
          attrs={"channels": 3})
    layer("conv3d", 54, [96], bias=True,
          attrs=vol(2, 3, 4, filter_size=2, num_filters=3, stride=1,
                    padding=0))
    layer("deconv3d", 0, [36], attrs=vol(2, 2, 3, filter_size=2,
                                         num_filters=2, stride=1,
                                         padding=0))
    layer("pool3d", 16, [128], attrs=vol(2, 4, 4, pool_size=2, stride=2,
                                         padding=0, pool_type="avg"))
    priors = np.concatenate([boxes(4), np.tile([0.1, 0.1, 0.2, 0.2],
                                               (4, 1)).astype(f32)], 1)
    layer("priorbox", 0, [18], [{"in0": d(1, 18)}],
          attrs={"layer_width": 3, "layer_height": 3, "image_width": 12,
                 "image_height": 12, "min_size": [4], "max_size": [],
                 "aspect_ratio": [2.0], "variance": [0.1, 0.1, 0.2, 0.2]})
    gt = np.concatenate([np.ones((2, 1, 1), f32), boxes(2)[:, None],
                         np.zeros((2, 1, 1), f32)], 2)
    layer("multibox_loss", 1, [32, 6, 16, 12],
          [{"in0": np.tile(priors.reshape(1, -1), (2, 1)), "in1": gt,
            "in1_len": np.ones(2, np.int32), "in2": 0.1 * d(2, 16),
            "in3": d(2, 12)}], seqs=("in1",),
          attrs={"num_classes": 3, "input_num": 1,
                 "overlap_threshold": 0.3})
    layer("detection_output", 0, [32, 16, 12],
          [{"in0": priors.reshape(1, -1), "in1": 0.1 * d(1, 16),
            "in2": d(1, 12)}], attrs={"num_classes": 3, "input_num": 1})

    def w(*shape):
        return (r.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(f32)

    c3 = IMAGE_C3D
    x3 = d(c3["B"], c3["D"], c3["HW"], c3["HW"], c3["C"])
    ties = r.randint(0, 4, (4, 28, 28, 32)).astype(f32)
    ones = np.ones(64, f32)
    ops = [
        ("conv2d NCHW s2 SAME",
         lambda x, w: N.conv2d(x, w, 2, "SAME", data_format="NCHW"),
         {"x": d(4, 64, 28, 28), "w": w(3, 3, 64, 32)}, ()),
        ("conv2d_transpose s2 64->32 at 28x28",
         lambda x, w: N.conv2d_transpose(x, w, 2, 1),
         {"x": d(4, 28, 28, 64), "w": w(3, 3, 32, 64)}, ()),
        ("conv3d C3D", lambda x, w: N.conv3d(x, w, 1, 1),
         {"x": x3, "w": w(3, 3, 3, c3["C"], c3["F"])}, ()),
        ("conv3d_transpose C3D", lambda x, w: N.conv3d_transpose(x, w, 1, 1),
         {"x": x3, "w": w(3, 3, 3, c3["F"], c3["C"])}, ()),
        ("pool3d max C3D", lambda x: N.pool3d(x, "max", 2, 2, 0),
         {"x": x3}, ()),
        ("pool3d avg C3D pad 1", lambda x: N.pool3d(x, "avg", 3, 2, 1),
         {"x": x3}, ()),
        ("pool2d NCHW max asymmetric pads",
         lambda x: N.pool2d(x, "max", 3, 2, [(0, 1), (1, 0)], "NCHW"),
         {"x": d(4, 64, 27, 27)}, ()),
        ("pool2d avg SAME", lambda x: N.pool2d(x, "avg", 3, 2, "SAME"),
         {"x": d(4, 27, 27, 64)}, ()),
        ("pool2d global avg",
         lambda x: N.pool2d(x, "avg", global_pooling=True),
         {"x": d(4, 7, 7, 512)}, ()),
        ("max_pool2d_with_index values",
         lambda x: N.max_pool2d_with_index(x, 3, 2, 1)[0], {"x": ties},
         ()),
        ("max_pool2d_with_index indices",
         lambda x: N.max_pool2d_with_index(x, 3, 2, 1)[1], {"x": ties},
         ("x",)),
        ("spp 13x17 max", lambda x: N.spatial_pyramid_pool(x, 3, "max"),
         {"x": d(4, 13, 17, 256)}, ()),
        ("spp 13x17 avg", lambda x: N.spatial_pyramid_pool(x, 3, "avg"),
         {"x": d(4, 13, 17, 256)}, ()),
        ("batch_norm", lambda x, s, b, m, v: N.batch_norm(x, s, b, m, v)[0],
         {"x": d(8, 28, 28, 64), "s": d(64), "b": d(64),
          "m": 0 * ones, "v": ones}, ("m", "v")),
        ("affine_act_conv2d 1x1",
         lambda z, a, c, w: N.affine_act_conv2d(z, a, c, w),
         {"z": d(4, 28, 28, 64), "a": d(64), "c": d(64),
          "w": w(1, 1, 64, 128)}, ()),
        ("conv2d_bn s2",
         lambda x, w, s, b, m, v: N.conv2d_bn(x, w, None, s, b, m, v,
                                              stride=2, padding=1)[0],
         {"x": d(4, 28, 28, 64), "w": w(3, 3, 64, 64), "s": d(64),
          "b": d(64), "m": 0 * ones, "v": ones}, ("m", "v")),
        ("lrn 96 channels at 55x55",
         lambda x: N.lrn(x, 5, 1.0, 1e-4 / 5, 0.75),
         {"x": d(4, 55, 55, 96)}, ()),
        ("maxout NHWC", lambda x: N.maxout(x, 2), {"x": d(4, 28, 28, 64)},
         ()),
        ("maxout NCHW", lambda x: N.maxout(x, 4, "NCHW"),
         {"x": d(4, 64, 28, 28)}, ()),
        ("prelu", lambda x, a: N.prelu(x, a),
         {"x": d(64, 1024), "a": d(1024)}, ()),
        ("bilinear_interp up", lambda x: N.bilinear_interp(x, 47, 47),
         {"x": d(4, 32, 32, 16)}, ()),
        ("bilinear_interp down", lambda x: N.bilinear_interp(x, 20, 13),
         {"x": d(4, 32, 32, 16)}, ()),
        ("feature_map_expand",
         lambda x: N.feature_map_expand(x, 8, False), {"x": d(64, 256)},
         ()),
        ("block_expand padded",
         lambda x: N.block_expand(x, 3, 3, 2, 2, 1, 1),
         {"x": d(4, 28, 28, 32)}, ()),
        ("rotate", lambda x: N.rotate(x, 28, 32),
         {"x": d(64, 28 * 32 * 8)}, ()),
        ("switch_order", lambda x: N.switch_order(x, "NCHW"),
         {"x": d(4, 28, 28, 64)}, ())]
    cases += [(f"op {n}", fn, arrays, ints) for n, fn, arrays, ints in ops]
    return cases


def phase_image_types(dev):
    """Phase 4z-image (a): the 22 types and the nn_ops forward and
    backward on the card against the same code on the CPU, and the NHWC
    stride-1 conv against float64."""
    import torch
    from paddle_tpu_torch.core.dtypes import Policy, policy_scope
    from paddle_tpu_torch.ops import nn_ops as N
    worst, n = {}, 0
    for name, fn, arrays, ints in _image_cases():
        want = _gen_run(fn, arrays, "cpu", ints)
        got = _gen_run(fn, arrays, dev, ints)
        if not want["output"].is_floating_point():
            if not torch.equal(got["output"], want["output"]):
                fail(f"4z-image {name}: card indices differ from the CPU's")
            worst[name] = 0.0
        else:
            worst[name] = _dense_worst(got, want, name)
        n += 1
    r = np.random.RandomState(78)
    arrays = {"x": r.uniform(-1, 1, (4, 28, 28, 64)),
              "w": r.randn(3, 3, 64, 64) / 24}

    def conv(x, w):
        return N.conv2d(x, w, 1, "SAME")
    # float64 compute, the output rounded to fp32 so that the readout's
    # ramp is the card's
    f64 = torch.float64
    with policy_scope(Policy(f64, f64, torch.float32)):
        want = _gen_run(conv, arrays, "cpu")
    got = _gen_run(conv, {k: v.astype(np.float32)
                          for k, v in arrays.items()}, dev)
    f64_share = _dense_worst(got, want, "op conv2d NHWC s1 against float64",
                             IMAGE_CONV_F64_LIMIT)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    log(f"  (a) {n} cases (the 22 image, 3-D and detection types at the "
        f"sweep's sizes, the nn_ops at larger shapes: a stride-2 exconvt "
        f"64->32 at 28x28, lrn over 96 channels at 55x55, spp at 13x17, "
        f"bilinear up and down, max_pool2d_with_index with ties and "
        f"padding, conv3d / deconv3d / pool3d on a C3D block) card vs CPU "
        f"within rtol {DENSE_RTOL}, atol {DENSE_ATOL} x max(1, max|CPU|), "
        f"indices exact; worst shares {top}; the NHWC stride-1 3x3 conv at "
        f"[4, 28, 28, 64] -> 64 in fp32 on the card against float64 on the "
        f"CPU {f64_share:.3f} of that tolerance (limit "
        f"{IMAGE_CONV_F64_LIMIT})")
    return {"cases": n + 1, "worst_share": max(worst.values()),
            "worst": dict(top), "conv2d_vs_f64_share": f64_share}


def _ssd_config():
    """SSD300's detection layers over data: six priorbox layers over the
    feature maps' grids (concatenated), the loc and conf heads fed as
    data, the multibox loss and the detection output."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.data.feeder import (dense_vector,
                                              dense_vector_sequence)
    from paddle_tpu_torch.ops.detection_ops import num_priors_per_cell
    s = SSD
    with dsl.config_scope():
        image = dsl.data("image", dense_vector(3 * s["IMG"] ** 2),
                         height=s["IMG"], width=s["IMG"])
        label = dsl.data("label", dense_vector_sequence(6))
        boxes, locs, confs = [], [], []
        for i, (cell, mn, mx, ar) in enumerate(zip(
                s["CELLS"], s["MIN"], s["MAX"], s["AR"])):
            feat = dsl.data(f"feat{i}", dense_vector(cell * cell),
                            height=cell, width=cell)
            boxes.append(dsl.priorbox_layer(feat, image, ar, s["VAR"], [mn],
                                            [mx], name=f"priorbox{i}"))
            k = cell * cell * num_priors_per_cell([mn], [mx], ar)
            locs.append(dsl.data(f"loc{i}", dense_vector(4 * k)))
            confs.append(dsl.data(f"conf{i}",
                                  dense_vector(s["CLASSES"] * k)))
        priors = dsl.concat(boxes, name="priors")
        loss = dsl.multibox_loss_layer(locs, confs, priors, label,
                                       s["CLASSES"], name="loss")
        det = dsl.detection_output_layer(
            locs, confs, priors, s["CLASSES"], nms_threshold=s["NMS_T"],
            nms_top_k=s["TOP_K"], keep_top_k=s["KEEP"],
            confidence_threshold=s["CONF_T"], name="det")
        return dsl.topology([loss, det])


def _ssd_feed(net):
    """The heads and the ground truth from RandomState(0): the boxes
    through DataFeeder as a sequence of (class, xmin, ymin, xmax, ymax,
    difficult) rows an image; N(0, 1) conf logits and 0.1 N(0, 1) loc
    offsets, except at the priors the ground truth matches, whose class
    logit is raised by 6 and whose offsets are their box's encoding plus
    0.1 N(0, 1) noise, so that the decode finds real detections."""
    import torch
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.data.feeder import dense_vector_sequence
    from paddle_tpu_torch.ops import detection_ops as D
    s, rng = SSD, np.random.RandomState(0)
    b, c = s["B"], s["CLASSES"]
    rows = []
    for n in rng.randint(s["GT"][0], s["GT"][1] + 1, b):
        xy = np.sort(rng.rand(n, 2, 2), axis=1).reshape(n, 4)
        rows.append((np.concatenate([rng.randint(1, c, (n, 1)), xy,
                                     np.zeros((n, 1))], 1)
                     .astype(np.float32).tolist(),))
    feed = DataFeeder([("label", dense_vector_sequence(6))]).convert(rows)
    priors = torch.from_numpy(np.concatenate([
        D.prior_boxes(cell, cell, s["IMG"], s["IMG"], [mn], [mx], ar,
                      s["VAR"])
        for cell, mn, mx, ar in zip(s["CELLS"], s["MIN"], s["MAX"],
                                    s["AR"])]))
    gt = feed["label"]
    valid = torch.arange(gt.data.shape[1])[None, :] < gt.length[:, None]
    match, _ = D.match_priors(priors[:, :4], gt.data[..., 1:5], valid, 0.5)
    pos = match >= 0
    safe = match.clamp(min=0).long()
    conf = torch.from_numpy(rng.randn(b, s["PRIORS"], c).astype(np.float32))
    loc = torch.from_numpy(0.1 * rng.randn(b, s["PRIORS"], 4)
                           .astype(np.float32))
    cls = torch.gather(gt.data[..., 0].long(), 1, safe)
    conf.scatter_add_(2, cls[..., None], 6.0 * pos[..., None].float())
    target = D.encode_boxes(priors[None, :, :4], priors[None, :, 4:],
                            torch.gather(gt.data[..., 1:5], 1, safe[..., None]
                                         .expand(b, s["PRIORS"], 4)))
    loc = torch.where(pos[..., None], target + loc, loc)
    feed["image"] = torch.zeros(b, 3 * s["IMG"] ** 2)
    start = 0
    for i, cell in enumerate(s["CELLS"]):
        k = cell * cell * D.num_priors_per_cell([s["MIN"][i]],
                                                [s["MAX"][i]], s["AR"][i])
        feed[f"feat{i}"] = torch.zeros(b, cell * cell)
        feed[f"loc{i}"] = loc[:, start:start + k].reshape(b, -1).clone()
        feed[f"conf{i}"] = conf[:, start:start + k].reshape(b, -1).clone()
        start += k
    assert start == s["PRIORS"] and set(feed) == {
        lc.name for lc in net.config.layers if lc.type == "data"}
    return feed


def phase_image_detection(dev, card):
    """Phase 4z-image (b): SSD300's priors, the multibox loss and its
    gradients, the mined negatives, the decode and the detection_map
    evaluator over it, card against CPU; ms of the loss forward +
    backward and of the decode."""
    import torch
    from paddle_tpu_torch.evaluators import create_evaluator
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.layers.detection import _as_conf, _as_loc
    from paddle_tpu_torch.ops import detection_ops as D
    s = SSD
    net = NeuralNetwork(_ssd_config())
    cpu_feed = _ssd_feed(net)
    heads = [k for k in cpu_feed if k.startswith(("loc", "conf"))]
    res = {}
    for where in ("cpu", dev):
        feed = {k: v.to(where) for k, v in cpu_feed.items()}
        for k in heads:
            feed[k].requires_grad_(True)
        values, _ = net.forward({}, feed, is_training=False)
        rows = values["loss"]
        loss = torch.sum(rows) / rows.shape[0]
        grads = torch.autograd.grad(loss, [feed[k] for k in heads])
        priors = values["priors"].detach()
        conf = torch.cat([_as_conf(feed[f"conf{i}"].detach(), s["CLASSES"])
                          for i in range(6)], 1)
        label = feed["label"]
        _, pos, neg = D.mine(conf, priors.reshape(-1, 8), label.data,
                             label.length)
        ev = create_evaluator("detection_map")
        ev.eval_batch(values["det"].detach(), label)
        res[str(where)] = {
            "priors": priors.cpu(), "loss": loss.detach().cpu(),
            "grads": {f"grad {k}": g.cpu() for k, g in zip(heads, grads)},
            "pos": pos.cpu(), "neg": neg.cpu(),
            "det": values["det"].detach().cpu(), "map": ev.finish()}
    want, got = res["cpu"], res[str(dev)]
    if tuple(got["priors"].shape) != (1, 8 * s["PRIORS"]) or \
            not torch.equal(got["priors"], want["priors"]):
        fail(f"4z-image (b): priors {tuple(got['priors'].shape)} differ from "
             "the CPU's or are not SSD300's 8732")
    l_dev, l_cpu = float(got["loss"]), float(want["loss"])
    if not np.isfinite(l_dev) or abs(l_dev - l_cpu) > \
            VAE_LOSS_RTOL * abs(l_cpu):
        fail(f"4z-image (b): multibox loss card {l_dev} vs CPU {l_cpu}")
    g_share = _dense_worst(got["grads"], want["grads"], "multibox loss")
    if not (torch.equal(got["pos"], want["pos"])
            and torch.equal(got["neg"], want["neg"])):
        fail("4z-image (b): the matched priors or the mined negatives "
             "differ card vs CPU")
    det_g, det_w = got["det"], want["det"]
    if not torch.equal(det_g[..., :2], det_w[..., :2]):
        fail("4z-image (b): the kept (image, class) rows differ card vs CPU")
    d_share = _dense_worst({"rows": det_g}, {"rows": det_w}, "decode")
    if got["map"] != want["map"]:
        fail(f"4z-image (b): detection_map card {got['map']} vs CPU "
             f"{want['map']}")
    # times on the card: the loss forward + backward, the decode
    feed = {k: v.to(dev) for k, v in cpu_feed.items()}
    p8 = got["priors"].to(dev).reshape(-1, 8)
    loc = torch.cat([_as_loc(feed[f"loc{i}"]) for i in range(6)], 1)
    conf = torch.cat([_as_conf(feed[f"conf{i}"], s["CLASSES"])
                      for i in range(6)], 1).requires_grad_(True)
    loc.requires_grad_(True)
    lab = feed["label"]

    def loss_step():
        val = D.multibox_loss(conf, loc, p8, lab.data, lab.length,
                              s["CLASSES"])
        torch.autograd.grad(val, [conf, loc])

    def decode():
        with torch.no_grad():
            D.detection_output(conf, loc, p8, s["CLASSES"],
                               conf_threshold=s["CONF_T"],
                               nms_top_k=s["TOP_K"],
                               nms_threshold=s["NMS_T"],
                               keep_top_k=s["KEEP"])
    m = {"priors": s["PRIORS"], "loss": l_dev, "loss_cpu": l_cpu,
         "grad_share": g_share, "decode_share": d_share,
         "positives": int(got["pos"].sum()),
         "negatives": int(got["neg"].sum()),
         "kept": int((det_g[..., 0] >= 0).sum()),
         "detection_map": got["map"]["detection_map"]}
    m["loss_ms"] = time_events_ms(loss_step, reps=5)
    m["decode_ms"] = time_events_ms(decode, reps=3)
    m["loss_busy"], m["loss_items"] = _profile_busy(loss_step)
    m["decode_busy"], m["decode_items"] = _profile_busy(decode)
    log(f"  (b) SSD300 heads (B {s['B']}, {s['PRIORS']} priors, "
        f"{s['CLASSES']} classes, {m['positives']} matched priors, "
        f"{m['negatives']} mined negatives): priors equal, loss card "
        f"{l_dev:.6f} vs CPU {l_cpu:.6f}, gradients {g_share:.3f} of the "
        f"tolerance, mined negatives equal; decode (nms_top_k "
        f"{s['TOP_K']}, keep_top_k {s['KEEP']}): {m['kept']} rows kept, "
        f"(image, class) equal, scores and boxes {d_share:.3f} of the "
        f"tolerance, detection_map {m['detection_map']} equal; loss "
        f"forward + "
        f"backward {m['loss_ms']:.3f} ms ({m['loss_items']} device items, "
        f"busy {100 * m['loss_busy']:.1f} %), decode {m['decode_ms']:.3f} "
        f"ms ({m['decode_items']} device items, busy "
        f"{100 * m['decode_busy']:.1f} %) on {card}")
    return m


def _grad_rel(got, want):
    """||got - want|| / ||want|| in float64 (0 where both are 0)."""
    import torch
    norm = torch.linalg.vector_norm
    diff = float(norm(got.double() - want.double()))
    return diff / float(norm(want.double())) if diff else 0.0


def _image_provider(config):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_image_provider",
        os.path.join(os.path.dirname(config), "provider.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.process


def image_step(model, dev):
    """One step of configs/image.py's ``model`` at B IMAGE_CHECK_B on the
    CPU and on ``dev`` from the same parameters: the two losses, each
    parameter's gradient against the CPU's in norm (``_grad_rel``), and
    the weights after one step of the config's optimizer."""
    import itertools
    import torch
    from paddle_tpu_torch.config.config_parser import parse_config
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.trainer.trainer import optimizer_from_config
    config = os.path.abspath(IMAGE_CONFIG)
    cfg, opt, ds = parse_config(config, f"model={model},batch_size="
                                        f"{IMAGE_CHECK_B}")
    net = NeuralNetwork(cfg)
    provider = _image_provider(config)
    samples = list(itertools.islice(provider.reader(**ds.args)(),
                                    IMAGE_CHECK_B))
    feeder = DataFeeder(list(zip(("data", "label"),
                                 provider.settings.input_types)))
    cpu_feed = feeder.convert(samples)
    cpu_params = net.init_params(seed=1, device="cpu")
    res = {}
    for where in ("cpu", dev):
        params = {n: p.to(where).requires_grad_(True)
                  for n, p in cpu_params.items()}
        loss, _ = net.loss(params, {k: v.to(where)
                                    for k, v in cpu_feed.items()},
                           is_training=False)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        rule = optimizer_from_config(opt)[0]
        stepped, _ = rule.apply(params, grads, rule.init_state(params))
        res[str(where)] = (float(loss.detach()),
                           {n: g.cpu() for n, g in grads.items()},
                           {n: v.detach().cpu() for n, v in stepped.items()})
    (l_cpu, g_cpu, w_cpu), (l_dev, g_dev, w_dev) = res["cpu"], res[str(dev)]
    rel = {k: _grad_rel(g_dev[k], v) for k, v in g_cpu.items()}
    w_max, w_share = 0.0, 0.0
    for k, v in w_cpu.items():
        diff = (w_dev[k] - v).abs()
        w_max = max(w_max, float(diff.max()))
        w_share = max(w_share, float((diff > 2e-5).float().mean()))
    worst = max(rel, key=rel.get)
    return {"loss": l_dev, "loss_cpu": l_cpu, "grad_rel": rel[worst],
            "grad_rel_param": worst, "weight_max": w_max,
            "weight_share_past_2e-5": w_share, "params": len(cpu_params),
            "lr": opt.learning_rate, "method": opt.learning_method}


def image_step_faults(m):
    """What of ``image_step``'s readings ``m`` breaks (c)'s gate."""
    out = []
    if not np.isfinite(m["loss"]) or abs(m["loss"] - m["loss_cpu"]) > \
            VAE_LOSS_RTOL * abs(m["loss_cpu"]):
        out.append(f"loss card {m['loss']} vs CPU {m['loss_cpu']}")
    if not m["grad_rel"] <= IMAGE_GRAD_REL:
        out.append(f"the gradient of {m['grad_rel_param']} "
                   f"{m['grad_rel']:.3e} of its norm from the CPU's (limit "
                   f"{IMAGE_GRAD_REL:g})")
    if m["weight_max"] > VAE_W_ATOL or m["weight_share_past_2e-5"] > 1e-3:
        out.append(f"after one {m['method']} step a weight "
                   f"{m['weight_max']:.2e} from the CPU's "
                   f"({m['weight_share_past_2e-5']:.2e} of a tensor past "
                   "2e-5)")
    return out


def phase_image_nets(dev, card):
    """Phase 4z-image (c): configs/image.py's smallnet, alexnet,
    googlenet and VGG-19: one step at B 4 card vs CPU, then `--job
    time` at the config's B 64 through the CLI, no kernel launched."""
    config = os.path.abspath(IMAGE_CONFIG)
    out = {}
    for model, timed in IMAGE_NETS.items():
        m = image_step(model, dev)
        faults = image_step_faults(m)
        if faults:
            fail(f"4z-image (c) {model}: " + "; ".join(faults))
        n = 3 + timed
        text, launches = run_cli(
            ["train", "--job", "time", "--config", config, "--config_args",
             f"model={model},num_samples={n * IMAGE_B}", "--test_period",
             str(timed)], {}, f"4z-image (c) {model}")
        tj = json.loads(text.strip().splitlines()[-1])
        m.update({"ms_per_batch": tj["ms_per_batch"],
                  "samples_per_s": tj["samples_per_sec"],
                  "batches": tj["batches"],
                  "launches": sum(launches.values())})
        out[model] = m
        log(f"  (c) {model}: B {IMAGE_CHECK_B} step loss card "
            f"{m['loss']:.6f} vs CPU {m['loss_cpu']:.6f}; the "
            f"{m['params']} gradients within {m['grad_rel']:.3e} of their "
            f"norms ({m['grad_rel_param']}; limit {IMAGE_GRAD_REL:g}); "
            f"after one {m['method']} step (lr {m['lr']:g}) the weights "
            f"within {m['weight_max']:.2e} "
            f"({m['weight_share_past_2e-5']:.2e} of a tensor past 2e-5); "
            f"--job time B {IMAGE_B}: {tj['ms_per_batch']} ms/batch, "
            f"{tj['samples_per_sec']} samples/s over {tj['batches']} "
            f"batches (fp32, TF32 off, {card}); the {len(launches)} launch "
            f"counters of the 22 kernels all {sum(launches.values())}")
    return out


def phase_image(dev, card):
    """Phase 4z-image: (a) the new types and ops card vs CPU, (b) SSD300's
    detection layers, (c) configs/image.py's nets through the CLI."""
    import torch
    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")
    m = {"types": phase_image_types(dev),
         "detection": phase_image_detection(dev, card),
         "nets": phase_image_nets(dev, card)}
    m["seconds"] = time.perf_counter() - t0
    log(f"  4z-image (a)-(c) took {m['seconds']:.1f} s")
    return m


# ------------------------------------------------------------ phase 4z-v2
#: the sentiment demo's net (demo/sentiment/train.py): emb 64,
#: stacked_lstm_net(hid_dim=64, stacked_num=3), B 32, Adam lr 2e-3; the
#: first V2_SENT_CHECK batches card against the CPU
V2_SENT = dict(emb=64, hid=64, stacked=3, b=32, lr=2e-3)
V2_SENT_CHECK = 4
#: record-file shards of the v2 pass: samples a shard
V2_SHARD = 512


def _v2_lstm_net(v2):
    """The LSTM row's net (``models/text.py::lstm_text_classifier``'s calls,
    in its order) through ``v2``, inside an open config scope:
    (cost, probs)."""
    data = v2.layer.data("data", v2.data_type.integer_value_sequence(
        TRAIN["vocab_size"]))
    net = v2.layer.embedding(data, size=TRAIN["embed_dim"])
    for i in range(TRAIN["lstm_num"]):
        net = v2.networks.simple_lstm(net, size=TRAIN["hidden_size"],
                                      name=f"lstm{i}")
    net = v2.layer.last_seq(net)
    probs = v2.layer.fc(net, size=TRAIN["num_classes"],
                        act=v2.activation.Softmax())
    label = v2.layer.data("label", v2.data_type.integer_value(
        TRAIN["num_classes"]))
    return v2.layer.classification_cost(probs, label), probs


def _cost_log(costs):
    def handle(e):
        if type(e).__name__ == "EndIteration":
            costs.append(e.cost)
    return handle


def _shard_order(samples, shard, seed=0):
    """The order ``download.convert`` writes ``samples`` in: each shard's
    buffer shuffled by one ``random.Random(seed)``."""
    import random
    rand, order = random.Random(seed), []
    for i in range(0, len(samples), shard):
        buf = list(samples[i:i + shard])
        rand.shuffle(buf)
        order += buf
    return order


def _timed(fn, dev):
    """(``fn()``, its wall in s between device syncs)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def phase_v2_full(dev):
    """Phase 4z-v2 (a): the LSTM row's net built and trained through
    ``paddle_tpu_torch.v2`` from record files, against ``Trainer.train``
    over the same samples in memory from the same parameters."""
    import dataclasses
    import io
    import tempfile

    import torch
    from paddle_tpu_torch import v2
    from paddle_tpu_torch.config.dsl import config_scope
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.core.sequence import value_of
    from paddle_tpu_torch.data import (DataFeeder, integer_value,
                                       integer_value_sequence, reader)
    from paddle_tpu_torch.data.download import convert
    from paddle_tpu_torch.evaluators import create_evaluator
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import lstm_text_classifier
    from paddle_tpu_torch.trainer.trainer import Trainer
    from paddle_tpu_torch.utils import FLAGS
    m = {}
    n_batches = LOOP_SAMPLES // TRAIN_B
    feeding = {"data": 0, "label": 1}
    with config_scope():
        cost, probs = _v2_lstm_net(v2)
        opt = v2.optimizer.Adam(
            learning_rate=TRAIN_OPT["learning_rate"],
            regularization=v2.optimizer.L2Regularization(
                TRAIN_OPT["l2_weight_decay"]),
            gradient_clipping_threshold=TRAIN_OPT[
                "gradient_clipping_threshold"])
        sgd = v2.trainer.SGD(cost, update_equation=opt, device=dev)
        want_cfg = lstm_text_classifier(**TRAIN)
        if sgd.model_config.to_json() != want_cfg.to_json():
            fail("4z-v2: the v2 net's ModelConfig differs from "
                 "lstm_text_classifier's")
        if dataclasses.asdict(opt.conf) != dataclasses.asdict(
                OptimizationConfig(**TRAIN_OPT)):
            fail(f"4z-v2: v2.optimizer.Adam gives {opt.conf}, not 4d's "
                 "OptimizationConfig")
        log("  the v2 net's ModelConfig is lstm_text_classifier's, "
            "v2.optimizer.Adam's OptimizationConfig is 4d's")
        if any(p.device != dev for p in sgd.core.params.values()):
            fail("4z-v2: a parameter of SGD is off the card")

        samples = loop_samples(LOOP_SAMPLES, TRAIN["vocab_size"],
                               LOOP_LENGTHS, 0)
        test_samples = loop_samples(LOOP_TEST_SAMPLES, TRAIN["vocab_size"],
                                    LOOP_LENGTHS, 1)
        order = _shard_order(samples, V2_SHARD)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_v2_") as tmp:
            shards, conv_s = _timed(lambda: convert(
                tmp, lambda: iter(samples), V2_SHARD, "lstm"), dev)
            rec = reader.recordio(shards)
            if list(rec()) != order:
                fail("4z-v2: reader.recordio does not give convert's order")
            ref = Trainer(NeuralNetwork(want_cfg),
                          OptimizationConfig(**TRAIN_OPT),
                          seed=sgd.core.seed, device=dev)
            params = sgd.parameters
            for name in params.names():
                params.set(name, ref.params[name])
            if any(p.device != dev or p.dtype != torch.float32
                   for p in sgd.core.params.values()):
                fail("4z-v2: Parameters.set moved a parameter off the "
                     "card or out of float32")
            feeder = DataFeeder([
                ("data", integer_value_sequence(TRAIN["vocab_size"])),
                ("label", integer_value(TRAIN["num_classes"]))])
            # a throwaway step first, so neither timed pass pays the
            # first launches
            Trainer(NeuralNetwork(want_cfg), OptimizationConfig(**TRAIN_OPT),
                    seed=1, device=dev).train_one_batch(
                        feeder.convert(order[:TRAIN_B]))
            old = {k: FLAGS.get(k) for k in ("log_period", "save_dir")}
            set_flags(log_period=1, save_dir="")
            try:
                want = []
                _, ref_s = _timed(lambda: ref.train(
                    reader.batch(reader.np_array(order), TRAIN_B), 1,
                    _cost_log(want), feeder), dev)
                got = []
                reset_counts()
                _, v2_s = _timed(lambda: sgd.train(
                    v2.reader.batch(rec, TRAIN_B), num_passes=1,
                    event_handler=_cost_log(got), feeding=feeding), dev)
                launches = read_counts()
            finally:
                set_flags(**old)
        check_launches(launches, {"lstm_fwd": 2 * n_batches,
                                  "lstm_bwd": 2 * n_batches},
                       "4z-v2 SGD.train")
        if len(got) != n_batches or got != want:
            fail(f"4z-v2: SGD.train's costs from record files differ from "
                 f"Trainer.train's in memory: {got[:4]} vs {want[:4]}")
        if not all(np.isfinite(got)):
            fail("4z-v2: a non-finite cost")
        log(f"  convert: {LOOP_SAMPLES} samples into {len(shards)} record "
            f"files in {conv_s * 1e3:.1f} ms; SGD.train from them: "
            f"{n_batches} costs bit-identical to Trainer.train's in memory "
            f"({got[0]:.6f} ... {got[-1]:.6f}); launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        log(f"  samples/s: v2 from record files {LOOP_SAMPLES / v2_s:.1f} "
            f"({v2_s * 1e3:.1f} ms), Trainer.train in memory "
            f"{LOOP_SAMPLES / ref_s:.1f} ({ref_s * 1e3:.1f} ms)")
        m.update(costs=got, launches=launches, convert_ms=conv_s * 1e3,
                 v2_samples_per_s=LOOP_SAMPLES / v2_s,
                 trainer_samples_per_s=LOOP_SAMPLES / ref_s)

        test_r = {k: reader.batch(reader.np_array(test_samples), TRAIN_B)
                  for k in ("v2", "ref")}
        got_t = sgd.test(test_r["v2"], feeding=feeding,
                         evaluators=[v2.evaluator.classification_error()])
        want_t = ref.test(test_r["ref"], feeder,
                          [create_evaluator("classification_error")])
        if got_t != want_t:
            fail(f"4z-v2: SGD.test {got_t} != Trainer.test {want_t}")
        batch = test_samples[:TRAIN_B]
        reset_counts()
        out = v2.infer(output_layer=probs, parameters=sgd.parameters,
                       input=[batch], feeding={"data": 0}, device=dev)
        inf_launches = read_counts()
        check_launches(inf_launches, {"lstm_fwd": 2}, "4z-v2 infer")
        with torch.no_grad():
            values, _ = sgd.network.forward(
                sgd.core.params, ref._place_feed(feeder.convert(batch)),
                sgd.core.buffers, is_training=False)
        plain = value_of(values[probs.name]).cpu().numpy()
        if out.shape != plain.shape or not np.array_equal(out, plain):
            fail("4z-v2: v2.infer differs from NeuralNetwork.forward in "
                 "eval mode")
        log(f"  SGD.test = Trainer.test ({got_t}); v2.infer = "
            f"NeuralNetwork.forward (eval) bit for bit, {out.shape}")
        m["test"] = got_t

        buf = io.BytesIO()
        sgd.parameters.to_tar(buf)
        buf.seek(0)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_v2_") as tmp:
            path = v2.model.save_model(v2.Parameters.from_tar(buf),
                                       os.path.join(tmp, "model.tar"))
            other = Trainer(NeuralNetwork(want_cfg),
                            OptimizationConfig(**TRAIN_OPT), seed=1,
                            device=dev)
            loaded = v2.Parameters()
            loaded.attach(other)
            v2.model.load_model(loaded, path)
            size = os.path.getsize(path)
        for name, p in sgd.core.params.items():
            q = other.params[name]
            if q.device != dev or q.dtype != p.dtype or \
                    not torch.equal(p, q):
                fail(f"4z-v2: {name} after to_tar -> from_tar -> "
                     "save_model -> load_model differs")
        log(f"  to_tar -> from_tar -> save_model -> load_model: "
            f"{len(sgd.core.params)} arrays byte-equal ({size} bytes)")
    return m


def phase_v2_sentiment(dev):
    """Phase 4z-v2 (b): the sentiment demo's net through ``paddle.v2``
    (the port's aliases) on the imdb surrogate, card against CPU, then a
    whole pass on the card."""
    import importlib
    import logging
    from paddle_tpu_torch import compat
    from paddle_tpu_torch.config.dsl import config_scope
    from paddle_tpu_torch.utils import FLAGS
    s = V2_SENT
    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Lines(logging.WARNING)
    logger = logging.getLogger("paddle_tpu_torch.dataset")
    logger.addHandler(handler)
    m = {}
    try:
        with compat.swapped():
            compat.install()
            paddle = importlib.import_module("paddle.v2")
            word_dict = paddle.dataset.imdb.word_dict()
            with config_scope():
                data = paddle.layer.data(
                    "word", paddle.data_type.integer_value_sequence(
                        len(word_dict)))
                label = paddle.layer.data(
                    "label", paddle.data_type.integer_value(2))
                emb = paddle.layer.embedding(data, size=s["emb"])
                lstm_last = paddle.layer.last_seq(
                    paddle.networks.stacked_lstm_net(
                        emb, hid_dim=s["hid"], stacked_num=s["stacked"]))
                probs = paddle.layer.fc(lstm_last, size=2,
                                        act=paddle.activation.Softmax())
                cost = paddle.layer.classification_cost(probs, label)
                sgds = {where: paddle.trainer.SGD(
                    cost, update_equation=paddle.optimizer.Adam(
                        learning_rate=s["lr"]), device=where)
                    for where in (dev, "cpu")}
                card, cpu = sgds[dev], sgds["cpu"]
                for name in card.parameters.names():
                    cpu.parameters.set(name, card.parameters.get(name))
                feeding = {"word": 0, "label": 1}

                def batches(n=None):
                    r = paddle.reader.batch(paddle.reader.shuffle(
                        paddle.dataset.imdb.train(word_dict), 2048, seed=0),
                        s["b"], drop_last=True)
                    return paddle.reader.firstn(r, n) if n else r

                first = next(iter(batches(1)()))
                reset_counts()
                outs = {w: paddle.infer(output_layer=probs,
                                        parameters=card.parameters,
                                        input=[first], feeding={"word": 0},
                                        device=w) for w in (dev, "cpu")}
                costs, check_s = {}, {}
                old = {k: FLAGS.get(k) for k in ("log_period", "save_dir")}
                set_flags(log_period=1, save_dir="")
                try:
                    for where, sgd in sgds.items():
                        costs[str(where)] = []
                        _, check_s[str(where)] = _timed(lambda: sgd.train(
                            batches(V2_SENT_CHECK), num_passes=1,
                            event_handler=_cost_log(costs[str(where)]),
                            feeding=feeding), dev)
                    check = read_counts()
                    reset_counts()
                    n_pass = []
                    _, pass_s = _timed(lambda: card.train(
                        batches(), num_passes=1,
                        event_handler=_cost_log(n_pass), feeding=feeding),
                        dev)
                    pass_launches = read_counts()
                    (busy, items), prof_s = _timed(
                        lambda: _profile_busy(lambda: card.train(
                            batches(1), num_passes=1,
                            event_handler=lambda e: None,
                            feeding=feeding)), dev)
                finally:
                    set_flags(**old)
    finally:
        logger.removeHandler(handler)
    if not any("imdb unavailable" in ln and "synthetic surrogate" in ln
               for ln in lines):
        fail(f"4z-v2 (b): the imdb loader did not log its surrogate: "
             f"{lines[:3]}")
    for what, counts in (("card vs CPU", check), ("the pass", pass_launches)):
        check_launches(counts, {}, f"4z-v2 (b) {what} (H {s['hid']}: the "
                       "reference's scan)")
    got, want = costs[str(dev)], costs["cpu"]
    worst = max(abs(g - w) / (LSTM_GRAD_ATOL + LSTM_GRAD_RTOL * abs(w))
                for g, w in zip(got, want))
    o_dev, o_cpu = outs[dev], outs["cpu"]
    inf_worst = float(np.max(np.abs(o_dev - o_cpu) / (
        LSTM_GRAD_ATOL + LSTM_GRAD_RTOL * np.abs(o_cpu))))
    log(f"  sentiment (V {len(word_dict)}, E {s['emb']}, "
        f"stacked_lstm_net H {s['hid']} x {s['stacked']}, B {s['b']}): the "
        f"imdb loader took its surrogate; first {V2_SENT_CHECK} costs card "
        f"{[round(c, 6) for c in got]}, CPU {[round(c, 6) for c in want]}: "
        f"worst {worst:.3f} of the tolerance; infer worst {inf_worst:.3f}; "
        "no launch of kernels 8 and 9")
    if len(got) != V2_SENT_CHECK or worst > 1.0 or inf_worst > 1.0:
        fail("4z-v2 (b): the card and the CPU disagree")
    if not all(np.isfinite(n_pass)):
        fail("4z-v2 (b): a non-finite cost in the pass")
    ms = pass_s * 1e3 / len(n_pass)
    log(f"  a whole pass on the card: {len(n_pass)} batches, "
        f"{ms:.3f} ms/batch ({pass_s:.2f} s); one profiled batch: busy "
        f"{busy * 100:.1f} %, {items} device items ({prof_s:.2f} s with "
        f"the profiler); the first {V2_SENT_CHECK} batches took "
        f"{check_s[str(dev)]:.2f} s on the card, {check_s['cpu']:.2f} s on "
        "the CPU")
    m.update(costs_card=got, costs_cpu=want, worst=worst,
             infer_worst=inf_worst, batches=len(n_pass), ms_per_batch=ms,
             busy=busy, device_items=items)
    return m


def phase_v2(dev):
    """Phase 4z-v2: (a) and (b), fp32 with TF32 off."""
    import torch
    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")
    m = {"full": phase_v2_full(dev)}
    t1 = time.perf_counter()
    m["sentiment"] = phase_v2_sentiment(dev)
    m["seconds"] = time.perf_counter() - t0
    log(f"  4z-v2 (a) took {t1 - t0:.1f} s, (b) "
        f"{m['seconds'] - (t1 - t0):.1f} s")
    return m


# ------------------------------------------------------------ phase 4z-fw
#: the book programs of phase 4z-fw (b): steps card against CPU
FW_BOOK_STEPS = 3
#: MNIST's images and the book's batch
FW_MNIST_B, FW_MNIST_SIDE = 64, 28


def _fw_lstm_row(fw, layers, opt):
    """The LSTM row's net as a Fluid program (ids -> embedding ->
    sequence_conv(4H, 1) -> lstm twice -> last step -> fc softmax ->
    cross entropy -> mean; Adam 2e-3): (cost, probs).  The ``fc`` 4H
    projection of the row is ``sequence_conv`` with filter size 1
    (context start 0, length 1, a bias): ``fc`` drops the LoD that
    ``lstm`` needs, in both packages."""
    h = TRAIN["hidden_size"]
    net = layers.embedding(layers.data("words", [TRAIN_T], "int64",
                                       lod_level=1),
                           [TRAIN["vocab_size"], TRAIN["embed_dim"]])
    for _ in range(TRAIN["lstm_num"]):
        net, _ = layers.lstm(layers.sequence_conv(net, 4 * h,
                                                  filter_size=1), h)
    probs = layers.fc(layers.sequence_pool(net, "LAST"),
                      TRAIN["num_classes"], act="softmax")
    cost = layers.mean(layers.cross_entropy(
        probs, layers.data("label", [1], "int64")))
    opt.AdamOptimizer(learning_rate=TRAIN_OPT["learning_rate"]).minimize(
        cost)
    return cost, probs


def _fw_scope_copy(scope, where):
    """A new framework scope with ``scope``'s values on ``where``."""
    from paddle_tpu_torch.framework import Scope
    out = Scope()
    for name, v in scope.vars.items():
        out.set(name, v.to(where))
    return out


def _fw_changes(main, p0, pd, pc):
    """The worst ||d_card - d_cpu|| / ||d_cpu|| over the program's
    parameters, d the change from ``p0``."""
    worst = 0.0
    for p in main.parameters():
        d_cpu = pc[p.name] - p0[p.name]
        d_dev = pd[p.name] - p0[p.name]
        worst = max(worst, float((d_dev - d_cpu).norm())
                    / max(float(d_cpu.norm()), 1e-30))
    return worst


def _fw_card_vs_cpu(main, startup, feeds, fetch, dev, what, steps):
    """``startup`` on the card, its values carried to a CPU scope, then
    ``steps`` runs of ``main`` on both from ``feeds(i, where)``: (worst
    fetch share of 4e's loss tolerance, worst parameter-change rel err,
    the card's fetches).  Counts set to 0 before, checked after: none
    of the port's kernels runs."""
    from paddle_tpu_torch.framework import Executor, Scope
    exe = {"card": Executor(place=dev), "cpu": Executor(place="cpu")}
    scopes = {"card": Scope()}
    reset_counts()
    exe["card"].run(startup, scope=scopes["card"])
    scopes["cpu"] = _fw_scope_copy(scopes["card"], "cpu")
    p0 = {n: v.cpu().clone() for n, v in scopes["cpu"].vars.items()}
    got = {k: [exe[k].run(main, feed=feeds(i, dev if k == "card" else
                                           "cpu"),
                          fetch_list=fetch, scope=scopes[k])
               for i in range(steps)] for k in ("card", "cpu")}
    check_launches(read_counts(), {}, f"4z-fw (b) {what}")
    share = 0.0
    for a, b in zip(got["card"], got["cpu"]):
        for x, y in zip(a, b):
            if not np.all(np.isfinite(x)) or x.shape != y.shape:
                fail(f"4z-fw (b) {what}: a non-finite or misshapen fetch")
            share = max(share, float(np.max(np.abs(x - y) / (
                LSTM_GRAD_ATOL + LSTM_GRAD_RTOL * np.abs(y)))))
    perr = _fw_changes(main, p0, {n: v.cpu() for n, v in
                                  scopes["card"].vars.items()},
                       scopes["cpu"].vars) if main.parameters() else 0.0
    return share, perr, got["card"]


def _fw_book(dev):
    """Phase 4z-fw (b): the book programs of ``tests/test_framework.py``
    card against CPU from the card's startup values."""
    from paddle_tpu_torch import framework as fw
    from paddle_tpu_torch.framework import layers, nets
    from paddle_tpu_torch.framework import optimizer as opt
    rng = np.random.RandomState(0)
    res = {}

    def build(fn):
        main, startup = fw.Program(), fw.Program()
        with fw.program_guard(main, startup):
            out = fn()
        return main, startup, out

    def fit_a_line():
        x, y = layers.data("x", [13]), layers.data("y", [1])
        cost = layers.mean(layers.square_error_cost(layers.fc(x, 1), y))
        opt.SGDOptimizer(learning_rate=0.01).minimize(cost)
        return [cost]

    def mnist_mlp():
        img = layers.data("img", [FW_MNIST_SIDE * FW_MNIST_SIDE])
        label = layers.data("label", [1], "int64")
        h = layers.fc(layers.fc(img, 128, act="relu"), 64, act="relu")
        probs = layers.fc(h, 10, act="softmax")
        cost = layers.mean(layers.cross_entropy(probs, label))
        acc = layers.accuracy(probs, label)
        opt.MomentumOptimizer(learning_rate=0.001, momentum=0.9).minimize(
            cost)
        return [cost, acc]

    def mnist_conv():
        img = layers.data("img", [1, FW_MNIST_SIDE, FW_MNIST_SIDE])
        label = layers.data("label", [1], "int64")
        net = img
        for filters in (20, 50):
            net = nets.simple_img_conv_pool(net, num_filters=filters,
                                            filter_size=5, pool_size=2,
                                            pool_stride=2, act="relu")
        probs = layers.fc(net, 10, act="softmax")
        cost = layers.mean(layers.cross_entropy(probs, label))
        acc = layers.accuracy(probs, label)
        opt.AdamOptimizer(learning_rate=0.01).minimize(cost)
        return [cost, acc]

    def static_rnn():
        seq, tgt = layers.data("seq", [4, 2]), layers.data("tgt", [3])
        rnn = layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(seq)
            mem = rnn.memory(batch_ref=seq, shape=(-1, 3), init_value=0.0)
            nxt = layers.fc([xt, mem], size=3, act="tanh")
            rnn.update_memory(mem, nxt)
            rnn.output(nxt)
        pred = layers.fc(layers.reshape(rnn(), [-1, 12]), size=3)
        cost = layers.mean(layers.square_error_cost(pred, tgt))
        opt.SGDOptimizer(learning_rate=0.1).minimize(cost)
        return [cost]

    def cond():
        x, pred = layers.data("x", [3]), layers.data("pred", [1])
        main = fw.default_main_program()
        idx = []
        for scale in (2.0, -1.0):
            blk = main.create_block()
            with main.block_guard(blk):
                out = blk.create_var(name="cond_out", shape=(-1, 3))
                tmp = blk.create_var(shape=(-1, 3))
                blk.append_op("scale", inputs={"X": [x]},
                              outputs={"Out": [tmp]},
                              attrs={"scale": scale})
                blk.append_op("elementwise_add",
                              inputs={"X": [tmp], "Y": [x]},
                              outputs={"Out": [out]})
            idx.append(blk.idx)
        out = main.global_block.create_var(name="cond_out", shape=(-1, 3))
        main.global_block.append_op(
            "cond", inputs={"Cond": [pred]}, outputs={"Out": [out]},
            attrs={"true_block": idx[0], "false_block": idx[1]})
        return [out]

    w_line = rng.randn(13, 1).astype(np.float32)
    protos = rng.randn(10, FW_MNIST_SIDE * FW_MNIST_SIDE).astype(np.float32)

    def on(where, **arrays):
        import torch
        return {k: torch.from_numpy(v).to(where) for k, v in arrays.items()}

    def line_feed(i, where):
        r = np.random.RandomState(100 + i)
        x = r.randn(32, 13).astype(np.float32)
        return on(where, x=x, y=x @ w_line)

    def mnist_feed(i, where, flat=True):
        r = np.random.RandomState(200 + i)
        lab = r.randint(0, 10, (FW_MNIST_B, 1))
        img = np.tanh(protos[lab[:, 0]] + r.randn(
            FW_MNIST_B, FW_MNIST_SIDE * FW_MNIST_SIDE)).astype(np.float32)
        if not flat:
            img = img.reshape(FW_MNIST_B, 1, FW_MNIST_SIDE, FW_MNIST_SIDE)
        return on(where, img=img, label=lab.astype(np.int64))

    def rnn_feed(i, where):
        r = np.random.RandomState(300 + i)
        x = r.randn(8, 4, 2).astype(np.float32)
        return on(where, seq=x, tgt=np.tanh(x.sum(1))[:, :1].repeat(
            3, 1).astype(np.float32))

    def cond_feed(i, where):
        x = np.arange(6, dtype=np.float32).reshape(2, 3) + i
        return on(where, x=x, pred=np.full((2, 1), 1.0 if i % 2 == 0
                                           else -1.0, np.float32))

    for name, fn, feeds in (
            ("fit_a_line", fit_a_line, line_feed),
            ("mnist_mlp", mnist_mlp, mnist_feed),
            ("mnist_conv", mnist_conv,
             lambda i, w: mnist_feed(i, w, flat=False)),
            ("static_rnn", static_rnn, rnn_feed),
            ("cond", cond, cond_feed)):
        main, startup, fetch = build(fn)
        share, perr, card = _fw_card_vs_cpu(main, startup, feeds, fetch, dev,
                                            name, FW_BOOK_STEPS)
        log(f"  (b) {name}: {FW_BOOK_STEPS} runs card vs CPU, fetches "
            f"{[round(float(np.ravel(f)[0]), 6) for f in card[-1]]}, worst "
            f"{share:.3f} of 4e's loss tolerance; parameter-change rel "
            f"err {perr:.2e} (limit {OPT_PARAM_RTOL})")
        if share > 1.0 or perr > OPT_PARAM_RTOL:
            fail(f"4z-fw (b) {name}: the card and the CPU disagree")
        if name == "cond":
            x = cond_feed(1, "cpu")["x"].numpy()
            if not np.array_equal(card[1][0], 0 * x) or not np.array_equal(
                    card[0][0], 3 * cond_feed(0, "cpu")["x"].numpy()):
                fail("4z-fw (b) cond: a branch gave the wrong output")
        res[name] = {"fetch_share": share, "param_rel_err": perr}
    return res


def phase_fw_row(dev, step_ms):
    """Phase 4z-fw (a): the LSTM row's net as a Fluid program on the
    card: startup and main on the card; 2 Adam steps against the CPU
    plain path from the card's startup values, each step exactly 2
    launches each of kernels 8 and 9; an ``is_test`` run of the pruned
    program 2 of kernel 8 and none of 9; ``save_inference_model`` ->
    ``load_inference_model`` bit for bit; then 3 warm and
    ``TIMED_STEPS`` timed steps (CUDA events; memory flat), one profiled
    step."""
    import tempfile

    import torch
    from paddle_tpu_torch import framework as fw
    from paddle_tpu_torch.framework import io as fio
    from paddle_tpu_torch.framework import layers
    from paddle_tpu_torch.framework import optimizer as opt
    m = {}
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup):
        cost, probs = _fw_lstm_row(fw, layers, opt)
    infer = main.prune([probs.name])
    exe, scope = fw.Executor(place=dev), fw.Scope()
    if exe.place != dev:
        fail(f"4z-fw: Executor(place={dev}) runs on {exe.place}")
    exe.run(startup, scope=scope)
    if sorted(scope.vars) != sorted(p.name for p in main.parameters()) \
            or any(v.device != dev for v in scope.vars.values()):
        fail("4z-fw: the startup program's values are not all on the card")
    raw = train_feed(0, TRAIN_B, TRAIN_T, TRAIN["vocab_size"], dev)
    feed = {"words": raw["data"], "label": raw["label"]}
    cpu_feed = {"words": raw["data"].to("cpu"), "label": raw["label"].cpu()}
    cpu_scope = _fw_scope_copy(scope, "cpu")
    p0 = {n: v.cpu().clone() for n, v in scope.vars.items()}

    # 2 Adam steps on the card, each exactly 2 + 2 launches, and on the
    # CPU plain path from the same startup values
    card_costs = []
    for i in range(2):
        reset_counts()
        card_costs += exe.run(main, feed=feed, fetch_list=[cost],
                              scope=scope)
        check_launches(read_counts(), {"lstm_fwd": 2, "lstm_bwd": 2},
                       f"4z-fw training step {i}")
    exe_cpu = fw.Executor(place="cpu")
    cpu_costs, cpu_s = _timed(lambda: [
        exe_cpu.run(main, feed=cpu_feed, fetch_list=[cost],
                    scope=cpu_scope)[0] for _ in range(2)], dev)
    card_costs = [float(c) for c in card_costs]
    cpu_costs = [float(c) for c in cpu_costs]
    share = max(abs(a - b) / (LSTM_GRAD_ATOL + LSTM_GRAD_RTOL * abs(b))
                for a, b in zip(card_costs, cpu_costs))
    perr = _fw_changes(main, p0, {n: v.cpu() for n, v in scope.vars.items()},
                       cpu_scope.vars)
    log(f"  (a) 2 Adam steps card vs CPU plain path: costs card "
        f"{[round(c, 7) for c in card_costs]}, CPU "
        f"{[round(c, 7) for c in cpu_costs]} ({share:.3f} of 4e's loss "
        f"tolerance); parameter-change rel err {perr:.2e} (limit "
        f"{OPT_PARAM_RTOL}); the CPU's 2 steps {cpu_s:.1f} s; exactly 2 + 2 "
        "launches of kernels 8 and 9 each card step")
    if not all(np.isfinite(card_costs)) or share > 1.0 \
            or perr > OPT_PARAM_RTOL:
        fail("4z-fw (a): the card and the CPU plain path disagree")
    m.update(costs_card=card_costs, costs_cpu=cpu_costs, cost_share=share,
             param_rel_err=perr, cpu_two_steps_s=cpu_s)
    del cpu_scope

    # the pruned program in eval mode, and the inference model's round trip
    reset_counts()
    want, = exe.run(infer, feed=feed, fetch_list=[probs], scope=scope,
                    is_test=True)
    check_launches(read_counts(), {"lstm_fwd": 2}, "4z-fw is_test run")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fw_") as tmp:
        fio.save_inference_model(tmp, ["words"], [probs], exe,
                                 main_program=main, scope=scope)
        loaded = fw.Scope()
        prog, feeds, fetches = fio.load_inference_model(tmp, exe, loaded)
        got, = exe.run(prog, feed={"words": feed["words"]},
                       fetch_list=fetches, scope=loaded, is_test=True)
        size = sum(os.path.getsize(os.path.join(tmp, f))
                   for f in os.listdir(tmp))
    if feeds != ["words"] or any(v.device != dev
                                 for v in loaded.vars.values()) \
            or got.shape != (TRAIN_B, TRAIN["num_classes"]) \
            or not np.array_equal(got, want):
        fail("4z-fw: save_inference_model -> load_inference_model does not "
             "give the same output on the card bit for bit")
    log(f"  is_test run of the pruned program: 2 launches of kernel 8, "
        f"none of 9; save_inference_model -> load_inference_model ({size} "
        f"bytes) gives its {got.shape} output bit for bit")

    # the timed steps
    for _ in range(WARM_STEPS):
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                return_numpy=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
            return_numpy=False)
    torch.cuda.synchronize()
    peak_one = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    t0 = time.perf_counter()
    start.record()
    losses, held = [], []
    for _ in range(TIMED_STEPS):
        losses += exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                          return_numpy=False)
        held.append(torch.cuda.memory_allocated())
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    ms = start.elapsed_time(end) / TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    check_launches(launches, {"lstm_fwd": 2 * TIMED_STEPS,
                              "lstm_bwd": 2 * TIMED_STEPS},
                   "4z-fw timed steps")
    if not all(np.isfinite(losses)):
        fail("4z-fw: a non-finite cost in the timed steps")
    slack = 16 * 2 ** 20
    if max(held) - min(held) > slack or peak > peak_one + slack:
        fail(f"4z-fw: device memory grows across the timed steps (held "
             f"{min(held)}..{max(held)} bytes, peak {peak} against one "
             f"step's {peak_one}): a run keeps an earlier run's graph")
    busy, items = _profile_busy(lambda: exe.run(
        main, feed=feed, fetch_list=[cost], scope=scope, return_numpy=False))
    log(f"  (a) {TIMED_STEPS} timed steps: {ms:.3f} ms/step (CUDA events), "
        f"{TRAIN_B * 1e3 / ms:.1f} samples/s, host wall "
        f"{wall * 1e3 / TIMED_STEPS:.3f} ms/step, beside 4d's "
        f"{step_ms:.3f} ms/step in this call; memory held after each step "
        f"{min(held) / 1e9:.3f}-{max(held) / 1e9:.3f} GB, peak "
        f"{peak / 1e9:.3f} GB (one step alone {peak_one / 1e9:.3f}); one "
        f"profiled step busy {busy * 100:.1f} %, {items} device items; "
        f"launches { {k: v for k, v in launches.items() if v} }; costs "
        f"{losses[0]:.6f} ... {losses[-1]:.6f}")
    m.update(ms_per_step=ms, samples_per_s=TRAIN_B * 1e3 / ms,
             host_wall_ms_per_step=wall * 1e3 / TIMED_STEPS,
             step_ms_4d=step_ms, held_bytes=[min(held), max(held)],
             peak_bytes=peak, peak_one_step_bytes=peak_one, busy=busy,
             device_items=items, losses=losses,
             launches={k: v for k, v in launches.items() if v})
    return m


def phase_fw(dev, step_ms):
    """Phase 4z-fw: (a) and (b), fp32 with TF32 off."""
    import torch
    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")
    m = {"row": phase_fw_row(dev, step_ms)}
    t1 = time.perf_counter()
    m["book"] = _fw_book(dev)
    m["seconds"] = time.perf_counter() - t0
    log(f"  4z-fw (a) took {t1 - t0:.1f} s, (b) "
        f"{m['seconds'] - (t1 - t0):.1f} s")
    return m


# ----------------------------------------------------------- phase 4z-obs
#: phase 4z-obs: one pass of Trainer.train over OBS_SAMPLES raw samples
#: (4z-loop's reader: lengths LOOP_LENGTHS, seed 0) at 4d's width, with
#: the telemetry off and then with every sink on; OBS_TIMED steps each
#: way for the speed reading
OBS_SAMPLES, OBS_TIMED = 1024, 20
#: the CUDA runtime calls that make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cudaMemcpy3D", "cudaMemcpyFromSymbol", "cudaMemcpyToSymbol")
#: host-synchronizing CUDA runtime calls in one step of the LSTM row
#: (4d's trainer and feed, telemetry off) on the parent tree, counted by
#: tools/step_syncs.py beside this tree's on the same card (PERF.md)
PARENT_STEP_SYNCS = 0


def step_sync_calls(trainer, feed):
    """The host-synchronizing CUDA runtime calls (``SYNC_CALLS``) made
    inside one ``trainer.train_one_batch(feed)``, by name, from a
    ``torch.profiler`` trace of the step, and the kernel launch calls
    traced in it (to show the runtime's calls were traced at all)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("ptpu_counted_step"):
            trainer.train_one_batch(feed)
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    (rng,) = [e for e in evs if e.name == "ptpu_counted_step"]
    t0, t1 = rng.time_range.start, rng.time_range.end
    inside = [e for e in evs if t0 <= e.time_range.start <= t1]
    syncs = sorted(e.name for e in inside if e.name in SYNC_CALLS)
    launches = sum(1 for e in inside if "LaunchKernel" in e.name)
    return syncs, launches


def _obs_free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _obs_get(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read().decode()


def _obs_prom_value(text, series):
    """The value of one exact series line of a Prometheus text."""
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.split(" ")[-1])
    fail(f"4z-obs: /metrics has no series {series}")


def _obs_pass(dev, samples, costs_of):
    """One ``Trainer.train`` pass of a fresh 4d trainer (seed 0) over
    ``samples`` at the flags set; every launch count set to 0 just
    before it: (trainer, launches, pass wall s); each step's cost is
    appended to ``costs_of`` as one list."""
    import torch
    trainer, feeder, train_r, _ = loop_setup(TRAIN, dev, TRAIN_B, samples,
                                             samples[:TRAIN_B])
    costs = []

    def handle(e):
        if type(e).__name__ == "EndIteration":
            costs.append(e.cost)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer.train(train_r, 1, handle, feeder)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    costs_of.append(costs)
    return trainer, read_counts(), wall


def _obs_spans(path, n_batches):
    """Phase 4z-obs (a)'s trace gates on the Chrome trace file: one
    ``train_pass``; under it ``n_batches`` ``train_step`` spans, each the
    parent of one ``feed``, one ``step_dispatch`` and one ``fence``; the
    ``input_wait`` spans and the pipeline's ``pipeline_read`` /
    ``pipeline_convert`` spans under the pass too.  Returns span counts
    by name."""
    with open(path) as f:
        events = json.load(f)
    if not all(e.get("ph") == "X" and {"ts", "dur", "pid", "tid", "name"}
               <= set(e) for e in events):
        fail("4z-obs (a): the trace file is not a Chrome trace of complete "
             "events")
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    passes = by.get("train_pass", [])
    if len(passes) != 1:
        fail(f"4z-obs (a): {len(passes)} train_pass spans, expected 1")
    pass_id = passes[0]["args"]["span_id"]
    steps = by.get("train_step", [])
    if len(steps) != n_batches or any(
            s["args"].get("parent_id") != pass_id for s in steps):
        fail(f"4z-obs (a): {len(steps)} train_step spans, expected "
             f"{n_batches} under the pass")
    for s in steps:
        kids = sorted(e["name"] for e in events
                      if e["args"].get("parent_id") == s["args"]["span_id"])
        if kids != ["feed", "fence", "step_dispatch"]:
            fail(f"4z-obs (a): a train_step's children are {kids}")
    for name in ("pipeline_read", "pipeline_convert", "input_wait"):
        got = by.get(name, [])
        if len(got) < n_batches or any(
                e["args"].get("parent_id") != pass_id for e in got):
            fail(f"4z-obs (a): {len(got)} {name} spans, not all under the "
                 "pass")
    return {k: len(v) for k, v in sorted(by.items())}


def phase_obs_sinks(dev, tmp):
    """Phase 4z-obs (a): one pass with the telemetry off, one with
    --metrics_jsonl, --trace_jsonl and --metrics_port (loopback) on."""
    import torch
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.observe import dump, trace
    from paddle_tpu_torch.observe import memory as omem
    from paddle_tpu_torch.utils import FLAGS
    from paddle_tpu_torch.utils.stat import global_stat
    samples = loop_samples(OBS_SAMPLES, TRAIN["vocab_size"], LOOP_LENGTHS, 0)
    n = OBS_SAMPLES // TRAIN_B
    keys = ("prefetch_depth", "log_period", "save_dir", "metrics_jsonl",
            "trace_jsonl", "metrics_port", "metrics_interval_s")
    old = {k: FLAGS.get(k) for k in keys}
    m, costs = {}, []
    try:
        set_flags(prefetch_depth=2, log_period=1, save_dir="")
        observe.REGISTRY.reset()
        global_stat.reset()
        if observe.active() or trace.enabled():
            fail("4z-obs (a): telemetry is on before the off pass")
        tr_off, l_off, w_off = _obs_pass(dev, samples, costs)
        del tr_off
        blocked = observe.REGISTRY.histogram("train_device_blocked_seconds")
        m["off"] = {"pass_s": w_off, "blocked_count": blocked.count()}
        if blocked.count() != 0:
            fail(f"4z-obs (a) off: {blocked.count()} fenced steps")
        observe.REGISTRY.reset()
        global_stat.reset()
        port = _obs_free_port()
        sink, tr_path = (os.path.join(tmp, "metrics.jsonl"),
                         os.path.join(tmp, "trace.json"))
        set_flags(metrics_jsonl=sink, trace_jsonl=tr_path, metrics_port=port,
                  metrics_interval_s=3600.0)
        trainer, l_on, w_on = _obs_pass(dev, samples, costs)
        blocked = observe.REGISTRY.histogram("train_device_blocked_seconds")
        m["on"] = {"pass_s": w_on, "blocked_count": blocked.count(),
                   "blocked_p50_ms": 1e3 * blocked.sample_quantile(0.5),
                   "step_p50_ms": 1e3 * observe.REGISTRY.histogram(
                       "train_step_seconds").sample_quantile(0.5)}
        if blocked.count() != n:
            fail(f"4z-obs (a) on: {blocked.count()} fenced steps, expected "
                 f"{n}")
        if costs[0] != costs[1] or len(costs[0]) != n:
            fail(f"4z-obs (a): costs differ off and on: {costs}")
        want = {"lstm_fwd": 2 * n, "lstm_bwd": 2 * n}
        check_launches(l_off, want, "4z-obs (a) off")
        check_launches(l_on, want, "4z-obs (a) on")
        # the endpoint: the dispatch decisions, the HBM gauge at a sample
        snap = omem.sample(trainer)
        allocated = torch.cuda.memory_allocated()
        code, text = _obs_get(port, "/metrics")
        rnn = _obs_prom_value(
            text, 'rnn_dispatch_total{kind="lstm",path="fused",reason=""}')
        hbm = _obs_prom_value(text, "hbm_in_use_bytes")
        if code != 200 or rnn != 2 * n or int(hbm) != allocated \
                or snap["in_use_bytes"] != allocated:
            fail(f"4z-obs (a) /metrics: code {code}, rnn_dispatch_total "
                 f"fused {rnn} (expected {2 * n}), hbm_in_use_bytes {hbm} "
                 f"against torch.cuda.memory_allocated() {allocated}")
        code, body = _obs_get(port, "/healthz")
        if code != 200 or json.loads(body)["status"] != "ok":
            fail(f"4z-obs (a) /healthz: {code} {body[:200]}")
        prom, dumped = dump.debug_dump(os.path.join(tmp, "dump"))
        with open(prom) as f:
            prom_text = f.read()
        with open(dumped) as f:
            ring = json.load(f)
        if "\ntrain_steps " not in prom_text or not any(
                e["name"] == "train_step" for e in ring):
            fail("4z-obs (a): the debug dump lacks the steps")
        observe.stop_global()       # final JSONL line, closes the trace
        with open(sink) as f:
            lines = f.read().splitlines()
        last = json.loads(lines[-1])
        steps = [s["value"] for mm in last["metrics"]
                 if mm["name"] == "train_steps" for s in mm["samples"]]
        if steps != [n]:
            fail(f"4z-obs (a): the last JSONL line's train_steps {steps}, "
                 f"expected [{n}]")
        spans = _obs_spans(tr_path, n)
        m["launches"] = l_on
        m["on"].update(spans=spans, hbm_in_use_bytes=allocated,
                       hbm_peak_bytes=snap["peak_bytes"],
                       categories=snap["categories"],
                       jsonl_lines=len(lines),
                       trace_bytes=os.path.getsize(tr_path),
                       dump_events=len(ring))
        log(f"  (a) {n} batches a pass: costs bit-identical off and on "
            f"({[round(c, 6) for c in costs[0][:4]]}...), launches "
            f"{want} each pass; fenced steps off 0, on {n} (p50 blocked "
            f"{m['on']['blocked_p50_ms']:.3f} ms of a "
            f"{m['on']['step_p50_ms']:.3f} ms step); pass wall off "
            f"{w_off:.3f} s, on {w_on:.3f} s")
        log(f"  (a) JSONL {len(lines)} lines, the last's train_steps {n}; "
            f"trace {m['on']['trace_bytes']} bytes, spans {spans}; "
            f"/metrics rnn_dispatch_total fused {int(rnn)}, "
            f"hbm_in_use_bytes {int(hbm)} = memory_allocated, categories "
            f"{snap['categories']}; /healthz ok; dump {len(ring)} events")
        return m, trainer
    finally:
        observe.stop_global()
        set_flags(**old)


def phase_obs_syncs(trainer, feed, tmp):
    """Phase 4z-obs (b): host-synchronizing runtime calls of one step
    with the telemetry off, then with a metrics sink on."""
    from paddle_tpu_torch import observe
    for _ in range(2):
        trainer.train_one_batch(feed)
    off, off_launches = step_sync_calls(trainer, feed)
    observe.attach(os.path.join(tmp, "syncs.jsonl"), interval_s=3600.0)
    try:
        on, on_launches = step_sync_calls(trainer, feed)
    finally:
        observe.stop_global()
    log(f"  (b) one step's synchronizing runtime calls: off {len(off)} "
        f"{off}, on {len(on)} {on}; launch calls traced off "
        f"{off_launches}, on {on_launches}; the parent tree's "
        f"{PARENT_STEP_SYNCS}")
    if not off_launches or not on_launches:
        fail("4z-obs (b): the profile traced no launch call")
    extra = list(on)
    for name in off:
        if name in extra:
            extra.remove(name)
    if len(on) != len(off) + 1 or extra != ["cudaEventSynchronize"]:
        fail(f"4z-obs (b): telemetry on makes {len(on)} syncs against "
             f"{len(off)} off; expected exactly one more, the fence's "
             "cudaEventSynchronize")
    if PARENT_STEP_SYNCS is not None and len(off) != PARENT_STEP_SYNCS:
        fail(f"4z-obs (b): {len(off)} syncs a step off, the parent's "
             f"{PARENT_STEP_SYNCS}")
    return {"off": off, "on": on, "parent": PARENT_STEP_SYNCS}


def phase_obs_speed(trainer, feed, step, tmp):
    """Phase 4z-obs (c): OBS_TIMED steps with the telemetry off, then
    with the metrics sink, the trace file and the endpoint on; and the
    cost of a span off and into the ring (readings, not gates)."""
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.observe import http as ohttp
    from paddle_tpu_torch.observe import trace
    _, _, ms_off, wall_off, _ = timed_steps(trainer, feed, OBS_TIMED)
    observe.attach(os.path.join(tmp, "speed.jsonl"), interval_s=3600.0)
    trace.enable(jsonl_path=os.path.join(tmp, "speed.trace.json"))
    srv = ohttp.ObservabilityServer(port=0).start()
    try:
        launches, _, ms_on, wall_on, _ = timed_steps(trainer, feed,
                                                     OBS_TIMED)
    finally:
        srv.stop()
        observe.stop_global()
    check_launches(launches, {"lstm_fwd": 2 * OBS_TIMED,
                              "lstm_bwd": 2 * OBS_TIMED}, "4z-obs (c) on")
    n_off, n_on = 200000, 20000
    t0 = time.perf_counter()
    for _ in range(n_off):
        with trace.span("x"):
            pass
    span_off_ns = (time.perf_counter() - t0) / n_off * 1e9
    trace.enable(ring_size=4096)
    t0 = time.perf_counter()
    for _ in range(n_on):
        with trace.span("x"):
            pass
    span_on_ns = (time.perf_counter() - t0) / n_on * 1e9
    trace.disable()
    m = {"off_ms_per_step": ms_off, "on_ms_per_step": ms_on,
         "off_host_wall_ms": wall_off, "on_host_wall_ms": wall_on,
         "step_4d_ms": step["ms_per_step"],
         "span_off_ns": span_off_ns, "span_ring_ns": span_on_ns}
    log(f"  (c) {OBS_TIMED} steps: off {ms_off:.3f} ms/step (host wall "
        f"{wall_off:.3f}), on {ms_on:.3f} ms/step (host wall "
        f"{wall_on:.3f}), {100 * (ms_on / ms_off - 1):+.1f} %; 4d "
        f"{step['ms_per_step']:.3f}; a span off {span_off_ns:.0f} ns, into "
        f"the ring {span_on_ns:.0f} ns")
    return m


def phase_obs_profile(trainer, feed, tmp):
    """Phase 4z-obs (d): ``utils.profiler.trace`` around 2 steps with
    the spans on: the exported Chrome trace holds 2 ``train_step``
    ranges and the 2 + 2 launches of kernels 8 and 9 a step inside
    them."""
    import torch
    from paddle_tpu_torch.observe import trace
    from paddle_tpu_torch.utils import profiler
    trace.enable(ring_size=4096, fences=False)
    try:
        torch.cuda.synchronize()
        with profiler.trace(os.path.join(tmp, "prof")) as path:
            # one small kernel, waited for, before the steps, so that the
            # window's device tracing is live before the first step's
            # launches (an unprimed window once held 3 of kernel 8's 4
            # records)
            torch.ones(1, device=feed["label"].device).add_(1)
            torch.cuda.synchronize()
            for _ in range(2):
                trainer.train_one_batch(feed)
            torch.cuda.synchronize()
    finally:
        trace.disable()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    cpu_steps = [e for e in events if e.get("name") == "train_step"
                 and e.get("cat") == "user_annotation"]
    gpu_steps = [e for e in events if e.get("name") == "train_step"
                 and e.get("cat") == "gpu_user_annotation"]
    runtime = {e["args"].get("correlation"): e for e in events
               if e.get("cat") == "cuda_runtime" and "args" in e}
    found = {}
    for label in ("kernel 8", "kernel 9"):
        mark = LSTM_PROFILE_MARKS[label]
        kern = [e for e in events if e.get("cat") == "kernel"
                and mark in e.get("name", "")]
        inside = 0
        for k in kern:
            launch = runtime.get(k.get("args", {}).get("correlation"))
            if launch is not None:
                ok = any(s["ts"] <= launch["ts"] <= s["ts"] + s["dur"]
                         for s in cpu_steps)
            else:
                ok = any(s["ts"] <= k["ts"] and k["ts"] + k["dur"]
                         <= s["ts"] + s["dur"] for s in gpu_steps)
            inside += ok
        found[label] = (len(kern), inside)
    cats = sorted({e.get("cat", "") for e in events})
    log(f"  (d) {os.path.getsize(path)} bytes, train_step ranges: host "
        f"{len(cpu_steps)}, device {len(gpu_steps)}; kernels 8 and 9 "
        f"(launched, inside a train_step): {found}; categories {cats}")
    if len(cpu_steps) != 2:
        fail(f"4z-obs (d): {len(cpu_steps)} train_step ranges, expected 2")
    for label, (k, inside) in found.items():
        if k != 4 or inside != 4:
            fail(f"4z-obs (d): {label}: {k} launches, {inside} inside a "
                 "train_step range; expected 4 and 4")
    return {"train_step_ranges": len(cpu_steps),
            "device_ranges": len(gpu_steps), "kernels": found,
            "trace_bytes": os.path.getsize(path)}


def phase_obs_timer(trainer, feed):
    """Phase 4z-obs (e): ``global_stat.timer(..., block_on=...)`` around
    one step reads at least the step's CUDA-event span."""
    import torch
    from paddle_tpu_torch.utils.stat import global_stat
    global_stat.reset()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = {}
    with global_stat.timer("obs_step", block_on=out):
        start.record()
        out["loss"] = trainer.train_one_batch(feed)
        end.record()
    timer_ms = global_stat.item("obs_step").total * 1e3
    end.synchronize()
    ev_ms = start.elapsed_time(end)
    log(f"  (e) the timer with block_on reads {timer_ms:.3f} ms, the "
        f"step's CUDA events {ev_ms:.3f} ms")
    if not timer_ms >= ev_ms:
        fail(f"4z-obs (e): the timer read {timer_ms:.3f} ms, under the "
             f"event-timed {ev_ms:.3f} ms")
    return {"timer_ms": timer_ms, "event_ms": ev_ms}


def phase_obs(dev, step):
    """Phase 4z-obs: the telemetry core around the LSTM row at 4d's
    width (fp32): (a) sinks off and on, (b) synchronizations a step, (c)
    speed, (d) a profiler window, (e) the blocking timer; ``step`` is
    4d's metrics."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        m, trainer = phase_obs_sinks(dev, tmp)
        feed = train_feed(0, TRAIN_B, TRAIN_T, TRAIN["vocab_size"], dev)
        m["syncs"] = phase_obs_syncs(trainer, feed, tmp)
        m["speed"] = phase_obs_speed(trainer, feed, step, tmp)
        m["profile"] = phase_obs_profile(trainer, feed, tmp)
        m["timer"] = phase_obs_timer(trainer, feed)
        del trainer
    m["seconds"] = time.perf_counter() - t0
    log(f"  4z-obs took {m['seconds']:.1f} s")
    return m


def _same_net(a, b, rename):
    """ModelConfig ``a`` equals ``b`` with ``b``'s layer names mapped by
    ``rename``, in any order of the layers."""
    def norm(cfg, names):
        d = json.loads(cfg.to_json())
        for lc in d["layers"]:
            lc["name"] = names.get(lc["name"], lc["name"])
            for inp in lc.get("inputs", []):
                inp["input_layer_name"] = names.get(
                    inp["input_layer_name"], inp["input_layer_name"])
        d["layers"] = {lc["name"]: lc for lc in d["layers"]}
        for k in ("input_layer_names", "output_layer_names"):
            d[k] = sorted(names.get(n, n) for n in d.get(k, []))
        return d
    return norm(a, {}) == norm(b, rename)


def phase_image_resnet(dev, r50, launches):
    """Phase 4z-image (d): configs/image.py model=resnet at 4l's B under
    4l's flags through `--job time`: its ModelConfig is 4l's (the data
    layer named ``data``, not ``image``), and it launches kernels 19 and
    20 as often a step as 4l."""
    from paddle_tpu_torch.config.config_parser import parse_config
    from paddle_tpu_torch.models import resnet
    config = os.path.abspath(IMAGE_CONFIG)
    set_flags(**BENCH_FLAGS)
    try:
        cfg, _, _ = parse_config(config, f"model=resnet,batch_size={RESNET_B}")
        if not _same_net(cfg, resnet(50, RESNET_CLASSES, RESNET_IMG),
                         {"image": "data"}):
            fail("4z-image (d): configs/image.py model=resnet is not 4l's "
                 "ResNet-50")
        n = 3 + IMAGE_R50_TIMED
        per_step = {"conv3x3_fwd": 16, "conv3x3_fwd_bwd": 16}
        text, got = run_cli(
            ["train", "--job", "time", "--config", config, "--config_args",
             f"model=resnet,batch_size={RESNET_B},num_samples="
             f"{n * RESNET_B}", "--test_period", str(IMAGE_R50_TIMED)],
            {k: v * n for k, v in per_step.items()}, "4z-image (d)")
    finally:
        set_flags(use_bf16=False, bf16_activations=False)
    tj = json.loads(text.strip().splitlines()[-1])
    for name in launches:
        launches[name]["img_r50"] = got.get(name, 0)
    m = {"ms_per_batch": tj["ms_per_batch"],
         "samples_per_s": tj["samples_per_sec"], "batches": tj["batches"],
         "launches": {k: v for k, v in got.items() if v},
         "resnet50_ms_per_step": r50["ms_per_step"]}
    log(f"  (d) model=resnet, B {RESNET_B}, {BENCH_FLAGS}: ModelConfig "
        f"equal to 4l's; {tj['ms_per_batch']} ms/batch, "
        f"{tj['samples_per_sec']} samples/s over {tj['batches']} batches "
        f"(--job time, momentum); 4l {r50['ms_per_step']:.3f} ms/step "
        f"(Adam, CUDA events); launches {m['launches']} in {n} steps "
        f"(16 + 16 a step, as 4l)")
    return m


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


# ------------------------------------------------------------ 4z-roll
#: the canary's seeded-slow artifact (manifest debug_prefill_delay_ms) and
#: its bake; a breach is a windowed p99 TTFT past ROLL_FACTOR x baseline
ROLL_SLOW_MS, ROLL_BAKE_S, ROLL_FACTOR = 150, 3.0, 2.0
#: the reprefill window's prompts (a second stream, seed 1) and their new
#: tokens: long enough that requests are in flight when the flip lands
ROLL_REPREFILL_N, ROLL_REPREFILL_NEW = 24, 96
#: stats() keys of the server before rollout (--rollout=false keeps them)
PRE_ROLLOUT_STATS = {"queue_depth", "active", "free_pages", "used_pages",
                     "served", "generated_tokens", "continuous",
                     "max_batch"}
#: bench.py's serving_int8 row (_precision_serving_row, bench.py:1970):
#: an MLP 784 -> 3136 -> 3136 -> 10 (seed 7), B 128, 3 warm and 30 timed
#: calls, x and labels from RandomState(0)
SERVED_DIM, SERVED_CLASSES, SERVED_B = 784, 10, 128
SERVED_WARM, SERVED_CALLS = 3, 30
#: the second batch size of a batch-polymorphic artifact
SERVED_B2 = 64
#: the LSTM row's classifier in the subprocess: warm and timed calls
SERVED_LSTM_WARM, SERVED_LSTM_CALLS = 2, 10


def _roll_server(model, version, **kw):
    from paddle_tpu_torch.serving.server import InferenceServer
    return InferenceServer(model, max_batch=MAX_BATCH, n_pages=POOL_PAGES,
                           page_size=PAGE, continuous=True,
                           model_version=version, **kw)


def _roll_ref(model, prompts, max_new=None):
    """Each prompt's tokens (``max_new`` new ones, default ``MAX_NEW``)
    from ``model`` alone, through a fresh server."""
    srv = _roll_server(model, "ref").start()
    try:
        reqs = [srv.submit(p, max_new or MAX_NEW) for p in prompts]
        return [srv.result(r, timeout=600.0) for r in reqs]
    finally:
        srv.stop()


def _roll_window(srv, prompts, swap=None, after=MAX_BATCH, max_new=None):
    """Submit ``prompts`` to the running ``srv`` and wait for them all.
    With ``swap`` (a function returning a swap report), another thread
    calls it once ``after`` of them have finished — mid-stream — and
    reads the launch counts just after the flip.  Returns (requests,
    metrics, {"report", "t_flip", "counts"})."""
    import threading
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = srv.served
    out = {}

    def run():
        while srv.served - base < after:
            time.sleep(0.0005)
        out["report"] = swap()
        out["t_flip"] = time.perf_counter()
        out["counts"] = read_counts()

    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new or MAX_NEW) for p in prompts]
    th = None
    if swap is not None:
        th = threading.Thread(target=run, name="chip-smoke-swap")
        th.start()
    for r in reqs:
        r.done.wait(600.0)
    if th is not None:
        th.join(600.0)
    wall = time.perf_counter() - t0
    ttft = np.array([r.ttft_s for r in reqs
                     if r.ttft_s is not None]) * 1e3
    m = {"req_per_s": len(prompts) / wall,
         "ttft_p50_ms": float(np.percentile(ttft, 50)),
         "ttft_p99_ms": float(np.percentile(ttft, 99)),
         "wall_s": wall,
         "failed": sum(r.state != "done" for r in reqs),
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return reqs, m, out


def _one_model(reqs, ref_old, ref_new, what):
    """Each request's tokens are exactly one model's reference: labels
    ``old``, ``new`` or ``both`` (the two references agree)."""
    labels = []
    for i, r in enumerate(reqs):
        old, new = r.tokens == ref_old[i], r.tokens == ref_new[i]
        if not (old or new):
            fail(f"4z-roll {what}: request {i} ({r.id}) has tokens of "
                 f"neither model")
        labels.append("both" if old and new else "old" if old else "new")
    return labels


def _roll_post(port, body):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/swap", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _flip_launches(end, at_flip):
    return {k: end[k] - at_flip[k] for k in SERVING_KERNELS}


def phase_roll_swap(dev, tmp):
    """4z-roll (a): the watcher exports two checkpoints, then hot swaps
    under load at phase 4's config (drain, then reprefill back), a torn
    artifact, ``POST /v1/swap`` and the kill switch."""
    import shutil
    import torch
    from paddle_tpu_torch.observe import REGISTRY
    from paddle_tpu_torch.serving.loader import artifact_digest, \
        read_manifest
    from paddle_tpu_torch.serving.model import (DecoderConfig, DecoderModel,
                                                init_decoder_params)
    from paddle_tpu_torch.serving.rollout import (CheckpointWatcher,
                                                  swap_from_artifact)
    from paddle_tpu_torch.testing import fault
    from paddle_tpu_torch.trainer.checkpoint import save_checkpoint
    cfg = DecoderConfig(**CFG)
    save_dir, export_dir = os.path.join(tmp, "ckpt"), \
        os.path.join(tmp, "export")
    for i in (0, 1):
        save_checkpoint(save_dir, i, init_decoder_params(cfg, seed=i))
    watcher = CheckpointWatcher(save_dir, cfg, export_dir=export_dir,
                                quantize="int8")
    t0 = time.perf_counter()
    arts = watcher.poll_once()
    export_s = time.perf_counter() - t0
    again = watcher.poll_once()
    if len(arts) != 2 or again:
        fail(f"4z-roll: the watcher exported {arts} then {again}; expected "
             "two artifacts exactly once")
    art_a, art_b = arts
    ver = {d: artifact_digest(read_manifest(d)) for d in arts}
    log(f"  watcher: 2 checkpoints -> {[os.path.basename(d) for d in arts]}"
        f" (int8) in {export_s:.2f} s; a second poll exported nothing")
    m_a = DecoderModel.from_artifact(art_a, device=dev)
    m_b = DecoderModel.from_artifact(art_b, device=dev)
    p0 = _prompts(0, N_REQ, cfg.vocab)
    p1 = _prompts(1, ROLL_REPREFILL_N, cfg.vocab)
    ref = {"a0": _roll_ref(m_a, p0), "b0": _roll_ref(m_b, p0),
           "a1": _roll_ref(m_a, p1, ROLL_REPREFILL_NEW),
           "b1": _roll_ref(m_b, p1, ROLL_REPREFILL_NEW)}
    differ = sum(x != y for x, y in zip(ref["a0"], ref["b0"]))
    if differ < N_REQ // 2:
        fail(f"4z-roll: models A and B agree on {N_REQ - differ} of "
             f"{N_REQ} prompts; the exactly-one-model gate needs them apart")
    del m_b
    REGISTRY.reset()
    res = {"export_s": export_s}
    srv = _roll_server(m_a, ver[art_a]).start()
    try:
        _roll_window(srv, p0[:MAX_BATCH])                      # warm
        reqs0, steady, _ = _roll_window(srv, p0)
        if [r.tokens for r in reqs0] != ref["a0"]:
            fail("4z-roll: the steady window's tokens are not model A's")
        reset_counts()
        reqs, swap_m, sw = _roll_window(
            srv, p0, lambda: swap_from_artifact(srv, art_b,
                                                inflight="drain"))
        end = read_counts()
        rep = sw["report"]
        labels = _one_model(reqs, ref["a0"], ref["b0"], "drain")
        seen = [x for x in labels if x != "both"]
        if rep.get("result") != "ok" or "new" not in seen or \
                "old" not in seen or \
                "old" in seen[seen.index("new"):]:
            fail(f"4z-roll drain: report {rep}, labels {labels}")
        drain_flip = _flip_launches(end, sw["counts"])
        log(f"  drain swap A -> B under load: build {rep['build_s']:.3f} s "
            f"(verify + load + probe), flip pause "
            f"{rep['pause_s'] * 1e3:.3f} ms; {seen.count('old')} requests "
            f"on A (admitted before the flip), {seen.count('new')} on B, "
            f"{labels.count('both')} where A and B agree; launches after "
            f"the flip {drain_flip}")
        roll_counts = dict(end)
        reset_counts()
        reqs1, rep_m, sw1 = _roll_window(
            srv, p1, lambda: swap_from_artifact(srv, art_a,
                                                inflight="reprefill"),
            after=1, max_new=ROLL_REPREFILL_NEW)
        end = read_counts()
        rep1 = sw1["report"]
        labels1 = _one_model(reqs1, ref["b1"], ref["a1"], "reprefill")
        again_ids = set(rep1.get("reprefilled", []))
        for r, lab in zip(reqs1, labels1):
            if r.id in again_ids and lab == "old":
                fail(f"4z-roll reprefill: {r.id} re-prefilled but kept "
                     "model B's tokens")
            if lab == "old" and r.t_done > sw1["t_flip"]:
                fail(f"4z-roll reprefill: {r.id} finished after the flip "
                     "on model B")
        if rep1.get("result") != "ok" or not again_ids:
            fail(f"4z-roll reprefill: report {rep1}")
        reprefill_flip = _flip_launches(end, sw1["counts"])
        log(f"  reprefill swap B -> A under load: build "
            f"{rep1['build_s']:.3f} s, flip pause "
            f"{rep1['pause_s'] * 1e3:.3f} ms; {len(again_ids)} requests "
            f"re-prefilled on A, {labels1.count('old')} finished on B "
            f"before the flip; launches after the flip {reprefill_flip}")
        for name, counts in (("drain", drain_flip),
                             ("reprefill", reprefill_flip)):
            if min(counts.values()) <= 0:
                fail(f"4z-roll {name}: kernels 1 and 7 not both launched "
                     f"after the flip: {counts}")
        roll_counts = {k: roll_counts[k] + end[k] for k in end}
        failed = steady["failed"] + swap_m["failed"] + rep_m["failed"]
        errs = REGISTRY.find("serve_request_failures")
        if failed or (errs is not None and errs.count()):
            fail(f"4z-roll: {failed} failed requests")

        # a torn copy of B rolls back; A keeps serving its tokens
        torn = os.path.join(tmp, "torn")
        shutil.copytree(art_b, torn)
        fault.corrupt_artifact(torn, mode="bitflip")
        port = srv.start_http(0)
        bad = swap_from_artifact(srv, torn)
        _, health = _obs_get(port, "/healthz")
        health = json.loads(health)
        toks = [srv.generate(p, MAX_NEW, timeout=600.0) for p in p0[:4]]
        if bad.get("result") != "rolled_back" or \
                health.get("rollout_state") != "rolled_back" or \
                not str(health.get("last_swap_error")).startswith(
                    "verify:") or \
                health.get("model_version") != ver[art_a] or \
                toks != ref["a0"][:4]:
            fail(f"4z-roll torn artifact: report {bad}, /healthz {health}")
        log(f"  torn artifact rolled back: /healthz rollout_state "
            f"{health['rollout_state']}, last_swap_error "
            f"{health['last_swap_error'][:60]}...; A still serves its "
            "reference tokens")
        code, post = _roll_post(port, {"artifact": art_b})
        code2, post2 = _roll_post(port, {"artifact": art_b})
        if code != 200 or post.get("result") != "ok" or code2 != 200 or \
                post2.get("result") != "unchanged" or \
                srv.model_version != ver[art_b]:
            fail(f"4z-roll POST /v1/swap: {code} {post}; {code2} {post2}")
        log(f"  POST /v1/swap -> {post['result']} (pause "
            f"{post['pause_s'] * 1e3:.3f} ms), re-POST -> "
            f"{post2['result']}")
    finally:
        srv.stop()
    kill = _roll_server(m_a, ver[art_a], rollout=False)
    if set(kill.stats()) != PRE_ROLLOUT_STATS:
        fail(f"4z-roll --rollout=false: stats() keys {sorted(kill.stats())}")
    log("  --rollout=false: stats() has the pre-rollout keys")
    del kill, m_a
    for name, m in (("steady", steady), ("with a drain swap", swap_m),
                    ("with a reprefill swap", rep_m)):
        log(f"  window {name}: {m['req_per_s']:.3f} req/s, TTFT p50 "
            f"{m['ttft_p50_ms']:.3f} ms p99 {m['ttft_p99_ms']:.3f} ms, "
            f"peak memory {m['peak_mem_gb']:.4f} GB")
    res.update(steady=steady, drain=dict(swap_m, **{
        k: rep[k] for k in ("build_s", "pause_s", "swap_s")},
        launches_after_flip=drain_flip, on_old=seen.count("old"),
        on_new=seen.count("new")),
        reprefill=dict(rep_m, **{k: rep1[k] for k in
                                 ("build_s", "pause_s", "swap_s")},
                       launches_after_flip=reprefill_flip,
                       reprefilled=len(again_ids)),
        post_pause_s=post["pause_s"])
    return res, roll_counts, export_dir, ver[art_a]


def phase_roll_canary(dev, export_dir, base_art):
    """4z-roll (b): a seeded-slow artifact rolls back to its predecessor
    after a bake under traffic; a normal one is promoted."""
    import threading
    from paddle_tpu_torch.observe import REGISTRY, counter
    from paddle_tpu_torch.serving.loader import artifact_digest, \
        read_manifest
    from paddle_tpu_torch.serving.model import (DecoderConfig, DecoderModel,
                                                export_decoder,
                                                init_decoder_params)
    from paddle_tpu_torch.serving.rollout import ARTIFACT_PREFIX, \
        swap_from_artifact
    cfg = DecoderConfig(**CFG)

    def publish(seed, **extra):
        stage = os.path.join(export_dir, f".stage-{seed}")
        export_decoder(init_decoder_params(cfg, seed=seed), cfg, stage,
                       **extra)
        digest = artifact_digest(read_manifest(stage))
        final = os.path.join(export_dir, ARTIFACT_PREFIX + digest[:12])
        os.rename(stage, final)
        return final, digest

    base = os.path.join(export_dir, ARTIFACT_PREFIX + base_art[:12])
    slow, _ = publish(2, extra_meta={"debug_prefill_delay_ms": ROLL_SLOW_MS})
    good, good_ver = publish(3)
    REGISTRY.reset()
    srv = _roll_server(DecoderModel.from_artifact(base, device=dev),
                       base_art).start()
    stop, errors, served = threading.Event(), [], [0]

    def traffic():
        i = 0
        while not stop.is_set():
            try:
                srv.generate([2 + i % 60] * 3, 2, timeout=600.0)
                served[0] += 1
            except Exception as e:  # noqa: BLE001 - the failure ledger
                errors.append(repr(e))
            i += 1

    th = threading.Thread(target=traffic, name="chip-smoke-traffic")
    try:
        th.start()
        deadline = time.monotonic() + 60.0
        while True:
            h = REGISTRY.find("serve_ttft_seconds")
            if h is not None and h.window_count(60.0) >= 100:
                break
            if time.monotonic() > deadline:
                fail("4z-roll canary: the baseline never warmed")
            time.sleep(0.05)
        rep = swap_from_artifact(srv, slow, canary=True, bake_s=ROLL_BAKE_S,
                                 canary_factor=ROLL_FACTOR)
        back = srv.model_version
        rep2 = swap_from_artifact(srv, good, canary=True,
                                  bake_s=ROLL_BAKE_S,
                                  canary_factor=ROLL_FACTOR)
    finally:
        stop.set()
        th.join(600.0)
        srv.stop()
    can, can2 = rep.get("canary", {}), rep2.get("canary", {})
    if rep.get("result") != "rolled_back" or can.get("rollback") != "ok" \
            or back != base_art or rep2.get("result") != "ok" \
            or can2.get("result") != "promoted" \
            or srv.model_version != good_ver or errors:
        fail(f"4z-roll canary: slow {rep}; normal {rep2}; errors {errors}")
    counts = {r: counter("rollout_canary_total", "").value(result=r)
              for r in ("rolled_back", "promoted")}
    log(f"  canary: the {ROLL_SLOW_MS} ms-slow artifact rolled back after "
        f"a {ROLL_BAKE_S} s bake (p99 TTFT {can['p99_s'] * 1e3:.3f} ms "
        f"against baseline {can['baseline_p99_s'] * 1e3:.3f} ms); a normal "
        f"one promoted (p99 {can2['p99_s'] * 1e3:.3f} ms); {served[0]} "
        f"requests, 0 failed; rollout_canary_total {counts}")
    return {"slow": can, "normal": can2, "requests": served[0]}


_SERVED_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from paddle_tpu_torch.serving.loader import ServedModel
from paddle_tpu_torch.ops import attention as A, lstm as L
jobs = json.loads(sys.argv[1])
out = {}
for job in jobs:
    name, d, feeds, calls, warm = (job[k] for k in
                                   ("name", "dir", "feeds", "calls", "warm"))
    feed = dict(np.load(feeds))
    m = ServedModel.load(d)
    for _ in range(warm):
        m(**feed)
    L.lstm_fwd.launches = 0
    A.flash_fwd.launches = A.flash_fwd_legacy.launches = 0
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        res = m(**feed)
        times.append((time.perf_counter() - t0) * 1e3)
    rec = {"ms": times, "launches": {
        "lstm_fwd": L.lstm_fwd.launches, "flash_fwd": A.flash_fwd.launches,
        "flash_fwd_legacy": A.flash_fwd_legacy.launches},
        "batch_polymorphic": m.manifest["batch_polymorphic"]}
    np.savez(d + "-card.npz", **res)
    if job.get("cpu"):
        cpu = ServedModel.load(d, device="cpu")(**feed)
        np.savez(d + "-cpu.npz", **cpu)
    if job.get("b2") and m.manifest["batch_polymorphic"]:
        part = {k: v[:job["b2"]] for k, v in feed.items()}
        np.savez(d + "-b2.npz", **m(**part))
    out[name] = rec
banned = sorted(m for m in sys.modules if m.startswith(tuple(
    "paddle_tpu_torch." + p for p in ("layers", "config", "trainer",
                                      "framework"))) or m == "jax"
    or m.startswith("paddle_tpu."))
print("SERVED " + json.dumps({"jobs": out, "banned": banned,
                              "device": torch.cuda.get_device_name(0)}))
"""


def _artifact_bytes(d):
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def phase_roll_served(dev, tmp):
    """4z-roll (c): ``ServedModel`` in a fresh process on the card —
    bench.py's serving_int8 row (fp32 and int8 with the default bf16
    dequant) and the LSTM row's classifier (fp32, a SequenceBatch
    feed)."""
    import torch
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.sequence import value_of
    from paddle_tpu_torch.data.feeder import dense_vector, integer_value
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import lstm_text_classifier
    from paddle_tpu_torch.serving import export_network

    def card_forward(net, params, feed, name):
        p = {k: v.to(dev) for k, v in params.items()}
        with torch.no_grad():
            vals, _ = net.forward(p, {k: v.to(dev) for k, v in feed.items()},
                                  net.init_buffers(dev), is_training=False,
                                  only=[name])
        return value_of(vals[name]).float().cpu().numpy()

    with dsl.config_scope():
        img = dsl.data_layer("img", dense_vector(SERVED_DIM))
        lbl = dsl.data_layer("label", integer_value(SERVED_CLASSES))
        h = dsl.fc_layer(img, size=4 * SERVED_DIM, act=dsl.ReluActivation())
        h = dsl.fc_layer(h, size=4 * SERVED_DIM, act=dsl.ReluActivation())
        pred = dsl.fc_layer(h, size=SERVED_CLASSES,
                            act=dsl.SoftmaxActivation(), name="prediction")
        mlp = NeuralNetwork(dsl.topology(dsl.classification_cost(pred, lbl)))
    mp = mlp.init_params(7, device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(SERVED_B, SERVED_DIM).astype(np.float32)
    labels = rng.randint(0, SERVED_CLASSES, (SERVED_B,))
    d32, d8 = os.path.join(tmp, "mlp_fp32"), os.path.join(tmp, "mlp_int8")
    t0 = time.perf_counter()
    export_network(mlp, mp, {"img": x}, d32)
    export_network(mlp, mp, {"img": x}, d8, quantize="int8")
    np.savez(os.path.join(tmp, "mlp_feed.npz"), img=x)
    ref_mlp = card_forward(mlp, mp, {"img": torch.from_numpy(x)},
                           "prediction")

    lnet = NeuralNetwork(lstm_text_classifier(**TRAIN))
    lp = lnet.init_params(0, device="cpu")
    feed = train_feed(0, TRAIN_B, TRAIN_T, TRAIN["vocab_size"], "cpu")
    dl = os.path.join(tmp, "lstm_fp32")
    export_network(lnet, lp, {"data": feed["data"]}, dl)
    export_s = time.perf_counter() - t0
    fetch = json.load(open(os.path.join(dl, "manifest.json")))["fetches"][0]
    np.savez(os.path.join(tmp, "lstm_feed.npz"),
             data=feed["data"].data.numpy(),
             data_len=feed["data"].length.numpy())
    from paddle_tpu_torch.ops import lstm as L
    L.lstm_fwd.launches = 0
    ref_lstm = card_forward(lnet, lp, {"data": feed["data"]}, fetch)
    if L.lstm_fwd.launches != TRAIN["lstm_num"]:
        fail(f"4z-roll served: the in-process forward launched kernel 8 "
             f"{L.lstm_fwd.launches} times")
    log(f"  exported the MLP (fp32, int8) and the LSTM row's classifier on "
        f"the CPU in {export_s:.2f} s")
    jobs = [{"name": "mlp_fp32", "dir": d32, "calls": SERVED_CALLS,
             "warm": SERVED_WARM, "b2": SERVED_B2,
             "feeds": os.path.join(tmp, "mlp_feed.npz")},
            {"name": "mlp_int8", "dir": d8, "calls": SERVED_CALLS,
             "warm": SERVED_WARM, "feeds": os.path.join(tmp, "mlp_feed.npz")},
            {"name": "lstm", "dir": dl, "calls": SERVED_LSTM_CALLS,
             "warm": SERVED_LSTM_WARM, "cpu": True, "b2": SERVED_B2,
             "feeds": os.path.join(tmp, "lstm_feed.npz")}]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)) + os.pathsep
        + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _SERVED_CHILD,
                           json.dumps(jobs)], capture_output=True, text=True,
                          timeout=600, env=env)
    child_s = time.perf_counter() - t0
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("SERVED ")]
    if proc.returncode != 0 or not line:
        fail(f"4z-roll served: the subprocess failed ({proc.returncode}): "
             f"{proc.stderr[-3000:]}")
    child = json.loads(line[0][len("SERVED "):])
    if child["banned"]:
        fail(f"4z-roll served: the loader imported {child['banned']}")
    res = {"child_s": child_s, "export_s": export_s}
    load = lambda d, tag: np.load(f"{d}-{tag}.npz")  # noqa: E731
    p32 = load(d32, "card")["prediction"]
    p8 = load(d8, "card")["prediction"]
    err32 = float(np.abs(p32 - ref_mlp).max())
    if not (np.isfinite(p32).all() and err32 <= 1e-6):
        fail(f"4z-roll served: the fp32 MLP differs from the in-process "
             f"forward by {err32}")
    if not np.isfinite(p8).all() or float(np.abs(p8 - p32).max()) >= 0.05:
        fail(f"4z-roll served: int8 MLP outputs {np.abs(p8 - p32).max()} "
             "from fp32 (test_precision's 0.05)")
    b2 = load(d32, "b2")["prediction"]
    b2_err = float(np.abs(b2 - ref_mlp[:SERVED_B2]).max())
    if b2.shape != (SERVED_B2, SERVED_CLASSES) or b2_err > 1e-5:
        fail(f"4z-roll served: batch {SERVED_B2} gave {b2.shape}, "
             f"{b2_err}")

    def ce(p):
        return float(np.mean(-np.log(np.maximum(
            p[np.arange(SERVED_B), labels], 1e-9))))
    row = {"fp32": {"ms_per_call": float(np.median(
               child["jobs"]["mlp_fp32"]["ms"])), "loss": ce(p32),
               "artifact_bytes": _artifact_bytes(d32)},
           "int8": {"ms_per_call": float(np.median(
               child["jobs"]["mlp_int8"]["ms"])), "loss": ce(p8),
               "artifact_bytes": _artifact_bytes(d8)}}
    row.update(latency_ratio=row["int8"]["ms_per_call"]
               / row["fp32"]["ms_per_call"],
               top1_delta=float((p32.argmax(1) != p8.argmax(1)).mean()),
               loss_delta=abs(row["fp32"]["loss"] - row["int8"]["loss"]),
               size_ratio=row["int8"]["artifact_bytes"]
               / row["fp32"]["artifact_bytes"],
               max_abs_vs_forward=err32, bit_equal=bool(err32 == 0.0),
               batch2_max_abs=b2_err)
    log(f"  serving_int8 row (B {SERVED_B}, {SERVED_CALLS} calls): fp32 "
        f"{row['fp32']['ms_per_call']:.3f} ms/call, int8 (bf16 dequant) "
        f"{row['int8']['ms_per_call']:.3f} ms/call; top1_delta "
        f"{row['top1_delta']}, loss_delta {row['loss_delta']:.6f}, "
        f"size_ratio {row['size_ratio']:.4f}; fp32 vs the in-process "
        f"forward {err32:.3e} (bit-equal {row['bit_equal']}); batch "
        f"{SERVED_B2} of the polymorphic artifact {b2_err:.3e}")
    lj = child["jobs"]["lstm"]
    out_card = load(dl, "card")[fetch]
    out_cpu = load(dl, "cpu")[fetch]
    e_card = float(np.abs(out_card - ref_lstm).max())
    e_cpu = float(np.abs(out_cpu - ref_lstm).max())
    per_call = lj["launches"]["lstm_fwd"] / SERVED_LSTM_CALLS
    if not (np.isfinite(out_card).all() and e_card <= LSTM_ATOL
            and e_cpu <= LSTM_ATOL and per_call >= 1):
        fail(f"4z-roll served LSTM: card {e_card}, CPU {e_cpu}, kernel 8 "
             f"{per_call} launches a call")
    lstm = {"ms_per_call": float(np.median(lj["ms"])),
            "max_abs_vs_forward": e_card, "cpu_max_abs_vs_forward": e_cpu,
            "kernel8_launches_per_call": per_call,
            "batch_polymorphic": lj["batch_polymorphic"]}
    log(f"  LSTM row's classifier (B {TRAIN_B}, T {TRAIN_T}, H "
        f"{TRAIN['hidden_size']}) in a fresh process: "
        f"{lstm['ms_per_call']:.3f} ms/call, kernel 8 {per_call:.0f} "
        f"launches a call, vs the in-process forward {e_card:.3e}; the same "
        f"model.pt2 on the CPU (plain version) {e_cpu:.3e} (tolerance "
        f"{LSTM_ATOL}); batch-polymorphic {lj['batch_polymorphic']}; the "
        f"subprocess took {child_s:.1f} s")
    res.update(serving_int8=row, lstm=lstm)
    counts = {"lstm_fwd": lj["launches"]["lstm_fwd"]}
    return res, counts


def phase_roll(dev):
    """Phase 4z-roll: the hot swap under load, the canary, and
    ``ServedModel`` in a fresh process (fp32)."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        swap, roll_counts, export_dir, base = phase_roll_swap(dev, tmp)
        canary = phase_roll_canary(dev, export_dir, base)
        served, served_counts = phase_roll_served(dev, tmp)
    res = {"swap": swap, "canary": canary, "served": served,
           "seconds": time.perf_counter() - t0}
    log(f"  4z-roll took {res['seconds']:.1f} s")
    return res, roll_counts, served_counts


# ------------------------------------------------- 4z-dist: multi-device
#: 4z-dist's gate on the 2-rank data-parallel parameters: each rank's
#: ||p - p_one|| / ||p_one - p_0||, max over parameters, against the one
#: rank's run of the same 4 global batches.  Set between the honest
#: reading, 4.53e-4 for DP and FSDP alike, and the planted fault's (rank
#: 1 keeping its own gradient), 5.50 (the phase's first run on the H100)
DIST_PARAM_RTOL = 1e-2
#: the losses (the ranks' reduced mean against the one rank's)
DIST_LOSS_RTOL = 1e-4
DIST_STEPS, DIST_KILL_AFTER, DIST_CHUNKS = 4, 4, 12
DIST_DEADLINE_S, DIST_TASK_TIMEOUT_S = 120.0, 5.0

#: a 4z-dist child process runs :func:`_dist_child` with its kind, its
#: spec (JSON) and its rank or mode as arguments
_DIST_CHILD = "import chip_smoke; chip_smoke._dist_child()"


def _dist_child() -> None:
    """Entry of a 4z-dist child: ``python -c "$_DIST_CHILD" rank|elastic
    <spec JSON> <rank|first|resume>``."""
    kind, spec, arg = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
    {"rank": _dist_rank, "elastic": _dist_elastic}[kind](spec, arg)


def _dist_prepare(spec):
    """The children's common start: the script's flags, the card, and a
    builder of the LSTM row's trainer → (device, builder)."""
    import torch
    from paddle_tpu_torch.utils import FLAGS
    for k, v in spec["flags"].items():
        FLAGS.set(k, v)
    dev = torch.device(spec["device"])
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import lstm_text_classifier
    from paddle_tpu_torch.trainer.trainer import Trainer

    def trainer(**kw):
        return Trainer(NeuralNetwork(lstm_text_classifier(**spec["dims"])),
                       OptimizationConfig(**spec["opt"]), seed=0,
                       device=dev, **kw)
    return dev, trainer


def _dist_launches() -> dict:
    from paddle_tpu_torch.ops import lstm as L
    return {"lstm_fwd": L.lstm_fwd.launches, "lstm_bwd": L.lstm_bwd.launches}


def _dist_wait_go() -> None:
    """Report the imports and the model built, then wait for "GO" on
    stdin (the parent starts the children early and releases them in
    turn, so the card runs one phase at a time)."""
    print("READY", flush=True)
    if sys.stdin.readline().strip() != "GO":
        sys.exit(3)


def _dist_rank(spec, rank) -> None:
    """(b) one rank of the 2-rank job on the card over gloo: DP, the
    planted fault, FSDP (with a sharded save); each rank writes its
    parameters."""
    dev, trainer = _dist_prepare(spec)
    from paddle_tpu_torch.core.device import build_mesh
    from paddle_tpu_torch.distributed import launch
    from paddle_tpu_torch.observe import memory
    from paddle_tpu_torch.ops import lstm as L
    from paddle_tpu_torch.parallel import lstm_fsdp_rules
    from paddle_tpu_torch.parallel.sharding import full_tensor
    rank = int(rank)
    launch.initialize_cluster(spec["addr"], 2, rank, device=dev,
                              backend="gloo", timeout_s=60.0)
    mesh = build_mesh({"data": 2})
    # the global batches: each rank takes its rows of them
    feeds = [train_feed(seed, spec["b"], spec["t"],
                        spec["dims"]["vocab_size"], dev)
             for seed in range(spec["steps"])]
    runs = {"dp": dict(),
            "fsdp": dict(fsdp=True, fsdp_rules=lstm_fsdp_rules()),
            "planted": dict()}
    built = {name: trainer(mesh=mesh, **kw) for name, kw in runs.items()}
    _dist_wait_go()
    out = {}
    for name, tr in built.items():
        reduce_s = []
        if name != "fsdp":
            orig = tr._reduce_grads

            def timed(grads, orig=orig, name=name, reduce_s=reduce_s):
                sync(dev)
                t0 = time.perf_counter()
                red = orig(grads)
                sync(dev)
                reduce_s.append(time.perf_counter() - t0)
                if name == "planted" and rank == 1:
                    return grads        # the fault: rank 1 keeps its own
                return red
            tr._reduce_grads = timed
        L.reset_launch_counts()
        losses, step_s = [], []
        for f in feeds:
            sync(dev)
            t0 = time.perf_counter()
            losses.append(float(tr.train_one_batch(f)))
            sync(dev)
            step_s.append(time.perf_counter() - t0)
        count, slots = tr.opt_state
        # the first step of a run pays its warm-up (the child's first use
        # of the kernels and the collectives): the time is the later
        # steps'
        res = {"losses": losses,
               "ms_per_step": 1e3 * sum(step_s[1:]) / (len(step_s) - 1),
               "reduce_ms_per_step": 1e3 * sum(reduce_s[1:])
               / max(len(reduce_s) - 1, 1),
               "launches": _dist_launches(),
               "param_bytes": sum(memory.per_chip_bytes(p)
                                  for p in tr.params.values()),
               "opt_bytes": sum(memory.per_chip_bytes(x)
                                for s in slots.values() for x in s)}
        params = {n: full_tensor(p).cpu().numpy()
                  for n, p in tr.params.items()}
        np.savez(os.path.join(spec["tmp"], f"{name}-rank{rank}.npz"),
                 **params)
        if name == "fsdp":
            res["ckpt"] = tr.save(os.path.join(spec["tmp"], "fsdp_ckpt"), 0)
        out[name] = res
    launch.shutdown_cluster()
    print("DIST " + json.dumps(out), flush=True)


def _dist_elastic(spec, mode) -> None:
    """(c) a trainer fed by the master: "first" reads through
    cloud_reader, checkpoints after every chunk and stops after
    spec["kill_after"] (the parent SIGKILLs it there); "resume" resumes
    under ElasticTrainer and drains the pass (the master's counts then),
    then times a whole pass of Trainer.train through cloud_reader and one
    over the same chunks in memory."""
    import pickle
    dev, trainer = _dist_prepare(spec)
    from paddle_tpu_torch.data import recordio as rio
    from paddle_tpu_torch.data.feeder import (DataFeeder, integer_value,
                                              integer_value_sequence)
    from paddle_tpu_torch.data.reader import batch, cloud_reader
    from paddle_tpu_torch.distributed import ElasticTrainer, MasterClient
    from paddle_tpu_torch.ops import lstm as L
    from paddle_tpu_torch.utils import FLAGS
    v = spec["dims"]["vocab_size"]
    feeder = DataFeeder([("data", integer_value_sequence(v)),
                         ("label", integer_value(2))], buckets=[spec["t"]])

    def load_chunk(payload):
        path, off = payload.rsplit("\t", 1)
        return [pickle.loads(r) for r in rio.read_chunk(path, int(off))]

    tr = trainer()
    client = MasterClient(spec["master"], retry_max=5)
    et = ElasticTrainer(tr, client, load_chunk, spec["save_dir"],
                        trainer_id=f"trainer-{mode}", checkpoint_every_s=1e9)
    _dist_wait_go()
    L.reset_launch_counts()
    if mode == "first":
        reader = batch(cloud_reader(spec["path"], client, read_ahead=1),
                       spec["b"])
        for i, samples in enumerate(reader()):
            tr.train_one_batch(feeder.convert(samples))
            et._maybe_checkpoint(0, force=True)
            print("CHUNK " + json.dumps({"chunk": i + 1,
                                         **_dist_launches()}), flush=True)
            if i + 1 == spec["kill_after"]:
                time.sleep(600)          # the parent kills it here
        sys.exit(4)
    t0 = time.perf_counter()
    ok = et.resume()
    resume_s = time.perf_counter() - t0
    seen = tr.samples_seen
    sync(dev)
    t0 = time.perf_counter()
    et.train(feeder, batch_size=spec["b"], num_epochs=1)
    sync(dev)
    drain_s = time.perf_counter() - t0
    res = {"resumed": ok, "samples_seen_at_resume": seen,
           "resume_s": resume_s, "drained_samples": tr.samples_seen - seen,
           "drain_s": drain_s, "launches": _dist_launches(),
           "counts": client.counts(), "epoch": client.current_epoch()}
    # a whole pass of Trainer.train fed by the master, then one over the
    # same chunks in memory, on the same trainer
    FLAGS.set("save_dir", "")
    chunks = [load_chunk(p) for p in rio.chunk_payloads(spec["path"])]
    for name, reader in (
            ("master", batch(cloud_reader(spec["path"], client,
                                          read_ahead=1), spec["b"])),
            ("memory", lambda: iter(chunks))):
        n0 = tr.samples_seen
        sync(dev)
        t0 = time.perf_counter()
        tr.train(reader, num_passes=1, feeder=feeder)
        sync(dev)
        res[f"{name}_s"] = time.perf_counter() - t0
        res[f"{name}_samples"] = tr.samples_seen - n0
    print("ELASTIC " + json.dumps(res), flush=True)


class _DistChild:
    """A 4z-dist child process: started early, released with ``go()``;
    threads drain its stdout (into a queue) and its stderr; killed at its
    deadline (the phase then fails)."""

    def __init__(self, kind, args, env, name):
        import queue
        import threading
        self.name = name
        self.deadline = time.monotonic() + DIST_DEADLINE_S
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _DIST_CHILD, kind, *args], env=env,
            text=True,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        self.out, self.err = queue.Queue(), []

        def pump(stream, sink):
            for ln in stream:
                sink(ln)
            if sink == self.out.put:
                self.out.put(None)
        for stream, sink in ((self.proc.stdout, self.out.put),
                             (self.proc.stderr, self.err.append)):
            threading.Thread(target=pump, args=(stream, sink),
                             daemon=True).start()

    def line(self, prefix):
        """The next stdout line starting with ``prefix`` (fails at the
        deadline or when the child ends first)."""
        import queue
        while True:
            left = self.deadline - time.monotonic()
            if left <= 0:
                self.kill()
                fail(f"4z-dist: {self.name} passed its "
                     f"{DIST_DEADLINE_S:.0f} s deadline: "
                     f"{''.join(self.err)[-2000:]}")
            try:
                ln = self.out.get(timeout=min(left, 1.0))
            except queue.Empty:
                continue
            if ln is None:
                fail(f"4z-dist: {self.name} ended ({self.proc.wait()}) "
                     f"before {prefix!r}: {''.join(self.err)[-3000:]}")
            if ln.startswith(prefix):
                return ln[len(prefix):].strip()

    def go(self):
        self.proc.stdin.write("GO\n")
        self.proc.stdin.flush()

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()

    def wait(self):
        left = max(self.deadline - time.monotonic(), 0.1)
        try:
            rc = self.proc.wait(timeout=left)
        except subprocess.TimeoutExpired:
            self.kill()
            fail(f"4z-dist: {self.name} passed its deadline")
        if rc != 0:
            fail(f"4z-dist: {self.name} exited {rc}: "
                 f"{''.join(self.err)[-3000:]}")


def _dist_rel(got, want, start):
    """max over parameters of ||got - want|| / ||want - start||."""
    worst = 0.0
    for n, w in want.items():
        step = float(np.linalg.norm(w - start[n]))
        worst = max(worst, float(np.linalg.norm(got[n] - w))
                    / max(step, 1e-30))
    return worst


def phase_dist_nccl(dev):
    """4z-dist (a): world 1 over NCCL in this process: ``--fsdp`` on and
    off under the ``{data: 1}`` mesh, 3 steps each at the LSTM row's
    width, bit-identical parameters, kernels 8 and 9 launched on both."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.core.device import get_mesh
    from paddle_tpu_torch.distributed import launch
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import lstm_text_classifier
    from paddle_tpu_torch.trainer.trainer import Trainer
    launch.initialize_cluster(f"127.0.0.1:{_obs_free_port()}", 1, 0,
                              device=dev, timeout_s=60.0)
    try:
        if dist.get_backend() != "nccl":
            fail(f"4z-dist (a): backend {dist.get_backend()}, not nccl")
        probe = torch.ones(4, device=dev)
        dist.all_reduce(probe)
        mesh = get_mesh(refresh=True)
        if mesh.shape != {"data": 1}:
            fail(f"4z-dist (a): mesh {mesh.shape}")
        feed = train_feed(0, TRAIN_B, TRAIN_T, TRAIN["vocab_size"], dev)
        params, counts = {}, {}
        for fsdp in (True, False):
            tr = Trainer(NeuralNetwork(lstm_text_classifier(**TRAIN)),
                         OptimizationConfig(**TRAIN_OPT), seed=0,
                         device=dev, mesh=mesh, fsdp=fsdp)
            if tr._resolve_specs() is not None:
                fail("4z-dist (a): --fsdp placed parameters on a {data: 1} "
                     "mesh")
            launches, losses, ms, _, _ = timed_steps(tr, feed, 3)
            counts[fsdp] = {k: launches[k] for k in TRAINING_KERNELS}
            params[fsdp] = {n: p.detach().clone()
                            for n, p in tr.params.items()}
            del tr
    finally:
        launch.shutdown_cluster()
    same = all(torch.equal(params[True][n], params[False][n])
               for n in params[False])
    want = 3 * TRAIN["lstm_num"]
    if not same or any(c[k] != want for c in counts.values()
                       for k in TRAINING_KERNELS):
        fail(f"4z-dist (a): fsdp on/off bit-identical {same}, launches "
             f"{counts} (want {want} each)")
    log(f"  (a) NCCL world 1: --fsdp on and off bit-identical after 3 "
        f"steps; kernels 8 and 9 {counts[True]} each way")
    cli = phase_dist_cli()
    return {"bit_identical": same, "launches": counts[True],
            "launches_off": counts[False], "cli": cli}


def phase_dist_cli():
    """4z-dist (a), the entry point: ``python -m paddle_tpu_torch train
    --distributed --fsdp`` (in process) as rank 0 of a one-process job
    from the ``PADDLE_*`` environment, 2 steps of the LSTM row: the CLI
    joins an NCCL group on the card and trains through kernels 8 and 9."""
    import tempfile

    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import launch
    from paddle_tpu_torch.utils import FLAGS
    env = {"PADDLE_COORDINATOR": f"127.0.0.1:{_obs_free_port()}",
           "PADDLE_NUM_NODES": "1", "PADDLE_NODE_ID": "0"}
    old_env = {k: os.environ.get(k) for k in env}
    old_fsdp = FLAGS.get("fsdp")
    joined = {}
    real_init = dist.init_process_group

    def init(*a, **kw):
        real_init(*a, **kw)
        joined.update(backend=dist.get_backend(),
                      card=torch.cuda.current_device())
    steps = 2
    os.environ.update(env)
    dist.init_process_group = init
    try:
        with tempfile.TemporaryDirectory() as save_dir:
            _, launches = run_cli(
                ["train", "--config", os.path.abspath(CLI_CONFIG),
                 "--config_args", f"num_samples={steps * TRAIN_B}",
                 "--num_passes", "1", "--save_dir", save_dir,
                 "--distributed", "--fsdp"],
                {"lstm_fwd": 2 * steps, "lstm_bwd": 2 * steps},
                "train --distributed --fsdp")
        launches = {k: launches[k] for k in TRAINING_KERNELS}
    finally:
        dist.init_process_group = real_init
        launch.shutdown_cluster()
        FLAGS.set("fsdp", old_fsdp)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if joined != {"backend": "nccl", "card": 0}:
        fail(f"4z-dist (a): train --distributed joined {joined}, not NCCL "
             f"on card 0")
    log(f"  (a) train --distributed --fsdp from PADDLE_*: NCCL world 1 on "
        f"card 0, {steps} steps, kernels 8 and 9 {launches}")
    return launches


def phase_dist(dev, dims=TRAIN):
    """Phase 4z-dist: the multi-device slice on one card (``dims``: the
    LSTM row's; a CPU rehearsal passes smaller ones and skips (a))."""
    import pickle
    import tempfile

    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.data import recordio as rio
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import lstm_text_classifier
    from paddle_tpu_torch.trainer.trainer import Trainer
    from paddle_tpu_torch.utils import FLAGS
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)) + os.pathsep
        + os.environ.get("PYTHONPATH", ""))
    flags = {k: FLAGS.get(k) for k in ("use_bf16", "bf16_activations",
                                       "precision", "fused_rnn_hblock")}
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = {"flags": flags, "dims": dims, "opt": TRAIN_OPT,
                "b": TRAIN_B, "t": TRAIN_T, "tmp": tmp,
                "device": str(dev)}
        # (c)'s data: the LSTM row's samples as record files, 12 chunks
        rng = np.random.RandomState(7)
        path = os.path.join(tmp, "lstm-00000.rec")
        with rio.Writer(path, max_records_per_chunk=TRAIN_B) as w:
            for _ in range(DIST_CHUNKS * TRAIN_B):
                t = int(rng.randint(TRAIN_T // 2, TRAIN_T + 1))
                w.write(pickle.dumps((
                    rng.randint(0, dims["vocab_size"], t).tolist(),
                    int(rng.randint(0, 2)))))
        master_log = open(os.path.join(tmp, "master.log"), "w")
        master = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch", "master", "--port",
             "0", "--local_only", "--snapshot", os.path.join(tmp, "snap"),
             "--task_timeout", str(DIST_TASK_TIMEOUT_S)], env=env,
            text=True, stdout=subprocess.PIPE, stderr=master_log)
        children = []
        try:
            addr = f"127.0.0.1:{_obs_free_port()}"
            ranks = [_DistChild("rank", [json.dumps(
                {**base, "addr": addr, "steps": DIST_STEPS}), str(r)],
                env, f"rank {r}") for r in range(2)]
            children += ranks
            line = master.stdout.readline()
            if "master serving on :" not in line:
                master_log.flush()
                fail(f"4z-dist: the master did not start: {line!r} "
                     f"{open(master_log.name).read()[-2000:]}")
            maddr = f"127.0.0.1:{int(line.rsplit(':', 1)[1])}"
            el = {**base, "master": maddr, "path": path,
                  "save_dir": os.path.join(tmp, "elastic"),
                  "kill_after": DIST_KILL_AFTER}
            first = _DistChild("elastic", [json.dumps(el), "first"],
                               env, "elastic first")
            second = _DistChild("elastic", [json.dumps(el), "resume"],
                                env, "elastic resume")
            children += [first, second]
            log("  (a) NCCL world 1 in this process")
            res["nccl"] = phase_dist_nccl(dev) if dev.type == "cuda" \
                else {"launches": dict.fromkeys(TRAINING_KERNELS, 0),
                      "launches_off": dict.fromkeys(TRAINING_KERNELS, 0),
                      "cli": dict.fromkeys(TRAINING_KERNELS, 0)}
            # (b): the one rank's run of the same 4 global batches
            feeds = [train_feed(s, TRAIN_B, TRAIN_T, dims["vocab_size"],
                                dev) for s in range(DIST_STEPS)]
            one = Trainer(NeuralNetwork(lstm_text_classifier(**dims)),
                          OptimizationConfig(**TRAIN_OPT), seed=0,
                          device=dev)
            start = {n: p.detach().cpu().numpy()
                     for n, p in one.params.items()}
            sync(dev)
            t0 = time.perf_counter()
            one_losses = [float(one.train_one_batch(f)) for f in feeds]
            sync(dev)
            one_ms = (time.perf_counter() - t0) * 1e3 / DIST_STEPS
            want = {n: p.detach().cpu().numpy()
                    for n, p in one.params.items()}
            del one, feeds
            for r in ranks:
                r.line("READY")
            for r in ranks:
                r.go()
            out = [json.loads(r.line("DIST ")) for r in ranks]
            for r in ranks:
                r.wait()
            res["gloo"] = _dist_gloo_gates(dev, dims, tmp, out, start,
                                           want, one_losses, one_ms)
            # (c): the master feeds the elastic trainers
            if master.poll() is not None:
                master_log.flush()
                fail(f"4z-dist: the master exited ({master.returncode}) "
                     f"before (c): {open(master_log.name).read()[-3000:]}")
            try:
                res["master"] = _dist_master(first, second, maddr,
                                             dev.type == "cuda")
            except SystemExit:
                master_log.flush()
                log(f"  the master: {master.poll()}, its log: "
                    f"{open(master_log.name).read()[-3000:]}")
                raise
        finally:
            for c in children:
                c.kill()
            master.terminate()
            try:
                master.wait(timeout=10)
            except subprocess.TimeoutExpired:
                master.kill()
                master.wait()
            master_log.close()
    res["seconds"] = time.perf_counter() - t_phase
    counts = {k: res["nccl"]["launches"][k] + res["nccl"]["launches_off"][k]
              + res["nccl"]["cli"][k]
              + res["gloo"]["launches"][k] + res["master"]["launches"][k]
              for k in TRAINING_KERNELS}
    log(f"  4z-dist took {res['seconds']:.1f} s; kernels 8 and 9 launched "
        f"{counts} times across its processes")
    return res, counts


def _dist_gloo_gates(dev, dims, tmp, out, start, want, one_losses,
                     one_ms):
    """4z-dist (b)'s gates on the two ranks' results."""
    rel = {}
    for name in ("dp", "fsdp", "planted"):
        rel[name] = max(_dist_rel(dict(np.load(os.path.join(
            tmp, f"{name}-rank{r}.npz"))), want, start) for r in range(2))
    loss_err = max(abs(a - b) / abs(b) for r in out for name in ("dp",
                   "fsdp") for a, b in zip(r[name]["losses"], one_losses))
    log(f"  (b) 2 ranks over gloo on one card, {DIST_STEPS} steps of global "
        f"B {TRAIN_B}: parameters vs one rank (||d|| / ||update||, worst "
        f"parameter and rank) DP {rel['dp']:.3e}, FSDP {rel['fsdp']:.3e}, "
        f"planted fault (rank 1 keeps its own gradient) "
        f"{rel['planted']:.3e}; gate {DIST_PARAM_RTOL}; losses within "
        f"{loss_err:.3e} (gate {DIST_LOSS_RTOL})")
    if not (rel["dp"] <= DIST_PARAM_RTOL and rel["fsdp"] <= DIST_PARAM_RTOL
            and rel["planted"] > DIST_PARAM_RTOL
            and loss_err <= DIST_LOSS_RTOL):
        fail(f"4z-dist (b): DP {rel['dp']}, FSDP {rel['fsdp']}, planted "
             f"{rel['planted']} against {DIST_PARAM_RTOL}; losses "
             f"{loss_err}")
    want_k = DIST_STEPS * dims["lstm_num"] if dev.type == "cuda" else 0
    for r, o in enumerate(out):
        for name in ("dp", "fsdp"):
            if any(o[name]["launches"][k] != want_k
                   for k in TRAINING_KERNELS):
                fail(f"4z-dist (b): rank {r} {name} launches "
                     f"{o[name]['launches']} (want {want_k} each)")
        ratio = (o["fsdp"]["param_bytes"] + o["fsdp"]["opt_bytes"]) \
            / (o["dp"]["param_bytes"] + o["dp"]["opt_bytes"])
        if ratio > 0.55:
            fail(f"4z-dist (b): rank {r}'s FSDP params + opt_state are "
                 f"{ratio:.3f} of the replicated bytes")
    ckpt = out[0]["fsdp"]["ckpt"]
    loaded = _dist_load_one(dev, dims, ckpt)
    fsdp_params = dict(np.load(os.path.join(tmp, "fsdp-rank0.npz")))
    if any(not np.array_equal(loaded[n], fsdp_params[n]) for n in loaded):
        fail("4z-dist (b): the sharded checkpoint loads into one rank "
             "with other parameters")
    ratio = max((o["fsdp"]["param_bytes"] + o["fsdp"]["opt_bytes"])
                / (o["dp"]["param_bytes"] + o["dp"]["opt_bytes"])
                for o in out)
    m = {"param_rel_dp": rel["dp"], "param_rel_fsdp": rel["fsdp"],
         "param_rel_planted": rel["planted"], "loss_rel": loss_err,
         "fsdp_bytes_ratio": ratio,
         "one_rank_ms_per_step": one_ms,
         "two_rank_ms_per_step": max(o["dp"]["ms_per_step"] for o in out),
         "two_rank_fsdp_ms_per_step": max(o["fsdp"]["ms_per_step"]
                                          for o in out),
         "gloo_reduce_ms_per_step": max(o["dp"]["reduce_ms_per_step"]
                                        for o in out),
         "shard_files": sorted(f for f in os.listdir(ckpt)
                               if ".shard-" in f),
         "launches": {k: sum(o[name]["launches"][k] for o in out
                             for name in ("dp", "fsdp", "planted"))
                      for k in TRAINING_KERNELS}}
    log(f"  (b) FSDP params + opt_state per rank {ratio:.3f} of the "
        f"replicated bytes; sharded checkpoint {m['shard_files']} loads "
        f"into one rank bit for bit; ms/step one rank alone {one_ms:.2f}, "
        f"two ranks sharing the card {m['two_rank_ms_per_step']:.2f} (DP) "
        f"and {m['two_rank_fsdp_ms_per_step']:.2f} (FSDP) -- the ranks "
        f"share the SMs, so this is no scaling figure; the gloo "
        f"all-reduce {m['gloo_reduce_ms_per_step']:.2f} ms a step")
    return m


def _dist_load_one(dev, dims, ckpt):
    """A one-rank trainer on the card loading ``ckpt``: its parameters
    on the host."""
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models import lstm_text_classifier
    from paddle_tpu_torch.trainer.trainer import Trainer
    tr = Trainer(NeuralNetwork(lstm_text_classifier(**dims)),
                 OptimizationConfig(**TRAIN_OPT), seed=5, device=dev)
    tr.load(ckpt)
    return {n: p.detach().cpu().numpy() for n, p in tr.params.items()}


def _dist_master(first, second, maddr, on_card):
    """4z-dist (c): the first trainer through 4 chunks, SIGKILLed; the
    second resumes and drains the pass; the master's counts after."""
    from paddle_tpu_torch.distributed import MasterClient
    first.line("READY")
    second.line("READY")
    first.go()
    chunk = None
    for _ in range(DIST_KILL_AFTER):
        chunk = json.loads(first.line("CHUNK "))
    first.kill()
    t_kill = time.perf_counter()
    second.go()
    res = json.loads(second.line("ELASTIC "))
    second.wait()
    res["kill_to_done_s"] = time.perf_counter() - t_kill
    counts, epoch = res["counts"], res["epoch"]
    with MasterClient(maddr, retry_max=2) as c:
        c.reset_epoch(c.current_epoch() + 1)
        c.ping()
        t0 = time.perf_counter()
        n = 0
        while True:                # the next epoch's leases, timed
            tid, payload = c.get_task()
            if payload is None:
                break
            c.task_finished(tid)
            n += 1
        rpc_us = (time.perf_counter() - t0) * 1e6 / max(2 * n, 1)
    first_launches = {k: chunk[k] for k in TRAINING_KERNELS}
    ok = (res["resumed"] and res["samples_seen_at_resume"] > 0
          and counts["pending"] == 0 and counts["failed"] == 0
          and counts["todo"] == DIST_CHUNKS and epoch == 1
          and all((first_launches[k] > 0 and res["launches"][k] > 0)
                  == on_card for k in TRAINING_KERNELS))
    log(f"  (c) master-fed: killed the first trainer after "
        f"{chunk['chunk']} chunks (kernels 8/9 {first_launches}); the "
        f"resume returned {res['resumed']} at samples_seen "
        f"{res['samples_seen_at_resume']} in {res['resume_s']:.2f} s and "
        f"drained {res['drained_samples']} samples in "
        f"{res['drain_s']:.2f} s (the killed trainer's leases wait out the "
        f"{DIST_TASK_TIMEOUT_S:.0f} s task timeout), kernels 8/9 "
        f"{res['launches']}; master counts {counts}, epoch {epoch}; a "
        f"pass of Trainer.train fed by the master "
        f"{res['master_samples'] / res['master_s']:.1f} samples/s, in "
        f"memory {res['memory_samples'] / res['memory_s']:.1f} samples/s; "
        f"a lease or finish RPC {rpc_us:.1f} us")
    if not ok:
        fail(f"4z-dist (c): resume {res}, counts {counts}, epoch {epoch}, "
             f"launches {first_launches}")
    res.update(counts=counts, epoch=epoch, rpc_us=rpc_us,
               first_launches=first_launches,
               master_samples_per_s=res["master_samples"] / res["master_s"],
               memory_samples_per_s=res["memory_samples"] / res["memory_s"],
               launches={k: first_launches[k] + res["launches"][k]
                         for k in TRAINING_KERNELS})
    return res


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
        log("== phase 4z-loop: the training loop around the step at 4d's "
            "width (Trainer.train with a test reader and the config's "
            "classification_error evaluator, --prefetch_depth 0 and 2)")
        loop = phase_loop(dev, train)
        for name in launches:
            for path, counts in loop["launches"].items():
                launches[name][f"training_{path}"] = counts[name]
        log("== phase 4z-small: the loop at B 8, T 12, H 128, card vs CPU "
            "plain path (fp32)")
        loop["small"] = phase_loop_small(dev)
        log("== phase 4z-ckpt: checkpoints around Trainer.train at 4d's "
            "width (save a pass, resume at --start_pass=1 from "
            "--init_model_path, fp32 and --precision=bf16)")
        ckpt = phase_ckpt(dev, train)
        log("== phase 4z-opt: the ten optimizers, L1, the seven schedules "
            "and a pruning hook at B 8, T 12, H 128, card vs CPU plain "
            "path (fp32)")
        opt = phase_opt(dev)
        log("== phase 4z-cli: configs/rnn.py through python -m "
            "paddle_tpu_torch (dump_config, train --job time / train / "
            "test / checkgrad) at 4d's width")
        cli = phase_cli(dev, train, loop["time_job"])
        log("== phase 4z-dense: the dense layers, costs and activations "
            "card vs CPU, dropout and the error clip, the VAE demo's config "
            "at full width (fp32)")
        dense = phase_dense(dev, card)
        log("== phase 4z-gen: the sequence layers, nested batches and the "
            "sampled layers card vs CPU, the seqToseq demo trained and "
            "decoded, the seq2seq row's model translating at full width "
            "(fp32)")
        gen = phase_gen(dev, card)
        log("== phase 4z-tag: the recurrent types, the sequence costs and "
            "nested groups card vs CPU, the tagging demo trained and "
            "decoded, its config at the seq2seq row's encoder width, a "
            "nested group at the LSTM row's width (fp32)")
        tag = phase_tag(dev, card)
        log("== phase 4z-image: the image, 3-D and detection types and ops "
            "card vs CPU, SSD300's loss and decode, configs/image.py's "
            "nets through python -m paddle_tpu_torch train --job time "
            "(fp32)")
        image = phase_image(dev, card)
        log("== phase 4z-v2: the LSTM row's net through paddle_tpu_torch.v2 "
            "trained from record files against Trainer.train in memory, "
            "SGD.test, infer, Parameters tars; the sentiment demo's net "
            "through paddle.v2 card vs CPU and a pass (fp32)")
        v2res = phase_v2(dev)
        for name in launches:
            launches[name]["v2"] = v2res["full"]["launches"].get(name, 0)
            launches[name]["training_ckpt"] = ckpt["launches"].get(name, 0)
            launches[name]["training_opt"] = opt["launches"].get(name, 0)
            launches[name]["cli"] = cli["launches"].get(name, 0)
            launches[name]["gen"] = gen["translate"]["launches"].get(name, 0)
            launches[name]["tag"] = tag["full"]["launches"].get(name, 0)
            launches[name]["nest"] = tag["nested"]["launches"].get(name, 0)
        log("== phase 4z-fw: the LSTM row's net as a Fluid program "
            "(paddle_tpu_torch.framework: Program, Executor, backward, "
            "Adam) on the card, card vs CPU, the inference model's round "
            "trip, timed beside 4d; the book programs card vs CPU (fp32)")
        fwres = phase_fw(dev, train["ms_per_step"])
        for name in launches:
            launches[name]["fw"] = fwres["row"]["launches"].get(name, 0)
        log("== phase 4z-obs: the telemetry core around the LSTM row at "
            "4d's width: Trainer.train off and with --metrics_jsonl, "
            "--trace_jsonl and --metrics_port on, the step's syncs, 20 "
            "steps each way, a profiler window, the blocking timer (fp32)")
        obs = phase_obs(dev, train)
        for name in launches:
            launches[name]["obs"] = obs["launches"].get(name, 0)
        log("== phase 4z-roll: hot swap under load at phase 4's config "
            "(the watcher's int8 exports, drain and reprefill flips, a "
            "torn artifact, POST /v1/swap, --rollout=false), the canary "
            "bake, ServedModel in a fresh process (the serving_int8 row "
            "and the LSTM row's classifier, fp32)")
        roll, roll_counts, served_counts = phase_roll(dev)
        for name in launches:
            launches[name]["roll"] = roll_counts.get(name, 0)
            launches[name]["served"] = served_counts.get(name, 0)
        log("== phase 4z-dist: the multi-device slice on one card at the "
            "LSTM row's width: (a) NCCL world 1, --fsdp on and off; (b) 2 "
            "ranks over gloo, DP and FSDP against one rank, a sharded "
            "checkpoint; (c) the master feeding an elastic trainer "
            "through a SIGKILL and a resume (fp32)")
        dist_res, dist_counts = phase_dist(dev)
        for name in launches:
            launches[name]["dist"] = dist_counts.get(name, 0)
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
        log("== phase 4z-image (d): configs/image.py model=resnet through "
            "--job time under 4l's flags")
        image["resnet"] = phase_image_resnet(dev, resnet["resnet50"],
                                             launches)
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
    mark_phase(None)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"phase_seconds": dict(
        PHASES["seconds"], total=time.perf_counter() - t_start)}))
    print(json.dumps({"serving": {k: v for k, v in serve.items()
                                  if k != "prompt_lengths"},
                      "training": train, "training_loop": loop,
                      "training_ckpt": ckpt, "training_opt": opt,
                      "cli": cli, "dense": dense, "gen": gen, "tag": tag,
                      "image": image, "v2": v2res, "fw": fwres,
                      "obs": obs, "roll": roll, "dist": dist_res,
                      "training_h1280": blocked,
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
