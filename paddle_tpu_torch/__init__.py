"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper (H100).

The JAX package (``paddle_tpu``) stays the reference; this package is
its counterpart module for module, in PyTorch idiom.  It imports
``torch``, numpy and the stdlib only — never ``jax`` and nothing of
``paddle_tpu`` (it keeps its own copies of what it needs).

Slice 1 ports the serving path: ``InferenceServer.submit`` → page-pool
admission → packed prefill (:func:`ops.attention.prefill_attention_packed`)
→ fixed-width paged decode (:func:`ops.attention.paged_decode_attention`).
Both attention kernels are hand-written CUDA C++ for ``sm_90a`` under
``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).

Slice 2a ports the fp32 training step of the LSTM text classifier:
``NeuralNetwork(ModelConfig)`` → ``Trainer.train_one_batch``, with the
fused LSTM forward and BPTT as persistent cooperative CUDA kernels
(``ops/lstm.py``, ``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``); slice 2b
the hidden-blocked LSTM tier and the bf16 precision policy.

Slice 3 ports the ResNet-50 training step (``models/image.py``): batch-norm
buffers, the conv/BN fusion plan (``analysis/netcheck.py``) and the fused
conv/BN-affine 3×3 kernels (``ops/conv.py``, ``csrc/conv3x3_*.cu``).

Slice 5a ports the transformer classifier's training step
(``models/text.transformer_text_classifier``; ``layers/attention.py``):
``flash_attention`` / ``flash_attention_packed`` take the reference's
dispatch, and the block-sparse path runs the tensor-core flash forward
and its two backward kernels (``ops/attention.py``,
``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu``, ``csrc/flash_bwd_dkv.cu``).

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no CUDA device they raise instead of moving to the CPU.
"""
