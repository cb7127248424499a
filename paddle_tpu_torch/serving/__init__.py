"""Serving: the decoder model, its page pool and the continuous-batching
server (counterpart of ``paddle_tpu/serving``)."""
