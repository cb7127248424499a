"""Row-sparse parameter machinery (counterpart of ``paddle_tpu/parallel``;
``sparse.py`` only)."""
