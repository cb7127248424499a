"""Decoder-only transformer for the serving stack (counterpart of
``paddle_tpu/serving/model.py``).

- :meth:`DecoderModel.prefill` runs a batch of mixed-length prompts with
  ONE :func:`prefill_attention_packed` launch per layer (``[B, T]`` rows
  flattened to one packed ``[1, B·T]`` row with
  :func:`segments_from_lengths`), writes every prompt token's K/V into
  the rows' pages (the :func:`paged_kv_write` scatter, its index built
  once per step for all layers), and returns each row's
  first generated token;
- :meth:`DecoderModel.decode` advances a fixed-width decode batch one
  token with :func:`paged_decode_attention` over the shared page pool;
  inactive slots carry the scratch page table, a zero write count and
  length 1, so they touch no memory they do not own.

Batch invariance is a contract: a request's tokens must not depend on
which requests share its batch, so that ``--serve_continuous=false``
(sequential serving) gives byte-identical tokens.  Both attention
kernels sum each query's keys in an order fixed by the query's own
segment or row.

The KV pools are updated in place (the JAX version threads new pools
through a jitted function); prefill and decode still return them.
Artifacts: :func:`export_decoder` writes the JAX package's version-2
weights layout with ``"kind": "decoder"`` (int8 dequantized to fp32 by
default, or to bf16, whose weights stay bf16 and are upcast at each
product); artifacts move between the two packages in both directions.
The rollout pipeline (``serving/rollout.py``) records provenance in
``extra_meta``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..layers.beam_search import eos_frozen_logits
from ..ops.attention import (kv_write_index, paged_decode_attention,
                             paged_kv_scatter, prefill_attention_packed,
                             segments_from_lengths)
from ..utils import enforce
from ..utils.jax_interop import decoder_param_shapes, params_from_jax
from . import export as _export
from . import loader as _loader

Params = Mapping[str, torch.Tensor]


class DecoderConfig(NamedTuple):
    """Shape of the served decoder."""
    vocab: int
    dim: int
    heads: int
    layers: int
    ffn: int
    max_context: int = 256
    eos_id: int = 1


def init_decoder_params(cfg: DecoderConfig, seed: int = 0
                        ) -> Dict[str, np.ndarray]:
    """Random fp32 decoder weights (scaled normal init) from numpy's
    ``default_rng(seed)`` — the same draws, in the same order, as the
    JAX package, so one seed gives the same weights in both."""
    enforce(cfg.dim % cfg.heads == 0,
            f"dim {cfg.dim} not divisible by heads {cfg.heads}")
    rng = np.random.default_rng(seed)

    def mat(n_in, n_out):
        return (rng.standard_normal((n_in, n_out)) /
                np.sqrt(n_in)).astype(np.float32)

    p: Dict[str, np.ndarray] = {
        "embed": mat(cfg.vocab, cfg.dim) * np.float32(np.sqrt(cfg.vocab)),
        "pos_embed": (0.02 * rng.standard_normal(
            (cfg.max_context, cfg.dim))).astype(np.float32),
        "ln_f": np.ones(cfg.dim, np.float32),
        "lm_head": mat(cfg.dim, cfg.vocab),
    }
    for i in range(cfg.layers):
        p[f"l{i}.ln1"] = np.ones(cfg.dim, np.float32)
        p[f"l{i}.ln2"] = np.ones(cfg.dim, np.float32)
        for w, (a, b) in {"wq": (cfg.dim, cfg.dim), "wk": (cfg.dim, cfg.dim),
                          "wv": (cfg.dim, cfg.dim), "wo": (cfg.dim, cfg.dim),
                          "w1": (cfg.dim, cfg.ffn),
                          "w2": (cfg.ffn, cfg.dim)}.items():
            p[f"l{i}.{w}"] = mat(a, b)
    return p


def _rms(x, g, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * g


def _mm(x, w):
    """``x @ w`` with a bf16 weight (an int8 artifact dequantized to
    bf16) upcast to the activations' dtype at the op: the JAX package's
    promotion of bf16 against f32, whose matmul is an f32 one over the
    exactly widened weight (``torch.matmul`` refuses mixed dtypes).  The
    embedding tables are upcast where they are read, so the activations
    stay f32; the JAX package instead carries the bf16 sum of the two
    embeddings into its first RMS norm (rounded there, unrounded in the
    residual, as XLA's excess precision fuses it), a difference of one
    bf16 rounding of the input embedding."""
    return x @ w.to(x.dtype)


def _ffn(x, p: Params, i: int):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(_mm(_rms(x, p[f"l{i}.ln2"]), p[f"l{i}.w1"]),
               approximate="tanh")
    return x + _mm(h, p[f"l{i}.w2"])


def _qkv(xn, p: Params, i: int, heads: int):
    b, t, d = xn.shape
    dh = d // heads

    def proj(w):
        return _mm(xn, p[f"l{i}.{w}"]).reshape(b, t, heads, dh)
    return proj("wq"), proj("wk"), proj("wv")


def _kv_index(k_pool, tables_host, starts_host, counts_host, t_n: int, dev):
    """The K/V scatter index of one step, built on the CPU and copied to
    the card once: every layer writes the same token slots."""
    return kv_write_index(tables_host, starts_host, counts_host, t_n,
                          k_pool.shape[2], k_pool.shape[1]).to(dev)


def _prefill_impl(p: Params, k_pool, v_pool, tokens, lengths, lengths_host,
                  tables_host, cfg: DecoderConfig):
    """``[B, T]`` padded prompts → ``([B] first generated tokens, [B, V]
    logits)``; writes the prompts' K/V into the pools.  ``lengths`` is on
    the model's device, ``lengths_host`` / ``tables_host`` are the same
    metadata on the CPU for the K/V scatter."""
    b, t = tokens.shape
    dev = tokens.device
    pos = torch.arange(t, device=dev).clamp(0, cfg.max_context - 1)
    # .float(): a bf16 table is upcast where it is read (see _mm)
    x = p["embed"][tokens].float() + p["pos_embed"][pos][None].float()
    segments = segments_from_lengths(lengths, b, t)
    kv_index = _kv_index(k_pool, tables_host,
                         torch.zeros((b,), dtype=torch.int32), lengths_host,
                         t, dev)
    dh = cfg.dim // cfg.heads
    for i in range(cfg.layers):
        q, k, v = _qkv(_rms(x, p[f"l{i}.ln1"]), p, i, cfg.heads)
        # the decode contract: K/V are in the pages before any later
        # step queries them — write the whole prompt now
        paged_kv_scatter(k_pool[i], v_pool[i], k, v, kv_index)
        attn, _ = prefill_attention_packed(
            q.reshape(1, b * t, cfg.heads, dh),
            k.reshape(1, b * t, cfg.heads, dh),
            v.reshape(1, b * t, cfg.heads, dh),
            segments, causal=True, slot=t)
        x = x + _mm(attn.reshape(b, t, cfg.dim), p[f"l{i}.wo"])
        x = _ffn(x, p, i)
    idx = (lengths.long() - 1).clamp(0, t - 1)
    last = x[torch.arange(b, device=dev), idx]
    logits = _mm(_rms(last, p["ln_f"]), p["lm_head"])
    nxt = torch.argmax(eos_frozen_logits(logits, lengths > 0, cfg.eos_id),
                       dim=-1)
    return nxt, logits


def _decode_impl(p: Params, k_pool, v_pool, tokens, tables, lengths, active,
                 tables_host, lengths_host, active_host, cfg: DecoderConfig):
    """One decode step for a fixed-width batch.  ``lengths`` INCLUDE the
    token being fed (its position is ``lengths - 1``); ``active`` masks
    padded slots — their K/V write count is zero and their kernel length
    is 1 over the scratch page, so padding neither writes nor reads real
    pool state."""
    b = tokens.shape[0]
    pos = (lengths.long() - 1).clamp(0, cfg.max_context - 1)
    x = (p["embed"][tokens].float()
         + p["pos_embed"][pos].float())[:, None, :]
    kv_index = _kv_index(k_pool, tables_host, lengths_host - 1,
                         active_host.to(torch.int32), 1, tokens.device)
    klen = torch.where(active, lengths, torch.ones_like(lengths))
    for i in range(cfg.layers):
        q, k, v = _qkv(_rms(x, p[f"l{i}.ln1"]), p, i, cfg.heads)
        paged_kv_scatter(k_pool[i], v_pool[i], k, v, kv_index)
        attn = paged_decode_attention(q, k_pool[i], v_pool[i], tables, klen)
        x = x + _mm(attn.reshape(b, 1, cfg.dim), p[f"l{i}.wo"])
        x = _ffn(x, p, i)
    logits = _mm(_rms(x[:, 0], p["ln_f"]), p["lm_head"])
    nxt = torch.argmax(eos_frozen_logits(logits, active, cfg.eos_id), dim=-1)
    return nxt, logits


def _host_int32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.int32)))


class DecoderModel(nn.Module):
    """A decoder's weights on one device, with its prefill and decode
    steps.  Pools are owned by the caller (the server) and passed to
    every call; the model holds no KV state, so one model serves any
    number of pools.

    Weights are fp32, except that bf16 tensors (an int8 artifact
    dequantized to bf16) stay bf16 and are upcast at each product
    (:func:`_mm`).  ``debug_prefill_delay_s`` (0 unless an artifact's
    manifest sets ``debug_prefill_delay_ms``) is a testing knob the
    server sleeps inside every prefill's TTFT."""

    debug_prefill_delay_s = 0.0

    def __init__(self, params: Mapping[str, Any], cfg: DecoderConfig,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        enforce(cfg.dim % cfg.heads == 0,
                f"dim {cfg.dim} not divisible by heads {cfg.heads}")
        self.cfg = cfg
        self.device = resolve_device(device)
        bf16 = {n for n, w in params.items()
                if isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16}
        tensors = params_from_jax(
            {n: (w.detach().float().cpu().numpy()
                 if isinstance(w, torch.Tensor) else w)
             for n, w in params.items()}, cfg, self.device)
        for name in bf16:       # exact: the values came from bf16
            tensors[name] = tensors[name].to(torch.bfloat16)
        # buffer names may not hold '.', so "l0.wq" is kept as "l0__wq"
        for name, t in tensors.items():
            self.register_buffer(name.replace(".", "__"), t)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return {n: getattr(self, n.replace(".", "__"))
                for n in decoder_param_shapes(self.cfg)}

    # ----------------------------------------------------------- pools
    def new_pools(self, n_pages: int, page_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zeroed per-layer K/V pools, ``[L, P, page, H, Dh]``."""
        dh = self.cfg.dim // self.cfg.heads
        shape = (self.cfg.layers, n_pages, page_size, self.cfg.heads, dh)
        return (torch.zeros(shape, dtype=torch.float32, device=self.device),
                torch.zeros(shape, dtype=torch.float32, device=self.device))

    # ----------------------------------------------------------- steps
    @torch.no_grad()
    def prefill(self, k_pool, v_pool, tokens, lengths, page_indices):
        """Prompts in, first generated token out.  ``tokens`` [B, T] int
        padded, ``lengths`` [B], ``page_indices`` [B, max_pages] page
        tables covering each prompt plus the tokens to be generated
        (host arrays).  Returns ``(next tokens as numpy int32, logits
        [B, V] on the device, k_pool, v_pool)``; the pools are updated
        in place."""
        tokens = np.asarray(tokens)
        enforce(tokens.ndim == 2 and tokens.shape[1] <= self.cfg.max_context,
                f"prompt batch {tokens.shape} exceeds max_context "
                f"{self.cfg.max_context}")
        lengths_host = _host_int32(lengths)
        nxt, logits = _prefill_impl(
            self.params, k_pool, v_pool,
            torch.from_numpy(tokens.astype(np.int64)).to(self.device),
            lengths_host.to(self.device), lengths_host,
            _host_int32(page_indices), self.cfg)
        return (nxt.cpu().numpy().astype(np.int32), logits, k_pool, v_pool)

    @torch.no_grad()
    def decode(self, k_pool, v_pool, tokens, page_indices, lengths, active):
        """One continuous-batching decode step over the page pool (host
        arrays in; same returns as :meth:`prefill`)."""
        tables_host = _host_int32(page_indices)
        lengths_host = _host_int32(lengths)
        active_host = torch.from_numpy(np.asarray(active, bool))
        nxt, logits = _decode_impl(
            self.params, k_pool, v_pool,
            torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device),
            tables_host.to(self.device), lengths_host.to(self.device),
            active_host.to(self.device), tables_host, lengths_host,
            active_host, self.cfg)
        return (nxt.cpu().numpy().astype(np.int32), logits, k_pool, v_pool)

    # -------------------------------------------------------- artifacts
    @classmethod
    def from_artifact(cls, dirname: str, verify: bool = True,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> "DecoderModel":
        """Load an exported decoder artifact (int8 entries dequantized
        once at load, to the manifest's dtype); ``verify`` re-hashes the
        payload first, so a torn artifact raises
        :class:`loader.TornArtifact`."""
        manifest = _loader.read_manifest(dirname)
        if verify:
            _loader.verify_artifact(dirname, manifest)
        enforce(manifest.get("kind") == "decoder",
                f"{dirname}: not a decoder artifact "
                f"(kind={manifest.get('kind')!r}); ServedModel.load "
                "handles module artifacts")
        cfg = DecoderConfig(**manifest["decoder"])
        wsec = manifest["weights"]
        weights = _loader.load_weight_tensors(dirname, wsec)
        params = {e["name"]: w for e, w in zip(wsec["entries"], weights)}
        model = cls(params, cfg, device=device)
        # testing/bench knob (export_decoder extra_meta): a seeded-slow
        # artifact carries debug_prefill_delay_ms; the server sleeps it
        # inside the TTFT stamp, so a canary bake has a deterministic
        # latency regression to detect
        delay_ms = manifest.get("debug_prefill_delay_ms")
        if delay_ms:
            model.debug_prefill_delay_s = float(delay_ms) / 1e3
        return model


def export_decoder(params: Mapping[str, Any], cfg: DecoderConfig,
                   dirname: str, quantize: Optional[str] = "int8",
                   dequant_dtype: str = "float32",
                   extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Write a decoder artifact: the version-2 weights layout (int8
    per-channel for >=2-D floats when ``quantize="int8"``, dequantized
    to ``dequant_dtype`` at load; raw otherwise) plus ``"kind":
    "decoder"`` and the config in the manifest.  ``params`` may be numpy
    arrays or tensors.

    ``extra_meta`` lands verbatim in the manifest (a key that collides
    with a manifest field raises): the rollout pipeline records
    provenance there (``source_ckpt_digest``, ``source_ckpt``)."""
    params = {n: (w.detach().cpu().numpy() if isinstance(w, torch.Tensor)
                  else np.asarray(w)) for n, w in params.items()}
    if quantize is None:
        store = {}
        entries = []
        for name in sorted(params):
            arr = params[name]
            store["w::" + name] = arr
            entries.append({"name": name, "shape": list(arr.shape),
                            "dtype": str(arr.dtype), "quantized": False,
                            "axis": None})
        scheme = "none"
    else:
        enforce(quantize == "int8",
                f"export_decoder: unknown quantize scheme {quantize!r}")
        store, entries = _export.quantize_weight_store(params,
                                                       dequant_dtype)
        scheme = _export.QUANT_SCHEME
    os.makedirs(dirname, exist_ok=True)
    np.savez(os.path.join(dirname, _export.WEIGHTS_FILE), **store)
    manifest = {
        "format": _export.FORMAT_NAME,
        "version": _export.QUANT_FORMAT_VERSION,
        "kind": "decoder",
        "decoder": dict(cfg._asdict()),
        "weights": {
            "file": _export.WEIGHTS_FILE,
            "scheme": scheme,
            "dequant_dtype": dequant_dtype,
            "entries": entries,
        },
    }
    for k, v in (extra_meta or {}).items():
        enforce(k not in manifest,
                f"export_decoder: extra_meta key {k!r} collides with a "
                "manifest field")
        manifest[k] = v
    _export.stamp_manifest(manifest, dirname, [_export.WEIGHTS_FILE])
    with open(os.path.join(dirname, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return dirname
