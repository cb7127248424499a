"""Take the JAX package's parameters (network buffers, optimizer state)
into the port.

The JAX side hands over a dict of numpy arrays (``np.asarray`` of its
params, or ``init_decoder_params`` directly); this module does not
import JAX.  Names are checked against the port's own specs and layouts
stay as they are: weight matrices are ``[in, out]`` and applied as
``x @ W``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from .error import enforce


def decoder_param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Name → shape of every decoder parameter for ``cfg`` (a
    ``DecoderConfig``): the artifact contract."""
    shapes: Dict[str, Tuple[int, ...]] = {
        "embed": (cfg.vocab, cfg.dim),
        "pos_embed": (cfg.max_context, cfg.dim),
        "ln_f": (cfg.dim,),
        "lm_head": (cfg.dim, cfg.vocab),
    }
    for i in range(cfg.layers):
        shapes[f"l{i}.ln1"] = (cfg.dim,)
        shapes[f"l{i}.ln2"] = (cfg.dim,)
        for w in ("wq", "wk", "wv", "wo"):
            shapes[f"l{i}.{w}"] = (cfg.dim, cfg.dim)
        shapes[f"l{i}.w1"] = (cfg.dim, cfg.ffn)
        shapes[f"l{i}.w2"] = (cfg.ffn, cfg.dim)
    return shapes


def params_from_jax(np_params: Mapping[str, np.ndarray], cfg,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The JAX decoder's params as fp32 tensors on ``device`` (default
    CUDA; raises when CUDA is absent and the CPU was not asked for)."""
    dev = resolve_device(device)
    want = decoder_param_shapes(cfg)
    enforce(set(np_params) == set(want),
            f"decoder params do not match the config: missing "
            f"{sorted(set(want) - set(np_params))}, unexpected "
            f"{sorted(set(np_params) - set(want))}")
    out: Dict[str, torch.Tensor] = {}
    for name, shape in want.items():
        arr = np.asarray(np_params[name], dtype=np.float32)
        enforce(arr.shape == shape,
                f"param {name}: shape {arr.shape} != expected {shape}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    return out


def network_params_from_jax(np_params: Mapping[str, np.ndarray], net,
                            device: Optional[Union[str, torch.device]] = None
                            ) -> Dict[str, torch.Tensor]:
    """The JAX ``NeuralNetwork.init_params`` output (as numpy) as fp32
    tensors on ``device`` for the port's ``net`` (a
    ``paddle_tpu_torch.layers.network.NeuralNetwork``): every name and
    shape must equal the port's ``param_specs``, else this raises."""
    dev = resolve_device(device)
    want = {n: tuple(s.dims) if s.dims else (s.size,)
            for n, s in net.param_specs.items()}
    enforce(set(np_params) == set(want),
            f"params do not match the network: missing "
            f"{sorted(set(want) - set(np_params))}, unexpected "
            f"{sorted(set(np_params) - set(want))}")
    out: Dict[str, torch.Tensor] = {}
    for name in sorted(want):
        arr = np.array(np_params[name], dtype=np.float32)   # a copy
        enforce(arr.shape == want[name],
                f"param {name}: shape {arr.shape} != expected {want[name]}")
        out[name] = torch.from_numpy(arr).to(dev)
    return out


def network_buffers_from_jax(np_buffers: Mapping[str, np.ndarray], net,
                             device: Optional[Union[str, torch.device]] = None
                             ) -> Dict[str, torch.Tensor]:
    """The JAX ``NeuralNetwork.init_buffers`` output (or a step's new
    buffers, as numpy) as fp32 tensors on ``device`` for the port's
    ``net``: every name and shape must equal the port's
    ``init_buffers()``, else this raises."""
    dev = resolve_device(device)
    want = {n: tuple(b.shape) for n, b in net.init_buffers("cpu").items()}
    enforce(set(np_buffers) == set(want),
            f"buffers do not match the network: missing "
            f"{sorted(set(want) - set(np_buffers))}, unexpected "
            f"{sorted(set(np_buffers) - set(want))}")
    out: Dict[str, torch.Tensor] = {}
    for name in sorted(want):
        arr = np.array(np_buffers[name], dtype=np.float32)   # a copy
        enforce(arr.shape == want[name],
                f"buffer {name}: shape {arr.shape} != expected {want[name]}")
        out[name] = torch.from_numpy(arr).to(dev)
    return out


def opt_state_from_jax(count, np_slots: Mapping[str, Sequence[np.ndarray]],
                       params: Mapping[str, torch.Tensor],
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Tuple[torch.Tensor, Dict[str, tuple]]:
    """The JAX trainer's optimizer state as the port's ``(count, slots by
    name)`` on ``device`` (default CUDA, as above).  ``count`` is the JAX
    step count; ``np_slots`` maps each parameter name to its slot tuple
    (the JAX slot list is in the order of ``sorted(params)``), as numpy.
    Names must equal ``params``' and a slot of several elements its
    parameter's shape, else this raises."""
    dev = resolve_device(device)
    enforce(set(np_slots) == set(params),
            f"slots do not match the params: missing "
            f"{sorted(set(params) - set(np_slots))}, unexpected "
            f"{sorted(set(np_slots) - set(params))}")
    slots: Dict[str, tuple] = {}
    for name in sorted(np_slots):
        want = tuple(params[name].shape)
        arrs = [np.array(x, dtype=np.float32) for x in np_slots[name]]
        enforce(all(a.size == 1 or a.shape == want for a in arrs),
                f"slots of {name}: shapes {[a.shape for a in arrs]} vs "
                f"{want}")
        slots[name] = tuple(torch.from_numpy(a).to(dev) for a in arrs)
    return (torch.tensor(int(count), dtype=torch.int32, device=dev), slots)
