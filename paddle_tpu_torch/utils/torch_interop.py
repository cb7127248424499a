"""Import ``torch.nn``-trained weights (counterpart of
``paddle_tpu/utils/torch_interop.py``, the ``torch2paddle`` answer).

Reference: ``python/paddle/utils/torch2paddle.py`` converted Torch7
models into reference ``Parameter`` files.  Here a ``torch.nn``
state_dict becomes a parameter dict in the framework's layouts (which
the port keeps: ROADMAP rule c), or a reference-layout model dir
(``trainer/interop.py`` raw buffers):

- ``nn.Linear.weight`` is ``[out, in]`` (y = x Wᵀ + b); fc weights
  are ``[in, out]``, so it is transposed.
- ``nn.Conv2d.weight`` is ``[out, in, kh, kw]`` (OIHW); conv weights
  are HWIO, so it is permuted to ``[kh, kw, in, out]``.
- biases and norm scales carry over unchanged.  Auto-detection treats
  EVERY 2-D ``*.weight`` as a Linear weight; for ``nn.Embedding``
  (already ``[vocab, dim]``) pass ``kinds={"emb.weight": "raw"}``.

The arrays come back as numpy, as the JAX package gives them; a
trainer places them on its device when it loads them.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np


def convert_tensor(name: str, value, kind: Optional[str] = None
                   ) -> np.ndarray:
    """One state_dict tensor in the framework's layout.  ``kind``
    overrides auto-detection: "linear_weight", "conv_weight" or
    "raw"."""
    arr = np.asarray(value.detach().cpu().numpy()
                     if hasattr(value, "detach") else value)
    if kind is None:
        if name.endswith(".weight") and arr.ndim == 2:
            kind = "linear_weight"
        elif name.endswith(".weight") and arr.ndim == 4:
            kind = "conv_weight"
        else:
            kind = "raw"
    if kind == "linear_weight":
        return np.ascontiguousarray(arr.T)          # [out,in] -> [in,out]
    if kind == "conv_weight":
        return np.ascontiguousarray(
            arr.transpose(2, 3, 1, 0))              # OIHW -> HWIO
    return arr


def torch_state_dict_to_params(
        state_dict: Mapping[str, Any],
        name_map: Mapping[str, str],
        kinds: Optional[Mapping[str, str]] = None
        ) -> Dict[str, np.ndarray]:
    """A torch state_dict as a parameter dict.  ``name_map``: {torch
    name: parameter name}; an entry absent from the state_dict raises.
    ``kinds`` overrides the layout conversion by torch name."""
    out: Dict[str, np.ndarray] = {}
    for tname, pname in name_map.items():
        if tname not in state_dict:
            raise KeyError(f"torch state_dict lacks {tname!r} "
                           f"(has {sorted(state_dict)[:8]}...)")
        out[pname] = convert_tensor(
            tname, state_dict[tname],
            (kinds or {}).get(tname))
    return out


def import_torch_model(module_or_state_dict,
                       name_map: Mapping[str, str],
                       save_dir: Optional[str] = None,
                       kinds: Optional[Mapping[str, str]] = None
                       ) -> Dict[str, np.ndarray]:
    """state_dict (or ``nn.Module``) → parameters; with ``save_dir``
    also a reference-layout model dir (``Parameter::save`` raw buffers)
    that feeds ``merge_model``."""
    sd = module_or_state_dict
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    params = torch_state_dict_to_params(sd, name_map, kinds)
    if save_dir:
        from ..trainer.interop import save_reference_model_dir
        save_reference_model_dir(save_dir, params)
    return params
