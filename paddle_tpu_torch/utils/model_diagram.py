"""Graphviz model diagrams (``python/paddle/utils/make_model_diagram.py``).

Emits DOT text from a parsed :class:`ModelConfig` — no graphviz binary
needed to generate; render with ``dot -Tpng`` wherever available.
Counterpart of ``paddle_tpu/utils/model_diagram.py``, the port's own copy.
"""

from __future__ import annotations

from typing import List

from ..config.model_config import ModelConfig

_COLORS = {
    "data": "lightblue",
    "fc": "lightyellow",
    "exconv": "lightsalmon",
    "mixed": "lightcyan",
}


def _node(name: str) -> str:
    return '"' + name.replace('"', "'") + '"'


def model_to_dot(model: ModelConfig, name: str = "model") -> str:
    lines: List[str] = [f"digraph {name} {{", "  rankdir=BT;"]
    costs = set()
    for l in model.layers:
        color = _COLORS.get(l.type)
        if "cost" in l.type or "entropy" in l.type:
            color = "tomato"
        shape = "box" if l.type != "data" else "ellipse"
        style = f', style=filled, fillcolor="{color}"' if color else ""
        lines.append(
            f"  {_node(l.name)} [shape={shape}, "
            f'label="{l.name}\\n{l.type} ({l.size})"{style}];')
    for l in model.layers:
        for i in l.input_names():
            src = i.split(".", 1)[0]
            lines.append(f"  {_node(src)} -> {_node(l.name)};")
    for sm in model.sub_models:
        if sm.name == "root" or not sm.layer_names:
            continue
        lines.append(f'  subgraph "cluster_{sm.name}" {{')
        lines.append(f'    label="{sm.name}"; color=gray;')
        for ln in sm.layer_names:
            lines.append(f"    {_node(ln)};")
        lines.append("  }")
    lines.append("}")
    return "\n".join(lines)
