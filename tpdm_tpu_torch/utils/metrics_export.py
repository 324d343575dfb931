"""Prometheus text-exposition rendering of engine/trainer stats dicts.

The port's own copy of ``tpdm_tpu/utils/metrics_export.py`` (pure Python,
unchanged), so that the port imports nothing of the JAX package.

Zero-dependency observability sink alongside the native TensorBoard writer
(utils/tb_writer.py): `prometheus_text(engine.stats())` turns the nested
stats dict every serving engine exposes into the text format any Prometheus
scraper ingests (served by the port's
``tpdm_tpu_torch/serve.py`` at GET /metrics). The reference has no
serving metrics at all; this rounds out the production surface.

Rendering rules:
- numeric scalars (int/float/bool) -> `<prefix>_<key> <value>`
- one level of dict nesting -> labels: {"adapter_batches": {"a": 3}}
  becomes `tpdm_adapter_batches{item="a"} 3`
- keys are sanitized to [a-zA-Z0-9_] (Prometheus metric-name charset);
  non-numeric values are skipped.
"""

from __future__ import annotations

import math
import re
from typing import Any, Mapping

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float, bool)) and not isinstance(v, str)


def prometheus_text(stats: Mapping[str, Any], prefix: str = "tpdm") -> str:
    """Render a stats dict as Prometheus text exposition format."""
    lines = []
    for key in sorted(stats):
        value = stats[key]
        name = f"{prefix}_{_sanitize(str(key))}"
        if _is_num(value):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(value)}")
        elif isinstance(value, Mapping):
            rows = [
                (str(k), v) for k, v in value.items() if _is_num(v)
            ]
            if rows:
                lines.append(f"# TYPE {name} gauge")
                for k, v in sorted(rows):
                    lines.append(
                        f'{name}{{item="{_escape_label(k)}"}} {_fmt(v)}'
                    )
        # strings/lists/None: not representable as a gauge; skipped
    return "\n".join(lines) + "\n"
