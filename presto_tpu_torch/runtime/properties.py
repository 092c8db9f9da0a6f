"""Session properties (the subset the ported planner reads).

Counterpart of ``presto_tpu/runtime/properties.py``: typed, validated
per-session overrides of engine defaults, with the JAX package's names,
types and defaults. Unknown names are errors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from presto_tpu_torch.runtime.errors import UserError


@dataclass(frozen=True)
class PropertyDef:
    name: str
    py_type: type
    default: Any
    description: str

    def coerce(self, value):
        """Coerce a user-supplied value (possibly a SQL literal string)
        to the property's type."""
        if value is None:
            return None
        if self.py_type is bool and isinstance(value, str):
            s = value.strip().lower()
            if s in ("true", "1", "on", "yes"):
                return True
            if s in ("false", "0", "off", "no"):
                return False
        elif not isinstance(value, str):
            try:
                return self.py_type(value)
            except (TypeError, ValueError):
                pass
        raise UserError(f"session property {self.name}: cannot interpret "
                        f"{value!r} as a {self.py_type.__name__}")


SESSION_PROPERTIES: dict[str, PropertyDef] = {
    d.name: d
    for d in [
        PropertyDef(
            "pallas_join", bool, True,
            "Prefer the fused lookup-table probe kernels for equi-joins "
            "on narrow stats-bounded keys (ops/cuda_join.py). Ineligible "
            "joins fall back to the dense or sorted probes with a "
            "join.pallas_fallback counter; results are identical."),
        PropertyDef(
            "narrow_storage", bool, None,
            "Stats-driven narrow physical column storage: scans "
            "materialize int8/int16/int32 device columns wherever "
            "connector value bounds permit, which arms the fused leaf "
            "route (exec/leaf_route.py). Process-wide, mirrors the "
            "PRESTO_TPU_NARROW environment variable; default: on. Off "
            "takes the generic operators with canonical storage; "
            "results are bit-identical either way."),
    ]
}


def validate_properties(props: dict) -> dict:
    """Coerce + validate a property mapping; unknown names are errors."""
    out = {}
    for name, value in props.items():
        d = SESSION_PROPERTIES.get(name)
        if d is None:
            known = ", ".join(sorted(SESSION_PROPERTIES))
            raise UserError(f"unknown session property {name!r} (known: {known})")
        out[name] = d.coerce(value)
    return out


def effective(props: dict, name: str):
    """Value of a property under the session overrides."""
    return props.get(name, SESSION_PROPERTIES[name].default)
