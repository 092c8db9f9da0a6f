"""Canonical content-based fingerprints for plans, exprs and configs.

Counterpart of ``presto_tpu/cache/fingerprint.py``. Everything here
hashes by VALUE, never by identity:

- plan nodes, exprs and operator configs are frozen dataclasses: they
  serialize field by field with a class tag;
- a ``Dictionary`` hashes by its content (the sorted value tuple), so two
  scans of one table, which build distinct but equal dictionaries, share
  a key;
- a torch tensor hashes by its dtype, shape and bytes (read on the host),
  never by the tensor object or its storage;
- tables contribute (connector, name, catalog version), so DDL that bumps
  a version changes every fingerprint that read the table: result-cache
  invalidation falls out of the key itself.

The serialization is tag-length-value into one sha256, so nested
structures cannot collide by concatenation. The digests are the port's
own: they need not equal the JAX package's, only share and differ where
its do. A plan's fingerprint folds the session's mesh shape (its axis
names, shape and devices; ``()`` for a local session), so a local and a
mesh session never share a fingerprint, a cached result or a cached step.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
from typing import Optional

import numpy as np
import torch

from presto_tpu_torch.batch import Dictionary

#: scalar functions whose value is not a pure function of their inputs:
#: the result cache refuses any plan that calls one
NONDETERMINISTIC_FNS = frozenset({"now", "random", "rand", "uuid",
                                  "current_timestamp", "current_date"})

#: session properties that change what a query computes; they feed the
#: plan fingerprint. ``approx_join`` changes results (a Bloom semi join
#: may keep false positives). ``narrow_storage`` is folded through the
#: resolved physical scan schemas instead (``physical_scan_schemas``).
CODEGEN_PROPERTIES = (
    "join_build_budget_bytes",
    "direct_group_limit",
    "pallas_strings",
    "approx_join",
    # approx_scan_fraction < 1 drops splits (sampled scans): sampled and
    # exact runs must never share cached results
    "approx_scan_fraction",
)

def _mesh_shape(mesh) -> tuple:
    """The mesh part of a fingerprint: ``()`` for a local session, else
    the axis names, the shape and the shards' devices."""
    if mesh is None:
        return ()
    return (tuple(mesh.axis_names), tuple(int(s) for s in mesh.shape),
            tuple(str(d) for d in mesh.devices))


class Unfingerprintable(TypeError):
    """An object with no canonical content serialization reached the
    fingerprinter (an open file, a raw callable). Callers treat the
    enclosing plan or config as uncacheable rather than guessing."""


def dictionary_fingerprint(d: Dictionary) -> str:
    """Content hash of an ordered dictionary, cached on the object
    (dictionaries are immutable after construction)."""
    fp = d._bytes_mats.get("content_fp")
    if fp is None:
        h = hashlib.sha256()
        for v in d.values.tolist():
            b = v.encode("utf-8", "surrogatepass")
            h.update(len(b).to_bytes(4, "little"))
            h.update(b)
        fp = h.hexdigest()
        d._bytes_mats["content_fp"] = fp
    return fp


def _canon(obj, h) -> None:
    """Feed ``obj``'s canonical tag-length-value serialization to ``h``."""
    if obj is None:
        h.update(b"N")
    elif obj is True:
        h.update(b"T")
    elif obj is False:
        h.update(b"F")
    elif isinstance(obj, (int, np.integer)):
        b = str(int(obj)).encode()
        h.update(b"i" + len(b).to_bytes(4, "little") + b)
    elif isinstance(obj, (float, np.floating)):
        b = float(obj).hex().encode()
        h.update(b"f" + len(b).to_bytes(4, "little") + b)
    elif isinstance(obj, str):
        b = obj.encode("utf-8", "surrogatepass")
        h.update(b"s" + len(b).to_bytes(4, "little") + b)
    elif isinstance(obj, bytes):
        h.update(b"b" + len(obj).to_bytes(4, "little") + obj)
    elif isinstance(obj, enum.Enum):
        _canon(type(obj).__name__, h)
        _canon(obj.name, h)
    elif isinstance(obj, Dictionary):
        h.update(b"D")
        _canon(dictionary_fingerprint(obj), h)
    elif isinstance(obj, torch.Tensor):
        h.update(b"t")
        _canon(str(obj.dtype), h)
        _canon(tuple(obj.shape), h)
        h.update(obj.detach().cpu().contiguous().numpy().tobytes())
    elif isinstance(obj, (torch.dtype, torch.device)):
        _canon(str(obj), h)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        h.update(b"C")
        _canon(type(obj).__name__, h)
        for f in dataclasses.fields(obj):
            _canon(f.name, h)
            _canon(getattr(obj, f.name), h)
        h.update(b".")
    elif isinstance(obj, (tuple, list)):
        h.update(b"(")
        for x in obj:
            _canon(x, h)
        h.update(b")")
    elif isinstance(obj, (set, frozenset)):
        h.update(b"{")
        for x in sorted(fingerprint(x) for x in obj):
            _canon(x, h)
        h.update(b"}")
    elif isinstance(obj, dict):
        h.update(b"[")
        for k in sorted(obj, key=repr):
            _canon(k, h)
            _canon(obj[k], h)
        h.update(b"]")
    elif isinstance(obj, np.generic):
        # remaining numpy scalar kinds (datetime64 literals): repr is
        # canonical for a given dtype and value
        _canon(str(obj.dtype), h)
        _canon(repr(obj), h)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            # tobytes() of an object array serializes element pointers
            raise Unfingerprintable("object-dtype ndarray")
        _canon(str(obj.dtype), h)
        _canon(obj.shape, h)
        h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, type):
        _canon(f"{obj.__module__}.{obj.__qualname__}", h)
    else:
        raise Unfingerprintable(f"no canonical serialization for {type(obj).__name__}")


def fingerprint(*parts) -> str:
    """sha256 hex digest of the parts' canonical serialization."""
    h = hashlib.sha256()
    for p in parts:
        _canon(p, h)
    return h.hexdigest()


def try_fingerprint(*parts) -> Optional[str]:
    """``fingerprint`` that answers None for uncacheable content."""
    try:
        return fingerprint(*parts)
    except Unfingerprintable:
        return None


def expr_fingerprint(expr) -> str:
    """Content hash of one expression tree."""
    return fingerprint(expr)


# ---------------------------------------------------------------------------
# plan-level fingerprints
# ---------------------------------------------------------------------------


def referenced_tables(plan) -> "tuple[tuple[str, str], ...]":
    """Every (connector, table) pair scanned under ``plan``, deduped, in
    sorted order."""
    from presto_tpu_torch.plan import nodes as N

    out: dict[tuple[str, str], None] = {}

    def walk(node):
        if isinstance(node, N.TableScan):
            out[(node.connector, node.table)] = None
        for c in node.children:
            walk(c)

    walk(plan)
    return tuple(sorted(out))


def _walk_exprs(obj, found: set) -> None:
    from presto_tpu_torch.expr import Call

    if isinstance(obj, Call):
        found.add(obj.fn)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _walk_exprs(getattr(obj, f.name), found)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _walk_exprs(x, found)


def plan_functions(plan) -> frozenset:
    """Every scalar-function name anywhere in the plan tree."""
    found: set = set()
    _walk_exprs(plan, found)
    return frozenset(found)


def plan_is_deterministic(plan, catalog) -> bool:
    """True when re-running the plan against unchanged tables must give
    the same rows: no volatile scalar functions and no scans of volatile
    connectors (the ``system`` tables change between calls)."""
    if plan_functions(plan) & NONDETERMINISTIC_FNS:
        return False
    for cname, _table in referenced_tables(plan):
        conn = catalog.connectors.get(cname)
        if conn is None or getattr(conn, "volatile", False):
            return False
    return True


def table_versions(plan, catalog) -> "tuple[tuple[str, int], ...]":
    """(table, catalog version) for every referenced table: the caches
    store these when they fill and re-check them when they answer."""
    return tuple((t, catalog.version(t)) for _c, t in referenced_tables(plan))


def physical_scan_schemas(plan, catalog) -> tuple:
    """The resolved physical storage of every scanned column,
    (connector, table, ((col, 'bigint:int16'), ...)) per TableScan: the
    ``narrow_storage`` switch changes the fingerprint through the types
    it resolves to."""
    from presto_tpu_torch.plan import nodes as N

    out = []

    def walk(node):
        if isinstance(node, N.TableScan):
            conn = catalog.connectors.get(node.connector)
            cols = [s for _n, s in node.columns]
            if conn is not None and hasattr(conn, "physical_schema"):
                try:
                    sch = conn.physical_schema(node.table, cols)
                    out.append((node.connector, node.table,
                                tuple((c, sch[c].physical_str()) for c in cols)))
                except KeyError:
                    pass  # a table dropped mid-plan: the versions catch it
        for c in node.children:
            walk(c)

    walk(plan)
    return tuple(sorted(out))


def plan_fingerprint(plan, catalog, properties: dict | None = None,
                     mesh=None) -> Optional[str]:
    """The canonical identity of one executable query: plan structure and
    expressions, the referenced tables with their catalog versions, the
    physical scan schemas, the mesh part and every result-changing
    session property. None when the plan holds uncacheable content."""
    from presto_tpu_torch.runtime.properties import effective

    props = {name: effective(properties or {}, name) for name in CODEGEN_PROPERTIES}
    return try_fingerprint(
        plan,
        table_versions(plan, catalog),
        referenced_tables(plan),
        physical_scan_schemas(plan, catalog),
        _mesh_shape(mesh),
        props,
    )
