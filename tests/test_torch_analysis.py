"""The port's static analyzer (``presto_tpu_torch/analysis``) against the
JAX package's.

- Twins of ``tests/test_analysis.py``'s fixtures where a rule's meaning
  carries over (PT001, PT103, PT201's env and captured knobs, PT301-303,
  PT401-403, suppressions, the baseline, the JSON schema): the same
  source gives the same findings (rule, line, column) in both analyzers.
  The snippets are the reference's own.
- The port's readings of the JAX-shaped rules: PT101 / PT102 flag host
  syncs and branches on tensors in cached step bodies (what an
  ``EXEC_CACHE.get_or_build`` builder returns, the nested ``step`` of a
  ``*_step`` builder) and kernel wrappers (functions calling
  ``check_launch``); PT201 holds the ``pallas_strings`` switch to the
  key like any knob (the port's ``key_of`` folds none of its own).
- ``test_port_analyzes_clean``: ``presto_tpu_torch/`` and
  ``chip_smoke.py`` have no open finding against the port's baseline,
  and the CLI's default run exits 0.
The tests write fixtures to ``tmp_path`` and analyze that directory as
the repo root; neither analyzer imports the code it analyzes.
"""

import json
import os

import pytest

import test_analysis as J
from presto_tpu.analysis import RULES as J_RULES
from presto_tpu.analysis import analyze as j_analyze
from presto_tpu_torch.analysis import RULES as P_RULES
from presto_tpu_torch.analysis import analyze as p_analyze
from presto_tpu_torch.analysis.findings import SCHEMA_VERSION

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(analyze, tmp_path, sources: dict, rules=None, baseline=None):
    for name, src in sources.items():
        (tmp_path / name).write_text(src)
    return analyze([str(tmp_path)], root=str(tmp_path), rule_ids=rules,
                   baseline=baseline or [])


def located(result):
    return [(f.rule, f.line, f.col) for f in result.findings]


def test_rule_catalog_equals_reference():
    import presto_tpu.analysis.rules  # noqa: F401
    import presto_tpu_torch.analysis.rules  # noqa: F401

    assert sorted(P_RULES) == sorted(J_RULES)
    for rid, rule in P_RULES.items():
        assert (rule.name, rule.severity) == (J_RULES[rid].name, J_RULES[rid].severity), rid
        assert rule.description and rule.motivation, rid


PT102_BAD = """
import jax


def _make_step():
    def step(batch):
        if batch > 0:
            return batch
        return -batch
    return jax.jit(step)
"""

PT102_GOOD = """
import jax


def _make_step():
    def step(batch, aux=None):
        if aux is not None:
            batch = batch + aux
        if batch.shape[0] > 8:
            batch = batch[:8]
        return batch
    return jax.jit(step)
"""

PT103_BAD = """
from presto_tpu.expr import evaluate


def project(batch, params):
    return evaluate(batch, None)
"""

PT103_GOOD = """
from presto_tpu.expr import evaluate, param_scope


def project(batch, params):
    with param_scope(params):
        return evaluate(batch, None)
"""

PT103_PRIVATE = """
from presto_tpu import expr


def peek():
    return expr._PARAM_VALUES.get()
"""

PT201_CAPTURED = """
from presto_tpu.cache.exec_cache import EXEC_CACHE
from presto_tpu.spi import narrow_enabled


def build():
    narrow = narrow_enabled()
    return EXEC_CACHE.get_or_build(
        EXEC_CACHE.key_of("step", 7),
        lambda: (lambda b: b + (1 if narrow else 0)))
"""

PT303_SELF = """
import threading


class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def reserve(self):
        with self._lock:
            self._n += 1
            return self.describe()

    def describe(self):
        with self._lock:
            return str(self._n)


class RPool:
    def __init__(self):
        self._cv = threading.Condition()
        self._n = 0

    def reserve(self):
        with self._cv:
            self._n += 1
            return self.describe()

    def describe(self):
        with self._cv:
            return str(self._n)
"""

PT303_ACQUIRE = """
import threading


class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def reserve(self):
        self._lock.acquire()
        try:
            self._n += 1
            return self.describe()
        finally:
            self._lock.release()

    def describe(self):
        with self._lock:
            return str(self._n)
"""

PT302_CYCLE = """
import threading


class Alpha:
    def __init__(self, other):
        self._lock = threading.Lock()
        self.other = other

    def ping_alpha(self):
        with self._lock:
            self.other.pong_beta()


class Beta:
    def __init__(self, other):
        self._lock = threading.Lock()
        self.other = other

    def pong_beta(self):
        with self._lock:
            pass

    def back(self):
        with self._lock:
            self.other.ping_alpha()
"""

PT302_ONE_WAY = """
import threading


class Alpha:
    def __init__(self, other):
        self._lock = threading.Lock()
        self.other = other

    def ping_alpha(self):
        with self._lock:
            self.other.pong_beta()


class Beta:
    def __init__(self):
        self._lock = threading.Lock()

    def pong_beta(self):
        with self._lock:
            pass
"""

PT401_BAD = """
import os


def test_toggle():
    os.environ["PRESTO_TPU_NARROW"] = "1"
"""

PT401_GOOD = """
import os

import pytest


def test_toggle():
    before = os.environ.get("PRESTO_TPU_NARROW")
    os.environ["PRESTO_TPU_NARROW"] = "1"
    try:
        pass
    finally:
        if before is None:
            os.environ.pop("PRESTO_TPU_NARROW", None)
        else:
            os.environ["PRESTO_TPU_NARROW"] = before


@pytest.fixture
def narrow_env():
    os.environ["PRESTO_TPU_NARROW"] = "1"
    yield
    os.environ.pop("PRESTO_TPU_NARROW", None)
"""

PT401_PARTIAL = """
import os


def test_two_keys():
    a = os.environ.get("PRESTO_TPU_A")
    os.environ["PRESTO_TPU_A"] = "1"
    os.environ["PRESTO_TPU_B"] = "1"
    try:
        pass
    finally:
        os.environ.pop("PRESTO_TPU_A", None)
"""

PT402_BAD = """
from presto_tpu.runtime.metrics import REGISTRY


def test_counters():
    REGISTRY.reset()
"""

PT402_MARKED = """
import pytest

from presto_tpu.runtime.metrics import REGISTRY


@pytest.mark.resets_global_state
def test_counters():
    REGISTRY.reset()
"""

PT402_PYTESTMARK = """
import pytest

from presto_tpu.runtime.metrics import REGISTRY

pytestmark = pytest.mark.resets_global_state


def test_counters():
    REGISTRY.reset()
"""

PT403_BAD = """
from presto_tpu.runtime.metrics import REGISTRY


def test_warm(session):
    t0 = REGISTRY.snapshot().get("exec.traces", 0)
    session.sql("select 1")
    assert REGISTRY.snapshot().get("exec.traces", 0) == t0
"""

PT403_GOOD = """
from presto_tpu.cache.exec_cache import trace_delta


def test_warm(session):
    with trace_delta() as td:
        session.sql("select 1")
    assert td.traces == 0
"""

REASONED = J.BAD_LOCKS.replace(
    "        self._items.remove(x)",
    "        # presto-lint: ignore[PT301] -- benchmark-only path, "
    "single-threaded by construction\n"
    "        self._items.remove(x)")

REASONLESS = J.BAD_LOCKS.replace(
    "        self._items.remove(x)",
    "        self._items.remove(x)  # presto-lint: ignore[PT301]")

#: name -> (file name, source, rules, the findings' rule ids)
TWINS = {
    "PT101 jitted bad step": ("mod.py", J.BAD_STEP, ["PT101"], ["PT101"] * 3),
    "PT101 static metadata": ("mod.py", J.GOOD_STEP, ["PT101"], []),
    "PT102 branch": ("mod.py", PT102_BAD, ["PT102"], ["PT102"]),
    "PT102 identity and shape": ("mod.py", PT102_GOOD, ["PT102"], []),
    "PT103 no scope": ("mod.py", PT103_BAD, ["PT103"], ["PT103"]),
    "PT103 scope": ("mod.py", PT103_GOOD, ["PT103"], []),
    "PT103 private": ("mod.py", PT103_PRIVATE, ["PT103"], ["PT103"]),
    "PT201 unkeyed env knob": ("mod.py", J.BAD_CACHE, ["PT201"], ["PT201"]),
    "PT201 hoisted keyed knob": ("mod.py", J.GOOD_CACHE, ["PT201"], []),
    "PT201 captured knob": ("mod.py", PT201_CAPTURED, ["PT201"], ["PT201"]),
    "PT301 unguarded": ("mod.py", J.BAD_LOCKS, ["PT301"], ["PT301"]),
    "PT301 locked suffix": ("mod.py", J.GOOD_LOCKS, ["PT301"], []),
    "PT303 self deadlock": ("mod.py", PT303_SELF, ["PT303"], ["PT303"]),
    "PT303 acquire/release": ("mod.py", PT303_ACQUIRE, ["PT303"], ["PT303"]),
    "PT302 cycle": ("mod.py", PT302_CYCLE, ["PT302"], ["PT302"]),
    "PT302 one way": ("mod.py", PT302_ONE_WAY, ["PT302"], []),
    "PT401 unrestored": ("test_env.py", PT401_BAD, ["PT401"], ["PT401"]),
    "PT401 restored": ("test_env.py", PT401_GOOD, ["PT401"], []),
    "PT401 partial": ("test_env.py", PT401_PARTIAL, ["PT401"], ["PT401"]),
    "PT402 reset": ("test_reg.py", PT402_BAD, ["PT402"], ["PT402"]),
    "PT402 marked": ("test_reg.py", PT402_MARKED, ["PT402"], []),
    "PT402 pytestmark": ("test_reg.py", PT402_PYTESTMARK, ["PT402"], []),
    "PT403 raw probe": ("test_tr.py", PT403_BAD, ["PT403"], ["PT403"] * 2),
    "PT403 window": ("test_tr.py", PT403_GOOD, ["PT403"], []),
    "suppressed with a reason": ("mod.py", REASONED, ["PT301"], []),
    "suppression without a reason": ("mod.py", REASONLESS, None, ["PT001", "PT301"]),
}


@pytest.mark.parametrize("name", list(TWINS))
def test_same_source_same_findings(tmp_path, name):
    fname, src, rules, ids = TWINS[name]
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = run(j_analyze, tmp_path / "j", {fname: src}, rules)
    got = run(p_analyze, tmp_path / "p", {fname: src}, rules)
    assert located(got) == located(want)
    assert sorted(f.rule for f in got.findings) == sorted(ids)
    assert len(got.suppressed) == len(want.suppressed)


def test_baseline_and_json_schema_equal_reference(tmp_path):
    res = run(p_analyze, tmp_path, {"mod.py": J.BAD_LOCKS}, ["PT301"])
    (finding,) = res.findings
    entry = {"rule": "PT301", "path": finding.path, "anchor": finding.anchor,
             "reason": "grandfathered: pre-lint code, scheduled fix"}
    res2 = run(p_analyze, tmp_path, {"mod.py": J.BAD_LOCKS}, ["PT301"], baseline=[entry])
    assert res2.findings == [] and len(res2.baselined) == 1
    drifted = dict(entry, anchor="self._items.remove(x, strict=True)")
    res3 = run(p_analyze, tmp_path, {"mod.py": J.BAD_LOCKS}, ["PT301"], baseline=[drifted])
    assert [f.rule for f in res3.findings] == ["PT301"]
    want = json.loads(run(j_analyze, tmp_path, {"mod.py": J.BAD_LOCKS}, ["PT301"]).to_json())
    assert json.loads(res.to_json()) == want
    assert want["version"] == SCHEMA_VERSION


# ---------------------------------------------------------------------------
# the port's readings of the JAX-shaped rules
# ---------------------------------------------------------------------------

TORCH_STEPS = """
import numpy as np
import torch

from presto_tpu_torch.cache.exec_cache import EXEC_CACHE
from presto_tpu_torch.ops import _build


def _probe_step(batch, table):
    n = int(batch.live.sum())
    keys = batch.keys.cpu()
    if n > 0 and table > 0:
        torch.cuda.synchronize()
    return keys[:n], table.tolist()


def _scan_step(spec):
    def step(b, bitmap):
        hit = bool((b.data > spec).any())
        rows = b.capacity
        return hit, rows, np.asarray(bitmap)
    return step


def launch(keys, out):
    code = 0
    if out.numel() > 0:
        code = int(keys.max())
    _build.check_launch(None, "probe", code)
    return out.item()


class Op:
    def __init__(self, key):
        self._step = EXEC_CACHE.get_or_build(EXEC_CACHE.key_of("probe", key),
                                             lambda: _probe_step)
        self._scan = EXEC_CACHE.get_or_build(EXEC_CACHE.key_of("scan", key),
                                             lambda: _scan_step(key))
"""


def test_pt101_pt102_flag_syncs_in_cached_steps_and_kernel_wrappers(tmp_path):
    res = run(p_analyze, tmp_path, {"mod.py": TORCH_STEPS}, ["PT101", "PT102"])
    got = sorted((f.rule, f.line) for f in res.findings)
    # _probe_step: int(), .cpu(), the branch on a parameter, synchronize,
    # .tolist(); the nested step: bool(), np.asarray (b.capacity is host
    # metadata); the wrapper: int(keys.max()) and .item() (out.numel()
    # is metadata)
    assert got == sorted([("PT101", 10), ("PT101", 11), ("PT102", 12), ("PT101", 13),
                          ("PT101", 14), ("PT101", 19), ("PT101", 21), ("PT101", 28),
                          ("PT101", 30)])


def test_pt101_silent_outside_steps_and_wrappers(tmp_path):
    src = TORCH_STEPS.replace("lambda: _probe_step", "lambda: None").replace(
        "lambda: _scan_step(key)", "lambda: None").replace(
        "_build.check_launch(None, \"probe\", code)", "pass").replace(
        "def _scan_step(spec):", "def _scan_helper(spec):")
    res = run(p_analyze, tmp_path, {"mod.py": src}, ["PT101", "PT102"])
    assert res.findings == []


def test_pt201_string_kernel_switch_must_be_keyed(tmp_path):
    env = """
import os
from presto_tpu_torch.cache.exec_cache import EXEC_CACHE


def build():
    return EXEC_CACHE.get_or_build(
        EXEC_CACHE.key_of("step", 7),
        lambda: (lambda b: b if os.environ.get("PRESTO_TPU_PALLAS") else -b))
"""
    prop = """
from presto_tpu_torch.cache.exec_cache import EXEC_CACHE


def build(session):
    return EXEC_CACHE.get_or_build(
        EXEC_CACHE.key_of("step", 7),
        lambda: (lambda b: b if session.prop("pallas_strings") else -b))
"""
    keyed = """
from presto_tpu_torch.cache.exec_cache import EXEC_CACHE


def build(session):
    pallas_strings = session.prop("pallas_strings")
    return EXEC_CACHE.get_or_build(
        EXEC_CACHE.key_of("step", 7, pallas_strings),
        lambda: (lambda b: b if pallas_strings else -b))
"""
    (f,) = run(p_analyze, tmp_path, {"mod.py": env}, ["PT201"]).findings
    assert f.data["knob"] == "env:PRESTO_TPU_PALLAS"
    (f,) = run(p_analyze, tmp_path, {"mod.py": prop}, ["PT201"]).findings
    assert f.data["knob"] == "prop:pallas_strings"
    assert run(p_analyze, tmp_path, {"mod.py": keyed}, ["PT201"]).findings == []


def test_port_analyzes_clean(capsys):
    """The port's tree and chip_smoke.py: no open finding against the
    port's baseline; every suppression carries a reason and every
    baseline entry a justification (``load_baseline`` asserts it)."""
    from presto_tpu_torch.analysis.__main__ import main
    from presto_tpu_torch.analysis.engine import load_baseline

    res = p_analyze([os.path.join(ROOT, "presto_tpu_torch"),
                     os.path.join(ROOT, "chip_smoke.py")], root=ROOT)
    assert res.findings == [], [f.render() for f in res.findings]
    assert all(sup.reason for _f, sup in res.suppressed)
    assert all(e["reason"] for e in load_baseline())
    assert main([]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("0 findings")
