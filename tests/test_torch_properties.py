"""The port's single-device session properties against the JAX package's.

- ``Session.show_session``: the reference's rows, in its order, values
  equal, less ``degrade_to_local`` (the distributed-to-local degradation
  is not ported yet);
- ``direct_group_limit``: the grouping strategy each package picks
  (direct under the limit, sort past it), the frames and the
  ``agg.strategy.*`` counters equal, default and lowered;
- ``partial_agg_bypass``: a near-unique CTAS key bypasses partial
  aggregation by default and stays ``partial`` when off, in both
  packages, counted and rendered alike, frames equal;
- ``profile_dir``: one ``torch.profiler`` Chrome trace a query, named by
  its query id;
- ``pallas_strings``: off answers LIKE over byte columns alike through
  the plain version, the port's setting stays in its session (no
  process-wide mirror, no exec-cache key part: it picks no code); forced
  on in a CPU session it answers the reference's answer through the
  plain version, the CPU's one route (ROADMAP C23, closed: the reference
  answers through its interpret-mode kernel), and off in a CUDA session
  is refused (C25).
Exact comparisons throughout.
"""

import json
import os

import pandas as pd
import pytest
import torch

import presto_tpu.exec.local_planner as JL
import presto_tpu_torch.exec.local_planner as PL
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.cache.exec_cache import EXEC_CACHE
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.runtime.errors import NotSupported
from presto_tpu_torch.runtime.session import Session as PSession
from presto_tpu_torch.runtime.session import device_checked
from test_torch_memory import both
from torch_bridge import counters, port_frame

#: the reference's properties the port has not ported yet: none since
#: ``degrade_to_local`` came with the distributed joins
A10 = ()

NO_CACHE = {"result_cache_enabled": False}


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=0.01), PConnector(sf=0.01, device="cpu")


def sessions(conns, **props):
    props = {**NO_CACHE, **props}
    return (JSession({"tpch": conns[0]}, properties=props),
            PSession({"tpch": conns[1]}, properties=props, device="cpu"))


@pytest.fixture()
def pallas_env():
    """The reference's sessions mirror ``pallas_strings`` into the
    process-wide ``PRESTO_TPU_PALLAS``: put back what was there."""
    before = os.environ.get("PRESTO_TPU_PALLAS")
    yield
    if before is None:
        os.environ.pop("PRESTO_TPU_PALLAS", None)
    else:
        os.environ["PRESTO_TPU_PALLAS"] = before


def test_show_session_rows_equal_reference(conns):
    js, ps = sessions(conns, direct_group_limit=64, partial_agg_bypass="false")
    want = [(n, v) for n, v, _d in js.show_session() if n not in A10]
    got = [(n, v) for n, v, _d in ps.show_session()]
    assert got == want
    assert all(d.strip() for _n, _v, d in ps.show_session())


GROUPED = ("select n_name, count(*) as n, sum(c_acctbal) as b from customer, nation "
           "where c_nationkey = n_nationkey group by n_name order by n_name")


@pytest.mark.parametrize("limit,strategy", [(None, "DirectStrategy"), (4, "SortStrategy")])
def test_direct_group_limit_picks_the_strategy_alike(conns, monkeypatch, limit, strategy):
    picked = {"j": [], "p": []}

    def spy(module, side):
        real = module.pick_group_strategy

        def pick(*args, **kwargs):
            s = real(*args, **kwargs)
            picked[side].append(type(s).__name__)
            return s

        monkeypatch.setattr(module, "pick_group_strategy", pick)

    spy(JL, "j")
    spy(PL, "p")
    props = {} if limit is None else {"direct_group_limit": limit}
    both(sessions(conns, **props), GROUPED)
    assert picked["p"] == picked["j"] == [strategy]


BYPASS_Q = "select k, sum(v) sv, count(*) c from bypass_t group by k order by k"


@pytest.mark.parametrize("bypass,strategy", [(True, "bypass"), (False, "partial")])
def test_partial_agg_bypass_counts_and_renders_alike(conns, bypass, strategy):
    pair = sessions(conns, partial_agg_bypass=bypass)
    both(pair, "create table bypass_t as select l_orderkey * 10 + l_linenumber k, "
               "l_quantity v from lineitem")
    both(pair, BYPASS_Q)
    assert counters().get(f"agg.strategy.{strategy}") == 1
    js, ps = pair
    assert ps.explain(BYPASS_Q) == js.explain(BYPASS_Q)
    assert f"agg_strategy={strategy}" in ps.explain(BYPASS_Q)


def test_profile_dir_writes_one_trace_a_query(conns, tmp_path):
    ps = PSession({"tpch": conns[1]}, properties={**NO_CACHE, "profile_dir": str(tmp_path)},
                  device="cpu")
    ps.sql("select count(*) as n from nation")
    ps.sql("select r_name from region order by r_name")
    ids = [i.query_id for i in ps.history.infos()]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(f"{q}.json" for q in ids)
    for q in ids:
        events = json.loads((tmp_path / f"{q}.json").read_text())["traceEvents"]
        assert events, q
    ps.set_property("profile_dir", None)
    ps.sql("select count(*) as n from region")
    assert len(list(tmp_path.iterdir())) == 2


STRINGS = ("select count(*) as n from part where p_name like '%green%'",
           "select count(*) as n from orders where o_comment like '%special%requests%'")


@pytest.mark.parametrize("sql", STRINGS)
def test_pallas_strings_off_answers_alike(conns, pallas_env, sql):
    both(sessions(conns, pallas_strings=False), sql)


def test_pallas_strings_stays_in_its_session(conns, pallas_env, monkeypatch):
    """The port's setting writes no process-wide switch, and the
    executable cache's keys do not depend on it: the string steps are
    the same code under every accepted setting."""
    monkeypatch.delenv("PRESTO_TPU_PALLAS", raising=False)
    key = EXEC_CACHE.key_of("filter_project", "p_name like '%green%'")
    ps = PSession({"tpch": conns[1]}, properties={**NO_CACHE, "pallas_strings": False},
                  device="cpu")
    other = PSession({"tpch": conns[1]}, properties=NO_CACHE, device="cpu")
    for s in (ps, other, ps):
        s.sql(STRINGS[0])
        assert "PRESTO_TPU_PALLAS" not in os.environ
        assert EXEC_CACHE.key_of("filter_project", "p_name like '%green%'") == key
    assert ps.prop("pallas_strings") is False and other.prop("pallas_strings") is None


def test_pallas_strings_forced_on_a_cpu_session_c23(conns, pallas_env):
    """ROADMAP C23, closed: the reference runs its Pallas kernel in
    interpret mode off the TPU and answers; the port's CPU session takes
    the setting, at construction and at SET alike, and answers the
    reference's answer through the plain string predicates (the CPU's
    one route), with the same route counters."""
    for sql in STRINGS:
        both(sessions(conns, pallas_strings=True), sql)
    ps = PSession({"tpch": conns[1]}, properties={**NO_CACHE, "pallas_strings": False},
                  device="cpu")
    ps.set_property("pallas_strings", "true")
    assert ps.prop("pallas_strings") is True
    js, _ps = sessions(conns)
    js.set_property("pallas_strings", True)
    want = js.sql(STRINGS[0])
    assert int(want["n"][0]) > 0
    pd.testing.assert_frame_equal(port_frame(ps.sql(STRINGS[0])), want)


@pytest.mark.parametrize("setting,refused", [(None, False), (True, False), (False, True)])
def test_pallas_strings_off_on_a_cuda_session_c25(setting, refused):
    """ROADMAP C25: on the card the string predicates always launch the
    CUDA kernels, so ``pallas_strings=false`` there is refused; unset
    and on are the kernels' own route."""
    props = {} if setting is None else {"pallas_strings": setting}
    cuda = torch.device("cuda")
    if not refused:
        assert device_checked(cuda, props) == props
        return
    with pytest.raises(NotSupported, match="pallas_strings=false would run the plain string "
                                           "predicates on the card"):
        device_checked(cuda, props)
