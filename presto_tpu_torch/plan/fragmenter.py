"""Plan fragmenter: explicit exchange boundaries and plan-time
distribution decisions.

Counterpart of ``presto_tpu/plan/fragmenter.py`` (Presto's
``PlanFragmenter``, ``AddExchanges`` and the cost-based join
distribution), pure Python over plan nodes. A fragment is not a
separately scheduled stage: the distributed executor
(``exec/distributed.py``) runs each exchange inside its consumer's step
(PARTIAL, the exchange, FINAL). The fragment tree still decides two
things:

- plan-time join distribution, from a SOUND upper bound on the build
  side's rows (row counts, unique-build joins, limits and unions only:
  selectivity is never assumed);
- the text of ``EXPLAIN (TYPE DISTRIBUTED)``, which equals the JAX
  package's letter for letter (its closing line names ``shard_map``
  steps, the JAX package's word for the per-shard step).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from presto_tpu_torch.plan import nodes as N


def upper_bound_rows(node: N.PlanNode, catalog) -> int | None:
    """SOUND output-row upper bound from connector stats, or None.

    Unlike ``bounds.estimate_rows`` (an estimate with selectivity
    guesses, fine for capacity sizing backed by retry), this never
    divides: a wrong broadcast decision would not be caught by any
    retry loop, so only provable bounds count.
    """
    ub = upper_bound_rows
    if isinstance(node, N.TableScan):
        conn = catalog.connector(node.connector)
        if hasattr(conn, "row_count"):
            return int(conn.row_count(node.table))
        return None
    if isinstance(node, (N.Filter, N.Project, N.Window, N.Sort)):
        return ub(node.child, catalog)
    if isinstance(node, N.BindScalars):
        return ub(node.child, catalog)
    if isinstance(node, N.ScalarValue):
        return 1
    if isinstance(node, N.Values):
        return 1
    if isinstance(node, N.Aggregate):
        c = ub(node.child, catalog)
        if not node.keys:
            # a keyless (global) aggregate emits one row even over an
            # empty input, so a child bound of 0 (or unknown) would
            # violate the SOUND-upper-bound contract
            return 1 if c is None else max(1, c)
        return c  # one row per group <= input rows
    if isinstance(node, N.Join):
        if node.unique and node.kind in ("inner", "left"):
            # each probe row matches at most one build row; LEFT adds
            # no extra rows beyond the probe side
            return ub(node.left, catalog)
        return None
    if isinstance(node, N.SemiJoin):
        return ub(node.left, catalog)
    if isinstance(node, (N.TopN, N.Limit)):
        c = ub(node.child, catalog)
        return node.count if c is None else min(c, node.count)
    if isinstance(node, N.Union):
        parts = [ub(c, catalog) for c in node.inputs]
        return None if any(p is None for p in parts) else sum(parts)
    if isinstance(node, N.Output):
        return ub(node.child, catalog)
    return None


def is_unfiltered(node: N.PlanNode) -> bool:
    """True when ``upper_bound_rows`` is EXACT for this subtree — no
    predicate anywhere, so the bound equals the actual row count. The
    executor's plan-proven broadcast fast path requires this: with a
    merely-loose bound, skipping the runtime ``live_count`` would size
    the replication compaction (and check the gather guard) against
    rows that are not really there."""
    if isinstance(node, N.TableScan):
        return node.predicate is None
    if isinstance(node, (N.Project, N.BindScalars)):
        return is_unfiltered(node.child)
    if isinstance(node, (N.Values, N.ScalarValue)):
        return True
    return False


def output_partitioned(node: N.PlanNode) -> bool:
    """Whether the node's OUTPUT is row-sharded at runtime. False for
    producers the executor leaves single/replicated: literal rows,
    global (keyless) aggregates (a plain-jit psum), and operators that
    sit above their own gather (sort/topN/limit/window)."""
    if isinstance(node, (N.Values, N.ScalarValue)):
        return False
    if isinstance(node, N.Aggregate):
        return bool(node.keys)
    if isinstance(node, (N.Sort, N.TopN, N.Limit, N.Window)):
        return False
    if isinstance(node, (N.Filter, N.Project, N.BindScalars, N.Output)):
        return output_partitioned(node.children[0])
    if isinstance(node, (N.Join, N.SemiJoin)):
        return output_partitioned(node.left)
    if isinstance(node, N.Union):
        return any(output_partitioned(c) for c in node.inputs)
    return True  # TableScan and anything unknown: assume sharded


@dataclass(frozen=True)
class Exchange:
    """A fragment boundary: how the producer's rows reach the consumer."""

    kind: str  # "broadcast" | "hash" | "gather"
    keys: tuple[str, ...] = ()


@dataclass
class Fragment:
    fid: int
    root: N.PlanNode
    partitioning: str  # "source" | "hash" | "single" | "replicated"
    #: (child fragment id, exchange feeding this fragment)
    consumes: list[tuple[int, Exchange]] = field(default_factory=list)


@dataclass
class FragmentPlan:
    fragments: list[Fragment]
    #: id(Join node) -> "broadcast" | "auto" (auto = runtime decides)
    join_strategy: dict
    #: id(Join node) -> True when the stats UB proves the build side
    #: fits the in-memory join budget (skips the runtime budget sync)
    join_fits_budget: dict
    #: id(Join node) -> sound build-row upper bound (replication
    #: capacity sizing without a device sync)
    join_rows_ub: dict
    #: catalog used for planning (renders scan columns' physical types)
    catalog: object = None

    def render(self, skew_history: "dict | None" = None) -> str:
        # roots of other fragments are rendering stop points: each
        # subtree prints in exactly one fragment, with an exchange stub
        # where it was cut out.
        # ``skew_history``: {id(plan node): observed exchange-partition
        # skew ratio} from plan-stats history (recurring fingerprints) —
        # rendered on the owning fragment's header so a hot partition
        # seen in PAST runs is visible at plan time.
        stops = {id(f.root): f.fid for f in self.fragments}
        ex_by_child = {}
        for f in self.fragments:
            for fid, ex in f.consumes:
                ex_by_child[fid] = ex

        def label(n: N.PlanNode) -> str:
            t = type(n).__name__
            if isinstance(n, N.TableScan):
                phys = ""
                if self.catalog is not None:
                    from presto_tpu_torch.plan.nodes import scan_physical_types

                    narrowed = {
                        s: dt for s, dt in
                        scan_physical_types(n, self.catalog).items()
                        if dt.is_narrowed
                    }
                    if narrowed:
                        phys = " physical={" + ", ".join(
                            f"{s}:{dt.phys}" for s, dt in sorted(
                                narrowed.items())) + "}"
                return f"{t}[{n.connector}.{n.table}]{phys}"
            if isinstance(n, N.Aggregate):
                return f"{t}[keys={[k for k, _ in n.keys]}]"
            if isinstance(n, N.Join):
                strat = self.join_strategy.get(id(n))
                # an unproven broadcast (row UB fits the broadcast limit
                # but the byte budget is not plan-time proven) can still
                # take the grouped-spill path at runtime; render it as
                # tentative so EXPLAIN doesn't overstate the strategy
                if strat == "broadcast" and not self.join_fits_budget.get(
                        id(n)):
                    strat = "broadcast?"
                extra = f", dist={strat}" if strat else ""
                return f"{t}[{n.kind}{extra}]"
            return t

        def tree(n: N.PlanNode, own_fid: int, indent: int) -> list[str]:
            pad = "    " + "  " * indent
            fid = stops.get(id(n))
            if fid is not None and fid != own_fid:
                ex = ex_by_child.get(fid)
                how = (f"{ex.kind}" + (f"({', '.join(ex.keys)})"
                                       if ex and ex.keys else "")
                       if ex else "exchange")
                return [f"{pad}[{how} <- fragment {fid}]"]
            lines = [pad + label(n)]
            for c in n.children:
                lines.extend(tree(c, own_fid, indent + 1))
            return lines

        def fragment_skew(n: N.PlanNode, own_fid: int) -> float:
            """Worst history-observed skew over the nodes THIS fragment
            owns (stopping at other fragments' roots, like tree())."""
            fid = stops.get(id(n))
            if fid is not None and fid != own_fid:
                return 0.0
            worst = (skew_history or {}).get(id(n), 0.0)
            for c in n.children:
                worst = max(worst, fragment_skew(c, own_fid))
            return worst

        out = []
        for f in self.fragments:
            # the SOUND plan-time row bound per fragment root (the same
            # number the estimate-vs-actual snapshot records), so the
            # distributed rendering shows what the fragmenter's
            # distribution decisions were actually based on
            bound = ""
            if self.catalog is not None:
                ub = upper_bound_rows(f.root, self.catalog)
                if ub is not None:
                    bound = f" est<={ub:,} rows"
            skew = fragment_skew(f.root, f.fid)
            if skew > 0:
                bound += f" skew~{skew:.1f}x (observed)"
            out.append(f"Fragment {f.fid} [{f.partitioning}]{bound}")
            out.extend(tree(f.root, f.fid, 0))
        out.append(
            "(exchanges compile INTO their consumer's shard_map step — a "
            "fragment boundary is a collective, not an RPC hop)"
        )
        return "\n".join(out)


def fragment_plan(plan: N.PlanNode, catalog, broadcast_limit: int,
                  join_build_budget: int | None = None) -> FragmentPlan:
    """Cut the logical plan at exchange boundaries and decide join
    distribution from sound stats bounds."""
    from presto_tpu_torch.runtime.memory import node_row_bytes

    fragments: list[Fragment] = []
    join_strategy: dict = {}
    join_fits: dict = {}
    join_rows_ub: dict = {}

    def new_fragment(root, partitioning) -> Fragment:
        f = Fragment(len(fragments), root, partitioning)
        fragments.append(f)
        return f

    def visit(node: N.PlanNode, frag: Fragment) -> None:
        if isinstance(node, N.Join):
            # probe side stays in this fragment; build side becomes its
            # own fragment delivered by broadcast or hash exchange
            ubr = upper_bound_rows(node.right, catalog)
            # physical (narrowed) widths, matching the runtime build
            # estimates — plan-time and run-time sizing must agree
            bytes_ub = (None if ubr is None
                        else ubr * node_row_bytes(node.right, catalog))
            if ubr is not None and ubr <= broadcast_limit:
                join_strategy[id(node)] = "broadcast"
                ex = Exchange("broadcast")
                part = "replicated"
            else:
                join_strategy[id(node)] = "auto"
                ex = Exchange("hash", tuple(map(str, node.right_keys)))
                part = "hash"
            # the executor's sync-skipping fast path additionally
            # requires the bound to be EXACT (no filtering below):
            # a loose bound would mis-size the replication compaction
            # and over-trip the gather guard
            join_fits[id(node)] = (
                join_build_budget is not None and bytes_ub is not None
                and bytes_ub <= join_build_budget
                and is_unfiltered(node.right)
            )
            if ubr is not None:
                join_rows_ub[id(node)] = ubr
            bf = new_fragment(node.right, part)
            frag.consumes.append((bf.fid, ex))
            visit(node.right, bf)
            visit(node.left, frag)
            return
        if isinstance(node, N.SemiJoin):
            ubr = upper_bound_rows(node.right, catalog)
            ex = (Exchange("broadcast")
                  if ubr is not None and ubr <= broadcast_limit
                  else Exchange("hash", tuple(map(str, node.right_keys))))
            bf = new_fragment(
                node.right,
                "replicated" if ex.kind == "broadcast" else "hash")
            frag.consumes.append((bf.fid, ex))
            visit(node.right, bf)
            visit(node.left, frag)
            return
        if isinstance(node, N.Aggregate) and node.keys:
            # PARTIAL below the hash exchange, FINAL above (the executor
            # fuses all three into one step; the boundary still exists)
            cf = new_fragment(node.child, "hash")
            frag.consumes.append(
                (cf.fid, Exchange("hash", tuple(n for n, _ in node.keys))))
            visit(node.child, cf)
            return
        single_ops = (N.Sort, N.TopN, N.Limit, N.Window)
        if isinstance(node, single_ops) or (
                isinstance(node, N.Aggregate)
                and frag.partitioning != "single"):
            # single-partition operators over a PARTITIONED child: the
            # gather happens below the INNERMOST such op (a chain like
            # Limit over Sort gathers once). A child whose output is
            # already single/replicated at runtime (Values, global
            # aggregate, another single op) gets NO spurious exchange.
            child = node.children[0]
            if isinstance(node, single_ops) and isinstance(
                    child, single_ops):
                visit(child, frag)
                return
            if not output_partitioned(child):
                visit(child, frag)
                return
            producer = child
            while isinstance(producer, (N.Project, N.Filter,
                                        N.BindScalars)):
                producer = producer.children[0]
            part = ("hash" if isinstance(producer, N.Aggregate)
                    and producer.keys else "source")
            cf = new_fragment(child, part)
            frag.consumes.append((cf.fid, Exchange("gather")))
            visit(child, cf)
            return
        for c in node.children:
            visit(c, frag)

    root = new_fragment(plan, "single")
    visit(plan, root)
    return FragmentPlan(fragments, join_strategy, join_fits, join_rows_ub,
                        catalog=catalog)
