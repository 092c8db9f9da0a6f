"""SQL abstract syntax tree.

Reference parity: ``com.facebook.presto.sql.tree`` (``Query``,
``QuerySpecification``, ``Select``, ``Join``, ``ComparisonExpression``,
...) [SURVEY §2.1; reference tree unavailable, paths reconstructed].
Small immutable dataclasses; the analyzer turns these into the typed
relational IR — the AST itself is untyped.

A copy of ``presto_tpu/sql/ast.py`` (the port imports nothing of the JAX
package); keep the two identical.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------


class Node:
    pass


@dataclass(frozen=True)
class Identifier(Node):
    parts: tuple[str, ...]  # ("o", "custkey") or ("custkey",)

    def __str__(self):
        return ".".join(self.parts)


@dataclass(frozen=True)
class NumberLit(Node):
    text: str  # keep text: "1", "0.05" — analyzer picks int/decimal/double

    def __str__(self):
        return self.text


@dataclass(frozen=True)
class StringLit(Node):
    value: str


@dataclass(frozen=True)
class DateLit(Node):
    value: str  # 'YYYY-MM-DD'

@dataclass(frozen=True)
class TimestampLit(Node):
    value: str  # 'YYYY-MM-DD HH:MM:SS[.ffffff]'


@dataclass(frozen=True)
class IntervalLit(Node):
    value: str
    unit: str  # day | month | year


@dataclass(frozen=True)
class BinaryOp(Node):
    op: str  # + - * / % = <> < <= > >= and or
    left: Node
    right: Node


@dataclass(frozen=True)
class UnaryOp(Node):
    op: str  # - not
    operand: Node


@dataclass(frozen=True)
class WindowSpec(Node):
    """OVER (PARTITION BY ... ORDER BY ... [frame]).

    frame: 'range' (SQL default: RANGE UNBOUNDED PRECEDING..CURRENT
    ROW), 'rows' (ROWS UNBOUNDED PRECEDING..CURRENT ROW), or 'full'
    (UNBOUNDED PRECEDING..UNBOUNDED FOLLOWING = whole partition).
    """

    partition_by: tuple[Node, ...] = ()
    order_by: tuple["OrderItem", ...] = ()
    frame: str = "range"


@dataclass(frozen=True)
class FunctionCall(Node):
    name: str
    args: tuple[Node, ...]
    distinct: bool = False
    is_star: bool = False  # count(*)
    over: Optional[WindowSpec] = None  # window function when set


@dataclass(frozen=True)
class Resolved(Node):
    """An AST slot already lowered to a typed engine Expr (used by the
    analyzer to substitute planned window-function results before the
    SELECT projection pass). ``expr`` is a presto_tpu_torch.expr.Expr."""

    expr: object


@dataclass(frozen=True)
class CaseExpr(Node):
    whens: tuple[tuple[Node, Node], ...]
    else_: Optional[Node]
    operand: Optional[Node] = None  # CASE x WHEN v THEN ...


@dataclass(frozen=True)
class Between(Node):
    value: Node
    low: Node
    high: Node
    negated: bool = False


@dataclass(frozen=True)
class InList(Node):
    value: Node
    items: tuple[Node, ...]
    negated: bool = False


@dataclass(frozen=True)
class InSubquery(Node):
    value: Node
    query: "Query"
    negated: bool = False


@dataclass(frozen=True)
class Exists(Node):
    query: "Query"
    negated: bool = False


@dataclass(frozen=True)
class ScalarSubquery(Node):
    query: "Query"


@dataclass(frozen=True)
class Like(Node):
    value: Node
    pattern: Node
    negated: bool = False


@dataclass(frozen=True)
class IsNull(Node):
    value: Node
    negated: bool = False


@dataclass(frozen=True)
class Cast(Node):
    value: Node
    type_name: str  # "double", "decimal(12,2)", "date", "bigint", "varchar"


@dataclass(frozen=True)
class Extract(Node):
    field: str  # year | month | day
    value: Node


@dataclass(frozen=True)
class Star(Node):
    qualifier: Optional[str] = None


@dataclass(frozen=True)
class Substring(Node):
    value: Node
    start: Node
    length: Optional[Node]


@dataclass(frozen=True)
class Placeholder(Node):
    """A ``?`` parameter in a PREPAREd statement; ``ordinal`` is the
    0-based lexical position. The analyzer types it from its comparison
    /arithmetic context and lowers it to an ``expr.Param`` slot."""

    ordinal: int


# ---------------------------------------------------------------------------
# relations & query structure
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Table(Node):
    name: str
    alias: Optional[str] = None


@dataclass(frozen=True)
class SubqueryRelation(Node):
    query: "Query"
    alias: Optional[str] = None


@dataclass(frozen=True)
class Join(Node):
    kind: str  # inner | left | right | full | cross
    left: Node
    right: Node
    on: Optional[Node] = None


@dataclass(frozen=True)
class SelectItem(Node):
    expr: Node
    alias: Optional[str] = None


@dataclass(frozen=True)
class OrderItem(Node):
    expr: Node
    descending: bool = False
    nulls_first: Optional[bool] = None


@dataclass(frozen=True)
class GroupingSets(Node):
    """A ROLLUP / CUBE / GROUPING SETS element inside GROUP BY; the
    parser normalizes all three spellings to the explicit set list."""

    sets: tuple[tuple[Node, ...], ...]


@dataclass(frozen=True)
class Query(Node):
    select: tuple[SelectItem, ...]
    from_: Optional[Node]  # relation tree (None for SELECT <expr>)
    where: Optional[Node] = None
    group_by: tuple[Node, ...] = ()  # exprs and/or GroupingSets elements
    having: Optional[Node] = None
    order_by: tuple[OrderItem, ...] = ()
    limit: Optional[int] = None
    distinct: bool = False
    ctes: tuple[tuple[str, "Query"], ...] = ()  # WITH name AS (query)


@dataclass(frozen=True)
class CreateTableAs(Node):
    """CREATE TABLE <name> AS <query> (CTAS into the memory catalog)."""

    name: str
    query: Node  # Query | SetQuery


@dataclass(frozen=True)
class InsertInto(Node):
    """INSERT INTO <name> <query> (append, atomic per statement)."""

    name: str
    query: Node


@dataclass(frozen=True)
class DropTable(Node):
    name: str
    if_exists: bool = False


@dataclass(frozen=True)
class Prepare(Node):
    """PREPARE <name> FROM <statement> — store a plan template under a
    session-scoped handle (reference: PREPARE; SURVEY §2.1 protocol)."""

    name: str
    statement: Node  # Query | SetQuery


@dataclass(frozen=True)
class ExecuteStmt(Node):
    """EXECUTE <name> [USING v1, v2, ...] — run a prepared template
    with positional parameter bindings (literals only)."""

    name: str
    args: tuple[Node, ...] = ()


@dataclass(frozen=True)
class Deallocate(Node):
    """DEALLOCATE PREPARE <name> — drop a prepared handle."""

    name: str


@dataclass(frozen=True)
class SetQuery(Node):
    """UNION [ALL] chain. ``ops[i]`` combines ``terms[i]`` into the
    running result ('union' dedups, 'union_all' keeps duplicates);
    ORDER BY / LIMIT apply to the combined result and may reference the
    first term's output names or ordinals."""

    terms: tuple[Node, ...]  # Query | SetQuery
    ops: tuple[str, ...]  # len(terms) - 1
    order_by: tuple[OrderItem, ...] = ()
    limit: Optional[int] = None
    ctes: tuple[tuple[str, "Query"], ...] = ()
