"""Recursive-descent SQL parser for the TPC-H/TPC-DS/SSB dialect subset.

Reference parity: ``presto-parser`` (``SqlParser.createStatement`` over
the ANTLR4 ``SqlBase.g4`` grammar) [SURVEY §2.1; reference tree
unavailable, paths reconstructed]. Hand-rolled per SURVEY §7.2 step 5
(no network, no ANTLR): one token of lookahead, standard precedence
climbing for expressions.

A copy of ``presto_tpu/sql/parser.py`` (the port imports nothing of the JAX
package); keep the two identical.
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch.sql import ast as A
from presto_tpu_torch.runtime.errors import UserError
from presto_tpu_torch.sql.lexer import Token, tokenize


#: contextual (non-reserved) set-operation words: never implicit aliases
_SET_OP_WORDS = ("intersect", "except")


class ParseError(UserError):
    """Syntax errors (taxonomy: USER_ERROR via UserError, which keeps
    the pre-taxonomy ValueError ancestry)."""

    def __init__(self, msg: str, tok: Token):
        super().__init__(f"{msg} at line {tok.line}:{tok.col} (near {tok.text!r})")


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0
        #: ``?`` placeholders seen so far (ordinals in lex order)
        self.n_params = 0

    # -- token helpers ----------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def kw(self, *words: str) -> bool:
        t = self.cur
        return t.kind == "KW" and t.text.lower() in words

    def op(self, *ops: str) -> bool:
        t = self.cur
        return t.kind == "OP" and t.text in ops

    def word(self, *words: str) -> bool:
        """Match a non-reserved word (lexed as IDENT) or keyword:
        ROLLUP/CUBE/GROUPING/SETS/INTERSECT/EXCEPT are contextual."""
        t = self.cur
        return t.kind in ("KW", "IDENT") and t.text.lower() in words

    def _accept_word(self, w: str) -> bool:
        if self.word(w):
            self.eat()
            return True
        return False

    def _query_follows(self, idx: int) -> bool:
        """True when the tokens at ``idx`` open a query expression,
        possibly through nested parens: ``((select ...`` — the standard
        TPC-DS spelling of parenthesized union terms."""
        j = idx
        while self.toks[j].kind == "OP" and self.toks[j].text == "(":
            j += 1
        t = self.toks[j]
        return t.kind == "KW" and t.text.lower() in ("select", "with")

    def eat(self):
        t = self.cur
        self.i += 1
        return t

    def expect_kw(self, word: str) -> Token:
        if not self.kw(word):
            raise ParseError(f"expected {word.upper()}", self.cur)
        return self.eat()

    def expect_op(self, op: str) -> Token:
        if not self.op(op):
            raise ParseError(f"expected {op!r}", self.cur)
        return self.eat()

    def accept_kw(self, *words: str) -> bool:
        if self.kw(*words):
            self.eat()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.op(*ops):
            self.eat()
            return True
        return False

    # -- entry ------------------------------------------------------------
    def parse(self) -> A.Node:
        q = self.parse_statement()
        self.accept_op(";")
        if self.cur.kind != "EOF":
            raise ParseError("trailing input", self.cur)
        return q

    def parse_statement(self) -> A.Node:
        """Query, CREATE TABLE AS, INSERT INTO, DROP TABLE, or the
        prepared-statement surface (PREPARE / EXECUTE ... USING /
        DEALLOCATE PREPARE)."""
        if self.word("prepare"):
            self.eat()
            name = self.parse_name()
            self.expect_kw("from")
            return A.Prepare(name, self.parse_statement())
        if self.word("execute"):
            self.eat()
            name = self.parse_name()
            args: list[A.Node] = []
            if self._accept_word("using"):
                args.append(self.parse_expr())
                while self.accept_op(","):
                    args.append(self.parse_expr())
            return A.ExecuteStmt(name, tuple(args))
        if self.word("deallocate"):
            self.eat()
            if not self._accept_word("prepare"):
                raise ParseError("expected PREPARE", self.cur)
            return A.Deallocate(self.parse_name())
        if self.word("create"):
            self.eat()
            if not self._accept_word("table"):
                raise ParseError("expected TABLE", self.cur)
            name = self.parse_name()
            self.expect_kw("as")
            return A.CreateTableAs(name, self.parse_query())
        if self.word("insert"):
            self.eat()
            if not self._accept_word("into"):
                raise ParseError("expected INTO", self.cur)
            name = self.parse_name()
            return A.InsertInto(name, self.parse_query())
        if self.word("drop"):
            self.eat()
            if not self._accept_word("table"):
                raise ParseError("expected TABLE", self.cur)
            if_exists = False
            if self.word("if"):
                self.eat()
                if not self._accept_word("exists"):
                    raise ParseError("expected EXISTS", self.cur)
                if_exists = True
            return A.DropTable(self.parse_name(), if_exists)
        return self.parse_query()

    # -- query ------------------------------------------------------------
    def parse_query(self) -> A.Node:
        """[WITH ...] term (UNION [ALL] term)* [ORDER BY ...] [LIMIT n]
        -> Query (no set ops) or SetQuery."""
        ctes: list[tuple[str, A.Query]] = []
        if self.accept_kw("with"):
            while True:
                name = self.parse_name()
                self.expect_kw("as")
                self.expect_op("(")
                ctes.append((name, self.parse_query()))
                self.expect_op(")")
                if not self.accept_op(","):
                    break
        first, first_parenthesized = self._parse_intersect_chain()
        terms = [first]
        ops: list[str] = []
        while self.kw("union") or self.word("except"):
            # UNION and EXCEPT share a precedence level (standard SQL);
            # INTERSECT binds tighter and is folded by the chain below
            if self.word("except"):
                self.eat()
                if self.kw("all"):
                    raise ParseError("EXCEPT ALL not supported", self.cur)
                self.accept_kw("distinct")
                ops.append("except")
            else:
                self.eat()
                if self.accept_kw("all"):
                    ops.append("union_all")
                else:
                    self.accept_kw("distinct")
                    ops.append("union")
            terms.append(self._parse_intersect_chain()[0])
        order_by: list[A.OrderItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.parse_order_item())
            while self.accept_op(","):
                order_by.append(self.parse_order_item())
        limit = None
        if self.accept_kw("limit"):
            t = self.eat()
            if t.kind != "NUMBER":
                raise ParseError("expected LIMIT count", t)
            limit = int(t.text)
        if len(terms) == 1:
            q = terms[0]
            if not first_parenthesized:
                # a bare core: its order/limit/ctes slots are empty
                return dataclasses.replace(
                    q, order_by=tuple(order_by), limit=limit, ctes=tuple(ctes)
                )
            # a parenthesized query keeps its own ORDER BY/LIMIT/CTEs;
            # outer clauses (if any) wrap it as a single-term SetQuery
            if not order_by and limit is None and not ctes:
                return q
            return A.SetQuery(
                terms=(q,), ops=(), order_by=tuple(order_by),
                limit=limit, ctes=tuple(ctes),
            )
        return A.SetQuery(
            terms=tuple(terms),
            ops=tuple(ops),
            order_by=tuple(order_by),
            limit=limit,
            ctes=tuple(ctes),
        )

    def _parse_intersect_chain(self) -> tuple[A.Node, bool]:
        """INTERSECT binds tighter than UNION/EXCEPT (standard SQL).
        Set (distinct) semantics only; the ALL variant is rejected."""
        first, parenthesized = self._parse_set_term()
        terms = [first]
        ops: list[str] = []
        while self.word("intersect"):
            self.eat()
            if self.kw("all"):
                raise ParseError("INTERSECT ALL not supported", self.cur)
            self.accept_kw("distinct")
            ops.append("intersect")
            terms.append(self._parse_set_term()[0])
        if len(terms) == 1:
            return first, parenthesized
        return A.SetQuery(terms=tuple(terms), ops=tuple(ops)), True

    def _parse_set_term(self) -> tuple[A.Node, bool]:
        """One UNION operand: a parenthesized query or a bare select
        core (whose ORDER BY/LIMIT, if unparenthesized, belong to the
        enclosing query — standard SQL). Returns (term, parenthesized)."""
        if self.op("(") and self._query_follows(self.i + 1):
            self.eat()
            q = self.parse_query()
            self.expect_op(")")
            return q, True
        return self._parse_select_core(), False

    def _parse_select_core(self) -> A.Query:
        self.expect_kw("select")
        distinct = self.accept_kw("distinct")
        self.accept_kw("all")
        items = [self.parse_select_item()]
        while self.accept_op(","):
            items.append(self.parse_select_item())
        from_ = None
        if self.accept_kw("from"):
            from_ = self.parse_relation_list()
        where = self.parse_expr() if self.accept_kw("where") else None
        group_by: list[A.Node] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by.append(self._parse_grouping_element())
            while self.accept_op(","):
                group_by.append(self._parse_grouping_element())
        having = self.parse_expr() if self.accept_kw("having") else None
        return A.Query(
            select=tuple(items),
            from_=from_,
            where=where,
            group_by=tuple(group_by),
            having=having,
            distinct=distinct,
        )

    def _parse_grouping_element(self) -> A.Node:
        """GROUP BY element: expr | ROLLUP(...) | CUBE(...) |
        GROUPING SETS ((...), ...) — the latter three normalize to an
        explicit GroupingSets set list."""
        if self.word("rollup") and self.toks[self.i + 1].text == "(":
            self.eat()
            self.expect_op("(")
            exprs = [self.parse_expr()]
            while self.accept_op(","):
                exprs.append(self.parse_expr())
            self.expect_op(")")
            sets = tuple(tuple(exprs[:k]) for k in range(len(exprs), -1, -1))
            return A.GroupingSets(sets)
        if self.word("cube") and self.toks[self.i + 1].text == "(":
            self.eat()
            self.expect_op("(")
            exprs = [self.parse_expr()]
            while self.accept_op(","):
                exprs.append(self.parse_expr())
            self.expect_op(")")
            sets = []
            for mask in range((1 << len(exprs)) - 1, -1, -1):
                sets.append(tuple(
                    e for i, e in enumerate(exprs) if mask & (1 << (len(exprs) - 1 - i))
                ))
            return A.GroupingSets(tuple(sets))
        if self.word("grouping"):
            save = self.i
            self.eat()
            if self._accept_word("sets"):
                self.expect_op("(")
                sets = []
                while True:
                    self.expect_op("(")
                    exprs = []
                    if not self.op(")"):
                        exprs.append(self.parse_expr())
                        while self.accept_op(","):
                            exprs.append(self.parse_expr())
                    self.expect_op(")")
                    sets.append(tuple(exprs))
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                return A.GroupingSets(tuple(sets))
            self.i = save  # grouping(...) the function, in an expression
        return self.parse_expr()

    def parse_name(self) -> str:
        t = self.cur
        if t.kind == "QIDENT":
            self.eat()
            return t.text
        if t.kind in ("IDENT", "KW"):
            self.eat()
            return t.text.lower()
        raise ParseError("expected identifier", t)

    def parse_select_item(self) -> A.SelectItem:
        if self.op("*"):
            self.eat()
            return A.SelectItem(A.Star(), None)
        # qualified star: ident.*
        if self.cur.kind == "IDENT" and self.toks[self.i + 1].text == "." and self.toks[
            self.i + 2
        ].text == "*":
            q = self.eat().text.lower()
            self.eat()
            self.eat()
            return A.SelectItem(A.Star(q), None)
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.parse_name()
        elif self.cur.kind == "IDENT" and not self.word(*_SET_OP_WORDS):
            alias = self.eat().text.lower()
        elif self.cur.kind == "QIDENT":
            alias = self.eat().text
        return A.SelectItem(e, alias)

    def parse_order_item(self) -> A.OrderItem:
        e = self.parse_expr()
        desc = False
        if self.accept_kw("desc"):
            desc = True
        elif self.accept_kw("asc"):
            pass
        nulls_first = None
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nulls_first = True
            else:
                self.expect_kw("last")
                nulls_first = False
        return A.OrderItem(e, desc, nulls_first)

    # -- relations --------------------------------------------------------
    def parse_relation_list(self) -> A.Node:
        rel = self.parse_joined_relation()
        while self.accept_op(","):
            rel = A.Join("cross", rel, self.parse_joined_relation())
        return rel

    def parse_joined_relation(self) -> A.Node:
        rel = self.parse_primary_relation()
        while True:
            kind = None
            if self.kw("join", "inner"):
                self.accept_kw("inner")
                self.expect_kw("join")
                kind = "inner"
            elif self.kw("left", "right", "full"):
                kind = self.eat().text.lower()
                self.accept_kw("outer")
                self.expect_kw("join")
            elif self.kw("cross"):
                self.eat()
                self.expect_kw("join")
                rel = A.Join("cross", rel, self.parse_primary_relation())
                continue
            else:
                break
            right = self.parse_primary_relation()
            self.expect_kw("on")
            on = self.parse_expr()
            rel = A.Join(kind, rel, right, on)
        return rel

    def parse_primary_relation(self) -> A.Node:
        if self.op("(") and self._query_follows(self.i + 1):
            # Ambiguous open: a derived table — possibly a parenthesized
            # UNION chain, FROM ((select ...) union all (select ...)) t —
            # or a parenthesized JOIN whose first relation is a subquery,
            # FROM ((select ...) x join y on ...). Try the derived-table
            # parse; backtrack to the join parse on failure (the parser
            # state is just the token index).
            save = self.i
            try:
                self.eat()
                q = self.parse_query()
                self.expect_op(")")
            except ParseError:
                self.i = save
            else:
                alias = self._maybe_alias()
                return A.SubqueryRelation(q, alias)
        if self.accept_op("("):
            rel = self.parse_relation_list()
            self.expect_op(")")
            return rel
        name = self.parse_name()
        alias = self._maybe_alias()
        return A.Table(name, alias)

    def _maybe_alias(self) -> str | None:
        if self.accept_kw("as"):
            return self.parse_name()
        if self.cur.kind == "IDENT" and not self.word(*_SET_OP_WORDS):
            return self.eat().text.lower()
        if self.cur.kind == "QIDENT":
            return self.eat().text
        return None

    # -- expressions ------------------------------------------------------
    def parse_expr(self) -> A.Node:
        return self.parse_or()

    def parse_or(self) -> A.Node:
        e = self.parse_and()
        while self.accept_kw("or"):
            e = A.BinaryOp("or", e, self.parse_and())
        return e

    def parse_and(self) -> A.Node:
        e = self.parse_not()
        while self.accept_kw("and"):
            e = A.BinaryOp("and", e, self.parse_not())
        return e

    def parse_not(self) -> A.Node:
        if self.accept_kw("not"):
            return A.UnaryOp("not", self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> A.Node:
        e = self.parse_additive()
        while True:
            if self.op("=", "<>", "<", "<=", ">", ">="):
                op = self.eat().text
                rhs = self.parse_additive_or_quantified()
                e = A.BinaryOp(op, e, rhs)
                continue
            negated = False
            save = self.i
            if self.accept_kw("not"):
                negated = True
            if self.accept_kw("between"):
                low = self.parse_additive()
                self.expect_kw("and")
                high = self.parse_additive()
                e = A.Between(e, low, high, negated)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.kw("select", "with"):
                    q = self.parse_query()
                    self.expect_op(")")
                    e = A.InSubquery(e, q, negated)
                else:
                    items = [self.parse_expr()]
                    while self.accept_op(","):
                        items.append(self.parse_expr())
                    self.expect_op(")")
                    e = A.InList(e, tuple(items), negated)
                continue
            if self.accept_kw("like"):
                e = A.Like(e, self.parse_additive(), negated)
                continue
            if negated:
                self.i = save  # bare NOT belongs to parse_not
                break
            if self.accept_kw("is"):
                neg = self.accept_kw("not")
                self.expect_kw("null")
                e = A.IsNull(e, neg)
                continue
            break
        return e

    def parse_additive_or_quantified(self) -> A.Node:
        """rhs of a comparison: expr, (subquery), or ANY/ALL(subquery)."""
        if self.kw("any", "some", "all"):
            raise ParseError("quantified comparisons not supported yet", self.cur)
        return self.parse_additive()

    def parse_additive(self) -> A.Node:
        e = self.parse_multiplicative()
        while self.op("+", "-") or (self.cur.kind == "OP" and self.cur.text == "||"):
            op = self.eat().text
            e = A.BinaryOp(op, e, self.parse_multiplicative())
        return e

    def parse_multiplicative(self) -> A.Node:
        e = self.parse_unary()
        while self.op("*", "/", "%"):
            op = self.eat().text
            e = A.BinaryOp(op, e, self.parse_unary())
        return e

    def parse_unary(self) -> A.Node:
        if self.accept_op("-"):
            return A.UnaryOp("-", self.parse_unary())
        if self.accept_op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> A.Node:
        t = self.cur
        if self.op("?"):
            self.eat()
            ph = A.Placeholder(self.n_params)
            self.n_params += 1
            return ph
        if t.kind == "NUMBER":
            self.eat()
            return A.NumberLit(t.text)
        if t.kind == "STRING":
            self.eat()
            return A.StringLit(t.text)
        if self.kw("true"):
            self.eat()
            return A.NumberLit("1")  # folded by analyzer as boolean true
        if self.kw("false"):
            self.eat()
            return A.NumberLit("0")
        if self.kw("null"):
            self.eat()
            return A.Identifier(("null",))  # analyzer resolves to NULL literal
        if self.kw("date"):
            self.eat()
            s = self.eat()
            if s.kind != "STRING":
                raise ParseError("expected date string", s)
            return A.DateLit(s.text)
        if self.kw("timestamp"):
            self.eat()
            s = self.eat()
            if s.kind != "STRING":
                raise ParseError("expected timestamp string", s)
            return A.TimestampLit(s.text)
        if self.kw("interval"):
            self.eat()
            s = self.eat()
            if s.kind != "STRING":
                raise ParseError("expected interval string", s)
            unit_tok = self.eat()
            unit = unit_tok.text.lower()
            if unit not in ("day", "month", "year"):
                raise ParseError("expected interval unit", unit_tok)
            return A.IntervalLit(s.text, unit)
        if self.kw("case"):
            return self.parse_case()
        if self.kw("cast"):
            self.eat()
            self.expect_op("(")
            v = self.parse_expr()
            self.expect_kw("as")
            type_name = self.parse_type_name()
            self.expect_op(")")
            return A.Cast(v, type_name)
        if self.kw("extract"):
            self.eat()
            self.expect_op("(")
            field = self.parse_name()
            self.expect_kw("from")
            v = self.parse_expr()
            self.expect_op(")")
            return A.Extract(field, v)
        if self.kw("substring"):
            self.eat()
            self.expect_op("(")
            v = self.parse_expr()
            if self.accept_kw("from"):
                start = self.parse_expr()
                length = self.parse_expr() if self.accept_kw("for") else None
            else:
                self.expect_op(",")
                start = self.parse_expr()
                length = self.parse_expr() if self.accept_op(",") else None
            self.expect_op(")")
            return A.Substring(v, start, length)
        if t.kind == "IDENT" and t.text.lower() == "position":
            # POSITION(needle IN haystack) special form -> strpos
            nxt = self.toks[self.i + 1] if self.i + 1 < len(self.toks) else None
            if nxt is not None and nxt.kind == "OP" and nxt.text == "(":
                self.eat()
                self.eat()
                # additive level: the IN belongs to the POSITION form
                needle = self.parse_additive()
                self.expect_kw("in")
                hay = self.parse_expr()
                self.expect_op(")")
                return A.FunctionCall("strpos", (hay, needle))
        if self.kw("exists"):
            self.eat()
            self.expect_op("(")
            q = self.parse_query()
            self.expect_op(")")
            return A.Exists(q)
        if self.kw("not"):
            self.eat()
            return A.UnaryOp("not", self.parse_primary())
        if self.op("("):
            self.eat()
            if self.kw("select", "with"):
                q = self.parse_query()
                self.expect_op(")")
                return A.ScalarSubquery(q)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        # function call or identifier (agg keywords double as functions)
        if t.kind in ("IDENT", "QIDENT") or self.kw(
            "count", "sum", "avg", "min", "max", "year", "month", "day"
        ):
            name = self.eat().text
            if t.kind != "QIDENT":
                name = name.lower()
            if self.op("("):
                self.eat()
                distinct = self.accept_kw("distinct")
                if self.op("*"):
                    self.eat()
                    self.expect_op(")")
                    return self._maybe_over(A.FunctionCall(name, (), is_star=True))
                args: list[A.Node] = []
                if not self.op(")"):
                    args.append(self.parse_expr())
                    while self.accept_op(","):
                        args.append(self.parse_expr())
                self.expect_op(")")
                return self._maybe_over(
                    A.FunctionCall(name, tuple(args), distinct=distinct)
                )
            parts = [name]
            while self.op(".") and self.toks[self.i + 1].kind in (
                "IDENT", "KW", "QIDENT"
            ):
                self.eat()
                nt = self.eat()
                parts.append(nt.text if nt.kind == "QIDENT" else nt.text.lower())
            return A.Identifier(tuple(parts))
        raise ParseError("unexpected token", t)

    def _maybe_over(self, fc: A.FunctionCall) -> A.FunctionCall:
        if not self.kw("over"):
            return fc
        self.eat()
        self.expect_op("(")
        partition: list[A.Node] = []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition.append(self.parse_expr())
            while self.accept_op(","):
                partition.append(self.parse_expr())
        order: list[A.OrderItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order.append(self.parse_order_item())
            while self.accept_op(","):
                order.append(self.parse_order_item())
        frame = "range"
        if self.kw("rows", "range"):
            unit = self.eat().text.lower()
            frame = self._parse_frame(unit)
        self.expect_op(")")
        spec = A.WindowSpec(tuple(partition), tuple(order), frame)
        return dataclasses.replace(fc, over=spec)

    def _parse_frame(self, unit: str) -> str:
        """Supported frames: [ROWS|RANGE] BETWEEN UNBOUNDED PRECEDING
        AND {CURRENT ROW | UNBOUNDED FOLLOWING}, or the shorthand
        [ROWS|RANGE] UNBOUNDED PRECEDING."""
        if self.accept_kw("between"):
            self.expect_kw("unbounded")
            self.expect_kw("preceding")
            self.expect_kw("and")
            if self.accept_kw("current"):
                self.expect_kw("row")
                return unit  # rows | range
            self.expect_kw("unbounded")
            self.expect_kw("following")
            return "full"
        self.expect_kw("unbounded")
        self.expect_kw("preceding")
        return unit

    def parse_case(self) -> A.CaseExpr:
        self.expect_kw("case")
        operand = None
        if not self.kw("when"):
            operand = self.parse_expr()
        whens = []
        while self.accept_kw("when"):
            c = self.parse_expr()
            self.expect_kw("then")
            v = self.parse_expr()
            whens.append((c, v))
        else_ = self.parse_expr() if self.accept_kw("else") else None
        self.expect_kw("end")
        return A.CaseExpr(tuple(whens), else_, operand)

    def parse_type_name(self) -> str:
        name = self.parse_name()
        if self.accept_op("("):
            params = [self.eat().text]
            while self.accept_op(","):
                params.append(self.eat().text)
            self.expect_op(")")
            return f"{name}({','.join(params)})"
        return name


def parse(sql: str) -> A.Query:
    return Parser(sql).parse()
