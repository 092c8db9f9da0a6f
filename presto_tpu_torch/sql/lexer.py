"""SQL tokenizer.

Reference parity: the lexer half of ``presto-parser``'s ANTLR4
``SqlBase.g4`` [SURVEY §2.1; reference tree unavailable]. Hand-rolled
(no ANTLR in a zero-dependency build): one pass, line/col tracked for
error messages.

A copy of ``presto_tpu/sql/lexer.py`` (the port imports nothing of the JAX
package); keep the two identical.
"""

from __future__ import annotations

from dataclasses import dataclass

from presto_tpu_torch.runtime.errors import UserError


@dataclass(frozen=True)
class Token:
    kind: str  # KW | IDENT | NUMBER | STRING | OP | EOF
    text: str
    pos: int
    line: int
    col: int


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "exists", "between", "like", "is",
    "null", "case", "when", "then", "else", "end", "cast", "extract",
    "date", "timestamp", "interval", "year", "month", "day", "distinct", "join",
    "inner", "left", "right", "full", "outer", "cross", "on", "with",
    "asc", "desc", "nulls", "first", "last", "substring", "union", "all",
    "true", "false", "count", "sum", "avg", "min", "max", "any", "some",
    "for", "over", "partition", "rows", "range", "preceding", "following",
    "current", "row", "unbounded",
}

_TWO_CHAR_OPS = {"<=", ">=", "<>", "!=", "||"}
_ONE_CHAR_OPS = set("+-*/%(),.;=<>?")


class LexError(UserError):
    """Tokenizer rejection. A ``UserError`` (which is also a
    ``ValueError``): malformed SQL must surface through the TYPED
    error contract like every parse/analysis rejection, not as a bare
    built-in exception."""


def tokenize(sql: str) -> list[Token]:
    out: list[Token] = []
    i, n = 0, len(sql)
    line, col = 1, 1

    def advance(k: int):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and sql[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            advance(1)
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":
            while i < n and sql[i] != "\n":
                advance(1)
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":
            advance(2)
            while i + 1 < n and not (sql[i] == "*" and sql[i + 1] == "/"):
                advance(1)
            advance(2)
            continue
        start, sline, scol = i, line, col
        if c.isalpha() or c == "_":
            while i < n and (sql[i].isalnum() or sql[i] == "_"):
                advance(1)
            text = sql[start:i]
            kind = "KW" if text.lower() in KEYWORDS else "IDENT"
            out.append(Token(kind, text, start, sline, scol))
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            seen_dot = False
            while i < n and (sql[i].isdigit() or (sql[i] == "." and not seen_dot)):
                if sql[i] == ".":
                    # "1." followed by non-digit: stop before the dot
                    if i + 1 >= n or not sql[i + 1].isdigit():
                        break
                    seen_dot = True
                advance(1)
            out.append(Token("NUMBER", sql[start:i], start, sline, scol))
            continue
        if c == "'":
            advance(1)
            buf = []
            while True:
                if i >= n:
                    raise LexError(f"unterminated string at line {sline}")
                if sql[i] == "'":
                    if i + 1 < n and sql[i + 1] == "'":
                        buf.append("'")
                        advance(2)
                        continue
                    advance(1)
                    break
                buf.append(sql[i])
                advance(1)
            out.append(Token("STRING", "".join(buf), start, sline, scol))
            continue
        if c == '"':
            advance(1)
            qstart = i
            while i < n and sql[i] != '"':
                advance(1)
            if i >= n:
                raise LexError(f"unterminated quoted identifier at line {sline}")
            # QIDENT: case-preserved (unquoted identifiers fold to lower)
            out.append(Token("QIDENT", sql[qstart:i], qstart, sline, scol))
            advance(1)
            continue
        two = sql[i : i + 2]
        if two in _TWO_CHAR_OPS:
            out.append(Token("OP", "<>" if two == "!=" else two, start, sline, scol))
            advance(2)
            continue
        if c in _ONE_CHAR_OPS:
            out.append(Token("OP", c, start, sline, scol))
            advance(1)
            continue
        raise LexError(f"unexpected character {c!r} at line {line}:{col}")
    out.append(Token("EOF", "", n, line, col))
    return out
