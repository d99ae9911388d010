"""SQL frontend: recursive-descent parser + lowering to logical plans
(the port of `spark_tpu/sql/parser.py`; pure Python, so the port keeps
its own copy).

Covers the SELECT subset the engine executes: projections, arithmetic /
boolean / comparison expressions, CASE, BETWEEN, IN, LIKE, IS NULL,
CAST, DATE and INTERVAL literals, aggregate functions (incl. aggregates
inside arithmetic, extracted into the Aggregate node), WHERE, explicit
JOIN ... ON and TPC-H-style implicit comma joins (equi-keys are pulled
out of the WHERE conjunction), GROUP BY (names, aliases, positions),
HAVING, ORDER BY (names, positions, expressions), LIMIT, subqueries in
FROM, WITH clauses, scalar, IN and EXISTS subqueries in WHERE, window
functions (OVER with ROWS/RANGE frames), set operations (UNION ALL,
INTERSECT, EXCEPT) and grouping sets (ROLLUP, CUBE, GROUPING SETS),
every aggregate and scalar function of the function library, `explode`
in the select list, and the DDL/DML commands (CREATE/DROP/INSERT/SHOW/
DESCRIBE), which run at parse time against the catalog (`parse_sql`).

The reference parses with a generated ANTLR grammar + AstBuilder
(`sql/catalyst/.../parser/SqlBase.g4`, `AstBuilder.scala`); here a Pratt
-style descent over ~20 productions is enough, and lowering happens
inline because the DataFrame-facing logical plan resolves eagerly.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .. import types as T
from ..expr import (Alias, AnalysisError, And, CaseWhen, Cast, ColumnRef, EQ,
                    Expression, ExtractYear, GE, GT, In, IsNull, LE, LT, Like,
                    Literal, Mod, NE, Neg, Not, Or, SortOrder, Substring,
                    date_literal)
from ..expr_agg import (AggExpr, AggregateFunction, AnyValue, Avg,
                        AvgDistinct, BoolAnd, BoolOr, CollectList,
                        CollectSet, Corr, Count, CountDistinct, CountIf,
                        CovarPop, CovarSamp, First, Kurtosis, Last, Max,
                        Median, Min, Percentile, Skewness, StddevPop,
                        StddevSamp, Sum, SumDistinct, VariancePop,
                        VarianceSamp)
from ..plan import logical as L
from .lexer import ParseError, Token, tokenize

_KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "AS", "AND", "OR", "NOT", "IN", "LIKE", "BETWEEN", "IS", "NULL",
    "CASE", "WHEN", "THEN", "ELSE", "END", "CAST", "JOIN", "INNER",
    "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "SEMI", "ANTI", "ON",
    "ASC", "DESC", "UNION", "ALL", "DISTINCT", "DATE", "INTERVAL",
    "EXTRACT", "TRUE", "FALSE", "EXISTS", "WITH", "INTERSECT", "EXCEPT",
}


@dataclass
class _Interval:
    """A parsed INTERVAL literal; only valid inside date +/- interval."""
    days: int = 0
    months: int = 0
    years: int = 0


class _AggCall(Expression):
    """Parse-time wrapper so aggregate calls can sit inside scalar
    expression trees; lowering extracts them into the Aggregate node and
    substitutes a ColumnRef (the reference does the same extraction in
    `Analyzer.ResolveAggregateFunctions`)."""

    def __init__(self, func: AggregateFunction):
        self.func = func
        self.children = ()

    def dtype(self, schema):
        return self.func.result_type(schema)

    def nullable(self, schema):
        return True

    def references(self):
        return self.func.references()

    def __repr__(self):
        return repr(self.func)


def _contains_agg(e: Expression) -> bool:
    if isinstance(e, _AggCall):
        return True
    return any(_contains_agg(c) for c in e.children)


class Parser:
    def __init__(self, text: str, session=None):
        self.text = text
        self.tokens = tokenize(text)
        self.i = 0
        self.session = session

    # -- token helpers ------------------------------------------------------

    def peek(self, k: int = 0) -> Token:
        return self.tokens[min(self.i + k, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.upper in words

    def eat_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.eat_kw(word):
            t = self.peek()
            raise ParseError(
                f"expected {word} at position {t.pos}, got {t.value!r}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def eat_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            t = self.peek()
            raise ParseError(
                f"expected {op!r} at position {t.pos}, got {t.value!r}")

    # -- statements ---------------------------------------------------------

    def parse_statement(self) -> "_Select":
        ctes = []
        if self.at_kw("WITH"):
            self.next()
            while True:
                name = self._ident()
                col_aliases = None
                if self.at_op("("):
                    self.next()
                    col_aliases = [self._ident()]
                    while self.eat_op(","):
                        col_aliases.append(self._ident())
                    self.expect_op(")")
                self.expect_kw("AS")
                self.expect_op("(")
                body = self.parse_query_expr()
                self.expect_op(")")
                ctes.append((name, col_aliases, body))
                if not self.eat_op(","):
                    break
        sel = self.parse_query_expr()
        sel.ctes = ctes
        self.eat_op(";")
        t = self.peek()
        if t.kind != "eof":
            raise ParseError(f"unexpected trailing input at {t.pos}: "
                             f"{t.value!r}")
        return sel

    def parse_query_expr(self) -> "_Select":
        """select [UNION ALL select]... — the query-expression body used
        at top level AND inside CTE bodies/subqueries, so set operations
        work in every position."""
        def combine(left, right, kind):
            # a trailing ORDER BY / LIMIT binds to the WHOLE set
            # operation, not the right arm (standard SQL precedence)
            out = _Select(union_of=(left, right), set_op=kind,
                          order_by=right.order_by, limit=right.limit)
            right.order_by = None
            right.limit = None
            return out

        def intersect_term():
            # INTERSECT binds tighter than UNION/EXCEPT (standard SQL)
            t = self.parse_select()
            while self.at_kw("INTERSECT"):
                self.next()
                self.eat_kw("DISTINCT")
                t = combine(t, self.parse_select(), "intersect")
            return t

        sel = intersect_term()
        while self.at_kw("UNION", "EXCEPT"):
            op = self.next().upper
            if op == "UNION":
                if not self.eat_kw("ALL"):
                    raise ParseError("only UNION ALL is supported (UNION "
                                     "DISTINCT needs dropDuplicates)")
                kind = "union_all"
            else:
                self.eat_kw("DISTINCT")  # the default for set ops
                kind = "except"
            sel = combine(sel, intersect_term(), kind)
        return sel

    def parse_select(self) -> "_Select":
        self.expect_kw("SELECT")
        if self.eat_kw("DISTINCT"):
            distinct = True
        else:
            self.eat_kw("ALL")
            distinct = False
        items: List[Tuple[Expression, Optional[str]]] = []
        star = False
        while True:
            if self.at_op("*"):
                self.next()
                star = True
            else:
                e = self.parse_expr()
                alias = None
                if self.eat_kw("AS"):
                    alias = self._ident()
                elif self.peek().kind == "ident" and \
                        self.peek().upper not in _KEYWORDS:
                    alias = self._ident()
                items.append((e, alias))
            if not self.eat_op(","):
                break

        sel = _Select(items=items, star=star, distinct=distinct)
        if self.eat_kw("FROM"):
            sel.relations, sel.joins = self.parse_from()
        if self.eat_kw("WHERE"):
            sel.where = self.parse_expr()
        if self.at_kw("GROUP"):
            self.next()
            self.expect_kw("BY")
            if self.at_kw("ROLLUP", "CUBE", "GROUPING"):
                sel.group_by, sel.grouping_sets = \
                    self._parse_grouping_analytics()
            else:
                sel.group_by = [self.parse_expr()]
                while self.eat_op(","):
                    sel.group_by.append(self.parse_expr())
        if self.eat_kw("HAVING"):
            sel.having = self.parse_expr()
        if self.at_kw("ORDER"):
            self.next()
            self.expect_kw("BY")
            sel.order_by = [self.parse_sort_item()]
            while self.eat_op(","):
                sel.order_by.append(self.parse_sort_item())
        if self.eat_kw("LIMIT"):
            t = self.next()
            if t.kind != "number":
                raise ParseError(f"LIMIT expects a number at {t.pos}")
            sel.limit = int(t.value)
        return sel

    def _parse_grouping_analytics(self):
        """ROLLUP(a, b) / CUBE(a, b) / GROUPING SETS((a, b), (a), ())
        -> (full column list, list of name subsets). Reference:
        SqlBase.g4 groupingAnalytics -> Expand planning; here each set
        lowers to its own aggregate union-ed together (ExpandExec.scala
        semantics without the row-expansion operator)."""
        kind = self.next().upper
        cols: List[str] = []
        sets: List[List[str]] = []

        def ident_list():
            names = []
            self.expect_op("(")
            if not self.at_op(")"):
                names.append(self._ident())
                while self.eat_op(","):
                    names.append(self._ident())
            self.expect_op(")")
            return names

        if kind in ("ROLLUP", "CUBE"):
            cols = ident_list()
            if kind == "ROLLUP":
                sets = [cols[:i] for i in range(len(cols), -1, -1)]
            else:
                import itertools
                sets = [list(c) for r in range(len(cols), -1, -1)
                        for c in itertools.combinations(cols, r)]
        else:
            self.expect_kw("SETS")
            self.expect_op("(")
            while True:
                if self.at_op("("):
                    sets.append(ident_list())
                else:
                    # bare column = a single-column grouping set
                    sets.append([self._ident()])
                if not self.eat_op(","):
                    break
            self.expect_op(")")
            seen = []
            for s_ in sets:
                for n in s_:
                    if n not in seen:
                        seen.append(n)
            cols = seen
        return [ColumnRef(n) for n in cols], sets

    def _ident(self) -> str:
        t = self.next()
        if t.kind != "ident":
            raise ParseError(f"expected identifier at {t.pos}, "
                             f"got {t.value!r}")
        return t.value

    def parse_sort_item(self) -> Tuple[Expression, bool, Optional[bool]]:
        e = self.parse_expr()
        asc = True
        if self.eat_kw("DESC"):
            asc = False
        else:
            self.eat_kw("ASC")
        nulls_first: Optional[bool] = None
        if self.at_kw("NULLS"):
            self.next()
            if self.eat_kw("FIRST"):
                nulls_first = True
            elif self.eat_kw("LAST"):
                nulls_first = False
            else:
                raise ParseError("expected FIRST or LAST after NULLS")
        return (e, asc, nulls_first)

    # -- FROM clause --------------------------------------------------------

    def parse_from(self):
        relations: List[Tuple[object, Optional[str]]] = []
        joins: List[Tuple[str, object, Optional[str], Optional[Expression]]] = []
        relations.append(self.parse_table_ref())
        while True:
            if self.eat_op(","):
                relations.append(self.parse_table_ref())
                continue
            how = None
            if self.at_kw("JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS",
                          "SEMI", "ANTI"):
                w = self.next().upper
                if w == "JOIN":
                    how = "inner"
                else:
                    how = {"INNER": "inner", "LEFT": "left", "RIGHT": "right",
                           "FULL": "full", "CROSS": "cross",
                           "SEMI": "left_semi", "ANTI": "left_anti"}[w]
                    self.eat_kw("OUTER")
                    if w == "LEFT" and self.eat_kw("SEMI"):
                        how = "left_semi"
                    elif w == "LEFT" and self.eat_kw("ANTI"):
                        how = "left_anti"
                    elif w == "RIGHT" and self.at_kw("SEMI", "ANTI"):
                        raise ParseError(
                            "RIGHT SEMI/ANTI JOIN is not supported; "
                            "swap the operands and use LEFT SEMI/ANTI")
                    self.expect_kw("JOIN")
                ref, alias = self.parse_table_ref()
                cond = None
                if self.eat_kw("ON"):
                    cond = self.parse_expr()
                joins.append((how, ref, alias, cond))
                continue
            break
        return relations, joins

    def parse_table_ref(self):
        if self.at_op("("):
            self.next()
            sub = self.parse_query_expr()
            self.expect_op(")")
            self.eat_kw("AS")
            alias = self._ident()
            return (sub, alias)
        name = self._ident()
        alias = None
        if self.eat_kw("AS"):
            alias = self._ident()
        elif self.peek().kind == "ident" and \
                self.peek().upper not in _KEYWORDS:
            alias = self._ident()
        return (name, alias)

    # -- expressions (precedence climbing) ----------------------------------

    def parse_expr(self) -> Expression:
        return self.parse_or()

    def parse_or(self) -> Expression:
        e = self.parse_and()
        while self.eat_kw("OR"):
            e = Or(e, self.parse_and())
        return e

    def parse_and(self) -> Expression:
        e = self.parse_not()
        while self.eat_kw("AND"):
            e = And(e, self.parse_not())
        return e

    def parse_not(self) -> Expression:
        if self.eat_kw("NOT"):
            return Not(self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> Expression:
        e = self.parse_additive()
        negate = False
        if self.at_kw("NOT"):
            nxt = self.peek(1)
            if nxt.kind == "ident" and nxt.upper in ("IN", "LIKE", "BETWEEN"):
                self.next()
                negate = True
        if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
            op = self.next().value
            rhs = self.parse_additive()
            cls = {"=": EQ, "<>": NE, "!=": NE, "<": LT, "<=": LE,
                   ">": GT, ">=": GE}[op]
            e = self._fold_interval_cmp(cls, e, rhs)
        elif self.eat_kw("BETWEEN"):
            lo = self.parse_additive()
            self.expect_kw("AND")
            hi = self.parse_additive()
            e = And(GE(e, lo), LE(e, hi))
        elif self.eat_kw("IN"):
            self.expect_op("(")
            if self.at_kw("SELECT"):
                sub = self.parse_query_expr()
                self.expect_op(")")
                e = _InSubquery(e, sub)
            else:
                values = [self._literal_value()]
                while self.eat_op(","):
                    values.append(self._literal_value())
                self.expect_op(")")
                e = In(e, tuple(values))
        elif self.eat_kw("LIKE"):
            t = self.next()
            if t.kind != "string":
                raise ParseError(f"LIKE expects a string pattern at {t.pos}")
            e = Like(e, t.value)
        elif self.eat_kw("IS"):
            neg = self.eat_kw("NOT")
            self.expect_kw("NULL")
            e = IsNull(e)
            if neg:
                e = Not(e)
        if negate:
            e = Not(e)
        return e

    def _literal_value(self):
        t = self.next()
        if t.kind == "string":
            return t.value
        if t.kind == "number":
            return self._number(t.value)
        raise ParseError(f"expected literal at {t.pos}, got {t.value!r}")

    @staticmethod
    def _number(text: str):
        if "." in text or "e" in text or "E" in text:
            return float(text)
        return int(text)

    def _fold_interval_cmp(self, cls, lhs, rhs):
        return cls(lhs, rhs)

    def parse_additive(self) -> Expression:
        e = self.parse_multiplicative()
        while self.at_op("+", "-"):
            op = self.next().value
            rhs = self.parse_multiplicative()
            if isinstance(rhs, _IntervalExpr):
                e = _shift_date(e, rhs.interval, -1 if op == "-" else 1)
            elif op == "+":
                e = e + rhs
            else:
                e = e - rhs
        return e

    def parse_multiplicative(self) -> Expression:
        e = self.parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            rhs = self.parse_unary()
            if op == "*":
                e = e * rhs
            elif op == "/":
                e = e / rhs
            else:
                e = Mod(e, rhs)
        return e

    def parse_unary(self) -> Expression:
        if self.eat_op("-"):
            e = self.parse_unary()
            if isinstance(e, Literal) and isinstance(e.value, (int, float)):
                return Literal(-e.value, e._dtype)
            return Neg(e)
        if self.eat_op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> Expression:
        t = self.peek()
        if self.eat_op("("):
            if self.at_kw("SELECT"):
                sub = self.parse_query_expr()
                self.expect_op(")")
                return _ScalarSubquery(sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "number":
            self.next()
            return Literal(self._number(t.value))
        if t.kind == "string":
            self.next()
            return Literal(t.value)
        if t.kind != "ident":
            raise ParseError(f"unexpected token {t.value!r} at {t.pos}")

        u = t.upper
        if u == "NULL":
            self.next()
            return Literal(None)
        if u in ("TRUE", "FALSE"):
            self.next()
            return Literal(u == "TRUE")
        if u == "DATE":
            nxt = self.peek(1)
            if nxt.kind == "string":
                self.next()
                self.next()
                return date_literal(nxt.value)
        if u == "INTERVAL":
            self.next()
            return _IntervalExpr(self._parse_interval())
        if u == "EXISTS":
            self.next()
            self.expect_op("(")
            sub = self.parse_select()
            self.expect_op(")")
            return _ExistsSubquery(sub)
        if u == "CASE":
            return self.parse_case()
        if u == "CAST":
            self.next()
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("AS")
            dt = self.parse_type()
            self.expect_op(")")
            return Cast(e, dt)
        if u == "EXTRACT":
            self.next()
            self.expect_op("(")
            field = self._ident().upper()
            self.expect_kw("FROM")
            e = self.parse_expr()
            self.expect_op(")")
            if field == "YEAR":
                return ExtractYear(e)
            raise ParseError(f"EXTRACT({field}) is not supported")

        if u in _KEYWORDS:
            raise ParseError(f"unexpected keyword {t.value!r} at {t.pos}")
        # function call or (qualified) column reference
        if self.peek(1).kind == "op" and self.peek(1).value == "(":
            e = self.parse_function()
            if self.at_kw("OVER"):
                return self._parse_over(e)
            if isinstance(e, _RankingCall):
                raise ParseError(
                    f"{e.kind}() requires an OVER (...) clause")
            return e
        self.next()
        name = t.value
        if self.at_op(".") and self.peek(1).kind == "ident":
            self.next()
            return _QualifiedRef(name, self._ident())
        return ColumnRef(name)

    def _parse_interval(self) -> _Interval:
        t = self.next()
        if t.kind == "string":
            qty = int(t.value)
        elif t.kind == "number":
            qty = int(t.value)
        else:
            raise ParseError(f"INTERVAL expects a quantity at {t.pos}")
        unit = self._ident().upper().rstrip("S")
        if unit == "DAY":
            return _Interval(days=qty)
        if unit == "MONTH":
            return _Interval(months=qty)
        if unit == "YEAR":
            return _Interval(years=qty)
        raise ParseError(f"unsupported INTERVAL unit {unit!r}")

    def parse_case(self) -> Expression:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        branches = []
        while self.eat_kw("WHEN"):
            cond = self.parse_expr()
            if operand is not None:
                cond = EQ(operand, cond)
            self.expect_kw("THEN")
            branches.append((cond, self.parse_expr()))
        otherwise = None
        if self.eat_kw("ELSE"):
            otherwise = self.parse_expr()
        self.expect_kw("END")
        return CaseWhen(branches, otherwise)

    def parse_type(self) -> T.DataType:
        name = self._ident().upper()
        simple = {
            "INT": T.INT, "INTEGER": T.INT, "BIGINT": T.LONG, "LONG": T.LONG,
            "SMALLINT": T.SHORT, "TINYINT": T.BYTE, "DOUBLE": T.DOUBLE,
            "FLOAT": T.FLOAT, "REAL": T.FLOAT, "BOOLEAN": T.BOOLEAN,
            "DATE": T.DATE, "STRING": T.STRING, "VARCHAR": T.STRING,
            "CHAR": T.STRING, "TIMESTAMP": T.TIMESTAMP,
        }
        if name in simple:
            if name in ("VARCHAR", "CHAR") and self.eat_op("("):
                self.next()
                self.expect_op(")")
            return simple[name]
        if name in ("DECIMAL", "NUMERIC"):
            p, s = 10, 0
            if self.eat_op("("):
                p = int(self.next().value)
                if self.eat_op(","):
                    s = int(self.next().value)
                self.expect_op(")")
            return T.DecimalType(p, s)
        raise ParseError(f"unknown type {name!r}")

    _AGGS = {"SUM": Sum, "AVG": Avg, "MEAN": Avg, "MIN": Min, "MAX": Max,
             "STDDEV": StddevSamp, "STDDEV_SAMP": StddevSamp,
             "STDDEV_POP": StddevPop, "VARIANCE": VarianceSamp,
             "VAR_SAMP": VarianceSamp, "VAR_POP": VariancePop}

    #: DISTINCT-capable rewrite markers (RewriteDistinctAggregates)
    _DISTINCT_AGGS = {"SUM": SumDistinct, "AVG": AvgDistinct,
                      "MEAN": AvgDistinct}

    #: single-argument extended aggregates
    _AGGS_EXT = {"FIRST": First, "FIRST_VALUE": First, "LAST": Last,
                 "LAST_VALUE": Last, "ANY_VALUE": AnyValue,
                 "SKEWNESS": Skewness, "KURTOSIS": Kurtosis,
                 "BOOL_AND": BoolAnd, "EVERY": BoolAnd, "BOOL_OR": BoolOr,
                 "ANY": BoolOr, "SOME": BoolOr, "COUNT_IF": CountIf}

    #: two-argument aggregates (corr/covar)
    _AGGS2 = {"CORR": Corr, "COVAR_SAMP": CovarSamp, "COVAR_POP": CovarPop}

    def parse_function(self) -> Expression:
        name = self._ident().upper()
        self.expect_op("(")
        if name == "COUNT":
            if self.eat_op("*"):
                self.expect_op(")")
                return _AggCall(Count(None))
            if self.eat_kw("DISTINCT"):
                e = self.parse_expr()
                self.expect_op(")")
                return _AggCall(CountDistinct(e))
            e = self.parse_expr()
            self.expect_op(")")
            return _AggCall(Count(e))
        if name in self._AGGS:
            if self.eat_kw("DISTINCT"):
                marker = self._DISTINCT_AGGS.get(name)
                if marker is None:
                    raise ParseError(
                        f"{name}(DISTINCT ...) is not supported")
                e = self.parse_expr()
                self.expect_op(")")
                return _AggCall(marker(e))
            e = self.parse_expr()
            self.expect_op(")")
            return _AggCall(self._AGGS[name](e))
        if name in self._AGGS_EXT:
            e = self.parse_expr()
            self.expect_op(")")
            return _AggCall(self._AGGS_EXT[name](e))
        if name in self._AGGS2:
            x = self.parse_expr()
            self.expect_op(",")
            y = self.parse_expr()
            self.expect_op(")")
            return _AggCall(self._AGGS2[name](x, y))
        if name in ("PERCENTILE", "PERCENTILE_APPROX",
                    "APPROX_PERCENTILE"):
            e = self.parse_expr()
            self.expect_op(",")
            q = self.parse_expr()
            if not isinstance(q, Literal):
                raise ParseError(f"{name} fraction must be a literal")
            if self.eat_op(","):
                self.parse_expr()  # accuracy: exact anyway
            self.expect_op(")")
            return _AggCall(Percentile(e, float(q.value)))
        if name == "MEDIAN":
            e = self.parse_expr()
            self.expect_op(")")
            return _AggCall(Median(e))
        if name in ("COLLECT_LIST", "COLLECT_SET", "ARRAY_AGG"):
            e = self.parse_expr()
            self.expect_op(")")
            cls = CollectSet if name == "COLLECT_SET" else CollectList
            return _AggCall(cls(e))
        if name in ("ROW_NUMBER", "RANK", "DENSE_RANK"):
            self.expect_op(")")
            return _RankingCall(name.lower(), None, 0, None)
        if name in ("LAG", "LEAD"):
            arg = self.parse_expr()
            offset, default = 1, None
            if self.eat_op(","):
                off = self.parse_expr()
                if not (isinstance(off, Literal)
                        and isinstance(off.value, int)):
                    raise ParseError(f"{name} offset must be a literal int")
                offset = off.value
                if self.eat_op(","):
                    dflt = self.parse_expr()
                    if not isinstance(dflt, Literal):
                        raise ParseError(f"{name} default must be a literal")
                    default = dflt.value
            self.expect_op(")")
            return _RankingCall(name.lower(), arg,
                                offset if name == "LAG" else -offset,
                                default)
        args: List[Expression] = []
        if not self.at_op(")"):
            args.append(self.parse_expr())
            while self.eat_op(","):
                args.append(self.parse_expr())
        self.expect_op(")")
        return self._scalar_function(name, args)

    def _parse_frame_clause(self):
        """ROWS|RANGE BETWEEN <bound> AND <bound> (or the single-bound
        short form `ROWS n PRECEDING`), reference SqlBase.g4
        windowFrame."""
        from ..window import (CURRENT_ROW, UNBOUNDED_FOLLOWING,
                              UNBOUNDED_PRECEDING)
        kind = "rows" if self.eat_kw("ROWS") else "range"
        if kind == "range":
            self.expect_kw("RANGE")

        def bound(default_end=False):
            if self.eat_kw("UNBOUNDED"):
                if self.eat_kw("PRECEDING"):
                    return UNBOUNDED_PRECEDING
                self.expect_kw("FOLLOWING")
                return UNBOUNDED_FOLLOWING
            if self.eat_kw("CURRENT"):
                self.expect_kw("ROW")
                return CURRENT_ROW
            t = self.next()
            if t.kind != "number":
                raise ParseError(
                    f"expected a frame bound at {t.pos}, got {t.value!r}")
            try:
                n = int(t.value)
            except ValueError:
                raise ParseError(
                    f"frame bounds must be integers, got {t.value!r} "
                    f"at {t.pos}") from None
            if self.eat_kw("PRECEDING"):
                return -n
            self.expect_kw("FOLLOWING")
            return n

        if self.eat_kw("BETWEEN"):
            start = bound()
            self.expect_kw("AND")
            end = bound()
        else:
            start = bound()
            end = CURRENT_ROW
        return (kind, start, end)

    def _parse_over(self, call: Expression) -> Expression:
        """fn(...) OVER ([PARTITION BY ...] [ORDER BY ...])."""
        from ..window import WindowExpr, WindowSpec
        self.expect_kw("OVER")
        self.expect_op("(")
        partition: List[Expression] = []
        order: List[SortOrder] = []
        if self.at_kw("PARTITION"):
            self.next()
            self.expect_kw("BY")
            partition.append(self.parse_expr())
            while self.eat_op(","):
                partition.append(self.parse_expr())
        if self.at_kw("ORDER"):
            self.next()
            self.expect_kw("BY")
            while True:
                e, asc, nf = self.parse_sort_item()
                order.append(SortOrder(e, ascending=asc, nulls_first=nf))
                if not self.eat_op(","):
                    break
        frame = None
        if self.at_kw("ROWS", "RANGE"):
            frame = self._parse_frame_clause()
        self.expect_op(")")
        spec = WindowSpec(tuple(partition), tuple(order), frame)
        if isinstance(call, _RankingCall):
            if not order:
                raise ParseError(
                    f"{call.kind}() requires ORDER BY in its OVER clause")
            return WindowExpr(call.kind, call.arg, spec,
                              offset=call.offset, default=call.default)
        if isinstance(call, _AggCall):
            from ..window import AGG_WINDOW_KINDS
            kind = AGG_WINDOW_KINDS.get(type(call.func).__name__)
            if kind is None:
                raise ParseError(
                    f"{type(call.func).__name__} is not supported as a "
                    f"window function")
            return WindowExpr(kind, call.func.child, spec)
        raise ParseError("OVER applies to window or aggregate functions")

    def _scalar_function(self, name: str, args: List[Expression]) -> Expression:
        if name in ("SUBSTRING", "SUBSTR") and len(args) == 3:
            start = args[1]
            length = args[2]
            if not (isinstance(start, Literal) and isinstance(length, Literal)):
                raise ParseError("SUBSTRING requires literal start/length")
            return Substring(args[0], int(start.value), int(length.value))
        # registry-driven dispatch (reference: FunctionRegistry.scala);
        # replaces the round-3 hand list
        from .registry import lookup
        out = lookup(name, args)
        if out is not None:
            return out
        # session-registered Python UDFs (UDFRegistration.scala analog)
        if self.session is not None:
            u = self.session.udf.lookup(name)
            if u is not None:
                return u(*args)
        raise ParseError(f"unknown function {name!r}")


def _classify_side_multi(e: Expression, per_alias: dict,
                         all_inner) -> str:
    """'inner' | 'outer' | 'mixed' | 'none' for a subquery conjunct,
    honoring table qualifiers (references() drops them, which
    misclassified `bounds.k = tiny.k`-style correlation). Unqualified
    names resolve inner-first (the inner scope shadows the outer)."""
    saw_inner = saw_outer = False

    def walk(node):
        nonlocal saw_inner, saw_outer
        if isinstance(node, _QualifiedRef):
            names = per_alias.get(node.qualifier)
            if names is not None and node.col in names:
                saw_inner = True
            else:
                saw_outer = True
            return
        if isinstance(node, ColumnRef):
            if node.name() in all_inner:
                saw_inner = True
            else:
                saw_outer = True
            return
        for c in node.children:
            walk(c)

    walk(e)
    if saw_inner and saw_outer:
        return "mixed"
    if saw_inner:
        return "inner"
    if saw_outer:
        return "outer"
    return "none"


class _SubqueryExpr(Expression):
    """Base for parse-time subquery expressions; consumed by the
    Lowerer's rewrite passes (reference: `optimizer/subquery.scala`
    RewritePredicateSubquery / RewriteCorrelatedScalarSubquery)."""

    def __init__(self, select: "_Select", child: Optional[Expression] = None):
        self.select = select
        self.children = () if child is None else (child,)

    def references(self):
        return set() if not self.children else self.children[0].references()

    def dtype(self, schema):
        raise AnalysisError(
            f"{type(self).__name__} must be rewritten before analysis")


class _InSubquery(_SubqueryExpr):
    def __init__(self, child: Expression, select: "_Select"):
        super().__init__(select, child)

    def __repr__(self):
        return f"({self.children[0]!r} IN (<subquery>))"


class _ExistsSubquery(_SubqueryExpr):
    def __repr__(self):
        return "EXISTS(<subquery>)"


class _ScalarSubquery(_SubqueryExpr):
    def __repr__(self):
        return "(<scalar subquery>)"


def _contains_subquery(e: Expression) -> bool:
    if isinstance(e, _SubqueryExpr):
        return True
    return any(_contains_subquery(c) for c in e.children)


class _RankingCall(Expression):
    """Parse-time sentinel for row_number/rank/dense_rank/lag/lead —
    only valid immediately followed by OVER."""

    def __init__(self, kind: str, arg, offset: int, default):
        self.kind = kind
        self.arg = arg
        self.offset = offset
        self.default = default
        self.children = () if arg is None else (arg,)

    def dtype(self, schema):
        raise AnalysisError(f"{self.kind}() requires an OVER clause")


class _QualifiedRef(Expression):
    """`alias.col` — resolved against the FROM-clause relations during
    lowering, then rewritten to a plain ColumnRef (the engine's plans
    resolve flat names; the reference resolves qualifiers in
    `Analyzer.ResolveReferences`)."""

    def __init__(self, qualifier: str, col: str):
        self.qualifier = qualifier
        self.col = col
        self.children = ()

    def dtype(self, schema):
        raise AnalysisError(
            f"unresolved qualified reference {self.qualifier}.{self.col}")

    def references(self):
        return {self.col}

    def __repr__(self):
        return f"{self.qualifier}.{self.col}"


class _IntervalExpr(Expression):
    """Transient node produced for INTERVAL literals; must be consumed by
    date +/- interval folding before lowering."""

    def __init__(self, interval: _Interval):
        self.interval = interval
        self.children = ()

    def dtype(self, schema):
        raise AnalysisError("INTERVAL is only valid in date +/- interval")


def _shift_date(e: Expression, iv: _Interval, sign: int) -> Expression:
    """Fold `date_literal +/- interval` into a new DATE literal."""
    if not (isinstance(e, Literal) and isinstance(e._dtype, T.DateType)):
        raise AnalysisError("date +/- INTERVAL requires a DATE literal "
                            "on the left")
    days = int(e.value)
    d = (np.datetime64("1970-01-01", "D") + np.timedelta64(days, "D")
         ).astype(datetime.date)
    if iv.years or iv.months:
        months = d.year * 12 + (d.month - 1) + sign * (iv.years * 12 + iv.months)
        y, m = divmod(months, 12)
        # clamp the day to the target month's length (SQL add_months)
        import calendar
        day = min(d.day, calendar.monthrange(y, m + 1)[1])
        d = datetime.date(y, m + 1, day)
    if iv.days:
        d = d + datetime.timedelta(days=sign * iv.days)
    return date_literal(d.isoformat())


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------

@dataclass
class _Select:
    items: List[Tuple[Expression, Optional[str]]] = None
    star: bool = False
    distinct: bool = False
    relations: List = None
    joins: List = None
    where: Optional[Expression] = None
    group_by: Optional[List[Expression]] = None
    having: Optional[Expression] = None
    order_by: Optional[List[Tuple[Expression, bool, Optional[bool]]]] = None
    limit: Optional[int] = None
    union_of: Optional[Tuple["_Select", "_Select"]] = None
    set_op: str = "union_all"  # union_all | intersect | except
    grouping_sets: Optional[List[List[str]]] = None  # ROLLUP/CUBE/SETS
    ctes: Optional[List] = None  # (name, col_aliases, _Select) triples


def _conjuncts(e: Optional[Expression]) -> List[Expression]:
    if e is None:
        return []
    if isinstance(e, And):
        return _conjuncts(e.children[0]) + _conjuncts(e.children[1])
    return [e]


def _and_all(es: Sequence[Expression]) -> Optional[Expression]:
    out = None
    for e in es:
        out = e if out is None else And(out, e)
    return out


class _Scope:
    """Name resolution over the FROM-clause relations: tracks which
    relation owns each column, and each (relation, column)'s CURRENT
    output name as joins rename collisions with the `_r` suffix."""

    def __init__(self):
        self.rels: Dict[str, List[str]] = {}        # alias -> column names
        self.current: Dict[Tuple[str, str], str] = {}  # (alias, col) -> name

    def add(self, alias: str, names: Sequence[str]) -> None:
        if alias in self.rels:
            raise AnalysisError(f"duplicate relation alias {alias!r}")
        self.rels[alias] = list(names)
        for n in names:
            self.current[(alias, n)] = n

    def qrefs(self, e: Expression, within: Set[str]) -> Set[Tuple[str, str]]:
        """All (alias, col) pairs an expression references, resolving
        unqualified names against `within` (raises on ambiguity)."""
        out: Set[Tuple[str, str]] = set()

        def walk(node):
            if isinstance(node, _QualifiedRef):
                if node.qualifier not in self.rels:
                    raise AnalysisError(
                        f"unknown relation {node.qualifier!r}")
                if node.col not in self.rels[node.qualifier]:
                    raise AnalysisError(
                        f"column {node.col!r} not in {node.qualifier!r}")
                out.add((node.qualifier, node.col))
                return
            if isinstance(node, ColumnRef):
                owners = [a for a in within
                          if node.name() in self.rels.get(a, ())]
                if len(owners) > 1:
                    raise AnalysisError(
                        f"ambiguous column {node.name()!r} (in "
                        f"{sorted(owners)}); qualify it")
                if owners:
                    out.add((owners[0], node.name()))
                return
            if isinstance(node, _AggCall):
                for c in node.func.children:
                    walk(c)
                return
            for c in node.children:
                walk(c)

        walk(e)
        return out

    def rewrite(self, e: Expression) -> Expression:
        """Replace qualified refs (and renamed unqualified refs) with the
        current flat output names."""
        if isinstance(e, _QualifiedRef):
            key = (e.qualifier, e.col)
            if key not in self.current:
                raise AnalysisError(f"cannot resolve {e!r}")
            return ColumnRef(self.current[key])
        if isinstance(e, ColumnRef):
            owners = [a for a in self.rels if e.name() in self.rels[a]]
            if len(owners) > 1:
                raise AnalysisError(
                    f"ambiguous column {e.name()!r} (in {sorted(owners)}); "
                    f"qualify it")
            if len(owners) == 1:
                return ColumnRef(self.current[(owners[0], e.name())])
            return e
        if isinstance(e, _AggCall):
            if e.func.children:
                return _AggCall(e.func.with_args(
                    [self.rewrite(c) for c in e.func.children]))
            return e
        return e.map_children(self.rewrite)

    def apply_rename(self, rename: Dict[str, str],
                     right_aliases: Set[str]) -> None:
        """Record the `_r`-suffix renames a join applied to the build-side
        relations' columns (rename maps pre-join name -> post-join name)."""
        for alias in right_aliases:
            for col in self.rels[alias]:
                cur = self.current[(alias, col)]
                if cur in rename and rename[cur] != cur:
                    self.current[(alias, col)] = rename[cur]


def _split_equi(conds: List[Expression], scope: _Scope,
                bound: Set[str], new: Set[str]):
    """Partition join conjuncts into equi key pairs (left side bound,
    right side the newly-joined relation) and residuals."""
    lk, rk, residual = [], [], []
    within = bound | new
    for c in conds:
        if isinstance(c, EQ):
            a, b = c.children
            ar = {al for al, _ in scope.qrefs(a, within)}
            br = {al for al, _ in scope.qrefs(b, within)}
            if ar and ar <= bound and br and br <= new:
                lk.append(a)
                rk.append(b)
                continue
            if ar and ar <= new and br and br <= bound:
                lk.append(b)
                rk.append(a)
                continue
        residual.append(c)
    return lk, rk, residual


class Lowerer:
    def __init__(self, session):
        self.session = session
        self._agg_counter = 0
        self._sq_counter = 0
        # WITH-clause views: name -> lowered plan, shared across every
        # reference in the statement (FROM and subqueries alike)
        self._ctes: Dict[str, L.LogicalPlan] = {}

    def lower(self, sel: _Select) -> L.LogicalPlan:
        for name, col_aliases, body in (sel.ctes or []):
            plan = self.lower(body)
            if col_aliases:
                names = plan.schema().names
                if len(col_aliases) != len(names):
                    raise AnalysisError(
                        f"CTE {name!r} declares {len(col_aliases)} "
                        f"columns but its query yields {len(names)}")
                plan = L.Project(plan, [Alias(ColumnRef(n), a)
                                        for n, a in zip(names,
                                                        col_aliases)])
            self._ctes[name] = plan
            # mark for the plan-fingerprint cache: a CTE referenced
            # more than once (Q15's FROM + scalar subquery) materializes
            # once on first use instead of re-executing per reference.
            # implicit=True scopes the entry to one statement execution
            # (evicted afterwards — no staleness, no unbounded growth)
            self.session.mark_cache(plan, implicit=True)
        if sel.grouping_sets:
            return self._lower_grouping_sets(sel)
        if sel.union_of is not None:
            lplan = self.lower(sel.union_of[0])
            rplan = self.lower(sel.union_of[1])
            if sel.set_op == "union_all":
                plan = L.Union(lplan, rplan)
            else:
                from ..dataframe import set_op_plan
                plan = set_op_plan(lplan, rplan,
                                   "left_semi" if sel.set_op ==
                                   "intersect" else "left_anti")
            plan = self._lower_order_limit(sel, plan)
            if sel.limit is not None:
                plan = L.Limit(plan, sel.limit)
            return plan
        plan, remaining, scope = self._lower_from(sel)
        plain = [c for c in remaining if not _contains_subquery(c)]
        subq = [c for c in remaining if _contains_subquery(c)]
        if plain:
            plan = L.Filter(plan, _and_all([scope.rewrite(c)
                                            for c in plain]))
        for c in subq:
            plan = self._rewrite_subquery_conjunct(plan, c, scope)
        sel = _Select(
            items=[(scope.rewrite(e), a) for e, a in (sel.items or [])],
            star=sel.star, distinct=sel.distinct,
            group_by=None if sel.group_by is None
            else [scope.rewrite(g) for g in sel.group_by],
            having=None if sel.having is None else scope.rewrite(sel.having),
            order_by=None if sel.order_by is None
            else [(scope.rewrite(e), asc, nf)
                  for e, asc, nf in sel.order_by],
            limit=sel.limit)
        plan = self._lower_projection(sel, plan)
        if sel.limit is not None:
            plan = L.Limit(plan, sel.limit)
        return plan

    # -- FROM/WHERE: relations + join extraction ---------------------------

    def _rel_plan(self, ref) -> L.LogicalPlan:
        if isinstance(ref, _Select):
            return self.lower(ref)
        if ref in self._ctes:
            return self._ctes[ref]
        if ref not in self.session.catalog:
            raise AnalysisError(
                f"table {ref!r} not found; known: "
                f"{sorted(self._ctes) + sorted(self.session.catalog)}")
        return L.Scan(self.session.catalog[ref])

    def _lower_from(self, sel: _Select):
        where = _conjuncts(sel.where)
        agg_where = [c for c in where if _contains_agg(c)]
        if agg_where:
            raise AnalysisError("aggregate functions are not allowed in "
                                "WHERE (use HAVING)")
        scope = _Scope()
        if not sel.relations:
            if sel.where is not None or sel.joins:
                raise AnalysisError("WHERE/JOIN without FROM")
            return L.Range(0, 1), [], scope

        def rel_alias(ref, alias) -> str:
            if alias:
                return alias
            if isinstance(ref, str):
                return ref
            raise AnalysisError("a subquery in FROM needs an alias")

        rels: List[Tuple[str, L.LogicalPlan]] = []
        for ref, alias in sel.relations:
            p = self._rel_plan(ref)
            a = rel_alias(ref, alias)
            scope.add(a, p.schema().names)
            rels.append((a, p))
        join_rels = []
        for how, ref, alias, cond in (sel.joins or []):
            p = self._rel_plan(ref)
            a = rel_alias(ref, alias)
            scope.add(a, p.schema().names)
            join_rels.append((how, a, p, cond))

        all_aliases = set(scope.rels)

        def refs(c) -> Set[str]:
            return {al for al, _ in scope.qrefs(c, all_aliases)}

        # single-table predicates push below the joins (the optimizer also
        # does this, but doing it here keeps implicit-join search simple
        # and cross-join intermediates small)
        def push_single(alias, plan):
            nonlocal where
            # subquery conjuncts must survive to the rewrite pass — their
            # inner references are invisible to references()
            mine = [c for c in where
                    if not _contains_subquery(c) and refs(c) == {alias}]
            if mine:
                # identity-based removal: Expression.__eq__ is the DSL EQ
                # constructor, so `c in mine` would match everything
                where = [c for c in where
                         if not any(c is m for m in mine)]
                return L.Filter(plan, _and_all([scope.rewrite(c)
                                                for c in mine]))
            return plan

        rels = [(a, push_single(a, p)) for a, p in rels]

        def make_join(plan, bound, right_alias, right_plan, how,
                      lk, rk, residual):
            """Build the join — flipping sides for inner joins when the new
            relation is the bigger one, so fact tables land on the probe
            (left) side and dimensions on the build side (the
            `JoinSelection`-style size heuristic) — then record the `_r`
            renames it applies and rewrite the residual against the
            post-join names."""
            from ..plan.planner import estimate_rows
            lk = [scope.rewrite(k) for k in lk]
            rk = [scope.rewrite(k) for k in rk]
            left, right = plan, right_plan
            left_aliases, right_aliases = set(bound), {right_alias}
            if how == "inner":
                eb = estimate_rows(plan)
                en = estimate_rows(right_plan)
                if en is not None and (eb is None or en > eb):
                    left, right = right_plan, plan
                    lk, rk = rk, lk
                    left_aliases, right_aliases = right_aliases, left_aliases
            join = L.Join(left, right, lk, rk, how, None)
            if how not in ("left_semi", "left_anti"):
                scope.apply_rename(join.right_name_map(), right_aliases)
            if residual:
                join = L.Join(left, right, lk, rk, how,
                              _and_all([scope.rewrite(c)
                                        for c in residual]))
            return join

        (alias0, plan) = rels[0]
        bound = {alias0}
        pending = list(rels[1:])
        while pending:
            progressed = False
            for i, (a, p) in enumerate(pending):
                linking = [c for c in where
                           if not _contains_subquery(c)
                           and refs(c) and refs(c) <= (bound | {a})
                           and a in refs(c)
                           and (refs(c) & bound)]
                lk, rk, residual = _split_equi(linking, scope, bound, {a})
                if lk:
                    where = [c for c in where
                             if not any(c is m for m in linking)]
                    plan = make_join(plan, bound, a, p, "inner",
                                     lk, rk, residual)
                    bound.add(a)
                    pending.pop(i)
                    progressed = True
                    break
            if progressed:
                continue
            # no equi link: cross join the next relation, conditions stay
            # in WHERE and apply after (the optimizer cannot save a truly
            # unlinked product — that is the query's semantics)
            a, p = pending.pop(0)
            from ..expr import Literal as Lit
            plan = make_join(plan, bound, a, p, "inner",
                             [Lit(1)], [Lit(1)], [])
            bound.add(a)

        for how, a, p, cond in join_rels:
            if how == "cross":
                from ..expr import Literal as Lit
                plan = make_join(plan, bound, a, p, "inner",
                                 [Lit(1)], [Lit(1)], _conjuncts(cond))
                bound.add(a)
                continue
            lk, rk, residual = _split_equi(_conjuncts(cond), scope,
                                           bound, {a})
            if not lk:
                raise AnalysisError(
                    f"JOIN ON requires at least one equi-condition "
                    f"(got {cond!r})")
            plan = make_join(plan, bound, a, p, how, lk, rk, residual)
            bound.add(a)

        return plan, where, scope

    # -- SELECT/GROUP BY/HAVING/ORDER BY ------------------------------------

    def _fresh_agg_name(self) -> str:
        self._agg_counter += 1
        return f"_agg{self._agg_counter}"

    def _extract_aggs(self, e: Expression, aggs: List[AggExpr],
                      top_alias: Optional[str] = None) -> Expression:
        """Replace _AggCall nodes with ColumnRefs, appending AggExprs.
        Reuses an existing output for structurally equal aggregates."""
        if isinstance(e, _AggCall):
            for existing in aggs:
                if repr(existing.func) == repr(e.func):
                    return ColumnRef(existing.out_name)
            name = top_alias or self._fresh_agg_name()
            aggs.append(AggExpr(e.func, name))
            return ColumnRef(name)
        if isinstance(e, Alias):
            inner = self._extract_aggs(e.child, aggs, top_alias=e.name())
            if isinstance(inner, ColumnRef) and inner.name() == e.name():
                return inner
            return Alias(inner, e.name())
        return e.map_children(lambda c: self._extract_aggs(c, aggs))

    def _lower_projection(self, sel: _Select, plan: L.LogicalPlan
                          ) -> L.LogicalPlan:
        child_names = plan.schema().names
        items: List[Tuple[Expression, Optional[str]]] = list(sel.items or [])
        if sel.star:
            star_items = [(ColumnRef(n), None) for n in child_names]
            items = star_items + items

        # uncorrelated scalar subqueries are legal anywhere an expression
        # is (SELECT items, HAVING thresholds — TPC-H Q11): lower them to
        # executor-resolved ScalarSubqueryExpr nodes up front. Correlated
        # ones outside WHERE stay unsupported (raise at analysis).
        def scalarize(e: Expression) -> Expression:
            if isinstance(e, _ScalarSubquery):
                if self._subquery_is_correlated(e.select):
                    raise AnalysisError(
                        "correlated scalar subqueries are only supported "
                        "in WHERE conjuncts (not SELECT/HAVING)")
                return L.ScalarSubqueryExpr(self.lower(e.select))
            return e.map_children(scalarize)

        items = [(scalarize(e), a) for e, a in items]
        if sel.having is not None:
            sel.having = scalarize(sel.having)

        has_agg = any(_contains_agg(e) for e, _ in items) or \
            sel.group_by is not None or \
            (sel.having is not None and _contains_agg(sel.having))

        from ..window import contains_window
        from ..expr_array import contains_explode
        has_window = any(contains_window(e) for e, _ in items)
        has_gen = any(contains_explode(e) for e, _ in items)
        if has_window or has_gen:
            if has_agg:
                raise AnalysisError(
                    "window functions / explode with GROUP BY in one "
                    "SELECT are not supported yet (use a FROM subquery)")
            plan, items = self._extract_window_items(plan, items)

        if sel.distinct and has_agg:
            raise AnalysisError(
                "SELECT DISTINCT with aggregates is not supported yet")
        if sel.having is not None and not has_agg:
            raise AnalysisError(
                "HAVING requires GROUP BY or aggregate functions "
                "(use WHERE for row filters)")

        def out_name(e: Expression, alias: Optional[str], idx: int) -> str:
            if alias:
                return alias
            if isinstance(e, (ColumnRef, Alias)):
                return e.name()
            if isinstance(e, _AggCall):
                return repr(e.func)
            return f"col{idx}"

        if not has_agg:
            exprs = [Alias(e, out_name(e, a, i)) if not (
                isinstance(e, ColumnRef) and a is None) else e
                for i, (e, a) in enumerate(items)]
            out_names = {out_name(e, a, i)
                         for i, (e, a) in enumerate(items)}
            if sel.order_by:
                # resolve ORDER BY ordinals against the SELECT list here —
                # the hidden-sort path below would otherwise bind them to
                # the pre-projection child schema
                resolved = []
                for k, asc, nf in sel.order_by:
                    if isinstance(k, Literal) and isinstance(k.value, int):
                        idx = k.value - 1
                        if not (0 <= idx < len(items)):
                            raise AnalysisError(
                                f"ORDER BY position {k.value} out of range")
                        k = ColumnRef(out_name(items[idx][0],
                                               items[idx][1], idx))
                    resolved.append((k, asc, nf))
                sel.order_by = resolved
            if sel.distinct and sel.order_by and any(
                    (k.references() - out_names)
                    and k.references() <= set(child_names)
                    for k, _, _ in sel.order_by):
                # the dedupe would have to run between the hidden sort and
                # the projection, destroying the requested order
                raise AnalysisError(
                    "SELECT DISTINCT: ORDER BY must reference select-list "
                    "columns")
            if sel.order_by and any(
                    (k.references() - out_names)
                    and k.references() <= set(child_names)
                    for k, _, _ in sel.order_by):
                # ORDER BY keys hidden by the projection: sort below it
                # (reference: Analyzer.ResolveSortReferences adds a hidden
                # projection; ordering is stable through Project). Keys on
                # select aliases substitute the aliased expression.
                subst = {a: e for (e, a) in items if a}

                def desugar(k: Expression) -> Expression:
                    if isinstance(k, ColumnRef) and k.name() in subst \
                            and k.name() not in child_names:
                        return subst[k.name()]
                    return k.map_children(desugar)

                sorted_below = self._lower_order_limit(
                    sel, plan, key_rewrite=desugar)
                return L.Project(sorted_below, exprs)
            plan = L.Project(plan, exprs)
            if sel.distinct:
                plan = L.Aggregate(
                    plan, [ColumnRef(n) for n in plan.schema().names], [])
            plan = self._lower_order_limit(sel, plan)
            return plan

        # aggregate query: resolve group expressions (positions / aliases /
        # expressions), split each select item into group-key or aggregate
        groups: List[Expression] = []
        for g in (sel.group_by or []):
            if isinstance(g, Literal) and isinstance(g.value, int):
                idx = g.value - 1
                if not (0 <= idx < len(items)):
                    raise AnalysisError(f"GROUP BY position {g.value} out "
                                        f"of range")
                e, a = items[idx]
                groups.append(Alias(e, out_name(e, a, idx))
                              if not isinstance(e, ColumnRef) or a else e)
                continue
            if isinstance(g, ColumnRef) and g.name() not in child_names:
                # group by a select alias
                for i, (e, a) in enumerate(items):
                    if a == g.name():
                        groups.append(Alias(e, a))
                        break
                else:
                    raise AnalysisError(
                        f"GROUP BY column {g.name()!r} not found")
                continue
            groups.append(g)

        def group_key_name(g: Expression) -> str:
            return g.name() if isinstance(g, (ColumnRef, Alias)) else repr(g)

        group_names = [group_key_name(g) for g in groups]
        aggs: List[AggExpr] = []
        post: List[Expression] = []
        for i, (e, a) in enumerate(items):
            name = out_name(e, a, i)
            if not _contains_agg(e):
                # must be a group key (SQL: non-aggregated select columns
                # must appear in GROUP BY)
                matched = None
                for g, gname in zip(groups, group_names):
                    from ..expr import structurally_equal
                    ge = g.child if isinstance(g, Alias) else g
                    ee = e.child if isinstance(e, Alias) else e
                    if structurally_equal(ge, ee) or gname == name:
                        matched = gname
                        break
                if matched is None:
                    raise AnalysisError(
                        f"column {name!r} must appear in GROUP BY or inside "
                        f"an aggregate")
                post.append(ColumnRef(matched) if matched == name
                            else Alias(ColumnRef(matched), name))
                continue
            replaced = self._extract_aggs(e, aggs, top_alias=a
                                          if isinstance(e, _AggCall) else None)
            if isinstance(replaced, ColumnRef) and replaced.name() == name:
                post.append(replaced)
            else:
                post.append(Alias(replaced, name))

        having_expr = None
        if sel.having is not None:
            having_expr = self._extract_aggs(sel.having, aggs)

        plan = L.Aggregate(plan, groups, aggs)
        if having_expr is not None:
            plan = L.Filter(plan, having_expr)
        plan = L.Project(plan, post)
        return self._lower_order_limit(sel, plan)

    # -- subquery rewrites (reference: optimizer/subquery.scala) ------------

    def _inner_universe(self, sub: _Select):
        """(aliases, per-alias column names) over every FROM relation and
        explicit join of a subquery — inner scope shadows outer for
        unqualified names (standard SQL name resolution)."""
        per_alias = {}
        refs = list(sub.relations or [])
        refs += [(ref, alias) for _how, ref, alias, _c
                 in (sub.joins or [])]
        for ref, alias in refs:
            if isinstance(ref, _Select):
                raise AnalysisError(
                    "FROM subqueries inside correlated subqueries are "
                    "not supported")
            a = alias or ref
            per_alias[a] = set(self._rel_plan(ref).schema().names)
        return per_alias

    def _split_correlation(self, sub: _Select, outer_scope: _Scope):
        """Split a (possibly multi-relation) subquery's WHERE into local
        conjuncts (RAW — the inner query's own lowering resolves them)
        and (outer_expr_rewritten, inner_expr_raw) equi-correlation
        pairs. Returns (local_conjuncts, pairs)."""
        if not sub.relations:
            raise AnalysisError("correlated subqueries need a FROM clause")
        if sub.group_by or sub.having or sub.limit is not None \
                or sub.order_by:
            raise AnalysisError(
                "GROUP BY/HAVING/ORDER BY/LIMIT inside a correlated "
                "predicate subquery is not supported")
        per_alias = self._inner_universe(sub)
        all_inner = set().union(*per_alias.values()) if per_alias else set()

        def side(e: Expression) -> str:
            return _classify_side_multi(e, per_alias, all_inner)

        local, pairs, residuals = [], [], []
        self._last_inner_universe = (per_alias, all_inner)
        for c in _conjuncts(sub.where):
            s = side(c)
            if s in ("inner", "none"):
                local.append(c)
                continue
            if isinstance(c, EQ):
                a, b = c.children
                for inner_e, outer_e in ((a, b), (b, a)):
                    if side(inner_e) == "inner" and \
                            side(outer_e) == "outer":
                        pairs.append((outer_scope.rewrite(outer_e),
                                      inner_e))
                        break
                else:
                    residuals.append(c)
            else:
                # non-equi correlation (e.g. l2.l_suppkey <> l1.l_suppkey
                # in Q21): EXISTS carries these as a join residual; the
                # scalar-aggregate rewrite cannot
                residuals.append(c)
        return local, pairs, residuals

    def _rewrite_subquery_conjunct(self, plan: L.LogicalPlan,
                                   c: Expression, scope: _Scope
                                   ) -> L.LogicalPlan:
        """Turn one WHERE conjunct containing a subquery into joins
        (IN -> left_semi, NOT IN -> left_anti, EXISTS likewise; scalar
        subqueries substitute an executed literal when uncorrelated, or
        a grouped-aggregate join when equi-correlated)."""
        negate = False
        e = c
        while isinstance(e, Not) and isinstance(e.children[0],
                                                (_InSubquery,
                                                 _ExistsSubquery)):
            negate = not negate
            e = e.children[0]

        if isinstance(e, _InSubquery):
            sub_plan = self.lower(e.select)
            sub_schema = sub_plan.schema()
            out_cols = sub_schema.names
            if len(out_cols) != 1:
                raise AnalysisError(
                    "IN (subquery) requires exactly one output column")
            how = "left_anti" if negate else "left_semi"
            probe = scope.rewrite(e.children[0])
            # NOT IN lowers to the NULL-AWARE anti-join (SQL three-valued
            # logic: one NULL in the subquery output empties the result;
            # a NULL probe survives only an empty subquery) — round-3
            # ADVICE low; reference: the NAAJ path in JoinSelection
            return L.Join(plan, sub_plan, [probe],
                          [ColumnRef(out_cols[0])], how,
                          null_aware=negate)

        if isinstance(e, _ExistsSubquery):
            if any(_contains_agg(ie) for ie, _a in (e.select.items or [])):
                # `EXISTS (SELECT count(*) ...)` is ALWAYS true (the
                # aggregate yields one row); a semi-join would wrongly
                # drop non-matching outer rows
                raise AnalysisError(
                    "aggregates inside an EXISTS subquery are not "
                    "supported (the aggregate always yields one row)")
            local, pairs, residuals = self._split_correlation(
                e.select, scope)
            if not pairs:
                if residuals:
                    raise AnalysisError(
                        "EXISTS with only non-equi correlation is not "
                        "supported (at least one equi-correlated "
                        "conjunct is required)")
                raise AnalysisError(
                    "uncorrelated EXISTS is not supported (it is a "
                    "constant — filter host-side instead)")
            # project the correlation keys and lower the inner query
            # normally (its own scope resolves qualified/local names;
            # duplicates are harmless under a semi/anti join)
            self._sq_counter += 1
            sq = self._sq_counter
            key_items = [(ie, f"__sq{sq}_key{i}")
                         for i, (_oe, ie) in enumerate(pairs)]
            # non-equi correlated conjuncts become the join's residual:
            # inner leaf refs project as uniquely-aliased columns so the
            # pair-batch condition never hits a rename collision
            per_alias, all_inner = self._last_inner_universe
            res_items: List[Tuple[Expression, str]] = []

            def residualize(node: Expression) -> Expression:
                if isinstance(node, (_QualifiedRef, ColumnRef)) and \
                        _classify_side_multi(node, per_alias,
                                             all_inner) == "inner":
                    alias = f"__sq{sq}_res{len(res_items)}"
                    res_items.append((node, alias))
                    return ColumnRef(alias)
                if isinstance(node, (_QualifiedRef, ColumnRef)):
                    return scope.rewrite(node)
                return node.map_children(residualize)

            residual_cond = None
            if residuals:
                residual_cond = _and_all([residualize(c)
                                          for c in residuals])
            inner_sel = _Select(items=list(key_items) + res_items,
                                relations=list(e.select.relations),
                                joins=list(e.select.joins or []),
                                where=_and_all(local))
            inner = self.lower(inner_sel)
            how = "left_anti" if negate else "left_semi"
            return L.Join(plan, inner, [p[0] for p in pairs],
                          [ColumnRef(nm) for _ie, nm in key_items], how,
                          condition=residual_cond)

        # comparison (or expression) containing scalar subqueries
        return self._rewrite_scalar_in_conjunct(plan, c, scope)

    def _subquery_is_correlated(self, sub: _Select) -> bool:
        if not sub.relations:
            return False
        try:
            per_alias = self._inner_universe(sub)
        except AnalysisError:
            return False  # FROM-subquery inners: treated uncorrelated
        all_inner = set().union(*per_alias.values()) if per_alias else set()
        return any(
            _classify_side_multi(cc, per_alias, all_inner)
            in ("outer", "mixed")
            for cc in _conjuncts(sub.where))

    def _rewrite_scalar_in_conjunct(self, plan, c: Expression,
                                    scope: _Scope) -> L.LogicalPlan:
        def rewrite(e: Expression) -> Expression:
            nonlocal plan
            if isinstance(e, _ScalarSubquery):
                sub = e.select
                if not self._subquery_is_correlated(sub):
                    return L.ScalarSubqueryExpr(self.lower(sub))
                # correlated scalar aggregate -> grouped aggregate joined
                # on the correlation keys (RewriteCorrelatedScalarSubquery)
                local, pairs, residuals = self._split_correlation(
                    sub, scope)
                if residuals:
                    raise AnalysisError(
                        "correlated scalar subqueries support "
                        "equi-correlation only")
                if len(sub.items or []) != 1:
                    raise AnalysisError(
                        "correlated scalar subquery needs exactly one "
                        "select item")
                # session-unique generated names: two correlated
                # subqueries in one query must not collide (the join
                # would rename the second to __sq_valN_r while the
                # filter still referenced __sq_valN)
                self._sq_counter += 1
                sq = self._sq_counter
                key_items = [(ie, f"__sq{sq}_key{i}")
                             for i, (_oe, ie) in enumerate(pairs)]
                val_name = f"__sq{sq}_val"
                inner_sel = _Select(
                    items=[(ie, nm) for ie, nm in key_items]
                    + [(sub.items[0][0], val_name)],
                    relations=list(sub.relations),
                    joins=list(sub.joins or []),
                    where=_and_all(local),
                    group_by=[ie for ie, _nm in key_items])
                sub_plan = self.lower(inner_sel)
                # LEFT join: outer rows without a matching group keep a
                # NULL subquery value (SQL semantics; an inner join
                # would wrongly drop them under OR-combined predicates)
                plan = L.Join(plan, sub_plan,
                              [oe for oe, _ie in pairs],
                              [ColumnRef(nm) for _ie, nm in key_items],
                              "left")
                return ColumnRef(val_name)
            return e.map_children(rewrite)

        cond = scope.rewrite(rewrite(c))
        return L.Filter(plan, cond)

    def _lower_grouping_sets(self, sel: _Select) -> L.LogicalPlan:
        """ROLLUP/CUBE/GROUPING SETS: one aggregate per grouping set,
        missing keys re-projected as typed NULLs, UNION ALL of the lot
        (the reference's Expand + single-aggregate plan produces the
        same relation — `ExpandExec.scala:1`; the union form trades one
        wide scan for set-count scans but keeps every aggregate on the
        fast grouped path)."""
        import copy as _c
        group_names = [g.name() for g in sel.group_by]
        if sel.items is None:
            raise AnalysisError(
                "grouping analytics need an explicit select list")
        out_names = []
        for e, a in sel.items:
            if a:
                out_names.append(a)
            elif isinstance(e, _QualifiedRef):
                out_names.append(e.col)  # t1.a projects as "a"
            else:
                out_names.append(e.name() if hasattr(e, "name")
                                 else repr(e))
        # input schema for typed NULL placeholders
        probe = _c.copy(sel)
        probe.ctes = None
        from_plan, _, _ = self._lower_from(probe)
        from_schema = from_plan.schema()

        plans = []
        for gset in sel.grouping_sets:
            sub = _c.copy(sel)
            sub.grouping_sets = None
            sub.ctes = None
            sub.order_by = None
            sub.limit = None
            sub.group_by = [ColumnRef(n) for n in gset] or None
            kept = []   # (expr, alias) | ("__null__", source_col_name)
            gset_bare = {n.split(".")[-1].lower() for n in gset}
            for e, a in sel.items:
                # match plain AND table-qualified refs on the bare name
                if isinstance(e, ColumnRef):
                    bare = e._name.split(".")[-1].lower()
                elif isinstance(e, _QualifiedRef):
                    bare = e.col.lower()
                else:
                    bare = None
                hit = bare is not None and any(
                    g.split(".")[-1].lower() == bare
                    for g in group_names)
                if hit and bare not in gset_bare:
                    kept.append(("__null__", bare))
                else:
                    kept.append((e, a))
            sub.items = [k for k in kept
                         if not isinstance(k[0], str)]
            p = self.lower(sub)
            sub_names = p.schema().names
            exprs = []
            pos = 0
            for k, out_name in zip(kept, out_names):
                if isinstance(k[0], str):  # "__null__" marker
                    dt = ColumnRef(k[1]).dtype(from_schema)
                    exprs.append(Alias(Literal(None, dt), out_name))
                else:
                    exprs.append(Alias(ColumnRef(sub_names[pos]),
                                       out_name))
                    pos += 1
            plans.append(L.Project(p, exprs))
        plan = plans[0]
        for q in plans[1:]:
            plan = L.Union(plan, q)
        plan = self._lower_order_limit(sel, plan)
        if sel.limit is not None:
            plan = L.Limit(plan, sel.limit)
        return plan

    def _extract_window_items(self, plan: L.LogicalPlan, items):
        """Pull WindowExpr nodes into Window plan nodes below the
        projection (shared with the DataFrame layer: one node — one
        sort — per distinct spec; collision-safe names)."""
        from ..window import extract_window_exprs
        from ..expr_array import contains_explode, extract_generators
        exprs = [Alias(e, a) if a else e for e, a in items]
        plan, out = extract_window_exprs(plan, exprs)
        if any(contains_explode(e) for e in out):
            plan, out = extract_generators(plan, out)
        rebuilt = []
        for (orig_e, a), new_e in zip(items, out):
            if a and isinstance(new_e, Alias):
                rebuilt.append((new_e.child, a))
            else:
                rebuilt.append((new_e, a))
        return plan, rebuilt

    def _lower_order_limit(self, sel: _Select, plan: L.LogicalPlan,
                           key_rewrite=None) -> L.LogicalPlan:
        if not sel.order_by:
            return plan
        out_names = plan.schema().names
        orders = []
        for e, asc, nulls_first in sel.order_by:
            if isinstance(e, Literal) and isinstance(e.value, int):
                idx = e.value - 1
                if not (0 <= idx < len(out_names)):
                    raise AnalysisError(f"ORDER BY position {e.value} out "
                                        f"of range")
                e = ColumnRef(out_names[idx])
            if _contains_agg(e):
                raise AnalysisError("ORDER BY aggregate expressions must "
                                    "use their select alias")
            if key_rewrite is not None:
                e = key_rewrite(e)
            orders.append(SortOrder(e, ascending=asc,
                                    nulls_first=nulls_first))
        return L.Sort(plan, orders)


def parse_sql(query: str, session) -> L.LogicalPlan:
    """Parse one statement into a logical plan bound to the session
    catalog (the `SparkSession.sql:613` entry point). DDL/DML commands
    (CREATE/DROP/INSERT/SHOW/DESCRIBE) run eagerly at parse time — the
    reference's RunnableCommand contract — and lower to a scan over
    their small result relation."""
    p = Parser(query, session)
    t = p.peek()
    if t.kind == "ident" and t.upper in ("CREATE", "DROP", "INSERT",
                                         "SHOW", "DESCRIBE", "DESC"):
        from .ddl import execute_command
        from ..io.sources import ArrowTableSource
        table = execute_command(p, session)
        return L.Scan(ArrowTableSource("__command__", table))
    sel = p.parse_statement()
    return Lowerer(session).lower(sel)
