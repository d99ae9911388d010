"""DDL / DML commands: CREATE TABLE [AS SELECT], INSERT INTO, DROP
TABLE, SHOW TABLES, DESCRIBE.

Reference: the eager command layer in
`sql/core/.../execution/command/tables.scala:1` (+ `AstBuilder`'s DDL
rules). Commands run at parse time — the reference's RunnableCommand
contract — and return a small Arrow result table the session wraps as a
DataFrame, so ``spark.sql("SHOW TABLES").to_pandas()`` works the same
way it does there. The port of `spark_tpu/sql/ddl.py`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import pyarrow as pa

from ..expr import AnalysisError, Literal
from . import parser as _p


_TYPES = {
    "BIGINT": pa.int64(), "LONG": pa.int64(),
    "INT": pa.int32(), "INTEGER": pa.int32(),
    "SMALLINT": pa.int32(), "TINYINT": pa.int32(),
    "DOUBLE": pa.float64(), "FLOAT": pa.float32(), "REAL": pa.float32(),
    "STRING": pa.string(), "VARCHAR": pa.string(), "CHAR": pa.string(),
    "TEXT": pa.string(),
    "BOOLEAN": pa.bool_(), "BOOL": pa.bool_(),
    "DATE": pa.date32(), "TIMESTAMP": pa.timestamp("us"),
}


def _parse_type(p: "_p.Parser") -> pa.DataType:
    t = p.next()
    name = t.upper if t.kind == "ident" else None
    if name in ("DECIMAL", "NUMERIC"):
        prec, scale = 10, 0
        if p.eat_op("("):
            prec = int(p.next().value)
            if p.eat_op(","):
                scale = int(p.next().value)
            p.expect_op(")")
        return pa.decimal128(prec, scale)
    if name in ("VARCHAR", "CHAR"):
        if p.eat_op("("):
            p.next()
            p.expect_op(")")
        return pa.string()
    if name in _TYPES:
        return _TYPES[name]
    raise _p.ParseError(f"unknown column type {t.value!r}")


def _run_query(p: "_p.Parser", session) -> pa.Table:
    sel = p.parse_statement()
    plan = _p.Lowerer(session).lower(sel)
    from ..execution.executor import QueryExecution
    return QueryExecution(session, plan).collect()


def _literal_value(e):
    from ..expr import Neg
    if isinstance(e, Literal):
        return e.value
    if isinstance(e, Neg) and isinstance(e.children[0], Literal):
        return -e.children[0].value
    raise _p.ParseError("INSERT ... VALUES requires literal values")


def _parse_values(p: "_p.Parser", session) -> pa.Table:
    rows: List[Tuple] = []
    while True:
        p.expect_op("(")
        row = []
        while True:
            e = p.parse_expr()
            row.append(_literal_value(e))
            if not p.eat_op(","):
                break
        p.expect_op(")")
        rows.append(tuple(row))
        if not p.eat_op(","):
            break
    width = len(rows[0])
    if any(len(r) != width for r in rows):
        raise _p.ParseError("VALUES rows differ in arity")
    cols = [pa.array([r[i] for r in rows]) for i in range(width)]
    return pa.table(cols, names=[f"col{i}" for i in range(width)])


def _ok(**cols) -> pa.Table:
    if not cols:
        return pa.table({"result": pa.array([], type=pa.string())})
    return pa.table({k: pa.array(v) for k, v in cols.items()})


def execute_command(p: "_p.Parser", session) -> pa.Table:
    """Parse + eagerly run one command statement; returns its result
    relation (RunnableCommand.run analog)."""
    cat = session.catalog
    if p.eat_kw("SHOW"):
        p.expect_kw("TABLES")
        p.eat_op(";")
        rows = cat.list_tables()
        return _ok(tableName=[r["name"] for r in rows],
                   isTemporary=[r["isTemporary"] for r in rows])

    if p.eat_kw("DESCRIBE") or p.eat_kw("DESC"):
        p.eat_kw("TABLE")
        name = p._ident()
        p.eat_op(";")
        rows = cat.describe(name)
        return _ok(col_name=[r["col_name"] for r in rows],
                   data_type=[r["data_type"] for r in rows],
                   nullable=[r["nullable"] for r in rows])

    if p.eat_kw("DROP"):
        is_view = p.eat_kw("VIEW")
        if not is_view:
            p.expect_kw("TABLE")
        if_exists = False
        if p.eat_kw("IF"):
            p.expect_kw("EXISTS")
            if_exists = True
        name = p._ident()
        p.eat_op(";")
        cat.drop_table(name, if_exists=if_exists, temp_only=is_view)
        return _ok()

    if p.eat_kw("INSERT"):
        p.expect_kw("INTO")
        p.eat_kw("TABLE")
        name = p._ident()
        if p.eat_kw("VALUES"):
            data = _parse_values(p, session)
            p.eat_op(";")
        else:
            data = _run_query(p, session)
        cat.insert_into(name, data)
        return _ok(inserted=[data.num_rows])

    if p.eat_kw("CREATE"):
        or_replace = False
        if p.eat_kw("OR"):
            p.expect_kw("REPLACE")
            or_replace = True
        p.expect_kw("TABLE")
        if_not_exists = False
        if p.eat_kw("IF"):
            p.expect_kw("NOT")
            p.expect_kw("EXISTS")
            if_not_exists = True
        name = p._ident()
        schema: Optional[pa.Schema] = None
        if p.at_op("("):
            p.next()
            fields = []
            while True:
                col = p._ident()
                typ = _parse_type(p)
                fields.append(pa.field(col, typ))
                if not p.eat_op(","):
                    break
            p.expect_op(")")
            schema = pa.schema(fields)
        if p.eat_kw("USING"):
            fmt = p._ident()
            if fmt.lower() != "parquet":
                raise AnalysisError(
                    f"only USING parquet is supported, got {fmt!r}")
        data = None
        if p.at_kw("AS") or p.at_kw("SELECT") or p.at_kw("WITH"):
            p.eat_kw("AS")
            data = _run_query(p, session)
        else:
            p.eat_op(";")
        cat.create_table(name, schema=schema, data=data,
                         if_not_exists=if_not_exists,
                         or_replace=or_replace)
        return _ok()

    t = p.peek()
    raise _p.ParseError(f"unsupported command at {t.pos}: {t.value!r}")
