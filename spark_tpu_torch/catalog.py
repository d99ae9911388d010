"""Session catalog: temp views + a persistent parquet warehouse (the
port of `spark_tpu/catalog.py`).

Reference: `sql/catalyst/.../catalog/SessionCatalog.scala:1` (temp-view
shadowing, lookup order) + `InMemoryCatalog` + the command layer in
`sql/core/.../execution/command/tables.scala:1`. The TPU-era inversion:
no Hive metastore process — table metadata is a JSON sidecar per table
directory under ``spark_tpu.sql.warehouse.dir`` and the data is plain
parquet parts, so a fresh session over the same warehouse dir sees every
table (the DDL round-trip the reference gets from the metastore).

Lookup order matches the reference: temp views shadow persistent tables.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, Iterator, List, Optional

import pyarrow as pa
import pyarrow.parquet as pq

from . import types as T
from .expr import AnalysisError

_META = "_spark_tpu_table.json"


def _type_name(dt: T.DataType) -> str:
    return repr(dt)


class Catalog:
    """Mapping-compatible with the former plain dict (``name in``,
    ``[name]``, ``.get``), plus the persistent-table command surface."""

    def __init__(self, session):
        self._session = session
        self._temp: Dict[str, object] = {}

    # -- mapping protocol (temp views shadow persistent tables) -------------

    def warehouse_dir(self) -> str:
        return str(self._session.conf.get("spark_tpu.sql.warehouse.dir"))

    def _table_dir(self, name: str) -> str:
        return os.path.join(self.warehouse_dir(), name.lower())

    def _is_persistent(self, name: str) -> bool:
        return os.path.isfile(os.path.join(self._table_dir(name), _META))

    def __contains__(self, name: str) -> bool:
        return name in self._temp or self._is_persistent(name)

    def __getitem__(self, name: str):
        if name in self._temp:
            return self._temp[name]
        if self._is_persistent(name):
            return self._persistent_source(name)
        raise KeyError(name)

    def get(self, name: str, default=None):
        try:
            return self[name]
        except KeyError:
            return default

    def __setitem__(self, name: str, source) -> None:
        self._temp[name] = source

    def __delitem__(self, name: str) -> None:
        del self._temp[name]

    def __iter__(self) -> Iterator[str]:
        seen = set(self._temp)
        yield from self._temp
        wh = self.warehouse_dir()
        if os.path.isdir(wh):
            for d in sorted(os.listdir(wh)):
                if d not in seen and self._is_persistent(d):
                    yield d

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def keys(self):
        return list(self)

    def _persistent_source(self, name: str):
        # a FRESH dataset each lookup: INSERT INTO appends part files,
        # and the stat-stamped cache_token keeps device caches honest
        from .io.sources import ParquetSource
        src = ParquetSource(self._table_dir(name), name)
        return src

    # -- metadata ------------------------------------------------------------

    def _read_meta(self, name: str) -> dict:
        with open(os.path.join(self._table_dir(name), _META)) as f:
            return json.load(f)

    def _write_meta(self, name: str, meta: dict) -> None:
        os.makedirs(self._table_dir(name), exist_ok=True)
        with open(os.path.join(self._table_dir(name), _META), "w") as f:
            json.dump(meta, f, indent=1)

    # -- commands (command/tables.scala analog) ------------------------------

    def create_table(self, name: str, schema: Optional[pa.Schema] = None,
                     data: Optional[pa.Table] = None,
                     if_not_exists: bool = False,
                     or_replace: bool = False) -> None:
        if name in self._temp:
            raise AnalysisError(
                f"temp view {name!r} already exists")
        if self._is_persistent(name):
            if if_not_exists:
                return
            if not or_replace:
                raise AnalysisError(f"table {name!r} already exists")
            self.drop_table(name)
        if data is not None:
            schema = data.schema
        if schema is None:
            raise AnalysisError("CREATE TABLE needs a schema or a query")
        self._write_meta(name, {
            "name": name,
            "created": time.time(),
            "format": "parquet",
            "schema": {f.name: str(f.type) for f in schema},
        })
        # always materialize one (possibly empty) part so the dataset
        # scanner knows the schema without reading the JSON
        part = data if data is not None else schema.empty_table()
        self._append_part(name, part)

    def _append_part(self, name: str, table: pa.Table) -> None:
        d = self._table_dir(name)
        os.makedirs(d, exist_ok=True)
        existing = [f for f in os.listdir(d) if f.endswith(".parquet")]
        pq.write_table(table,
                       os.path.join(d, f"part-{len(existing):05d}.parquet"))

    def insert_into(self, name: str, table: pa.Table) -> None:
        if not self._is_persistent(name):
            if name in self._temp:
                raise AnalysisError(
                    f"INSERT INTO a temp view {name!r} is not supported")
            raise AnalysisError(f"table {name!r} not found")
        target = self._persistent_source(name)._dataset.schema
        if len(table.schema) != len(target):
            raise AnalysisError(
                f"INSERT INTO {name}: {len(table.schema)} columns for "
                f"{len(target)} target columns")
        # position-based with implicit casts, like the reference's
        # by-position resolution for INSERT
        cols = [table.column(i).cast(target.field(i).type)
                for i in range(len(target))]
        self._append_part(name, pa.table(cols, names=target.names))

    def drop_table(self, name: str, if_exists: bool = False,
                   temp_only: bool = False) -> bool:
        if name in self._temp:
            del self._temp[name]
            return True
        if not temp_only and self._is_persistent(name):
            from .io.device_cache import CACHE
            src = self._persistent_source(name)
            token = src.cache_token()
            if token is not None:
                CACHE.invalidate_token(token)
            shutil.rmtree(self._table_dir(name))
            return True
        if not if_exists:
            raise AnalysisError(f"table {name!r} not found")
        return False

    def list_tables(self) -> List[dict]:
        out = []
        for name in self:
            out.append({"name": name,
                        "isTemporary": name in self._temp})
        return out

    def describe(self, name: str) -> List[dict]:
        if name not in self:
            raise AnalysisError(f"table {name!r} not found")
        src = self[name]
        return [{"col_name": f.name, "data_type": _type_name(f.dtype),
                 "nullable": f.nullable}
                for f in src.schema().fields]
