"""SparkSession analog: catalog + conf + device + entry points (the port
of `spark_tpu/session.py`; reference: `SparkSession.scala:83`).

A session runs on one device: the current CUDA card unless the builder
asks for another (`SparkTpuSession.builder().device("cpu")`). Without a
device and without CUDA, building a session raises.

`sql(text)` parses and lowers one SELECT statement (`sql/parser.py`) to
the same logical plans the DataFrame API builds. A WITH-clause view is
marked for statement-scoped materialization (`mark_cache`): the first
query that reaches it computes it once, later references in the same
statement read the result, and the data is dropped when the outermost
execution ends. The user-facing `DataFrame.cache()` and a session data
cache that outlives a statement are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import pandas as pd
import pyarrow as pa

from .columnar import resolve_device
from .config import Conf
from .dataframe import DataFrame
from .io.sources import ArrowTableSource, ParquetSource, TableSource
from .plan import logical as L


class SparkTpuSession:
    def __init__(self, conf: Optional[Conf] = None, device=None):
        self.conf = conf or Conf()
        self.device = resolve_device(device)
        self.catalog: Dict[str, TableSource] = {}
        # statement-scoped materializations (WITH-clause views), keyed by
        # plan fingerprint: the marked plans, and the tables computed for
        # them in the current statement
        self._cache_requests: Dict[str, L.LogicalPlan] = {}
        self._data_cache: Dict[str, pa.Table] = {}
        # nesting depth of running executions (subqueries and
        # materializations run their own); the outermost one's end ends
        # the statement
        self._exec_depth = 0

    # -- statement-scoped materialization ---------------------------------

    @staticmethod
    def _plan_fingerprint(plan: L.LogicalPlan) -> str:
        """tree_string + each scan source's identity stamp: a Parquet
        rewrite or a re-registered table changes the fingerprint, so a
        materialization never matches stale data."""
        tokens = [s.source.cache_token() for s in L.iter_scans(plan)]
        return plan.tree_string() + f"#src{tokens!r}"

    def mark_cache(self, plan: L.LogicalPlan) -> None:
        """Materialize `plan` once per statement wherever a query reaches
        it (the executor's `_apply_cache`): the JAX package's
        `mark_cache(plan, implicit=True)`. A cache that outlives the
        statement is not ported yet."""
        self._cache_requests[self._plan_fingerprint(plan)] = plan

    # -- builder ------------------------------------------------------------

    class Builder:
        def __init__(self):
            self._conf = Conf()
            self._device = None

        def config(self, key: str, value) -> "SparkTpuSession.Builder":
            self._conf.set(key, value)
            return self

        def device(self, device) -> "SparkTpuSession.Builder":
            """'cuda', 'cuda:1', 'cpu' or a torch.device; default: the
            current CUDA card."""
            self._device = device
            return self

        def get_or_create(self) -> "SparkTpuSession":
            return SparkTpuSession(self._conf, self._device)

        getOrCreate = get_or_create

    @classmethod
    def builder(cls) -> "SparkTpuSession.Builder":
        return cls.Builder()

    # -- entry points -------------------------------------------------------

    def range(self, start: int, end: Optional[int] = None,
              step: int = 1) -> DataFrame:
        if end is None:
            start, end = 0, start
        return DataFrame(self, L.Range(int(start), int(end), int(step)))

    def create_dataframe(self, data, name: str = "df") -> DataFrame:
        if isinstance(data, pd.DataFrame):
            table = pa.Table.from_pandas(data, preserve_index=False)
        elif isinstance(data, pa.Table):
            table = data
        elif isinstance(data, dict):
            table = pa.table(data)
        else:
            raise TypeError(f"cannot create DataFrame from {type(data)}")
        return DataFrame(self, L.Scan(ArrowTableSource(name, table)))

    createDataFrame = create_dataframe

    def register_table(self, name: str, source_or_table) -> None:
        # marks over the replaced table can never match again (its
        # source stamp is gone): drop them
        for fp, plan in list(self._cache_requests.items()):
            if any(s.source.name == name for s in L.iter_scans(plan)):
                del self._cache_requests[fp]
                self._data_cache.pop(fp, None)
        if isinstance(source_or_table, TableSource):
            self.catalog[name] = source_or_table
        elif isinstance(source_or_table, pa.Table):
            self.catalog[name] = ArrowTableSource(name, source_or_table)
        elif isinstance(source_or_table, pd.DataFrame):
            self.catalog[name] = ArrowTableSource(
                name, pa.Table.from_pandas(source_or_table,
                                           preserve_index=False))
        elif isinstance(source_or_table, DataFrame):
            self.catalog[name] = ArrowTableSource(
                name, source_or_table.collect())
        else:
            raise TypeError(f"cannot register {type(source_or_table)}")

    def table(self, name: str) -> DataFrame:
        if name not in self.catalog:
            raise KeyError(f"table {name!r} not found; "
                           f"known: {sorted(self.catalog)}")
        return DataFrame(self, L.Scan(self.catalog[name]))

    def read_parquet(self, path: str, name: Optional[str] = None) -> DataFrame:
        return DataFrame(self, L.Scan(ParquetSource(path, name)))

    def sql(self, query: str) -> DataFrame:
        """Parse and lower one SQL statement against the catalog (the
        reference's `SparkSession.sql:613`)."""
        from .sql.parser import parse_sql
        return DataFrame(self, parse_sql(query, self))
