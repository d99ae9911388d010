"""Three SQL programs over the function library and the statistical
aggregates, with independent pandas/numpy/scipy answers to hold them to.

- F1, lineitem moments: a data-profiling query over TPC-H's fact table.
  Every aggregate is a sum (float64 power sums, counts), so with the
  (l_returnflag, l_linestatus) key it takes the dense group-by with
  float rows.
- F2, shipping percentiles: percentile and median (the positional
  path), first/last, bool_and/bool_or and date functions over one
  filtered year of lineitem, grouped by an expression.
- F3, customer strings: a TPC-DS customer listing through 13 scalar
  functions on strings, dates, math and bits after a join.

`QUERIES[name]` is the SQL text and `SUITE[name]` the benchmark whose
tables it reads ("tpch" or "tpcds"). `golden(name, path)` computes the
answer from the Parquet files at `path` with pandas (F1's variance
two-pass in float64, skewness and kurtosis by `scipy.stats` in Spark's
population and excess conventions, F2's percentiles by
`numpy.percentile` with linear interpolation) and returns it with a
frame of absolute tolerances for F1's moment columns; `compare` holds a
result to it.

F1's tolerances are derived from the data, per group: a float64 sum of
n terms in any order is off by at most about n*u times the sum of the
terms' magnitudes (u = 2^-53), and the power-sum formulas then cancel
terms of size E[x^2] (variance), sqrt(E[x^2]E[y^2]) (covariance),
E|x|^3 (third moment) and E[x^4] (fourth moment), so each column's
bound is MOMENT_SLACK * n * u times that scale, carried through the
division by var, sd^3 or var^2. Every other float column is held within
FLOAT_RTOL; ints, strings, dates and booleans exactly, NULLs included.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

QUERIES: Dict[str, str] = {
    "f1": """
SELECT l_returnflag, l_linestatus, count(*) AS n,
  stddev_samp(l_quantity) AS sd_qty, var_pop(l_extendedprice) AS var_price,
  stddev_pop(l_discount) AS sdp_disc, variance(l_tax) AS var_tax,
  corr(l_extendedprice, l_discount) AS corr_pd,
  covar_samp(l_quantity, l_extendedprice) AS cov_qp,
  covar_pop(l_discount, l_tax) AS covp_dt,
  skewness(l_extendedprice) AS skew_price, kurtosis(l_quantity) AS kurt_qty,
  count_if(l_receiptdate > l_commitdate) AS late
FROM lineitem GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
""",
    "f2": """
SELECT l_shipmode, quarter(l_shipdate) AS qtr,
  percentile(l_extendedprice, 0.9) AS p90_price, median(l_discount) AS med_disc,
  first(l_shipinstruct) AS first_instr, last(l_linenumber) AS last_line,
  bool_and(l_receiptdate >= l_shipdate) AS all_after, bool_or(l_tax = 0) AS any_untaxed,
  max(datediff(l_receiptdate, l_shipdate)) AS max_transit,
  min(months_between(l_receiptdate, l_commitdate)) AS min_months
FROM lineitem
WHERE l_shipdate >= DATE '1994-01-01' AND l_shipdate < add_months(DATE '1994-01-01', 12)
GROUP BY l_shipmode, quarter(l_shipdate)
ORDER BY l_shipmode, qtr
""",
    "f3": """
SELECT c_customer_id,
  initcap(lower(c_last_name)) AS last_name, lpad(c_first_name, 12, '*') AS first_name,
  regexp_replace(ca_street_name, '[0-9]+', '#') AS street,
  translate(ca_zip, '0123456789', 'abcdefghij') AS zip_code,
  instr(c_email_address, '@') AS at_pos,
  datediff(DATE '2003-01-02', make_date(c_birth_year, c_birth_month, c_birth_day)) AS age_days,
  trunc(make_date(c_birth_year, c_birth_month, c_birth_day), 'MM') AS birth_month,
  greatest(c_birth_month, c_birth_day) AS gmd, nullif(c_preferred_cust_flag, 'N') AS pref,
  round(pow(c_birth_month, 2) / 7, 2) AS r2, bit_count(c_birth_year) AS bits,
  shiftleft(c_birth_month, 4) AS shl
FROM customer JOIN customer_address ON c_current_addr_sk = ca_address_sk
WHERE startswith(c_email_address, 'c1') AND rlike(ca_city, '^[A-M]')
ORDER BY c_customer_id
""",
}

SUITE = {"f1": "tpch", "f2": "tpch", "f3": "tpcds"}

#: float columns outside F1's moments: relative tolerance
FLOAT_RTOL = 1e-12
#: F1: multiple of n*u*scale each moment column is held to (the sums
#: of the formula, each within n*u of its terms' magnitudes)
MOMENT_SLACK = 16.0
U = 2.0 ** -53


def _read(path: str, table: str, columns) -> pd.DataFrame:
    """Columns of one table, decimals as float64 (cast in Arrow, the
    correctly rounded quotient of the scaled integer)."""
    t = pq.read_table(os.path.join(path, f"{table}.parquet"),
                      columns=list(columns))
    cols = {}
    for name, col in zip(t.column_names, t.columns):
        if pa.types.is_decimal(col.type):
            col = pc.cast(col, pa.float64())
        cols[name] = col
    return pa.table(cols).to_pandas()


def moment_tolerance(kind: str, x, y=None) -> float:
    """Absolute bound on the error of one group's statistical aggregate
    computed from float64 power sums, for the group's contributing
    values `x` (and `y`): MOMENT_SLACK * n * u times the scale the
    formula cancels, carried through its division. `kind` is one of
    var_samp, var_pop, stddev_samp, stddev_pop, covar_samp, covar_pop,
    corr, skewness, kurtosis."""
    x = np.asarray(x, np.float64)
    n = len(x)
    nu = np.float64(MOMENT_SLACK * n * U)
    # numpy scalars: an empty or constant group divides by zero into an
    # infinite bound (its result is NULL) instead of raising
    second = np.mean(x * x) if n else np.float64(0.0)
    m2 = np.var(x) if n else np.float64(0.0)
    if kind in ("var_samp", "var_pop"):
        return nu * second
    if kind in ("stddev_samp", "stddev_pop"):
        ddof = 1 if kind == "stddev_samp" else 0
        var = np.var(x, ddof=ddof) if n > ddof else np.float64(0.0)
        return nu * second / (2 * np.sqrt(var)) if var > 0 \
            else np.sqrt(nu * second)
    if kind in ("covar_samp", "covar_pop", "corr"):
        y = np.asarray(y, np.float64)
        scale = nu * np.sqrt(second * np.mean(y * y))
        if kind != "corr":
            return scale
        vy = np.var(y)
        corr = np.abs(np.corrcoef(x, y)[0, 1]) if n > 1 else 0.0
        # cov / sqrt(vx vy): the covariance's bound over the scale, plus
        # the relative bounds of both variances
        return (scale / np.sqrt(m2 * vy) + corr * (
            nu * second / (2 * m2) + nu * np.mean(y * y) / (2 * vy)))
    centered = x - x.mean()
    if kind == "skewness":
        skew = np.mean(centered ** 3) / m2 ** 1.5
        return (nu * np.mean(np.abs(x) ** 3) / m2 ** 1.5
                + abs(skew) * 1.5 * nu * second / m2)
    if kind == "kurtosis":
        m4 = np.mean(centered ** 4)
        return (nu * np.mean(x ** 4) / m2 ** 2
                + m4 / m2 ** 2 * 2 * nu * second / m2)
    raise ValueError(f"unknown moment {kind!r}")


#: F1's moment columns: (kind, x column, y column)
F1_MOMENTS = {
    "sd_qty": ("stddev_samp", "l_quantity", None),
    "var_price": ("var_pop", "l_extendedprice", None),
    "sdp_disc": ("stddev_pop", "l_discount", None),
    "var_tax": ("var_samp", "l_tax", None),
    "corr_pd": ("corr", "l_extendedprice", "l_discount"),
    "cov_qp": ("covar_samp", "l_quantity", "l_extendedprice"),
    "covp_dt": ("covar_pop", "l_discount", "l_tax"),
    "skew_price": ("skewness", "l_extendedprice", None),
    "kurt_qty": ("kurtosis", "l_quantity", None),
}


def _moment_tolerances(g: pd.DataFrame) -> Dict[str, float]:
    """Absolute tolerances of F1's moment columns for one group."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return {name: moment_tolerance(
            kind, g[x].to_numpy(), None if y is None else g[y].to_numpy())
            for name, (kind, x, y) in F1_MOMENTS.items()}


def golden_f1(path: str) -> Tuple[pd.DataFrame, pd.DataFrame]:
    from scipy import stats
    li = _read(path, "lineitem", [
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
        "l_discount", "l_tax", "l_receiptdate", "l_commitdate"])
    rows, tols = [], []
    for (rf, ls), g in li.groupby(["l_returnflag", "l_linestatus"],
                                  sort=True):
        q, p = g["l_quantity"].to_numpy(), g["l_extendedprice"].to_numpy()
        d, t = g["l_discount"].to_numpy(), g["l_tax"].to_numpy()
        n = len(g)
        rows.append({
            "l_returnflag": rf, "l_linestatus": ls, "n": n,
            "sd_qty": np.std(q, ddof=1) if n > 1 else np.nan,
            "var_price": np.var(p),
            "sdp_disc": np.std(d),
            "var_tax": np.var(t, ddof=1) if n > 1 else np.nan,
            "corr_pd": np.corrcoef(p, d)[0, 1] if n > 1 else np.nan,
            "cov_qp": np.cov(q, p, ddof=1)[0, 1] if n > 1 else np.nan,
            "covp_dt": np.cov(d, t, ddof=0)[0, 1],
            "skew_price": stats.skew(p, bias=True),
            "kurt_qty": stats.kurtosis(q, fisher=True, bias=True),
            "late": int((g["l_receiptdate"] > g["l_commitdate"]).sum()),
        })
        tols.append(_moment_tolerances(g))
    return pd.DataFrame(rows), pd.DataFrame(tols)


def _months_between(end: pd.Series, start: pd.Series) -> np.ndarray:
    """Spark's months_between: whole months, plus the day difference
    over 31 unless both dates are month ends or share the day of month,
    rounded to 8 digits."""
    e, s = pd.to_datetime(end), pd.to_datetime(start)
    whole = ((e.dt.year - s.dt.year) * 12
             + (e.dt.month - s.dt.month)).to_numpy(np.float64)
    frac = (e.dt.day - s.dt.day).to_numpy(np.float64) / 31.0
    same = ((e.dt.is_month_end & s.dt.is_month_end)
            | (e.dt.day == s.dt.day)).to_numpy()
    out = np.where(same, whole, whole + frac)
    return np.round(out * 1e8) / 1e8


def golden_f2(path: str) -> Tuple[pd.DataFrame, None]:
    li = _read(path, "lineitem", [
        "l_shipmode", "l_shipdate", "l_receiptdate", "l_commitdate",
        "l_extendedprice", "l_discount", "l_shipinstruct", "l_linenumber",
        "l_tax"])
    ship = pd.to_datetime(li["l_shipdate"])
    keep = (ship >= "1994-01-01") & (ship < "1995-01-01")
    li = li[keep.to_numpy()].reset_index(drop=True)
    ship = pd.to_datetime(li["l_shipdate"])
    receipt = pd.to_datetime(li["l_receiptdate"])
    li["qtr"] = ((ship.dt.month - 1) // 3 + 1).astype(np.int32)
    li["transit"] = (receipt - ship).dt.days.astype(np.int32)
    li["months"] = _months_between(li["l_receiptdate"], li["l_commitdate"])
    li["after"] = (receipt >= ship).to_numpy()
    li["untaxed"] = (li["l_tax"] == 0).to_numpy()
    rows = []
    # file order within each group: first/last by row position
    for (mode, qtr), g in li.groupby(["l_shipmode", "qtr"], sort=True):
        rows.append({
            "l_shipmode": mode, "qtr": qtr,
            "p90_price": np.percentile(g["l_extendedprice"].to_numpy(), 90,
                                       method="linear"),
            "med_disc": np.percentile(g["l_discount"].to_numpy(), 50,
                                      method="linear"),
            "first_instr": g["l_shipinstruct"].iloc[0],
            "last_line": g["l_linenumber"].iloc[-1],
            "all_after": bool(g["after"].all()),
            "any_untaxed": bool(g["untaxed"].any()),
            "max_transit": int(g["transit"].max()),
            "min_months": float(g["months"].min()),
        })
    return pd.DataFrame(rows), None


def _initcap(s: str) -> str:
    return " ".join(w[:1].upper() + w[1:].lower() if w else w
                    for w in s.split(" "))


def golden_f3(path: str) -> Tuple[pd.DataFrame, None]:
    import re
    c = _read(path, "customer", [
        "c_customer_id", "c_last_name", "c_first_name", "c_email_address",
        "c_birth_year", "c_birth_month", "c_birth_day",
        "c_preferred_cust_flag", "c_current_addr_sk"])
    a = _read(path, "customer_address", [
        "ca_address_sk", "ca_street_name", "ca_zip", "ca_city"])
    j = c.merge(a, left_on="c_current_addr_sk", right_on="ca_address_sk")
    city = re.compile("^[A-M]")
    keep = j["c_email_address"].str.startswith("c1") & \
        j["ca_city"].map(lambda s: city.search(s) is not None)
    j = j[keep.to_numpy()].sort_values("c_customer_id").reset_index(
        drop=True)
    birth = pd.to_datetime(pd.DataFrame({
        "year": j["c_birth_year"], "month": j["c_birth_month"],
        "day": j["c_birth_day"]}))
    zip_table = str.maketrans("0123456789", "abcdefghij")
    month = j["c_birth_month"].to_numpy(np.int64)
    scaled = month.astype(np.float64) ** 2 / 7 * 100
    out = pd.DataFrame({
        "c_customer_id": j["c_customer_id"],
        "last_name": j["c_last_name"].map(lambda s: _initcap(s.lower())),
        "first_name": j["c_first_name"].map(
            lambda s: s[:12] if len(s) >= 12
            else ("*" * (12 - len(s))) + s),
        "street": j["ca_street_name"].map(
            lambda s: re.sub("[0-9]+", "#", s)),
        "zip_code": j["ca_zip"].map(lambda s: s.translate(zip_table)),
        "at_pos": j["c_email_address"].map(lambda s: s.find("@") + 1),
        "age_days": (pd.Timestamp("2003-01-02") - birth).dt.days,
        "birth_month": birth.dt.to_period("M").dt.start_time.dt.date,
        "gmd": np.maximum(month, j["c_birth_day"].to_numpy(np.int64)),
        "pref": j["c_preferred_cust_flag"].where(
            j["c_preferred_cust_flag"] != "N", None),
        "r2": np.sign(scaled) * np.floor(np.abs(scaled) + 0.5) / 100,
        "bits": [bin(int(y) & (2 ** 64 - 1)).count("1")
                 for y in j["c_birth_year"]],
        "shl": month << 4,
    })
    return out, None


GOLDEN = {"f1": golden_f1, "f2": golden_f2, "f3": golden_f3}


def golden(name: str, path: str):
    """(answer, F1's moment tolerances or None) from the Parquet files."""
    return GOLDEN[name](path)


def _plain(values: pd.Series):
    """A column's values in comparable Python form."""
    out = []
    for v in values:
        if v is None or (isinstance(v, float) and np.isnan(v)):
            out.append(None)
        elif hasattr(v, "item"):
            out.append(v.item())
        else:
            out.append(v)
    return out


def compare(got: pa.Table, want: pd.DataFrame,
            tolerances: Optional[pd.DataFrame] = None,
            what: str = "result", want_valid=None) -> None:
    """Hold `got` to the golden: same columns and rows; float columns
    within the column's absolute tolerance in `tolerances` where it has
    one, else FLOAT_RTOL, NaN equal to NaN; everything else equal, NULLs
    included. A golden's NaN is its NULL unless `want_valid` gives the
    float columns' validity. Raises AssertionError naming the first
    column that differs."""
    if got.column_names != list(want.columns) or \
            got.num_rows != len(want):
        raise AssertionError(
            f"{what}: columns {got.column_names} with {got.num_rows} rows, "
            f"expected {list(want.columns)} with {len(want)}")
    for name in want.columns:
        col = got.column(name)
        if pa.types.is_floating(col.type):
            g = col.to_numpy(zero_copy_only=False).astype(np.float64)
            w = want[name].to_numpy(dtype=np.float64, na_value=np.nan)
            valid = col.is_valid().to_numpy(zero_copy_only=False)
            wv = ~np.isnan(w) if want_valid is None else want_valid[name]
            if not np.array_equal(valid, wv):
                raise AssertionError(f"{what}: column {name}'s NULLs differ")
            g, w = g[valid], w[valid]
            if tolerances is not None and name in tolerances:
                tol = tolerances[name].to_numpy(np.float64)[valid]
                # NaN where the golden is NaN; elsewhere a finite bound
                bad = np.isnan(g) != np.isnan(w)
                num = ~np.isnan(w)
                if not np.isfinite(tol[num]).all():
                    raise AssertionError(
                        f"{what}: column {name} has no finite bound")
                bad[num] |= np.abs(g[num] - w[num]) > tol[num]
            else:
                bad = ~np.isclose(g, w, rtol=FLOAT_RTOL, atol=0.0,
                                  equal_nan=True)
            if bad.any():
                i = int(np.flatnonzero(bad)[0])
                raise AssertionError(
                    f"{what}: column {name} differs in {int(bad.sum())} "
                    f"rows, first {g[i]!r} against {w[i]!r}")
        elif _plain(col.to_pandas()) != _plain(want[name]):
            raise AssertionError(f"{what}: column {name} differs")


def compare_tables(got: pa.Table, want: pa.Table,
                   tolerances: Optional[pd.DataFrame] = None,
                   what: str = "result") -> None:
    """Hold one engine result to another (the kernel's against the plain
    path's): `compare` with `want` as a frame, its NULLs from Arrow."""
    valid = {name: col.is_valid().to_numpy(zero_copy_only=False)
             for name, col in zip(want.column_names, want.columns)}
    compare(got, want.to_pandas(), tolerances, what, valid)
