"""The parallel generator: the same tables for a seed whatever the
number of workers, only the columns asked for, and consistent keys."""

import numpy as np
import pyarrow as pa

import datagen

ALL = {t: datagen.SCHEMA[t] for t in ("region", "nation", "customer",
                                       "supplier", "orders", "lineitem")}
BIG_SEED = 2**31 + 987_654_321


def test_same_tables_for_any_worker_count():
    one = datagen.generate(0.004, BIG_SEED, ALL, workers=1)
    two = datagen.generate(0.004, BIG_SEED, ALL, workers=2)
    assert set(one) == set(two) == set(ALL)
    for name in ALL:
        assert one[name].equals(two[name]), name
    assert one["lineitem"].num_rows > 4 * one["orders"].num_rows * 0.8


def test_seed_changes_the_data_and_columns_are_independent():
    a = datagen.generate(0.002, 1, {"lineitem": ["l_quantity",
                                                 "l_shipdate"]}, 1)
    b = datagen.generate(0.002, 2, {"lineitem": ["l_quantity"]}, 1)
    c = datagen.generate(0.002, 1, {"lineitem": ["l_quantity"]}, 1)
    assert a["lineitem"].column_names == ["l_quantity", "l_shipdate"]
    assert not a["lineitem"]["l_quantity"].equals(b["lineitem"]["l_quantity"])
    assert a["lineitem"]["l_quantity"].equals(c["lineitem"]["l_quantity"])


def test_lines_follow_their_orders():
    t = datagen.generate(0.004, 7, {
        "orders": ["o_orderkey", "o_orderdate"],
        "lineitem": ["l_orderkey", "l_shipdate", "l_commitdate",
                     "l_receiptdate", "l_linenumber"]}, workers=2)
    o, li = t["orders"], t["lineitem"]
    okey = o["o_orderkey"].to_numpy()
    assert np.array_equal(okey, np.arange(1, len(okey) + 1))
    lkey = li["l_orderkey"].to_numpy()
    odate = o["o_orderdate"].cast(pa.int32()).to_numpy()[lkey - 1]
    ship = li["l_shipdate"].cast(pa.int32()).to_numpy()
    receipt = li["l_receiptdate"].cast(pa.int32()).to_numpy()
    assert ((ship - odate >= 1) & (ship - odate <= 121)).all()
    assert ((receipt - ship >= 1) & (receipt - ship <= 30)).all()
    lines = li["l_linenumber"].to_numpy()
    assert lines.min() == 1 and lines.max() <= 7
    assert set(np.unique(lkey)) <= set(okey)
