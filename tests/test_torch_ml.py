"""`spark_tpu_torch.ml` against `spark_tpu.ml`: every case of
`tests/test_ml.py`, each run through both packages on the same seeded
numpy data (the port's session on the CPU device, the JAX package's on
its CPU backend), with the JAX test's assertions made on each and the
two packages' outputs held together: coefficients, weights, centres and
metrics within rtol 1e-10, k-means assignments exactly. Also: a
`LinearRegressionModel` saved by either package loads in the other.
"""

import types

import numpy as np
import pandas as pd
import pytest

import spark_tpu.ml as ref_ml
from spark_tpu.session import SparkTpuSession as RefSession

import spark_tpu_torch.ml as port_ml
from spark_tpu_torch import SparkTpuSession

RTOL = 1e-10

PORT = types.SimpleNamespace(
    name="port", ml=port_ml,
    session=lambda: SparkTpuSession.builder().device("cpu").get_or_create())
REF = types.SimpleNamespace(
    name="ref", ml=ref_ml,
    session=lambda: RefSession(register_active=False))


def _table(P, name, pdf):
    s = P.session()
    s.register_table(name, pdf)
    return s.table(name)


def _reg_pdf():
    rs = np.random.RandomState(7)
    n = 400
    x1 = rs.randn(n)
    x2 = rs.randn(n) * 2.0
    y = 3.0 * x1 - 1.5 * x2 + 0.75 + rs.randn(n) * 0.01
    return pd.DataFrame({"x1": x1, "x2": x2, "label": y})


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=0)


def test_linear_regression_parity_with_lstsq():
    pdf = _reg_pdf()
    A = np.column_stack([pdf[["x1", "x2"]].to_numpy(), np.ones(len(pdf))])
    want, *_ = np.linalg.lstsq(A, pdf["label"].to_numpy(), rcond=None)

    def case(P):
        df = _table(P, f"ml_reg_{P.name}", pdf)
        assembled = P.ml.VectorAssembler(["x1", "x2"], "features") \
            .transform(df)
        model = P.ml.LinearRegression().fit(assembled)
        assert np.allclose(model.coefficients, want[:2], atol=1e-8)
        assert np.isclose(model.intercept, want[2], atol=1e-8)
        scored = model.transform(assembled)
        rmse = P.ml.RegressionEvaluator().evaluate(scored)
        assert rmse < 0.02
        r2 = P.ml.RegressionEvaluator(metricName="r2").evaluate(scored)
        assert r2 > 0.999
        pred = scored.to_pandas()["prediction"].to_numpy()
        return model, rmse, r2, pred

    (pm, prmse, pr2, ppred), (rm, rrmse, rr2, rpred) = case(PORT), case(REF)
    _close(pm.coefficients, rm.coefficients)
    _close(pm.intercept, rm.intercept)
    _close([prmse, pr2], [rrmse, rr2])
    _close(ppred, rpred)


def test_pipeline_fit_transform():
    pdf = _reg_pdf()

    def case(P):
        df = _table(P, f"ml_pipe_{P.name}", pdf)
        pipe = P.ml.Pipeline([
            P.ml.VectorAssembler(["x1", "x2"], "raw"),
            P.ml.StandardScaler(inputCol="raw", outputCol="features"),
            P.ml.LinearRegression(),
        ])
        model = pipe.fit(df)
        out = model.transform(df)
        rmse = P.ml.RegressionEvaluator().evaluate(out)
        assert rmse < 0.02
        scaler, lr = model.stages[1], model.stages[2]
        return (scaler.mean, scaler.std, lr.coefficients, lr.intercept,
                rmse, out.to_pandas()["prediction"].to_numpy())

    for p, r in zip(case(PORT), case(REF)):
        _close(p, r)


def test_model_save_load(tmp_path):
    pdf = _reg_pdf()

    def case(P):
        df = _table(P, f"ml_save_{P.name}", pdf)
        assembled = P.ml.VectorAssembler(["x1", "x2"], "features") \
            .transform(df)
        model = P.ml.LinearRegression().fit(assembled)
        p = str(tmp_path / f"lr_{P.name}.npz")
        model.save(p)
        loaded = P.ml.LinearRegressionModel.load(p)
        assert np.allclose(loaded.coefficients, model.coefficients)
        assert loaded.intercept == model.intercept
        return loaded

    p, r = case(PORT), case(REF)
    _close(p.coefficients, r.coefficients)
    _close(p.intercept, r.intercept)


def test_saved_model_loads_in_the_other_package(tmp_path):
    """The port keeps the JAX package's `np.savez` format: a model saved
    by either package loads in the other with the same coefficients,
    intercept and column names, and scores the same rows the same."""
    pdf = _reg_pdf()
    fitted = {}
    for P in (PORT, REF):
        df = _table(P, f"ml_cross_{P.name}", pdf)
        assembled = P.ml.VectorAssembler(["x1", "x2"], "features") \
            .transform(df)
        model = P.ml.LinearRegression(predictionCol="yhat").fit(assembled)
        path = str(tmp_path / f"from_{P.name}.npz")
        model.save(path)
        fitted[P.name] = (model, path, assembled)
    for saver, loader in ((PORT, REF), (REF, PORT)):
        model, path, _ = fitted[saver.name]
        loaded = loader.ml.LinearRegressionModel.load(path)
        assert type(loaded) is loader.ml.LinearRegressionModel
        np.testing.assert_array_equal(loaded.coefficients,
                                      model.coefficients)
        assert loaded.intercept == model.intercept
        assert (loaded.featuresCol, loaded.predictionCol) == \
            ("features", "yhat")
        scored = loaded.transform(fitted[loader.name][2]).to_pandas()
        own = model.transform(fitted[saver.name][2]).to_pandas()
        _close(scored["yhat"].to_numpy(), own["yhat"].to_numpy())


def test_logistic_regression_separates():
    rs = np.random.RandomState(11)
    n = 600
    x = rs.randn(n, 2)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float64)
    pdf = pd.DataFrame({"a": x[:, 0], "b": x[:, 1], "label": y})

    def case(P):
        df = P.ml.VectorAssembler(["a", "b"], "features").transform(
            _table(P, f"ml_clf_{P.name}", pdf))
        model = P.ml.LogisticRegression(maxIter=300, stepSize=2.0).fit(df)
        scored = model.transform(df)
        out = scored.to_pandas()
        acc = (out["prediction"] == out["label"]).mean()
        assert acc > 0.97
        auc = P.ml.BinaryClassificationEvaluator().evaluate(scored)
        assert auc > 0.99
        return (model.coefficients, model.intercept, auc,
                out["probability"].to_numpy(),
                out["prediction"].to_numpy())

    (pw, pb, pauc, pp, ppred), (rw, rb, rauc, rp, rpred) = \
        case(PORT), case(REF)
    _close(pw, rw)
    _close(pb, rb)
    _close(pauc, rauc)
    _close(pp, rp)
    np.testing.assert_array_equal(ppred, rpred)


def test_kmeans_recovers_blobs():
    rs = np.random.RandomState(5)
    c1 = rs.randn(100, 2) * 0.2 + np.array([5.0, 5.0])
    c2 = rs.randn(100, 2) * 0.2 + np.array([-5.0, 5.0])
    c3 = rs.randn(100, 2) * 0.2 + np.array([0.0, -5.0])
    X = np.vstack([c1, c2, c3])
    pdf = pd.DataFrame({"a": X[:, 0], "b": X[:, 1],
                        "blob": np.repeat([0, 1, 2], 100)})

    def case(P):
        df = P.ml.VectorAssembler(["a", "b"], "features").transform(
            _table(P, f"ml_km_{P.name}", pdf))
        model = P.ml.KMeans(k=3, maxIter=25, seed=3).fit(df)
        out = model.transform(df).to_pandas()
        # every true blob maps to exactly one predicted cluster
        for b in range(3):
            preds = out[out["blob"] == b]["prediction"]
            assert preds.nunique() == 1
        assert out["prediction"].nunique() == 3
        centers = np.sort(np.round(model.cluster_centers), axis=0)
        assert centers.shape == (3, 2)
        return model.cluster_centers, out["prediction"].to_numpy()

    (pc, pa), (rc, ra) = case(PORT), case(REF)
    _close(pc, rc)
    np.testing.assert_array_equal(pa, ra)


def test_params_set_and_errors():
    for P in (PORT, REF):
        lr = P.ml.LinearRegression()
        lr2 = lr.set(regParam=0.5)
        assert lr2.regParam == 0.5 and lr.regParam == 0.0
        with pytest.raises(ValueError) as exc:
            lr.set(nope=1)
        assert "no param 'nope'" in str(exc.value)
    assert PORT.ml.LinearRegression().explain_params() == \
        REF.ml.LinearRegression().explain_params()
    assert PORT.ml.__all__ == REF.ml.__all__


def test_ridge_kmeans_empty_cluster_and_lloyd_against_numpy():
    """Cases the JAX test leaves out, through both packages: a ridge
    fit (regParam > 0, the intercept unregularized), and KMeans with
    more clusters than distinct points, so Lloyd meets empty clusters,
    which keep their centre; both held to a float64 numpy run of the
    same algorithm."""
    pdf = _reg_pdf()
    A = np.column_stack([pdf[["x1", "x2"]].to_numpy(), np.ones(len(pdf))])
    ridge = A.T @ A + 2.5 * np.diag([1.0, 1.0, 0.0])
    want = np.linalg.solve(ridge, A.T @ pdf["label"].to_numpy())
    dup = pd.DataFrame({"a": [0.0, 0.0, 1.0, 1.0, 1.0, 9.0],
                        "b": [0.0, 0.0, 1.0, 1.0, 1.0, 9.0]})
    got = {}
    for P in (PORT, REF):
        df = P.ml.VectorAssembler(["x1", "x2"], "features").transform(
            _table(P, f"ml_ridge_{P.name}", pdf))
        m = P.ml.LinearRegression(regParam=2.5).fit(df)
        _close(np.append(m.coefficients, m.intercept), want)
        kdf = P.ml.VectorAssembler(["a", "b"], "features").transform(
            _table(P, f"ml_dup_{P.name}", dup))
        km = P.ml.KMeans(k=4, maxIter=5, seed=0).fit(kdf)
        got[P.name] = (m, km.cluster_centers)
    _close(got["port"][1], got["ref"][1])
    # the farthest-point start holds a repeated point twice: the
    # cluster that loses it stays empty and keeps its centre
    assert len({tuple(c) for c in got["port"][1]}) == 3
