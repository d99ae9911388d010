"""Pipeline abstractions (the port of `spark_tpu/ml/base.py`; reference:
`ml/Pipeline.scala:1`, `ml/param/params.scala` Params): Estimator.fit
-> Model, Transformer.transform, Pipeline = sequential fit/transform."""

from __future__ import annotations

import copy
from typing import Dict, List


class Params:
    """Declared-parameter holder (the reference's Params trait without
    the reflection): subclasses set defaults in __init__; get/set by
    name with copy-on-write semantics."""

    def _params(self) -> Dict[str, object]:
        return {k: v for k, v in vars(self).items()
                if not k.startswith("_")}

    def set(self, **kwargs) -> "Params":
        out = copy.copy(self)
        for k, v in kwargs.items():
            if not hasattr(out, k):
                raise ValueError(
                    f"{type(self).__name__} has no param {k!r}; "
                    f"known: {sorted(self._params())}")
            setattr(out, k, v)
        return out

    def explain_params(self) -> str:
        return "\n".join(f"{k}: {v!r}"
                         for k, v in sorted(self._params().items()))


class Transformer(Params):
    def transform(self, df):
        raise NotImplementedError

    def __call__(self, df):
        return self.transform(df)


class Estimator(Params):
    def fit(self, df) -> "Model":
        raise NotImplementedError


class Model(Transformer):
    pass


class Pipeline(Estimator):
    """fit: run stages in order — estimators fit on the running
    transformed frame and contribute their models; transformers pass
    through (Pipeline.scala:1 semantics)."""

    def __init__(self, stages: List[Params]):
        self.stages = list(stages)

    def fit(self, df) -> "PipelineModel":
        models: List[Transformer] = []
        cur = df
        for stage in self.stages:
            if isinstance(stage, Estimator):
                m = stage.fit(cur)
                models.append(m)
                cur = m.transform(cur)
            elif isinstance(stage, Transformer):
                models.append(stage)
                cur = stage.transform(cur)
            else:
                raise TypeError(f"not a pipeline stage: {stage!r}")
        return PipelineModel(models)


class PipelineModel(Model):
    def __init__(self, stages: List[Transformer]):
        self.stages = list(stages)

    def transform(self, df):
        cur = df
        for s in self.stages:
            cur = s.transform(cur)
        return cur
