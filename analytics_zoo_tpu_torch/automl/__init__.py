"""AutoML for time series, as the JAX package's ``automl/__init__.py``
exports it: search spaces and engines, the feature transformer, the
recipes, ``TimeSequencePredictor`` / ``TimeSequencePipeline`` and the
population trainer."""

from analytics_zoo_tpu_torch.automl.feature import (  # noqa: F401
    ALL_DT_FEATURES, TimeSequenceFeatureTransformer)
from analytics_zoo_tpu_torch.automl.population import \
    PopulationTrainer  # noqa: F401
from analytics_zoo_tpu_torch.automl.regression import (  # noqa: F401
    BayesRecipe, GridRandomRecipe, LSTMGridRandomRecipe, MTNetGridRandomRecipe,
    MTNetSmokeRecipe, RandomRecipe, Recipe, SmokeRecipe, TimeSequencePipeline,
    TimeSequencePredictor)
from analytics_zoo_tpu_torch.automl.search import (  # noqa: F401
    BayesSearchEngine, Choice, GridRandomSearchEngine, GridSearch,
    GridSearchEngine, LogUniform, QUniform, RandInt, RandomSearchEngine,
    SampleFn, SearchEngine, Uniform)

__all__ = [
    "ALL_DT_FEATURES", "TimeSequenceFeatureTransformer", "PopulationTrainer",
    "Recipe", "SmokeRecipe", "MTNetSmokeRecipe", "RandomRecipe", "BayesRecipe",
    "GridRandomRecipe", "LSTMGridRandomRecipe", "MTNetGridRandomRecipe",
    "TimeSequencePredictor", "TimeSequencePipeline",
    "SearchEngine", "RandomSearchEngine", "GridSearchEngine",
    "GridRandomSearchEngine", "BayesSearchEngine",
    "Uniform", "LogUniform", "RandInt", "QUniform", "Choice", "GridSearch",
    "SampleFn",
]
