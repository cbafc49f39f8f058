"""The recommendation zoo: ``NeuralCF``, ``WideAndDeep``, the
``Recommender`` surface and the NCF ranking protocol.  ``movielens`` holds
the MovieLens-1M pipeline."""

from analytics_zoo_tpu_torch.models.recommendation.neuralcf import NeuralCF
from analytics_zoo_tpu_torch.models.recommendation.recommender import (
    Recommender, UserItemFeature, UserItemPrediction, evaluate_ranking,
    generate_negative_samples, hit_ratio, ndcg)
from analytics_zoo_tpu_torch.models.recommendation.wide_and_deep import (
    ColumnFeatureInfo, WideAndDeep)


class SessionRecommender:
    """Not ported yet: it needs the GRU of ``nn/layers/recurrent.py``
    (ROADMAP queue 1, item 4)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SessionRecommender needs the GRU of nn/layers/recurrent.py, "
            "not ported yet: ROADMAP queue 1, item 4")
