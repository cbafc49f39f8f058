"""The recommendation zoo: ``NeuralCF``, ``WideAndDeep``,
``SessionRecommender``, the ``Recommender`` surface and the NCF ranking
protocol.  ``movielens`` holds the MovieLens-1M pipeline."""

from analytics_zoo_tpu_torch.models.recommendation.neuralcf import NeuralCF
from analytics_zoo_tpu_torch.models.recommendation.recommender import (
    Recommender, UserItemFeature, UserItemPrediction, evaluate_ranking,
    generate_negative_samples, hit_ratio, ndcg)
from analytics_zoo_tpu_torch.models.recommendation.session_recommender \
    import SessionRecommender
from analytics_zoo_tpu_torch.models.recommendation.wide_and_deep import (
    ColumnFeatureInfo, WideAndDeep)

