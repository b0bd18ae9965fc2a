"""Feature transformers of the algorithm library."""
from flink_ml_tpu_torch.models.feature.binarizer import Binarizer
from flink_ml_tpu_torch.models.feature.count_vectorizer import CountVectorizer, CountVectorizerModel
from flink_ml_tpu_torch.models.feature.elementwise_product import ElementwiseProduct
from flink_ml_tpu_torch.models.feature.feature_hasher import FeatureHasher
from flink_ml_tpu_torch.models.feature.hashing_tf import HashingTF
from flink_ml_tpu_torch.models.feature.idf import IDF, IDFModel
from flink_ml_tpu_torch.models.feature.imputer import Imputer, ImputerModel
from flink_ml_tpu_torch.models.feature.ngram import NGram
from flink_ml_tpu_torch.models.feature.normalizer import Normalizer
from flink_ml_tpu_torch.models.feature.standard_scaler import (
    OnlineStandardScaler,
    OnlineStandardScalerModel,
    StandardScaler,
    StandardScalerModel,
)
from flink_ml_tpu_torch.models.feature.stop_words_remover import StopWordsRemover
from flink_ml_tpu_torch.models.feature.tokenizer import RegexTokenizer, Tokenizer

__all__ = [
    "Binarizer",
    "CountVectorizer",
    "CountVectorizerModel",
    "ElementwiseProduct",
    "FeatureHasher",
    "HashingTF",
    "IDF",
    "IDFModel",
    "Imputer",
    "ImputerModel",
    "NGram",
    "Normalizer",
    "OnlineStandardScaler",
    "OnlineStandardScalerModel",
    "RegexTokenizer",
    "StandardScaler",
    "StandardScalerModel",
    "StopWordsRemover",
    "Tokenizer",
]
