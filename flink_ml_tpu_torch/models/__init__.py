"""Estimators and models of the algorithm library.

``STAGE_REGISTRY`` maps the public name of each ported stage to its dotted
class path, as ``flink_ml_tpu/models/__init__.py``'s does for the JAX
package; its keys are the ported subset of the JAX registry's.
"""
import importlib

STAGE_REGISTRY = {
    # classification
    "LogisticRegression": "flink_ml_tpu_torch.models.classification.logistic_regression.LogisticRegression",
    "LogisticRegressionModel": "flink_ml_tpu_torch.models.classification.logistic_regression.LogisticRegressionModel",
    "LinearSVC": "flink_ml_tpu_torch.models.classification.linearsvc.LinearSVC",
    "LinearSVCModel": "flink_ml_tpu_torch.models.classification.linearsvc.LinearSVCModel",
    "MLPClassifier": "flink_ml_tpu_torch.models.classification.mlp_classifier.MLPClassifier",
    "MLPClassifierModel": "flink_ml_tpu_torch.models.classification.mlp_classifier.MLPClassifierModel",
    "OnlineLogisticRegression":
        "flink_ml_tpu_torch.models.classification.online_logistic_regression.OnlineLogisticRegression",
    "OnlineLogisticRegressionModel":
        "flink_ml_tpu_torch.models.classification.online_logistic_regression.OnlineLogisticRegressionModel",
    "SelfAttentionClassifier": "flink_ml_tpu_torch.models.classification.attention_classifier.SelfAttentionClassifier",
    "SelfAttentionClassifierModel":
        "flink_ml_tpu_torch.models.classification.attention_classifier.SelfAttentionClassifierModel",
    # clustering
    "KMeans": "flink_ml_tpu_torch.models.clustering.kmeans.KMeans",
    "KMeansModel": "flink_ml_tpu_torch.models.clustering.kmeans.KMeansModel",
    "OnlineKMeans": "flink_ml_tpu_torch.models.clustering.online_kmeans.OnlineKMeans",
    "OnlineKMeansModel": "flink_ml_tpu_torch.models.clustering.online_kmeans.OnlineKMeansModel",
    # feature (stateless)
    "Binarizer": "flink_ml_tpu_torch.models.feature.binarizer.Binarizer",
    "ElementwiseProduct": "flink_ml_tpu_torch.models.feature.elementwise_product.ElementwiseProduct",
    "FeatureHasher": "flink_ml_tpu_torch.models.feature.feature_hasher.FeatureHasher",
    "HashingTF": "flink_ml_tpu_torch.models.feature.hashing_tf.HashingTF",
    "NGram": "flink_ml_tpu_torch.models.feature.ngram.NGram",
    "Normalizer": "flink_ml_tpu_torch.models.feature.normalizer.Normalizer",
    "RegexTokenizer": "flink_ml_tpu_torch.models.feature.tokenizer.RegexTokenizer",
    "StopWordsRemover": "flink_ml_tpu_torch.models.feature.stop_words_remover.StopWordsRemover",
    "Tokenizer": "flink_ml_tpu_torch.models.feature.tokenizer.Tokenizer",
    # feature (fitted)
    "CountVectorizer": "flink_ml_tpu_torch.models.feature.count_vectorizer.CountVectorizer",
    "CountVectorizerModel": "flink_ml_tpu_torch.models.feature.count_vectorizer.CountVectorizerModel",
    "IDF": "flink_ml_tpu_torch.models.feature.idf.IDF",
    "IDFModel": "flink_ml_tpu_torch.models.feature.idf.IDFModel",
    "Imputer": "flink_ml_tpu_torch.models.feature.imputer.Imputer",
    "ImputerModel": "flink_ml_tpu_torch.models.feature.imputer.ImputerModel",
    "StandardScaler": "flink_ml_tpu_torch.models.feature.standard_scaler.StandardScaler",
    "StandardScalerModel": "flink_ml_tpu_torch.models.feature.standard_scaler.StandardScalerModel",
    "OnlineStandardScaler": "flink_ml_tpu_torch.models.feature.standard_scaler.OnlineStandardScaler",
    "OnlineStandardScalerModel": "flink_ml_tpu_torch.models.feature.standard_scaler.OnlineStandardScalerModel",
    # regression
    "LinearRegression": "flink_ml_tpu_torch.models.regression.linear_regression.LinearRegression",
    "LinearRegressionModel": "flink_ml_tpu_torch.models.regression.linear_regression.LinearRegressionModel",
}


def get_stage_class(name: str):
    """The port class registered under ``name``."""
    dotted = STAGE_REGISTRY[name]
    module_name, _, cls_name = dotted.rpartition(".")
    return getattr(importlib.import_module(module_name), cls_name)
