"""DataFrame and schema types."""
from flink_ml_tpu_torch.api.dataframe import DataFrame, Row
from flink_ml_tpu_torch.api.types import BasicType, DataType, DataTypes, MatrixType, ScalarType, VectorType

__all__ = ["DataFrame", "Row", "BasicType", "DataType", "DataTypes", "MatrixType", "ScalarType", "VectorType"]
