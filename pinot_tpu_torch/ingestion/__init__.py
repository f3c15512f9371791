"""Ingestion: record transformer pipeline + batch ingestion jobs.

Reference parity: pinot-segment-local/.../recordtransformer/ (the
CompositeTransformer row pipeline applied before indexing) and
pinot-spi/.../ingestion/batch/ + pinot-plugins/pinot-batch-ingestion/
(job spec + standalone runner building and pushing segments).
"""
from .batch import BatchIngestionJob, run_batch_ingestion  # noqa: F401
from .transformers import (ComplexTypeTransformer,  # noqa: F401
                           CompositeTransformer, DataTypeTransformer,
                           ExpressionTransformer, FilterTransformer,
                           SanitizationTransformer)
