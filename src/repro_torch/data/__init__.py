"""Deterministic input pipelines, as ``repro.data``: ``TokenPipeline``
(the LM trainer's batches) and ``GraphBatchPipeline`` (the GNN trainer's
seed nodes)."""

from .pipeline import GraphBatchPipeline, TokenPipeline  # noqa: F401
