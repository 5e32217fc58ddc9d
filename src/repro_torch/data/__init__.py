"""Deterministic input pipelines, as ``repro.data``: ``TokenPipeline``
(the LM trainer's batches)."""

from .pipeline import TokenPipeline  # noqa: F401
