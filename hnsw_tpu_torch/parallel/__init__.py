"""Sharded search (counterpart of hnsw_tpu/parallel)."""
