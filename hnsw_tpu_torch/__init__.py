"""hnsw_tpu_torch — the PyTorch/CUDA port of hnsw_tpu for NVIDIA Hopper.

The JAX package ``hnsw_tpu`` stays the reference; this package imports
``torch`` and never ``jax``. It keeps the reference's module names:

- ``core``: spaces and padded-CSR graphs (host numpy, device tensors);
- ``native``: the reference's C++ builder and vector store, compiled by
  path and bound with ctypes, and its native service frontends
  (``build_binary``);
- ``io``: the reference's .npz checkpoint and .adj adjacency formats, and
  hnswlib's .bin index format;
- ``ops``: distances, top-k, the unified node-block tables of the bf16,
  int8 and int4 tiers and the split table with their hand-written CUDA
  kernels (``ops.gather_kernels``, sources in ``csrc/``), and the batched
  beam traversal;
- ``models``: the exact bruteforce oracle, HNSWIndex (with its row-delta
  device sync), the device-wave ``bulk_build``, and the stop-condition
  searches ``epsilon_search`` and ``MultiVectorIndex``;
- ``parallel``: the sharded index in one process
  (``parallel.sharding.ShardedHNSWIndex``, one HNSWIndex per shard);
- ``service``: the deployment's builder CLI, storage service and query
  service (``python -m hnsw_tpu_torch.service.<name>``);
- ``convert``: numpy-only conversion of the JAX package's state.
"""

from hnsw_tpu_torch.core.graph import HNSWGraph, graph_device_arrays
from hnsw_tpu_torch.core.spaces import (
    CosineSpace,
    IPSpace,
    L2Space,
    L2SpaceU8,
    Space,
    get_space,
)
from hnsw_tpu_torch.models.bruteforce import BruteforceIndex
from hnsw_tpu_torch.models.bulk_build import bulk_build
from hnsw_tpu_torch.models.hnsw import HNSWIndex, SearchParams
from hnsw_tpu_torch.models.multivector import MultiVectorIndex, epsilon_search

__all__ = [
    "HNSWGraph",
    "graph_device_arrays",
    "Space",
    "L2Space",
    "L2SpaceU8",
    "IPSpace",
    "CosineSpace",
    "get_space",
    "BruteforceIndex",
    "HNSWIndex",
    "SearchParams",
    "bulk_build",
    "MultiVectorIndex",
    "epsilon_search",
]
