from hnsw_tpu_torch.models.bruteforce import BruteforceIndex
from hnsw_tpu_torch.models.hnsw import HNSWIndex, SearchParams
from hnsw_tpu_torch.models.multivector import MultiVectorIndex, epsilon_search

__all__ = [
    "BruteforceIndex",
    "HNSWIndex",
    "SearchParams",
    "MultiVectorIndex",
    "epsilon_search",
]
