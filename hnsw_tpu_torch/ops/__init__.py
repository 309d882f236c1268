from hnsw_tpu_torch.ops.distance import (
    gather_dist,
    gather_ip_dist,
    gather_l2_sq,
    pairwise_dist,
    pairwise_ip_dist,
    pairwise_l2_sq,
)
from hnsw_tpu_torch.ops.topk import bruteforce_topk, merge_sorted_topk, topk_smallest

__all__ = [
    "pairwise_l2_sq",
    "pairwise_ip_dist",
    "pairwise_dist",
    "gather_l2_sq",
    "gather_ip_dist",
    "gather_dist",
    "topk_smallest",
    "merge_sorted_topk",
    "bruteforce_topk",
]
