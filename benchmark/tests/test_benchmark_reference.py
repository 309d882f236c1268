"""The yardstick on the CPU: the reference against a float64 numpy brute
force, the comparison's numbers on hand-made answers, and the roofline's
byte counts against a hand count."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import compare, reference, roofline


def _numpy_knn(x, q, k):
    d = ((q.astype(np.float64)[:, None, :] - x.astype(np.float64)[None]) ** 2).sum(-1)
    i = np.argsort(d, axis=-1, kind="stable")[:, :k]
    return np.take_along_axis(d, i, -1), i


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_exact_knn_equals_numpy(dtype):
    rng = np.random.default_rng(0)
    if dtype == np.uint8:
        x = rng.integers(0, 256, (700, 24)).astype(np.uint8)
        q = rng.integers(0, 256, (37, 24)).astype(np.uint8)
    else:
        x = rng.normal(size=(700, 24)).astype(np.float32)
        q = rng.normal(size=(37, 24)).astype(np.float32)
    d, i = reference.exact_knn(x, q, 10, torch.device("cpu"), q_block=8)
    dn, in_ = _numpy_knn(x, q, 10)
    np.testing.assert_allclose(d, dn, rtol=1e-12, atol=1e-9)
    if dtype == np.uint8:  # integer distances may tie: compare the sets' distances
        assert np.array_equal(d, dn)
    else:
        assert np.array_equal(i, in_)


def test_pair_dists_forms():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, 16)).astype(np.float32)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    qid = np.array([0, 5, 5, 2])
    lab = rng.integers(0, 50, (4, 3))
    out = reference.pair_dists(x, q, qid, lab, ("f32", "bf16"), torch.device("cpu"), block=5)
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    for r in range(4):
        for j in range(3):
            qq = q[qid[r]].astype(np.float64)
            assert out["f32"][r, j] == pytest.approx(((x[lab[r, j]] - qq) ** 2).sum(), rel=1e-12)
            assert out["bf16"][r, j] == pytest.approx(((xb[lab[r, j]] - qq) ** 2).sum(), rel=1e-12)
            assert out["scale"][r, j] == pytest.approx((x[lab[r, j]].astype(np.float64) ** 2).sum()
                                                       + (qq ** 2).sum(), rel=1e-12)


def _cfg(k=3):
    return {"k": k, "stored_as": ["u8"]}


def test_judge_counts_ties_and_catches_bad_rows():
    x = np.array([[0, 0], [1, 0], [0, 1], [3, 3], [5, 5]], dtype=np.uint8)
    q = np.array([[0, 0]], dtype=np.uint8)
    check = {"recall_min": 0.9, "dist_gap_max": 0}
    dev = torch.device("cpu")
    qid = np.zeros(1, dtype=np.int64)
    # rows 1 and 2 tie at distance 1: either is a hit
    good = compare.judge(_cfg(), check, x, q, qid, np.array([[0, 2, 1]]),
                         np.array([[0.0, 1.0, 1.0]]), dev)
    assert good["correct"] and good["recall"] == 1.0
    # a wrong distance, a label twice, a label out of range, out of order
    for lab, d in (([0, 1, 2], [0.0, 1.0, 2.0]), ([0, 1, 1], [0.0, 1.0, 1.0]),
                   ([0, 1, 9], [0.0, 1.0, 1.0]), ([0, 1, 2], [1.0, 0.0, 1.0])):
        res = compare.judge(_cfg(), check, x, q, qid, np.array([lab]), np.array([d]), dev)
        assert not res["correct"], (lab, d)
    # a farther row in the top 3 lowers recall
    far = compare.judge(_cfg(), check, x, q, qid, np.array([[0, 1, 3]]),
                        np.array([[0.0, 1.0, 18.0]]), dev)
    assert far["recall"] == pytest.approx(2 / 3) and not far["correct"]


def test_roofline_byte_counts_by_hand():
    # bf16 blocks of m0=4 rows at d=12 (padded to 16): a row is 16*2 + 4 bytes
    assert roofline.block_bytes("unified", 4, 12) == 4 * (32 + 4)
    assert roofline.block_bytes("unified8", 4, 12) == 4 * (16 + 8)
    assert roofline.block_bytes("unified4", 4, 16) == 4 * (8 + 8)
    # B=3 queries, E=2 chosen each, 5 distinct blocks
    got = roofline.hop_launch_bytes("unified", 3, 2, 5, 4, 12)
    assert got == 5 * 144 + 3 * 16 * 4 + 3 * 2 * 4 + 3 * 2 * 4 * 8
    assert roofline.hop_launch_flops("unified8", 3, 2, 4, 12) == 3 * 2 * 4 * 16 * 4
    t = roofline.hop_least_seconds("unified", [(3, 2, 5)], 4, 12)
    assert t == pytest.approx(max(got / 3.35e12, 3 * 2 * 4 * 16 * 3 / 67e12))
