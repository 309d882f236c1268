"""Port parity, the query engine on the tier ladder's tables: the JAX
engine with the tables its build_inline_tables makes (Pallas in interpret
mode), set on it by the test, against the port's engine with the ladder
built on the CPU through its `tables` seam, on one serial-built graph: the
bf16 rung, the int8 rung with its auto rescore, and --hbm_trim (bf16 vector
table, no upper tables). The `cuda`-marked tests hold the engine on the card
to the same engine's plain versions on the CPU, and count its kernels'
launches.

Each JAX search runs once per module; the cases with a rescore run 8 or 4
queries (the JAX side's Pallas gathers cost seconds per query in interpret
mode; the f32 rescore's parity at 8 queries is in test_torch_service.py)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hnsw_tpu.ops.pallas_gather import build_inline_tables as j_build_inline_tables
from hnsw_tpu.service import query_service as jqs

from hnsw_tpu_torch.models import hnsw as thnsw
from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.ops.gather_kernels import COUNTS, tier_bytes
from hnsw_tpu_torch.service import query_service as tqs

N, D, M, EFC, B, K, EF = 1500, 24, 8, 100, 16, 10, 48
MODES = {"speed": {"stop_frontier": 1.15, "max_iters": 14, "entry_seeds": 4, "ef": 40},
         "rescore": {"rescore": 40, "entry_seeds": 4}}
JAX_BF16_BYTES = 13 * 2**30  # hnsw_tpu.models.hnsw.UNIFIED_MAX_BYTES


def _jax_int8_bytes(n_pad, m0):
    """The JAX ladder's own count of the int8 rung (lane width 128)."""
    return n_pad * ((m0 * 128 // 512 + 1) * 512 + 128 + 4)


def _build(n, seed, tmp):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    idx = HNSWIndex("l2", dim=D, m=M, ef_construction=EFC, device="cpu")
    labels = np.arange(n, dtype=np.int64) * 3 + 7
    idx._builder.add_batch(x, labels, n_threads=1)
    ckpt = str(tmp / "index.npz")
    idx.save(ckpt)
    idx.export_adj(ckpt + ".adj")
    perm = rng.permutation(n)
    return {"x": x, "q": q, "ckpt": ckpt, "bulk": (labels[perm], x[perm])}


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    return {**_build(N, 19, tmp_path_factory.mktemp("tiers")), "jax": {}}


# tier, hbm_trim, construction, mode, rows
CASES = {
    "bf16": ("unified", False, "normal", None, B),
    "bf16_speed": ("unified", False, "normal", "speed", B),
    "bf16_optimized": ("unified", False, "optimized", None, B),
    "int8_auto_rescore": ("unified8", False, "normal", None, 8),
    "int8_hbm_trim": ("unified8", True, "optimized", None, 4),
}


def _engine(pkg, s, tier, trim, construction, monkeypatch, **kw):
    graph, optimized = s["ckpt"], construction == "optimized"
    if optimized:
        fetch = lambda storage, dim, retries=3: (s["bulk"][0].copy(), s["bulk"][1].copy())
        monkeypatch.setattr(pkg, "_fetch_bulk_vectors", fetch)
    return pkg.build_engine(graph, optimized, "http://storage.invalid", D, EF, K,
                            modes=MODES, hbm_trim=trim, **kw)


def _port_engine(s, tier, trim, construction, monkeypatch, device="cpu"):
    """The port's engine with its ladder held to `tier` by the module budget
    at that tier's own bytes (None: no limit on the CPU, the bf16 rung)."""
    n_pad = ((len(s["x"]) + 1 + 127) // 128) * 128
    budget = None if tier == "unified" else tier_bytes(n_pad, 2 * M, D)[tier]
    monkeypatch.setattr(thnsw, "UNIFIED_MAX_BYTES", budget)
    return _engine(tqs, s, tier, trim, construction, monkeypatch, device=device,
                   tables=True)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_tables_match_jax(shared, case, monkeypatch):
    tier, trim, construction, mode, rows = CASES[case]
    if case not in shared["jax"]:
        je = _engine(jqs, shared, tier, trim, construction, monkeypatch)
        n_pad, m0 = je.dg.level0.shape
        budget = JAX_BF16_BYTES if tier == "unified" else _jax_int8_bytes(n_pad, m0)
        je.inline = j_build_inline_tables(
            je.x, je.dg, D, budget, 0, upper_inline=not trim, keep_delta_tables=False)
        assert je.inline[0] == tier
        shared["jax"][case] = je.search(shared["q"][:rows], K, EF, mode=mode)
    jd, jl = shared["jax"][case]
    te = _port_engine(shared, tier, trim, construction, monkeypatch)
    assert te.tier == tier
    assert te.x.dtype == (torch.bfloat16 if trim else torch.float32)
    assert (len(te.inline.upper_tables) == 0) == trim
    td, tl = te.search(shared["q"][:rows], K, EF, mode=mode)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=0)


def test_engine_serves_plain_gathers_on_the_cpu(shared):
    """No tables unless asked: on the CPU the engine serves through plain
    row gathers, as the JAX engine does off the TPU."""
    te = tqs.build_engine(shared["ckpt"], False, "", D, EF, K, device="cpu")
    assert te.inline is None and te.tier is None


# ---------------------------------------------------------------------------
# On the card (cuda marker): the hop and rescore kernels of each rung.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return _build(2000, 23, tmp_path_factory.mktemp("card"))


@pytest.mark.cuda
@pytest.mark.parametrize("tier,trim,construction,mode,kernels", [
    ("unified", False, "normal", None, ("hop_dist_unified",)),
    ("unified", False, "normal", "rescore", ("hop_dist_unified", "gather_dist_rows")),
    ("unified8", False, "normal", None, ("hop_dist_unified8", "gather_dist_rows")),
    ("unified8", True, "optimized", None, ("hop_dist_unified8", "gather_dist_bf16")),
    ("unified", True, "normal", "rescore", ("hop_dist_unified", "gather_dist_bf16")),
])
def test_engine_on_cuda_matches_plain(card, tier, trim, construction, mode, kernels,
                                      monkeypatch):
    plain = _port_engine(card, tier, trim, construction, monkeypatch)
    want_d, want_l = plain.search(card["q"], K, EF, mode=mode)
    eng = _port_engine(card, tier, trim, construction, monkeypatch, device="cuda")
    assert eng.tier == tier and eng.x.is_cuda
    eng.warm_modes()
    COUNTS.reset()
    got_d, got_l = eng.search(card["q"], K, EF, mode=mode)
    for name in kernels:
        assert getattr(COUNTS, name) > 0, name
    assert COUNTS.plain_on_cuda == 0
    # the kernels' summation order can flip a near-tie
    assert np.mean(got_l == want_l) >= 0.99
    same = got_l == want_l
    np.testing.assert_allclose(got_d[same], want_d[same], rtol=1e-5, atol=1e-4)
