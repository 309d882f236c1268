"""Port parity, the hnswlib `.bin` format: the port's save_hnswlib writes the
JAX package's bytes for the same graph and vectors, each package's read_bin
reads the other's file, write_bin -> read_bin is exact, malformed files
raise the same errors, and the port's from_hnswlib serves JAX's labels, in
the l2, ip, cosine and l2u8 spaces, with delete marks.

Light by design: one serial build at N=2000 (over l2, on u8-valued data, and
used in every space: the format does not depend on the space the links were
chosen in), one thread, files only under tmp_path, and each JAX search once
per module at one batch shape (its Pallas kernel runs in interpret mode)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import hnsw_tpu.core.graph as jgraph
from hnsw_tpu.io.hnswbin import read_bin as j_read_bin
from hnsw_tpu.models.hnsw import HNSWIndex as JIndex

from hnsw_tpu_torch.core.spaces import get_space
from hnsw_tpu_torch.io.hnswbin import read_bin, write_bin
from hnsw_tpu_torch.models import hnsw as thnsw
from hnsw_tpu_torch.models.hnsw import HNSWIndex
from hnsw_tpu_torch.native.hnsw_builder import NativeHNSWBuilder
from hnsw_tpu_torch.ops.gather_kernels import COUNTS, tier_bytes

REPO = Path(__file__).resolve().parents[1]
N, D, M, EFC, B, K, EF = 2000, 16, 8, 60, 16, 10, 40
SPACES = ("l2", "ip", "cosine", "l2u8")
FIELDS = ("level0", "upper", "upper_slot", "node_level", "labels")
META = ("space", "dim", "m", "max_m", "max_m0", "ef_construction", "mult",
        "max_elements")


def _raw(u: np.ndarray, space: str) -> np.ndarray:
    """The values a user inserts in `space`, from u8 data."""
    if space == "l2u8":
        return u
    if space == "l2":
        return u.astype(np.float32) / 16.0
    return (u.astype(np.float32) - 127.5) / 128.0  # ip, cosine


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(41)
    u = rng.integers(0, 256, size=(N, D)).astype(np.uint8)
    uq = rng.integers(0, 256, size=(B, D)).astype(np.uint8)
    labels = np.arange(N, dtype=np.int64) * 7 + 3_000_000_000  # past 2^31
    b = NativeHNSWBuilder(D, "l2", M, EFC, seed=123)
    b.add_batch(u.astype(np.float32), labels, n_threads=1)
    g = b.export_graph()
    deleted = np.zeros(N, dtype=np.uint8)
    deleted[rng.choice(N, 25, replace=False)] = 1
    deleted[g.entry_point] = 1  # a delete-marked entry point stays the entry
    return {"u": u, "uq": uq, "g": g, "deleted": deleted, "jax": {}}


def _jgraph(g):
    return jgraph.HNSWGraph(g.level0, g.upper, g.upper_slot, g.node_level,
                            g.labels, g.entry_point, g.max_level)


def _indexes(s, space):
    """The port's and the JAX package's index over the shared graph, with
    the space's stored values."""
    internal = get_space(space, D).preprocess(_raw(s["u"], space))
    meta = {"space": space, "dim": D, "m": M, "ef_construction": EFC}
    t = HNSWIndex._from_parts(s["g"], internal, s["deleted"], meta, device="cpu")
    j = JIndex._from_parts(_jgraph(s["g"]), internal, s["deleted"], meta)
    return t, j


def _assert_same_read(a, b):
    (ga, va, da, ma), (gb, vb, db, mb) = a, b
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ga, f)),
                                      np.asarray(getattr(gb, f)), err_msg=f)
    assert (ga.entry_point, ga.max_level) == (gb.entry_point, gb.max_level)
    assert va.dtype == vb.dtype
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(da, db)
    assert {k: ma[k] for k in META} == {k: mb[k] for k in META}


@pytest.mark.parametrize("space", SPACES)
def test_bin_files_match_jax(shared, space, tmp_path):
    t, j = _indexes(shared, space)
    pt, pj = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    t.save_hnswlib(pt)
    j.save_hnswlib(pj)
    blob = Path(pt).read_bytes()
    assert blob == Path(pj).read_bytes()

    got = read_bin(pj, space=space)
    _assert_same_read(got, j_read_bin(pt, space=space))
    g, vectors, deleted, meta = got
    # the file holds what the index holds: its graph, raw values, marks
    tg = t.graph
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(g, f), getattr(tg, f), err_msg=f)
    assert (g.entry_point, g.max_level) == (tg.entry_point, tg.max_level)
    np.testing.assert_array_equal(deleted, shared["deleted"])
    want = _raw(shared["u"], space)
    if space == "cosine":
        want = get_space("cosine", D).preprocess(want)
    np.testing.assert_array_equal(vectors, want)
    assert meta == {"space": space, "dim": D, "m": M, "max_m": M, "max_m0": 2 * M,
                    "ef_construction": EFC, "mult": 1.0 / np.log(M),
                    "max_elements": N}

    # write_bin -> read_bin is exact, and writes the same bytes again
    again = str(tmp_path / "again.bin")
    write_bin(again, g, vectors, deleted, space=space, m=M, ef_construction=EFC)
    assert Path(again).read_bytes() == blob
    _assert_same_read(read_bin(again, space=space), got)


def _malformed(kind, s, tmp_path):
    t, _ = _indexes(s, "l2")
    path = str(tmp_path / f"{kind}.bin")
    if kind == "short_header":
        Path(path).write_bytes(b"\0" * 95)
    elif kind == "offset_level0":
        t.save_hnswlib(path)
        blob = bytearray(Path(path).read_bytes())
        blob[0:8] = (4).to_bytes(8, "little")
        Path(path).write_bytes(bytes(blob))
    else:  # a u8 file of dim 3 read as an f32 space: 3 bytes of data
        write_bin(path, s["g"], s["u"][:, :3], space="l2u8", m=M)
    return path


@pytest.mark.parametrize("kind,match", [
    ("short_header", "shorter than the 96-byte header"),
    ("offset_level0", "offsetLevel0 4 != 0"),
    ("data_size", "not a multiple of 4"),
])
def test_malformed_bin_raises_as_jax(shared, kind, match, tmp_path):
    path = _malformed(kind, shared, tmp_path)
    with pytest.raises(ValueError, match=match) as mine:
        read_bin(path, space="l2")
    with pytest.raises(ValueError) as theirs:
        j_read_bin(path, space="l2")
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("space", SPACES)
def test_from_hnswlib_matches_jax(shared, space, tmp_path):
    """The port's from_hnswlib of a JAX-written file serves JAX's
    from_hnswlib labels (JAX on its unified tier)."""
    _, j = _indexes(shared, space)
    path = str(tmp_path / "jax.bin")
    j.save_hnswlib(path)
    q = _raw(shared["uq"], space)
    if space not in shared["jax"]:
        ji = JIndex.from_hnswlib(path, space=space)
        ji.inline_neighbors = True  # the CPU default is off
        ji._device = None
        shared["jax"][space] = ji.search(q, k=K, ef=EF)
    jd, jl = shared["jax"][space]
    ti = HNSWIndex.from_hnswlib(path, space=space, device="cpu")
    assert ti.space.persist_name == space and ti.device.type == "cpu"
    assert ti.deleted_count == int(shared["deleted"].sum())
    g, tg = shared["g"], ti.graph
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tg, f), getattr(g, f), err_msg=f)
    assert (tg.entry_point, tg.max_level) == (g.entry_point, g.max_level)
    td, tl = ti.search(q, k=K, ef=EF)
    assert ti._device.tier == "unified"
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=0)
    assert not np.isin(tl, shared["g"].labels[shared["deleted"] == 1]).any()


def test_hnswbin_imports_no_jax():
    subprocess.run(
        [sys.executable, "-c",
         "import sys; import hnsw_tpu_torch.io.hnswbin, hnsw_tpu_torch.models.hnsw, "
         "hnsw_tpu_torch.ops; "
         "assert not [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
         "or m == 'hnsw_tpu' or m.startswith('hnsw_tpu.')], 'jax or hnsw_tpu imported'"],
        check=True, cwd=REPO, timeout=120,
    )


# ---------------------------------------------------------------------------
# On the card (cuda marker): an imported index serves the original's labels.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_from_hnswlib_on_cuda_matches_original(shared, tmp_path, monkeypatch):
    """In each space, on the bf16 rung and on the int8 rung (the budget at
    the int8 table's bytes), the index imported onto the card returns the
    labels of the index it was saved from, and launches the rung's hop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for space in SPACES:
        t, _ = _indexes(shared, space)
        path = str(tmp_path / f"{space}.bin")
        t.save_hnswlib(path)
        orig = HNSWIndex._from_parts(shared["g"], t._builder.export_vectors(),
                                     shared["deleted"], {"space": space, "dim": D, "m": M,
                                                         "ef_construction": EFC},
                                     device="cuda")
        imp = HNSWIndex.from_hnswlib(path, space=space, device="cuda")
        q = _raw(shared["uq"], space)
        dg = orig.device_graph  # the synced tables' n_pad (growth headroom included)
        int8_bytes = tier_bytes(dg.n_pad, dg.level0.shape[1], D)["unified8"]
        for tier, budget, hop in (("unified", None, "hop_dist_unified"),
                                  ("unified8", int8_bytes, "hop_dist_unified8")):
            monkeypatch.setattr(thnsw, "UNIFIED_MAX_BYTES", budget)
            assert orig.rebuild_device_tables().tier == tier
            want_d, want_l = orig.search(q, k=K, ef=EF)
            assert imp.rebuild_device_tables().tier == tier and imp.device_vectors.is_cuda
            COUNTS.reset()
            got_d, got_l = imp.search(q, k=K, ef=EF)
            assert getattr(COUNTS, hop) > 0 and COUNTS.plain_on_cuda == 0
            np.testing.assert_array_equal(got_l, want_l, err_msg=f"{space} {tier}")
            np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=0)
