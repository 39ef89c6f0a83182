"""Unit tests for the numeric ops — the fine-grained coverage the
reference lacks (SURVEY.md §4: add unit tests for PQ encode/decode,
bitmap filters, bucket append/grow/compact)."""

import numpy as np
import jax.numpy as jnp
import pytest

from gamma_tpu.ops import kmeans as km, pq as pq_ops, penalty as pen_ops
from gamma_tpu.ops.distances import pairwise_l2, pairwise_ip, BIG
from gamma_tpu.ops.flat_scan import flat_search
from gamma_tpu.ops.topk import topk_min


def test_pairwise_l2_matches_numpy(rng):
    q = rng.normal(size=(7, 16)).astype(np.float32)
    x = rng.normal(size=(33, 16)).astype(np.float32)
    got = np.asarray(pairwise_l2(jnp.asarray(q), jnp.asarray(x)))
    want = ((q[:, None] - x[None]) ** 2).sum(-1)
    # the norm-expansion formula trades a little precision for one matmul
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=5e-2)


def test_pairwise_ip(rng):
    q = rng.normal(size=(5, 8)).astype(np.float32)
    x = rng.normal(size=(9, 8)).astype(np.float32)
    got = np.asarray(pairwise_ip(jnp.asarray(q), jnp.asarray(x)))
    np.testing.assert_allclose(got, q @ x.T, rtol=1e-5, atol=1e-4)


def test_topk_min(rng):
    d = rng.normal(size=(3, 50)).astype(np.float32)
    ids = np.tile(np.arange(50, dtype=np.int32), (3, 1))
    vals, got_ids = topk_min(jnp.asarray(d), jnp.asarray(ids), 5)
    for b in range(3):
        want = np.sort(d[b])[:5]
        np.testing.assert_allclose(np.asarray(vals)[b], want, rtol=1e-6)


def test_kmeans_reduces_quantization_error(corpus_small):
    x = jnp.asarray(corpus_small)
    cents, counts = km.kmeans(x, 32, iters=8)
    d = np.asarray(pairwise_l2(x, cents)).min(axis=1)
    # random-init error would be far larger; clustered data → tight fit
    assert d.mean() < np.var(corpus_small, axis=0).sum() * 0.5
    assert np.asarray(counts).sum() == corpus_small.shape[0]


def test_pq_roundtrip_error(corpus_small):
    x = corpus_small
    pq = pq_ops.train_pq(jnp.asarray(x), M=8, iters=8)
    codes = pq_ops.encode_pq(pq, jnp.asarray(x))
    assert codes.shape == (x.shape[0], 8)
    assert codes.dtype == jnp.uint8
    rec = np.asarray(pq_ops.decode_pq(pq, codes))[:, : x.shape[1]]
    rel = np.linalg.norm(rec - x) / np.linalg.norm(x)
    assert rel < 0.35     # 8 bytes for 32 dims of clustered data


def test_adc_matches_exact_lut_sum(rng):
    x = rng.normal(size=(300, 32)).astype(np.float32)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    pq = pq_ops.train_pq(jnp.asarray(x), M=4, iters=6)
    codes = pq_ops.encode_pq(pq, jnp.asarray(x))
    lut = pq_ops.l2_lut(pq, jnp.asarray(q))          # [4, M, 256]
    # adc over all codes for each query
    adc = np.asarray(pq_ops.adc_scan(lut[:, None], codes[None, None]))
    # oracle: distance between q and decoded x
    rec = np.asarray(pq_ops.decode_pq(pq, codes))
    want = ((q[:, None] - rec[None]) ** 2).sum(-1)
    np.testing.assert_allclose(adc[:, 0], want, rtol=1e-3, atol=1e-2)


def test_penalty_compose():
    v = pen_ops.init_validity(64)
    v = pen_ops.mark_live(v, jnp.arange(10, dtype=jnp.int32))
    v = pen_ops.mark_deleted(v, jnp.asarray([3], jnp.int32))
    col = jnp.arange(64, dtype=jnp.float32)
    rp = pen_ops.range_penalty(col, 2.0, 7.0)
    combined = np.asarray(pen_ops.combine([v, rp]))
    ok = np.flatnonzero(combined == 0.0)
    np.testing.assert_array_equal(ok, [2, 4, 5, 6, 7])


def test_flat_search_exact(rng):
    x = rng.normal(size=(1000, 24)).astype(np.float32)
    q = rng.normal(size=(5, 24)).astype(np.float32)
    pen = np.zeros(1000, np.float32)
    d, ids = flat_search(jnp.asarray(x), jnp.asarray((x ** 2).sum(1)),
                         jnp.asarray(q), jnp.asarray(pen), k=10,
                         chunk=256)
    want = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :10]
    got = np.asarray(ids)
    # allow order ties; compare sets per query
    for b in range(5):
        assert set(got[b]) == set(want[b])


def test_flat_search_respects_penalty(rng):
    x = rng.normal(size=(500, 8)).astype(np.float32)
    q = x[:3].copy()
    pen = np.zeros(500, np.float32)
    pen[:3] = float(BIG)      # mask the exact matches
    d, ids = flat_search(jnp.asarray(x), jnp.asarray((x ** 2).sum(1)),
                         jnp.asarray(q), jnp.asarray(pen), k=5)
    got = np.asarray(ids)
    assert not (got[:, 0] == np.arange(3)).any()


def test_chunkmin_topk_indices_and_containment():
    """_chunkmin_topk: returned values match flat[ridx]; strided bins
    keep near-contiguous true winners (same-list adjacency) intact."""
    import jax.numpy as jnp
    from gamma_tpu.ops.topk import _chunkmin_topk
    rng = np.random.default_rng(3)
    b, w, rn = 8, 200_000, 64
    flat = rng.normal(size=(b, w)).astype(np.float32)
    # plant adjacent extreme winners (hot-list near-ties): contiguous
    # chunking would collide them, strided bins must keep all
    for i in range(b):
        s = rng.integers(0, w - 40)
        flat[i, s: s + 12] = -100 - rng.random(12).astype(np.float32)
    rd, ridx = _chunkmin_topk(jnp.asarray(flat), rn)
    rd, ridx = np.asarray(rd), np.asarray(ridx)
    np.testing.assert_allclose(rd, np.take_along_axis(flat, ridx, 1))
    got = {tuple(sorted(ridx[i][:12])) for i in range(b)}
    for i in range(b):
        exact = set(np.argsort(flat[i])[:12].tolist())
        assert exact <= set(ridx[i].tolist()), (i, exact - set(ridx[i]))
    # and monotone ascending prefix
    assert np.all(np.diff(rd[:, :12], axis=1) >= -1e-6)


def test_exact_scan_query_chunking_matches_direct(rng, monkeypatch):
    """ivfflat_search / binary_ivf_search must return identical results
    whether the payload gather runs whole-batch or through the
    lax.map query-chunked path (FLAT_GATHER_BYTES budget — the 13 GB
    full-batch gather OOM'd one chip at the 200k bench geometry)."""
    from gamma_tpu.ops import ivf_scan as iv
    from gamma_tpu.index.ivfflat import IVFFlatIndex
    from gamma_tpu.index.binary_ivf import BinaryIVFIndex, pack_bits_np
    from gamma_tpu.vector.raw_store import RawVectorStore
    from gamma_tpu.config import SearchParams

    n, d, k = 3000, 32, 5
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = x[rng.choice(n, 24, replace=False)] + 0.05 * rng.normal(
        size=(24, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    sp = SearchParams.from_dict({"nprobe": 8})
    pen = jnp.zeros(n, jnp.float32)

    def build(cls, xx):
        s = RawVectorStore("chk", d, init_cap=n + 64)
        s.add(x)
        s.flush_device()
        m = cls(s, {"ncentroids": 32, "bucket_init_size": 256})
        m.train(x)
        m.add(xx, ids, ids)
        return m

    for cls, xx, qq in ((IVFFlatIndex, x, jnp.asarray(q)),
                        (BinaryIVFIndex, x, jnp.asarray(q))):
        m = build(cls, xx)
        d0, doc0, vid0 = (np.asarray(t)
                          for t in m.search(qq, pen, sp, k))
        # force the chunked path: tiny budget => many lax.map chunks
        monkeypatch.setattr(iv, "FLAT_GATHER_BYTES", 1 << 12)
        iv.ivfflat_search.clear_cache()
        iv.binary_ivf_search.clear_cache()
        d1, doc1, vid1 = (np.asarray(t)
                          for t in m.search(qq, pen, sp, k))
        monkeypatch.undo()
        iv.ivfflat_search.clear_cache()
        iv.binary_ivf_search.clear_cache()
        np.testing.assert_allclose(d0, d1, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(doc0, doc1)
