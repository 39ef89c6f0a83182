"""Dense-scan mode: reconstruction-matmul coarse pass + exact rerank.

Checks that dense mode (a) computes the same ADC math as gather mode,
(b) respects penalties (deletes + filters), (c) stays consistent under
OPQ rotation, and (d) survives delete/re-add cycles.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gamma_tpu.config import SearchParams
from gamma_tpu.index.ivfpq import IVFPQIndex
from gamma_tpu.ops.distances import BIG
from gamma_tpu.vector.raw_store import RawVectorStore


def _build(corpus, nlist=64, m=8, **kw):
    store = RawVectorStore("vec", corpus.shape[1])
    store.add(corpus)
    store.flush_device()
    idx = IVFPQIndex(store, {"ncentroids": nlist, "nsubvector": m, **kw})
    idx.train(corpus)
    ids = np.arange(corpus.shape[0], dtype=np.int64)
    idx.add(corpus, ids, ids)
    return store, idx


@pytest.fixture(scope="module")
def built(corpus_medium):
    return _build(corpus_medium)


def test_dense_matches_gather_recall(built, rng):
    """Both scan modes against a float64 exact oracle.

    The tiers select candidates differently — dense ranks a PQ-decoded
    bf16 mirror then reranks recall_num exactly; gather scans residual-
    SQ8 exact-to-quantized-point distances with NO rerank (ops/
    sq.py) — so mode-vs-mode set equality is NOT the contract
    (the SQ8 tier is measurably MORE accurate than PQ candidate select
    at this geometry). The contract is recall vs exact for each."""
    store, idx = built
    # on-manifold queries: the workload both tiers are specified for
    base = np.asarray(store.header(0, store.n))[
        rng.integers(0, store.n, size=8)]
    q = jnp.asarray(base + 0.05 * rng.normal(size=base.shape)
                    .astype(np.float32))
    pen = jnp.zeros(store.n + 64, jnp.float32)
    k = 10
    corpus = np.asarray(store.header(0, store.n)).astype(np.float64)
    d2 = ((np.asarray(q, np.float64)[:, None, :]
           - corpus[None]) ** 2).sum(-1)
    extop = np.argsort(d2, axis=1)[:, :k]
    spd = SearchParams.from_dict({"scan_mode": "dense"})
    spg = SearchParams.from_dict({"scan_mode": "gather",
                                  "nprobe": idx.p.ncentroids})
    dd, ddoc, _ = idx.search(q, pen, spd, k)
    gd, gdoc, _ = idx.search(q, pen, spg, k)
    dd, ddoc = np.asarray(dd), np.asarray(ddoc)
    gd, gdoc = np.asarray(gd), np.asarray(gdoc)
    rec_d = np.mean([len(set(ddoc[i]) & set(extop[i])) / k
                     for i in range(len(extop))])
    rec_g = np.mean([len(set(gdoc[i]) & set(extop[i])) / k
                     for i in range(len(extop))])
    assert rec_d >= 0.75, rec_d      # PQ M=8 at 64d: coarse candidates
    assert rec_g >= 0.90, rec_g      # SQ8 exact scan: near-exact
    # both modes agree on the top-1 doc and its (exact/near-exact) dist
    assert (ddoc[:, 0] == gdoc[:, 0]).mean() >= 0.99
    np.testing.assert_allclose(dd[:, 0], gd[:, 0], rtol=0.05, atol=0.2)


def test_dense_self_recall(built):
    """Indexed vectors must retrieve themselves at rank 1 (rerank exact)."""
    store, idx = built
    qi = np.arange(0, 500, 61)
    q = jnp.asarray(store.header(0, store.n)[qi])
    pen = jnp.zeros(store.n + 64, jnp.float32)
    sp = SearchParams.from_dict({"scan_mode": "dense"})
    _, docs, _ = idx.search(q, pen, sp, 1)
    assert (np.asarray(docs)[:, 0] == qi).mean() >= 0.99


def test_dense_penalty_filters(built, rng):
    store, idx = built
    q = jnp.asarray(rng.normal(size=(4, store.d)).astype(np.float32))
    pen = np.zeros(store.n + 64, np.float32)
    pen[::2] = BIG
    sp = SearchParams.from_dict({"scan_mode": "dense"})
    _, docs, _ = idx.search(q, jnp.asarray(pen), sp, 10)
    live = np.asarray(docs)[np.asarray(docs) >= 0]
    assert live.size and np.all(live % 2 == 1)


def test_dense_delete_readd(corpus_small):
    store, idx = _build(corpus_small, nlist=16, m=4)
    pen = jnp.zeros(store.n + 64, jnp.float32)
    sp = SearchParams.from_dict({"scan_mode": "dense"})
    q = jnp.asarray(corpus_small[:4])
    _, docs, _ = idx.search(q, pen, sp, 1)
    assert list(np.asarray(docs)[:, 0]) == [0, 1, 2, 3]
    idx.delete(np.array([0, 1]))
    _, docs, _ = idx.search(q, pen, sp, 1)
    assert not set(np.asarray(docs)[:, 0]) & {0, 1}
    # re-add (update path): becomes findable again
    idx.add(corpus_small[:2], np.array([0, 1]), np.array([0, 1]))
    _, docs, _ = idx.search(q, pen, sp, 1)
    assert list(np.asarray(docs)[:2, 0]) == [0, 1]


def test_dense_opq_rerank_consistent(corpus_medium, rng):
    store, idx = _build(corpus_medium, nlist=32, m=8, has_opq=True)
    q = jnp.asarray(corpus_medium[:8])
    pen = jnp.zeros(store.n + 64, jnp.float32)
    sp = SearchParams.from_dict({"scan_mode": "dense"})
    d, docs, _ = idx.search(q, pen, sp, 1)
    # self-retrieval with exact rerank: distance ~ 0 in RAW space
    assert (np.asarray(docs)[:, 0] == np.arange(8)).all()
    assert np.all(np.asarray(d)[:, 0] < 1e-2)


def test_dense_load_rebuilds_recon(tmp_path, corpus_small):
    store, idx = _build(corpus_small, nlist=16, m=4)
    idx.dump(str(tmp_path))
    store2 = RawVectorStore("vec", corpus_small.shape[1])
    store2.add(corpus_small)
    store2.flush_device()
    idx2 = IVFPQIndex(store2, {"ncentroids": 16, "nsubvector": 4})
    assert idx2.load(str(tmp_path)) == corpus_small.shape[0]
    np.testing.assert_allclose(
        np.asarray(idx2.recon[: store2.n], jnp.float32),
        np.asarray(idx.recon[: store2.n], jnp.float32), atol=1e-2)
    pen = jnp.zeros(store2.n + 64, jnp.float32)
    sp = SearchParams.from_dict({"scan_mode": "dense"})
    q = jnp.asarray(corpus_small[:4])
    _, docs, _ = idx2.search(q, pen, sp, 1)
    assert list(np.asarray(docs)[:, 0]) == [0, 1, 2, 3]
