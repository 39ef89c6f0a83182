"""IVFPQ_FASTSCAN: 4-bit packed codes, ksub=16 scan, model lifecycle.

Reference behavior contract: index/impl/gamma_index_ivfpqfs.{h,cc}
(nbits=4 forced, by_residual=false, packed blocks)."""

import numpy as np
import pytest

import jax.numpy as jnp

from gamma_tpu.config import SearchParams
from gamma_tpu.index import create_model
from gamma_tpu.index.ivfpq_fastscan import IVFPQFastScanIndex
from gamma_tpu.ops import pq as pq_ops
from gamma_tpu.vector.raw_store import RawVectorStore

from tests.conftest import make_blobs


def _gt(corpus, queries, k):
    d2 = (np.sum(queries**2, 1)[:, None] - 2 * queries @ corpus.T
          + np.sum(corpus**2, 1)[None, :])
    return np.argsort(d2, axis=1)[:, :k]


@pytest.fixture(scope="module")
def built(rng):
    corpus = make_blobs(np.random.default_rng(7), 8000, 64, n_clusters=64)
    store = RawVectorStore("v", 64)
    store.add(corpus)
    store.flush_device()
    idx = IVFPQFastScanIndex(store, {"ncentroids": 64, "nsubvector": 32,
                                     "nprobe": 16})
    idx.train(corpus)
    ids = np.arange(corpus.shape[0], dtype=np.int64)
    idx.add(corpus, ids, ids)
    return corpus, store, idx


def test_registry_creates_real_fastscan(rng):
    store = RawVectorStore("v", 32)
    m = create_model("IVFPQ_FASTSCAN", store, {"ncentroids": 16})
    assert isinstance(m, IVFPQFastScanIndex)
    assert m.p.nbits_per_idx == 4
    assert m.state.codes.shape[-1] == m.p.nsubvector // 2   # packed


def test_codes_are_packed_nibbles(built):
    corpus, store, idx = built
    codes = np.asarray(idx.state.codes)
    assert codes.shape[-1] == 16          # 32 subquantizers / 2
    # unpack round-trips through the packing used at encode time
    _, packed, _, _ = idx.encode_batch(corpus[:32])
    un = np.asarray(pq_ops.unpack_nibbles(packed))[:32]
    assert un.max() <= 15
    repacked = un[:, 0::2] | (un[:, 1::2] << 4)
    assert (repacked == np.asarray(packed)[:32]).all()


def test_gather_recall(built):
    corpus, store, idx = built
    rng = np.random.default_rng(3)
    queries = corpus[rng.choice(8000, 64, replace=False)] + \
        0.02 * rng.normal(size=(64, 64)).astype(np.float32)
    queries = queries.astype(np.float32)
    gt = _gt(corpus, queries, 10)
    penalty = jnp.zeros(store.device.shape[0], jnp.float32)
    sp = SearchParams.from_dict({"scan_mode": "gather", "nprobe": 16,
                                 "recall_num": 100, "has_rank": True})
    _, docs, _ = idx.search(jnp.asarray(queries), penalty, sp, 10)
    docs = np.asarray(docs)
    recall = np.mean([len(set(docs[i]) & set(gt[i])) / 10
                      for i in range(64)])
    assert recall >= 0.9, recall


def test_dense_mode_matches_gather(built):
    corpus, store, idx = built
    queries = jnp.asarray(corpus[:16])
    penalty = jnp.zeros(store.device.shape[0], jnp.float32)
    spd = SearchParams.from_dict({"scan_mode": "dense", "recall_num": 100})
    spg = SearchParams.from_dict({"scan_mode": "gather", "nprobe": 64,
                                  "recall_num": 100})
    _, dd, _ = idx.search(queries, penalty, spd, 10)
    _, dg, _ = idx.search(queries, penalty, spg, 10)
    # nprobe=nlist gather vs dense: same candidates after exact rerank
    agree = np.mean([len(set(np.asarray(dd)[i]) & set(np.asarray(dg)[i]))
                     / 10 for i in range(16)])
    assert agree >= 0.9, agree


def test_delete_and_update(built):
    corpus, store, idx = built
    penalty = jnp.zeros(store.device.shape[0], jnp.float32)
    sp = SearchParams.from_dict({"scan_mode": "gather", "nprobe": 64,
                                 "recall_num": 100})
    q = jnp.asarray(corpus[5:6])
    _, docs, _ = idx.search(q, penalty, sp, 5)
    target = int(np.asarray(docs)[0, 0])
    idx.delete(np.array([target]))
    _, docs2, _ = idx.search(q, penalty, sp, 5)
    assert target not in np.asarray(docs2)[0].tolist()


def test_dump_load_roundtrip(built, tmp_path):
    corpus, store, idx = built
    penalty = jnp.zeros(store.device.shape[0], jnp.float32)
    sp = SearchParams.from_dict({"scan_mode": "gather", "nprobe": 16,
                                 "recall_num": 100})
    q = jnp.asarray(corpus[:8])
    _, before, _ = idx.search(q, penalty, sp, 10)
    idx.dump(str(tmp_path))
    idx2 = IVFPQFastScanIndex(store, {"ncentroids": 64, "nsubvector": 32,
                                      "nprobe": 16})
    assert idx2.load(str(tmp_path)) == idx.indexed_count
    _, after, _ = idx2.search(q, penalty, sp, 10)
    assert (np.asarray(before) == np.asarray(after)).all()


def test_train_with_shared_coarse(rng):
    """coarse=(centroids, norms) seeds the coarse quantizer (no k-means
    rerun): the bench shares IVFPQ's quantizer with FastScan.  Recall
    must match a self-trained build on the same data."""
    from gamma_tpu.index.ivfpq import IVFPQIndex
    corpus = make_blobs(np.random.default_rng(11), 8000, 64, n_clusters=64)
    ids = np.arange(corpus.shape[0], dtype=np.int64)

    store_a = RawVectorStore("va", 64)
    store_a.add(corpus)
    store_a.flush_device()
    donor = IVFPQIndex(store_a, {"ncentroids": 64, "nsubvector": 16,
                                 "nprobe": 16})
    donor.train(corpus)

    store_b = RawVectorStore("vb", 64)
    store_b.add(corpus)
    store_b.flush_device()
    fs = IVFPQFastScanIndex(store_b, {"ncentroids": 64, "nsubvector": 32,
                                      "nprobe": 16})
    fs.train(corpus, coarse=(donor.centroids, donor.cent_norms))
    assert np.asarray(fs.centroids is donor.centroids
                      or np.array_equal(np.asarray(fs.centroids),
                                        np.asarray(donor.centroids)))
    fs.add(corpus, ids, ids)

    q = corpus[np.random.default_rng(12).integers(0, 8000, 32)]
    pen = jnp.zeros(8000, np.float32)
    sp = SearchParams.from_dict({"recall_num": 64, "has_rank": True,
                                 "scan_mode": "gather"})
    _, docs, _ = fs.search(jnp.asarray(q), pen, sp, 10)
    docs = np.asarray(docs)
    d_ex = ((q[:, None].astype(np.float64)
             - corpus[None].astype(np.float64)) ** 2).sum(-1)
    want = np.argsort(d_ex, axis=1)[:, :10]
    recall = np.mean([len(set(docs[b]) & set(want[b])) / 10
                      for b in range(32)])
    assert recall >= 0.85, f"shared-coarse recall@10 = {recall}"
