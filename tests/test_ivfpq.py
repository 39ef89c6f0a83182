"""IVFPQ model: recall vs exact oracle, fused filters, delete/update,
dump/load — the recall-parity harness of SURVEY.md §7 step 4."""

import numpy as np
import jax.numpy as jnp
import pytest

from gamma_tpu.config import SearchParams
from gamma_tpu.index.ivfpq import IVFPQIndex
from gamma_tpu.ops import penalty as pen_ops
from gamma_tpu.ops.distances import BIG
from gamma_tpu.vector.raw_store import RawVectorStore


def exact_topk(x, q, k):
    d = ((q[:, None] - x[None]) ** 2).sum(-1)
    return np.argsort(d, axis=1)[:, :k]


@pytest.fixture(scope="module")
def built(rng_mod):
    rng = rng_mod
    n, d = 20000, 64
    centers = rng.normal(size=(64, d)).astype(np.float32)
    x = (centers[rng.integers(0, 64, n)]
         + 0.15 * rng.normal(size=(n, d))).astype(np.float32)
    store = RawVectorStore("vec", d)
    store.add(x)
    store.flush_device()
    idx = IVFPQIndex(store, {"ncentroids": 64, "nsubvector": 16,
                             "nprobe": 16})
    idx.train(x)
    vids = np.arange(n, dtype=np.int64)
    idx.add(x, vids, vids)
    pen = np.zeros(n, np.float32)
    return x, store, idx, jnp.asarray(pen)


@pytest.fixture(scope="module")
def rng_mod():
    return np.random.default_rng(7)


def test_recall_at_10(built, rng_mod):
    x, store, idx, pen = built
    q = x[rng_mod.integers(0, x.shape[0], 32)].copy()
    want = exact_topk(x, q, 10)
    sp = SearchParams(recall_num=100)
    d, docids, vids = idx.search(jnp.asarray(q), pen, sp, k=10)
    got = np.asarray(docids)
    recall = np.mean([len(set(got[b]) & set(want[b])) / 10
                      for b in range(q.shape[0])])
    assert recall >= 0.8, f"recall@10 = {recall}"


def test_rerank_improves_recall1(built, rng_mod):
    x, store, idx, pen = built
    q = x[rng_mod.integers(0, x.shape[0], 64)].copy()
    sp = SearchParams(recall_num=100, has_rank=True)
    _, docids, _ = idx.search(jnp.asarray(q), pen, sp, k=1)
    want = exact_topk(x, q, 1)[:, 0]
    r_rank = np.mean(np.asarray(docids)[:, 0] == want)
    sp2 = SearchParams(recall_num=100, has_rank=False)
    _, docids2, _ = idx.search(jnp.asarray(q), pen, sp2, k=1)
    r_norank = np.mean(np.asarray(docids2)[:, 0] == want)
    assert r_rank >= r_norank
    assert r_rank >= 0.9, f"reranked recall@1 = {r_rank}"


def test_filter_fused(built):
    x, store, idx, pen_clear = built
    n = x.shape[0]
    # only even docids pass the filter
    pen = np.zeros(n, np.float32)
    pen[1::2] = float(BIG)
    q = x[:8].copy()
    sp = SearchParams(recall_num=200)
    _, docids, _ = idx.search(jnp.asarray(q), jnp.asarray(pen), sp, k=10)
    got = np.asarray(docids)
    live = got[got >= 0]
    assert live.size > 0
    assert (live % 2 == 0).all()


def test_delete_then_search(built):
    x, store, idx, pen = built
    q = x[100:101].copy()
    sp = SearchParams(recall_num=50)
    _, docids, _ = idx.search(jnp.asarray(q), pen, sp, k=1)
    assert np.asarray(docids)[0, 0] == 100
    idx.delete(np.array([100]))
    _, docids, _ = idx.search(jnp.asarray(q), pen, sp, k=1)
    assert np.asarray(docids)[0, 0] != 100


def test_dump_load_roundtrip(built, tmp_path):
    x, store, idx, pen = built
    q = x[:4].copy()
    sp = SearchParams(recall_num=50)
    d1, i1, _ = idx.search(jnp.asarray(q), pen, sp, k=5)
    idx.dump(str(tmp_path))
    idx2 = IVFPQIndex(store, {"ncentroids": 64, "nsubvector": 16,
                              "nprobe": 16})
    assert idx2.load(str(tmp_path)) == idx.indexed_count
    d2, i2, _ = idx2.search(jnp.asarray(q), pen, sp, k=5)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5)


def test_opq_gather_rerank_space(rng_mod):
    """With OPQ, the gather-mode exact rerank must use the UNROTATED
    query against raw rows: self-retrieval distance ~0, top-1 exact."""
    rng = rng_mod
    n, d = 4096, 32
    x = rng.normal(size=(n, d)).astype(np.float32)
    store = RawVectorStore("vec", d)
    store.add(x)
    store.flush_device()
    idx = IVFPQIndex(store, {"ncentroids": 32, "nsubvector": 8,
                             "nprobe": 32, "has_opq": True,
                             "scan_mode": "gather"})
    idx.train(x)
    vids = np.arange(n, dtype=np.int64)
    idx.add(x, vids, vids)
    pen = jnp.zeros(n + 64, jnp.float32)
    sp = SearchParams.from_dict({"recall_num": 64,
                                 "scan_mode": "gather"})
    dists, docs, _ = idx.search(jnp.asarray(x[:8]), pen, sp, 5)
    dists, docs = np.asarray(dists), np.asarray(docs)
    assert list(docs[:, 0]) == list(range(8))
    assert np.all(dists[:, 0] < 1e-2), dists[:, 0]


def test_validity_mask_matches_penalty_path(corpus_medium):
    """Unfiltered gather search via the gather-free validity mask must
    equal the doc-space penalty path (and respect tombstones + the live
    watermark)."""
    import jax.numpy as jnp
    from gamma_tpu.config import SearchParams
    from gamma_tpu.index.ivfpq import IVFPQIndex
    from gamma_tpu.vector.raw_store import RawVectorStore

    x = corpus_medium
    n = x.shape[0]
    store = RawVectorStore("v", x.shape[1])
    store.add(x)
    store.flush_device()
    idx = IVFPQIndex(store, {"ncentroids": 64, "nsubvector": 8,
                             "nprobe": 16})
    idx.train(x)
    ids = np.arange(n, dtype=np.int64)
    idx.add(x, ids, ids)
    idx.delete(np.array([5, 6]))
    sp = SearchParams.from_dict({"scan_mode": "gather", "nprobe": 16,
                                 "recall_num": 100})
    q = jnp.asarray(x[:8])
    pen = np.zeros(n + 64, np.float32)
    pen[5] = pen[6] = 3.0e38
    d1, doc1, _ = idx.search(q, jnp.asarray(pen), sp, 10)
    d2, doc2, _ = idx.search(q, jnp.asarray(np.zeros(n + 64, np.float32)),
                             sp, 10, validity_n=n)
    assert (np.asarray(doc1) == np.asarray(doc2)).all()
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-6)
    # watermark: rows >= validity_n are invisible
    _, doc3, _ = idx.search(q, jnp.asarray(np.zeros(n + 64, np.float32)),
                            sp, 10, validity_n=10)
    assert np.asarray(doc3).max() < 10


def test_dense_fast_path_matches_penalty_path(corpus_medium):
    """Unfiltered DENSE search via the fused-bias fast path
    (ops/dense_scan.py dense_scan_search_fast) must return the same docs
    as the penalty-array path, honor tombstones + the live watermark,
    and restore the bias across dump/load."""
    import jax.numpy as jnp
    from gamma_tpu.config import SearchParams
    from gamma_tpu.index.ivfpq import IVFPQIndex
    from gamma_tpu.vector.raw_store import RawVectorStore

    x = corpus_medium
    n = x.shape[0]
    store = RawVectorStore("v", x.shape[1])
    store.add(x)
    store.flush_device()
    idx = IVFPQIndex(store, {"ncentroids": 64, "nsubvector": 8})
    idx.train(x)
    ids = np.arange(n, dtype=np.int64)
    idx.add(x, ids, ids)
    idx.delete(np.array([5, 6]))
    sp = SearchParams.from_dict({"scan_mode": "dense",
                                 "recall_num": 100})
    q = jnp.asarray(x[:8])
    pen = np.zeros(n + 64, np.float32)
    pen[5] = pen[6] = 3.0e38
    d1, doc1, _ = idx.search(q, jnp.asarray(pen), sp, 10)
    d2, doc2, _ = idx.search(q, jnp.asarray(np.zeros(n + 64, np.float32)),
                             sp, 10, validity_n=n)
    assert (np.asarray(doc1) == np.asarray(doc2)).all()
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2),
                               rtol=1e-5, atol=1e-4)
    assert 5 not in np.asarray(doc2) and 6 not in np.asarray(doc2)
    # watermark: rows >= validity_n are invisible
    _, doc3, _ = idx.search(q, jnp.asarray(np.zeros(n + 64, np.float32)),
                            sp, 10, validity_n=10)
    doc3 = np.asarray(doc3)
    assert doc3[doc3 >= 0].size == 0 or doc3.max() < 10
    # bias survives checkpoint: deleted rows stay dead after load
    import tempfile, os as _os
    with tempfile.TemporaryDirectory() as td:
        p = _os.path.join(td, "ivfpq")
        idx.dump(p)
        idx2 = IVFPQIndex(store, {"ncentroids": 64, "nsubvector": 8})
        idx2.load(p)
        d4, doc4, _ = idx2.search(
            q, jnp.asarray(np.zeros(n + 64, np.float32)), sp, 10,
            validity_n=n)
        doc4 = np.asarray(doc4)
        assert 5 not in doc4 and 6 not in doc4
        assert (doc4 == np.asarray(doc2)).all()


def test_dense_fast_path_ip_and_update(corpus_medium):
    """Fast-path coverage for the IP metric (bias = validity only) and
    the update path (tombstone + re-append must keep exactly one live
    copy visible)."""
    import jax.numpy as jnp
    from gamma_tpu.config import SearchParams
    from gamma_tpu.index.ivfpq import IVFPQIndex
    from gamma_tpu.vector.raw_store import RawVectorStore

    x = corpus_medium.copy()
    n = x.shape[0]
    store = RawVectorStore("v", x.shape[1])
    store.add(x)
    store.flush_device()
    idx = IVFPQIndex(store, {"ncentroids": 64, "nsubvector": 8,
                             "metric_type": "InnerProduct"})
    idx.train(x)
    ids = np.arange(n, dtype=np.int64)
    idx.add(x, ids, ids)
    sp = SearchParams.from_dict({"scan_mode": "dense", "recall_num": 100,
                                 "metric_type": "InnerProduct"})
    q = jnp.asarray(x[:4])
    zeros = jnp.asarray(np.zeros(n + 64, np.float32))
    d1, doc1, _ = idx.search(q, zeros, sp, 10)
    d2, doc2, _ = idx.search(q, zeros, sp, 10, validity_n=n)
    assert (np.asarray(doc1) == np.asarray(doc2)).all()
    # update doc 0: tombstone + re-append with a new vector; the fast
    # path must see only the new copy
    x0 = x[1] * 0.5
    idx.delete(np.array([0]))
    store.update(np.array([0]), x0[None, :])
    store.flush_device()
    idx.add(x0[None, :], np.array([0]), np.array([0]))
    # IP has no self-retrieval guarantee (bigger-norm rows can beat the
    # query's own doc) — assert fast vs penalty-path parity instead:
    # both must agree on the post-update state (one live copy, new code)
    qn = jnp.asarray(x0[None, :])
    d3, doc3, _ = idx.search(qn, zeros, sp, 10, validity_n=n)
    d4, doc4, _ = idx.search(qn, zeros, sp, 10)
    assert (np.asarray(doc3) == np.asarray(doc4)).all()
    np.testing.assert_allclose(np.asarray(d3), np.asarray(d4),
                               rtol=1e-5, atol=1e-4)
    docs_all = np.asarray(idx.search(qn, zeros, sp, 100,
                                     validity_n=n)[1])[0]
    assert (docs_all == 0).sum() <= 1


def test_split_commit_parity(corpus_medium, monkeypatch):
    """The big-corpus two-dispatch commit (mirror first, then posting
    state) must produce the same index as the fused single-dispatch
    commit."""
    import jax.numpy as jnp
    from gamma_tpu import index as _ix
    from gamma_tpu.config import SearchParams
    from gamma_tpu.index import ivfpq as ivfpq_mod
    from gamma_tpu.vector.raw_store import RawVectorStore

    x = corpus_medium
    n = x.shape[0]
    outs = []
    for split in (False, True):
        monkeypatch.setattr(ivfpq_mod, "SPLIT_COMMIT_BYTES",
                            0 if split else (1 << 30))
        store = RawVectorStore("v", x.shape[1])
        store.add(x)
        store.flush_device()
        idx = ivfpq_mod.IVFPQIndex(store, {"ncentroids": 64,
                                           "nsubvector": 8})
        idx.train(x)
        ids = np.arange(n, dtype=np.int64)
        idx.add(x, ids, ids)
        idx.delete(np.array([3]))
        sp = SearchParams.from_dict({"scan_mode": "dense",
                                     "recall_num": 100})
        d, doc, _ = idx.search(jnp.asarray(x[:8]),
                               jnp.asarray(np.zeros(n + 64, np.float32)),
                               sp, 10, validity_n=n)
        outs.append((np.asarray(d), np.asarray(doc)))
    assert (outs[0][1] == outs[1][1]).all()
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-6)


def test_release_recon_serves_gather(built, rng_mod):
    """release_recon drops the dense mirror (capacity-tier operating
    point): search auto-routes to gather mode and stays correct."""
    import copy
    x, store, idx, pen = built
    # work on a shallow copy so module-scoped fixture state survives
    idx2 = copy.copy(idx)
    idx2.release_recon()
    assert idx2.scan_mode(SearchParams.from_dict({})) == "gather"
    q = jnp.asarray(x[:8])
    d, docs, _ = idx2.search(q, pen, SearchParams.from_dict(
        {"recall_num": 64, "has_rank": True}), 10)
    docs = np.asarray(docs)
    assert (docs[:, 0] == np.arange(8)).mean() >= 0.9  # self-retrieval


def test_build_sq_sidecar_posthoc_matches_ingest(rng_mod):
    """Capacity-tier promotion: an index built with the SQ8 sidecar
    DISABLED during ingest (gather_payload="pq"), then promoted via
    build_sq_sidecar(), must produce the same sidecar contents (same
    quantized codes for live slots) and the same gather-mode search
    results as one that maintained the sidecar at ingest time — the
    10M bench relies on this to stay inside device memory."""
    rng = np.random.default_rng(21)
    n, d, nlist = 6000, 64, 32
    centers = rng.normal(size=(48, d)).astype(np.float32)
    x = (centers[rng.integers(0, 48, n)]
         + 0.15 * rng.normal(size=(n, d))).astype(np.float32)
    vids = np.arange(n, dtype=np.int64)

    def build(payload):
        store = RawVectorStore(f"v_{payload}", d)
        store.add(x)
        store.flush_device()
        idx = IVFPQIndex(store, {"ncentroids": nlist, "nsubvector": 16,
                                 "nprobe": 8, "gather_payload": payload})
        idx.train(x)
        idx.add(x, vids, vids)
        return idx

    ref = build("sq8")
    assert ref.sq_active
    promoted = build("pq")
    assert not promoted.sq_active
    assert promoted.build_sq_sidecar()
    assert promoted.sq_active

    # scale/off were fitted on different samples; refit equality is not
    # required — reuse ref's fit so codes compare level-for-level.
    # (Bit-exactness is NOT the contract: the two paths compile into
    # different fused graphs whose f32 rounding can flip codes sitting
    # exactly on a quantization boundary by one level.)
    promoted.sq_scale, promoted.sq_off = ref.sq_scale, ref.sq_off
    promoted.sq_codes = promoted.sq_norms = None
    assert promoted.build_sq_sidecar()
    lens = np.asarray(ref.state.lens)
    rc = np.asarray(ref.sq_codes).astype(np.int16)
    pc = np.asarray(promoted.sq_codes).astype(np.int16)
    rn, pn = np.asarray(ref.sq_norms), np.asarray(promoted.sq_norms)
    in_len = (np.arange(rc.shape[1])[None, :, None]
              < lens[:, None, None])
    diff = np.abs(rc - pc)[np.broadcast_to(in_len, rc.shape)]
    assert diff.max() <= 1, f"codes differ by >1 level: {diff.max()}"
    assert (diff != 0).mean() < 0.10, \
        f"too many boundary flips: {(diff != 0).mean():.3f}"
    live2 = np.arange(rn.shape[1])[None, :] < lens[:, None]
    np.testing.assert_allclose(rn[live2], pn[live2], rtol=2e-2)

    q = jnp.asarray(x[:16])
    pen = jnp.zeros(n, np.float32)
    sp = SearchParams.from_dict({"scan_mode": "gather", "recall_num": 64,
                                 "has_rank": True})
    d_r, doc_r, _ = ref.search(q, pen, sp, 10)
    d_p, doc_p, _ = promoted.search(q, pen, sp, 10)
    doc_r, doc_p = np.asarray(doc_r), np.asarray(doc_p)
    overlap = np.mean([len(set(doc_r[b]) & set(doc_p[b])) / 10
                       for b in range(doc_r.shape[0])])
    assert overlap >= 0.9, f"ingest vs promoted top-10 overlap {overlap}"


def test_build_sq_sidecar_own_fit_recall(rng_mod):
    """The promotion path's OWN scale/off fit (sampled from live
    residuals) serves gather search at healthy recall."""
    rng = np.random.default_rng(22)
    n, d, nlist = 6000, 64, 32
    centers = rng.normal(size=(48, d)).astype(np.float32)
    x = (centers[rng.integers(0, 48, n)]
         + 0.15 * rng.normal(size=(n, d))).astype(np.float32)
    vids = np.arange(n, dtype=np.int64)
    store = RawVectorStore("v_ownfit", d)
    store.add(x)
    store.flush_device()
    idx = IVFPQIndex(store, {"ncentroids": nlist, "nsubvector": 16,
                             "nprobe": 8, "gather_payload": "pq"})
    idx.train(x)
    idx.add(x, vids, vids)
    idx.release_recon()
    assert idx.build_sq_sidecar()
    q = jnp.asarray(x[rng.integers(0, n, 32)])
    pen = jnp.zeros(n, np.float32)
    sp = SearchParams.from_dict({"recall_num": 64, "has_rank": True})
    _, docs, _ = idx.search(q, pen, sp, 10)
    docs = np.asarray(docs)
    want = exact_topk(x, np.asarray(q), 10)
    recall = np.mean([len(set(docs[b]) & set(want[b])) / 10
                      for b in range(32)])
    assert recall >= 0.8, f"promoted-sidecar recall@10 = {recall}"


def test_cap_eff_trim_matches_full_scan(built, rng_mod):
    """cap_eff watermark trimming must be invisible in results: the
    slots past ladder(max_len) are dead padding (lens never exceed the
    watermark), so the trimmed and untrimmed scans see identical live
    candidates (ops/ivf_scan._trim_state)."""
    from gamma_tpu.ops import ivf_scan
    x, store, idx, pen = built
    q = jnp.asarray(x[rng_mod.integers(0, x.shape[0], 16)].copy())
    ce = idx._cap_eff()
    assert ce <= idx.state.cap
    args = (idx.state, idx.centroids, idx.cent_norms, idx.pq, q, pen,
            store.device)
    kw = dict(nprobe=8, recall_num=64, k=10, metric="l2", rerank=True)
    d0, doc0, vid0 = ivf_scan.ivfpq_search(*args, cap_eff=0, **kw)
    d1, doc1, vid1 = ivf_scan.ivfpq_search(*args, cap_eff=ce, **kw)
    np.testing.assert_array_equal(np.asarray(doc0), np.asarray(doc1))
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), rtol=1e-6)


def test_sq_sidecar_ladder_alloc_and_growth():
    """The SQ8 sidecar allocates at ladder(max_len), NOT the posting
    cap (the 3x presize slack cost ~1.7 GB of dead device memory at
    10M), and must
    GROW before any append past its width — a scatter past the sidecar
    width would drop rows silently and lose recall."""
    rng = np.random.default_rng(5)
    n, d, nlist = 4000, 64, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    store = RawVectorStore("v_ladder", d)
    store.add(x)
    store.flush_device()
    # posting cap presized far beyond fill: 4096 slots/list
    idx = IVFPQIndex(store, {"ncentroids": nlist, "nsubvector": 16,
                             "nprobe": nlist, "bucket_init_size": 4096,
                             "gather_payload": "sq8"})
    idx.train(x[:2000])
    vids = np.arange(n, dtype=np.int64)
    idx.add(x, vids, vids)
    assert idx.sq_active
    assert idx.state.cap == 4096
    ce = idx._cap_eff()
    assert idx.sq_codes.shape[1] == ce < idx.state.cap
    assert ce >= int(np.asarray(idx.state.lens).max())

    # every row must be findable through the sidecar scan (no dropped
    # scatters across the ladder growth steps 256 -> ce)
    sp = SearchParams.from_dict({"scan_mode": "gather", "recall_num": 32,
                                 "has_rank": True})
    pen = jnp.zeros(n, np.float32)
    sel = rng.integers(0, n, 64)
    _, docs, _ = idx.search(jnp.asarray(x[sel]), pen, sp, 1)
    hit = np.mean(np.asarray(docs)[:, 0] == sel)
    assert hit >= 0.95, f"self-retrieval through sidecar: {hit}"


def test_compact_with_narrow_sidecar():
    """compact_state_with must keep a NARROWER-than-cap sidecar
    slot-aligned with the compacted posting lists."""
    rng = np.random.default_rng(6)
    n, d, nlist = 3000, 64, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    store = RawVectorStore("v_csq", d)
    store.add(x)
    store.flush_device()
    idx = IVFPQIndex(store, {"ncentroids": nlist, "nsubvector": 16,
                             "nprobe": nlist, "bucket_init_size": 2048,
                             "gather_payload": "sq8"})
    idx.train(x[:1500])
    vids = np.arange(n, dtype=np.int64)
    idx.add(x, vids, vids)
    assert idx.sq_active and idx.sq_codes.shape[1] < idx.state.cap
    # tombstone 40% then compact
    dead = rng.choice(n, int(0.4 * n), replace=False)
    idx.delete(dead.astype(np.int64))
    idx.compact()
    assert idx.sq_codes.shape[1] < idx.state.cap
    live = np.setdiff1d(np.arange(n), dead)
    sp = SearchParams.from_dict({"scan_mode": "gather", "recall_num": 32,
                                 "has_rank": True})
    pen = jnp.zeros(n, np.float32)
    sel = rng.choice(live, 64, replace=False)
    _, docs, _ = idx.search(jnp.asarray(x[sel]), pen, sp, 1)
    hit = np.mean(np.asarray(docs)[:, 0] == sel)
    assert hit >= 0.95, f"post-compact self-retrieval: {hit}"
    # deleted rows must stay gone
    _, docs_d, _ = idx.search(jnp.asarray(x[dead[:64]]), pen, sp, 1)
    assert not np.isin(np.asarray(docs_d)[:, 0], dead).any()


def test_hnsw_quantizer_param_rejected():
    """The reference accepts an "hnsw" coarse-quantizer param block
    (gamma_index_ivfpq.cc:146-156); this engine substitutes flat matmul
    assignment and must REJECT the param loudly, not ignore it."""
    store = RawVectorStore("vec", 16)
    with pytest.raises(ValueError, match="hnsw"):
        IVFPQIndex(store, {"ncentroids": 16, "nsubvector": 4,
                           "hnsw": {"nlinks": 32, "efSearch": 64}})
    with pytest.raises(ValueError, match="quantizer_type"):
        IVFPQIndex(store, {"ncentroids": 16, "nsubvector": 4,
                           "quantizer_type": "hnsw"})
    # explicit "flat" (the substitution itself) stays accepted
    IVFPQIndex(store, {"ncentroids": 16, "nsubvector": 4,
                       "quantizer_type": "flat"})


def test_released_mirror_guard(rng_mod):
    """A released device mirror must fail loudly when a dense scan or a
    gather rerank would read it (XLA clamps OOB gathers — without the
    guard the result is silently wrong, not an error)."""
    rng = rng_mod
    n, d = 3000, 32
    x = rng.normal(size=(n, d)).astype(np.float32)
    store = RawVectorStore("vec", d)
    store.add(x)
    store.flush_device()
    idx = IVFPQIndex(store, {"ncentroids": 16, "nsubvector": 8,
                             "nprobe": 8, "gather_payload": "pq"})
    idx.train(x)
    vids = np.arange(n, dtype=np.int64)
    idx.add(x, vids, vids)
    pen = jnp.zeros(n, np.float32)
    q = jnp.asarray(x[:4])
    store.release_device()
    assert store.released
    with pytest.raises(RuntimeError, match="released"):
        idx.search(q, pen, SearchParams.from_dict(
            {"scan_mode": "dense"}), 5)
    with pytest.raises(AssertionError, match="released"):
        idx.search(q, pen, SearchParams.from_dict(
            {"scan_mode": "gather", "has_rank": True}), 5)
    # no-rerank gather stays legal (reads only codes, never the mirror)
    d_, docs, _ = idx.search(q, pen, SearchParams.from_dict(
        {"scan_mode": "gather", "has_rank": False}), 5)
    assert (np.asarray(docs)[:, 0] == np.arange(4)).mean() >= 0.75
    # flush_device re-mirrors and clears the flag
    store.flush_device()
    assert not store.released
    idx.search(q, pen, SearchParams.from_dict({"scan_mode": "dense"}), 5)


def test_sq_rerank_path(built, rng_mod):
    """sp.sq_rerank engages an exact rerank on the SQ8 tier: distances
    come out f32-exact against the mirror rows and recall can only
    improve vs the rerank-free scan."""
    x, store, idx, pen = built
    assert idx.sq_active
    q = jnp.asarray(x[:16])
    sp0 = SearchParams.from_dict({"scan_mode": "gather",
                                  "recall_num": 64})
    sp1 = SearchParams.from_dict({"scan_mode": "gather",
                                  "recall_num": 64, "sq_rerank": True})
    d0, docs0, _ = idx.search(q, pen, sp0, 10)
    d1, docs1, _ = idx.search(q, pen, sp1, 10)
    docs0, docs1 = np.asarray(docs0), np.asarray(docs1)
    # self-retrieval survives both
    assert (docs1[:, 0] == np.arange(16)).mean() >= 0.9
    # reranked distances are exact distances to the mirror rows
    rows = store.header(0, store.n)
    d1 = np.asarray(d1)
    for i in range(4):
        ref = np.sum((x[i].astype(np.float64)
                      - rows[docs1[i, 0]].astype(np.float64)) ** 2)
        np.testing.assert_allclose(d1[i, 0], ref, rtol=2e-2, atol=1e-2)
    # heavy overlap with the rerank-free tier (both near-exact)
    ov = np.mean([len(set(docs0[i]) & set(docs1[i])) / 10
                  for i in range(16)])
    assert ov >= 0.85, ov
    # a released mirror falls back to the rerank-free scan, not garbage
    import copy
    idx2 = copy.copy(idx)
    st2 = copy.copy(store)
    idx2.store = st2
    st2.released = True
    d2, docs2, _ = idx2.search(q, pen, sp1, 10)
    assert (np.asarray(docs2)[:, 0] == np.arange(16)).mean() >= 0.9
