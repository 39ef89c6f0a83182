"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Validates that sharding inverted lists + raw rows over the "l" axis (and
queries over "q") reproduces the single-chip search results, and that the
data-parallel k-means matches the single-device k-means objective.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import make_blobs

from gamma_tpu.index.ivfpq import IVFPQIndex
from gamma_tpu.ops import ivf_scan
from gamma_tpu.ops.distances import BIG, pairwise_l2
from gamma_tpu.parallel import (build_mesh, shard_ivfpq,
                                sharded_flat_search_fn,
                                sharded_ivfpq_search_fn, sharded_kmeans_fit)
from gamma_tpu.vector.raw_store import RawVectorStore


def _build_index(corpus, nlist=64, m=8):
    store = RawVectorStore("vec", corpus.shape[1])
    store.add(corpus)
    store.flush_device()
    idx = IVFPQIndex(store, {"ncentroids": nlist, "nsubvector": m,
                             "nprobe": 16})
    idx.train(corpus)
    n = corpus.shape[0]
    ids = np.arange(n, dtype=np.int64)
    idx.add(corpus, ids, ids)
    return store, idx


@pytest.fixture(scope="module")
def built(corpus_medium):
    return _build_index(corpus_medium)


def _single_chip(store, idx, q, penalty, nprobe, recall, k, rerank=True):
    return ivf_scan.ivfpq_search(
        idx.state, idx.centroids, idx.cent_norms, idx.pq,
        q, penalty, store.device,
        nprobe=nprobe, recall_num=recall, k=k, metric="l2", rerank=rerank)


def test_sharded_matches_single_chip(built, rng):
    store, idx = built
    mesh = build_mesh(n_list_shards=4, n_query_shards=2)
    sh = shard_ivfpq(mesh, idx.state, idx.centroids, idx.cent_norms,
                     idx.pq, store.device)
    nprobe, recall, k = 16, 64, 10
    penalty = jnp.zeros(store.n + 64, jnp.float32)
    q = jnp.asarray(rng.normal(size=(16, store.d)).astype(np.float32))

    # local_probe=nprobe → provably identical candidate set
    search = sharded_ivfpq_search_fn(
        mesh, nprobe=nprobe, recall_num=recall, k=k, metric="l2",
        rerank=True, local_probe=nprobe, v_per_shard=sh.v_per_shard)
    sd, sdoc, svid = jax.tree.map(np.asarray, search(sh, q, penalty))
    rd, rdoc, rvid = jax.tree.map(
        np.asarray, _single_chip(store, idx, q, penalty, nprobe, recall, k))
    np.testing.assert_allclose(sd, rd, rtol=1e-4, atol=1e-3)
    # docids must agree wherever distances are distinct
    agree = (sdoc == rdoc).mean()
    assert agree > 0.95, f"docid agreement {agree}"


def test_sharded_default_local_probe_recall(built, rng):
    """Default (work-split) local_probe loses almost nothing vs exact."""
    store, idx = built
    mesh = build_mesh(n_list_shards=8, n_query_shards=1)
    sh = shard_ivfpq(mesh, idx.state, idx.centroids, idx.cent_norms,
                     idx.pq, store.device)
    penalty = jnp.zeros(store.n + 64, jnp.float32)
    q = jnp.asarray(rng.normal(size=(8, store.d)).astype(np.float32))
    search = sharded_ivfpq_search_fn(
        mesh, nprobe=16, recall_num=64, k=10, metric="l2", rerank=True,
        v_per_shard=sh.v_per_shard)
    sd, sdoc, _ = jax.tree.map(np.asarray, search(sh, q, penalty))
    rd, rdoc, _ = jax.tree.map(
        np.asarray, _single_chip(store, idx, q, penalty, 16, 64, 10))
    overlap = np.mean([
        len(set(sdoc[i]) & set(rdoc[i])) / 10 for i in range(8)])
    assert overlap >= 0.9, f"top-10 overlap {overlap}"


def test_sharded_respects_penalty(built, rng):
    store, idx = built
    mesh = build_mesh(n_list_shards=4, n_query_shards=2)
    sh = shard_ivfpq(mesh, idx.state, idx.centroids, idx.cent_norms,
                     idx.pq, store.device)
    pen = np.zeros(store.n + 64, np.float32)
    pen[::2] = BIG   # mask all even docids
    q = jnp.asarray(rng.normal(size=(8, store.d)).astype(np.float32))
    search = sharded_ivfpq_search_fn(
        mesh, nprobe=16, recall_num=64, k=10, metric="l2", rerank=True,
        local_probe=16, v_per_shard=sh.v_per_shard)
    _, sdoc, _ = jax.tree.map(
        np.asarray, search(sh, q, jnp.asarray(pen)))
    live = sdoc[sdoc >= 0]
    assert live.size and np.all(live % 2 == 1)


def test_sharded_flat_exact(corpus_small, rng):
    n, d = corpus_small.shape
    mesh = build_mesh(n_list_shards=4, n_query_shards=2)
    s = 4
    v_pad = -(-n // s) * s
    raw = np.zeros((v_pad, d), np.float32)
    raw[:n] = corpus_small
    norms = np.sum(raw.astype(np.float64) ** 2, -1).astype(np.float32)
    pen = np.zeros(v_pad, np.float32)
    pen[n:] = BIG
    from jax.sharding import NamedSharding, PartitionSpec as P
    raw_d = jax.device_put(raw, NamedSharding(mesh, P("l", None)))
    norms_d = jax.device_put(norms, NamedSharding(mesh, P("l")))
    pen_d = jax.device_put(pen, NamedSharding(mesh, P("l")))
    q = rng.normal(size=(16, d)).astype(np.float32)
    fn = sharded_flat_search_fn(mesh, k=5, metric="l2",
                                v_per_shard=v_pad // s)
    sd, sid = jax.tree.map(np.asarray, fn(raw_d, norms_d, jnp.asarray(q),
                                          pen_d))
    # numpy oracle
    ref = ((q[:, None, :] - corpus_small[None]) ** 2).sum(-1)
    oid = np.argsort(ref, axis=1)[:, :5]
    assert (np.sort(sid, 1) == np.sort(oid, 1)).mean() > 0.99


def test_sharded_kmeans_matches_single():
    # local corpus draw: the 5% objective bar is sensitive to k-means
    # local minima, which depend on the exact draw — the session rng
    # makes this order-flaky under `pytest -k` subsets (conftest
    # invariant)
    corpus_small = make_blobs(np.random.default_rng(11), 2000, 32)
    k = 16
    init = corpus_small[:k]
    mesh = build_mesh(n_list_shards=4, n_query_shards=2)
    cents, counts = sharded_kmeans_fit(mesh, corpus_small, init, k=k,
                                       iters=8)
    cents = np.asarray(cents)
    assert np.asarray(counts).sum() == corpus_small.shape[0]
    # sharded = plain data-parallel Lloyd; compare against the
    # single-device Lloyd WITHOUT the split-biggest rebalance rounds
    # (same algorithm, same init → objectives must agree tightly; the
    # rebalancing variant finds different local minima on some draws)
    from gamma_tpu.ops import kmeans as km
    ref_c, _ = km.kmeans_fit(jnp.asarray(corpus_small), jnp.asarray(init),
                             k=k, iters=8, rebalance=0)
    def obj(c):
        d = np.asarray(pairwise_l2(jnp.asarray(corpus_small),
                                   jnp.asarray(c)))
        return d.min(axis=1).mean()
    assert obj(cents) <= obj(np.asarray(ref_c)) * 1.01


def test_engine_sharded_search(tmp_path, rng):
    """Engine-level multi-chip serving: snapshot onto the mesh, search
    parity with single-chip, filters respected."""
    from gamma_tpu import (Doc, EngineConfig, FieldInfo, GammaEngine,
                           RangeFilter, Request, TableInfo, VectorInfo,
                           VectorQuery)
    from gamma_tpu.config import DataType
    eng = GammaEngine(EngineConfig(path=str(tmp_path)))
    eng.create_table(TableInfo(
        name="sh", fields=[FieldInfo("price", DataType.FLOAT, True)],
        vectors=[VectorInfo("vec", 32)], indexing_size=1500,
        retrieval_types=["IVFPQ"],
        retrieval_params=[{"ncentroids": 32, "nsubvector": 8,
                           "nprobe": 32}]))
    x = rng.normal(size=(2000, 32)).astype(np.float32)
    eng.add_or_update_docs([
        Doc(key=f"k{i}", fields={"price": float(i)},
            vectors={"vec": x[i]}) for i in range(2000)])
    eng.flush()
    ref = eng.search(Request(topn=5, vec_fields=[VectorQuery("vec",
                                                             x[:8])]))
    eng.enable_sharded_search(n_list_shards=4, n_query_shards=2)
    got = eng.search(Request(topn=5, vec_fields=[VectorQuery("vec",
                                                             x[:8])]))
    for b in range(8):
        r = [it.docid for it in ref.results[b].result_items]
        g = [it.docid for it in got.results[b].result_items]
        assert g[0] == b == r[0]
        assert len(set(r) & set(g)) >= 3
    # filters flow through the replicated penalty
    fr = eng.search(Request(
        topn=5, vec_fields=[VectorQuery("vec", x[:8])],
        range_filters=[RangeFilter("price", 1000.0, 1999.0)]))
    for sr in fr.results:
        for it in sr.result_items:
            assert 1000 <= it.docid <= 1999
    eng.disable_sharded_search()
    eng.close()


def test_sharded_dense_matches_single(built):
    """Row-sharded dense scan + psum rerank == single-chip dense mode.

    Queries come from a LOCAL rng (not the session fixture): both paths
    run ApproxTopK with different candidate pools, so a near-tie at the
    recall_num boundary can legitimately rank differently — a local
    seed keeps the draw independent of which tests consumed the session
    rng first (this test was order-flaky under `pytest -k` subsets).
    Top-1 parity is asserted on host-recomputed exact distances of each
    path's top-1 PICK — id near-ties may legitimately differ, but both
    picks must be (near-)equally close to the query, so a real ranking
    regression fails regardless of which ids flipped."""
    from gamma_tpu.config import SearchParams
    from gamma_tpu.parallel import shard_dense, sharded_dense_search_fn
    store, idx = built
    rng = np.random.default_rng(1234)
    mesh = build_mesh(n_list_shards=4, n_query_shards=2)
    sd = shard_dense(mesh, idx.recon, idx.recon_norms, idx.recon_valid,
                     store.device)
    fn = sharded_dense_search_fn(mesh, recall_num=64, k=10, metric="l2",
                                 rerank=True,
                                 rows_per_shard=sd.rows_per_shard)
    q = jnp.asarray(rng.normal(size=(16, store.d)).astype(np.float32))
    pen = jnp.zeros(sd.recon.shape[0], jnp.float32)
    d, vids = jax.tree.map(np.asarray, fn(sd, q, pen, q))

    sp = SearchParams.from_dict({"scan_mode": "dense", "recall_num": 64})
    pen1 = jnp.zeros(store.n + 64, jnp.float32)
    rd, rdoc, _ = idx.search(q, pen1, sp, 10)
    rd, rdoc = np.asarray(rd), np.asarray(rdoc)
    overlap = np.mean([len(set(vids[i]) & set(rdoc[i])) / 10
                       for i in range(16)])
    assert overlap >= 0.9, overlap
    # distance parity regardless of id choice: recompute both paths'
    # top-1 distances from the HOST store (independent of either path's
    # reported values) — a sharded regression that flips top-1 to a
    # genuinely farther row fails even when ids legitimately near-tie
    qh = np.asarray(q, np.float64)
    xs = store.header(0, store.n).astype(np.float64)
    d_sh = np.sum((qh - xs[vids[:, 0]]) ** 2, axis=1)
    d_single = np.sum((qh - xs[rdoc[:, 0]]) ** 2, axis=1)
    # 1e-2 rtol: both paths rerank from the bf16 mirror, so a genuine
    # near-tie flip implies exact distances within ~2x bf16 perturbation
    np.testing.assert_allclose(d_sh, d_single, rtol=1e-2, atol=1e-2)
    # and each path's reported top-1 distance matches its own pick
    # (reported values come from bf16 rows; host recompute is f32-exact)
    np.testing.assert_allclose(d[:, 0], d_sh, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(rd[:, 0], d_single, rtol=1e-2, atol=1e-2)


def test_engine_sharded_dense_dispatch(tmp_path, rng):
    """Engine sharded mode uses the dense snapshot when scan mode is
    dense, with parity against the pre-sharding results."""
    from gamma_tpu import (Doc, EngineConfig, FieldInfo, GammaEngine,
                           Request, TableInfo, VectorInfo, VectorQuery)
    from gamma_tpu.config import DataType
    eng = GammaEngine(EngineConfig(path=str(tmp_path)))
    eng.create_table(TableInfo(
        name="sd", fields=[FieldInfo("p", DataType.FLOAT)],
        vectors=[VectorInfo("vec", 32)], indexing_size=1000,
        retrieval_types=["IVFPQ"],
        retrieval_params=[{"ncentroids": 32, "nsubvector": 8}]))
    x = rng.normal(size=(1500, 32)).astype(np.float32)
    eng.add_or_update_docs([Doc(key=f"k{i}", fields={"p": 0.0},
                                vectors={"vec": x[i]})
                            for i in range(1500)])
    eng.flush()
    req = Request(topn=5, vec_fields=[VectorQuery("vec", x[:8])],
                  retrieval_params={"scan_mode": "dense"})
    ref = eng.search(req)
    eng.enable_sharded_search(n_list_shards=4, n_query_shards=2)
    got = eng.search(req)
    for b in range(8):
        g = [it.docid for it in got.results[b].result_items]
        r = [it.docid for it in ref.results[b].result_items]
        assert g[0] == r[0] == b
    eng.close()


def test_engine_sharded_single_query_padding(tmp_path, rng):
    """A 1-query request on an n_query_shards=2 mesh must pad, not raise
    a sharding error (shard_map needs B divisible by the q axis)."""
    from gamma_tpu import (Doc, EngineConfig, FieldInfo, GammaEngine,
                           Request, TableInfo, VectorInfo, VectorQuery)
    from gamma_tpu.config import DataType
    eng = GammaEngine(EngineConfig(path=str(tmp_path)))
    eng.create_table(TableInfo(
        name="p1", fields=[FieldInfo("p", DataType.FLOAT)],
        vectors=[VectorInfo("vec", 32)], indexing_size=900,
        retrieval_types=["IVFPQ"],
        retrieval_params=[{"ncentroids": 16, "nsubvector": 8}]))
    x = rng.normal(size=(1200, 32)).astype(np.float32)
    eng.add_or_update_docs([Doc(key=f"k{i}", fields={"p": 0.0},
                                vectors={"vec": x[i]})
                            for i in range(1200)])
    eng.flush()
    eng.enable_sharded_search(n_list_shards=4, n_query_shards=2)
    for nq in (1, 3):   # neither divides 2
        r = eng.search(Request(topn=5,
                               vec_fields=[VectorQuery("vec", x[:nq])]))
        assert len(r.results) == nq
        for b in range(nq):
            assert r.results[b].result_items[0].docid == b
    eng.close()


def test_engine_sharded_no_tail_duplicates(tmp_path, rng):
    """Rows indexed between enable_sharded_search() and the lazy snapshot
    build must not appear twice (snapshot extent is recorded at build
    time, not enable time)."""
    from gamma_tpu import (Doc, EngineConfig, FieldInfo, GammaEngine,
                           Request, TableInfo, VectorInfo, VectorQuery)
    from gamma_tpu.config import DataType
    eng = GammaEngine(EngineConfig(path=str(tmp_path)))
    eng.create_table(TableInfo(
        name="nd", fields=[FieldInfo("p", DataType.FLOAT)],
        vectors=[VectorInfo("vec", 32)], indexing_size=800,
        retrieval_types=["IVFPQ"],
        retrieval_params=[{"ncentroids": 16, "nsubvector": 8}]))
    x = rng.normal(size=(1400, 32)).astype(np.float32)
    eng.add_or_update_docs([Doc(key=f"k{i}", fields={"p": 0.0},
                                vectors={"vec": x[i]})
                            for i in range(1000)])
    eng.flush()
    eng.enable_sharded_search(n_list_shards=4, n_query_shards=1)
    # ingest + flush BEFORE the first sharded search: these rows land in
    # the live index; the snapshot (built lazily below) includes them too
    eng.add_or_update_docs([Doc(key=f"k{i}", fields={"p": 0.0},
                                vectors={"vec": x[i]})
                            for i in range(1000, 1400)])
    eng.flush()
    r = eng.search(Request(topn=10,
                           vec_fields=[VectorQuery("vec", x[1200])]))
    got = [it.docid for it in r.results[0].result_items]
    assert got[0] == 1200
    assert len(got) == len(set(got)), f"duplicate docids: {got}"
    eng.close()


def test_sharded_gather_rerank_opq_space(rng):
    """With OPQ the exact rerank must compare raw rows against the
    UNROTATED query; self-retrieval distance is then ~0."""
    corpus = rng.normal(size=(4096, 32)).astype(np.float32)
    store = RawVectorStore("vec", 32)
    store.add(corpus)
    store.flush_device()
    idx = IVFPQIndex(store, {"ncentroids": 32, "nsubvector": 8,
                             "nprobe": 32, "has_opq": True})
    idx.train(corpus)
    ids = np.arange(corpus.shape[0], dtype=np.int64)
    idx.add(corpus, ids, ids)
    mesh = build_mesh(n_list_shards=4, n_query_shards=2)
    sh = shard_ivfpq(mesh, idx.state, idx.centroids, idx.cent_norms,
                     idx.pq, store.device)
    q_raw = jnp.asarray(corpus[:8])
    q_rot = idx._rotate(q_raw)
    pen = jnp.zeros(store.n + 64, jnp.float32)
    fn = sharded_ivfpq_search_fn(
        mesh, nprobe=32, recall_num=64, k=5, metric="l2", rerank=True,
        local_probe=32, v_per_shard=sh.v_per_shard)
    d, doc, _ = jax.tree.map(np.asarray, fn(sh, q_rot, pen, q_raw))
    assert list(doc[:, 0]) == list(range(8))
    # exact rerank in the raw space → self-distance ~0 (bf16 rounding)
    assert np.all(d[:, 0] < 1e-2), d[:, 0]


def test_engine_sharded_realtime_tail(tmp_path, rng):
    """Docs ingested after the sharded snapshot stay searchable (served
    from the live index, merged by distance)."""
    from gamma_tpu import (Doc, EngineConfig, FieldInfo, GammaEngine,
                           Request, TableInfo, VectorInfo, VectorQuery)
    from gamma_tpu.config import DataType
    eng = GammaEngine(EngineConfig(path=str(tmp_path)))
    eng.create_table(TableInfo(
        name="rt", fields=[FieldInfo("p", DataType.FLOAT)],
        vectors=[VectorInfo("vec", 32)], indexing_size=800,
        retrieval_types=["IVFPQ"],
        retrieval_params=[{"ncentroids": 16, "nsubvector": 8}]))
    x = rng.normal(size=(1300, 32)).astype(np.float32)
    eng.add_or_update_docs([Doc(key=f"k{i}", fields={"p": 0.0},
                                vectors={"vec": x[i]})
                            for i in range(1000)])
    eng.flush()
    eng.enable_sharded_search(n_list_shards=4, n_query_shards=1)
    # ingest new docs AFTER the snapshot
    eng.add_or_update_docs([Doc(key=f"k{i}", fields={"p": 0.0},
                                vectors={"vec": x[i]})
                            for i in range(1000, 1300)])
    eng.flush()
    r = eng.search(Request(topn=3,
                           vec_fields=[VectorQuery("vec", x[1250])]))
    assert r.results[0].result_items[0].docid == 1250
    # snapshot-era docs still found too
    r2 = eng.search(Request(topn=3,
                            vec_fields=[VectorQuery("vec", x[10])]))
    assert r2.results[0].result_items[0].docid == 10
    eng.close()


def test_sharded_ivfsq_matches_single_chip(built, rng):
    """SQ8 capacity tier sharded over "l": with local_probe=nprobe the
    candidate set is provably identical to the single-chip ivfsq_search,
    and no rerank/psum step exists — exact distances merge once."""
    from gamma_tpu.parallel import shard_ivfsq, sharded_ivfsq_search_fn
    store, idx = built
    assert idx.sq_active
    mesh = build_mesh(n_list_shards=4, n_query_shards=2)
    cap_eff = idx._cap_eff()
    sh = shard_ivfsq(mesh, idx.state, idx.centroids, idx.cent_norms,
                     idx.sq_codes, idx.sq_norms, idx.sq_scale,
                     idx.sq_off, cap_eff=cap_eff)
    nprobe, k = 16, 10
    penalty = jnp.zeros(store.n + 64, jnp.float32)
    q = jnp.asarray(rng.normal(size=(16, store.d)).astype(np.float32))
    search = sharded_ivfsq_search_fn(mesh, nprobe=nprobe, k=k,
                                     metric="l2", local_probe=nprobe)
    sd, sdoc, svid = jax.tree.map(np.asarray, search(sh, q, penalty))
    rd, rdoc, rvid = jax.tree.map(np.asarray, ivf_scan.ivfsq_search(
        idx.state, idx.sq_codes, idx.sq_norms, idx.sq_scale, idx.sq_off,
        idx.centroids, idx.cent_norms, q, penalty,
        nprobe=nprobe, k=k, metric="l2", cap_eff=cap_eff))
    np.testing.assert_allclose(sd, rd, rtol=1e-4, atol=1e-3)
    agree = (sdoc == rdoc).mean()
    assert agree > 0.95, f"docid agreement {agree}"


def test_sharded_ivfsq_respects_penalty(built, rng):
    from gamma_tpu.parallel import shard_ivfsq, sharded_ivfsq_search_fn
    store, idx = built
    mesh = build_mesh(n_list_shards=8, n_query_shards=1)
    sh = shard_ivfsq(mesh, idx.state, idx.centroids, idx.cent_norms,
                     idx.sq_codes, idx.sq_norms, idx.sq_scale,
                     idx.sq_off, cap_eff=idx._cap_eff())
    pen = np.zeros(store.n + 64, np.float32)
    pen[::2] = BIG   # mask all even docids
    q = jnp.asarray(rng.normal(size=(8, store.d)).astype(np.float32))
    search = sharded_ivfsq_search_fn(mesh, nprobe=16, k=10, metric="l2",
                                     local_probe=16)
    _, sdoc, _ = jax.tree.map(np.asarray, search(sh, q, jnp.asarray(pen)))
    live = sdoc[sdoc >= 0]
    assert live.size and np.all(live % 2 == 1)


def test_engine_sharded_sq8_gather(tmp_path, rng):
    """Engine-level sharded serving in GATHER mode routes through the
    SQ8 sharded path (exact scan, one collective merge): parity with
    single-chip, filters respected, realtime tail merged."""
    from gamma_tpu import (Doc, EngineConfig, FieldInfo, GammaEngine,
                           RangeFilter, Request, TableInfo, VectorInfo,
                           VectorQuery)
    from gamma_tpu.config import DataType
    eng = GammaEngine(EngineConfig(path=str(tmp_path)))
    eng.create_table(TableInfo(
        name="shq", fields=[FieldInfo("price", DataType.FLOAT, True)],
        vectors=[VectorInfo("vec", 32)], indexing_size=1500,
        retrieval_types=["IVFPQ"],
        retrieval_params=[{"ncentroids": 32, "nsubvector": 8,
                           "nprobe": 32, "scan_mode": "gather"}]))
    x = rng.normal(size=(2000, 32)).astype(np.float32)
    eng.add_or_update_docs([
        Doc(key=f"k{i}", fields={"price": float(i)},
            vectors={"vec": x[i]}) for i in range(2000)])
    eng.flush()
    model = eng.vm.index_for("vec")
    assert model.sq_active
    ref = eng.search(Request(topn=5, vec_fields=[VectorQuery("vec",
                                                             x[:8])]))
    eng.enable_sharded_search(n_list_shards=4, n_query_shards=2)
    got = eng.search(Request(topn=5, vec_fields=[VectorQuery("vec",
                                                             x[:8])]))
    assert eng._sharded.get("sq") is not None        # SQ8 path taken
    assert eng._sharded["index"] is None             # not the ADC path
    for b in range(8):
        r = [it.docid for it in ref.results[b].result_items]
        g = [it.docid for it in got.results[b].result_items]
        assert g[0] == b == r[0]
        assert len(set(r) & set(g)) >= 3
    fr = eng.search(Request(
        topn=5, vec_fields=[VectorQuery("vec", x[:8])],
        range_filters=[RangeFilter("price", 1000.0, 1999.0)]))
    for sr in fr.results:
        for it in sr.result_items:
            assert 1000 <= it.docid <= 1999
    # realtime tail: new docs after the snapshot still come back
    eng.add_or_update_docs([
        Doc(key=f"t{i}", fields={"price": 0.5},
            vectors={"vec": x[i] + 0.001}) for i in range(4)])
    eng.flush()
    tr = eng.search(Request(topn=3, vec_fields=[VectorQuery("vec",
                                                            x[:4])]))
    for b in range(4):
        docs = [it.docid for it in tr.results[b].result_items]
        assert 2000 + b in docs or b in docs
    eng.disable_sharded_search()
    eng.close()


def test_sharded_ivfsq_validity_matches_penalty(built, rng):
    """use_validity=True (no doc-space penalty gather) returns the same
    results as the zero-penalty path when nothing is deleted."""
    from gamma_tpu.parallel import shard_ivfsq, sharded_ivfsq_search_fn
    store, idx = built
    mesh = build_mesh(n_list_shards=4, n_query_shards=2)
    sh = shard_ivfsq(mesh, idx.state, idx.centroids, idx.cent_norms,
                     idx.sq_codes, idx.sq_norms, idx.sq_scale,
                     idx.sq_off, cap_eff=idx._cap_eff())
    q = jnp.asarray(rng.normal(size=(16, store.d)).astype(np.float32))
    pen = jnp.zeros(store.n + 64, jnp.float32)
    f_pen = sharded_ivfsq_search_fn(mesh, nprobe=16, k=10, metric="l2",
                                    local_probe=16)
    f_val = sharded_ivfsq_search_fn(mesh, nprobe=16, k=10, metric="l2",
                                    local_probe=16, use_validity=True)
    pd, pdoc, _ = jax.tree.map(np.asarray, f_pen(sh, q, pen))
    vd, vdoc, _ = jax.tree.map(np.asarray,
                               f_val(sh, q, pen, live_n=store.n))
    np.testing.assert_allclose(pd, vd, rtol=1e-5, atol=1e-5)
    assert (pdoc == vdoc).mean() > 0.98


def test_sharded_fastscan_matches_single(corpus_medium, rng):
    """Sharded FastScan (packed 4-bit codes through the shard body's
    packed branch) == single-chip ivfpqfs_search at local_probe=nprobe
    (provably identical candidate set)."""
    from gamma_tpu.index.ivfpq_fastscan import IVFPQFastScanIndex
    store = RawVectorStore("vecfs", corpus_medium.shape[1])
    store.add(corpus_medium)
    store.flush_device()
    fs = IVFPQFastScanIndex(store, {"ncentroids": 64, "nsubvector": 8,
                                    "nprobe": 16})
    fs.train(corpus_medium)
    n = corpus_medium.shape[0]
    ids = np.arange(n, dtype=np.int64)
    fs.add(corpus_medium, ids, ids)
    assert fs.packed_codes and fs.state.codes.shape[-1] == 4  # M/2 bytes

    mesh = build_mesh(n_list_shards=4, n_query_shards=2)
    sh = shard_ivfpq(mesh, fs.state, fs.centroids, fs.cent_norms,
                     fs.pq, store.device)
    nprobe, recall, k = 16, 64, 10
    penalty = jnp.zeros(store.n + 64, jnp.float32)
    q = jnp.asarray(rng.normal(size=(16, store.d)).astype(np.float32))
    search = sharded_ivfpq_search_fn(
        mesh, nprobe=nprobe, recall_num=recall, k=k, metric="l2",
        rerank=True, local_probe=nprobe, v_per_shard=sh.v_per_shard,
        packed=True, by_residual=fs.by_residual)
    sd, sdoc, _ = jax.tree.map(np.asarray, search(sh, q, penalty))
    rd, rdoc, _ = jax.tree.map(np.asarray, ivf_scan.ivfpqfs_search(
        fs.state, fs.centroids, fs.cent_norms, fs.pq, q, penalty,
        store.device, nprobe=nprobe, recall_num=recall, k=k,
        metric="l2", rerank=True, by_residual=fs.by_residual))
    np.testing.assert_allclose(sd, rd, rtol=1e-4, atol=1e-3)
    agree = (sdoc == rdoc).mean()
    assert agree > 0.95, f"docid agreement {agree}"


def test_sharded_fastscan_raw_coded(corpus_medium, rng):
    """by_residual=False (the reference's forced FastScan layout,
    gamma_index_ivfpqfs.cc:146) through the sharded body."""
    from gamma_tpu.index.ivfpq_fastscan import IVFPQFastScanIndex
    store = RawVectorStore("vecfr", corpus_medium.shape[1])
    store.add(corpus_medium)
    store.flush_device()
    fs = IVFPQFastScanIndex(store, {"ncentroids": 64, "nsubvector": 8,
                                    "nprobe": 16, "by_residual": False})
    fs.train(corpus_medium)
    n = corpus_medium.shape[0]
    ids = np.arange(n, dtype=np.int64)
    fs.add(corpus_medium, ids, ids)

    mesh = build_mesh(n_list_shards=8, n_query_shards=1)
    sh = shard_ivfpq(mesh, fs.state, fs.centroids, fs.cent_norms,
                     fs.pq, store.device)
    penalty = jnp.zeros(store.n + 64, jnp.float32)
    q = jnp.asarray(rng.normal(size=(8, store.d)).astype(np.float32))
    search = sharded_ivfpq_search_fn(
        mesh, nprobe=16, recall_num=64, k=10, metric="l2",
        rerank=True, local_probe=16, v_per_shard=sh.v_per_shard,
        packed=True, by_residual=False)
    sd, sdoc, _ = jax.tree.map(np.asarray, search(sh, q, penalty))
    rd, rdoc, _ = jax.tree.map(np.asarray, ivf_scan.ivfpqfs_search(
        fs.state, fs.centroids, fs.cent_norms, fs.pq, q, penalty,
        store.device, nprobe=16, recall_num=64, k=10,
        metric="l2", rerank=True, by_residual=False))
    np.testing.assert_allclose(sd, rd, rtol=1e-4, atol=1e-3)
    agree = (sdoc == rdoc).mean()
    assert agree > 0.95, f"docid agreement {agree}"
