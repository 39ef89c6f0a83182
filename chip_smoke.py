#!/usr/bin/env python3
"""End-to-end smoke run of gamma-tpu on NVIDIA GPUs.

    python chip_smoke.py                  one GPU
    python chip_smoke.py --devices 4      four GPUs: the sharded phase only
    python chip_smoke.py --cpu-rehearsal  every phase (the sharded one
                                          too) at toy sizes on the CPU,
                                          over 4 virtual devices

One GPU, through the entry points a user calls:

  device     JAX must find GPUs, or the run stops before any phase.
  ingest     a GammaEngine table behind gamma_tpu.server (in-process)
             with an indexed FLOAT and STRING field and one 128-d
             vector field under IVFPQ (ncentroids=2048, nsubvector=32 —
             the SIFT1M geometry); 1M seeded docs (bench.make_corpus)
             added in batches through GammaClient, auto-trained past
             indexing_size, flushed, INDEXED.
  serve      requests of 256 queries (topn=10, recall_num=100, has_rank)
             against a numpy float64 brute force: unfiltered, and with a
             range + term filter whose every hit must satisfy both.
  lifecycle  delete → the doc vanishes; dump, close, a fresh engine
             load → the same top-10.
  models     every registered retrieval model at 200k x 128 against its
             exact reference (BinaryIVF: tie-aware Hamming recall).

--devices 4: the 1M engine's enable_sharded_search(n_list_shards=4) in
dense and gather mode (SQ8 sidecar), and a 200k engine's with the PQ
gather payload (the sharded ADC body), each vs the same engine's
single-GPU answers, plus the realtime tail and a post-snapshot delete.

Every check that fails raises, and the process exits non-zero.  The last
line of a passing GPU run is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
A rehearsal never reports ok.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

FULL = dict(n=1_000_000, d=128, nlist=2048, m=32, nprobe=64, nq=256,
            n_requests=4, batch=20_000, n_models=200_000,
            nlist_models=1024)
TOY = dict(n=20_000, d=128, nlist=64, m=32, nprobe=16, nq=32,
           n_requests=2, batch=5_000, n_models=4_000, nlist_models=32)

K = 10
RECALL_NUM = 100
# bars: the reference's published IVFPQ figure at SIFT1M is 0.9902
# recall@10 (BASELINE.md); 0.95 only catches a broken model path
MAIN_RECALL_BAR = 0.99
MODEL_RECALL_BAR = 0.95
SHARDED_RECALL_SLACK = 0.005
# exact rerank vs float64: the rerank is elementwise f32 over 128 dims,
# so the relative error of a distance is ~1e-5; rtol 1e-4 leaves 10x
RERANK_RTOL = 1e-4
# dump/load: the reloaded mirror is bit-identical, but its padded row
# count may differ, and the GPU compiler may then pick another matmul
# algorithm, so a near-tie at rank 10 may flip
RELOAD_AGREEMENT = 0.999


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def say(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------
# plain references (numpy float64, independent of the package)
# ---------------------------------------------------------------------

def exact_topk(corpus, queries, k, metric="l2", mask=None, chunk=65536):
    """Exact top-k rows of `corpus` per query in float64 (ascending L2,
    or descending inner product); rows with mask False are excluded."""
    q = queries.astype(np.float64)
    qn = np.einsum("bd,bd->b", q, q)
    nq = q.shape[0]
    best_d = np.full((nq, k), np.inf)
    best_i = np.full((nq, k), -1, np.int64)
    for s in range(0, corpus.shape[0], chunk):
        c = corpus[s:s + chunk].astype(np.float64)
        if metric == "ip":
            dist = -(q @ c.T)
        else:
            dist = qn[:, None] - 2.0 * (q @ c.T) + np.einsum(
                "nd,nd->n", c, c)[None, :]
        if mask is not None:
            dist[:, ~mask[s:s + chunk]] = np.inf
        kk = min(k, dist.shape[1])
        part = np.argpartition(dist, kk - 1, axis=1)[:, :kk]
        cd = np.concatenate(
            [best_d, np.take_along_axis(dist, part, axis=1)], axis=1)
        ci = np.concatenate([best_i, part + s], axis=1)
        sel = np.argpartition(cd, k - 1, axis=1)[:, :k]
        best_d = np.take_along_axis(cd, sel, axis=1)
        best_i = np.take_along_axis(ci, sel, axis=1)
    order = np.argsort(best_d, axis=1)
    return np.take_along_axis(best_i, order, axis=1)


def recall_at_k(found, gt):
    return float(np.mean([len(set(found[i][:K].tolist())
                              & set(gt[i][:K].tolist())) / K
                          for i in range(gt.shape[0])]))


def ids_of(resp, nq):
    """Result keys (= corpus rows) per query → [nq, K] i64, -1 padded."""
    out = np.full((nq, K), -1, np.int64)
    check(len(resp.results) == nq,
          f"{len(resp.results)} results for {nq} queries")
    for i, sr in enumerate(resp.results):
        keys = [int(it.key) for it in sr.result_items[:K]]
        out[i, :len(keys)] = keys
    return out


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------

def phase_device(rehearsal, want):
    import jax
    devs = jax.devices()
    platform = devs[0].platform
    if rehearsal:
        check(platform == "cpu", f"rehearsal runs on the CPU, got {platform}")
    elif platform != "gpu":
        say(f"JAX found no GPU (platform {platform!r}); nothing was run")
        sys.exit(2)
    if not rehearsal and len(devs) != want:
        # JAX reserves memory on every GPU it sees: a run uses exactly
        # the cards it was asked for, and reports that count
        say(f"--devices {want} needs exactly {want} visible GPUs, JAX "
            f"found {len(devs)}; set CUDA_VISIBLE_DEVICES")
        sys.exit(2)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        for line in smi.stdout.strip().splitlines():
            say(f"gpu: {line.strip()}")
    except (OSError, subprocess.SubprocessError) as exc:
        check(rehearsal, f"nvidia-smi failed: {exc!r}")
        say("gpu: none (rehearsal)")
    from gamma_tpu import native
    from gamma_tpu.utils.jax_cache import enable_compilation_cache
    say(f"jax {jax.__version__}; devices {len(devs)} x "
        f"{devs[0].device_kind} ({platform})")
    say(f"compile cache: {enable_compilation_cache()}")
    if native.available() or native.build():
        say("native host runtime: libgamma_host.so")
    else:
        why = native.build_error().splitlines()[-3:]
        say("native host runtime: pure-Python fallback (build failed: "
            + " | ".join(why) + ")")
    return devs


def make_docs(corpus, lo, hi, with_fields=True):
    from gamma_tpu import Doc
    return [Doc(key=str(i),
                fields=({"price": float(i % 1000), "tag": f"t{i % 10}"}
                        if with_fields else {}),
                vectors={"vec": corpus[i]}) for i in range(lo, hi)]


def main_table(S, name="smoke", **extra):
    from gamma_tpu import (DataType, FieldInfo, TableInfo, VectorInfo)
    return TableInfo(
        name=name,
        fields=[FieldInfo("price", DataType.FLOAT, True),
                FieldInfo("tag", DataType.STRING, True)],
        vectors=[VectorInfo("vec", S["d"],
                            store_param={"device_dtype": "float32"})],
        indexing_size=min(S["n"], S["nlist"] * 256),
        retrieval_types=["IVFPQ"],
        retrieval_params=[{"ncentroids": S["nlist"],
                           "nsubvector": S["m"], "nprobe": S["nprobe"],
                           "bucket_init_size":
                               max(1024, 4 * S["n"] // S["nlist"]),
                           **extra}])


def ingest(add, S, corpus, with_fields=True):
    """Batched add through `add(docs) -> codes`; the batch that reaches
    indexing_size also trains.  → (rows/s outside training, train s)."""
    n, batch = S["n"], S["batch"]
    thr = min(n, S["nlist"] * 256)
    plain_s, plain_rows, train_s = 0.0, 0, 0.0
    s = 0
    while s < n:
        e = min(n, s + batch, thr if s < thr else n)
        docs = make_docs(corpus, s, e, with_fields)
        t0 = time.perf_counter()
        codes = add(docs)
        dt = time.perf_counter() - t0
        check(len(codes) == e - s and not any(codes),
              f"add_or_update_docs codes {set(codes)} for rows {s}:{e}")
        if e == thr:
            train_s = dt
        else:
            plain_s += dt
            plain_rows += e - s
        s = e
    return plain_rows / max(plain_s, 1e-9), train_s


def phase_main(S, corpus, rng, root):
    from gamma_tpu import EngineConfig, RangeFilter, Request, \
        TermFilter, VectorQuery
    from gamma_tpu.api.status import IndexStatus
    from gamma_tpu.server import GammaClient, serve

    srv = serve(("127.0.0.1", 0))
    try:
        client = GammaClient(srv.server_address)
        check(client.init(EngineConfig(path=root)) == 0, "init")
        check(client.create_table(main_table(S)) == 0, "create_table")
        t0 = time.perf_counter()
        rate, train_s = ingest(client.add_or_update_docs, S, corpus)
        client.flush()
        st = client.status()
        check(st.index_status == IndexStatus.INDEXED,
              f"index status {st.index_status}")
        check(st.min_indexed_num >= S["n"],
              f"indexed {st.min_indexed_num} of {S['n']}")
        say(f"ingest (set-up): {S['n']} docs in "
            f"{time.perf_counter() - t0:.1f} s; {rate:,.0f} rows/s "
            f"through the client; auto-train batch {train_s:.1f} s")

        nq, nr = S["nq"], S["n_requests"]
        noise = 0.5 * rng.normal(size=(nq * nr, S["d"]))
        queries = (corpus[rng.choice(S["n"], nq * nr, replace=False)]
                   + noise).astype(np.float32)
        gt = exact_topk(corpus, queries, K)
        params = {"recall_num": RECALL_NUM, "has_rank": True}

        def request(qb, **kw):
            return Request(topn=K, vec_fields=[VectorQuery("vec", qb)],
                           retrieval_params=dict(params), **kw)

        # ---- unfiltered ----
        t0 = time.perf_counter()
        client.search(request(queries[:nq]))
        say(f"first request incl. compile (set-up): "
            f"{time.perf_counter() - t0:.1f} s")
        lat, found, scores = [], [], []
        for r in range(nr):
            t0 = time.perf_counter()
            resp = client.search(request(queries[r * nq:(r + 1) * nq]))
            lat.append(time.perf_counter() - t0)
            found.append(ids_of(resp, nq))
            scores.append([[it.score for it in sr.result_items[:K]]
                           for sr in resp.results])
        found = np.concatenate(found)
        rec = recall_at_k(found, gt)
        say(f"serve unfiltered: recall@10 {rec:.4f} vs float64 "
            f"(bar {MAIN_RECALL_BAR}); request p50 "
            f"{np.percentile(lat, 50) * 1e3:.1f} ms, p99 "
            f"{np.percentile(lat, 99) * 1e3:.1f} ms over {nr} requests "
            f"of {nq} queries (smoke timing, not a benchmark)")
        check(rec >= MAIN_RECALL_BAR, f"unfiltered recall@10 {rec:.4f}")
        worst = 0.0
        for r in range(nr):
            for i, row in enumerate(scores[r]):
                qi = r * nq + i
                ids = found[qi][:len(row)]
                d64 = ((corpus[ids].astype(np.float64)
                        - queries[qi].astype(np.float64)) ** 2).sum(1)
                err = np.abs(np.asarray(row) - d64) / np.maximum(d64, 1e-3)
                worst = max(worst, float(err.max(initial=0.0)))
        say(f"serve: exact-rerank distances vs float64 max rel err "
            f"{worst:.2e} (rtol {RERANK_RTOL})")
        check(worst <= RERANK_RTOL, f"rerank distance rel err {worst}")

        # ---- filtered: price in [100, 599] AND tag in {t1, t3, t5, t7}
        rows = np.arange(S["n"])
        tags = {"t1", "t3", "t5", "t7"}
        keep = ((rows % 1000 >= 100) & (rows % 1000 <= 599)
                & np.isin(rows % 10, [1, 3, 5, 7]))
        gt_f = exact_topk(corpus, queries, K, mask=keep)
        filt = dict(range_filters=[RangeFilter("price", 100.0, 599.0)],
                    term_filters=[TermFilter("tag", sorted(tags))])
        lat_f, found_f = [], []
        client.search(request(queries[:nq], **filt))      # compile
        for r in range(nr):
            t0 = time.perf_counter()
            resp = client.search(request(queries[r * nq:(r + 1) * nq],
                                         **filt))
            lat_f.append(time.perf_counter() - t0)
            found_f.append(ids_of(resp, nq))
            for sr in resp.results:
                for it in sr.result_items:
                    i = int(it.key)
                    check(keep[i], f"filtered hit {i} fails a predicate")
        found_f = np.concatenate(found_f)
        rec_f = recall_at_k(found_f, gt_f)
        say(f"serve filtered (range + term, {keep.mean():.0%} of rows "
            f"pass): recall@10 {rec_f:.4f} vs float64 filtered; every "
            f"hit satisfies both predicates; request p50 "
            f"{np.percentile(lat_f, 50) * 1e3:.1f} ms, p99 "
            f"{np.percentile(lat_f, 99) * 1e3:.1f} ms")
        check(rec_f >= MAIN_RECALL_BAR, f"filtered recall@10 {rec_f:.4f}")

        # ---- lifecycle ----
        q0 = queries[:nq]
        victim = int(found[0, 0])
        check(client.delete(str(victim)) == 0, f"delete {victim}")
        after = ids_of(client.search(request(q0)), nq)
        check(not (after == victim).any(), f"deleted {victim} returned")
        check(client.dump() == 0, "dump")
        client.close()
        client = GammaClient(srv.server_address)
        check(client.init(EngineConfig(path=root)) == 0, "re-init")
        t0 = time.perf_counter()
        check(client.load() == 0, "load")
        check(client.status().index_status == IndexStatus.INDEXED,
              "index status after load")
        load_s = time.perf_counter() - t0
        reloaded = ids_of(client.search(request(q0)), nq)
        check(not (reloaded == victim).any(),
              f"deleted {victim} returned after load")
        agree = np.mean([len(set(after[i]) & set(reloaded[i])) / K
                         for i in range(nq)])
        say(f"lifecycle: delete masks doc {victim}; dump/close/load "
            f"({load_s:.1f} s) top-10 agreement {agree:.4f} "
            f"(bar {RELOAD_AGREEMENT})")
        check(agree >= RELOAD_AGREEMENT, f"reload agreement {agree}")
        client.close()
    finally:
        srv.stop()


def model_runs(S):
    """(label, model, retrieval params, request params, metric)."""
    L = S["nlist_models"]
    p = min(64, L)
    ivf = {"ncentroids": L, "nprobe": p,
           "bucket_init_size": max(256, 4 * S["n_models"] // L)}
    ann = {"recall_num": RECALL_NUM, "has_rank": True}
    return [
        ("FLAT", "FLAT", {}, {}, "l2"),
        ("IVFPQ gather, PQ payload", "IVFPQ",
         dict(ivf, nsubvector=32, scan_mode="gather",
              gather_payload="pq"), ann, "l2"),
        ("IVFPQ gather, SQ8 payload", "IVFPQ",
         dict(ivf, nsubvector=32, scan_mode="gather",
              gather_payload="sq8"), ann, "l2"),
        ("IVFPQ_FASTSCAN", "IVFPQ_FASTSCAN",
         dict(ivf, nsubvector=64, scan_mode="gather"), ann, "l2"),
        ("IVFFLAT", "IVFFLAT", dict(ivf), {"nprobe": p}, "l2"),
        ("BINARYIVF", "BINARYIVF", dict(ivf), {"nprobe": p}, "hamming"),
        ("HNSW", "HNSW", {"nlinks": 32, "efSearch": 64},
         {"ef_search": 64}, "l2"),
        ("SCANN", "SCANN", dict(ivf, nsubvector=32,
                                metric_type="InnerProduct"),
         {"recall_num": 256, "has_rank": True}, "ip"),
        ("VEARCH", "VEARCH", dict(ivf, nsubvector=32,
                                  metric_type="InnerProduct"),
         {"recall_num": 256, "has_rank": True}, "ip"),
    ]


def hamming_recall(x, q, found):
    """Tie-aware Hamming recall@10: a found id counts when its distance
    is <= the true 10th distance (Hamming distances are small integers,
    so the top-10 boundary is a tie plateau)."""
    from gamma_tpu.index.binary_ivf import pack_bits_np
    px, pq = pack_bits_np(x), pack_bits_np(q)
    pop = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                        axis=1).sum(1).astype(np.int32)
    hits = 0.0
    for i in range(q.shape[0]):
        hd = pop[px ^ pq[i]].sum(1)
        thr = np.partition(hd, K - 1)[K - 1]
        f = found[i][found[i] >= 0]
        hits += float((hd[f] <= thr).sum()) / K
    return hits / q.shape[0]


def phase_models(S, corpus, rng, root):
    from gamma_tpu import (EngineConfig, GammaEngine, Request, TableInfo,
                           VectorInfo, VectorQuery)
    from gamma_tpu.index import model_names

    runs = model_runs(S)
    check({r[1] for r in runs} == set(model_names()),
          f"registered models {model_names()} vs smoke "
          f"{sorted({r[1] for r in runs})}")
    n2, d = S["n_models"], S["d"]
    x = np.ascontiguousarray(corpus[:n2])
    nq = S["nq"]
    q = (x[rng.choice(n2, nq, replace=False)]
         + 0.5 * rng.normal(size=(nq, d))).astype(np.float32)
    gts = {"l2": exact_topk(x, q, K), "ip": exact_topk(x, q, K, "ip")}
    for i, (label, model, params, req, metric) in enumerate(runs):
        t0 = time.perf_counter()
        eng = GammaEngine(EngineConfig(path=os.path.join(root, f"m{i}")))
        try:
            eng.create_table(TableInfo(
                name=f"m{i}", fields=[],
                vectors=[VectorInfo("vec", d, store_param={
                    "device_dtype": "float32"})],
                indexing_size=n2 // 2, retrieval_types=[model],
                retrieval_params=[params]))
            for s in range(0, n2, S["batch"]):
                codes = eng.add_or_update_docs(
                    make_docs(x, s, min(n2, s + S["batch"]), False))
                check(not any(codes), f"{label}: add codes")
            eng.flush()
            build_s = time.perf_counter() - t0
            found = []
            for s in range(0, nq, nq // 2):
                resp = eng.search(Request(
                    topn=K, vec_fields=[VectorQuery("vec",
                                                    q[s:s + nq // 2])],
                    retrieval_params=dict(req)))
                found.append(ids_of(resp, nq // 2))
            found = np.concatenate(found)
        finally:
            eng.close()
        if metric == "hamming":
            rec = hamming_recall(x, q, found)
        else:
            rec = recall_at_k(found, gts[metric])
        say(f"model {label}: recall@10 {rec:.4f} ({metric} reference; "
            f"bar {MODEL_RECALL_BAR}); build + 2 searches "
            f"{time.perf_counter() - t0:.1f} s (ingest+train {build_s:.1f} s)")
        check(rec >= MODEL_RECALL_BAR, f"{label} recall@10 {rec:.4f}")


def phase_sharded(S, corpus, rng, root, n_dev):
    # the 1M table as served: dense, and gather over the SQ8 sidecar
    sharded_engine(S, corpus, rng, root, n_dev, "sharded", {},
                   ("dense", "gather"), sq8=True)
    # a PQ-payload table at the secondary geometry: the sharded ADC
    # gather body
    S2 = dict(S, n=S["n_models"], nlist=S["nlist_models"])
    sharded_engine(S2, corpus, rng, root, n_dev, "sharded_pq",
                   {"gather_payload": "pq"}, ("gather",), sq8=False)


def sharded_engine(S, corpus, rng, root, n_dev, name, extra, mode_names,
                   sq8):
    """enable_sharded_search(n_list_shards=n_dev) on an engine of S["n"]
    rows vs the same engine's single-device answers, in `mode_names`;
    then the realtime tail and a post-snapshot delete."""
    from gamma_tpu import (Doc, EngineConfig, GammaEngine, Request,
                           VectorQuery)

    eng = GammaEngine(EngineConfig(path=os.path.join(root, name)))
    try:
        eng.create_table(main_table(S, name, **extra))
        t0 = time.perf_counter()
        ingest(eng.add_or_update_docs, S, corpus)
        eng.flush()
        payload = "SQ8" if sq8 else "PQ"
        check(eng.vm.index_for("vec").sq_active == sq8,
              f"{name}: gather payload is not {payload}")
        say(f"{name} ingest (set-up): {S['n']} docs in "
            f"{time.perf_counter() - t0:.1f} s; gather payload {payload}")
        nq = S["nq"]
        queries = (corpus[rng.choice(S["n"], nq, replace=False)]
                   + 0.5 * rng.normal(size=(nq, S["d"]))).astype(
                       np.float32)
        gt = exact_topk(corpus[:S["n"]], queries, K)
        modes = {
            "dense": {"recall_num": RECALL_NUM, "has_rank": True},
            "gather": {"scan_mode": "gather", "nprobe": S["nprobe"],
                       "recall_num": RECALL_NUM, "has_rank": True},
        }
        modes = {m: modes[m] for m in mode_names}

        def run(params, qb=queries, topn=K):
            return eng.search(Request(
                topn=topn, vec_fields=[VectorQuery("vec", qb)],
                retrieval_params=dict(params)))

        single = {m: recall_at_k(ids_of(run(p), nq), gt)
                  for m, p in modes.items()}
        eng.enable_sharded_search(n_list_shards=n_dev)
        for m, p in modes.items():
            t0 = time.perf_counter()
            found = ids_of(run(p), nq)
            rec = recall_at_k(found, gt)
            say(f"{name} {m} over {n_dev} devices: recall@10 {rec:.4f} "
                f"vs single-device {single[m]:.4f} (slack "
                f"{SHARDED_RECALL_SLACK}); first request incl. snapshot "
                f"+ compile {time.perf_counter() - t0:.1f} s")
            check(rec >= single[m] - SHARDED_RECALL_SLACK,
                  f"{name} {m} recall {rec:.4f} < {single[m]:.4f}")

        # realtime tail: docs added after the snapshot are served by the
        # live single-device index and merged in
        base = S["n"]
        tail = (corpus[:4] + 1e-3 * rng.normal(size=(4, S["d"]))).astype(
            np.float32)
        codes = eng.add_or_update_docs([
            Doc(key=str(base + j), fields={"price": 1.0, "tag": "t1"},
                vectors={"vec": tail[j]}) for j in range(4)])
        check(not any(codes), "tail add")
        eng.flush()
        for m, p in modes.items():
            got = ids_of(run(p, tail), 4)
            for j in range(4):
                check(base + j in got[j][:3],
                      f"{m}: tail doc {base + j} not in {got[j]}")
        # post-snapshot delete vanishes from sharded results
        for m, p in modes.items():
            victim = int(ids_of(run(p), nq)[0, 0])
            check(eng.delete(str(victim)) == 0, f"delete {victim}")
            got = ids_of(run(p), nq)
            check(not (got == victim).any(),
                  f"{m}: deleted {victim} still returned")
        say(f"{name}: realtime tail found, post-snapshot deletes masked "
            f"({', '.join(modes)})")
        eng.disable_sharded_search()
    finally:
        eng.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-GPU sharded phase")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="every phase at toy sizes on the CPU; never "
                         "reports ok")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cpu_rehearsal:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=4").strip()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax
    if args.cpu_rehearsal:
        jax.config.update("jax_platforms", "cpu")
    import bench

    t_start = time.perf_counter()
    devs = phase_device(args.cpu_rehearsal, args.devices)
    S = TOY if args.cpu_rehearsal else FULL
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    corpus, _ = bench.make_corpus(S["n"], S["d"], 1024, rng)
    say(f"corpus (set-up): {S['n']} x {S['d']} seeded in "
        f"{time.perf_counter() - t0:.1f} s")
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.devices == 1:
            phase_main(S, corpus, rng, root)
            phase_models(S, corpus, rng, root)
        if args.devices == 4 or args.cpu_rehearsal:
            phase_sharded(S, corpus, rng, root, 4)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say(f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs) if args.cpu_rehearsal else args.devices}
    if args.cpu_rehearsal:
        print(json.dumps({"rehearsal": "passed", "device": device}))
    else:
        print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
