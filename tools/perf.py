"""QPS / latency sweep tool.

Reference: tools/perf.cc (611 LoC) — loads profile+feature data, ingests,
waits for INDEXED, then sweeps search thread counts {1,5,10,20,30,50,70,
100} reporting QPS / avg / tp90 / tp99 per step until QPS stops improving
(perf.cc:245,306-325).

Device translation: the thread sweep becomes a BATCH-SIZE sweep — on a GPU,
concurrency is batch width, not caller threads (the engine serializes
device steps behind its admission semaphore anyway).  A small
caller-thread sweep is kept to exercise the concurrent-request path.

Usage:
    python tools/perf.py [--n 100000] [--d 128] [--model IVFPQ]
                         [--topn 10] [--filters]
Runs on a GPU only (exits non-zero elsewhere).  Prints one table row
per step; the final line is JSON (machine-readable) naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pct(xs, p):
    return float(np.percentile(np.asarray(xs), p))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--model", default="IVFPQ")
    ap.add_argument("--topn", type=int, default=10)
    ap.add_argument("--nq", type=int, default=2048)
    ap.add_argument("--filters", action="store_true")
    ap.add_argument("--path", default="",
                    help="engine directory (default: a fresh temporary "
                         "directory)")
    ap.add_argument("--threads", type=int, default=0,
                    help="also run a caller-thread sweep at this many "
                         "threads (0 = skip)")
    args = ap.parse_args()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"tools/perf.py measures on a GPU; JAX found "
                 f"{dev.platform}")
    import tempfile
    args.path = args.path or tempfile.mkdtemp(prefix="gamma_perf_")
    from gamma_tpu.api.doc import Doc
    from gamma_tpu.api.request import Request, RangeFilter, VectorQuery
    from gamma_tpu.config import (DataType, EngineConfig, FieldInfo,
                                  TableInfo, VectorInfo)
    from gamma_tpu.engine import GammaEngine
    import shutil

    shutil.rmtree(args.path, ignore_errors=True)
    eng = GammaEngine(EngineConfig(path=args.path))
    nlist = max(64, min(2048, args.n // 256))
    eng.create_table(TableInfo(
        name="perf",
        fields=[FieldInfo("price", DataType.FLOAT, True)],
        vectors=[VectorInfo("vec", args.d)],
        indexing_size=args.n + 1,      # manual build below
        retrieval_types=[args.model],
        retrieval_params=[{"ncentroids": nlist, "nsubvector": 32}]))

    rng = np.random.default_rng(0)
    basis = (rng.normal(size=(16, args.d)) / 4).astype(np.float32)
    x = (rng.normal(size=(args.n, 16)).astype(np.float32) @ basis)

    t0 = time.time()
    batch = []
    for i in range(args.n):
        batch.append(Doc(key=f"k{i}", fields={"price": float(i % 1000)},
                         vectors={"vec": x[i]}))
        if len(batch) == 10_000:
            eng.add_or_update_docs(batch)
            batch = []
    if batch:
        eng.add_or_update_docs(batch)
    ingest_s = time.time() - t0
    print(f"ingest: {args.n} docs in {ingest_s:.1f}s "
          f"({args.n/ingest_s:,.0f} docs/s)", flush=True)

    t0 = time.time()
    eng.build_index()
    print(f"build_index: {time.time()-t0:.1f}s "
          f"status={eng.engine_status().index_status.name}", flush=True)

    queries = x[rng.choice(args.n, args.nq, replace=False)]
    filters = ([RangeFilter("price", 100.0, 500.0)]
               if args.filters else [])

    def make_req(qb):
        return Request(topn=args.topn,
                       vec_fields=[VectorQuery("vec", qb)],
                       range_filters=list(filters))

    # batch-size sweep (the device analog of the thread sweep)
    rows = []
    print(f"{'batch':>6} {'QPS':>12} {'avg_ms':>8} {'tp90':>8} "
          f"{'tp99':>8}")
    best = 0.0
    for bs in (1, 8, 32, 128, 256, 512):
        if bs > args.nq:
            break
        eng.search(make_req(queries[:bs]))      # warm compile
        lats = []
        done = 0
        t_all = time.time()
        while done < args.nq:
            qb = queries[done % (args.nq - bs + 1): ][:bs]
            t0 = time.time()
            eng.search(make_req(qb))
            lats.append((time.time() - t0) * 1000)
            done += bs
        wall = time.time() - t_all
        qps = done / wall
        row = {"batch": bs, "qps": round(qps, 1),
               "avg_ms": round(float(np.mean(lats)), 3),
               "tp90_ms": round(pct(lats, 90), 3),
               "tp99_ms": round(pct(lats, 99), 3)}
        rows.append(row)
        print(f"{bs:>6} {row['qps']:>12,.0f} {row['avg_ms']:>8.2f} "
              f"{row['tp90_ms']:>8.2f} {row['tp99_ms']:>8.2f}",
              flush=True)
        if qps < best * 1.02 and bs >= 128:   # stop when flat (perf.cc:306)
            break
        best = max(best, qps)

    # optional caller-thread sweep (concurrent-request path)
    if args.threads:
        # warm every pow2 coalesced-batch shape the aggregator can form
        # from <= args.threads single-query requests: each fresh shape is
        # a fresh XLA compile (seconds to minutes),
        # and a cold shape mid-measurement once read as a 2.9 s tp99
        b = 1
        while b <= args.threads:
            eng.search(make_req(queries[:b]))
            b *= 2
        lats, lock = [], threading.Lock()

        def worker(tid):
            local = []
            for i in range(16):
                qb = queries[(tid * 16 + i) % args.nq][None, :]
                t0 = time.time()
                eng.search(make_req(qb))
                local.append((time.time() - t0) * 1000)
            with lock:
                lats.extend(local)

        t0 = time.time()
        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(args.threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.time() - t0
        print(f"threads={args.threads}: QPS={args.threads*16/wall:,.0f} "
              f"tp99={pct(lats, 99):.2f} ms", flush=True)

    print(json.dumps({"rows": rows, "ingest_docs_per_s":
                      round(args.n / ingest_s, 1),
                      "platform": dev.platform,
                      "device_kind": dev.device_kind,
                      "device_count": len(jax.devices())}))
    eng.close()


if __name__ == "__main__":
    main()
