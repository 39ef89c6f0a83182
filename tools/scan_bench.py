#!/usr/bin/env python3
"""Scan-layer timings on one GPU at the SIFT1M geometry.

    python tools/scan_bench.py                 measure on the GPU
    python tools/scan_bench.py --cpu-rehearsal tiny sizes on the CPU
                                               (checks the script only;
                                               its times mean nothing)

Two sections, one 1M x 128 IVFPQ index (ncentroids 2048, nsubvector 32,
f32 raw store, seeded bench.make_corpus corpus):

  dense    the unfiltered dense scan as the engine runs it
           (ops/dense_scan.dense_scan_search_fast: bf16 mirror cross
           term + bias → select_min_k recall_num=100 → exact rerank →
           top-10) at B in {256, 2048}; time per call and recall@10
           against float64.
  gather   the plain-XLA gather tiers: PQ gather (ADC + select + rerank)
           and residual SQ8 at 1M, B=1024, nprobe=64; IVFFlat at 200k,
           B=1024, nprobe=64 — the bar a hand-written list-major scan
           must beat.

Times are host-clock per call around block_until_ready after a compile
warm-up: the minimum and the median of ITERS calls.  The last line is
one JSON object with every number, the device and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

K = 10
RECALL_NUM = 100
ITERS = 10          # timed calls after the compile warm-up


def timed(fn, iters):
    import jax
    out = jax.block_until_ready(fn())            # compile + warm
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, {"min_ms": round(min(ts) * 1e3, 3),
                 "median_ms": round(float(np.median(ts)) * 1e3, 3)}


def recall(found, gt):
    found = np.asarray(found)
    return round(float(np.mean([
        len(set(found[i][:K].tolist()) & set(gt[i][:K].tolist())) / K
        for i in range(gt.shape[0])])), 4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true")
    ap.add_argument("--out", default="",
                    help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    if args.cpu_rehearsal:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    if args.cpu_rehearsal:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu_rehearsal:
        sys.exit(f"scan_bench measures on a GPU; JAX found {dev.platform}")

    import bench
    from chip_smoke import exact_topk
    from gamma_tpu.index.ivfflat import IVFFlatIndex
    from gamma_tpu.index.ivfpq import IVFPQIndex
    from gamma_tpu.ops import ivf_scan
    from gamma_tpu.ops.dense_scan import dense_scan_search_fast
    from gamma_tpu.utils.jax_cache import enable_compilation_cache
    from gamma_tpu.vector.raw_store import RawVectorStore

    enable_compilation_cache()
    small = args.cpu_rehearsal
    n, d, nlist, m, nprobe = ((8192, 128, 64, 32, 16) if small
                              else (1_000_000, 128, 2048, 32, 64))
    n_flat, nlist_flat = (4096, 32) if small else (200_000, 1024)
    widths = (32, 64) if small else (256, 2048)
    b_gather = 64 if small else 1024
    iters = 2 if small else ITERS
    smi = ""
    if not small:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {dev.device_kind} ({dev.platform}); nvidia-smi: {smi}",
          flush=True)

    rng = np.random.default_rng(0)
    corpus, _ = bench.make_corpus(n, d, 1024, rng)
    nq = max(widths + (b_gather,))
    queries = (corpus[rng.choice(n, nq, replace=False)]
               + 0.5 * rng.normal(size=(nq, d))).astype(np.float32)
    gt = exact_topk(corpus, queries, K)
    qd = jnp.asarray(queries)

    t0 = time.perf_counter()
    store = RawVectorStore("vec", d, device_dtype=jnp.float32,
                           init_cap=n + 1024)
    store.add(corpus)
    store.flush_device()
    idx = IVFPQIndex(store, {"ncentroids": nlist, "nsubvector": m,
                             "nprobe": nprobe,
                             "bucket_init_size": max(1024, 4 * n // nlist)})
    idx.train(store.device_rows(0, min(n, nlist * 256)))
    ids = np.arange(n, dtype=np.int64)
    for s in range(0, n, 65536):
        e = min(n, s + 65536)
        idx.add(store.device_rows(s, e), ids[s:e], ids[s:e])
    jax.block_until_ready(idx.state.lens)
    print(f"1M index build (set-up): {time.perf_counter() - t0:.1f} s; "
          f"SQ8 sidecar active: {idx.sq_active}; cap_eff "
          f"{idx._cap_eff()}", flush=True)
    result = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices()), "nvidia_smi": smi,
              "n": n, "d": d, "nlist": nlist, "m": m,
              "recon_rows": int(idx.recon.shape[0]), "dense": {},
              "gather": {}}

    # ---- the dense scan step, as the engine calls it ----
    live = jnp.int32(n)
    for b in widths:
        qb = qd[:b]
        out, t = timed(lambda: dense_scan_search_fast(
            idx.recon, idx.recon_bias, qb, qb, store.device, live,
            recall_num=RECALL_NUM, k=K), iters)
        t["recall_at_10"] = recall(out[1], gt[:b])
        result["dense"][str(b)] = t
        print(f"dense B={b} (recon rows {idx.recon.shape[0]}): {t}",
              flush=True)

    # ---- plain-XLA gather tiers ----
    qg = qd[:b_gather]
    pen = jnp.zeros(store.device.shape[0], jnp.float32)
    out, t = timed(lambda: ivf_scan.ivfpq_search(
        idx.state, idx.centroids, idx.cent_norms, idx.pq, qg, pen,
        store.device, live_n=live, nprobe=nprobe, recall_num=RECALL_NUM,
        k=K, metric="l2", rerank=True, cap_eff=idx._cap_eff()), iters)
    t["recall_at_10"] = recall(out[1], gt[:b_gather])
    result["gather"]["pq_1M"] = t
    print(f"gather PQ 1M B={b_gather} nprobe={nprobe}: {t}", flush=True)
    if idx.sq_active:
        out, t = timed(lambda: ivf_scan.ivfsq_search(
            idx.state, idx.sq_codes, idx.sq_norms, idx.sq_scale,
            idx.sq_off, idx.centroids, idx.cent_norms, qg, pen, None,
            live, nprobe=nprobe, k=K, metric="l2",
            cap_eff=idx._cap_eff()), iters)
        t["recall_at_10"] = recall(out[1], gt[:b_gather])
        result["gather"]["sq8_1M"] = t
        print(f"gather SQ8 1M B={b_gather} nprobe={nprobe}: {t}",
              flush=True)
    del idx, store

    x2 = np.ascontiguousarray(corpus[:n_flat])
    q2 = queries[:b_gather]
    gt2 = exact_topk(x2, q2, K)
    s2 = RawVectorStore("flat", d, init_cap=n_flat + 1024)
    s2.add(x2)
    s2.flush_device()
    fl = IVFFlatIndex(s2, {"ncentroids": nlist_flat, "nprobe": nprobe,
                           "bucket_init_size":
                               max(256, 4 * n_flat // nlist_flat)})
    fl.train(x2)
    ids2 = np.arange(n_flat, dtype=np.int64)
    for s in range(0, n_flat, 65536):
        e = min(n_flat, s + 65536)
        fl.add(x2[s:e], ids2[s:e], ids2[s:e])
    from gamma_tpu.utils.growth import ladder_256
    ce = ladder_256(max(fl._max_len, 1), fl.state.cap)
    pen2 = jnp.zeros(n_flat + 1024, jnp.float32)
    out, t = timed(lambda: ivf_scan.ivfflat_search(
        fl.state, fl.centroids, fl.cent_norms, jnp.asarray(q2), pen2,
        nprobe=nprobe, k=K, d=d, metric="l2", cap_eff=ce), iters)
    t["recall_at_10"] = recall(out[1], gt2)
    result["gather"]["ivfflat_200k"] = t
    print(f"gather IVFFlat {n_flat} B={b_gather} nprobe={nprobe}: {t}",
          flush=True)

    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
