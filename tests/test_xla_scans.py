"""The plain-XLA scan tiers and their helpers against numpy references.

Every gathered-list tier has one XLA path (ops/ivf_scan.py); these
tests hold each to a float64 oracle at small shapes: the 8-bit and
packed 4-bit ADC scans (LUT oracle), the residual-SQ8 scan (distances
to the dequantized points), IVFFlat (exact over the stored bf16 rows),
and the one candidate select (ops/topk.select_min_k).  All probe every
list (nprobe = nlist) so the oracle needs no coarse tie-breaking.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gamma_tpu.config import SearchParams
from gamma_tpu.ops import ivf_scan
from gamma_tpu.ops import pq as pq_ops
from gamma_tpu.ops.distances import BIG
from gamma_tpu.ops.sq import encode_sq, train_sq
from gamma_tpu.ops.topk import EXACT_SELECT_MAX_WIDTH, select_min_k
from gamma_tpu.realtime.invert_index import IVFState
from gamma_tpu.utils import devmem

K = 6


def _posting(rng, nlist, cap, n_docs, dead_frac=0.1):
    """Random lens/docids with tombstones inside the live lengths."""
    lens = rng.integers(cap // 2, cap + 1, size=nlist).astype(np.int32)
    docids = np.full((nlist, cap), -1, np.int32)
    perm = rng.permutation(n_docs)
    k = 0
    for li in range(nlist):
        docids[li, :lens[li]] = perm[k:k + lens[li]]
        k += lens[li]
    dead = (rng.random((nlist, cap)) < dead_frac) & (docids >= 0)
    docids[dead] = -1
    return lens, docids


def _penalty(rng, n_docs, masked):
    pen = np.zeros(n_docs + 8, np.float32)
    if masked:
        pen[rng.random(n_docs + 8) < 0.3] = BIG
    return pen


def _oracle_topk(dist, lens, docids, pen, k):
    """dist [B, nlist, cap] f64 over every list → top-k (dist, docid)
    over live, unmasked slots."""
    cap = dist.shape[-1]
    live = (np.arange(cap)[None, :] < lens[:, None]) & (docids >= 0)
    ok = live & (pen[np.maximum(docids, 0)] < BIG)
    d = np.where(ok[None], dist, np.inf).reshape(dist.shape[0], -1)
    order = np.argsort(d, axis=1)[:, :k]
    return (np.take_along_axis(d, order, axis=1),
            docids.reshape(-1)[order])


def _check_topk(got_d, got_doc, ref_d, ref_doc, rtol=1e-4):
    got_d, got_doc = np.asarray(got_d, np.float64), np.asarray(got_doc)
    np.testing.assert_allclose(got_d, ref_d, rtol=rtol,
                               atol=rtol * np.abs(ref_d).max())
    for i in range(ref_doc.shape[0]):
        assert set(got_doc[i].tolist()) == set(ref_doc[i].tolist()), i


# ---------------------------------------------------------------------
# 8-bit and packed 4-bit ADC (ivfpq_search / ivfpqfs_search)
# ---------------------------------------------------------------------

def _adc_setup(rng, nbits, nlist=6, cap=24, d=16, m=4, b=5):
    n_docs = nlist * cap
    x = rng.normal(size=(2048, d)).astype(np.float32)
    pq = pq_ops.train_pq(jnp.asarray(x), m, nbits=nbits, iters=3)
    ksub = 1 << nbits
    codes = rng.integers(0, ksub, size=(nlist, cap, m)).astype(np.uint8)
    cents = (2.0 * rng.normal(size=(nlist, d))).astype(np.float32)
    lens, docids = _posting(rng, nlist, cap, n_docs)
    q = rng.normal(size=(b, d)).astype(np.float32)
    return pq, codes, cents, lens, docids, q, n_docs


def _adc_oracle(pq, codes, cents, q, metric):
    """[B, nlist, cap] f64 ADC distances from explicit per-list LUTs."""
    cb = np.asarray(pq.codebooks, np.float64)              # [M, ksub, ds]
    m, _, ds = cb.shape
    q64 = q.astype(np.float64)
    out = np.zeros((q.shape[0],) + codes.shape[:2])
    for b in range(q.shape[0]):
        for li in range(codes.shape[0]):
            if metric == "ip":
                qs = q64[b].reshape(m, ds)
                lut = -np.einsum("md,mkd->mk", qs, cb)
                base = -q64[b] @ cents[li].astype(np.float64)
            else:
                r = (q64[b] - cents[li]).reshape(m, ds)
                lut = ((r[:, None, :] - cb) ** 2).sum(-1)
                base = 0.0
            out[b, li] = base + lut[np.arange(m)[None, :],
                                    codes[li].astype(np.int64)].sum(-1)
    return out


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ivfpq_adc_matches_lut_oracle(metric, fused):
    """8-bit ADC + mask + select (rerank off) == the LUT oracle.
    fused=False passes an all-admitting score range, which routes the
    mask through the unfused range branch."""
    rng = np.random.default_rng(11)
    pq, codes, cents, lens, docids, q, n_docs = _adc_setup(rng, 8)
    pen = _penalty(rng, n_docs, masked=True)
    state = IVFState(jnp.asarray(codes), jnp.asarray(docids),
                     jnp.asarray(docids), jnp.asarray(lens))
    cj = jnp.asarray(cents)
    dr = None if fused else jnp.asarray([-BIG, BIG], jnp.float32)
    d, doc, _ = ivf_scan.ivfpq_search(
        state, cj, jnp.sum(cj * cj, -1), pq, jnp.asarray(q),
        jnp.asarray(pen), jnp.zeros((n_docs, q.shape[1])),
        dist_range=dr, nprobe=codes.shape[0], recall_num=K, k=K,
        metric=metric, rerank=False)
    ref_d, ref_doc = _oracle_topk(_adc_oracle(pq, codes, cents, q, metric),
                                  lens, docids, pen, K)
    _check_topk(d, doc, ref_d, ref_doc)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ivfpqfs_packed_adc_matches_lut_oracle(metric):
    """Packed two-per-byte 4-bit codes (lo nibble first) through the
    FastScan scan == the LUT oracle over the unpacked codes."""
    rng = np.random.default_rng(12)
    pq, codes, cents, lens, docids, q, n_docs = _adc_setup(rng, 4, m=8)
    packed = (codes[..., 0::2] | (codes[..., 1::2] << 4)).astype(np.uint8)
    np.testing.assert_array_equal(
        np.asarray(pq_ops.unpack_nibbles(jnp.asarray(packed))), codes)
    pen = _penalty(rng, n_docs, masked=True)
    state = IVFState(jnp.asarray(packed), jnp.asarray(docids),
                     jnp.asarray(docids), jnp.asarray(lens))
    cj = jnp.asarray(cents)
    d, doc, _ = ivf_scan.ivfpqfs_search(
        state, cj, jnp.sum(cj * cj, -1), pq, jnp.asarray(q),
        jnp.asarray(pen), jnp.zeros((n_docs, q.shape[1])),
        nprobe=codes.shape[0], recall_num=K, k=K, metric=metric,
        rerank=False, by_residual=True)
    ref_d, ref_doc = _oracle_topk(_adc_oracle(pq, codes, cents, q, metric),
                                  lens, docids, pen, K)
    _check_topk(d, doc, ref_d, ref_doc)


# ---------------------------------------------------------------------
# residual SQ8 (ops/sq.py + sq_raw_dist_xla + ivfsq_search)
# ---------------------------------------------------------------------

def _sq_state(rng, nlist, cap, d, d_pad, *, residual):
    """Rows encoded per list → (codes, norms, cents, scale, off, deq)
    with deq[l, s] the dequantized point the scan must be exact to."""
    cents = (3.0 * rng.normal(size=(nlist, d))).astype(np.float32)
    rows = cents[:, None, :] + \
        0.3 * rng.normal(size=(nlist, cap, d)).astype(np.float32)
    res = rows - cents[:, None, :] if residual else rows
    scale, off = train_sq(jnp.asarray(res.reshape(-1, d)))
    coarse = np.repeat(cents, cap, axis=0) if residual else None
    codes, norms = encode_sq(
        jnp.asarray(rows.reshape(-1, d)), scale, off,
        None if coarse is None else jnp.asarray(coarse),
        d_pad=d_pad, residual=residual)
    codes = np.asarray(codes).reshape(nlist, cap, d_pad)
    norms = np.asarray(norms).reshape(nlist, cap)
    base = cents[:, None, :] if residual else 0.0
    deq = (base + np.asarray(off, np.float64)
           + np.asarray(scale, np.float64) * codes[..., :d])
    return codes, norms, cents, scale, off, deq


def _sq_oracle(deq, list_ids, q, metric):
    pts = deq[np.asarray(list_ids)]                      # [B, P, cap, d]
    q64 = q.astype(np.float64)[:, None, None, :]
    if metric == "ip":
        return -(q64 * pts).sum(-1)
    return ((q64 - pts) ** 2).sum(-1)


def test_encode_sq_norms_exact(rng):
    """norms must be ||dequantized point||^2, including the coarse base."""
    d, d_pad, n = 12, 16, 64
    cents = rng.normal(size=(n, d)).astype(np.float32)
    rows = cents + 0.2 * rng.normal(size=(n, d)).astype(np.float32)
    scale, off = train_sq(jnp.asarray(rows - cents))
    codes, norms = encode_sq(jnp.asarray(rows), scale, off,
                             coarse=jnp.asarray(cents), d_pad=d_pad,
                             residual=True)
    deq = cents + np.asarray(off) + \
        np.asarray(scale) * np.asarray(codes)[:, :d].astype(np.float32)
    np.testing.assert_allclose(np.asarray(norms), (deq ** 2).sum(-1),
                               rtol=1e-5)
    # padding dims must encode as zero-contribution
    assert codes.shape == (n, d_pad)
    assert np.all(np.asarray(codes)[:, d:] == 0)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_sq_raw_dist_matches_f64(metric, residual):
    """Distances to the dequantized points, f32 arithmetic: error is
    f32 rounding of ||q||^2 + ||x||^2 scale terms (rtol 1e-5)."""
    rng = np.random.default_rng(21)
    nlist, cap, d = 6, 20, 16
    codes, norms, cents, scale, off, deq = _sq_state(
        rng, nlist, cap, d, d, residual=residual)
    q = rng.normal(size=(4, d)).astype(np.float32)
    lids = rng.integers(0, nlist, size=(4, 3)).astype(np.int32)
    got = np.asarray(ivf_scan.sq_raw_dist_xla(
        jnp.asarray(codes), jnp.asarray(norms), scale, off,
        jnp.asarray(cents if residual else np.zeros_like(cents)),
        jnp.asarray(lids), jnp.asarray(q), metric=metric), np.float64)
    ref = _sq_oracle(deq, lids, q, metric)
    pts = deq[lids]
    scale_t = ((q.astype(np.float64) ** 2).sum(-1)[:, None, None]
               + (pts ** 2).sum(-1))
    assert np.max(np.abs(got - ref) / scale_t) < 1e-5


def test_sq_raw_dist_padded_dims():
    """A code width padded past d (d=12 → 16) reads only the first d
    code bytes: garbage in the padding must not move a distance."""
    rng = np.random.default_rng(22)
    nlist, cap, d, d_pad = 4, 16, 12, 16
    codes, norms, cents, scale, off, deq = _sq_state(
        rng, nlist, cap, d, d_pad, residual=True)
    codes = codes.copy()
    codes[..., d:] = 255
    q = rng.normal(size=(3, d)).astype(np.float32)
    lids = np.tile(np.arange(nlist, dtype=np.int32), (3, 1))
    got = np.asarray(ivf_scan.sq_raw_dist_xla(
        jnp.asarray(codes), jnp.asarray(norms), scale, off,
        jnp.asarray(cents), jnp.asarray(lids), jnp.asarray(q)),
        np.float64)
    ref = _sq_oracle(deq, lids, q, "l2")
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ivfsq_search_list_bias(metric):
    """ivfsq_search (no rerank) == top-k of the f64 oracle over live,
    penalty-admitted slots: tombstones, beyond-length slots and masked
    docs never surface."""
    rng = np.random.default_rng(23)
    nlist, cap, d = 6, 24, 16
    codes, norms, cents, scale, off, deq = _sq_state(
        rng, nlist, cap, d, d, residual=True)
    n_docs = nlist * cap
    lens, docids = _posting(rng, nlist, cap, n_docs)
    pen = _penalty(rng, n_docs, masked=True)
    state = IVFState(jnp.zeros((nlist, cap, 1), jnp.uint8),
                     jnp.asarray(docids), jnp.asarray(docids),
                     jnp.asarray(lens))
    q = rng.normal(size=(5, d)).astype(np.float32)
    cj = jnp.asarray(cents)
    d_out, doc, _ = ivf_scan.ivfsq_search(
        state, jnp.asarray(codes), jnp.asarray(norms), scale, off, cj,
        jnp.sum(cj * cj, -1), jnp.asarray(q), jnp.asarray(pen),
        nprobe=nlist, k=K, metric=metric)
    lids = np.tile(np.arange(nlist), (q.shape[0], 1))
    ref_d, ref_doc = _oracle_topk(_sq_oracle(deq, lids, q, metric),
                                  lens, docids, pen, K)
    _check_topk(d_out, doc, ref_d, ref_doc)


# ---------------------------------------------------------------------
# IVFFlat
# ---------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ivfflat_search_matches_exact(metric):
    """Probing every list, IVFFlat is exact over its stored bf16 rows."""
    from gamma_tpu.index.ivfflat import IVFFlatIndex
    from gamma_tpu.vector.raw_store import RawVectorStore
    rng = np.random.default_rng(31)
    n, d, nlist = 600, 16, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    store = RawVectorStore("f", d)
    store.add(x)
    store.flush_device()
    idx = IVFFlatIndex(store, {"ncentroids": nlist, "nprobe": nlist,
                               "metric_type": "InnerProduct"
                               if metric == "ip" else "L2"})
    idx.train(x)
    ids = np.arange(n, dtype=np.int64)
    idx.add(x, ids, ids)
    q = rng.normal(size=(7, d)).astype(np.float32)
    d_out, doc, _ = ivf_scan.ivfflat_search(
        idx.state, idx.centroids, idx.cent_norms, jnp.asarray(q),
        jnp.zeros(n + 8, jnp.float32), nprobe=nlist, k=K, d=d,
        metric=metric)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float64)
    q64 = q.astype(np.float64)
    if metric == "ip":
        ref = -(q64 @ xb.T)
    else:
        ref = ((q64[:, None, :] - xb[None]) ** 2).sum(-1)
    order = np.argsort(ref, axis=1)[:, :K]
    _check_topk(d_out, doc, np.take_along_axis(ref, order, 1), order)


# ---------------------------------------------------------------------
# the one candidate select
# ---------------------------------------------------------------------

@pytest.mark.parametrize("width", [64, 2048])
def test_select_min_k_exact_when_narrow(width):
    rng = np.random.default_rng(41)
    s = rng.normal(size=(6, width)).astype(np.float32)
    vals, idx = select_min_k(jnp.asarray(s), 32)
    nd, ref = jax.lax.top_k(-jnp.asarray(s), 32)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(vals), -np.asarray(nd))


@pytest.mark.parametrize("width", [1 << 15, 1 << 17])
def test_select_min_k_wide_against_top_k(width):
    """Past EXACT_SELECT_MAX_WIDTH the strided chunk-min prefilter
    returns true values at their indices, ascending; it keeps planted
    adjacent winners (same-list neighbours) exactly and loses a random
    top-100 member only to a smaller one in its bin."""
    assert width > EXACT_SELECT_MAX_WIDTH
    rng = np.random.default_rng(42)
    b, k = 8, 100
    s = rng.normal(size=(b, width)).astype(np.float32)
    for i in range(b):
        st = rng.integers(0, width - 20)
        s[i, st:st + 12] = -100.0 - rng.random(12)
    vals, idx = select_min_k(jnp.asarray(s), k)
    vals, idx = np.asarray(vals), np.asarray(idx)
    np.testing.assert_array_equal(vals, np.take_along_axis(s, idx, 1))
    assert np.all(np.diff(vals, axis=1) >= 0)
    _, ref = jax.lax.top_k(-jnp.asarray(s), k)
    ref = np.asarray(ref)
    for i in range(b):
        assert set(ref[i, :12]) <= set(idx[i])
        assert len(set(ref[i]) & set(idx[i])) >= 0.95 * k


def test_select_min_k_big_padded_rows():
    """Rows that are mostly masked (BIG) return their few live entries
    first, then BIG; no live entry is lost."""
    rng = np.random.default_rng(43)
    width = 1 << 15
    s = np.full((4, width), BIG, np.float32)
    live = [rng.choice(width, 5, replace=False) for _ in range(4)]
    for i, pos in enumerate(live):
        s[i, pos] = rng.random(5).astype(np.float32)
    vals, idx = select_min_k(jnp.asarray(s), 10)
    vals, idx = np.asarray(vals), np.asarray(idx)
    for i, pos in enumerate(live):
        assert set(idx[i, :5]) == set(pos.tolist())
        assert np.all(vals[i, 5:] >= BIG)


def test_select_min_k_pads_k_beyond_width():
    s = np.random.default_rng(44).normal(size=(3, 50)).astype(np.float32)
    vals, idx = select_min_k(jnp.asarray(s), 64)
    vals, idx = np.asarray(vals), np.asarray(idx)
    assert vals.shape == idx.shape == (3, 64)
    np.testing.assert_array_equal(np.sort(idx[:, :50], axis=1),
                                  np.tile(np.arange(50), (3, 1)))
    assert np.all(vals[:, 50:] >= BIG) and np.all(idx[:, 50:] == -1)


# ---------------------------------------------------------------------
# device budgets, request params
# ---------------------------------------------------------------------

class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_scaled_budget_keeps_constants_on_cpu():
    cpu = jax.devices("cpu")[0]
    assert devmem.scaled_budget(8 << 30, cpu) == 8 << 30
    assert devmem.scaled_budget(ivf_scan.FLAT_GATHER_BYTES) == \
        ivf_scan.FLAT_GATHER_BYTES


def test_scaled_budget_scales_with_device_limit():
    dev = _FakeDevice("gpu", {"bytes_limit": 60 << 30})
    # same fraction of the device as of a 16 GiB device
    assert devmem.scaled_budget(8 << 30, dev) == 30 << 30
    assert devmem.scaled_budget(1 << 30, dev) == (60 << 30) // 16


def test_scaled_budget_requires_memory_stats():
    with pytest.raises(RuntimeError, match="memory_stats"):
        devmem.scaled_budget(1 << 30, _FakeDevice("gpu", None))


def test_search_params_ignore_recall_target():
    """Older clients still send the retired approximate-select recall
    target; it is accepted and selects nothing."""
    p = SearchParams.from_dict({"recall_target": 0.99, "recall_num": 50})
    assert p.recall_num == 50
    assert not hasattr(p, "recall_target")
