"""Per-list mask bias + late id materialization contracts.

These paths replace [B, P, cap] gathered masks/id arrays, whose
transients dominated device memory at the 10M gather geometry.
Contracts under test:

  * list_bias == the gathered _candidate_mask_* forms for every slot
  * _select_late returns the same candidates as the flat oracle select,
    on both sides of the exact/chunk-min width threshold
    (ops/topk.select_min_k)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gamma_tpu.ops.distances import BIG
from gamma_tpu.ops.ivf_scan import (_candidate_mask_penalty,
                                    _candidate_mask_validity,
                                    _select_late, list_bias)
from gamma_tpu.ops.topk import EXACT_SELECT_MAX_WIDTH


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _mk_posting(rng, nlist=8, cap=96, n_docs=500):
    lens = rng.integers(0, cap, size=nlist).astype(np.int32)
    docids = np.full((nlist, cap), -1, np.int32)
    for li in range(nlist):
        docids[li, : lens[li]] = rng.integers(0, n_docs, size=lens[li])
    # sprinkle tombstones inside live lengths
    for li in range(nlist):
        if lens[li] > 2:
            docids[li, rng.integers(0, lens[li])] = -1
    return jnp.asarray(lens), jnp.asarray(docids)


def test_list_bias_matches_gathered_masks(rng):
    nlist, cap, n_docs = 8, 96, 500
    lens, docids = _mk_posting(rng, nlist, cap, n_docs)
    penalty = jnp.asarray(
        np.where(rng.random(n_docs) < 0.3, BIG,
                 rng.random(n_docs) * 5).astype(np.float32))
    list_ids = jnp.asarray(
        rng.integers(0, nlist, size=(5, 3)).astype(np.int32))
    docids_g = jnp.take(docids, list_ids, axis=0)
    lens_g = jnp.take(lens, list_ids, axis=0)

    bias_p = list_bias(docids, lens, cap, penalty=penalty)
    got_p = jnp.take(bias_p, list_ids, axis=0)
    ref_p = _candidate_mask_penalty(docids_g, lens_g, cap, penalty)
    np.testing.assert_array_equal(np.asarray(got_p), np.asarray(ref_p))

    live_n = jnp.int32(n_docs // 2)
    bias_v = list_bias(docids, lens, cap, live_n=live_n)
    got_v = jnp.take(bias_v, list_ids, axis=0)
    ref_v = _candidate_mask_validity(docids_g, lens_g, cap, live_n)
    np.testing.assert_array_equal(np.asarray(got_v), np.asarray(ref_v))


@pytest.mark.parametrize("wide", [False, True])
def test_select_late_matches_oracle(rng, wide):
    """wide=False: the [B, P*cap] row is narrow enough for the exact
    select; wide=True: past EXACT_SELECT_MAX_WIDTH, through the strided
    chunk-min prefilter (the winners are planted in distinct bins, so
    the prefilter must return exactly the oracle's candidates)."""
    b, p, nlist, r = 4, 3, 8, 7
    cap = 64 if not wide else EXACT_SELECT_MAX_WIDTH // 2
    assert (p * cap > EXACT_SELECT_MAX_WIDTH) == wide
    list_ids = np.stack([rng.choice(nlist, p, replace=False)
                         for _ in range(b)]).astype(np.int32)
    # distinct distances → unique oracle ordering
    dist = (rng.permutation(b * p * cap).reshape(b, p, cap)
            .astype(np.float32) + 1000.0)
    # poison a strip as dead
    dist[:, :, cap - 5:] = BIG
    # plant the r winners at consecutive flat positions: consecutive
    # positions never share a strided select bin
    for i in range(b):
        s = rng.integers(0, cap - 5 - r)
        dist[i, 1, s: s + r] = rng.permutation(r).astype(np.float32)
    docids = rng.permutation(nlist * cap).reshape(nlist, cap) \
        .astype(np.int32)
    vids = (docids + 10_000_000).astype(np.int32)

    rd, rdoc, rvid = _select_late(
        jnp.asarray(dist), jnp.asarray(list_ids), jnp.asarray(docids),
        jnp.asarray(vids), cap, r)
    flat = dist.reshape(b, -1)
    order = np.argsort(flat, axis=1)[:, :r]
    ref_d = np.take_along_axis(flat, order, axis=1)
    np.testing.assert_allclose(np.asarray(rd), ref_d, rtol=1e-6)
    pidx, slot = order // cap, order % cap
    lst = np.take_along_axis(list_ids, pidx, axis=1)
    ref_doc = docids[lst, slot]
    ref_vid = vids[lst, slot]
    dead = ref_d >= BIG
    np.testing.assert_array_equal(np.asarray(rdoc),
                                  np.where(dead, -1, ref_doc))
    np.testing.assert_array_equal(np.asarray(rvid),
                                  np.where(dead, -1, ref_vid))


def test_select_late_pads_past_width(rng):
    b, p, cap, nlist = 2, 2, 8, 4
    list_ids = np.stack([rng.choice(nlist, p, replace=False)
                         for _ in range(b)]).astype(np.int32)
    dist = rng.permutation(b * p * cap).reshape(b, p, cap) \
        .astype(np.float32)
    docids = np.arange(nlist * cap, dtype=np.int32).reshape(nlist, cap)
    r = p * cap + 5
    rd, rdoc, _ = _select_late(
        jnp.asarray(dist), jnp.asarray(list_ids), jnp.asarray(docids),
        jnp.asarray(docids), cap, r)
    assert rd.shape == (b, r)
    assert np.all(np.asarray(rd)[:, p * cap:] >= BIG)
    assert np.all(np.asarray(rdoc)[:, p * cap:] == -1)
