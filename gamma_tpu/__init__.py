"""gamma_tpu — a vector index-and-query engine in JAX.

A from-scratch JAX/XLA re-design of the capability contract of
vearch/gamma (the C++ vector-search core of Vearch, Middleware'18):

  * document store mixing scalar fields and dense vectors
  * real-time indexing (search while inserting, no locks)
  * ANN retrieval (IVFPQ, IVFFlat, Flat, binary/Hamming IVF)
  * scalar-filtered hybrid search (range + term filters fused into the scan)
  * checkpoint / restore, engine status, migration hooks

Architecture (deliberately NOT a translation of the reference's
pointer-chasing C++ design — see SURVEY.md §7):

  * Engine state is an immutable JAX pytree.  A search runs against the
    snapshot it was handed; writers publish new versions by swapping a
    Python reference.  Functional semantics give us gamma's lock-free
    "search during insert" property for free (reference:
    realtime/realtime_mem_data.cc:279-302 implements this with atomic
    cursors + delayed frees; we get it from immutability).
  * Inverted lists are padded dense tensors in device memory
    (`codes[nlist, cap, M] u8`, `entries[nlist, cap] i32`,
    `lens[nlist] i32`); growth is capacity-doubling reallocation
    (reference: realtime_mem_data.cc:152-188 ExtendBucketMem).
  * Deleted docs + scalar filters compose into one f32 "penalty" array
    (0.0 = valid, +inf = masked) built on-device from field columns;
    the scan kernel gathers penalty[docid] and adds it to the distance,
    so hybrid search never materializes candidate lists on the host
    (reference: table/field_range_index.cc bitmaps + ivfpq.h:574-601
    IsValid checks in the innermost loop).
  * Hot loops are matmuls or fused XLA reductions: coarse assign is a
    (nq x d x nlist) matmul, PQ training is vmapped Lloyd iterations,
    the ADC scan uses on-the-fly LUT construction.  The accelerator is
    an NVIDIA GPU (H100); tests run on the CPU backend.
  * Multi-device: inverted lists shard over a `jax.sharding.Mesh` axis;
    each device produces a local top-k which is merged with one
    all_gather (reference's multi-GPU analog: gpu.cc:588-601).
"""

from gamma_tpu.version import __version__
from gamma_tpu.config import (
    DataType,
    EngineConfig,
    FieldInfo,
    TableInfo,
    VectorInfo,
)
from gamma_tpu.api.request import Request, VectorQuery, RangeFilter, TermFilter
from gamma_tpu.api.response import Response, SearchResult, ResultItem
from gamma_tpu.api.doc import Doc
from gamma_tpu.engine import GammaEngine

__all__ = [
    "__version__",
    "DataType",
    "EngineConfig",
    "FieldInfo",
    "TableInfo",
    "VectorInfo",
    "Request",
    "VectorQuery",
    "RangeFilter",
    "TermFilter",
    "Response",
    "SearchResult",
    "ResultItem",
    "Doc",
    "GammaEngine",
]
