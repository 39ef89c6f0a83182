"""Configuration / schema data model.

Mirrors the capability of gamma's three config tiers (reference:
idl/fbs/config.fbs, idl/fbs/table.fbs:23-35, and the per-model JSON
retrieval_params parsed in index/impl/gamma_index_ivfpq.h:708-851) as plain
Python dataclasses.  All of these round-trip through JSON for
checkpointing (`<table>.schema`, reference: search/gamma_table_io.h:15-40).
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Dict, List, Optional


class DataType(enum.IntEnum):
    """Scalar / vector field types (reference: c_api/api_data/gamma_doc.h)."""

    INT = 0
    LONG = 1
    FLOAT = 2
    DOUBLE = 3
    STRING = 4
    VECTOR = 5


# numpy dtype for each fixed-width scalar type
FIXED_WIDTH_NUMPY = {
    DataType.INT: "int32",
    DataType.LONG: "int64",
    DataType.FLOAT: "float32",
    DataType.DOUBLE: "float64",
}


class MetricType(enum.IntEnum):
    """Distance metric (reference: index/retrieval_model.h DistanceComputeType)."""

    INNER_PRODUCT = 0
    L2 = 1


def _asdict(obj) -> Dict[str, Any]:
    d = dataclasses.asdict(obj)
    return d


@dataclasses.dataclass
class EngineConfig:
    """Engine-level config (reference: idl/fbs/config.fbs {path, log_dir})."""

    path: str
    log_dir: str = ""
    # host-side caches / limits
    max_doc_size: int = 10_000_000
    # admission control: max concurrent device search batches;
    # <= 0 → derived from host CPU count at engine init (the reference
    # derives its width from /proc limits, gamma_engine.cc:74-97)
    max_concurrent: int = 0
    # incremental persistence over native mmap segments (reference:
    # StorageManager + AsyncWriter); falls back to whole-corpus legacy
    # dumps when libgamma_host.so is unavailable or this is False
    native_persistence: bool = True
    # disk-tier row-block LRU capacity, runtime-alterable via SetConfig
    # (reference: AlterCacheSize, gamma_engine.cc:1366-1382)
    vector_cache_mb: int = 64
    # zstd block compression of the persisted table columns (reference:
    # storage/compress/compressor_zstd.h table blocks); vector-segment
    # compression is per-field via store_param {"compress": "zstd"}
    compress_table_blocks: bool = False

    def to_json(self) -> str:
        return json.dumps(_asdict(self))

    @staticmethod
    def from_json(s: str) -> "EngineConfig":
        return EngineConfig(**json.loads(s))


@dataclasses.dataclass
class FieldInfo:
    """One scalar field (reference: idl/fbs/table.fbs FieldInfo)."""

    name: str
    data_type: DataType
    is_index: bool = False

    def to_dict(self):
        return {"name": self.name, "data_type": int(self.data_type),
                "is_index": self.is_index}

    @staticmethod
    def from_dict(d):
        return FieldInfo(d["name"], DataType(d["data_type"]), d["is_index"])


@dataclasses.dataclass
class VectorInfo:
    """One vector field (reference: idl/fbs/table.fbs VectorInfo)."""

    name: str
    dimension: int
    store_type: str = "MemoryOnly"   # MemoryOnly | Mmap | Disk (="RocksDB")
    store_param: Dict[str, Any] = dataclasses.field(default_factory=dict)
    data_type: DataType = DataType.FLOAT
    is_index: bool = True

    def to_dict(self):
        return {
            "name": self.name,
            "dimension": self.dimension,
            "store_type": self.store_type,
            "store_param": self.store_param,
            "data_type": int(self.data_type),
            "is_index": self.is_index,
        }

    @staticmethod
    def from_dict(d):
        return VectorInfo(
            d["name"], d["dimension"], d.get("store_type", "MemoryOnly"),
            d.get("store_param", {}), DataType(d.get("data_type", 2)),
            d.get("is_index", True),
        )


@dataclasses.dataclass
class TableInfo:
    """Per-table schema (reference: idl/fbs/table.fbs:23-35).

    `retrieval_types` may name several models built over the same vectors
    (e.g. ["IVFPQ", "FLAT"]); `retrieval_params` is one dict per model.
    """

    name: str
    fields: List[FieldInfo] = dataclasses.field(default_factory=list)
    vectors: List[VectorInfo] = dataclasses.field(default_factory=list)
    indexing_size: int = 100_000       # train threshold (table.fbs indexing_size)
    retrieval_types: List[str] = dataclasses.field(default_factory=lambda: ["IVFPQ"])
    retrieval_params: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name,
            "fields": [f.to_dict() for f in self.fields],
            "vectors": [v.to_dict() for v in self.vectors],
            "indexing_size": self.indexing_size,
            "retrieval_types": self.retrieval_types,
            "retrieval_params": self.retrieval_params,
        })

    @staticmethod
    def from_json(s: str) -> "TableInfo":
        d = json.loads(s)
        return TableInfo(
            name=d["name"],
            fields=[FieldInfo.from_dict(f) for f in d["fields"]],
            vectors=[VectorInfo.from_dict(v) for v in d["vectors"]],
            indexing_size=d.get("indexing_size", 100_000),
            retrieval_types=d.get("retrieval_types", ["IVFPQ"]),
            retrieval_params=d.get("retrieval_params", []),
        )


@dataclasses.dataclass
class IVFPQParams:
    """IVFPQ model params with gamma's defaults
    (reference: index/impl/gamma_index_ivfpq.h:675-707)."""

    ncentroids: int = 2048
    nsubvector: int = 64
    nbits_per_idx: int = 8
    nprobe: int = 80
    metric_type: MetricType = MetricType.L2
    has_opq: bool = False
    bucket_init_size: int = 1000
    bucket_max_size: int = 1_280_000
    training_threshold: int = 0        # 0 → derived from indexing_size
    # "auto" | "dense" | "gather" — see gamma_tpu/index/ivfpq.py docstring
    scan_mode: str = "auto"
    # capacity-tier posting payload: "sq8" (residual int8 sidecar, exact
    # scan, no rerank — ops/sq.py) | "pq" (M-byte ADC scan, the
    # extreme-capacity format); "" → the model's default
    gather_payload: str = ""
    # extra split-biggest k-means rounds bounding the longest inverted
    # list near the mean (ops/kmeans._rebalance).  The longest list sets
    # the posting cap AND the per-probe scan width (cap_eff): at the 10M
    # geometry the default's 3x-mean max list tripled the gather-tier
    # scan width
    train_rebalance: int = 2

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "IVFPQParams":
        d = dict(d or {})
        p = IVFPQParams()
        p.ncentroids = int(d.get("ncentroids", p.ncentroids))
        p.nsubvector = int(d.get("nsubvector", p.nsubvector))
        p.nbits_per_idx = int(d.get("nbits_per_idx", p.nbits_per_idx))
        p.nprobe = int(d.get("nprobe", p.nprobe))
        mt = d.get("metric_type", "L2")
        if isinstance(mt, str):
            p.metric_type = (MetricType.INNER_PRODUCT
                             if mt.upper() in ("INNERPRODUCT", "IP", "INNER_PRODUCT")
                             else MetricType.L2)
        else:
            p.metric_type = MetricType(mt)
        p.has_opq = bool(d.get("has_opq", False))
        p.bucket_init_size = int(d.get("bucket_init_size", p.bucket_init_size))
        p.bucket_max_size = int(d.get("bucket_max_size", p.bucket_max_size))
        p.training_threshold = int(d.get("training_threshold", 0))
        p.scan_mode = str(d.get("scan_mode", "auto"))
        p.gather_payload = str(d.get("gather_payload", ""))
        p.train_rebalance = int(d.get("train_rebalance",
                                      p.train_rebalance))
        # the reference accepts an "hnsw" sub-object selecting an HNSW
        # coarse quantizer (gamma_index_ivfpq.cc:146-156 via the params'
        # GetObject("hnsw")).  This engine SUBSTITUTES flat assign (one
        # B x d x nlist matmul instead of a graph traversal for
        # nlist <= ~64k) — fail loudly instead of silently ignoring a
        # param that changes the reference's recall/latency profile.
        for key in ("hnsw", "quantizer_type"):
            if key in d and str(d[key]).lower() not in ("", "flat"):
                raise ValueError(
                    f"IVFPQ param {key!r}={d[key]!r}: the HNSW coarse "
                    "quantizer is substituted by flat matmul assignment "
                    "(documented deviation, see index/ivfpq.py module "
                    "docstring); omit the param or use the standalone "
                    "HNSW retrieval model")
        return p


@dataclasses.dataclass
class SearchParams:
    """Per-request retrieval params (reference: gamma_index_ivfpq.cc:216-270
    RetrievalModel::Parse of the request's retrieval_params JSON)."""

    metric_type: Optional[MetricType] = None
    nprobe: Optional[int] = None
    recall_num: int = 100              # coarse candidates before rerank (ivfpq.h:633)
    parallel_on_queries: bool = True   # kept for API parity; batching handles it
    has_rank: bool = True              # exact rerank with raw vectors
    l2_sqrt: bool = False
    scan_mode: Optional[str] = None    # per-request "dense"/"gather" override
    ef_search: Optional[int] = None    # HNSW beam width (reference: efSearch)
    # SQ8 capacity tier: rerank the top-recall_num exact-SQ candidates
    # against the raw store mirror (recovers the quantization misrank at
    # 10M-scale near-tie density).
    # Off by default: the tier's point is rerank-free serving, and the
    # mirror may not be resident at capacity scales.
    sq_rerank: bool = False

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "SearchParams":
        d = dict(d or {})
        p = SearchParams()
        if "metric_type" in d:
            mt = d["metric_type"]
            if isinstance(mt, str):
                p.metric_type = (MetricType.INNER_PRODUCT
                                 if mt.upper() in ("INNERPRODUCT", "IP", "INNER_PRODUCT")
                                 else MetricType.L2)
            else:
                p.metric_type = MetricType(mt)
        if "nprobe" in d:
            p.nprobe = int(d["nprobe"])
        p.recall_num = int(d.get("recall_num", p.recall_num))
        p.parallel_on_queries = bool(d.get("parallel_on_queries", True))
        p.has_rank = bool(d.get("has_rank", True))
        p.l2_sqrt = bool(d.get("l2_sqrt", False))
        if "scan_mode" in d:
            p.scan_mode = str(d["scan_mode"])
        # keys this engine no longer reads (older clients still send the
        # retired approximate-select recall target) are ignored
        if "efSearch" in d or "ef_search" in d:
            p.ef_search = int(d.get("efSearch", d.get("ef_search")))
        p.sq_rerank = bool(d.get("sq_rerank", False))
        return p
