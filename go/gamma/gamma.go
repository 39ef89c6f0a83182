// Package gamma is the Go SDK for the gamma-tpu serving surface.
//
// Reference: go/gamma/gamma.go:20-132 — the reference binds its C ABI
// via cgo + flatbuffers, which couples the Go build to the engine's
// shared object.  The engine's process model is different (the
// engine owns the GPU and serves over a socket — gamma_tpu/
// server.py), so this SDK is pure Go with zero cgo: it speaks the
// 5-byte-request / 8-byte-response frame protocol carrying GWIR
// messages (gamma_tpu/idl/wire.py), the same contract as the C++
// client (native/gamma_client.h).
//
// Wire layout (little-endian):
//
//	frame:  u8 opcode | u32 payload_len | payload
//	reply:  i32 status | u32 payload_len | payload
//	GWIR:   u32 magic 'GWIR' | u8 ver | u8 msg_type | u16 0
//	        u32 header_len | header (UTF-8 JSON)
//	        u32 n_blobs | { u32 blob_len | blob bytes } * n_blobs
//
// Large tensors travel as raw little-endian f32 blobs referenced from
// the JSON header by {"$blob": i, "dtype": "float32", "shape": [...]}.
//
// Covers the full 13-op surface: Init, Close, CreateTable,
// AddOrUpdateDocs, DeleteDoc, Search, GetDoc, BuildIndex, Flush,
// Status, Dump, Load, DelDocByQuery.
//
// Usage:
//
//	cli, err := gamma.Dial("tcp", "127.0.0.1:7070") // or "unix", path
//	cli.Init(gamma.Config{Path: "/tmp/engine"})
//	cli.CreateTable(table)
//	codes, err := cli.AddOrUpdateDocs(docs)
//	resp, err := cli.Search(req)
package gamma

import (
	"bytes"
	"encoding/binary"
	"encoding/json"
	"fmt"
	"io"
	"math"
	"net"
	"sync"
)

// Wire constants (gamma_tpu/idl/wire.py).
const (
	Magic   uint32 = 0x47574952 // 'GWIR'
	Version byte   = 1
)

// GWIR message types.
const (
	MsgConfig      byte = 1
	MsgTable       byte = 2
	MsgDoc         byte = 3
	MsgDocs        byte = 4
	MsgRequest     byte = 5
	MsgResponse    byte = 6
	MsgStatus      byte = 7
	MsgBatchResult byte = 8
)

// Frame opcodes (gamma_tpu/server.py).
const (
	OpInit            byte = 1
	OpClose           byte = 2
	OpCreateTable     byte = 3
	OpAddOrUpdateDocs byte = 4
	OpDeleteDoc       byte = 5
	OpSearch          byte = 6
	OpGetDoc          byte = 7
	OpBuildIndex      byte = 8
	OpFlush           byte = 9
	OpStatus          byte = 10
	OpDump            byte = 11
	OpLoad            byte = 12
	OpDelByQuery      byte = 13
)

// ---------------------------------------------------------------- wire

// blobRef is the JSON-side handle of a raw tensor blob.
type blobRef struct {
	Blob  int    `json:"$blob"`
	Dtype string `json:"dtype"`
	Shape []int  `json:"shape"`
}

// F32Blob encodes a []float32 as the raw little-endian buffer the wire
// carries (the Go analog of native/gamma_client.h F32Blob).
func F32Blob(v []float32) []byte {
	out := make([]byte, 4*len(v))
	for i, f := range v {
		binary.LittleEndian.PutUint32(out[4*i:], math.Float32bits(f))
	}
	return out
}

// F32FromBlob decodes a raw little-endian f32 buffer.
func F32FromBlob(b []byte) []float32 {
	out := make([]float32, len(b)/4)
	for i := range out {
		out[i] = math.Float32frombits(binary.LittleEndian.Uint32(b[4*i:]))
	}
	return out
}

// WirePack assembles one GWIR message from a JSON-marshalable header
// and raw blobs.
func WirePack(msgType byte, header interface{}, blobs [][]byte) ([]byte, error) {
	hj, err := json.Marshal(header)
	if err != nil {
		return nil, err
	}
	var buf bytes.Buffer
	var b4 [4]byte
	binary.LittleEndian.PutUint32(b4[:], Magic)
	buf.Write(b4[:])
	buf.WriteByte(Version)
	buf.WriteByte(msgType)
	buf.WriteByte(0)
	buf.WriteByte(0)
	binary.LittleEndian.PutUint32(b4[:], uint32(len(hj)))
	buf.Write(b4[:])
	buf.Write(hj)
	binary.LittleEndian.PutUint32(b4[:], uint32(len(blobs)))
	buf.Write(b4[:])
	for _, b := range blobs {
		binary.LittleEndian.PutUint32(b4[:], uint32(len(b)))
		buf.Write(b4[:])
		buf.Write(b)
	}
	return buf.Bytes(), nil
}

// WireUnpack splits one GWIR message into its raw JSON header and
// blobs, checking magic/version/type.
func WireUnpack(data []byte, expectType byte) (json.RawMessage, [][]byte, error) {
	if len(data) < 12 {
		return nil, nil, fmt.Errorf("gamma: short GWIR message (%d bytes)", len(data))
	}
	if binary.LittleEndian.Uint32(data[0:]) != Magic {
		return nil, nil, fmt.Errorf("gamma: bad magic")
	}
	if data[4] != Version {
		return nil, nil, fmt.Errorf("gamma: unsupported wire version %d", data[4])
	}
	if data[5] != expectType {
		return nil, nil, fmt.Errorf("gamma: message type %d, expected %d", data[5], expectType)
	}
	hlen := binary.LittleEndian.Uint32(data[8:])
	off := uint32(12)
	if uint32(len(data)) < off+hlen+4 {
		return nil, nil, fmt.Errorf("gamma: truncated header")
	}
	header := json.RawMessage(data[off : off+hlen])
	off += hlen
	nb := binary.LittleEndian.Uint32(data[off:])
	off += 4
	blobs := make([][]byte, 0, nb)
	for i := uint32(0); i < nb; i++ {
		if uint32(len(data)) < off+4 {
			return nil, nil, fmt.Errorf("gamma: truncated blob table")
		}
		bl := binary.LittleEndian.Uint32(data[off:])
		off += 4
		if uint32(len(data)) < off+bl {
			return nil, nil, fmt.Errorf("gamma: truncated blob %d", i)
		}
		blobs = append(blobs, data[off:off+bl])
		off += bl
	}
	return header, blobs, nil
}

// --------------------------------------------------------------- types

// Config mirrors gamma_tpu.config.EngineConfig (reference:
// idl/fbs/config.fbs {path, log_dir} plus the engine's knobs).
// Zero values fall back to the engine-side defaults.
type Config struct {
	Path                string `json:"path"`
	LogDir              string `json:"log_dir,omitempty"`
	MaxDocSize          int    `json:"max_doc_size,omitempty"`
	MaxConcurrent       int    `json:"max_concurrent,omitempty"`
	NativePersistence   *bool  `json:"native_persistence,omitempty"`
	VectorCacheMB       int    `json:"vector_cache_mb,omitempty"`
	CompressTableBlocks bool   `json:"compress_table_blocks,omitempty"`
}

// Field data types (gamma_tpu.config.DataType; reference table.fbs).
const (
	DataTypeInt    = 0
	DataTypeLong   = 1
	DataTypeFloat  = 2
	DataTypeDouble = 3
	DataTypeString = 4
)

// FieldInfo is one scalar column (reference: table.fbs FieldInfo).
type FieldInfo struct {
	Name     string `json:"name"`
	DataType int    `json:"data_type"`
	IsIndex  bool   `json:"is_index"`
}

// VectorInfo is one vector field (reference: table.fbs VectorInfo).
type VectorInfo struct {
	Name       string                 `json:"name"`
	Dimension  int                    `json:"dimension"`
	StoreType  string                 `json:"store_type,omitempty"` // MemoryOnly | Mmap | Disk
	StoreParam map[string]interface{} `json:"store_param,omitempty"`
	DataType   int                    `json:"data_type"`
	IsIndex    bool                   `json:"is_index"`
}

// TableInfo is the per-table schema (reference: table.fbs:23-35).
type TableInfo struct {
	Name            string                   `json:"name"`
	Fields          []FieldInfo              `json:"fields"`
	Vectors         []VectorInfo             `json:"vectors"`
	IndexingSize    int                      `json:"indexing_size,omitempty"`
	RetrievalTypes  []string                 `json:"retrieval_types,omitempty"`
	RetrievalParams []map[string]interface{} `json:"retrieval_params,omitempty"`
}

// Doc is one document: scalar fields + named dense vectors.
type Doc struct {
	Key     interface{} // string or integer key
	Fields  map[string]interface{}
	Vectors map[string][]float32
}

// VectorQuery is one per-field query block (reference:
// request.fbs VectorQuery). A nil Min/MaxScore means unbounded.
type VectorQuery struct {
	Name     string
	Value    []float32 // req_num queries flattened, row-major
	MinScore *float64
	MaxScore *float64
	Boost    float64
	HasBoost bool
}

// RangeFilter is a numeric range filter (reference: request.fbs).
type RangeFilter struct {
	Field        string      `json:"field"`
	LowerValue   interface{} `json:"lower_value"`
	UpperValue   interface{} `json:"upper_value"`
	IncludeLower bool        `json:"include_lower"`
	IncludeUpper bool        `json:"include_upper"`
}

// TermFilter is a string term filter; IsUnion selects OR(1) / AND(0) /
// NOT(2) across terms (reference: request.fbs TermFilter; the engine's
// is_union extension for NOT).
type TermFilter struct {
	Field   string   `json:"field"`
	Value   []string `json:"value"`
	IsUnion int      `json:"is_union"`
}

// Request mirrors gamma_tpu.api.request.Request (reference:
// request.fbs:27-41).
type Request struct {
	TopN             int
	ReqNum           int
	BruteForceSearch bool
	MultiVectorRank  int
	L2Sqrt           bool
	OnlineLogLevel   string
	Fields           []string
	RetrievalParams  map[string]interface{}
	VecFields        []VectorQuery
	RangeFilters     []RangeFilter
	TermFilters      []TermFilter
}

// ResultItem is one hit.
type ResultItem struct {
	Score      float64                `json:"score"`
	Docid      int                    `json:"docid"`
	Key        interface{}            `json:"key"`
	Attributes map[string]interface{} `json:"attributes"`
}

// SearchResult is the per-query result list.
type SearchResult struct {
	Total      int          `json:"total"`
	ResultCode int          `json:"result_code"`
	Msg        string       `json:"msg"`
	Items      []ResultItem `json:"items"`
}

// Response mirrors gamma_tpu.api.response.Response.
type Response struct {
	OnlineLogMessage string         `json:"online_log_message"`
	Results          []SearchResult `json:"results"`
}

// EngineStatus mirrors gamma_tpu.api.status.EngineStatus (reference:
// engine_status.fbs). IndexStatus: 0 UNINDEXED, 1 INDEXING, 2 INDEXED.
type EngineStatus struct {
	IndexStatus        int `json:"index_status"`
	TableMemBytes      int `json:"table_mem_bytes"`
	IndexMemBytes      int `json:"index_mem_bytes"`
	VectorMemBytes     int `json:"vector_mem_bytes"`
	FieldRangeMemBytes int `json:"field_range_mem_bytes"`
	BitmapMemBytes     int `json:"bitmap_mem_bytes"`
	DocCount           int `json:"doc_count"`
	MaxDocid           int `json:"max_docid"`
	MinIndexedNum      int `json:"min_indexed_num"`
	DeleteNum          int `json:"delete_num"`
}

// ------------------------------------------------------------ packing

// PackDocs assembles the MSG_DOCS message: vectors become f32 blobs
// referenced from the JSON header (wire.py pack_docs).
func PackDocs(docs []Doc) ([]byte, error) {
	blobs := make([][]byte, 0, len(docs))
	hdocs := make([]map[string]interface{}, 0, len(docs))
	for _, d := range docs {
		vecs := make(map[string]interface{}, len(d.Vectors))
		for name, v := range d.Vectors {
			vecs[name] = blobRef{Blob: len(blobs), Dtype: "float32",
				Shape: []int{len(v)}}
			blobs = append(blobs, F32Blob(v))
		}
		fields := d.Fields
		if fields == nil {
			fields = map[string]interface{}{}
		}
		hdocs = append(hdocs, map[string]interface{}{
			"key": d.Key, "fields": fields, "vectors": vecs,
		})
	}
	return WirePack(MsgDocs, map[string]interface{}{"docs": hdocs}, blobs)
}

// PackRequest assembles the MSG_REQUEST message (wire.py pack_request).
func PackRequest(req Request) ([]byte, error) {
	blobs := make([][]byte, 0, len(req.VecFields))
	vf := make([]map[string]interface{}, 0, len(req.VecFields))
	for _, q := range req.VecFields {
		ref := blobRef{Blob: len(blobs), Dtype: "float32",
			Shape: []int{len(q.Value)}}
		blobs = append(blobs, F32Blob(q.Value))
		boost := q.Boost
		if !q.HasBoost && boost == 0 {
			boost = 1.0
		}
		vf = append(vf, map[string]interface{}{
			"name": q.Name, "value": ref,
			"min_score": q.MinScore, "max_score": q.MaxScore,
			"boost": boost, "has_boost": q.HasBoost,
		})
	}
	topn := req.TopN
	if topn == 0 {
		topn = 10
	}
	reqNum := req.ReqNum
	if reqNum == 0 {
		reqNum = 1
	}
	fields := req.Fields
	if fields == nil {
		fields = []string{}
	}
	rp := req.RetrievalParams
	if rp == nil {
		rp = map[string]interface{}{}
	}
	rf := req.RangeFilters
	if rf == nil {
		rf = []RangeFilter{}
	}
	tf := req.TermFilters
	if tf == nil {
		tf = []TermFilter{}
	}
	h := map[string]interface{}{
		"topn":               topn,
		"req_num":            reqNum,
		"brute_force_search": req.BruteForceSearch,
		"multi_vector_rank":  req.MultiVectorRank,
		"l2_sqrt":            req.L2Sqrt,
		"online_log_level":   req.OnlineLogLevel,
		"fields":             fields,
		"retrieval_params":   rp,
		"vec_fields":         vf,
		"range_filters":      rf,
		"term_filters":       tf,
	}
	return WirePack(MsgRequest, h, blobs)
}

// UnpackResponse parses a MSG_RESPONSE payload.
func UnpackResponse(data []byte) (*Response, error) {
	h, _, err := WireUnpack(data, MsgResponse)
	if err != nil {
		return nil, err
	}
	var resp Response
	if err := json.Unmarshal(h, &resp); err != nil {
		return nil, err
	}
	return &resp, nil
}

// UnpackDoc parses a MSG_DOC payload, resolving vector blob refs.
func UnpackDoc(data []byte) (*Doc, error) {
	h, blobs, err := WireUnpack(data, MsgDoc)
	if err != nil {
		return nil, err
	}
	var raw struct {
		Key     interface{}            `json:"key"`
		Fields  map[string]interface{} `json:"fields"`
		Vectors map[string]blobRef     `json:"vectors"`
	}
	if err := json.Unmarshal(h, &raw); err != nil {
		return nil, err
	}
	doc := &Doc{Key: raw.Key, Fields: raw.Fields,
		Vectors: make(map[string][]float32, len(raw.Vectors))}
	for name, ref := range raw.Vectors {
		if ref.Blob < 0 || ref.Blob >= len(blobs) {
			return nil, fmt.Errorf("gamma: doc vector %q references blob %d of %d",
				name, ref.Blob, len(blobs))
		}
		doc.Vectors[name] = F32FromBlob(blobs[ref.Blob])
	}
	return doc, nil
}

// UnpackBatchResult parses a MSG_BATCH_RESULT payload into per-doc codes.
func UnpackBatchResult(data []byte) ([]int, error) {
	h, _, err := WireUnpack(data, MsgBatchResult)
	if err != nil {
		return nil, err
	}
	var raw struct {
		Codes []int `json:"codes"`
	}
	if err := json.Unmarshal(h, &raw); err != nil {
		return nil, err
	}
	return raw.Codes, nil
}

// UnpackStatus parses a MSG_STATUS payload.
func UnpackStatus(data []byte) (*EngineStatus, error) {
	h, _, err := WireUnpack(data, MsgStatus)
	if err != nil {
		return nil, err
	}
	var st EngineStatus
	if err := json.Unmarshal(h, &st); err != nil {
		return nil, err
	}
	return &st, nil
}

// --------------------------------------------------------------- client

// StatusError is a non-zero engine status returned for an op.
type StatusError struct {
	Op     byte
	Status int32
}

func (e *StatusError) Error() string {
	return fmt.Sprintf("gamma: server returned status %d for op %d", e.Status, e.Op)
}

// Client is one connection to a gamma-tpu server. One engine handle is
// bound per connection (created by Init). Safe for concurrent use; one
// call is in flight per connection at a time.
type Client struct {
	conn net.Conn
	mu   sync.Mutex
}

// Dial connects to a gamma-tpu server. network is "tcp" or "unix";
// addr is "host:port" or a socket path respectively.
func Dial(network, addr string) (*Client, error) {
	conn, err := net.Dial(network, addr)
	if err != nil {
		return nil, err
	}
	return &Client{conn: conn}, nil
}

// Close closes the connection (the server closes its engine handle on
// disconnect; call CloseEngine first for an explicit engine shutdown).
func (c *Client) Close() error { return c.conn.Close() }

// Call issues one raw frame and returns (status, reply payload).
func (c *Client) Call(op byte, payload []byte) (int32, []byte, error) {
	c.mu.Lock()
	defer c.mu.Unlock()
	var hdr [5]byte
	hdr[0] = op
	binary.LittleEndian.PutUint32(hdr[1:], uint32(len(payload)))
	if _, err := c.conn.Write(hdr[:]); err != nil {
		return 0, nil, err
	}
	if len(payload) > 0 {
		if _, err := c.conn.Write(payload); err != nil {
			return 0, nil, err
		}
	}
	var rsp [8]byte
	if _, err := io.ReadFull(c.conn, rsp[:]); err != nil {
		return 0, nil, err
	}
	status := int32(binary.LittleEndian.Uint32(rsp[0:]))
	plen := binary.LittleEndian.Uint32(rsp[4:])
	out := make([]byte, plen)
	if plen > 0 {
		if _, err := io.ReadFull(c.conn, out); err != nil {
			return 0, nil, err
		}
	}
	return status, out, nil
}

// call wraps Call, mapping a non-zero status to StatusError.
func (c *Client) call(op byte, payload []byte) ([]byte, error) {
	status, out, err := c.Call(op, payload)
	if err != nil {
		return nil, err
	}
	if status != 0 {
		return nil, &StatusError{Op: op, Status: status}
	}
	return out, nil
}

// Init creates the engine handle for this connection.
func (c *Client) Init(cfg Config) error {
	msg, err := WirePack(MsgConfig, cfg, nil)
	if err != nil {
		return err
	}
	_, err = c.call(OpInit, msg)
	return err
}

// CreateTable declares the table schema.
func (c *Client) CreateTable(info TableInfo) error {
	msg, err := WirePack(MsgTable, info, nil)
	if err != nil {
		return err
	}
	_, err = c.call(OpCreateTable, msg)
	return err
}

// AddOrUpdateDocs ingests a batch; returns one status code per doc.
func (c *Client) AddOrUpdateDocs(docs []Doc) ([]int, error) {
	msg, err := PackDocs(docs)
	if err != nil {
		return nil, err
	}
	out, err := c.call(OpAddOrUpdateDocs, msg)
	if err != nil {
		return nil, err
	}
	return UnpackBatchResult(out)
}

// DeleteDoc removes one doc by key.
func (c *Client) DeleteDoc(key string) error {
	_, err := c.call(OpDeleteDoc, []byte(key))
	return err
}

// Search runs one (possibly batched, filtered, multi-vector) request.
func (c *Client) Search(req Request) (*Response, error) {
	msg, err := PackRequest(req)
	if err != nil {
		return nil, err
	}
	out, err := c.call(OpSearch, msg)
	if err != nil {
		return nil, err
	}
	return UnpackResponse(out)
}

// GetDoc fetches one doc by key (nil, StatusError{-1} when absent).
func (c *Client) GetDoc(key string) (*Doc, error) {
	out, err := c.call(OpGetDoc, []byte(key))
	if err != nil {
		return nil, err
	}
	return UnpackDoc(out)
}

// BuildIndex triggers training + indexing of buffered vectors.
func (c *Client) BuildIndex() error {
	_, err := c.call(OpBuildIndex, nil)
	return err
}

// Flush drains the realtime ingest pump.
func (c *Client) Flush() error {
	_, err := c.call(OpFlush, nil)
	return err
}

// Status returns index state + per-subsystem memory + doc counts.
func (c *Client) Status() (*EngineStatus, error) {
	out, err := c.call(OpStatus, nil)
	if err != nil {
		return nil, err
	}
	return UnpackStatus(out)
}

// Dump checkpoints the engine to its configured path.
func (c *Client) Dump() error {
	_, err := c.call(OpDump, nil)
	return err
}

// Load restores the engine from its newest valid checkpoint.
func (c *Client) Load() error {
	_, err := c.call(OpLoad, nil)
	return err
}

// DelDocByQuery deletes every doc matching the request's range/term
// filters; returns the deleted count.
func (c *Client) DelDocByQuery(req Request) (int, error) {
	msg, err := PackRequest(req)
	if err != nil {
		return 0, err
	}
	status, _, err := c.Call(OpDelByQuery, msg)
	if err != nil {
		return 0, err
	}
	if status < 0 {
		return 0, &StatusError{Op: OpDelByQuery, Status: status}
	}
	return int(status), nil
}

// CloseEngine shuts the engine handle down explicitly.
func (c *Client) CloseEngine() error {
	_, err := c.call(OpClose, nil)
	return err
}
