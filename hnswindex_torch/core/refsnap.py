"""Reference-format snapshot interchange (protobuf-net wire layout).

A numpy copy of ``hnswindex_tpu/core/refsnap.py``, which this package may
not import.  The reference .NET library serializes
``HNSWIndexSnapshot<float[], float>`` with protobuf-net
(src/HNSWIndex/HNSWIndex.cs:210-229); this module reads and writes that
wire format, so an index crosses the implementation boundary both ways:

* ``read_snapshot(path)`` — load a snapshot produced by the reference's
  ``index.Serialize(path)`` into plain numpy structures;
* ``write_snapshot(path, ...)`` — produce a byte stream the reference's
  ``HNSWIndex<float[], float>.Deserialize(distFnc, path)`` accepts.

Wire contracts (field numbers from the [ProtoMember] attributes):

* HNSWIndexSnapshot (HNSWIndexSnapshot.cs:10-17):
    1: Parameters (message)      2: DataSnapshot (message)
* HNSWParameters (HNSWParameters.cs:7-56):
    1: MaxEdges        2: DistributionRate (double)  3: MinNN
    4: MaxCandidates   5: RemoveMaxCandidates        6: CollectionSize
    7: RandomSeed      8: AllowRemovals (bool)
* GraphDataSnapshot (GraphDataSnapshot.cs:10-36): 1: Nodes (repeated
    Node), 2: ActiveNodes (repeated int), 3: Items (repeated
    NestedArrayWrapper<float[]>), 4: RemovedIndexes (repeated int),
    5: EntryPointId, 6: Capacity, 7: Length, 8: Count
* Node (Node.cs:6-27): 1: Id, 2: IsRemoved (bool),
    3: OutEdges (repeated EdgeList), 4: InEdges (repeated EdgeList)
* EdgeList (Node.cs:30-36): 1: Buffer (repeated int), 2: Count
* NestedArrayWrapper<float[]> (NestedListWrapper.cs:15-21):
    1: Values (repeated float)

protobuf-net conventions honored here: ints are two's-complement varints
(negatives are 10 bytes); floats are non-packed fixed32 elements; repeated
ints are non-packed varints; scalar members equal to the CLR default
(0 / false) are skipped on write, and absent fields keep the C# object
initializer's value on read (e.g. ``EntryPointId = -1``,
``AllowRemovals = true``).  EdgeList buffers may carry slack beyond Count
(amortized growth, Node.cs:66-76) — readers truncate to Count.

The message grammar is the reference's.  What differs is speed: the
repeated ints and floats, which are almost all of a snapshot's bytes, are
encoded with numpy over all values at once, the items of one width are
written as one array, and every edge list is decoded in one numpy pass
over all of them.  A stream those fast paths do not cover (packed
encodings, fields out of the writer's order) is decoded by the
reference's field-by-field parser, so every conforming stream reads.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..params import HNSWParameters

_WIRE_VARINT = 0
_WIRE_F64 = 1
_WIRE_LEN = 2
_WIRE_F32 = 5
#: key of a non-packed fixed32 element of field 1
_F32_KEY1 = (1 << 3) | _WIRE_F32


# ---------------------------------------------------------------------------
# low-level decode
# ---------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _as_int32(u: int) -> int:
    u &= 0xFFFFFFFF
    return u - (1 << 32) if u & 0x80000000 else u


def _fields(buf: memoryview) -> Iterable[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, payload) triples.

    Payload is an int for varints, bytes for length-delimited, and raw
    4/8-byte buffers for fixed32/64.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fno, wt = key >> 3, key & 7
        if wt == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
            yield fno, wt, val
        elif wt == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                raise ValueError("truncated length-delimited field")
            yield fno, wt, buf[pos:pos + ln]
            pos += ln
        elif wt == _WIRE_F32:
            yield fno, wt, buf[pos:pos + 4]
            pos += 4
        elif wt == _WIRE_F64:
            yield fno, wt, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt} (field {fno})")


def _f32(payload) -> float:
    return struct.unpack("<f", payload)[0]


def _f64(payload) -> float:
    return struct.unpack("<d", payload)[0]


# ---------------------------------------------------------------------------
# message parsers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RefNode:
    id: int = 0
    is_removed: bool = False
    out_edges: List[np.ndarray] = dataclasses.field(default_factory=list)
    in_edges: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def max_layer(self) -> int:
        return len(self.out_edges) - 1


@dataclasses.dataclass
class RefSnapshot:
    params: HNSWParameters
    nodes: List[RefNode]
    items: List[np.ndarray]
    active: np.ndarray          # int32 active ids
    removed: List[int]          # free-list (stack order as serialized)
    entry_point: int
    capacity: int
    length: int
    count: int


def _packed_varints(payload: memoryview) -> List[int]:
    """Packed repeated varints (spec: readers accept packed and unpacked
    encodings interchangeably, whatever the writer chose)."""
    vals: List[int] = []
    pos = 0
    while pos < len(payload):
        v, pos = _read_varint(payload, pos)
        vals.append(_as_int32(v))
    return vals


def _parse_edge_list(buf: memoryview) -> np.ndarray:
    vals: List[int] = []
    count = 0
    for fno, wt, payload in _fields(buf):
        if fno == 1 and wt == _WIRE_VARINT:
            vals.append(_as_int32(payload))
        elif fno == 1 and wt == _WIRE_LEN:
            vals.extend(_packed_varints(payload))
        elif fno == 2 and wt == _WIRE_VARINT:
            count = _as_int32(payload)
    # Buffer carries slack beyond Count (EdgeList.Grow, Node.cs:95-106)
    return np.asarray(vals[:count], dtype=np.int32)


def _parse_node(buf: memoryview, pending: List[memoryview]) -> RefNode:
    """A node whose edge lists are left as indices into ``pending``, where
    their payloads are queued for ``_decode_edge_lists``."""
    node = RefNode()
    for fno, wt, payload in _fields(buf):
        if fno == 1 and wt == _WIRE_VARINT:
            node.id = _as_int32(payload)
        elif fno == 2 and wt == _WIRE_VARINT:
            node.is_removed = bool(payload)
        elif fno in (3, 4) and wt == _WIRE_LEN:
            (node.out_edges if fno == 3 else node.in_edges).append(
                len(pending))
            pending.append(payload)
    return node


def _varint_stream(data: np.ndarray):
    """Decode a byte array that is a run of whole varints.  Returns
    (values uint64, start byte of each) or None when it ends inside one."""
    last = (data & 0x80) == 0
    if data.size and not last[-1]:
        return None
    ends = np.flatnonzero(last)
    starts = np.concatenate([[0], ends[:-1] + 1]).astype(np.int64)
    lens = ends - starts + 1
    vals = np.zeros(ends.size, np.uint64)
    for j in range(int(lens.max()) if lens.size else 0):
        m = lens > j
        vals[m] |= (data[starts[m] + j] & 0x7F).astype(np.uint64) \
            << np.uint64(7 * j)
    return vals, starts


def _int32s(u: np.ndarray) -> np.ndarray:
    """_as_int32 over an array of uint64 varint values."""
    return (u & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)


def _decode_edge_lists(payloads: List[memoryview]) -> List[np.ndarray]:
    """Every EdgeList payload in one numpy pass: when each payload is a run
    of varint-typed (key, value) pairs, the pairs of field 1 are the buffer
    and the last field-2 value the count.  Anything else (a packed buffer,
    an unknown wire type) goes through ``_parse_edge_list``."""
    if not payloads:
        return []
    sizes = np.fromiter((len(p) for p in payloads), np.int64, len(payloads))
    data = np.frombuffer(b"".join(payloads), np.uint8)
    dec = _varint_stream(data)
    if dec is not None:
        vals, starts = dec
        list_end = np.cumsum(sizes)
        lid = np.searchsorted(list_end, starts, side="right")
        nv = np.bincount(lid, minlength=sizes.size)
        first = np.concatenate([[0], np.cumsum(nv)[:-1]])
        pos = np.arange(vals.size) - first[lid]
        keys = vals[pos % 2 == 0]
        # each list must start on a varint and hold (key, value) pairs of
        # varint-typed fields only
        ok = bool(np.isin((list_end - sizes)[sizes > 0], starts).all()
                  and (nv % 2 == 0).all()
                  and ((keys & np.uint64(7)) == _WIRE_VARINT).all())
    if dec is None or not ok:
        return [_parse_edge_list(p) for p in payloads]
    fno = (keys >> np.uint64(3)).astype(np.int64)
    pv = _int32s(vals[pos % 2 == 1])
    plid = lid[pos % 2 == 0]
    count = np.zeros(sizes.size, np.int64)
    is_cnt = fno == 2
    count[plid[is_cnt]] = pv[is_cnt]
    buf = fno == 1
    blid = plid[buf]
    nbuf = np.bincount(blid, minlength=sizes.size)
    rank = np.arange(blid.size) - np.concatenate(
        [[0], np.cumsum(nbuf)[:-1]])[blid]
    keep = rank < count[blid]
    kept = pv[buf][keep].astype(np.int32)
    return np.split(kept, np.cumsum(np.bincount(
        blid[keep], minlength=sizes.size))[:-1])


def _parse_vector(buf: memoryview) -> np.ndarray:
    raw = np.frombuffer(buf, np.uint8)
    if raw.size % 5 == 0 and (raw[::5] == _F32_KEY1).all():
        # the writer's layout: non-packed fixed32 field-1 elements
        return raw.reshape(-1, 5)[:, 1:].copy().view("<f4").ravel() \
            .astype(np.float32)
    vals: List[float] = []
    for fno, wt, payload in _fields(buf):
        if fno == 1 and wt == _WIRE_F32:
            vals.append(_f32(payload))
        elif fno == 1 and wt == _WIRE_LEN:    # packed fixed32 floats
            vals.extend(np.frombuffer(payload, dtype="<f4").tolist())
    return np.asarray(vals, dtype=np.float32)


def _parse_parameters(buf: memoryview) -> HNSWParameters:
    # start from the C# object-initializer defaults: protobuf-net skips
    # members at their CLR default on write, and absent fields keep the
    # initializer's value on read (HNSWParameters.cs:13-55)
    p = HNSWParameters()
    for fno, wt, payload in _fields(buf):
        if fno == 1 and wt == _WIRE_VARINT:
            p.max_edges = _as_int32(payload)
        elif fno == 2 and wt == _WIRE_F64:
            p.distribution_rate = _f64(payload)
        elif fno == 3 and wt == _WIRE_VARINT:
            p.min_nn = _as_int32(payload)
        elif fno == 4 and wt == _WIRE_VARINT:
            p.max_candidates = _as_int32(payload)
        elif fno == 5 and wt == _WIRE_VARINT:
            p.remove_max_candidates = _as_int32(payload)
        elif fno == 6 and wt == _WIRE_VARINT:
            p.collection_size = _as_int32(payload)
        elif fno == 7 and wt == _WIRE_VARINT:
            p.random_seed = _as_int32(payload)
        elif fno == 8 and wt == _WIRE_VARINT:
            p.allow_removals = bool(payload)
    return p


def _parse_graph_data(buf: memoryview) -> Dict:
    out: Dict = {"nodes": [], "items": [], "active": [], "removed": [],
                 "entry_point": -1, "capacity": 0, "length": 0, "count": 0}
    pending: List[memoryview] = []
    for fno, wt, payload in _fields(buf):
        if fno == 1 and wt == _WIRE_LEN:
            out["nodes"].append(_parse_node(payload, pending))
        elif fno == 2 and wt == _WIRE_VARINT:
            out["active"].append(_as_int32(payload))
        elif fno == 2 and wt == _WIRE_LEN:
            out["active"].extend(_packed_varints(payload))
        elif fno == 3 and wt == _WIRE_LEN:
            out["items"].append(_parse_vector(payload))
        elif fno == 4 and wt == _WIRE_VARINT:
            out["removed"].append(_as_int32(payload))
        elif fno == 4 and wt == _WIRE_LEN:
            out["removed"].extend(_packed_varints(payload))
        elif fno == 5 and wt == _WIRE_VARINT:
            out["entry_point"] = _as_int32(payload)
        elif fno == 6 and wt == _WIRE_VARINT:
            out["capacity"] = _as_int32(payload)
        elif fno == 7 and wt == _WIRE_VARINT:
            out["length"] = _as_int32(payload)
        elif fno == 8 and wt == _WIRE_VARINT:
            out["count"] = _as_int32(payload)
    lists = _decode_edge_lists(pending)
    for node in out["nodes"]:
        node.out_edges = [lists[i] for i in node.out_edges]
        node.in_edges = [lists[i] for i in node.in_edges]
    return out


def parse_snapshot(data: bytes) -> RefSnapshot:
    buf = memoryview(data)
    params: Optional[HNSWParameters] = None
    gd: Optional[Dict] = None
    for fno, wt, payload in _fields(buf):
        if fno == 1 and wt == _WIRE_LEN:
            params = _parse_parameters(payload)
        elif fno == 2 and wt == _WIRE_LEN:
            gd = _parse_graph_data(payload)
    if params is None:
        params = HNSWParameters()
    if gd is None:
        raise ValueError("snapshot has no GraphDataSnapshot (field 2)")
    return RefSnapshot(
        params=params, nodes=gd["nodes"], items=gd["items"],
        active=np.asarray(gd["active"], dtype=np.int32),
        removed=gd["removed"], entry_point=gd["entry_point"],
        capacity=gd["capacity"], length=gd["length"], count=gd["count"])


def read_snapshot(path: str) -> RefSnapshot:
    with open(path, "rb") as f:
        return parse_snapshot(f.read())


# ---------------------------------------------------------------------------
# low-level encode
# ---------------------------------------------------------------------------

def _varint(u: int) -> bytes:
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_int(fno: int, v: int, skip_default: bool = True) -> bytes:
    """Two's-complement varint, protobuf-net style: negatives become
    64-bit-wide (10-byte) varints; zero is skipped like the CLR default."""
    v = int(v)
    if v == 0 and skip_default:
        return b""
    key = _varint((fno << 3) | _WIRE_VARINT)
    return key + _varint(v & 0xFFFFFFFFFFFFFFFF if v < 0 else v)


def _enc_bool(fno: int, v: bool) -> bytes:
    if not v:
        return b""               # false == CLR default -> skipped
    return _varint((fno << 3) | _WIRE_VARINT) + b"\x01"


def _enc_double(fno: int, v: float) -> bytes:
    if v == 0.0:
        return b""
    return _varint((fno << 3) | _WIRE_F64) + struct.pack("<d", float(v))


def _enc_msg(fno: int, payload: bytes) -> bytes:
    return _varint((fno << 3) | _WIRE_LEN) + _varint(len(payload)) + payload


def _rep_varints(key: bytes, vals) -> Tuple[np.ndarray, np.ndarray]:
    """``key`` + varint of each value (two's complement, 64-bit wide for
    negatives) for an array of ints: (the bytes as one uint8 array, each
    value's byte count with its key)."""
    u = np.asarray(vals, dtype=np.int64).ravel().view(np.uint64)
    nb = np.ones(u.size, np.int64)
    for j in range(1, 10):
        nb += (u >> np.uint64(7 * j)) != 0
    kl = len(key)
    out = np.zeros((u.size, kl + 10), np.uint8)
    out[:, :kl] = np.frombuffer(key, np.uint8)
    j = np.arange(10)
    groups = (u[:, None] >> (np.uint64(7) * j.astype(np.uint64))) \
        & np.uint64(0x7F)
    out[:, kl:] = groups.astype(np.uint8) | np.where(
        j[None, :] < nb[:, None] - 1, 0x80, 0).astype(np.uint8)
    mask = np.zeros(out.shape, bool)
    mask[:, :kl] = True
    mask[:, kl:] = j[None, :] < nb[:, None]
    return out[mask], kl + nb


def _enc_rep_int(fno: int, vals) -> bytes:
    return _rep_varints(_varint((fno << 3) | _WIRE_VARINT),
                        vals)[0].tobytes()


def _rep_f32(fno: int, vals: np.ndarray) -> np.ndarray:
    """(n, key + 4) uint8 rows: each float's key and little-endian bytes;
    ``vals`` is (..., n) and the rows keep its leading dims."""
    v = np.ascontiguousarray(vals, dtype="<f4")
    key = np.frombuffer(_varint((fno << 3) | _WIRE_F32), np.uint8)
    out = np.empty(v.shape + (key.size + 4,), np.uint8)
    out[..., :key.size] = key
    out[..., key.size:] = v.view(np.uint8).reshape(v.shape + (4,))
    return out


def _enc_rep_f32(fno: int, vals: np.ndarray) -> bytes:
    return _rep_f32(fno, np.asarray(vals, np.float32).ravel()).tobytes()


def _enc_nodes(nodes: List[RefNode]) -> bytes:
    """Every node as a field-1 message (id, removed flag, out- then in-edge
    lists of an exactly-sized buffer and a count), with all edge-list
    values encoded in one numpy pass."""
    lists = [e for n in nodes for e in (*n.out_edges, *n.in_edges)]
    sizes = np.fromiter((len(e) for e in lists), np.int64, len(lists))
    flat = np.concatenate([np.asarray(e, np.int64).ravel() for e in lists]) \
        if lists else np.empty(0, np.int64)
    raw, nbytes = _rep_varints(_varint((1 << 3) | _WIRE_VARINT), flat)
    blob = raw.tobytes()
    bounds = np.concatenate([[0], np.cumsum(nbytes)])[
        np.concatenate([[0], np.cumsum(sizes)])].tolist()
    out = bytearray()
    i = 0
    for n in nodes:
        body = _enc_int(1, n.id) + _enc_bool(2, n.is_removed)
        for fno, group in ((3, n.out_edges), (4, n.in_edges)):
            for _ in group:
                body += _enc_msg(fno, blob[bounds[i]:bounds[i + 1]]
                                 + _enc_int(2, int(sizes[i])))
                i += 1
        out += _enc_msg(1, body)
    return bytes(out)


def _enc_items(items: List[np.ndarray]) -> bytes:
    """Every item as a field-3 message of non-packed floats; items of one
    width are written as one array."""
    widths = {int(np.asarray(x).size) for x in items}
    if len(widths) != 1:
        return b"".join(_enc_msg(3, _enc_rep_f32(1, x)) for x in items)
    rows = _rep_f32(1, np.stack([np.asarray(x, np.float32).ravel()
                                 for x in items]))
    rows = rows.reshape(len(items), -1)
    head = np.frombuffer(_varint((3 << 3) | _WIRE_LEN)
                         + _varint(rows.shape[1]), np.uint8)
    out = np.empty((len(items), head.size + rows.shape[1]), np.uint8)
    out[:, :head.size] = head
    out[:, head.size:] = rows
    return out.tobytes()


def _enc_parameters(p: HNSWParameters) -> bytes:
    out = bytearray()
    out += _enc_int(1, p.max_edges)
    out += _enc_double(2, p.distribution_rate)
    out += _enc_int(3, p.min_nn)
    out += _enc_int(4, p.max_candidates)
    out += _enc_int(5, p.remove_max_candidates)
    out += _enc_int(6, p.collection_size)
    out += _enc_int(7, p.random_seed)
    out += _enc_bool(8, p.allow_removals)
    return bytes(out)


def encode_snapshot(snap: RefSnapshot) -> bytes:
    gd = bytearray()
    gd += _enc_nodes(snap.nodes)
    gd += _enc_rep_int(2, snap.active)
    if snap.items:
        gd += _enc_items(snap.items)
    gd += _enc_rep_int(4, snap.removed)
    gd += _enc_int(5, snap.entry_point)
    gd += _enc_int(6, snap.capacity)
    gd += _enc_int(7, snap.length)
    gd += _enc_int(8, snap.count)
    return _enc_msg(1, _enc_parameters(snap.params)) + _enc_msg(2, bytes(gd))


def write_snapshot(path: str, snap: RefSnapshot) -> None:
    with open(path, "wb") as f:
        f.write(encode_snapshot(snap))
