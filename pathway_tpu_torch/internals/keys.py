"""128-bit row keys (port of ``pathway_tpu/internals/keys.py``).

A batch of keys is a structured numpy array with ``hi``/``lo`` uint64 fields;
a scalar key is a :class:`Pointer`. A key is the XXH3-128 fingerprint of the
salted serialisation of its values, with the reference's byte layout, so the
port derives bit-identical keys. The hash is the port's own, twice: in C++ in
the native module (``csrc/pathway_native.cc``: typed columns serialise and
hash in one call), and in Python and numpy (``internals/xxh3.py``: batches
hash one numpy pass per group of serialisations of equal length), which the
engine uses when the native module is disabled or cannot be built.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Any, Callable, Iterable, List, Sequence

import numpy as np

from pathway_tpu_torch import native as _native
from pathway_tpu_torch.native import I64P as _I64P
from pathway_tpu_torch.native import U8P as _U8P
from pathway_tpu_torch.native import U64P as _U64P
from pathway_tpu_torch.internals.xxh3 import xxh3_128, xxh3_128_rows

KEY_DTYPE = np.dtype([("hi", "<u8"), ("lo", "<u8")])

# host seconds and keys of the batch derivations below, for the ingest breakdown
KEY_DERIVATION = {"seconds": 0.0, "keys": 0}


def _timed(fn: Callable[..., np.ndarray]) -> Callable[..., np.ndarray]:
    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> np.ndarray:
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        KEY_DERIVATION["seconds"] += time.perf_counter() - t0
        KEY_DERIVATION["keys"] += len(out)
        return out

    return wrapper


_SALT = b"pathway-tpu-v1"


class Pointer:
    """User-visible 128-bit row reference."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi: int, lo: int):
        object.__setattr__(self, "hi", int(hi) & 0xFFFFFFFFFFFFFFFF)
        object.__setattr__(self, "lo", int(lo) & 0xFFFFFFFFFFFFFFFF)

    def __setattr__(self, *a: Any) -> None:
        raise AttributeError("Pointer is immutable")

    def __reduce__(self):
        return (Pointer, (self.hi, self.lo))

    def as_int(self) -> int:
        return (self.hi << 64) | self.lo

    def __repr__(self) -> str:
        return f"^{self.as_int():032X}"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Pointer) and other.hi == self.hi and other.lo == self.lo

    def __lt__(self, other: "Pointer") -> bool:
        return (self.hi, self.lo) < (other.hi, other.lo)

    def __le__(self, other: "Pointer") -> bool:
        return (self.hi, self.lo) <= (other.hi, other.lo)

    def __gt__(self, other: "Pointer") -> bool:
        return (self.hi, self.lo) > (other.hi, other.lo)

    def __ge__(self, other: "Pointer") -> bool:
        return (self.hi, self.lo) >= (other.hi, other.lo)

    def __hash__(self) -> int:
        return hash((self.hi, self.lo))


def _bswap64(x: int) -> int:
    return int.from_bytes(x.to_bytes(8, "little"), "big")


def _fingerprint_bytes(data: bytes) -> tuple[int, int]:
    # the reference reads the canonical (big-endian) digest little-endian
    high, low = xxh3_128(data)
    return _bswap64(high), _bswap64(low)


def _native_hash_serialized(buf: bytes, offsets: np.ndarray, n: int, lib: Any) -> np.ndarray:
    hi = np.empty(n, dtype=np.uint64)
    lo = np.empty(n, dtype=np.uint64)
    offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
    lib.pwtpu_hash_serialized(
        buf, offsets.ctypes.data_as(_U64P), n, hi.ctypes.data_as(_U64P), lo.ctypes.data_as(_U64P)
    )
    out = np.empty(n, dtype=KEY_DTYPE)
    out["hi"], out["lo"] = hi, lo
    return out


# below this many messages of one length, the Python hash beats numpy's overhead
_ROWS_MIN = 16


def fingerprint_many(blobs: Sequence[bytes]) -> np.ndarray:
    """Keys of many serialisations: one native call, or without the native
    module one numpy hash per group of equal length."""
    lib = _native.get_lib()
    if lib is not None:
        offsets = np.zeros(len(blobs) + 1, dtype=np.uint64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        return _native_hash_serialized(b"".join(blobs), offsets, len(blobs), lib)
    out = np.empty(len(blobs), dtype=KEY_DTYPE)
    by_len: dict = {}
    for i, b in enumerate(blobs):
        by_len.setdefault(len(b), []).append(i)
    for n, idx in by_len.items():
        if len(idx) < _ROWS_MIN:
            for i in idx:
                out["hi"][i], out["lo"][i] = _fingerprint_bytes(blobs[i])
            continue
        data = np.frombuffer(b"".join(blobs[i] for i in idx), dtype=np.uint8)
        high, low = xxh3_128_rows(data.reshape(len(idx), n))
        out["hi"][idx] = high.byteswap()
        out["lo"][idx] = low.byteswap()
    return out


def _serialize_value(value: Any, out: list[bytes]) -> None:
    """Deterministic serialization of an engine value for fingerprinting."""
    if value is None:
        out.append(b"\x00")
    elif isinstance(value, Pointer):
        out.append(b"\x01" + value.hi.to_bytes(8, "little") + value.lo.to_bytes(8, "little"))
    elif isinstance(value, (bool, np.bool_)):
        out.append(b"\x02\x01" if value else b"\x02\x00")
    elif isinstance(value, (int, np.integer)):
        out.append(b"\x03" + int(value).to_bytes(16, "little", signed=True))
    elif isinstance(value, (float, np.floating)):
        out.append(b"\x04" + np.float64(value).tobytes())
    elif isinstance(value, str):
        encoded = value.encode()
        out.append(b"\x05" + len(encoded).to_bytes(8, "little") + encoded)
    elif isinstance(value, bytes):
        out.append(b"\x06" + len(value).to_bytes(8, "little") + value)
    elif isinstance(value, (tuple, list)):
        out.append(b"\x07" + len(value).to_bytes(8, "little"))
        for item in value:
            _serialize_value(item, out)
    elif isinstance(value, np.void) and value.dtype == KEY_DTYPE:
        out.append(
            b"\x01"
            + int(value["hi"]).to_bytes(8, "little")
            + int(value["lo"]).to_bytes(8, "little")
        )
    elif isinstance(value, np.ndarray):
        out.append(b"\x08" + str(value.dtype).encode() + str(value.shape).encode() + value.tobytes())
    else:
        from pathway_tpu_torch.internals.json import Json

        if isinstance(value, Json):
            encoded = value.dumps().encode()
            out.append(b"\x09" + len(encoded).to_bytes(8, "little") + encoded)
        elif isinstance(value, dict):
            items = sorted(
                ((repr(k), k, v) for k, v in value.items()), key=lambda kv: kv[0]
            )
            out.append(b"\x0b" + len(items).to_bytes(8, "little"))
            for _, k, v in items:
                _serialize_value(k, out)
                _serialize_value(v, out)
        elif isinstance(value, (set, frozenset)):
            parts: list[list[bytes]] = []
            for item in value:
                chunk: list[bytes] = []
                _serialize_value(item, chunk)
                parts.append(chunk)
            out.append(b"\x0c" + len(parts).to_bytes(8, "little"))
            for chunk in sorted(parts, key=b"".join):
                out.extend(chunk)
        else:
            encoded = repr(value).encode()
            out.append(b"\x0a" + len(encoded).to_bytes(8, "little") + encoded)


# -- single-int identity-mix keys ----------------------------------------------
# A key of exactly one int value is a splitmix-style 128-bit mix instead of a
# hash of its serialisation (the reference's rule, kept bit for bit).

#: v1: a salted xxh3 for every value kind; v2: the splitmix mix for single-int
#: keys. Journals and checkpoints store derived keys and record this version:
#: ``persistence/engine.py`` refuses a store written under another
KEY_DERIVATION_VERSION = 2
_INTKEY_LO = 0x9E3779B97F4A7C15
_INTKEY_HI = 0xD6E8FEB86659FD93
_MIX_M1 = 0xBF58476D1CE4E5B9
_MIX_M2 = 0x94D049BB133111EB
_U64 = (1 << 64) - 1
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


def _mix64(x: int) -> int:
    x ^= x >> 30
    x = (x * _MIX_M1) & _U64
    x ^= x >> 27
    x = (x * _MIX_M2) & _U64
    x ^= x >> 31
    return x


def _is_plain_int(value: Any) -> bool:
    return (
        isinstance(value, (int, np.integer))
        and not isinstance(value, (bool, np.bool_))
        and _INT64_MIN <= int(value) <= _INT64_MAX
    )


def _int_key(value: int) -> tuple[int, int]:
    u = value & _U64
    return _mix64(u ^ _INTKEY_HI), _mix64((u + _INTKEY_LO) & _U64)


def _int_keys_array(col: np.ndarray) -> np.ndarray:
    """Vectorized mix for an int64 column — bit-identical to the scalar."""
    u = np.ascontiguousarray(col, dtype=np.int64).view(np.uint64)
    out = np.empty(len(col), dtype=KEY_DTYPE)

    def mix(x: np.ndarray) -> np.ndarray:
        x = x ^ (x >> np.uint64(30))
        x = x * np.uint64(_MIX_M1)
        x = x ^ (x >> np.uint64(27))
        x = x * np.uint64(_MIX_M2)
        x = x ^ (x >> np.uint64(31))
        return x

    out["hi"] = mix(u ^ np.uint64(_INTKEY_HI))
    out["lo"] = mix(u + np.uint64(_INTKEY_LO))
    return out


def _salted(parts: Iterable[Any]) -> bytes:
    chunks: list[bytes] = [_SALT]
    for part in parts:
        _serialize_value(part, chunks)
    return b"".join(chunks)


def pointer_from(*parts: Any) -> Pointer:
    """Fingerprint values into a key."""
    if len(parts) == 1 and _is_plain_int(parts[0]):
        return Pointer(*_int_key(int(parts[0])))
    hi, lo = _fingerprint_bytes(_salted(parts))
    return Pointer(hi, lo)


@_timed
def keys_from_rows(rows: Sequence[tuple]) -> np.ndarray:
    """``pointer_from(*row)`` for every row, as one KEY_DTYPE array. Rows of
    one arity whose values the native hasher serialises hash there in one
    call, as object columns."""
    arity = len(rows[0]) if rows else 0
    if arity and all(len(r) == arity for r in rows):
        # fromiter keeps a tuple or ndarray value one cell
        columns = [np.fromiter(values, dtype=object, count=len(rows)) for values in zip(*rows)]
        native_out = _native_keys(columns, len(rows))
        if native_out is not None:
            return native_out
    out = np.empty(len(rows), dtype=KEY_DTYPE)
    hashed: List[int] = []
    blobs: List[bytes] = []
    for i, row in enumerate(rows):
        if len(row) == 1 and _is_plain_int(row[0]):
            out["hi"][i], out["lo"][i] = _int_key(int(row[0]))
        else:
            hashed.append(i)
            blobs.append(_salted(row))
    if hashed:
        out[hashed] = fingerprint_many(blobs)
    return out


def _classify_column(col: np.ndarray):
    """(kind, contiguous data) of a column for the native hasher; None for an
    array dtype it has no kind for. Kinds as in ``csrc/pathway_native.cc``:
    1=int64 2=float64 3=bool 5=pyobject 6=key128. An object column is the
    pyobject kind: the native code dispatches on each value's type."""
    if col.dtype == KEY_DTYPE:
        return (6, np.ascontiguousarray(col))
    if col.dtype == object:
        return (5, np.ascontiguousarray(col))
    if col.dtype == np.bool_:
        return (3, np.ascontiguousarray(col, dtype=np.uint8))
    if np.issubdtype(col.dtype, np.integer):
        if col.dtype == np.uint64 and len(col) and col.max() > np.uint64(2**63 - 1):
            # an int64 cast would wrap; the Python serialiser writes the true value
            return None
        return (1, np.ascontiguousarray(col, dtype=np.int64))
    if np.issubdtype(col.dtype, np.floating):
        # widening, as the serialiser casts to float64
        return (2, np.ascontiguousarray(col, dtype=np.float64))
    return None


def pointer_column_keys(col: np.ndarray) -> np.ndarray | None:
    """An object column holding only ``Pointer`` cells as a KEY_DTYPE
    column (the key128 kind hashes them as Pointer values); None when some
    cell is not a Pointer."""
    if col.dtype != object or not len(col):
        return None
    try:
        if not all(type(p) is Pointer for p in col):
            return None
    except TypeError:
        return None
    out = np.empty(len(col), dtype=KEY_DTYPE)
    out["hi"] = np.fromiter((p.hi for p in col), dtype=np.uint64, count=len(col))
    out["lo"] = np.fromiter((p.lo for p in col), dtype=np.uint64, count=len(col))
    return out


def _marshal_cols(
    columns: Sequence[np.ndarray],
    masks: Sequence[np.ndarray | None] | None,
) -> "tuple[Any, list] | None":
    """(PwCol array, arrays to keep alive) for the native hashers; None when a
    column's dtype has no native kind. The one place both hash paths marshal."""
    descs = []
    for col in columns:
        col = np.asarray(col)
        as_keys = pointer_column_keys(col)
        desc = _classify_column(col if as_keys is None else as_keys)
        if desc is None:
            return None
        descs.append(desc)
    keepalive: list = [data for _kind, data in descs]
    cols = (_native.PwCol * len(descs))()
    for i, (kind, data) in enumerate(descs):
        cols[i].kind = kind
        cols[i].data = data.ctypes.data_as(ctypes.c_void_p)
        cols[i].offsets = None
        mask = masks[i] if masks is not None else None
        if mask is None:
            cols[i].mask = None
        else:
            m = np.ascontiguousarray(mask, dtype=np.uint8)
            keepalive.append(m)
            cols[i].mask = m.ctypes.data_as(ctypes.c_void_p)
    return cols, keepalive


def _native_keys(
    columns: Sequence[np.ndarray],
    n: int,
    masks: Sequence[np.ndarray | None] | None = None,
) -> np.ndarray | None:
    """Keys from the native hasher; None when it is unavailable or meets a
    value it does not serialise (the Python path then takes the batch)."""
    lib = _native.get_lib()
    if lib is None:
        return None
    marshalled = _marshal_cols(columns, masks)
    if marshalled is None:
        return None
    cols, _keepalive = marshalled
    hi = np.empty(n, dtype=np.uint64)
    lo = np.empty(n, dtype=np.uint64)
    status = lib.pwtpu_hash_typed(
        ctypes.cast(cols, ctypes.c_void_p), len(columns), n, _SALT, len(_SALT),
        np.bool_, np.integer, hi.ctypes.data_as(_U64P), lo.ctypes.data_as(_U64P),
    )
    if status != -1:
        return None
    out = np.empty(n, dtype=KEY_DTYPE)
    out["hi"], out["lo"] = hi, lo
    return out


@_timed
def keys_from_values(
    columns: Sequence[np.ndarray],
    masks: Sequence[np.ndarray | None] | None = None,
) -> np.ndarray:
    """Key derivation for a batch of rows, one key per row.

    ``masks[j]``, when given, marks present rows of column ``j`` (False
    serializes as None — the null side of an outer join). Batches of the
    types the native hasher serialises (int, float, bool, str, None, keys)
    hash there in one call; the rest take the Python serialiser."""
    n = len(columns[0]) if columns else 0
    if (
        len(columns) == 1
        and columns[0].dtype == np.int64
        and (masks is None or masks[0] is None)
    ):
        # single-int64 column: the vectorized mix beats even the native hasher
        return _int_keys_array(columns[0])
    if n:
        native_out = _native_keys(columns, n, masks)
        if native_out is not None:
            return native_out
    return _python_keys(columns, n, masks)


def _python_keys(
    columns: Sequence[np.ndarray],
    n: int,
    masks: Sequence[np.ndarray | None] | None = None,
) -> np.ndarray:
    """The Python serialiser's keys (the native hasher's are the same bits)."""
    out = np.empty(n, dtype=KEY_DTYPE)
    single = len(columns) == 1
    mask0 = masks[0] if (single and masks is not None) else None
    hashed: List[int] = []
    blobs: List[bytes] = []
    for i in range(n):
        if single and (mask0 is None or mask0[i]):
            v = columns[0][i]
            if _is_plain_int(v):
                out["hi"][i], out["lo"][i] = _int_key(int(v))
                continue
        chunks: list[bytes] = [_SALT]
        for j, col in enumerate(columns):
            if masks is not None and masks[j] is not None and not masks[j][i]:
                chunks.append(b"\x00")
            else:
                _serialize_value(col[i], chunks)
        hashed.append(i)
        blobs.append(b"".join(chunks))
    if hashed:
        out[hashed] = fingerprint_many(blobs)
    return out


def _pointer_blobs(keys: np.ndarray) -> np.ndarray:
    """(n, 17) uint8: the serialisation of each key as a Pointer value."""
    out = np.empty((len(keys), 17), dtype=np.uint8)
    out[:, 0] = 1
    out[:, 1:9] = np.ascontiguousarray(keys["hi"]).astype("<u8").view(np.uint8).reshape(-1, 8)
    out[:, 9:17] = np.ascontiguousarray(keys["lo"]).astype("<u8").view(np.uint8).reshape(-1, 8)
    return out


def _int_blobs(values: np.ndarray) -> np.ndarray:
    """(n, 17) uint8: the serialisation of each int64 as an int value."""
    v = np.asarray(values, dtype=np.int64)
    out = np.empty((len(v), 17), dtype=np.uint8)
    out[:, 0] = 3
    out[:, 1:9] = v.astype("<i8").view(np.uint8).reshape(-1, 8)
    out[:, 9:17] = np.where(v < 0, 0xFF, 0).astype(np.uint8)[:, None]
    return out


def _const_blob(value: Any, n: int) -> np.ndarray:
    chunks: list[bytes] = []
    _serialize_value(value, chunks)
    b = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    return np.broadcast_to(b, (n, len(b)))


def _hash_blob_rows(rows: np.ndarray) -> np.ndarray:
    """Keys of the rows of an (n, length) uint8 array of serialisations."""
    lib = _native.get_lib()
    if lib is not None:
        n, width = rows.shape
        offsets = np.arange(n + 1, dtype=np.uint64) * np.uint64(width)
        return _native_hash_serialized(np.ascontiguousarray(rows).tobytes(), offsets, n, lib)
    high, low = xxh3_128_rows(rows)
    out = np.empty(len(rows), dtype=KEY_DTYPE)
    out["hi"], out["lo"] = high.byteswap(), low.byteswap()
    return out


@_timed
def derived_keys(parents: np.ndarray, indices: np.ndarray, tag: str) -> np.ndarray:
    """``pointer_from(Pointer(parent), index, tag)`` for every row, in numpy:
    the keys that ``flatten`` gives its output rows. All serialisations have
    one length, so the batch hashes in one pass."""
    n = len(parents)
    if n == 0:
        return np.empty(0, dtype=KEY_DTYPE)
    salt = np.broadcast_to(np.frombuffer(_SALT, dtype=np.uint8), (n, len(_SALT)))
    rows = np.concatenate(
        [salt, _pointer_blobs(parents), _int_blobs(indices), _const_blob(tag, n)], axis=1
    )
    return _hash_blob_rows(rows)


@_timed
def reindexed_keys(parents: np.ndarray, index: int) -> np.ndarray:
    """``pointer_from(Pointer(parent), index)`` for every row, in numpy: the
    keys ``concat_reindex`` gives the rows of its ``index``-th input."""
    n = len(parents)
    if n == 0:
        return np.empty(0, dtype=KEY_DTYPE)
    salt = np.broadcast_to(np.frombuffer(_SALT, dtype=np.uint8), (n, len(_SALT)))
    rows = np.concatenate(
        [salt, _pointer_blobs(parents), _int_blobs(np.full(n, index))], axis=1
    )
    return _hash_blob_rows(rows)


def hash_upsert(
    index: Any,
    columns: Sequence[np.ndarray],
    masks: Sequence[np.ndarray | None] | None = None,
) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """``keys_from_values`` + ``KeyIndex.upsert`` (the groupby's pair):
    (keys, slots, is_new), in one native call when the index is native and
    the values serialise natively. An unsupported value leaves the index
    untouched (the native call hashes every row before it upserts one), and
    the batch goes straight to the Python serialiser."""
    from pathway_tpu_torch.engine.index import _NativeKeyIndex

    n = len(columns[0]) if columns else 0
    lib = _native.get_lib()
    marshalled = None
    if lib is not None and isinstance(index, _NativeKeyIndex) and n:
        marshalled = _marshal_cols(columns, masks)
    if marshalled is not None:
        # the seconds counted here include the upsert
        t0 = time.perf_counter()
        cols, _keepalive = marshalled
        hi = np.empty(n, dtype=np.uint64)
        lo = np.empty(n, dtype=np.uint64)
        slots = np.empty(n, dtype=np.int64)
        is_new = np.empty(n, dtype=np.uint8)
        status = lib.pwtpu_hash_upsert(
            ctypes.cast(cols, ctypes.c_void_p), len(columns), n, _SALT, len(_SALT),
            np.bool_, np.integer, index._h, hi.ctypes.data_as(_U64P),
            lo.ctypes.data_as(_U64P), slots.ctypes.data_as(_I64P),
            is_new.ctypes.data_as(_U8P),
        )
        if status == -1:
            keys = np.empty(n, dtype=KEY_DTYPE)
            keys["hi"], keys["lo"] = hi, lo
            is_new = is_new.astype(bool)
        else:
            keys = _python_keys(columns, n, masks)
            slots, is_new = index.upsert(keys)
        KEY_DERIVATION["seconds"] += time.perf_counter() - t0
        KEY_DERIVATION["keys"] += n
        return keys, slots, is_new
    keys = keys_from_values(columns, masks)
    slots, is_new = index.upsert(keys)
    return keys, slots, is_new


def combine_keys(
    lkeys: np.ndarray,
    rkeys: np.ndarray,
    lmask: np.ndarray,
    rmask: np.ndarray,
    salt: int = 0x6A6F696E,  # "join"
) -> np.ndarray:
    """Derive output keys from two (maskable) key columns by arithmetic mixing.
    Null sides (``mask`` False) fold in distinct constants so (k, null) !=
    (null, k). The native module's ``pwtpu_combine_keys`` is the same mix."""
    lib = _native.get_lib()
    if lib is not None and len(lkeys):
        n = len(lkeys)
        lk = np.ascontiguousarray(lkeys)
        rk = np.ascontiguousarray(rkeys)
        lm = np.ascontiguousarray(lmask, dtype=np.uint8)
        rm = np.ascontiguousarray(rmask, dtype=np.uint8)
        out = np.empty(n, dtype=KEY_DTYPE)
        lib.pwtpu_combine_keys(
            lk.ctypes.data_as(_U64P), rk.ctypes.data_as(_U64P),
            lm.ctypes.data_as(_U8P), rm.ctypes.data_as(_U8P),
            n, salt, out.ctypes.data_as(_U64P),
        )
        return out
    C1 = np.uint64(0x9E3779B97F4A7C15)
    C2 = np.uint64(0xC2B2AE3D27D4EB4F)
    C3 = np.uint64(0x165667B19E3779F9)
    z = np.uint64(0x27D4EB2F165667C5)
    with np.errstate(over="ignore"):
        lh = np.where(lmask, lkeys["hi"], np.uint64(0x6C6E756C6C))
        ll = np.where(lmask, lkeys["lo"], np.uint64(0x1B873593))
        rh = np.where(rmask, rkeys["hi"], np.uint64(0x726E756C6C))
        rl = np.where(rmask, rkeys["lo"], np.uint64(0x85EBCA77))
        s = np.uint64(salt)
        hi = (lh * C1) ^ (rh * C2) ^ ((rl >> np.uint64(31)) + s * C3)
        lo = (ll * C2) ^ (rl * C1) ^ ((lh << np.uint64(17)) | (lh >> np.uint64(47)))
        hi ^= hi >> np.uint64(29)
        hi *= z
        hi ^= hi >> np.uint64(32)
        lo ^= lo >> np.uint64(29)
        lo *= C3
        lo ^= lo >> np.uint64(32)
        lo ^= hi * C1
        lo ^= lo >> np.uint64(31)
    out = np.empty(len(lkeys), dtype=KEY_DTYPE)
    out["hi"], out["lo"] = hi, lo
    return out


@_timed
def sequential_keys(start: int, count: int) -> np.ndarray:
    """Keys for autogenerated row ids (dense ints hashed for uniform sharding)."""
    if count == 0:
        return np.empty(0, dtype=KEY_DTYPE)
    lib = _native.get_lib()
    if lib is not None:
        hi = np.empty(count, dtype=np.uint64)
        lo = np.empty(count, dtype=np.uint64)
        lib.pwtpu_sequential_keys(
            _SALT, len(_SALT), start, count, hi.ctypes.data_as(_U64P), lo.ctypes.data_as(_U64P)
        )
        out = np.empty(count, dtype=KEY_DTYPE)
        out["hi"], out["lo"] = hi, lo
        return out
    head = np.broadcast_to(np.frombuffer(_SALT + b"seq", dtype=np.uint8), (count, len(_SALT) + 3))
    seq = _int_blobs(np.arange(start, start + count, dtype=np.int64))[:, 1:]
    return _hash_blob_rows(np.concatenate([head, seq], axis=1))


def keys_to_pointers(keys: np.ndarray) -> list[Pointer]:
    return [Pointer(h, l) for h, l in zip(keys["hi"].tolist(), keys["lo"].tolist())]


def pointers_to_keys(pointers: Iterable[Pointer]) -> np.ndarray:
    pointers = list(pointers)
    out = np.empty(len(pointers), dtype=KEY_DTYPE)
    out["hi"] = [p.hi for p in pointers]
    out["lo"] = [p.lo for p in pointers]
    return out


def broadcast_key(p: Pointer, n: int) -> np.ndarray:
    """A KEY_DTYPE column with every row set to ``p`` (constant-key buckets)."""
    out = np.empty(n, dtype=KEY_DTYPE)
    out["hi"], out["lo"] = p.hi, p.lo
    return out


def key_bytes(keys: np.ndarray) -> list[bytes]:
    """Per-row 16-byte representations, usable as dict keys."""
    blob = np.ascontiguousarray(keys).tobytes()
    return [blob[i : i + 16] for i in range(0, len(blob), 16)]
