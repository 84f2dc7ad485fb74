"""XXH3-128 (xxHash 0.8, seed 0, default secret) in Python and numpy.

The row keys of the engine are XXH3-128 fingerprints of serialised values
(``internals/keys.py``), so every derived key, every ``origin_id`` column and
every tie order that follows from keys depends on these bits being exactly
xxHash's. Two implementations of the one function:

- :func:`xxh3_128` hashes one message with Python integers (the paths up to
  240 bytes cost a few microseconds, far less than numpy's per-call
  overhead; longer messages take the numpy path);
- :func:`xxh3_128_rows` hashes many messages of ONE length at once: an
  ``(n, length)`` uint8 array, every step a numpy operation over the rows.
  Past 240 bytes the stripes between two scrambles only add to the
  accumulators, so each such run is one summed numpy pass.

Both return ``(high64, low64)`` of the 128-bit hash; the canonical digest
(``xxhash.xxh3_128_digest``) is ``high64`` then ``low64``, each big-endian.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1

P32_1 = 0x9E3779B1
P32_2 = 0x85EBCA77
P32_3 = 0xC2B2AE3D
P64_1 = 0x9E3779B185EBCA87
P64_2 = 0xC2B2AE3D27D4EB4F
P64_3 = 0x165667B19E3779F9
P64_4 = 0x85EBCA77C2B2AE63
P64_5 = 0x27D4EB2F165667C5
PMX1 = 0x165667919E3779F9
PMX2 = 0x9FB21C651E98DF25

SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)
_SECRET_SIZE = len(SECRET)  # 192
_STRIPE = 64
_STRIPES_PER_BLOCK = (_SECRET_SIZE - _STRIPE) // 8  # 16
_BLOCK = _STRIPE * _STRIPES_PER_BLOCK  # 1024
_INIT_ACC = (P32_3, P64_1, P64_2, P64_3, P64_4, P32_2, P64_5, P32_1)


def _s64(off: int) -> int:
    return int.from_bytes(SECRET[off : off + 8], "little")


def _s32(off: int) -> int:
    return int.from_bytes(SECRET[off : off + 4], "little")


# -- one message, Python integers ----------------------------------------------


def _r64(b: bytes, off: int) -> int:
    return int.from_bytes(b[off : off + 8], "little")


def _avalanche64(h: int) -> int:
    h ^= h >> 33
    h = (h * P64_2) & _M64
    h ^= h >> 29
    h = (h * P64_3) & _M64
    return h ^ (h >> 32)


def _avalanche3(h: int) -> int:
    h ^= h >> 37
    h = (h * PMX1) & _M64
    return h ^ (h >> 32)


def _fold(a: int, b: int) -> int:
    p = a * b
    return (p & _M64) ^ (p >> 64)


def _mix16(b: bytes, off: int, soff: int) -> int:
    return _fold(_r64(b, off) ^ _s64(soff), _r64(b, off + 8) ^ _s64(soff + 8))


def _mix32(lo: int, hi: int, b: bytes, o1: int, o2: int, soff: int) -> Tuple[int, int]:
    lo = (lo + _mix16(b, o1, soff)) & _M64
    lo ^= (_r64(b, o2) + _r64(b, o2 + 8)) & _M64
    hi = (hi + _mix16(b, o2, soff + 16)) & _M64
    hi ^= (_r64(b, o1) + _r64(b, o1 + 8)) & _M64
    return lo, hi


def _finish_mid(lo: int, hi: int, n: int) -> Tuple[int, int]:
    low = _avalanche3((lo + hi) & _M64)
    high = ((lo * P64_1) + (hi * P64_4) + (n * P64_2)) & _M64
    return (-_avalanche3(high)) & _M64, low


def xxh3_128(b: bytes) -> Tuple[int, int]:
    """(high64, low64) of XXH3-128 of ``b``."""
    n = len(b)
    if n == 0:
        return _avalanche64(_s64(80) ^ _s64(88)), _avalanche64(_s64(64) ^ _s64(72))
    if n <= 3:
        c1, c2, c3 = b[0], b[n >> 1], b[n - 1]
        cl = (c1 << 16) | (c2 << 24) | c3 | (n << 8)
        sw = int.from_bytes(cl.to_bytes(4, "little"), "big")
        ch = ((sw << 13) | (sw >> 19)) & _M32
        return (
            _avalanche64(ch ^ (_s32(8) ^ _s32(12))),
            _avalanche64(cl ^ (_s32(0) ^ _s32(4))),
        )
    if n <= 8:
        x = int.from_bytes(b[:4], "little") + (int.from_bytes(b[n - 4 :], "little") << 32)
        p = (x ^ (_s64(16) ^ _s64(24))) * ((P64_1 + (n << 2)) & _M64)
        lo, hi = p & _M64, p >> 64
        hi = (hi + (lo << 1)) & _M64
        lo ^= hi >> 3
        lo ^= lo >> 35
        lo = (lo * PMX2) & _M64
        lo ^= lo >> 28
        return _avalanche3(hi), lo
    if n <= 16:
        ilo, ihi = _r64(b, 0), _r64(b, n - 8)
        p = (ilo ^ ihi ^ (_s64(32) ^ _s64(40))) * P64_1
        mlo, mhi = p & _M64, p >> 64
        mlo = (mlo + ((n - 1) << 54)) & _M64
        ihi ^= _s64(48) ^ _s64(56)
        mhi = (mhi + ihi + (ihi & _M32) * (P32_2 - 1)) & _M64
        mlo ^= int.from_bytes(mhi.to_bytes(8, "little"), "big")
        p = mlo * P64_2
        hlo, hhi = p & _M64, p >> 64
        hhi = (hhi + mhi * P64_2) & _M64
        return _avalanche3(hhi), _avalanche3(hlo)
    if n <= 128:
        lo, hi = (n * P64_1) & _M64, 0
        if n > 32:
            if n > 64:
                if n > 96:
                    lo, hi = _mix32(lo, hi, b, 48, n - 64, 96)
                lo, hi = _mix32(lo, hi, b, 32, n - 48, 64)
            lo, hi = _mix32(lo, hi, b, 16, n - 32, 32)
        lo, hi = _mix32(lo, hi, b, 0, n - 16, 0)
        return _finish_mid(lo, hi, n)
    if n <= 240:
        lo, hi = (n * P64_1) & _M64, 0
        for i in range(4):
            lo, hi = _mix32(lo, hi, b, 32 * i, 32 * i + 16, 32 * i)
        lo, hi = _avalanche3(lo), _avalanche3(hi)
        for i in range(4, n // 32):
            lo, hi = _mix32(lo, hi, b, 32 * i, 32 * i + 16, 3 + 32 * (i - 4))
        lo, hi = _mix32(lo, hi, b, n - 16, n - 32, 136 - 17 - 16)
        return _finish_mid(lo, hi, n)
    high, low = xxh3_128_rows(np.frombuffer(b, dtype=np.uint8).reshape(1, n))
    return int(high[0]), int(low[0])


# -- many messages of one length, numpy ----------------------------------------

_U = np.uint64
# the secret word each lane of each stripe of a block reads: stripe s, lane i
_STRIPE_KEYS = np.array(
    [[_s64(8 * (s + i)) for i in range(8)] for s in range(_STRIPES_PER_BLOCK)], dtype=_U
)


def _c(x: int) -> np.uint64:
    return _U(x & _M64)


def _rows64(d: np.ndarray, off: int) -> np.ndarray:
    return np.ascontiguousarray(d[:, off : off + 8]).view("<u8").reshape(-1).astype(_U)


def _rows32(d: np.ndarray, off: int) -> np.ndarray:
    return np.ascontiguousarray(d[:, off : off + 4]).view("<u4").reshape(-1).astype(_U)


def _mul128(a: np.ndarray, b: "np.ndarray | np.uint64") -> Tuple[np.ndarray, np.ndarray]:
    m = _c(_M32)
    s = _U(32)
    alo, ahi = a & m, a >> s
    blo, bhi = b & m, b >> s
    ll, hl, lh, hh = alo * blo, ahi * blo, alo * bhi, ahi * bhi
    cross = (ll >> s) + (hl & m) + lh
    return (cross << s) | (ll & m), (hl >> s) + (cross >> s) + hh


def _vfold(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lo, hi = _mul128(a, b)
    return lo ^ hi


def _vav64(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> _U(33))
    h = h * _c(P64_2)
    h = h ^ (h >> _U(29))
    h = h * _c(P64_3)
    return h ^ (h >> _U(32))


def _vav3(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> _U(37))
    h = h * _c(PMX1)
    return h ^ (h >> _U(32))


def _vmix16(d: np.ndarray, off: int, soff: int) -> np.ndarray:
    return _vfold(_rows64(d, off) ^ _c(_s64(soff)), _rows64(d, off + 8) ^ _c(_s64(soff + 8)))


def _vmix32(lo, hi, d, o1: int, o2: int, soff: int):
    lo = lo + _vmix16(d, o1, soff)
    lo = lo ^ (_rows64(d, o2) + _rows64(d, o2 + 8))
    hi = hi + _vmix16(d, o2, soff + 16)
    hi = hi ^ (_rows64(d, o1) + _rows64(d, o1 + 8))
    return lo, hi


def _vfinish_mid(lo, hi, n: int):
    low = _vav3(lo + hi)
    high = lo * _c(P64_1) + hi * _c(P64_4) + _c(n * P64_2)
    return _U(0) - _vav3(high), low


def xxh3_128_rows(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(high64, low64) uint64 arrays of XXH3-128 over each row of an
    ``(m, n)`` uint8 array (every message ``n`` bytes long)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    m, n = data.shape
    with np.errstate(over="ignore"):
        return _rows_impl(data, m, n)


def _rows_impl(d: np.ndarray, m: int, n: int):
    if n == 0 or m == 0:
        hi, lo = xxh3_128(b"") if n == 0 else (0, 0)
        return np.full(m, hi, dtype=_U), np.full(m, lo, dtype=_U)
    if n <= 3:
        c1 = d[:, 0].astype(np.uint32)
        c2 = d[:, n >> 1].astype(np.uint32)
        c3 = d[:, n - 1].astype(np.uint32)
        cl = (c1 << np.uint32(16)) | (c2 << np.uint32(24)) | c3 | np.uint32(n << 8)
        sw = cl.byteswap()
        ch = (sw << np.uint32(13)) | (sw >> np.uint32(19))
        return (
            _vav64(ch.astype(_U) ^ _c(_s32(8) ^ _s32(12))),
            _vav64(cl.astype(_U) ^ _c(_s32(0) ^ _s32(4))),
        )
    if n <= 8:
        x = _rows32(d, 0) + (_rows32(d, n - 4) << _U(32))
        lo, hi = _mul128(x ^ _c(_s64(16) ^ _s64(24)), _c(P64_1 + (n << 2)))
        hi = hi + (lo << _U(1))
        lo = lo ^ (hi >> _U(3))
        lo = lo ^ (lo >> _U(35))
        lo = lo * _c(PMX2)
        lo = lo ^ (lo >> _U(28))
        return _vav3(hi), lo
    if n <= 16:
        ilo, ihi = _rows64(d, 0), _rows64(d, n - 8)
        mlo, mhi = _mul128(ilo ^ ihi ^ _c(_s64(32) ^ _s64(40)), _c(P64_1))
        mlo = mlo + _c((n - 1) << 54)
        ihi = ihi ^ _c(_s64(48) ^ _s64(56))
        mhi = mhi + ihi + (ihi & _c(_M32)) * _c(P32_2 - 1)
        mlo = mlo ^ mhi.byteswap()
        hlo, hhi = _mul128(mlo, _c(P64_2))
        hhi = hhi + mhi * _c(P64_2)
        return _vav3(hhi), _vav3(hlo)
    lo = np.full(m, _c(n * P64_1), dtype=_U)
    hi = np.zeros(m, dtype=_U)
    if n <= 128:
        if n > 32:
            if n > 64:
                if n > 96:
                    lo, hi = _vmix32(lo, hi, d, 48, n - 64, 96)
                lo, hi = _vmix32(lo, hi, d, 32, n - 48, 64)
            lo, hi = _vmix32(lo, hi, d, 16, n - 32, 32)
        lo, hi = _vmix32(lo, hi, d, 0, n - 16, 0)
        return _vfinish_mid(lo, hi, n)
    if n <= 240:
        for i in range(4):
            lo, hi = _vmix32(lo, hi, d, 32 * i, 32 * i + 16, 32 * i)
        lo, hi = _vav3(lo), _vav3(hi)
        for i in range(4, n // 32):
            lo, hi = _vmix32(lo, hi, d, 32 * i, 32 * i + 16, 3 + 32 * (i - 4))
        lo, hi = _vmix32(lo, hi, d, n - 16, n - 32, 136 - 17 - 16)
        return _vfinish_mid(lo, hi, n)
    # the long path. Between two scrambles every stripe only ADDS to the
    # accumulators (mod 2^64), so a run of stripes sums in one numpy pass:
    # lane i^1 gains the stripe's word i, lane i gains lo32(w ^ k) * hi32(w ^ k)
    acc = np.empty((m, 8), dtype=_U)
    acc[:] = np.array(_INIT_ACC, dtype=_U)
    low32 = _c(_M32)
    swap = np.array([1, 0, 3, 2, 5, 4, 7, 6])

    def stripes(off: int, count: int, soff: int) -> None:
        if count == 0:
            return
        words = np.ascontiguousarray(d[:, off : off + count * _STRIPE]).view("<u8")
        words = words.reshape(m, count, 8).astype(_U)
        if soff == 0:
            keys = _STRIPE_KEYS[:count]
        else:
            keys = np.array([[_s64(soff + 8 * i) for i in range(8)]], dtype=_U)
        k = words ^ keys
        acc[:] += ((k & low32) * (k >> _U(32))).sum(axis=1, dtype=_U)
        acc[:] += words.sum(axis=1, dtype=_U)[:, swap]

    nb_blocks = (n - 1) // _BLOCK
    scramble_keys = np.array(
        [_s64(_SECRET_SIZE - _STRIPE + 8 * i) for i in range(8)], dtype=_U
    )
    for blk in range(nb_blocks):
        stripes(blk * _BLOCK, _STRIPES_PER_BLOCK, 0)
        a_ = acc ^ (acc >> _U(47))
        acc[:] = (a_ ^ scramble_keys) * _c(P32_1)
    stripes(nb_blocks * _BLOCK, ((n - 1) - _BLOCK * nb_blocks) // _STRIPE, 0)
    stripes(n - _STRIPE, 1, _SECRET_SIZE - _STRIPE - 7)

    def merge(soff: int, start: int) -> np.ndarray:
        r = np.full(m, _c(start), dtype=_U)
        for i in range(4):
            r = r + _vfold(
                acc[:, 2 * i] ^ _c(_s64(soff + 16 * i)), acc[:, 2 * i + 1] ^ _c(_s64(soff + 16 * i + 8))
            )
        return _vav3(r)

    low = merge(11, n * P64_1)
    high = merge(_SECRET_SIZE - 64 - 11, ~(n * P64_2))
    return high, low


def xxh3_128_digest(b: bytes) -> bytes:
    """The canonical 16-byte digest (``xxhash.xxh3_128_digest``)."""
    high, low = xxh3_128(b)
    return high.to_bytes(8, "big") + low.to_bytes(8, "big")
