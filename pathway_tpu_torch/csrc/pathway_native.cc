// Native host module of pathway_tpu_torch: the engine's host-side hot loops in
// C++, with a plain C interface loaded through ctypes (native/__init__.py).
//
//   - 128-bit row keys: XXH3-128 (xxHash 0.8, seed 0, default secret) over the
//     salted serialisation of typed column batches, byte for byte the
//     serialisation of internals/keys.py::_serialize_value, so native and
//     Python key derivation are interchangeable;
//   - KeyIndex (128-bit key -> dense recycled slot) and MultiMap (128-bit key
//     -> bag of slots), the engine's arrangements (engine/index.py), and the
//     fused join-side insert / remove passes over both;
//   - DSV splitting with csv-module quoting, and the fused CSV parse (split,
//     typed coercion, row dicts) of io/fs.py.
//
// The XXH3-128 below is this module's own: no xxhash.h is included. Every
// length path of the reference algorithm is here (0, 1-3, 4-8, 9-16, 17-128,
// 129-240 bytes, and the striped path past 240 bytes with its scramble and
// last stripe); internals/xxh3.py is the same function in Python and numpy,
// and the tests hold the two against each other at every length to 1,100.
//
// The pyobject column kind walks PyObject* arrays with CPython calls: load the
// library with ctypes.PyDLL, so that every call holds the GIL.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cassert>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// -- XXH3-128 ----------------------------------------------------------------

constexpr uint32_t P32_1 = 0x9E3779B1U;
constexpr uint32_t P32_2 = 0x85EBCA77U;
constexpr uint32_t P32_3 = 0xC2B2AE3DU;
constexpr uint64_t P64_1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P64_2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P64_3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P64_4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P64_5 = 0x27D4EB2F165667C5ULL;
constexpr uint64_t PMX1 = 0x165667919E3779F9ULL;
constexpr uint64_t PMX2 = 0x9FB21C651E98DF25ULL;

constexpr size_t SECRET_SIZE = 192;
constexpr size_t STRIPE_LEN = 64;
constexpr size_t SECRET_CONSUME_RATE = 8;
constexpr size_t STRIPES_PER_BLOCK = (SECRET_SIZE - STRIPE_LEN) / SECRET_CONSUME_RATE;
constexpr size_t BLOCK_LEN = STRIPE_LEN * STRIPES_PER_BLOCK;

alignas(64) constexpr uint8_t kSecret[SECRET_SIZE] = {
    0xb8, 0xfe, 0x6c, 0x39, 0x23, 0xa4, 0x4b, 0xbe, 0x7c, 0x01, 0x81, 0x2c, 0xf7, 0x21, 0xad, 0x1c,
    0xde, 0xd4, 0x6d, 0xe9, 0x83, 0x90, 0x97, 0xdb, 0x72, 0x40, 0xa4, 0xa4, 0xb7, 0xb3, 0x67, 0x1f,
    0xcb, 0x79, 0xe6, 0x4e, 0xcc, 0xc0, 0xe5, 0x78, 0x82, 0x5a, 0xd0, 0x7d, 0xcc, 0xff, 0x72, 0x21,
    0xb8, 0x08, 0x46, 0x74, 0xf7, 0x43, 0x24, 0x8e, 0xe0, 0x35, 0x90, 0xe6, 0x81, 0x3a, 0x26, 0x4c,
    0x3c, 0x28, 0x52, 0xbb, 0x91, 0xc3, 0x00, 0xcb, 0x88, 0xd0, 0x65, 0x8b, 0x1b, 0x53, 0x2e, 0xa3,
    0x71, 0x64, 0x48, 0x97, 0xa2, 0x0d, 0xf9, 0x4e, 0x38, 0x19, 0xef, 0x46, 0xa9, 0xde, 0xac, 0xd8,
    0xa8, 0xfa, 0x76, 0x3f, 0xe3, 0x9c, 0x34, 0x3f, 0xf9, 0xdc, 0xbb, 0xc7, 0xc7, 0x0b, 0x4f, 0x1d,
    0x8a, 0x51, 0xe0, 0x4b, 0xcd, 0xb4, 0x59, 0x31, 0xc8, 0x9f, 0x7e, 0xc9, 0xd9, 0x78, 0x73, 0x64,
    0xea, 0xc5, 0xac, 0x83, 0x34, 0xd3, 0xeb, 0xc3, 0xc5, 0x81, 0xa0, 0xff, 0xfa, 0x13, 0x63, 0xeb,
    0x17, 0x0d, 0xdd, 0x51, 0xb7, 0xf0, 0xda, 0x49, 0xd3, 0x16, 0x55, 0x26, 0x29, 0xd4, 0x68, 0x9e,
    0x2b, 0x16, 0xbe, 0x58, 0x7d, 0x47, 0xa1, 0xfc, 0x8f, 0xf8, 0xb8, 0xd1, 0x7a, 0xd0, 0x31, 0xce,
    0x45, 0xcb, 0x3a, 0x8f, 0x95, 0x16, 0x04, 0x28, 0xaf, 0xd7, 0xfb, 0xca, 0xbb, 0x4b, 0x40, 0x7e,
};

struct H128 {
  uint64_t low64;
  uint64_t high64;
};

inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // little-endian hosts (x86-64, aarch64)
  return v;
}

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline H128 mult64to128(uint64_t a, uint64_t b) {
  __uint128_t p = static_cast<__uint128_t>(a) * b;
  return H128{static_cast<uint64_t>(p), static_cast<uint64_t>(p >> 64)};
}

inline uint64_t mul128_fold64(uint64_t a, uint64_t b) {
  H128 p = mult64to128(a, b);
  return p.low64 ^ p.high64;
}

inline uint64_t avalanche64(uint64_t h) {  // XXH64's avalanche
  h ^= h >> 33;
  h *= P64_2;
  h ^= h >> 29;
  h *= P64_3;
  h ^= h >> 32;
  return h;
}

inline uint64_t avalanche3(uint64_t h) {
  h ^= h >> 37;
  h *= PMX1;
  h ^= h >> 32;
  return h;
}

inline H128 len_1to3(const uint8_t* in, size_t len) {
  uint8_t c1 = in[0], c2 = in[len >> 1], c3 = in[len - 1];
  uint32_t cl = (static_cast<uint32_t>(c1) << 16) | (static_cast<uint32_t>(c2) << 24) |
                static_cast<uint32_t>(c3) | (static_cast<uint32_t>(len) << 8);
  uint32_t sw = __builtin_bswap32(cl);
  uint32_t ch = (sw << 13) | (sw >> 19);
  uint64_t flipl = read32(kSecret) ^ read32(kSecret + 4);
  uint64_t fliph = read32(kSecret + 8) ^ read32(kSecret + 12);
  return H128{avalanche64(static_cast<uint64_t>(cl) ^ flipl),
              avalanche64(static_cast<uint64_t>(ch) ^ fliph)};
}

inline H128 len_4to8(const uint8_t* in, size_t len) {
  uint64_t x = read32(in) + (static_cast<uint64_t>(read32(in + len - 4)) << 32);
  uint64_t flip = read64(kSecret + 16) ^ read64(kSecret + 24);
  H128 m = mult64to128(x ^ flip, P64_1 + (static_cast<uint64_t>(len) << 2));
  m.high64 += m.low64 << 1;
  m.low64 ^= m.high64 >> 3;
  m.low64 ^= m.low64 >> 35;
  m.low64 *= PMX2;
  m.low64 ^= m.low64 >> 28;
  m.high64 = avalanche3(m.high64);
  return m;
}

inline H128 len_9to16(const uint8_t* in, size_t len) {
  uint64_t flipl = read64(kSecret + 32) ^ read64(kSecret + 40);
  uint64_t fliph = read64(kSecret + 48) ^ read64(kSecret + 56);
  uint64_t ilo = read64(in);
  uint64_t ihi = read64(in + len - 8);
  H128 m = mult64to128(ilo ^ ihi ^ flipl, P64_1);
  m.low64 += static_cast<uint64_t>(len - 1) << 54;
  ihi ^= fliph;
  m.high64 += ihi + static_cast<uint64_t>(static_cast<uint32_t>(ihi)) * (P32_2 - 1);
  m.low64 ^= __builtin_bswap64(m.high64);
  H128 h = mult64to128(m.low64, P64_2);
  h.high64 += m.high64 * P64_2;
  h.low64 = avalanche3(h.low64);
  h.high64 = avalanche3(h.high64);
  return h;
}

inline uint64_t mix16(const uint8_t* in, const uint8_t* sec) {
  return mul128_fold64(read64(in) ^ read64(sec), read64(in + 8) ^ read64(sec + 8));
}

inline void mix32(H128& acc, const uint8_t* in1, const uint8_t* in2, const uint8_t* sec) {
  acc.low64 += mix16(in1, sec);
  acc.low64 ^= read64(in2) + read64(in2 + 8);
  acc.high64 += mix16(in2, sec + 16);
  acc.high64 ^= read64(in1) + read64(in1 + 8);
}

inline H128 finish_mid(const H128& acc, size_t len) {
  H128 h;
  h.low64 = avalanche3(acc.low64 + acc.high64);
  h.high64 = 0 - avalanche3(acc.low64 * P64_1 + acc.high64 * P64_4 +
                            static_cast<uint64_t>(len) * P64_2);
  return h;
}

inline H128 len_17to128(const uint8_t* in, size_t len) {
  H128 acc{static_cast<uint64_t>(len) * P64_1, 0};
  if (len > 32) {
    if (len > 64) {
      if (len > 96) mix32(acc, in + 48, in + len - 64, kSecret + 96);
      mix32(acc, in + 32, in + len - 48, kSecret + 64);
    }
    mix32(acc, in + 16, in + len - 32, kSecret + 32);
  }
  mix32(acc, in, in + len - 16, kSecret);
  return finish_mid(acc, len);
}

inline H128 len_129to240(const uint8_t* in, size_t len) {
  H128 acc{static_cast<uint64_t>(len) * P64_1, 0};
  for (size_t i = 0; i < 4; ++i) mix32(acc, in + 32 * i, in + 32 * i + 16, kSecret + 32 * i);
  acc.low64 = avalanche3(acc.low64);
  acc.high64 = avalanche3(acc.high64);
  size_t rounds = len / 32;
  for (size_t i = 4; i < rounds; ++i) {
    mix32(acc, in + 32 * i, in + 32 * i + 16, kSecret + 3 + 32 * (i - 4));
  }
  // last 32 bytes, against the secret's end (136 - 17 - 16)
  mix32(acc, in + len - 16, in + len - 32, kSecret + 103);
  return finish_mid(acc, len);
}

inline void accumulate_512(uint64_t* acc, const uint8_t* in, const uint8_t* sec) {
  for (int i = 0; i < 8; ++i) {
    uint64_t v = read64(in + 8 * i);
    uint64_t k = v ^ read64(sec + 8 * i);
    acc[i ^ 1] += v;
    acc[i] += static_cast<uint64_t>(static_cast<uint32_t>(k)) * (k >> 32);
  }
}

inline void scramble(uint64_t* acc, const uint8_t* sec) {
  for (int i = 0; i < 8; ++i) {
    uint64_t a = acc[i];
    a ^= a >> 47;
    a ^= read64(sec + 8 * i);
    a *= P32_1;
    acc[i] = a;
  }
}

inline uint64_t merge_accs(const uint64_t* acc, const uint8_t* sec, uint64_t start) {
  uint64_t r = start;
  for (int i = 0; i < 4; ++i) {
    r += mul128_fold64(acc[2 * i] ^ read64(sec + 16 * i), acc[2 * i + 1] ^ read64(sec + 16 * i + 8));
  }
  return avalanche3(r);
}

H128 hash_long(const uint8_t* in, size_t len) {
  uint64_t acc[8] = {P32_3, P64_1, P64_2, P64_3, P64_4, P32_2, P64_5, P32_1};
  size_t nb_blocks = (len - 1) / BLOCK_LEN;
  for (size_t b = 0; b < nb_blocks; ++b) {
    for (size_t s = 0; s < STRIPES_PER_BLOCK; ++s) {
      accumulate_512(acc, in + b * BLOCK_LEN + s * STRIPE_LEN, kSecret + s * SECRET_CONSUME_RATE);
    }
    scramble(acc, kSecret + SECRET_SIZE - STRIPE_LEN);
  }
  size_t nb_stripes = ((len - 1) - BLOCK_LEN * nb_blocks) / STRIPE_LEN;
  for (size_t s = 0; s < nb_stripes; ++s) {
    accumulate_512(acc, in + nb_blocks * BLOCK_LEN + s * STRIPE_LEN,
                   kSecret + s * SECRET_CONSUME_RATE);
  }
  // the last stripe, against the secret's end (less 7 bytes)
  accumulate_512(acc, in + len - STRIPE_LEN, kSecret + SECRET_SIZE - STRIPE_LEN - 7);
  H128 h;
  h.low64 = merge_accs(acc, kSecret + 11, static_cast<uint64_t>(len) * P64_1);
  h.high64 = merge_accs(acc, kSecret + SECRET_SIZE - 64 - 11,
                        ~(static_cast<uint64_t>(len) * P64_2));
  return h;
}

H128 xxh3_128(const void* data, size_t len) {
  const uint8_t* in = static_cast<const uint8_t*>(data);
  if (len <= 16) {
    if (len > 8) return len_9to16(in, len);
    if (len >= 4) return len_4to8(in, len);
    if (len > 0) return len_1to3(in, len);
    return H128{avalanche64(read64(kSecret + 64) ^ read64(kSecret + 72)),
                avalanche64(read64(kSecret + 80) ^ read64(kSecret + 88))};
  }
  if (len <= 128) return len_17to128(in, len);
  if (len <= 240) return len_129to240(in, len);
  return hash_long(in, len);
}

// -- serialisation (tags of internals/keys.py::_serialize_value) -------------

constexpr uint8_t TAG_NONE = 0x00;
constexpr uint8_t TAG_BOOL = 0x02;
constexpr uint8_t TAG_INT = 0x03;
constexpr uint8_t TAG_FLOAT = 0x04;
constexpr uint8_t TAG_STR = 0x05;

inline void put_u64_le(std::string& buf, uint64_t v) {
  for (int i = 0; i < 8; ++i) buf.push_back(static_cast<char>((v >> (8 * i)) & 0xff));
}

// 16-byte little-endian signed integer (int.to_bytes(16, "little", signed=True))
inline void put_i128_le(std::string& buf, int64_t v) {
  put_u64_le(buf, static_cast<uint64_t>(v));
  put_u64_le(buf, v < 0 ? ~0ULL : 0ULL);
}

// keys.py reads the canonical digest little-endian: digest[:8] is the
// big-endian encoding of high64, so hi = bswap(high64); likewise lo.
inline void write_hash(const void* data, size_t len, uint64_t* hi, uint64_t* lo) {
  H128 h = xxh3_128(data, len);
  *hi = __builtin_bswap64(h.high64);
  *lo = __builtin_bswap64(h.low64);
}

}  // namespace

extern "C" {

// Column value kinds of pwtpu_hash_typed:
//   1 = int64    (data: int64_t*)
//   2 = float64  (data: double*)
//   3 = bool     (data: uint8_t*)
//   4 = utf8     (data: char buffer, offsets: uint64_t[n+1])
//   5 = pyobject (data: PyObject** of a numpy object column; needs the GIL)
//   6 = key128   (data: [hi, lo] uint64 pairs, the raw bytes of a KEY_DTYPE
//                 column, serialised as a Pointer value)
// A column's mask (optional, uint8_t*) marks rows present (1) or None (0).
struct PwCol {
  int32_t kind;
  const void* data;
  const uint64_t* offsets;
  const uint8_t* mask;
};

}  // extern "C"

namespace {

// Serialise one Python value as keys.py::_serialize_value does, for the scalar
// types of the engine's hot columns (np_bool / np_integer: numpy's np.bool_
// and np.integer). False for anything else (tuples, ndarrays, Json, ints past
// 64 bits): the caller hashes the batch in Python.
bool serialize_pyvalue(PyObject* v, PyObject* np_bool, PyObject* np_integer, std::string& buf) {
  if (v == Py_None) {
    buf.push_back(static_cast<char>(TAG_NONE));
    return true;
  }
  if (PyBool_Check(v) || PyObject_TypeCheck(v, reinterpret_cast<PyTypeObject*>(np_bool))) {
    buf.push_back(static_cast<char>(TAG_BOOL));
    buf.push_back(PyObject_IsTrue(v) ? '\x01' : '\x00');
    return true;
  }
  if (PyFloat_Check(v)) {  // np.float64 is a float subclass
    buf.push_back(static_cast<char>(TAG_FLOAT));
    double d = PyFloat_AS_DOUBLE(v);
    char raw[8];
    std::memcpy(raw, &d, 8);
    buf.append(raw, 8);
    return true;
  }
  if (PyLong_Check(v) || PyObject_TypeCheck(v, reinterpret_cast<PyTypeObject*>(np_integer))) {
    int overflow = 0;
    long long val = PyLong_AsLongLongAndOverflow(v, &overflow);
    if (overflow != 0) return false;  // past 64 bits: the Python path
    if (val == -1 && PyErr_Occurred()) {
      // np.integer scalars are not PyLong: go through __index__
      PyErr_Clear();
      PyObject* as_int = PyNumber_Index(v);
      if (as_int == nullptr) {
        PyErr_Clear();
        return false;
      }
      val = PyLong_AsLongLongAndOverflow(as_int, &overflow);
      Py_DECREF(as_int);
      if (overflow != 0 || (val == -1 && PyErr_Occurred())) {
        PyErr_Clear();
        return false;
      }
    }
    buf.push_back(static_cast<char>(TAG_INT));
    put_i128_le(buf, static_cast<int64_t>(val));
    return true;
  }
  if (PyUnicode_Check(v)) {
    Py_ssize_t size = 0;
    const char* utf8 = PyUnicode_AsUTF8AndSize(v, &size);
    if (utf8 == nullptr) {
      PyErr_Clear();
      return false;
    }
    buf.push_back(static_cast<char>(TAG_STR));
    put_u64_le(buf, static_cast<uint64_t>(size));
    buf.append(utf8, static_cast<size_t>(size));
    return true;
  }
  return false;
}

// A key of exactly one int value is a splitmix-style 128-bit mix of it, not a
// hash of its serialisation (keys.py::_int_key is the same function).
inline uint64_t intkey_mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

constexpr uint64_t INTKEY_LO = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t INTKEY_HI = 0xD6E8FEB86659FD93ULL;

// An int64-able integer that is not a bool, recognised as the serialiser
// recognises ints, so that the mix and the serialised path agree.
inline bool try_int64(PyObject* v, PyObject* np_bool, PyObject* np_integer, uint64_t* out) {
  if (PyBool_Check(v) || PyObject_TypeCheck(v, reinterpret_cast<PyTypeObject*>(np_bool))) {
    return false;
  }
  if (!(PyLong_Check(v) || PyObject_TypeCheck(v, reinterpret_cast<PyTypeObject*>(np_integer)))) {
    return false;
  }
  int overflow = 0;
  long long val = PyLong_AsLongLongAndOverflow(v, &overflow);
  if (overflow != 0) return false;
  if (val == -1 && PyErr_Occurred()) {
    PyErr_Clear();
    PyObject* as_int = PyNumber_Index(v);
    if (as_int == nullptr) {
      PyErr_Clear();
      return false;
    }
    val = PyLong_AsLongLongAndOverflow(as_int, &overflow);
    Py_DECREF(as_int);
    if (overflow != 0 || (val == -1 && PyErr_Occurred())) {
      PyErr_Clear();
      return false;
    }
  }
  *out = static_cast<uint64_t>(val);
  return true;
}

inline void int_key(uint64_t v, uint64_t* hi, uint64_t* lo) {
  *lo = intkey_mix64(v + INTKEY_LO);
  *hi = intkey_mix64(v ^ INTKEY_HI);
}

}  // namespace

extern "C" {

// Keys of n rows over ncols typed columns; salt prefixes every row. Returns -1
// on success, else the first row holding a value the serialiser does not
// support (the caller hashes the whole batch in Python).
int64_t pwtpu_hash_typed(const PwCol* cols, int32_t ncols, uint64_t n, const uint8_t* salt,
                         uint64_t salt_len, PyObject* np_bool, PyObject* np_integer,
                         uint64_t* out_hi, uint64_t* out_lo) {
  std::string buf;
  for (uint64_t i = 0; i < n; ++i) {
    if (ncols == 1) {
      // the single-int mix; masked rows and other values take the hash
      const PwCol& c0 = cols[0];
      bool present = c0.mask == nullptr || c0.mask[i] != 0;
      if (present && c0.kind == 1) {
        int_key(static_cast<uint64_t>(static_cast<const int64_t*>(c0.data)[i]), &out_hi[i],
                &out_lo[i]);
        continue;
      }
      if (present && c0.kind == 5) {
        uint64_t v = 0;
        if (try_int64(static_cast<PyObject* const*>(c0.data)[i], np_bool, np_integer, &v)) {
          int_key(v, &out_hi[i], &out_lo[i]);
          continue;
        }
      }
    }
    buf.assign(reinterpret_cast<const char*>(salt), salt_len);
    for (int32_t c = 0; c < ncols; ++c) {
      const PwCol& col = cols[c];
      if (col.mask != nullptr && col.mask[i] == 0) {
        buf.push_back(static_cast<char>(TAG_NONE));
        continue;
      }
      switch (col.kind) {
        case 1:
          buf.push_back(static_cast<char>(TAG_INT));
          put_i128_le(buf, static_cast<const int64_t*>(col.data)[i]);
          break;
        case 2: {
          buf.push_back(static_cast<char>(TAG_FLOAT));
          double v = static_cast<const double*>(col.data)[i];
          char raw[8];
          std::memcpy(raw, &v, 8);
          buf.append(raw, 8);
          break;
        }
        case 3:
          buf.push_back(static_cast<char>(TAG_BOOL));
          buf.push_back(static_cast<const uint8_t*>(col.data)[i] ? '\x01' : '\x00');
          break;
        case 4: {
          buf.push_back(static_cast<char>(TAG_STR));
          uint64_t start = col.offsets[i];
          uint64_t end = col.offsets[i + 1];
          put_u64_le(buf, end - start);
          buf.append(static_cast<const char*>(col.data) + start, end - start);
          break;
        }
        case 5:
          if (!serialize_pyvalue(static_cast<PyObject* const*>(col.data)[i], np_bool, np_integer,
                                 buf)) {
            return static_cast<int64_t>(i);
          }
          break;
        case 6:
          // Pointer tag + raw hi/lo (little-endian already in a KEY_DTYPE column)
          buf.push_back('\x01');
          buf.append(static_cast<const char*>(col.data) + 16 * i, 16);
          break;
        default:
          return static_cast<int64_t>(i);
      }
    }
    write_hash(buf.data(), buf.size(), &out_hi[i], &out_lo[i]);
  }
  return -1;
}

// Keys of serialisations made by the caller: payloads concatenated in buf,
// row i at [offsets[i], offsets[i+1]).
void pwtpu_hash_serialized(const uint8_t* buf, const uint64_t* offsets, uint64_t n,
                           uint64_t* out_hi, uint64_t* out_lo) {
  for (uint64_t i = 0; i < n; ++i) {
    write_hash(buf + offsets[i], offsets[i + 1] - offsets[i], &out_hi[i], &out_lo[i]);
  }
}

// Keys of autogenerated row ids: salt + "seq" + the id as a 16-byte int.
void pwtpu_sequential_keys(const uint8_t* salt, uint64_t salt_len, int64_t start, uint64_t count,
                           uint64_t* out_hi, uint64_t* out_lo) {
  std::string buf;
  for (uint64_t i = 0; i < count; ++i) {
    buf.assign(reinterpret_cast<const char*>(salt), salt_len);
    buf.append("seq", 3);
    put_i128_le(buf, start + static_cast<int64_t>(i));
    write_hash(buf.data(), buf.size(), &out_hi[i], &out_lo[i]);
  }
}

// ---------------------------------------------------------------------------
// DSV splitting: rows by '\n' (or a bare '\r'; CRLF is one break), fields by
// `delimiter`, double-quote quoting with "" escapes. As in the csv module, a
// quote is special only at the start of a field. Emits a flat field buffer,
// per-field offsets, per-row field counts and per-row had-quotes flags (a
// quoted empty string is data, a blank line is not). Returns the row count;
// call once with null outputs to size the buffers (needed_*), then again.
uint64_t pwtpu_split_dsv(const char* data, uint64_t len, char delimiter, char* field_buf,
                         uint64_t* field_offsets, uint64_t* row_field_counts,
                         uint8_t* row_had_quotes, uint64_t* needed_bytes,
                         uint64_t* needed_fields) {
  uint64_t rows = 0, fields = 0, bytes = 0;
  bool measuring = field_buf == nullptr;
  uint64_t field_start_bytes = 0;
  bool in_quotes = false;
  bool row_open = false;
  bool field_started = false;
  bool had_quotes = false;
  uint64_t row_fields = 0;

  auto end_field = [&]() {
    if (!measuring) field_offsets[fields] = field_start_bytes;
    ++fields;
    ++row_fields;
    field_start_bytes = bytes;
    field_started = false;
  };
  auto end_row = [&]() {
    end_field();
    if (!measuring) {
      row_field_counts[rows] = row_fields;
      if (row_had_quotes != nullptr) row_had_quotes[rows] = had_quotes ? 1 : 0;
    }
    ++rows;
    row_fields = 0;
    row_open = false;
    had_quotes = false;
  };

  for (uint64_t i = 0; i < len; ++i) {
    char ch = data[i];
    row_open = true;
    if (in_quotes) {
      if (ch == '"') {
        if (i + 1 < len && data[i + 1] == '"') {
          if (!measuring) field_buf[bytes] = '"';
          ++bytes;
          ++i;
        } else {
          in_quotes = false;
        }
      } else {
        if (!measuring) field_buf[bytes] = ch;
        ++bytes;
      }
      continue;
    }
    if (ch == '"' && !field_started) {
      in_quotes = true;
      field_started = true;
      had_quotes = true;
    } else if (ch == delimiter) {
      end_field();
    } else if (ch == '\r') {
      if (!(i + 1 < len && data[i + 1] == '\n')) end_row();  // CRLF: the \n ends it
    } else if (ch == '\n') {
      end_row();
    } else {
      if (!measuring) field_buf[bytes] = ch;
      ++bytes;
      field_started = true;
    }
  }
  if (row_open) end_row();
  if (!measuring && fields > 0) field_offsets[fields] = bytes;
  if (needed_bytes != nullptr) *needed_bytes = bytes;
  if (needed_fields != nullptr) *needed_fields = fields;
  return rows;
}

}  // extern "C"

namespace {

inline void trim(const char*& s, size_t& slen) {
  while (slen > 0 && (s[0] == ' ' || s[0] == '\t')) {
    ++s;
    --slen;
  }
  while (slen > 0 && (s[slen - 1] == ' ' || s[slen - 1] == '\t')) --slen;
}

// int(): strtoll for the common case, PyLong_FromString for big ints and
// underscore literals, so that a field coerces exactly as int() does.
PyObject* coerce_int(const char* s, size_t slen, PyObject* error_obj, std::string& scratch) {
  trim(s, slen);
  scratch.assign(s, slen);
  char* end = nullptr;
  errno = 0;
  long long v = strtoll(scratch.c_str(), &end, 10);
  if (errno == 0 && slen != 0 && end == scratch.c_str() + slen) return PyLong_FromLongLong(v);
  PyObject* big = PyLong_FromString(scratch.c_str(), nullptr, 10);
  if (big != nullptr) return big;
  PyErr_Clear();
  Py_INCREF(error_obj);
  return error_obj;
}

// float(): strtod for plain decimal forms, PyFloat_FromString otherwise
// (subnormals, '_' grouping, inf / nan words; C hex floats are refused).
PyObject* coerce_float(const char* s, size_t slen, PyObject* error_obj, std::string& scratch) {
  trim(s, slen);
  bool plain = slen > 0;
  for (size_t i = 0; i < slen && plain; ++i) {
    char c = s[i];
    plain = (c >= '0' && c <= '9') || c == '.' || c == '+' || c == '-' || c == 'e' || c == 'E';
  }
  scratch.assign(s, slen);
  if (plain) {
    char* end = nullptr;
    double v = strtod(scratch.c_str(), &end);  // ERANGE over/underflow matches float()
    if (end == scratch.c_str() + slen) return PyFloat_FromDouble(v);
  }
  PyObject* str = PyUnicode_DecodeUTF8(s, static_cast<Py_ssize_t>(slen), "replace");
  if (str == nullptr) {
    PyErr_Clear();
    Py_INCREF(error_obj);
    return error_obj;
  }
  PyObject* val = PyFloat_FromString(str);
  Py_DECREF(str);
  if (val != nullptr) return val;
  PyErr_Clear();
  Py_INCREF(error_obj);
  return error_obj;
}

}  // namespace

extern "C" {

// The fused DSV parse: split, typed coercion and row dicts in one call (with
// the GIL held).
//   data/len/delim: the file's bytes, header row included (quoted headers too:
//                   names resolve against the split header)
//   names         : tuple of the wanted column names
//   tags          : per wanted column, 0=str 1=int 2=float 3=bool
//   error_obj     : the value of a malformed typed field
// A wanted column absent from the header is left out of the rows, as
// csv.DictReader's are. Returns a new list of dicts, or NULL on an error.
PyObject* pwtpu_parse_dsv_rows(const char* data, uint64_t len, char delim, PyObject* names,
                               const int32_t* tags, int32_t ncols, PyObject* error_obj) {
  uint64_t needed_bytes = 0, needed_fields = 0;
  uint64_t nrows = pwtpu_split_dsv(data, len, delim, nullptr, nullptr, nullptr, nullptr,
                                   &needed_bytes, &needed_fields);
  PyObject* out = PyList_New(0);
  if (out == nullptr) return nullptr;
  if (nrows == 0) return out;
  std::vector<char> field_buf(needed_bytes > 0 ? needed_bytes : 1);
  std::vector<uint64_t> offsets(needed_fields + 1);
  std::vector<uint64_t> counts(nrows);
  std::vector<uint8_t> quoted(nrows);
  pwtpu_split_dsv(data, len, delim, field_buf.data(), offsets.data(), counts.data(),
                  quoted.data(), nullptr, nullptr);

  std::vector<int64_t> src_idx(ncols, -1);
  uint64_t header_fields = counts[0];
  for (int32_t c = 0; c < ncols; ++c) {
    Py_ssize_t name_len = 0;
    const char* name_utf8 = PyUnicode_AsUTF8AndSize(PyTuple_GET_ITEM(names, c), &name_len);
    if (name_utf8 == nullptr) {
      PyErr_Clear();
      continue;
    }
    for (uint64_t j = 0; j < header_fields; ++j) {
      uint64_t fl = offsets[j + 1] - offsets[j];
      if (fl == static_cast<uint64_t>(name_len) &&
          std::memcmp(field_buf.data() + offsets[j], name_utf8, fl) == 0) {
        src_idx[c] = static_cast<int64_t>(j);
        break;
      }
    }
  }

  uint64_t f = header_fields;
  std::string scratch;
  for (uint64_t r = 1; r < nrows; ++r) {
    uint64_t k = counts[r];
    if (k == 1 && offsets[f + 1] == offsets[f] && !quoted[r]) {
      f += k;
      continue;  // a blank line (a quoted "" row is data)
    }
    PyObject* row = PyDict_New();
    if (row == nullptr) {
      Py_DECREF(out);
      return nullptr;
    }
    for (int32_t c = 0; c < ncols; ++c) {
      int64_t j = src_idx[c];
      if (j < 0) continue;
      PyObject* value = nullptr;
      if (static_cast<uint64_t>(j) >= k) {
        Py_INCREF(Py_None);
        value = Py_None;
      } else {
        const char* s = field_buf.data() + offsets[f + j];
        size_t slen = offsets[f + j + 1] - offsets[f + j];
        switch (tags[c]) {
          case 1:
            value = coerce_int(s, slen, error_obj, scratch);
            break;
          case 2:
            value = coerce_float(s, slen, error_obj, scratch);
            break;
          case 3:  // io/fs.py::_coerce's words
            scratch.assign(s, slen);
            if (scratch == "true" || scratch == "True" || scratch == "1") {
              value = Py_True;
            } else if (scratch == "false" || scratch == "False" || scratch == "0") {
              value = Py_False;
            } else {
              value = error_obj;
            }
            Py_INCREF(value);
            break;
          default:
            value = PyUnicode_DecodeUTF8(s, static_cast<Py_ssize_t>(slen), "replace");
        }
      }
      if (value == nullptr || PyDict_SetItem(row, PyTuple_GET_ITEM(names, c), value) < 0) {
        Py_XDECREF(value);
        Py_DECREF(row);
        Py_DECREF(out);
        return nullptr;
      }
      Py_DECREF(value);
    }
    if (PyList_Append(out, row) < 0) {
      Py_DECREF(row);
      Py_DECREF(out);
      return nullptr;
    }
    Py_DECREF(row);
    f += k;
  }
  return out;
}

// ---------------------------------------------------------------------------
// Output keys of two (maskable) key columns by splitmix-style mixing: the twin
// of keys.py::combine_keys's numpy body, bit for bit.
void pwtpu_combine_keys(const uint64_t* lkeys, const uint64_t* rkeys, const uint8_t* lmask,
                        const uint8_t* rmask, int64_t n, uint64_t salt, uint64_t* out_keys) {
  constexpr uint64_t C1 = 0x9E3779B97F4A7C15ULL;
  constexpr uint64_t C2 = 0xC2B2AE3D27D4EB4FULL;
  constexpr uint64_t C3 = 0x165667B19E3779F9ULL;
  constexpr uint64_t Z = 0x27D4EB2F165667C5ULL;
  for (int64_t i = 0; i < n; ++i) {
    bool lm = lmask == nullptr || lmask[i];
    bool rm = rmask == nullptr || rmask[i];
    uint64_t lh = lm ? lkeys[2 * i] : 0x6C6E756C6CULL;
    uint64_t ll = lm ? lkeys[2 * i + 1] : 0x1B873593ULL;
    uint64_t rh = rm ? rkeys[2 * i] : 0x726E756C6CULL;
    uint64_t rl = rm ? rkeys[2 * i + 1] : 0x85EBCA77ULL;
    uint64_t hi = (lh * C1) ^ (rh * C2) ^ ((rl >> 31) + salt * C3);
    uint64_t lo = (ll * C2) ^ (rl * C1) ^ ((lh << 17) | (lh >> 47));
    hi ^= hi >> 29;
    hi *= Z;
    hi ^= hi >> 32;
    lo ^= lo >> 29;
    lo *= C3;
    lo ^= lo >> 32;
    lo ^= hi * C1;
    lo ^= lo >> 31;
    out_keys[2 * i] = hi;
    out_keys[2 * i + 1] = lo;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// KeyIndex: open addressing, 128-bit key -> dense int64 slot. Keys arrive as
// the raw bytes of a KEY_DTYPE column, interleaved little-endian [hi, lo]
// pairs; keys are fingerprints already, so `lo` is the hash. Slots are handed
// out densely and recycled through a free stack (last freed, first reused),
// so the caller keeps value columns indexed by slot.

namespace {

struct KeyIndex {
  std::vector<uint64_t> khi, klo;
  std::vector<int8_t> state;  // 0 empty, 1 full, 2 tombstone
  std::vector<int64_t> slots;
  uint64_t mask = 0;
  int64_t live = 0;
  int64_t filled = 0;  // live + tombstones
  int64_t next_slot = 0;
  std::vector<int64_t> free_slots;

  explicit KeyIndex(uint64_t cap_hint) {
    uint64_t cap = 16;
    while (cap < cap_hint * 2) cap <<= 1;
    rebuild(cap);
  }

  void rebuild(uint64_t cap) {
    khi.assign(cap, 0);
    klo.assign(cap, 0);
    state.assign(cap, 0);
    slots.assign(cap, -1);
    mask = cap - 1;
    filled = live;  // a rebuild drops the tombstones
  }

  // Rebuild at new_cap (the same size purges tombstones), re-inserting live entries.
  void rehash_to(uint64_t new_cap) {
    std::vector<uint64_t> ohi, olo;
    std::vector<int8_t> ost;
    std::vector<int64_t> osl;
    ohi.swap(khi);
    olo.swap(klo);
    ost.swap(state);
    osl.swap(slots);
    rebuild(new_cap);
    for (uint64_t i = 0; i < ost.size(); ++i) {
      if (ost[i] != 1) continue;
      uint64_t pos = olo[i] & mask;
      while (state[pos] == 1) pos = (pos + 1) & mask;
      khi[pos] = ohi[i];
      klo[pos] = olo[i];
      state[pos] = 1;
      slots[pos] = osl[i];
    }
  }

  // Load stays at most 0.5. A table full of tombstones rebuilds at its own
  // size, so churn at a constant live count keeps memory bounded.
  void rehash_if_needed() {
    uint64_t cap = mask + 1;
    if (static_cast<uint64_t>(filled) * 2 < cap) return;
    uint64_t new_cap = cap;
    while (static_cast<uint64_t>(live) * 4 >= new_cap) new_cap <<= 1;
    rehash_to(new_cap);
  }

  // Room for `extra` more inserts without a rehash mid-batch, so that batch
  // loops may prefetch probe positions.
  void reserve_for(uint64_t extra) {
    uint64_t cap = mask + 1;
    if ((static_cast<uint64_t>(filled) + extra) * 2 < cap) return;
    uint64_t new_cap = cap;
    while ((static_cast<uint64_t>(live) + extra) * 4 >= new_cap) new_cap <<= 1;
    rehash_to(new_cap);
  }

  // The position of the key when present, else the first insertable position.
  uint64_t find(uint64_t hi, uint64_t lo, bool* found) const {
    uint64_t pos = lo & mask;
    int64_t first_tomb = -1;
    for (;;) {
      int8_t st = state[pos];
      if (st == 0) {
        *found = false;
        return first_tomb >= 0 ? static_cast<uint64_t>(first_tomb) : pos;
      }
      if (st == 1 && klo[pos] == lo && khi[pos] == hi) {
        *found = true;
        return pos;
      }
      if (st == 2 && first_tomb < 0) first_tomb = static_cast<int64_t>(pos);
      pos = (pos + 1) & mask;
    }
  }

  int64_t upsert(uint64_t hi, uint64_t lo, uint8_t* is_new) {
    rehash_if_needed();
    bool found = false;
    uint64_t pos = find(hi, lo, &found);
    if (found) {
      *is_new = 0;
      return slots[pos];
    }
    int64_t slot;
    if (!free_slots.empty()) {
      slot = free_slots.back();
      free_slots.pop_back();
    } else {
      slot = next_slot++;
    }
    if (state[pos] == 0) ++filled;
    khi[pos] = hi;
    klo[pos] = lo;
    state[pos] = 1;
    slots[pos] = slot;
    ++live;
    *is_new = 1;
    return slot;
  }

  int64_t lookup(uint64_t hi, uint64_t lo) const {
    bool found = false;
    uint64_t pos = find(hi, lo, &found);
    return found ? slots[pos] : -1;
  }

  int64_t remove(uint64_t hi, uint64_t lo) {
    bool found = false;
    uint64_t pos = find(hi, lo, &found);
    if (!found) return -1;
    int64_t slot = slots[pos];
    state[pos] = 2;  // a tombstone stays counted in `filled`
    slots[pos] = -1;
    --live;
    free_slots.push_back(slot);
    return slot;
  }
};

// ---------------------------------------------------------------------------
// MultiMap: 128-bit key -> bag of int64 values (join key -> row slots), the
// same open addressing. Values are dense non-negative unique ids (each in at
// most one bag at a time), so bags are intrusive doubly-linked lists over
// arrays indexed by value: O(1) insert and remove, no allocation per key.
// A bag lists its values last inserted first.

struct MultiMap {
  std::vector<uint64_t> khi, klo;
  std::vector<int8_t> state;
  std::vector<int64_t> head;        // first value of the bag
  std::vector<int64_t> cnt;         // bag size
  std::vector<int64_t> nxt, prv;    // links, indexed by value
  std::vector<uint64_t> vhi, vlo;   // the key each linked value sits under
  std::vector<uint8_t> linked;      // 1 while the value is in a bag
  uint64_t mask = 0;
  int64_t live = 0;
  int64_t filled = 0;
  int64_t total_vals = 0;

  MultiMap() { rebuild(16); }

  void rebuild(uint64_t cap) {
    khi.assign(cap, 0);
    klo.assign(cap, 0);
    state.assign(cap, 0);
    head.assign(cap, -1);
    cnt.assign(cap, 0);
    mask = cap - 1;
    filled = live;
  }

  void ensure_links(int64_t v) {
    assert(v >= 0 && "MultiMap values must be non-negative slot ids");
    if (static_cast<size_t>(v) >= nxt.size()) {
      size_t n = nxt.size() ? nxt.size() : 64;
      while (n <= static_cast<size_t>(v)) n *= 2;
      nxt.resize(n, -1);
      prv.resize(n, -1);
      vhi.resize(n, 0);
      vlo.resize(n, 0);
      linked.resize(n, 0);
    }
  }

  void rehash_to(uint64_t new_cap) {
    std::vector<uint64_t> ohi, olo;
    std::vector<int8_t> ost;
    std::vector<int64_t> ohd, ocn;
    ohi.swap(khi);
    olo.swap(klo);
    ost.swap(state);
    ohd.swap(head);
    ocn.swap(cnt);
    rebuild(new_cap);
    for (uint64_t i = 0; i < ost.size(); ++i) {
      if (ost[i] != 1) continue;
      uint64_t pos = olo[i] & mask;
      while (state[pos] == 1) pos = (pos + 1) & mask;
      khi[pos] = ohi[i];
      klo[pos] = olo[i];
      state[pos] = 1;
      head[pos] = ohd[i];
      cnt[pos] = ocn[i];
    }
  }

  void rehash_if_needed() {
    uint64_t cap = mask + 1;
    if (static_cast<uint64_t>(filled) * 2 < cap) return;
    uint64_t new_cap = cap;
    while (static_cast<uint64_t>(live) * 4 >= new_cap) new_cap <<= 1;
    rehash_to(new_cap);
  }

  uint64_t find(uint64_t hi, uint64_t lo, bool* found) const {
    uint64_t pos = lo & mask;
    int64_t first_tomb = -1;
    for (;;) {
      int8_t st = state[pos];
      if (st == 0) {
        *found = false;
        return first_tomb >= 0 ? static_cast<uint64_t>(first_tomb) : pos;
      }
      if (st == 1 && klo[pos] == lo && khi[pos] == hi) {
        *found = true;
        return pos;
      }
      if (st == 2 && first_tomb < 0) first_tomb = static_cast<int64_t>(pos);
      pos = (pos + 1) & mask;
    }
  }

  void insert(uint64_t hi, uint64_t lo, int64_t v) {
    rehash_if_needed();
    bool found = false;
    uint64_t pos = find(hi, lo, &found);
    if (!found) {
      if (state[pos] == 0) ++filled;
      khi[pos] = hi;
      klo[pos] = lo;
      state[pos] = 1;
      head[pos] = -1;
      cnt[pos] = 0;
      ++live;
    }
    ensure_links(v);
    int64_t h = head[pos];
    nxt[v] = h;
    prv[v] = -1;
    if (h >= 0) prv[h] = v;
    head[pos] = v;
    vhi[v] = hi;
    vlo[v] = lo;
    linked[v] = 1;
    ++cnt[pos];
    ++total_vals;
  }

  // Unlinks v from the bag of `key`; false when v is not in that bag.
  bool remove(uint64_t hi, uint64_t lo, int64_t v) {
    bool found = false;
    uint64_t pos = find(hi, lo, &found);
    if (!found) return false;
    if (static_cast<size_t>(v) >= nxt.size()) return false;
    // v must be linked, and into THIS bag: unlinking it from another bag
    // while this bag's count drops would corrupt both
    if (!linked[v] || vhi[v] != hi || vlo[v] != lo) return false;
    if (prv[v] < 0 && head[pos] == v) {
      head[pos] = nxt[v];
      if (nxt[v] >= 0) prv[nxt[v]] = -1;
    } else {
      nxt[prv[v]] = nxt[v];
      if (nxt[v] >= 0) prv[nxt[v]] = prv[v];
    }
    nxt[v] = -1;
    prv[v] = -1;
    linked[v] = 0;
    --total_vals;
    if (--cnt[pos] == 0) {
      state[pos] = 2;
      head[pos] = -1;
      --live;
    }
    return true;
  }

  int64_t bag_head(uint64_t hi, uint64_t lo) const {
    bool found = false;
    uint64_t pos = find(hi, lo, &found);
    return found ? head[pos] : -1;
  }

  int64_t bag_count(uint64_t hi, uint64_t lo) const {
    bool found = false;
    uint64_t pos = find(hi, lo, &found);
    return found ? cnt[pos] : 0;
  }
};

}  // namespace

extern "C" {

void* pwtpu_idx_new(uint64_t cap_hint) { return new KeyIndex(cap_hint); }

void pwtpu_idx_free(void* h) { delete static_cast<KeyIndex*>(h); }

int64_t pwtpu_idx_len(void* h) { return static_cast<KeyIndex*>(h)->live; }

// One past the largest slot ever handed out: the size of the caller's columns.
int64_t pwtpu_idx_slot_bound(void* h) { return static_cast<KeyIndex*>(h)->next_slot; }

// Duplicate keys within one batch share a slot (is_new on the first only).
void pwtpu_idx_upsert(void* h, const uint64_t* keys, int64_t n, int64_t* out_slots,
                      uint8_t* out_is_new) {
  KeyIndex* idx = static_cast<KeyIndex*>(h);
  idx->reserve_for(static_cast<uint64_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    if (i + 8 < n) __builtin_prefetch(&idx->state[keys[2 * (i + 8) + 1] & idx->mask]);
    uint8_t is_new = 0;
    out_slots[i] = idx->upsert(keys[2 * i], keys[2 * i + 1], &is_new);
    if (out_is_new != nullptr) out_is_new[i] = is_new;
  }
}

void pwtpu_idx_lookup(void* h, const uint64_t* keys, int64_t n, int64_t* out_slots) {
  const KeyIndex* idx = static_cast<const KeyIndex*>(h);
  for (int64_t i = 0; i < n; ++i) {
    if (i + 8 < n) __builtin_prefetch(&idx->state[keys[2 * (i + 8) + 1] & idx->mask]);
    out_slots[i] = idx->lookup(keys[2 * i], keys[2 * i + 1]);
  }
}

// A removed key frees its slot for reuse; an absent key gives -1.
void pwtpu_idx_remove(void* h, const uint64_t* keys, int64_t n, int64_t* out_slots) {
  KeyIndex* idx = static_cast<KeyIndex*>(h);
  for (int64_t i = 0; i < n; ++i) {
    if (i + 8 < n) __builtin_prefetch(&idx->state[keys[2 * (i + 8) + 1] & idx->mask]);
    out_slots[i] = idx->remove(keys[2 * i], keys[2 * i + 1]);
  }
}

// Keys and upsert in one call (the groupby's pair). Returns -1 on success,
// else the first unsupported row, and then the index is untouched: every row
// hashes before any upsert.
int64_t pwtpu_hash_upsert(const PwCol* cols, int32_t ncols, uint64_t n, const uint8_t* salt,
                          uint64_t salt_len, PyObject* np_bool, PyObject* np_integer,
                          void* idx_handle, uint64_t* out_hi, uint64_t* out_lo,
                          int64_t* out_slots, uint8_t* out_is_new) {
  int64_t status =
      pwtpu_hash_typed(cols, ncols, n, salt, salt_len, np_bool, np_integer, out_hi, out_lo);
  if (status != -1) return status;
  KeyIndex* idx = static_cast<KeyIndex*>(idx_handle);
  idx->reserve_for(n);
  for (uint64_t i = 0; i < n; ++i) {
    if (i + 8 < n) __builtin_prefetch(&idx->state[out_lo[i + 8] & idx->mask]);
    uint8_t is_new = 0;
    out_slots[i] = idx->upsert(out_hi[i], out_lo[i], &is_new);
    out_is_new[i] = is_new;
  }
  return -1;
}

// Restore: insert keys with the slots they had (slots index the caller's
// columns and must survive a pickle round trip), then rebuild the free stack
// from the gaps below next_slot.
void pwtpu_idx_restore(void* h, const uint64_t* keys, const int64_t* in_slots, int64_t n,
                       int64_t next_slot) {
  KeyIndex* idx = static_cast<KeyIndex*>(h);
  std::vector<bool> used(static_cast<size_t>(next_slot), false);
  for (int64_t i = 0; i < n; ++i) {
    idx->rehash_if_needed();
    bool found = false;
    uint64_t pos = idx->find(keys[2 * i], keys[2 * i + 1], &found);
    if (!found) {
      if (idx->state[pos] == 0) ++idx->filled;
      ++idx->live;
    }
    idx->khi[pos] = keys[2 * i];
    idx->klo[pos] = keys[2 * i + 1];
    idx->state[pos] = 1;
    idx->slots[pos] = in_slots[i];
    if (in_slots[i] >= 0 && in_slots[i] < next_slot) used[in_slots[i]] = true;
  }
  idx->next_slot = next_slot;
  idx->free_slots.clear();
  for (int64_t s = next_slot - 1; s >= 0; --s) {
    if (!used[s]) idx->free_slots.push_back(s);
  }
}

// Every live (key, slot) pair; the buffers hold pwtpu_idx_len entries.
void pwtpu_idx_items(void* h, uint64_t* out_keys, int64_t* out_slots) {
  const KeyIndex* idx = static_cast<const KeyIndex*>(h);
  uint64_t j = 0;
  for (uint64_t pos = 0; pos <= idx->mask; ++pos) {
    if (idx->state[pos] != 1) continue;
    out_keys[2 * j] = idx->khi[pos];
    out_keys[2 * j + 1] = idx->klo[pos];
    out_slots[j] = idx->slots[pos];
    ++j;
  }
}

void* pwtpu_mm_new() { return new MultiMap(); }

void pwtpu_mm_free(void* h) { delete static_cast<MultiMap*>(h); }

int64_t pwtpu_mm_total(void* h) { return static_cast<MultiMap*>(h)->total_vals; }

void pwtpu_mm_insert(void* h, const uint64_t* keys, const int64_t* values, int64_t n) {
  MultiMap* mm = static_cast<MultiMap*>(h);
  for (int64_t i = 0; i < n; ++i) mm->insert(keys[2 * i], keys[2 * i + 1], values[i]);
}

// out_found (optional): 1 where the value was removed.
void pwtpu_mm_remove(void* h, const uint64_t* keys, const int64_t* values, int64_t n,
                     uint8_t* out_found) {
  MultiMap* mm = static_cast<MultiMap*>(h);
  for (int64_t i = 0; i < n; ++i) {
    bool ok = mm->remove(keys[2 * i], keys[2 * i + 1], values[i]);
    if (out_found != nullptr) out_found[i] = ok ? 1 : 0;
  }
}

// Matches per probe row; returns their total (the CSR sizing pass).
int64_t pwtpu_mm_count(void* h, const uint64_t* keys, int64_t n, int64_t* out_counts) {
  const MultiMap* mm = static_cast<const MultiMap*>(h);
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i + 8 < n) __builtin_prefetch(&mm->state[keys[2 * (i + 8) + 1] & mm->mask]);
    int64_t c = mm->bag_count(keys[2 * i], keys[2 * i + 1]);
    out_counts[i] = c;
    total += c;
  }
  return total;
}

// The CSR fill pass: out_values holds pwtpu_mm_count's total, row by row in
// probe order, each bag last inserted first.
void pwtpu_mm_fill(void* h, const uint64_t* keys, int64_t n, int64_t* out_values) {
  const MultiMap* mm = static_cast<const MultiMap*>(h);
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i + 8 < n) __builtin_prefetch(&mm->state[keys[2 * (i + 8) + 1] & mm->mask]);
    for (int64_t v = mm->bag_head(keys[2 * i], keys[2 * i + 1]); v >= 0; v = mm->nxt[v]) {
      out_values[w++] = v;
    }
  }
}

// Every (key, value) pair; the buffers hold pwtpu_mm_total entries.
void pwtpu_mm_items(void* h, uint64_t* out_keys, int64_t* out_values) {
  const MultiMap* mm = static_cast<const MultiMap*>(h);
  int64_t j = 0;
  for (uint64_t pos = 0; pos <= mm->mask; ++pos) {
    if (mm->state[pos] != 1) continue;
    for (int64_t v = mm->head[pos]; v >= 0; v = mm->nxt[v]) {
      out_keys[2 * j] = mm->khi[pos];
      out_keys[2 * j + 1] = mm->klo[pos];
      out_values[j] = v;
      ++j;
    }
  }
}

// ---------------------------------------------------------------------------
// A join side's arrangement update in one pass: row-index upsert, the writes
// of the slot-indexed key columns and the join-key multimap. keys_arr / jk_arr
// are the caller's slot-indexed KEY_DTYPE columns, sized to at least
// slot_bound + n rows. A row key already present replaces its row, and leaves
// the join-key bag it sat in.
void pwtpu_side_insert(void* idx_h, void* mm_h, const uint64_t* row_keys, const uint64_t* jkeys,
                       int64_t n, uint64_t* keys_arr, uint64_t* jk_arr, int64_t* out_slots) {
  KeyIndex* idx = static_cast<KeyIndex*>(idx_h);
  MultiMap* mm = static_cast<MultiMap*>(mm_h);
  idx->reserve_for(static_cast<uint64_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    if (i + 8 < n) {
      __builtin_prefetch(&idx->state[row_keys[2 * (i + 8) + 1] & idx->mask]);
      __builtin_prefetch(&mm->state[jkeys[2 * (i + 8) + 1] & mm->mask]);
    }
    uint8_t is_new = 0;
    int64_t slot = idx->upsert(row_keys[2 * i], row_keys[2 * i + 1], &is_new);
    if (!is_new) mm->remove(jk_arr[2 * slot], jk_arr[2 * slot + 1], slot);
    keys_arr[2 * slot] = row_keys[2 * i];
    keys_arr[2 * slot + 1] = row_keys[2 * i + 1];
    jk_arr[2 * slot] = jkeys[2 * i];
    jk_arr[2 * slot + 1] = jkeys[2 * i + 1];
    mm->insert(jkeys[2 * i], jkeys[2 * i + 1], slot);
    out_slots[i] = slot;
  }
}

void pwtpu_side_remove(void* idx_h, void* mm_h, const uint64_t* row_keys, int64_t n,
                       const uint64_t* jk_arr, int64_t* out_slots) {
  KeyIndex* idx = static_cast<KeyIndex*>(idx_h);
  MultiMap* mm = static_cast<MultiMap*>(mm_h);
  for (int64_t i = 0; i < n; ++i) {
    int64_t slot = idx->remove(row_keys[2 * i], row_keys[2 * i + 1]);
    out_slots[i] = slot;
    if (slot >= 0) mm->remove(jk_arr[2 * slot], jk_arr[2 * slot + 1], slot);
  }
}

}  // extern "C"
