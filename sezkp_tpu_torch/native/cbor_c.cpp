// CPython extension: fast CBOR value decoder for the hot wire paths.
//
// The framework's CBOR layer (utils/cbor.py) mirrors the reference's
// ciborium/serde_cbor encodings (crates/sezkp-core/src/io.rs,
// crates/sezkp-fold/src/lib.rs:142). Decoding multi-MB fold bundles and
// block files through the recursive pure-Python decoder costs ~2s per
// million values; this extension decodes the same value model natively
// (~50x). The Python layer keeps full behavioral control: anything this
// decoder does not support (tags) raises UnsupportedError and falls back
// to the pure-Python implementation, and all malformed input raises
// ValueError exactly like the Python decoder (the CBOR fuzz corpus in
// tests/test_invariants.py runs against both).
//
// Exposed API:
//   decode_at(data: bytes, pos: int) -> (object, new_pos: int)
//   UnsupportedError (exception type; subclass of ValueError)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <cmath>

static PyObject *UnsupportedError;

struct Dec {
  const unsigned char *p;
  Py_ssize_t n;
  Py_ssize_t pos;
  int depth;
};

static PyObject *fail(const char *msg) {
  PyErr_SetString(PyExc_ValueError, msg);
  return nullptr;
}

static int need(Dec *d, Py_ssize_t k) {
  if (d->pos + k > d->n) {
    PyErr_SetString(PyExc_ValueError, "CBOR: unexpected end of input");
    return 0;
  }
  return 1;
}

// additional-info field -> unsigned argument value
static int read_uint(Dec *d, unsigned info, uint64_t *out) {
  if (info < 24) {
    *out = info;
    return 1;
  }
  int k;
  switch (info) {
    case 24: k = 1; break;
    case 25: k = 2; break;
    case 26: k = 4; break;
    case 27: k = 8; break;
    default:
      PyErr_Format(PyExc_ValueError, "CBOR: unsupported additional info %u", info);
      return 0;
  }
  if (!need(d, k)) return 0;
  uint64_t v = 0;
  for (int i = 0; i < k; i++) v = (v << 8) | d->p[d->pos++];
  *out = v;
  return 1;
}

static double decode_half(uint16_t h) {
  double sign = (h & 0x8000) ? -1.0 : 1.0;
  unsigned exp = (h >> 10) & 0x1F;
  unsigned frac = h & 0x3FF;
  if (exp == 0) return sign * frac * ldexp(1.0, -24);
  if (exp == 31) return sign * (frac == 0 ? HUGE_VAL : NAN);
  return sign * (frac + 1024.0) * ldexp(1.0, (int)exp - 25);
}

static PyObject *decode(Dec *d);

static PyObject *decode_indefinite_string(Dec *d, unsigned major) {
  // chunks must be definite-length strings of the same major type
  PyObject *parts = PyList_New(0);
  if (!parts) return nullptr;
  for (;;) {
    if (!need(d, 1)) { Py_DECREF(parts); return nullptr; }
    unsigned char ib = d->p[d->pos];
    if (ib == 0xFF) { d->pos++; break; }
    PyObject *chunk = decode(d);
    if (!chunk) { Py_DECREF(parts); return nullptr; }
    int ok = (major == 2) ? PyBytes_Check(chunk) : PyUnicode_Check(chunk);
    if (!ok) {
      Py_DECREF(chunk);
      Py_DECREF(parts);
      return fail(major == 2 ? "CBOR: bad indefinite byte chunk"
                             : "CBOR: bad indefinite text chunk");
    }
    if (PyList_Append(parts, chunk) < 0) {
      Py_DECREF(chunk);
      Py_DECREF(parts);
      return nullptr;
    }
    Py_DECREF(chunk);
  }
  PyObject *sep = (major == 2) ? PyBytes_FromStringAndSize("", 0)
                               : PyUnicode_FromStringAndSize("", 0);
  if (!sep) { Py_DECREF(parts); return nullptr; }
  PyObject *out = (major == 2) ? _PyBytes_Join(sep, parts)
                               : PyUnicode_Join(sep, parts);
  Py_DECREF(sep);
  Py_DECREF(parts);
  return out;
}

static PyObject *decode(Dec *d) {
  if (++d->depth > 512) {
    d->depth--;
    return fail("CBOR: nesting too deep");
  }
  PyObject *result = nullptr;
  if (!need(d, 1)) goto done;
  {
    unsigned char ib = d->p[d->pos++];
    unsigned major = ib >> 5, info = ib & 0x1F;
    switch (major) {
      case 0: {
        uint64_t v;
        if (!read_uint(d, info, &v)) goto done;
        result = PyLong_FromUnsignedLongLong(v);
        break;
      }
      case 1: {
        uint64_t v;
        if (!read_uint(d, info, &v)) goto done;
        if (v < (1ULL << 63)) {
          result = PyLong_FromLongLong(-1 - (long long)v);
        } else {
          PyObject *big = PyLong_FromUnsignedLongLong(v);
          if (!big) goto done;
          PyObject *minus1 = PyLong_FromLong(-1);
          if (!minus1) { Py_DECREF(big); goto done; }
          result = PyNumber_Subtract(minus1, big);
          Py_DECREF(minus1);
          Py_DECREF(big);
        }
        break;
      }
      case 2:
      case 3: {
        if (info == 31) {
          result = decode_indefinite_string(d, major);
          break;
        }
        uint64_t len;
        if (!read_uint(d, info, &len)) goto done;
        if (len > (uint64_t)(d->n - d->pos)) {
          fail("CBOR: unexpected end of input");
          goto done;
        }
        const char *s = (const char *)(d->p + d->pos);
        d->pos += (Py_ssize_t)len;
        result = (major == 2)
                     ? PyBytes_FromStringAndSize(s, (Py_ssize_t)len)
                     : PyUnicode_DecodeUTF8(s, (Py_ssize_t)len, nullptr);
        break;
      }
      case 4: {
        PyObject *lst = PyList_New(0);
        if (!lst) goto done;
        if (info == 31) {
          for (;;) {
            if (!need(d, 1)) { Py_DECREF(lst); goto done; }
            if (d->p[d->pos] == 0xFF) { d->pos++; break; }
            PyObject *item = decode(d);
            if (!item || PyList_Append(lst, item) < 0) {
              Py_XDECREF(item);
              Py_DECREF(lst);
              goto done;
            }
            Py_DECREF(item);
          }
        } else {
          uint64_t len;
          if (!read_uint(d, info, &len)) { Py_DECREF(lst); goto done; }
          // grow incrementally: a malicious definite length fails on input
          // exhaustion instead of a giant allocation (matches Python path)
          for (uint64_t i = 0; i < len; i++) {
            PyObject *item = decode(d);
            if (!item || PyList_Append(lst, item) < 0) {
              Py_XDECREF(item);
              Py_DECREF(lst);
              goto done;
            }
            Py_DECREF(item);
          }
        }
        result = lst;
        break;
      }
      case 5: {
        PyObject *map = PyDict_New();
        if (!map) goto done;
        if (info == 31) {
          for (;;) {
            if (!need(d, 1)) { Py_DECREF(map); goto done; }
            if (d->p[d->pos] == 0xFF) { d->pos++; break; }
            PyObject *k = decode(d);
            if (!k) { Py_DECREF(map); goto done; }
            PyObject *v = decode(d);
            if (!v || PyDict_SetItem(map, k, v) < 0) {
              Py_DECREF(k);
              Py_XDECREF(v);
              Py_DECREF(map);
              goto done;
            }
            Py_DECREF(k);
            Py_DECREF(v);
          }
        } else {
          uint64_t len;
          if (!read_uint(d, info, &len)) { Py_DECREF(map); goto done; }
          for (uint64_t i = 0; i < len; i++) {
            PyObject *k = decode(d);
            if (!k) { Py_DECREF(map); goto done; }
            PyObject *v = decode(d);
            if (!v || PyDict_SetItem(map, k, v) < 0) {
              Py_DECREF(k);
              Py_XDECREF(v);
              Py_DECREF(map);
              goto done;
            }
            Py_DECREF(k);
            Py_DECREF(v);
          }
        }
        result = map;
        break;
      }
      case 6:
        PyErr_SetString(UnsupportedError, "CBOR: tagged value (python fallback)");
        break;
      default: {  // major == 7
        switch (info) {
          case 20: result = Py_NewRef(Py_False); break;
          case 21: result = Py_NewRef(Py_True); break;
          case 22: result = Py_NewRef(Py_None); break;
          case 23: result = Py_NewRef(Py_None); break;  // undefined -> None
          case 25: {
            if (!need(d, 2)) break;
            uint16_t h = (uint16_t)((d->p[d->pos] << 8) | d->p[d->pos + 1]);
            d->pos += 2;
            result = PyFloat_FromDouble(decode_half(h));
            break;
          }
          case 26: {
            if (!need(d, 4)) break;
            uint32_t u = 0;
            for (int i = 0; i < 4; i++) u = (u << 8) | d->p[d->pos++];
            float f;
            memcpy(&f, &u, 4);
            result = PyFloat_FromDouble((double)f);
            break;
          }
          case 27: {
            if (!need(d, 8)) break;
            uint64_t u = 0;
            for (int i = 0; i < 8; i++) u = (u << 8) | d->p[d->pos++];
            double f;
            memcpy(&f, &u, 8);
            result = PyFloat_FromDouble(f);
            break;
          }
          default:
            PyErr_Format(PyExc_ValueError,
                         "CBOR: unsupported simple value info=%u", info);
        }
      }
    }
  }
done:
  d->depth--;
  return result;
}

// ----------------------------- encoder -------------------------------------
//
// Mirrors utils/cbor.py::encode_into (ciborium-compatible conventions,
// dict insertion order). Anything outside the core value model — Tagged
// values (unless registered via set_tagged_class), u64 overflow, unknown
// types, excessive nesting — raises UnsupportedError so the Python
// implementation takes over and produces its exact error/bytes.

static PyObject *TaggedClass;   // set via set_tagged_class
static PyObject *U8ArrayClass;  // set via set_u8array_class

struct Enc {
  char *buf;
  size_t len, cap;
  int depth;
};

static int enc_reserve(Enc *e, size_t extra) {
  if (e->len + extra <= e->cap) return 1;
  size_t cap = e->cap ? e->cap : 256;
  while (cap < e->len + extra) cap *= 2;
  char *nb = (char *)PyMem_Realloc(e->buf, cap);
  if (!nb) {
    PyErr_NoMemory();
    return 0;
  }
  e->buf = nb;
  e->cap = cap;
  return 1;
}

static int enc_bytes(Enc *e, const void *p, size_t n) {
  if (!enc_reserve(e, n)) return 0;
  memcpy(e->buf + e->len, p, n);
  e->len += n;
  return 1;
}

static int enc_byte(Enc *e, unsigned char b) { return enc_bytes(e, &b, 1); }

static int enc_head(Enc *e, unsigned major, uint64_t v) {
  unsigned char h[9];
  size_t k;
  if (v < 24) {
    h[0] = (unsigned char)((major << 5) | v);
    k = 1;
  } else if (v < 0x100) {
    h[0] = (unsigned char)((major << 5) | 24);
    h[1] = (unsigned char)v;
    k = 2;
  } else if (v < 0x10000) {
    h[0] = (unsigned char)((major << 5) | 25);
    h[1] = (unsigned char)(v >> 8);
    h[2] = (unsigned char)v;
    k = 3;
  } else if (v < 0x100000000ULL) {
    h[0] = (unsigned char)((major << 5) | 26);
    for (int i = 0; i < 4; i++) h[1 + i] = (unsigned char)(v >> (24 - 8 * i));
    k = 5;
  } else {
    h[0] = (unsigned char)((major << 5) | 27);
    for (int i = 0; i < 8; i++) h[1 + i] = (unsigned char)(v >> (56 - 8 * i));
    k = 9;
  }
  return enc_bytes(e, h, k);
}

static int unsupported(const char *msg) {
  PyErr_SetString(UnsupportedError, msg);
  return 0;
}

static int encode_obj(Enc *e, PyObject *obj) {
  if (++e->depth > 512) {
    e->depth--;
    return unsupported("CBOR: nesting too deep (python fallback)");
  }
  int ok = 0;
  if (obj == Py_None) {
    ok = enc_byte(e, 0xF6);
  } else if (obj == Py_True) {
    ok = enc_byte(e, 0xF5);
  } else if (obj == Py_False) {
    ok = enc_byte(e, 0xF4);
  } else if (PyLong_Check(obj)) {
    int overflow;
    long long sv = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (overflow == 0 && sv == -1 && PyErr_Occurred()) {
      // conversion error
    } else if (overflow == 0) {
      ok = (sv >= 0) ? enc_head(e, 0, (uint64_t)sv)
                     : enc_head(e, 1, (uint64_t)(-1 - sv));
    } else if (overflow > 0) {
      uint64_t uv = PyLong_AsUnsignedLongLong(obj);
      if (uv == (uint64_t)-1 && PyErr_Occurred()) {
        PyErr_Clear();
        unsupported("CBOR: integer out of u64 range (python fallback)");
      } else {
        ok = enc_head(e, 0, uv);
      }
    } else {
      unsupported("CBOR: integer out of u64 range (python fallback)");
    }
  } else if (PyUnicode_Check(obj)) {
    Py_ssize_t n;
    const char *s = PyUnicode_AsUTF8AndSize(obj, &n);
    if (s) ok = enc_head(e, 3, (uint64_t)n) && enc_bytes(e, s, (size_t)n);
  } else if (PyBytes_Check(obj)) {
    ok = enc_head(e, 2, (uint64_t)PyBytes_GET_SIZE(obj)) &&
         enc_bytes(e, PyBytes_AS_STRING(obj), (size_t)PyBytes_GET_SIZE(obj));
  } else if (PyByteArray_Check(obj) || PyMemoryView_Check(obj)) {
    Py_buffer b;
    if (PyObject_GetBuffer(obj, &b, PyBUF_CONTIG_RO) == 0) {
      ok = enc_head(e, 2, (uint64_t)b.len) && enc_bytes(e, b.buf, (size_t)b.len);
      PyBuffer_Release(&b);
    }
  } else if (PyFloat_Check(obj)) {
    double f = PyFloat_AS_DOUBLE(obj);
    uint64_t u;
    memcpy(&u, &f, 8);
    unsigned char h[9];
    h[0] = 0xFB;
    for (int i = 0; i < 8; i++) h[1 + i] = (unsigned char)(u >> (56 - 8 * i));
    ok = enc_bytes(e, h, 9);
  } else if (PyList_Check(obj) || PyTuple_Check(obj)) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(obj);
    if (enc_head(e, 4, (uint64_t)n)) {
      ok = 1;
      for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PyList_Check(obj) ? PyList_GET_ITEM(obj, i)
                                           : PyTuple_GET_ITEM(obj, i);
        if (!encode_obj(e, item)) {
          ok = 0;
          break;
        }
      }
    }
  } else if (PyDict_Check(obj)) {
    if (enc_head(e, 5, (uint64_t)PyDict_GET_SIZE(obj))) {
      ok = 1;
      PyObject *k, *v;
      Py_ssize_t pos = 0;
      while (PyDict_Next(obj, &pos, &k, &v)) {  // insertion order
        if (!encode_obj(e, k) || !encode_obj(e, v)) {
          ok = 0;
          break;
        }
      }
    }
  } else if (U8ArrayClass && PyObject_IsInstance(obj, U8ArrayClass) == 1) {
    // serde [u8; N]: CBOR array of small ints, held compactly as bytes
    PyObject *data = PyObject_GetAttrString(obj, "data");
    if (data && PyBytes_Check(data)) {
      Py_ssize_t n = PyBytes_GET_SIZE(data);
      const unsigned char *p = (const unsigned char *)PyBytes_AS_STRING(data);
      if (enc_head(e, 4, (uint64_t)n)) {
        ok = 1;
        for (Py_ssize_t i = 0; i < n; i++) {
          if (!enc_head(e, 0, p[i])) {
            ok = 0;
            break;
          }
        }
      }
    }
    Py_XDECREF(data);
  } else if (TaggedClass && PyObject_IsInstance(obj, TaggedClass) == 1) {
    PyObject *tag = PyObject_GetAttrString(obj, "tag");
    PyObject *val = tag ? PyObject_GetAttrString(obj, "value") : nullptr;
    if (tag && val && PyLong_Check(tag)) {
      uint64_t tv = PyLong_AsUnsignedLongLong(tag);
      if (tv == (uint64_t)-1 && PyErr_Occurred()) {
        PyErr_Clear();
        unsupported("CBOR: tag out of range (python fallback)");
      } else {
        ok = enc_head(e, 6, tv) && encode_obj(e, val);
      }
    } else if (tag && val) {
      unsupported("CBOR: non-int tag (python fallback)");
    }
    Py_XDECREF(tag);
    Py_XDECREF(val);
  } else {
    unsupported("CBOR: unsupported type (python fallback)");
  }
  e->depth--;
  return ok;
}

static PyObject *py_dumps(PyObject *, PyObject *obj) {
  Enc e{nullptr, 0, 0, 0};
  if (!encode_obj(&e, obj)) {
    PyMem_Free(e.buf);
    return nullptr;
  }
  PyObject *out = PyBytes_FromStringAndSize(e.buf, (Py_ssize_t)e.len);
  PyMem_Free(e.buf);
  return out;
}

static PyObject *py_set_tagged_class(PyObject *, PyObject *cls) {
  Py_XDECREF(TaggedClass);
  TaggedClass = Py_NewRef(cls);
  Py_RETURN_NONE;
}

static PyObject *py_set_u8array_class(PyObject *, PyObject *cls) {
  Py_XDECREF(U8ArrayClass);
  U8ArrayClass = Py_NewRef(cls);
  Py_RETURN_NONE;
}

static PyObject *py_decode_at(PyObject *, PyObject *args) {
  Py_buffer buf;
  Py_ssize_t pos;
  if (!PyArg_ParseTuple(args, "y*n", &buf, &pos)) return nullptr;
  if (pos < 0 || pos > buf.len) {
    PyBuffer_Release(&buf);
    return fail("CBOR: position out of range");
  }
  Dec d{(const unsigned char *)buf.buf, buf.len, pos, 0};
  PyObject *obj = decode(&d);
  PyBuffer_Release(&buf);
  if (!obj) return nullptr;
  PyObject *out = Py_BuildValue("(Nn)", obj, d.pos);
  return out;
}

static PyMethodDef Methods[] = {
    {"decode_at", py_decode_at, METH_VARARGS,
     "decode_at(data, pos) -> (value, new_pos)"},
    {"dumps", py_dumps, METH_O, "dumps(obj) -> bytes"},
    {"set_tagged_class", py_set_tagged_class, METH_O,
     "register the Tagged wrapper class for encode"},
    {"set_u8array_class", (PyCFunction)py_set_u8array_class, METH_O,
     "register the U8Array wrapper class for encode"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "sezkp_cbor_c", nullptr, -1, Methods,
    nullptr, nullptr, nullptr, nullptr,
};

PyMODINIT_FUNC PyInit_sezkp_cbor_c(void) {
  PyObject *m = PyModule_Create(&moduledef);
  if (!m) return nullptr;
  UnsupportedError =
      PyErr_NewException("sezkp_cbor_c.UnsupportedError", PyExc_ValueError, nullptr);
  if (!UnsupportedError || PyModule_AddObject(m, "UnsupportedError", UnsupportedError) < 0) {
    Py_XDECREF(UnsupportedError);
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
