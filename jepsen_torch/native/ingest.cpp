// Op-list -> columnar ingest walk, and the same walk over serialized
// jsonl histories (CPython extension).
//
// The hot half of jepsen_torch.history.columnar.ops_to_columnar: one pass
// over recorded histories of Op objects applying invoke/completion
// pairing, failure retraction and observed-value propagation, emitting
// flat line buffers (type code / dense process / op kind / original op
// index / ok flag / info link) that the Python side turns into padded
// ColumnarOps arrays after the identity-drop pass. Per-op Python
// attribute reads are the floor cost of ingesting recorded histories;
// the walk in C keeps to that floor instead of the interpreter's loop.
//
// Contract notes mirror the pure-Python twin (_walk_py):
//   * ops whose process is not an int (nemesis) are skipped; a bool
//     process passes, as it passes isinstance(p, int);
//   * "fail" retracts the open invoke line (type -> PAD) and emits no
//     completion line;
//   * invoke lines carry the op kind (f, canonical value) with the
//     completion's observed value when the invoke recorded None;
//   * kinds are interned into the caller's vocab dict / kinds list so
//     indices stay aligned across walks and with seeded vocabularies.
//
// Build (jepsen_torch/native builds it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -I<python include>
//       -o _jt_torch_ingest.so ingest.cpp
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int8_t LINE_PAD = -1, LINE_INVOKE = 0, LINE_OK = 1, LINE_INFO = 2;

PyObject *s_process, *s_type, *s_f, *s_value, *s_index;

// canonical_value twin (ops/statespace.py): lists/tuples (incl. tuple
// subclasses like independent.KV) become plain tuples recursively; sets
// become frozensets of canonical items; everything else passes through.
PyObject* canon(PyObject* v);

PyObject* canon_items_tuple(PyObject* v) {
  PyObject* fast = PySequence_Fast(v, "expected a sequence");
  if (!fast) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject* out = PyTuple_New(n);
  if (!out) {
    Py_DECREF(fast);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* c = canon(PySequence_Fast_GET_ITEM(fast, i));
    if (!c) {
      Py_DECREF(fast);
      Py_DECREF(out);
      return nullptr;
    }
    PyTuple_SET_ITEM(out, i, c);
  }
  Py_DECREF(fast);
  return out;
}

PyObject* canon(PyObject* v) {
  if (PyList_Check(v) || PyTuple_Check(v)) {
    // Depth-guarded like the pure-Python twin: a pathologically nested
    // value raises RecursionError instead of overflowing the C stack.
    if (Py_EnterRecursiveCall(" in op-value canonicalization"))
      return nullptr;
    PyObject* out = canon_items_tuple(v);
    Py_LeaveRecursiveCall();
    return out;
  }
  if (PyAnySet_Check(v)) {
    if (Py_EnterRecursiveCall(" in op-value canonicalization"))
      return nullptr;
    PyObject* t = canon_items_tuple(v);
    Py_LeaveRecursiveCall();
    if (!t) return nullptr;
    PyObject* fs = PyFrozenSet_New(t);
    Py_DECREF(t);
    return fs;
  }
  Py_INCREF(v);
  return v;
}

// Intern (f, canon(value)) into vocab/kinds; returns kind index or -2 on
// error. `value_fallback` supplies the observed value when the invoke
// recorded None.
int32_t intern_kind(PyObject* vocab, PyObject* kinds, PyObject* inv,
                    PyObject* completion) {
  PyObject* f = PyObject_GetAttr(inv, s_f);
  if (!f) return -2;
  PyObject* v = PyObject_GetAttr(inv, s_value);
  if (!v) {
    Py_DECREF(f);
    return -2;
  }
  if (v == Py_None && completion) {
    Py_DECREF(v);
    v = PyObject_GetAttr(completion, s_value);
    if (!v) {
      Py_DECREF(f);
      return -2;
    }
  }
  PyObject* cv = canon(v);
  Py_DECREF(v);
  if (!cv) {
    Py_DECREF(f);
    return -2;
  }
  PyObject* key = PyTuple_Pack(2, f, cv);
  Py_DECREF(f);
  Py_DECREF(cv);
  if (!key) return -2;
  PyObject* ki_obj = PyDict_GetItemWithError(vocab, key);  // borrowed
  int32_t ki;
  if (ki_obj) {
    ki = (int32_t)PyLong_AsLong(ki_obj);
  } else {
    if (PyErr_Occurred()) {
      Py_DECREF(key);
      return -2;
    }
    ki = (int32_t)PyList_GET_SIZE(kinds);
    PyObject* kio = PyLong_FromLong(ki);
    if (!kio || PyDict_SetItem(vocab, key, kio) < 0 ||
        PyList_Append(kinds, key) < 0) {
      Py_XDECREF(kio);
      Py_DECREF(key);
      return -2;
    }
    Py_DECREF(kio);
  }
  Py_DECREF(key);
  return ki;
}

int32_t op_index_or(PyObject* op, int32_t dflt) {
  PyObject* pi = PyObject_GetAttr(op, s_index);
  if (!pi) {
    PyErr_Clear();
    return dflt;
  }
  int32_t r = (pi == Py_None) ? dflt : (int32_t)PyLong_AsLong(pi);
  Py_DECREF(pi);
  return r;
}

// walk(histories, vocab, kinds) ->
//   (code, proc, kind, oidx, okflag, link, rowlen) as bytes buffers
//   [int8, int32, int32, int32, int8, int32, int64].
PyObject* walk(PyObject*, PyObject* args) {
  PyObject *histories, *vocab, *kinds;
  if (!PyArg_ParseTuple(args, "OOO", &histories, &vocab, &kinds))
    return nullptr;
  if (!PyDict_Check(vocab) || !PyList_Check(kinds)) {
    PyErr_SetString(PyExc_TypeError, "vocab must be dict, kinds list");
    return nullptr;
  }

  std::vector<int8_t> code;
  std::vector<int32_t> proc, kind, oidx, link;
  std::vector<int8_t> okflag;
  std::vector<int64_t> rowlen;

  PyObject* hfast = PySequence_Fast(histories, "expected history list");
  if (!hfast) return nullptr;
  Py_ssize_t nh = PySequence_Fast_GET_SIZE(hfast);
  rowlen.reserve(nh);

  // op objects are borrowed: the history lists keep them alive.
  std::unordered_map<long long, int64_t> open_line;
  std::unordered_map<long long, PyObject*> open_op;
  std::unordered_map<long long, int32_t> dense;

  for (Py_ssize_t hi = 0; hi < nh; hi++) {
    PyObject* h = PySequence_Fast_GET_ITEM(hfast, hi);
    PyObject* ofast = PySequence_Fast(h, "expected op list");
    if (!ofast) {
      Py_DECREF(hfast);
      return nullptr;
    }
    Py_ssize_t nop = PySequence_Fast_GET_SIZE(ofast);
    int64_t rowstart = (int64_t)code.size();
    open_line.clear();
    open_op.clear();
    dense.clear();

    for (Py_ssize_t pos = 0; pos < nop; pos++) {
      PyObject* op = PySequence_Fast_GET_ITEM(ofast, pos);
      PyObject* pp = PyObject_GetAttr(op, s_process);
      if (!pp) goto fail;
      if (!PyLong_Check(pp)) {
        Py_DECREF(pp);
        continue;
      }
      {
        long long p = PyLong_AsLongLong(pp);
        Py_DECREF(pp);
        PyObject* pt = PyObject_GetAttr(op, s_type);
        if (!pt) goto fail;
        // Frequency order: invoke, ok, fail, info. Compare by content:
        // ops loaded from stored histories carry non-interned strings.
        int t;
        if (PyUnicode_CompareWithASCIIString(pt, "invoke") == 0)
          t = 0;
        else if (PyUnicode_CompareWithASCIIString(pt, "ok") == 0)
          t = 1;
        else if (PyUnicode_CompareWithASCIIString(pt, "fail") == 0)
          t = 2;
        else if (PyUnicode_CompareWithASCIIString(pt, "info") == 0)
          t = 3;
        else
          t = -1;
        Py_DECREF(pt);

        if (t == 0) {  // invoke
          int64_t j = (int64_t)code.size();
          open_line[p] = j;
          open_op[p] = op;
          auto r = dense.emplace(p, (int32_t)dense.size());
          code.push_back(LINE_INVOKE);
          proc.push_back(r.first->second);
          kind.push_back(-1);
          oidx.push_back(op_index_or(op, (int32_t)pos));
          okflag.push_back(0);
          link.push_back(-1);
        } else if (t == 1 || t == 3) {  // ok / info
          auto it = open_line.find(p);
          if (it == open_line.end()) continue;
          int64_t j = it->second;
          open_line.erase(it);
          PyObject* inv = open_op[p];
          open_op.erase(p);
          // Only ok completions propagate observations onto the invoke
          // (history.core.complete semantics).
          int32_t ki = intern_kind(vocab, kinds, inv, t == 1 ? op : nullptr);
          if (ki == -2) goto fail;
          kind[j] = ki;
          if (t == 1) okflag[j] = 1;
          code.push_back(t == 1 ? LINE_OK : LINE_INFO);
          proc.push_back(proc[j]);
          kind.push_back(-1);
          oidx.push_back(op_index_or(op, (int32_t)pos));
          okflag.push_back(0);
          link.push_back(t == 3 ? (int32_t)j : -1);
        } else if (t == 2) {  // fail: retract the invoke line
          auto it = open_line.find(p);
          if (it != open_line.end()) {
            code[it->second] = LINE_PAD;
            open_line.erase(it);
            open_op.erase(p);
          }
        }
      }
      continue;
    fail:
      Py_DECREF(ofast);
      Py_DECREF(hfast);
      return nullptr;
    }

    // Crashed invocations: kind from the invoke's own value, interned
    // in invocation (line) order so the kinds vocabulary is
    // bit-identical to the Python oracle's insertion order.
    std::vector<std::pair<int64_t, long>> crashed;
    crashed.reserve(open_line.size());
    for (auto& kv : open_line)
      crashed.emplace_back(kv.second, kv.first);
    std::sort(crashed.begin(), crashed.end());
    for (auto& pr : crashed) {
      int32_t ki = intern_kind(vocab, kinds, open_op[pr.second],
                               nullptr);
      if (ki == -2) {
        Py_DECREF(ofast);
        Py_DECREF(hfast);
        return nullptr;
      }
      kind[pr.first] = ki;
    }
    rowlen.push_back((int64_t)code.size() - rowstart);
    Py_DECREF(ofast);
  }
  Py_DECREF(hfast);

  return Py_BuildValue(
      "(y#y#y#y#y#y#y#)",
      (const char*)code.data(), (Py_ssize_t)(code.size() * sizeof(int8_t)),
      (const char*)proc.data(), (Py_ssize_t)(proc.size() * sizeof(int32_t)),
      (const char*)kind.data(), (Py_ssize_t)(kind.size() * sizeof(int32_t)),
      (const char*)oidx.data(), (Py_ssize_t)(oidx.size() * sizeof(int32_t)),
      (const char*)okflag.data(), (Py_ssize_t)(okflag.size() * sizeof(int8_t)),
      (const char*)link.data(), (Py_ssize_t)(link.size() * sizeof(int32_t)),
      (const char*)rowlen.data(),
      (Py_ssize_t)(rowlen.size() * sizeof(int64_t)));
}

// ------------------------------------------------------------ jsonl walk
//
// The store's histories are JSON lines (history/codec.py). walk_jsonl
// runs the same pairing walk straight off the serialized bytes, with no
// per-op Python objects at all: the native loader of the replay seam
// (store.clj:165-171; the reference framework reads its machine form
// through JVM-native fressian). A line's
// five relevant fields are located by a small JSON scanner, op kinds
// are interned by their raw (f, value) text through a C-side cache, and
// only a NEW kind's value text is materialized into a Python object
// (via the caller-supplied parse function, which applies codec._revive).
//
// Returns the same seven buffers as walk(), or None when any line
// doesn't scan (callers fall back to the Op-object path).

struct Slice {
  const char* p = nullptr;
  Py_ssize_t n = 0;
  bool set() const { return p != nullptr; }
  bool is(const char* lit) const {
    Py_ssize_t ln = (Py_ssize_t)strlen(lit);
    return n == ln && memcmp(p, lit, (size_t)ln) == 0;
  }
  std::string str() const { return std::string(p, (size_t)n); }
};

// Skip one JSON value starting at s (s < e), honoring strings/escapes
// and nesting. Returns pointer past the value, or nullptr on malformed.
const char* skip_value(const char* s, const char* e) {
  if (s >= e) return nullptr;
  char c = *s;
  if (c == '"') {
    for (s++; s < e; s++) {
      if (*s == '\\') {
        s++;
        continue;
      }
      if (*s == '"') return s + 1;
    }
    return nullptr;
  }
  if (c == '{' || c == '[') {
    char close = (c == '{') ? '}' : ']';
    int depth = 1;
    for (s++; s < e; s++) {
      char d = *s;
      if (d == '"') {
        for (s++; s < e; s++) {
          if (*s == '\\') {
            s++;
            continue;
          }
          if (*s == '"') break;
        }
        if (s >= e) return nullptr;
      } else if (d == '{' || d == '[') {
        depth++;
      } else if (d == '}' || d == ']') {
        depth--;
        if (depth == 0) {
          if (d != close && depth == 0) return nullptr;
          return s + 1;
        }
      }
    }
    return nullptr;
  }
  // number / true / false / null: scan to a delimiter (any JSON
  // whitespace counts — a tab after a numeric process value must not
  // leak into the slice and silently demote a client op to nemesis).
  const char* t = s;
  while (t < e && *t != ',' && *t != '}' && *t != ']' && *t != ' ' &&
         *t != '\t' && *t != '\r' && *t != '\n')
    t++;
  return (t > s) ? t : nullptr;
}

const char* skip_ws(const char* s, const char* e) {
  while (s < e && (*s == ' ' || *s == '\t')) s++;
  return s;
}

// Parse a decimal integer slice (no quotes); false if not a pure int.
bool parse_int(const Slice& sl, long long* out) {
  if (!sl.n) return false;
  const char* s = sl.p;
  const char* e = sl.p + sl.n;
  bool neg = false;
  if (*s == '-') {
    neg = true;
    s++;
  }
  if (s >= e) return false;
  long long v = 0;
  for (; s < e; s++) {
    if (*s < '0' || *s > '9') return false;
    v = v * 10 + (*s - '0');
  }
  *out = neg ? -v : v;
  return true;
}

// Intern a kind given raw f/value text. `parse` maps value text -> the
// revived Python value. Returns kind index, or -2 on error.
int32_t intern_kind_text(std::unordered_map<std::string, int32_t>& cache,
                         PyObject* vocab, PyObject* kinds, PyObject* parse,
                         const Slice& f, const Slice& v) {
  std::string key_txt;
  key_txt.reserve((size_t)(f.n + v.n + 1));
  key_txt.append(f.p, (size_t)f.n);
  key_txt.push_back('\x00');
  key_txt.append(v.p, (size_t)v.n);
  auto it = cache.find(key_txt);
  if (it != cache.end()) return it->second;

  PyObject* f_py = PyObject_CallFunction(parse, "s#", f.p, f.n);
  if (!f_py) return -2;
  PyObject* v_py = PyObject_CallFunction(parse, "s#", v.p, v.n);
  if (!v_py) {
    Py_DECREF(f_py);
    return -2;
  }
  PyObject* cv = canon(v_py);
  Py_DECREF(v_py);
  if (!cv) {
    Py_DECREF(f_py);
    return -2;
  }
  PyObject* key = PyTuple_Pack(2, f_py, cv);
  Py_DECREF(f_py);
  Py_DECREF(cv);
  if (!key) return -2;
  PyObject* ki_obj = PyDict_GetItemWithError(vocab, key);  // borrowed
  int32_t ki;
  if (ki_obj) {
    ki = (int32_t)PyLong_AsLong(ki_obj);
  } else {
    if (PyErr_Occurred()) {
      Py_DECREF(key);
      return -2;
    }
    ki = (int32_t)PyList_GET_SIZE(kinds);
    PyObject* kio = PyLong_FromLong(ki);
    if (!kio || PyDict_SetItem(vocab, key, kio) < 0 ||
        PyList_Append(kinds, key) < 0) {
      Py_XDECREF(kio);
      Py_DECREF(key);
      return -2;
    }
    Py_DECREF(kio);
  }
  Py_DECREF(key);
  cache[key_txt] = ki;
  return ki;
}

// walk_jsonl(texts, vocab, kinds, parse) -> buffers tuple, or None when
// any line doesn't scan (caller falls back to the Op-object path).
PyObject* walk_jsonl(PyObject*, PyObject* args) {
  PyObject *texts, *vocab, *kinds, *parse;
  if (!PyArg_ParseTuple(args, "OOOO", &texts, &vocab, &kinds, &parse))
    return nullptr;
  if (!PyDict_Check(vocab) || !PyList_Check(kinds)) {
    PyErr_SetString(PyExc_TypeError, "vocab must be dict, kinds list");
    return nullptr;
  }

  std::vector<int8_t> code;
  std::vector<int32_t> proc, kind, oidx, link;
  std::vector<int8_t> okflag;
  std::vector<int64_t> rowlen;
  std::unordered_map<std::string, int32_t> kind_cache;

  PyObject* tfast = PySequence_Fast(texts, "expected text list");
  if (!tfast) return nullptr;
  Py_ssize_t nt = PySequence_Fast_GET_SIZE(tfast);
  rowlen.reserve(nt);

  struct Open {
    int64_t j;
    Slice f, v;
  };

  for (Py_ssize_t ti = 0; ti < nt; ti++) {
    PyObject* t = PySequence_Fast_GET_ITEM(tfast, ti);
    const char* buf;
    Py_ssize_t len;
    if (PyBytes_Check(t)) {
      buf = PyBytes_AS_STRING(t);
      len = PyBytes_GET_SIZE(t);
    } else if (PyUnicode_Check(t)) {
      buf = PyUnicode_AsUTF8AndSize(t, &len);
      if (!buf) {
        Py_DECREF(tfast);
        return nullptr;
      }
    } else {
      Py_DECREF(tfast);
      PyErr_SetString(PyExc_TypeError, "texts must be str or bytes");
      return nullptr;
    }

    int64_t rowstart = (int64_t)code.size();
    std::unordered_map<long long, Open> open;
    std::unordered_map<long long, int32_t> dense;
    const char* s = buf;
    const char* end = buf + len;
    long long pos = -1;

    while (s < end) {
      const char* nl = (const char*)memchr(s, '\n', (size_t)(end - s));
      const char* le = nl ? nl : end;
      const char* ls = s;
      s = nl ? nl + 1 : end;
      if (le > ls && le[-1] == '\r') le--;
      ls = skip_ws(ls, le);
      if (ls == le) continue;           // blank line
      pos++;

      // --- scan the line's object for the five relevant fields.
      if (*ls != '{') goto bail;
      ls++;
      Slice f_type, f_proc, f_f, f_value, f_index;
      {
        bool have_value = false;        // null value still counts as set
        while (true) {
          ls = skip_ws(ls, le);
          if (ls < le && *ls == '}') break;
          if (ls >= le || *ls != '"') goto bail;
          const char* ks = ls + 1;
          const char* ke = ks;
          while (ke < le && *ke != '"') {
            if (*ke == '\\') ke++;
            ke++;
          }
          if (ke >= le) goto bail;
          ls = skip_ws(ke + 1, le);
          if (ls >= le || *ls != ':') goto bail;
          ls = skip_ws(ls + 1, le);
          const char* ve = skip_value(ls, le);
          if (!ve) goto bail;
          Slice v{ls, (Py_ssize_t)(ve - ls)};
          Py_ssize_t kn = ke - ks;
          if (kn == 4 && memcmp(ks, "type", 4) == 0)
            f_type = v;
          else if (kn == 7 && memcmp(ks, "process", 7) == 0)
            f_proc = v;
          else if (kn == 1 && *ks == 'f')
            f_f = v;
          else if (kn == 5 && memcmp(ks, "value", 5) == 0) {
            f_value = v;
            have_value = true;
          } else if (kn == 5 && memcmp(ks, "index", 5) == 0)
            f_index = v;
          ls = skip_ws(ve, le);
          if (ls < le && *ls == ',') {
            ls++;
            continue;
          }
          if (ls < le && *ls == '}') break;
          goto bail;
        }
        if (!f_type.set() || !f_f.set() || !have_value) goto bail;
        if (!f_value.set()) goto bail;
      }

      {
        long long p;
        if (!f_proc.set() || !parse_int(f_proc, &p))
          continue;                     // non-int process: skip
        long long idx = pos;
        if (f_index.set() && !f_index.is("null") &&
            !parse_int(f_index, &idx))
          goto bail;

        if (f_type.is("\"invoke\"")) {
          int64_t j = (int64_t)code.size();
          auto r = dense.emplace(p, (int32_t)dense.size());
          open[p] = Open{j, f_f, f_value};
          code.push_back(LINE_INVOKE);
          proc.push_back(r.first->second);
          kind.push_back(-1);
          oidx.push_back((int32_t)idx);
          okflag.push_back(0);
          link.push_back(-1);
        } else if (f_type.is("\"ok\"") || f_type.is("\"info\"")) {
          bool is_ok = f_type.is("\"ok\"");
          auto it = open.find(p);
          if (it == open.end()) continue;
          Open o = it->second;
          open.erase(it);
          // ok completions propagate observations onto a null invoke
          // value (history.core.complete semantics); info ops don't.
          const Slice& vv =
              (is_ok && o.v.is("null")) ? f_value : o.v;
          int32_t ki = intern_kind_text(kind_cache, vocab, kinds, parse,
                                        o.f, vv);
          if (ki == -2) {
            Py_DECREF(tfast);
            return nullptr;
          }
          kind[o.j] = ki;
          if (is_ok) okflag[o.j] = 1;
          code.push_back(is_ok ? LINE_OK : LINE_INFO);
          proc.push_back(proc[o.j]);
          kind.push_back(-1);
          oidx.push_back((int32_t)idx);
          okflag.push_back(0);
          link.push_back(is_ok ? -1 : (int32_t)o.j);
        } else if (f_type.is("\"fail\"")) {
          auto it = open.find(p);
          if (it != open.end()) {
            code[it->second.j] = LINE_PAD;
            open.erase(it);
          }
        }
        // unknown types: ignore the line (walk() parity).
      }
    }

    // Crashed invocations: kind from the invoke's own value. Intern
    // in invocation (line) order, not unordered_map order — the kinds
    // vocabulary must be bit-identical to the Python oracle's
    // insertion order and reproducible across platforms.
    std::vector<const Open*> crashed;
    crashed.reserve(open.size());
    for (auto& kv : open) crashed.push_back(&kv.second);
    std::sort(crashed.begin(), crashed.end(),
              [](const Open* a, const Open* b) { return a->j < b->j; });
    for (const Open* o : crashed) {
      int32_t ki = intern_kind_text(kind_cache, vocab, kinds, parse,
                                    o->f, o->v);
      if (ki == -2) {
        Py_DECREF(tfast);
        return nullptr;
      }
      kind[o->j] = ki;
    }
    rowlen.push_back((int64_t)code.size() - rowstart);
  }
  Py_DECREF(tfast);

  return Py_BuildValue(
      "(y#y#y#y#y#y#y#)",
      (const char*)code.data(), (Py_ssize_t)(code.size() * sizeof(int8_t)),
      (const char*)proc.data(), (Py_ssize_t)(proc.size() * sizeof(int32_t)),
      (const char*)kind.data(), (Py_ssize_t)(kind.size() * sizeof(int32_t)),
      (const char*)oidx.data(), (Py_ssize_t)(oidx.size() * sizeof(int32_t)),
      (const char*)okflag.data(), (Py_ssize_t)(okflag.size() * sizeof(int8_t)),
      (const char*)link.data(), (Py_ssize_t)(link.size() * sizeof(int32_t)),
      (const char*)rowlen.data(),
      (Py_ssize_t)(rowlen.size() * sizeof(int64_t)));

bail:
  // A line the scanner can't place: the whole batch falls back to the
  // Op-object path (correctness over speed).
  Py_DECREF(tfast);
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"walk", walk, METH_VARARGS,
     "walk(histories, vocab, kinds) -> flat line buffers"},
    {"walk_jsonl", walk_jsonl, METH_VARARGS,
     "walk_jsonl(texts, vocab, kinds, parse) -> flat line buffers | None"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_jt_torch_ingest",
    "Native Op-list -> columnar ingest walk", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__jt_torch_ingest(void) {
  s_process = PyUnicode_InternFromString("process");
  s_type = PyUnicode_InternFromString("type");
  s_f = PyUnicode_InternFromString("f");
  s_value = PyUnicode_InternFromString("value");
  s_index = PyUnicode_InternFromString("index");
  if (!s_process || !s_type || !s_f || !s_value || !s_index) return nullptr;
  return PyModule_Create(&moduledef);
}
