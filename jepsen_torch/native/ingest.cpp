// Op-list -> columnar ingest walk (CPython extension).
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

PyMethodDef methods[] = {
    {"walk", walk, METH_VARARGS,
     "walk(histories, vocab, kinds) -> flat line buffers"},
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
