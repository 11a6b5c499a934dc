// Native core of horovod_tpu_torch: the control-plane hot paths the
// reference implements in C++ (see SURVEY.md §2.1), as a CPython
// extension.  Counterpart: horovod_tpu/native/core.cpp, copied; the type
// names (horovod_tpu_torch.native._hvd_core.*) differ, dtype_bytes holds
// the port's ops/fusion.py _DTYPE_BYTES entry for entry, and
// StallTracker.pending_since reads a pending tensor's enqueue time (the
// clock of the port's negotiation abort, stall.py's overdue()).
// A host-side extension: no CUDA.  native/build.py compiles it with g++ at
// first use, into build/horovod_tpu_torch/native-<hash>/.
//
// Reference parity map:
//   plan_fusion_sigs -> horovod/common/controller.cc FuseResponses +
//                       fusion_buffer_manager.cc (bucketing up to
//                       HOROVOD_FUSION_THRESHOLD bytes)
//   ResponseCache    -> horovod/common/response_cache.cc (steady-state
//                       negotiation skip, LRU keyed by tensor signatures)
//   TimelineWriter   -> horovod/common/timeline.cc TimelineWriter (dedicated
//                       writer thread draining an event queue into Chrome
//                       trace JSON)
//   StallTracker     -> horovod/common/stall_inspector.cc (pending-tensor
//                       bookkeeping; warn/abort thresholds)
//
// The algorithms are parity-checked against the port's pure-Python
// planner, decision, writer and tracker (HOROVOD_TPU_NATIVE_CORE=0 selects
// those) and against the JAX package's core in
// tests/test_torch_native_core.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <list>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Sig extraction (mirror of horovod_tpu_torch.ops.fusion.EntrySig)
// ---------------------------------------------------------------------------

struct Sig {
  std::string name, op_type, reduce_op, dtype, wire_format;
  // negotiated DCN straggler tolerance ("strict"/"bounded"/"stale"):
  // mixed policies never fuse (mirrors EntrySig.tail_policy)
  std::string tail_policy;
  // canonicalized PartitionSpec fingerprint ("replicated" = no model-
  // axis sharding): differently-sharded entries reduce over different
  // axis sets, so mixed-spec entries never fuse (mirrors EntrySig.spec)
  std::string spec;
  std::vector<long long> shape;
  long long ps_id = 0;
  bool stacked = false;
  long long group_id = -1;
  // layer/topology key for overlapped dispatch: entries on different
  // layers never fuse (-1 = no layer identity; mirrors EntrySig.layer)
  long long layer = -1;
  bool has_prescale = false, has_postscale = false;
  double prescale = 1.0, postscale = 1.0;  // effective values (None -> 1.0)
  long long nbytes = 0;
};

// Mirror of fusion._DTYPE_BYTES: unknown dtypes return -1 and the caller
// raises (parity with the Python planner — a silent 4-byte guess
// mis-sizes buckets against the fusion threshold).
int dtype_bytes(const std::string &d) {
  if (d == "float64" || d == "int64" || d == "uint64" || d == "complex64")
    return 8;
  if (d == "float32" || d == "int32" || d == "uint32") return 4;
  if (d == "float16" || d == "bfloat16" || d == "int16" || d == "uint16")
    return 2;
  if (d == "int8" || d == "uint8" || d == "bool" ||
      d == "float8_e4m3fn" || d == "float8_e5m2" || d == "float8_e4m3" ||
      d == "float8_e3m4" || d == "float8_e4m3fnuz" ||
      d == "float8_e5m2fnuz")
    return 1;
  if (d == "complex128") return 16;
  return -1;
}

bool get_str_attr(PyObject *o, const char *attr, std::string *out) {
  PyObject *v = PyObject_GetAttrString(o, attr);
  if (!v) return false;
  if (!PyUnicode_Check(v)) {
    Py_DECREF(v);
    PyErr_Format(PyExc_TypeError, "sig attribute %s must be str", attr);
    return false;
  }
  Py_ssize_t len = 0;
  const char *s = PyUnicode_AsUTF8AndSize(v, &len);
  if (!s) {
    Py_DECREF(v);
    return false;
  }
  out->assign(s, static_cast<size_t>(len));
  Py_DECREF(v);
  return true;
}

bool get_ll_attr(PyObject *o, const char *attr, long long *out) {
  PyObject *v = PyObject_GetAttrString(o, attr);
  if (!v) return false;
  long long r = PyLong_AsLongLong(v);
  Py_DECREF(v);
  if (r == -1 && PyErr_Occurred()) return false;
  *out = r;
  return true;
}

bool get_bool_attr(PyObject *o, const char *attr, bool *out) {
  PyObject *v = PyObject_GetAttrString(o, attr);
  if (!v) return false;
  int r = PyObject_IsTrue(v);
  Py_DECREF(v);
  if (r < 0) return false;
  *out = r != 0;
  return true;
}

bool get_opt_double_attr(PyObject *o, const char *attr, bool *has,
                         double *out) {
  PyObject *v = PyObject_GetAttrString(o, attr);
  if (!v) return false;
  if (v == Py_None) {
    *has = false;
    *out = 1.0;
    Py_DECREF(v);
    return true;
  }
  double r = PyFloat_AsDouble(v);
  Py_DECREF(v);
  if (r == -1.0 && PyErr_Occurred()) return false;
  *has = true;
  *out = r;
  return true;
}

bool parse_sig(PyObject *o, Sig *s) {
  if (!get_str_attr(o, "name", &s->name)) return false;
  if (!get_str_attr(o, "op_type", &s->op_type)) return false;
  if (!get_str_attr(o, "reduce_op", &s->reduce_op)) return false;
  if (!get_str_attr(o, "dtype", &s->dtype)) return false;
  if (!get_str_attr(o, "wire_format", &s->wire_format)) return false;
  if (!get_str_attr(o, "tail_policy", &s->tail_policy)) return false;
  if (!get_str_attr(o, "spec", &s->spec)) return false;
  if (!get_ll_attr(o, "process_set_id", &s->ps_id)) return false;
  if (!get_bool_attr(o, "stacked", &s->stacked)) return false;
  if (!get_ll_attr(o, "group_id", &s->group_id)) return false;
  if (!get_ll_attr(o, "layer", &s->layer)) return false;
  if (!get_opt_double_attr(o, "prescale", &s->has_prescale, &s->prescale))
    return false;
  if (!get_opt_double_attr(o, "postscale", &s->has_postscale, &s->postscale))
    return false;
  PyObject *shape = PyObject_GetAttrString(o, "shape");
  if (!shape) return false;
  PyObject *seq = PySequence_Fast(shape, "sig.shape must be a sequence");
  Py_DECREF(shape);
  if (!seq) return false;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  long long numel = 1;
  s->shape.reserve(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i) {
    long long d = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(seq, i));
    if (d == -1 && PyErr_Occurred()) {
      Py_DECREF(seq);
      return false;
    }
    s->shape.push_back(d);
    numel *= d;
  }
  Py_DECREF(seq);
  int width = dtype_bytes(s->dtype);
  if (width < 0) {
    PyErr_Format(PyExc_ValueError,
                 "unknown dtype '%s' in fusion planning: add its element "
                 "width to dtype_bytes (core.cpp) and _DTYPE_BYTES "
                 "(fusion.py)",
                 s->dtype.c_str());
    return false;
  }
  s->nbytes = numel * width;
  return true;
}

bool parse_sigs(PyObject *sigs, std::vector<Sig> *out) {
  PyObject *seq = PySequence_Fast(sigs, "sigs must be a sequence");
  if (!seq) return false;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  out->resize(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i) {
    if (!parse_sig(PySequence_Fast_GET_ITEM(seq, i),
                   &(*out)[static_cast<size_t>(i)])) {
      Py_DECREF(seq);
      return false;
    }
  }
  Py_DECREF(seq);
  return true;
}

// ---------------------------------------------------------------------------
// Fusion planner (parity with fusion.plan_fusion)
// ---------------------------------------------------------------------------

// Bucket-compatibility key comparison: mirrors EntrySig.bucket_key() tuple
// ordering (op_type, reduce_op, dtype, process_set_id, stacked,
// prescale-or-1, postscale-or-1, wire_format, layer, tail_policy, spec).
int key_cmp(const Sig &a, const Sig &b) {
  int c = a.op_type.compare(b.op_type);
  if (c) return c;
  c = a.reduce_op.compare(b.reduce_op);
  if (c) return c;
  c = a.dtype.compare(b.dtype);
  if (c) return c;
  if (a.ps_id != b.ps_id) return a.ps_id < b.ps_id ? -1 : 1;
  if (a.stacked != b.stacked) return a.stacked < b.stacked ? -1 : 1;
  if (a.prescale != b.prescale) return a.prescale < b.prescale ? -1 : 1;
  if (a.postscale != b.postscale) return a.postscale < b.postscale ? -1 : 1;
  // mixed wire formats must never fuse: a bucket is ONE staged
  // collective, and a quantized staging cannot carry full-width members
  c = a.wire_format.compare(b.wire_format);
  if (c) return c;
  // buckets must never span layers: under overlapped dispatch a bucket
  // goes to the wire when its layer's backward step completes
  if (a.layer != b.layer) return a.layer < b.layer ? -1 : 1;
  // mixed tail policies must never fuse: a fused bucket runs ONE
  // deadline gate and one participation mask
  c = a.tail_policy.compare(b.tail_policy);
  if (c) return c;
  // mixed specs must never fuse: a bucket reduces over ONE axis set,
  // decided by its members' (shared) canonical PartitionSpec
  c = a.spec.compare(b.spec);
  if (c) return c;
  return 0;
}

std::vector<std::vector<long long>> plan(const std::vector<Sig> &sigs,
                                         long long threshold) {
  std::vector<size_t> order(sigs.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = i;
  // Deterministic total order: (bucket_key, group-contiguity, name,
  // submission index) — the invariant the reference's rank-0 negotiation
  // exists to provide.  Grouped sigs sort contiguously ahead of
  // ungrouped ones within a bucket key so a threshold flush can never
  // split a group (group_table.cc all-or-nothing), and groups order by
  // their MINIMUM MEMBER NAME — never by group_id, which is a
  // per-process counter (mirrors ops/fusion.py plan_fusion).  Two
  // groups can share a minimum member name (grouped submissions expand
  // to name.0/name.1, so two groups under one explicit name= collide);
  // the tie breaks on the group's full sorted member-name tuple so tied
  // groups stay contiguous instead of interleaving by bare name.
  // the sorted member tuple IS the ordering key: its first element is
  // the minimum member name, the rest break ties.  Identical tuples
  // (the same name= submitted twice in one cycle) order by first
  // submission index — the same cross-process contract the controller
  // uses to pair duplicate tokens (instance k with peer instance k).
  std::map<long long, std::vector<const std::string *>> group_names;
  std::map<long long, size_t> group_first;
  for (size_t i = 0; i < sigs.size(); ++i) {
    const Sig &s = sigs[i];
    if (s.group_id == -1) continue;
    group_names[s.group_id].push_back(&s.name);
    group_first.emplace(s.group_id, i);
  }
  for (auto &kv : group_names)
    std::sort(kv.second.begin(), kv.second.end(),
              [](const std::string *a, const std::string *b) {
                return *a < *b;
              });
  auto names_cmp = [&](long long gx, long long gy) {
    const auto &a = group_names[gx], &b = group_names[gy];
    for (size_t i = 0; i < a.size() && i < b.size(); ++i) {
      int c = a[i]->compare(*b[i]);
      if (c) return c;
    }
    if (a.size() != b.size()) return a.size() < b.size() ? -1 : 1;
    return 0;
  };
  std::stable_sort(order.begin(), order.end(), [&](size_t x, size_t y) {
    int c = key_cmp(sigs[x], sigs[y]);
    if (c) return c < 0;
    bool gx = sigs[x].group_id != -1, gy = sigs[y].group_id != -1;
    if (gx != gy) return gx;  // grouped first
    if (gx && sigs[x].group_id != sigs[y].group_id) {
      c = names_cmp(sigs[x].group_id, sigs[y].group_id);
      if (c) return c < 0;
      size_t fx = group_first[sigs[x].group_id];
      size_t fy = group_first[sigs[y].group_id];
      if (fx != fy) return fx < fy;
    }
    c = sigs[x].name.compare(sigs[y].name);
    if (c) return c < 0;
    return x < y;
  });

  std::vector<std::vector<long long>> buckets;
  std::vector<long long> cur;
  bool has_key = false;
  size_t key_idx = 0;  // index of a sig carrying the current bucket key
  long long cur_bytes = 0;
  long long cur_group = -1;

  auto flush = [&]() {
    if (!cur.empty()) buckets.push_back(std::move(cur));
    cur.clear();
    cur_bytes = 0;
  };

  for (size_t i : order) {
    const Sig &e = sigs[i];
    if (e.op_type != "allreduce") {
      flush();
      buckets.push_back({static_cast<long long>(i)});
      has_key = false;
      continue;
    }
    bool same_group =
        e.group_id != -1 && e.group_id == cur_group && !cur.empty();
    bool key_changed = !has_key || key_cmp(e, sigs[key_idx]) != 0;
    if (key_changed || (cur_bytes + e.nbytes > threshold && !same_group &&
                        !cur.empty())) {
      flush();
      has_key = true;
      key_idx = i;
    }
    cur.push_back(static_cast<long long>(i));
    cur_bytes += e.nbytes;
    cur_group = e.group_id;
  }
  flush();
  return buckets;
}

PyObject *plan_to_py(const std::vector<std::vector<long long>> &buckets) {
  PyObject *out = PyList_New(static_cast<Py_ssize_t>(buckets.size()));
  if (!out) return nullptr;
  for (size_t b = 0; b < buckets.size(); ++b) {
    PyObject *lst = PyList_New(static_cast<Py_ssize_t>(buckets[b].size()));
    if (!lst) {
      Py_DECREF(out);
      return nullptr;
    }
    for (size_t j = 0; j < buckets[b].size(); ++j) {
      PyObject *v = PyLong_FromLongLong(buckets[b][j]);
      if (!v) {
        Py_DECREF(lst);
        Py_DECREF(out);
        return nullptr;
      }
      PyList_SET_ITEM(lst, static_cast<Py_ssize_t>(j), v);
    }
    PyList_SET_ITEM(out, static_cast<Py_ssize_t>(b), lst);
  }
  return out;
}

PyObject *py_plan_fusion_sigs(PyObject *, PyObject *args) {
  PyObject *sigs_obj;
  long long threshold;
  if (!PyArg_ParseTuple(args, "OL", &sigs_obj, &threshold)) return nullptr;
  std::vector<Sig> sigs;
  if (!parse_sigs(sigs_obj, &sigs)) return nullptr;
  return plan_to_py(plan(sigs, threshold));
}

// Overlapped dispatch order of a fusion plan (mirror of
// fusion.plan_dispatch): descending layer first (the backward pass
// materializes layer L-1's gradients first), layer-less (-1) buckets
// last; ties keep plan order.  Returns (order, layers) tuples of ints.
PyObject *py_plan_dispatch_sigs(PyObject *, PyObject *args) {
  PyObject *sigs_obj, *buckets_obj;
  if (!PyArg_ParseTuple(args, "OO", &sigs_obj, &buckets_obj))
    return nullptr;
  std::vector<Sig> sigs;
  if (!parse_sigs(sigs_obj, &sigs)) return nullptr;
  PyObject *bseq = PySequence_Fast(buckets_obj,
                                   "buckets must be a sequence");
  if (!bseq) return nullptr;
  Py_ssize_t nb = PySequence_Fast_GET_SIZE(bseq);
  std::vector<long long> layers(static_cast<size_t>(nb));
  for (Py_ssize_t b = 0; b < nb; ++b) {
    PyObject *inner = PySequence_Fast(PySequence_Fast_GET_ITEM(bseq, b),
                                      "bucket must be a sequence");
    if (!inner) {
      Py_DECREF(bseq);
      return nullptr;
    }
    Py_ssize_t ni = PySequence_Fast_GET_SIZE(inner);
    if (ni == 0) {
      Py_DECREF(inner);
      Py_DECREF(bseq);
      PyErr_Format(PyExc_ValueError, "bucket %lld is empty",
                   static_cast<long long>(b));
      return nullptr;
    }
    for (Py_ssize_t j = 0; j < ni; ++j) {
      long long i = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(inner, j));
      if (i == -1 && PyErr_Occurred()) {
        Py_DECREF(inner);
        Py_DECREF(bseq);
        return nullptr;
      }
      if (i < 0 || i >= static_cast<long long>(sigs.size())) {
        Py_DECREF(inner);
        Py_DECREF(bseq);
        PyErr_Format(PyExc_ValueError,
                     "bucket %lld references sig %lld (have %lld sigs)",
                     static_cast<long long>(b), i,
                     static_cast<long long>(sigs.size()));
        return nullptr;
      }
      long long lay = sigs[static_cast<size_t>(i)].layer;
      if (j == 0) {
        layers[static_cast<size_t>(b)] = lay;
      } else if (lay != layers[static_cast<size_t>(b)]) {
        Py_DECREF(inner);
        Py_DECREF(bseq);
        PyErr_Format(PyExc_ValueError,
                     "bucket %lld spans layers %lld and %lld",
                     static_cast<long long>(b),
                     layers[static_cast<size_t>(b)], lay);
        return nullptr;
      }
    }
    Py_DECREF(inner);
  }
  Py_DECREF(bseq);
  std::vector<size_t> order(static_cast<size_t>(nb));
  for (size_t i = 0; i < order.size(); ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](size_t x, size_t y) {
    bool nx = layers[x] < 0, ny = layers[y] < 0;
    if (nx != ny) return ny;          // layered before layer-less
    if (!nx && layers[x] != layers[y]) return layers[x] > layers[y];
    return x < y;
  });
  PyObject *po = PyTuple_New(nb), *pl = PyTuple_New(nb);
  if (!po || !pl) {
    Py_XDECREF(po);
    Py_XDECREF(pl);
    return nullptr;
  }
  for (Py_ssize_t b = 0; b < nb; ++b) {
    PyTuple_SET_ITEM(
        po, b,
        PyLong_FromLongLong(
            static_cast<long long>(order[static_cast<size_t>(b)])));
    PyTuple_SET_ITEM(
        pl, b, PyLong_FromLongLong(layers[static_cast<size_t>(b)]));
  }
  return Py_BuildValue("(NN)", po, pl);
}

// ---------------------------------------------------------------------------
// Negotiation decision (horovod/common/controller.cc ComputeResponseList's
// readiness intersection, on canonical token strings).  Divergence analysis
// and caching stay in the Python controller; this is the per-round
// O(procs x tokens) multiset arithmetic.
// ---------------------------------------------------------------------------

// negotiate_decide(full: dict[int, list[str]], active: list[int])
//   -> (counts: dict[str, int], lagging: dict[str, list[int]],
//       deferred: int)
PyObject *py_negotiate_decide(PyObject *, PyObject *args) {
  PyObject *full_obj, *active_obj;
  if (!PyArg_ParseTuple(args, "OO", &full_obj, &active_obj)) return nullptr;
  if (!PyDict_Check(full_obj)) {
    PyErr_SetString(PyExc_TypeError, "full must be a dict");
    return nullptr;
  }
  std::vector<long long> active;
  {
    PyObject *seq = PySequence_Fast(active_obj, "active must be a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; ++i) {
      active.push_back(
          PyLong_AsLongLong(PySequence_Fast_GET_ITEM(seq, i)));
    }
    Py_DECREF(seq);
    if (PyErr_Occurred()) return nullptr;
  }
  // per-proc multiset counts over ALL procs in `full` (deferred counts
  // span every announcer, dispatch counts span only the active)
  std::unordered_map<long long,
                     std::unordered_map<std::string, long long>>
      counters;
  std::vector<std::string> order;  // first-seen order; sorted later
  std::unordered_map<std::string, bool> seen;
  PyObject *key, *val;
  Py_ssize_t pos = 0;
  while (PyDict_Next(full_obj, &pos, &key, &val)) {
    long long proc = PyLong_AsLongLong(key);
    if (PyErr_Occurred()) return nullptr;
    PyObject *seq = PySequence_Fast(val, "token lists must be sequences");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    auto &cnt = counters[proc];
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject *t = PySequence_Fast_GET_ITEM(seq, i);
      Py_ssize_t len = 0;
      const char *s = PyUnicode_AsUTF8AndSize(t, &len);
      if (!s) {
        Py_DECREF(seq);
        return nullptr;
      }
      std::string tok(s, static_cast<size_t>(len));
      cnt[tok] += 1;
      if (!seen[tok]) {
        seen[tok] = true;
        order.push_back(tok);
      }
    }
    Py_DECREF(seq);
  }
  std::sort(order.begin(), order.end());

  PyObject *counts = PyDict_New();
  PyObject *lagging = PyDict_New();
  long long deferred = 0;
  if (!counts || !lagging) {
    Py_XDECREF(counts);
    Py_XDECREF(lagging);
    return nullptr;
  }
  for (const std::string &tok : order) {
    long long k = -1, peak = 0, announce_peak = 0;
    for (long long p : active) {
      auto it = counters.find(p);
      long long c = 0;
      if (it != counters.end()) {
        auto jt = it->second.find(tok);
        if (jt != it->second.end()) c = jt->second;
      }
      k = (k < 0) ? c : std::min(k, c);
      peak = std::max(peak, c);
    }
    for (auto &pc : counters) {
      auto jt = pc.second.find(tok);
      if (jt != pc.second.end())
        announce_peak = std::max(announce_peak, jt->second);
    }
    if (k < 0) k = 0;
    deferred += announce_peak - k;
    PyObject *tk = PyUnicode_FromStringAndSize(
        tok.data(), static_cast<Py_ssize_t>(tok.size()));
    if (k > 0) {
      PyObject *kv = PyLong_FromLongLong(k);
      PyDict_SetItem(counts, tk, kv);
      Py_DECREF(kv);
    }
    if (peak > k) {
      PyObject *lag = PyList_New(0);
      for (long long p : active) {
        long long c = 0;
        auto it = counters.find(p);
        if (it != counters.end()) {
          auto jt = it->second.find(tok);
          if (jt != it->second.end()) c = jt->second;
        }
        if (c < peak) {
          PyObject *pv = PyLong_FromLongLong(p);
          PyList_Append(lag, pv);
          Py_DECREF(pv);
        }
      }
      PyDict_SetItem(lagging, tk, lag);
      Py_DECREF(lag);
    }
    Py_DECREF(tk);
  }
  return Py_BuildValue("(NNL)", counts, lagging, deferred);
}

// ---------------------------------------------------------------------------
// Response cache (LRU of fusion plans keyed by the cycle's signatures)
// ---------------------------------------------------------------------------

void append_ll(std::string *k, long long v) {
  char buf[32];
  int n = std::snprintf(buf, sizeof(buf), "%lld,", v);
  k->append(buf, static_cast<size_t>(n));
}

void append_str(std::string *k, const std::string &s) {
  append_ll(k, static_cast<long long>(s.size()));
  k->append(s);
}

std::string cache_key(const std::vector<Sig> &sigs) {
  std::string k;
  k.reserve(sigs.size() * 48);
  for (const Sig &s : sigs) {
    append_str(&k, s.name);
    append_str(&k, s.op_type);
    append_str(&k, s.reduce_op);
    append_str(&k, s.dtype);
    append_str(&k, s.wire_format);
    append_str(&k, s.tail_policy);
    append_str(&k, s.spec);
    append_ll(&k, s.ps_id);
    append_ll(&k, s.stacked ? 1 : 0);
    append_ll(&k, s.group_id);
    append_ll(&k, s.layer);
    char buf[64];
    int n = std::snprintf(buf, sizeof(buf), "%d:%.17g|%d:%.17g;",
                          s.has_prescale ? 1 : 0, s.prescale,
                          s.has_postscale ? 1 : 0, s.postscale);
    k.append(buf, static_cast<size_t>(n));
    for (long long d : s.shape) append_ll(&k, d);
    k.push_back('/');
  }
  return k;
}

using Plan = std::vector<std::vector<long long>>;

struct CacheImpl {
  long long capacity = 1024;
  // front = most recently used
  std::list<std::pair<std::string, Plan>> lru;
  std::unordered_map<std::string,
                     std::list<std::pair<std::string, Plan>>::iterator>
      map;
  long long hits = 0, misses = 0;
  std::mutex mu;
};

struct CacheObject {
  PyObject_HEAD CacheImpl *impl;
};

PyObject *cache_new(PyTypeObject *type, PyObject *, PyObject *) {
  CacheObject *self =
      reinterpret_cast<CacheObject *>(type->tp_alloc(type, 0));
  if (self) self->impl = new CacheImpl();
  return reinterpret_cast<PyObject *>(self);
}

int cache_init(PyObject *self_obj, PyObject *args, PyObject *kwds) {
  CacheObject *self = reinterpret_cast<CacheObject *>(self_obj);
  static const char *kwlist[] = {"capacity", nullptr};
  long long cap = 1024;
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "|L",
                                   const_cast<char **>(kwlist), &cap))
    return -1;
  self->impl->capacity = cap;
  return 0;
}

void cache_dealloc(PyObject *self_obj) {
  CacheObject *self = reinterpret_cast<CacheObject *>(self_obj);
  delete self->impl;
  Py_TYPE(self_obj)->tp_free(self_obj);
}

PyObject *cache_get(PyObject *self_obj, PyObject *args) {
  CacheObject *self = reinterpret_cast<CacheObject *>(self_obj);
  PyObject *sigs_obj;
  if (!PyArg_ParseTuple(args, "O", &sigs_obj)) return nullptr;
  if (self->impl->capacity <= 0) Py_RETURN_NONE;
  std::vector<Sig> sigs;
  if (!parse_sigs(sigs_obj, &sigs)) return nullptr;
  std::string key = cache_key(sigs);
  Plan plan_copy;
  bool found = false;
  {
    std::lock_guard<std::mutex> lk(self->impl->mu);
    auto it = self->impl->map.find(key);
    if (it == self->impl->map.end()) {
      self->impl->misses++;
    } else {
      self->impl->hits++;
      self->impl->lru.splice(self->impl->lru.begin(), self->impl->lru,
                             it->second);
      plan_copy = it->second->second;
      found = true;
    }
  }
  if (!found) Py_RETURN_NONE;
  return plan_to_py(plan_copy);
}

PyObject *cache_put(PyObject *self_obj, PyObject *args) {
  CacheObject *self = reinterpret_cast<CacheObject *>(self_obj);
  PyObject *sigs_obj, *plan_obj;
  if (!PyArg_ParseTuple(args, "OO", &sigs_obj, &plan_obj)) return nullptr;
  if (self->impl->capacity <= 0) Py_RETURN_NONE;
  std::vector<Sig> sigs;
  if (!parse_sigs(sigs_obj, &sigs)) return nullptr;
  Plan plan;
  PyObject *outer = PySequence_Fast(plan_obj, "plan must be a sequence");
  if (!outer) return nullptr;
  Py_ssize_t nb = PySequence_Fast_GET_SIZE(outer);
  plan.resize(static_cast<size_t>(nb));
  for (Py_ssize_t b = 0; b < nb; ++b) {
    PyObject *inner = PySequence_Fast(PySequence_Fast_GET_ITEM(outer, b),
                                      "bucket must be a sequence");
    if (!inner) {
      Py_DECREF(outer);
      return nullptr;
    }
    Py_ssize_t ni = PySequence_Fast_GET_SIZE(inner);
    for (Py_ssize_t j = 0; j < ni; ++j) {
      long long v = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(inner, j));
      if (v == -1 && PyErr_Occurred()) {
        Py_DECREF(inner);
        Py_DECREF(outer);
        return nullptr;
      }
      plan[static_cast<size_t>(b)].push_back(v);
    }
    Py_DECREF(inner);
  }
  Py_DECREF(outer);
  std::string key = cache_key(sigs);
  {
    std::lock_guard<std::mutex> lk(self->impl->mu);
    auto it = self->impl->map.find(key);
    if (it != self->impl->map.end()) {
      it->second->second = std::move(plan);
      self->impl->lru.splice(self->impl->lru.begin(), self->impl->lru,
                             it->second);
    } else {
      self->impl->lru.emplace_front(key, std::move(plan));
      self->impl->map[key] = self->impl->lru.begin();
      while (static_cast<long long>(self->impl->lru.size()) >
             self->impl->capacity) {
        self->impl->map.erase(self->impl->lru.back().first);
        self->impl->lru.pop_back();
      }
    }
  }
  Py_RETURN_NONE;
}

PyObject *cache_clear(PyObject *self_obj, PyObject *) {
  CacheObject *self = reinterpret_cast<CacheObject *>(self_obj);
  std::lock_guard<std::mutex> lk(self->impl->mu);
  self->impl->lru.clear();
  self->impl->map.clear();
  Py_RETURN_NONE;
}

PyObject *cache_stats(PyObject *self_obj, PyObject *) {
  CacheObject *self = reinterpret_cast<CacheObject *>(self_obj);
  std::lock_guard<std::mutex> lk(self->impl->mu);
  return Py_BuildValue("{s:L,s:L,s:L}", "hits", self->impl->hits, "misses",
                       self->impl->misses, "entries",
                       static_cast<long long>(self->impl->lru.size()));
}

PyMethodDef cache_methods[] = {
    {"get", cache_get, METH_VARARGS,
     "get(sigs) -> plan or None (LRU lookup by signature list)"},
    {"put", cache_put, METH_VARARGS, "put(sigs, plan)"},
    {"clear", cache_clear, METH_NOARGS, "clear()"},
    {"stats", cache_stats, METH_NOARGS, "stats() -> dict"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject CacheType = {
    PyVarObject_HEAD_INIT(nullptr, 0) "horovod_tpu_torch.native._hvd_core."
                                      "ResponseCache", /* tp_name */
    sizeof(CacheObject),                               /* tp_basicsize */
};

// ---------------------------------------------------------------------------
// Timeline writer (dedicated native thread draining an event queue)
// ---------------------------------------------------------------------------

struct WriterImpl {
  std::FILE *f = nullptr;
  std::thread th;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::string> q;
  bool stop = false;
  bool first = true;

  void loop() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv.wait(lk, [&] { return stop || !q.empty(); });
      while (!q.empty()) {
        std::string s = std::move(q.front());
        q.pop_front();
        lk.unlock();
        if (!first) std::fputs(",\n", f);
        first = false;
        std::fwrite(s.data(), 1, s.size(), f);
        lk.lock();
      }
      if (stop) return;
    }
  }

  bool open(const char *path) {
    f = std::fopen(path, "w");
    if (!f) return false;
    std::fputs("[\n", f);
    first = true;
    stop = false;
    th = std::thread([this] { loop(); });
    return true;
  }

  void close() {
    if (!f) return;
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    if (th.joinable()) th.join();
    std::fputs("\n]\n", f);
    std::fclose(f);
    f = nullptr;
  }
};

struct WriterObject {
  PyObject_HEAD WriterImpl *impl;
};

PyObject *writer_new(PyTypeObject *type, PyObject *, PyObject *) {
  WriterObject *self =
      reinterpret_cast<WriterObject *>(type->tp_alloc(type, 0));
  if (self) self->impl = new WriterImpl();
  return reinterpret_cast<PyObject *>(self);
}

int writer_init(PyObject *self_obj, PyObject *args, PyObject *) {
  WriterObject *self = reinterpret_cast<WriterObject *>(self_obj);
  const char *path;
  if (!PyArg_ParseTuple(args, "s", &path)) return -1;
  if (!self->impl->open(path)) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return -1;
  }
  return 0;
}

void writer_dealloc(PyObject *self_obj) {
  WriterObject *self = reinterpret_cast<WriterObject *>(self_obj);
  Py_BEGIN_ALLOW_THREADS self->impl->close();
  Py_END_ALLOW_THREADS delete self->impl;
  Py_TYPE(self_obj)->tp_free(self_obj);
}

PyObject *writer_write(PyObject *self_obj, PyObject *args) {
  WriterObject *self = reinterpret_cast<WriterObject *>(self_obj);
  const char *s;
  Py_ssize_t len;
  if (!PyArg_ParseTuple(args, "s#", &s, &len)) return nullptr;
  {
    std::lock_guard<std::mutex> lk(self->impl->mu);
    if (self->impl->f == nullptr || self->impl->stop) Py_RETURN_NONE;
    self->impl->q.emplace_back(s, static_cast<size_t>(len));
  }
  self->impl->cv.notify_one();
  Py_RETURN_NONE;
}

PyObject *writer_close(PyObject *self_obj, PyObject *) {
  WriterObject *self = reinterpret_cast<WriterObject *>(self_obj);
  Py_BEGIN_ALLOW_THREADS self->impl->close();
  Py_END_ALLOW_THREADS Py_RETURN_NONE;
}

PyMethodDef writer_methods[] = {
    {"write", writer_write, METH_VARARGS,
     "write(json_str): enqueue one trace event (non-blocking)"},
    {"close", writer_close, METH_NOARGS,
     "close(): drain the queue, write the JSON tail, close the file"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject WriterType = {
    PyVarObject_HEAD_INIT(nullptr, 0) "horovod_tpu_torch.native._hvd_core."
                                      "TimelineWriter", /* tp_name */
    sizeof(WriterObject),                               /* tp_basicsize */
};

// ---------------------------------------------------------------------------
// Stall tracker (pending-collective bookkeeping)
// ---------------------------------------------------------------------------

struct StallImpl {
  double check_time = 60.0, shutdown_time = 0.0;
  std::unordered_map<std::string, double> pending;
  std::unordered_map<std::string, double> warned;
  std::mutex mu;
};

struct StallObject {
  PyObject_HEAD StallImpl *impl;
};

PyObject *stall_new(PyTypeObject *type, PyObject *, PyObject *) {
  StallObject *self =
      reinterpret_cast<StallObject *>(type->tp_alloc(type, 0));
  if (self) self->impl = new StallImpl();
  return reinterpret_cast<PyObject *>(self);
}

int stall_init(PyObject *self_obj, PyObject *args, PyObject *kwds) {
  StallObject *self = reinterpret_cast<StallObject *>(self_obj);
  static const char *kwlist[] = {"check_time", "shutdown_time", nullptr};
  double check = 60.0, shut = 0.0;
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "|dd",
                                   const_cast<char **>(kwlist), &check,
                                   &shut))
    return -1;
  self->impl->check_time = check;
  self->impl->shutdown_time = shut;
  return 0;
}

void stall_dealloc(PyObject *self_obj) {
  StallObject *self = reinterpret_cast<StallObject *>(self_obj);
  delete self->impl;
  Py_TYPE(self_obj)->tp_free(self_obj);
}

PyObject *stall_enqueue(PyObject *self_obj, PyObject *args) {
  StallObject *self = reinterpret_cast<StallObject *>(self_obj);
  const char *name;
  double t;
  if (!PyArg_ParseTuple(args, "sd", &name, &t)) return nullptr;
  std::lock_guard<std::mutex> lk(self->impl->mu);
  self->impl->pending.emplace(name, t);  // keep earliest, like setdefault
  Py_RETURN_NONE;
}

PyObject *stall_complete(PyObject *self_obj, PyObject *args) {
  StallObject *self = reinterpret_cast<StallObject *>(self_obj);
  const char *name;
  if (!PyArg_ParseTuple(args, "s", &name)) return nullptr;
  std::lock_guard<std::mutex> lk(self->impl->mu);
  self->impl->pending.erase(name);
  self->impl->warned.erase(name);
  Py_RETURN_NONE;
}

// check(now) -> (newly_stalled: list[(name, age)], shutdown: (name, age)|None)
PyObject *stall_check(PyObject *self_obj, PyObject *args) {
  StallObject *self = reinterpret_cast<StallObject *>(self_obj);
  double now;
  if (!PyArg_ParseTuple(args, "d", &now)) return nullptr;
  std::vector<std::pair<std::string, double>> stalled;
  std::pair<std::string, double> shutdown;
  bool has_shutdown = false;
  {
    std::lock_guard<std::mutex> lk(self->impl->mu);
    for (const auto &kv : self->impl->pending) {
      double age = now - kv.second;
      if (age > self->impl->check_time &&
          !self->impl->warned.count(kv.first)) {
        stalled.emplace_back(kv.first, age);
        self->impl->warned[kv.first] = now;
      }
      if (self->impl->shutdown_time > 0 &&
          age > self->impl->shutdown_time && !has_shutdown) {
        shutdown = {kv.first, age};
        has_shutdown = true;
      }
    }
  }
  // Match the Python dict-iteration order contract loosely: sort for
  // deterministic warning text.
  std::sort(stalled.begin(), stalled.end());
  PyObject *lst = PyList_New(static_cast<Py_ssize_t>(stalled.size()));
  if (!lst) return nullptr;
  for (size_t i = 0; i < stalled.size(); ++i) {
    PyObject *t =
        Py_BuildValue("(sd)", stalled[i].first.c_str(), stalled[i].second);
    if (!t) {
      Py_DECREF(lst);
      return nullptr;
    }
    PyList_SET_ITEM(lst, static_cast<Py_ssize_t>(i), t);
  }
  PyObject *shut =
      has_shutdown
          ? Py_BuildValue("(sd)", shutdown.first.c_str(), shutdown.second)
          : Py_NewRef(Py_None);
  if (!shut) {
    Py_DECREF(lst);
    return nullptr;
  }
  PyObject *out = PyTuple_Pack(2, lst, shut);
  Py_DECREF(lst);
  Py_DECREF(shut);
  return out;
}

PyObject *stall_pending_count(PyObject *self_obj, PyObject *) {
  StallObject *self = reinterpret_cast<StallObject *>(self_obj);
  std::lock_guard<std::mutex> lk(self->impl->mu);
  return PyLong_FromSize_t(self->impl->pending.size());
}

// pending_since(name) -> the time record_enqueue noted, or None
PyObject *stall_pending_since(PyObject *self_obj, PyObject *args) {
  StallObject *self = reinterpret_cast<StallObject *>(self_obj);
  const char *name;
  if (!PyArg_ParseTuple(args, "s", &name)) return nullptr;
  std::lock_guard<std::mutex> lk(self->impl->mu);
  auto it = self->impl->pending.find(name);
  if (it == self->impl->pending.end()) Py_RETURN_NONE;
  return PyFloat_FromDouble(it->second);
}

PyMethodDef stall_methods[] = {
    {"record_enqueue", stall_enqueue, METH_VARARGS,
     "record_enqueue(name, t)"},
    {"record_complete", stall_complete, METH_VARARGS,
     "record_complete(name)"},
    {"check", stall_check, METH_VARARGS,
     "check(now) -> (newly_stalled, shutdown_offender_or_None)"},
    {"pending_count", stall_pending_count, METH_NOARGS, "pending_count()"},
    {"pending_since", stall_pending_since, METH_VARARGS,
     "pending_since(name) -> enqueue time or None"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject StallType = {
    PyVarObject_HEAD_INIT(nullptr, 0) "horovod_tpu_torch.native._hvd_core."
                                      "StallTracker", /* tp_name */
    sizeof(StallObject),                              /* tp_basicsize */
};

// ---------------------------------------------------------------------------
// Module
// ---------------------------------------------------------------------------

PyMethodDef module_methods[] = {
    {"plan_fusion_sigs", py_plan_fusion_sigs, METH_VARARGS,
     "plan_fusion_sigs(sigs, threshold_bytes) -> list[list[int]]\n"
     "Deterministic fused-bucket planner (parity with "
     "horovod_tpu_torch.ops.fusion.plan_fusion)."},
    {"plan_dispatch_sigs", py_plan_dispatch_sigs, METH_VARARGS,
     "plan_dispatch_sigs(sigs, buckets) -> (order, layers)\n"
     "Overlapped dispatch order of a fusion plan (parity with "
     "horovod_tpu_torch.ops.fusion.plan_dispatch)."},
    {"negotiate_decide", py_negotiate_decide, METH_VARARGS,
     "negotiate_decide(full, active) -> (counts, lagging, deferred)\n"
     "Readiness-intersection decision over announced token multisets "
     "(parity with ops.controller.Controller._decide's count loop; "
     "reference: controller.cc ComputeResponseList)."},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT,
    "_hvd_core",
    "Native control-plane core for horovod_tpu_torch (fusion planner, "
    "response cache, timeline writer, stall tracker).",
    -1,
    module_methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__hvd_core(void) {
  CacheType.tp_flags = Py_TPFLAGS_DEFAULT;
  CacheType.tp_new = cache_new;
  CacheType.tp_init = cache_init;
  CacheType.tp_dealloc = cache_dealloc;
  CacheType.tp_methods = cache_methods;
  CacheType.tp_doc = "LRU response cache keyed by collective signatures";
  if (PyType_Ready(&CacheType) < 0) return nullptr;

  WriterType.tp_flags = Py_TPFLAGS_DEFAULT;
  WriterType.tp_new = writer_new;
  WriterType.tp_init = writer_init;
  WriterType.tp_dealloc = writer_dealloc;
  WriterType.tp_methods = writer_methods;
  WriterType.tp_doc = "Chrome-trace writer with a dedicated native thread";
  if (PyType_Ready(&WriterType) < 0) return nullptr;

  StallType.tp_flags = Py_TPFLAGS_DEFAULT;
  StallType.tp_new = stall_new;
  StallType.tp_init = stall_init;
  StallType.tp_dealloc = stall_dealloc;
  StallType.tp_methods = stall_methods;
  StallType.tp_doc = "Pending-collective stall bookkeeping";
  if (PyType_Ready(&StallType) < 0) return nullptr;

  PyObject *m = PyModule_Create(&moduledef);
  if (!m) return nullptr;
  Py_INCREF(&CacheType);
  PyModule_AddObject(m, "ResponseCache",
                     reinterpret_cast<PyObject *>(&CacheType));
  Py_INCREF(&WriterType);
  PyModule_AddObject(m, "TimelineWriter",
                     reinterpret_cast<PyObject *>(&WriterType));
  Py_INCREF(&StallType);
  PyModule_AddObject(m, "StallTracker",
                     reinterpret_cast<PyObject *>(&StallType));
  return m;
}
