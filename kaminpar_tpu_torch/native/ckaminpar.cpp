// C ABI shim of the PyTorch/CUDA port (own copy of
// kaminpar_tpu/native/ckaminpar.cpp; kaminpar-shm/ckaminpar.cc analog).
//
// The engine is Python and PyTorch, so the C surface of
// include/ckaminpar_tpu.h embeds a CPython interpreter (one per process,
// lazily) and calls kaminpar_tpu_torch.capi.compute_from_pointers, which
// wraps the caller's raw CSR buffers as numpy arrays without copying and
// runs the partitioner on the card (KAMINPAR_TPU_PLATFORM=cpu: the CPU).
// The interpreter is initialized in the caller's thread and the GIL is
// released at once, so a call from any other C thread takes it with
// PyGILState_Ensure; torch creates its CUDA context in the first thread
// that computes.
//
// Build (see kaminpar_tpu_torch/native/build_capi.py):
//   python -m kaminpar_tpu_torch.native.build_capi  ->
//   kaminpar_tpu_torch/_build/libckaminpar_tpu_torch.so

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>

extern "C" {

struct kmp_partitioner {
  std::string preset;
  int seed;
  std::string last_error;
};

static bool ensure_python() {
  if (Py_IsInitialized()) return true;
  Py_InitializeEx(0);
  if (!Py_IsInitialized()) return false;
  // release the GIL acquired by initialization so OTHER threads'
  // PyGILState_Ensure in kmp_compute_partition can take it (the header
  // documents GIL-serialized multi-threaded use)
  PyEval_SaveThread();
  return true;
}

kmp_partitioner *kmp_create(const char *preset, int seed) {
  if (!ensure_python()) return nullptr;
  auto *p = new kmp_partitioner();
  p->preset = preset ? preset : "default";
  p->seed = seed;
  return p;
}

void kmp_free(kmp_partitioner *p) { delete p; }

const char *kmp_last_error(kmp_partitioner *p) {
  return p ? p->last_error.c_str() : "null partitioner";
}

int64_t kmp_compute_partition(kmp_partitioner *p, int64_t n,
                              const int64_t *xadj, const int32_t *adjncy,
                              const int32_t *vwgt, const int32_t *adjwgt,
                              int32_t k, double epsilon, int32_t *out) {
  if (!p) return -1;
  p->last_error.clear();
  if (n < 0 || !xadj || (!adjncy && xadj[n] > 0) || !out || k <= 0) {
    p->last_error = "invalid arguments";
    return -1;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  int64_t result = -1;
  PyObject *mod = nullptr, *ret = nullptr;
  mod = PyImport_ImportModule("kaminpar_tpu_torch.capi");
  if (!mod) goto fail;
  // pointers cross the ABI as integers; the Python side wraps them with
  // numpy without copying (np.ctypeslib.as_array)
  ret = PyObject_CallMethod(
      mod, "compute_from_pointers", "LLLLLLidLs", (long long)n,
      (long long)(intptr_t)xadj, (long long)(intptr_t)adjncy,
      (long long)(intptr_t)vwgt, (long long)(intptr_t)adjwgt,
      (long long)(intptr_t)out, (int)k, epsilon, (long long)p->seed,
      p->preset.c_str());
  if (!ret) goto fail;
  result = PyLong_AsLongLong(ret);
  if (PyErr_Occurred()) goto fail;
  Py_DECREF(ret);
  Py_DECREF(mod);
  PyGILState_Release(gil);
  return result;

fail:
  if (PyErr_Occurred()) {
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    PyObject *s = value ? PyObject_Str(value) : nullptr;
    const char *msg = s ? PyUnicode_AsUTF8(s) : "unknown python error";
    p->last_error = msg ? msg : "unknown python error";
    Py_XDECREF(s);
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
  } else {
    p->last_error = "unknown error";
  }
  Py_XDECREF(ret);
  Py_XDECREF(mod);
  PyGILState_Release(gil);
  return -1;
}

}  // extern "C"
