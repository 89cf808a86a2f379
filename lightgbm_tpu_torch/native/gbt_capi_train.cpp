// Training C ABI — the analogue of the reference's training c_api surface
// (include/LightGBM/c_api.h: LGBM_DatasetCreateFromMat, LGBM_BoosterCreate,
// LGBM_BoosterUpdateOneIter, LGBM_BoosterSaveModel, ...).
//
// Architecture note: the reference's c_api.cpp is a thin C shim over its C++
// GBDT runtime.  Here the training runtime is the PyTorch engine, so the C
// shim delegates into it through CPython embedding: handles are Python
// objects, every entry point bridges via
// lightgbm_tpu_torch.native.capi_bridge.
// A standalone C program gets a working training ABI (the interpreter is
// bootstrapped on first use); in-process (ctypes) callers share the live
// interpreter.  The serving-side functions (GBTN_Predict & co in
// gbt_native.cpp) stay pure C++ with no Python dependency.
#include <Python.h>

#include <cstring>
#include <string>

namespace {

thread_local std::string g_last_error;

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  PyErr_NormalizeException(&type, &value, &trace);
  g_last_error = "unknown python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) g_last_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
}

// Bootstraps the interpreter for standalone C callers; no-op in-process.
bool ensure_python() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    if (!Py_IsInitialized()) {
      g_last_error = "failed to initialize the Python runtime";
      return false;
    }
    // release the GIL acquired by initialization so OTHER caller threads
    // can enter through PyGILState_Ensure (multithreaded standalone use)
    PyEval_SaveThread();
  }
  return true;
}

// Calls lightgbm_tpu_torch.native.capi_bridge.<fn>(*args).  Returns a new
// reference, or nullptr with g_last_error set.
PyObject* call_bridge(const char* fn, PyObject* args) {
  if (args == nullptr) {   // failed Py_BuildValue / memoryview construction
    set_error_from_python();
    return nullptr;
  }
  PyObject* mod = PyImport_ImportModule("lightgbm_tpu_torch.native.capi_bridge");
  if (mod == nullptr) {
    set_error_from_python();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(mod, fn);
  Py_DECREF(mod);
  if (f == nullptr) {
    set_error_from_python();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* out = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (out == nullptr) set_error_from_python();
  return out;
}

struct Gil {
  PyGILState_STATE state;
  Gil() : state(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state); }
};

// ------------------------------------------------------------------ helpers
// The bridge functions return small typed results; these adapters collapse
// the "call, convert, decref, error-check" pattern.  All must be called with
// the GIL held.

PyObject* none_incref() {
  Py_INCREF(Py_None);
  return Py_None;
}

// Borrowed handle -> object for Py_BuildValue "O" (which increfs).
PyObject* handle_or_none(void* h) {
  return h == nullptr ? Py_None : static_cast<PyObject*>(h);
}

PyObject* mv_read(const void* data, Py_ssize_t bytes) {
  if (data == nullptr) return none_incref();
  return PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<void*>(data)), bytes, PyBUF_READ);
}

PyObject* mv_write(void* data, Py_ssize_t bytes) {
  return PyMemoryView_FromMemory(reinterpret_cast<char*>(data), bytes,
                                 PyBUF_WRITE);
}

// Bridge call whose result is discarded (success/failure only).
int bridge_ok(const char* fn, PyObject* args) {
  PyObject* r = call_bridge(fn, args);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

// Bridge call returning a new handle into *out.
int bridge_handle(const char* fn, PyObject* args, void** out) {
  PyObject* r = call_bridge(fn, args);
  if (r == nullptr) return -1;
  *out = r;
  return 0;
}

int bridge_ll(const char* fn, PyObject* args, long long* out) {
  PyObject* r = call_bridge(fn, args);
  if (r == nullptr) return -1;
  *out = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

int bridge_int(const char* fn, PyObject* args, int* out) {
  long long v = 0;
  if (bridge_ll(fn, args, &v) != 0) return -1;
  *out = static_cast<int>(v);
  return 0;
}

int bridge_double(const char* fn, PyObject* args, double* out) {
  PyObject* r = call_bridge(fn, args);
  if (r == nullptr) return -1;
  *out = PyFloat_AsDouble(r);
  Py_DECREF(r);
  return 0;
}

// Bridge call returning str; copied into a caller buffer with the
// reference's SaveModelToString convention: *out_len = needed size
// including NUL; the copy happens only when buffer_len suffices.
int bridge_string(const char* fn, PyObject* args, long long buffer_len,
                  long long* out_len, char* out_str) {
  PyObject* r = call_bridge(fn, args);
  if (r == nullptr) return -1;
  Py_ssize_t size = 0;
  const char* c = PyUnicode_AsUTF8AndSize(r, &size);
  if (c == nullptr) {
    set_error_from_python();
    Py_DECREF(r);
    return -1;
  }
  if (out_len != nullptr) *out_len = static_cast<long long>(size) + 1;
  if (out_str != nullptr && buffer_len >= size + 1) {
    std::memcpy(out_str, c, size + 1);
  }
  Py_DECREF(r);
  return 0;
}

// Bridge call returning list[str]; strings copied into caller-allocated
// out_strs[i] buffers of buffer_len bytes each (LGBM_BoosterGetEvalNames
// convention), *out_n = element count.  A name that does not fit is an
// ERROR (g_last_error reports the required size) — never a silent
// truncation; pass out_strs == null to probe only the count.
int bridge_string_list(const char* fn, PyObject* args, char** out_strs,
                       int buffer_len, int* out_n) {
  PyObject* r = call_bridge(fn, args);
  if (r == nullptr) return -1;
  if (!PyList_Check(r)) {
    g_last_error = "bridge did not return a list";
    Py_DECREF(r);
    return -1;
  }
  Py_ssize_t n = PyList_Size(r);
  if (out_n != nullptr) *out_n = static_cast<int>(n);
  if (out_strs != nullptr) {
    if (buffer_len <= 0) {
      g_last_error = "string buffer_len must be positive";
      Py_DECREF(r);
      return -1;
    }
    for (Py_ssize_t i = 0; i < n; ++i) {
      Py_ssize_t size = 0;
      const char* c = PyUnicode_AsUTF8AndSize(PyList_GetItem(r, i), &size);
      if (c == nullptr) {
        set_error_from_python();
        Py_DECREF(r);
        return -1;
      }
      if (size + 1 > buffer_len) {
        g_last_error = "string buffer too small: need " +
                       std::to_string(size + 1) + " bytes, have " +
                       std::to_string(buffer_len);
        Py_DECREF(r);
        return -1;
      }
      std::memcpy(out_strs[i], c, size + 1);
    }
  }
  Py_DECREF(r);
  return 0;
}

// Bridge call returning (address, length[, dtype]) of an array cached on
// the handle; copies length*elem_size bytes into out (when out != null).
int bridge_buffer_copy(const char* fn, PyObject* args, void* out,
                       size_t elem_size, long long* out_len,
                       int* out_type) {
  PyObject* r = call_bridge(fn, args);
  if (r == nullptr) return -1;
  if (!PyTuple_Check(r) || PyTuple_Size(r) < 2) {
    g_last_error = "bridge did not return (addr, len) tuple";
    Py_DECREF(r);
    return -1;
  }
  long long addr = PyLong_AsLongLong(PyTuple_GetItem(r, 0));
  long long len = PyLong_AsLongLong(PyTuple_GetItem(r, 1));
  if (out_type != nullptr && PyTuple_Size(r) >= 3) {
    *out_type = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 2)));
  }
  if (out_len != nullptr) *out_len = len;
  if (out != nullptr && addr != 0 && len > 0) {
    std::memcpy(out, reinterpret_cast<const void*>(addr), len * elem_size);
  }
  Py_DECREF(r);
  return 0;
}

}  // namespace

extern "C" {

const char* GBTN_GetLastError() { return g_last_error.c_str(); }

// data: row-major [nrow, ncol] f64; label: [nrow] f32 or null; reference:
// existing dataset handle whose bin mappers align the new data (validation
// sets — LGBM_DatasetCreateFromMat's reference param), or null.
// params: space-separated key=value pairs (reference c_api convention).
// On success *out is a dataset handle; returns 0, else -1.
int GBTN_DatasetCreateFromMat(const double* data, long long nrow, int ncol,
                              const char* params, const float* label,
                              void* reference, void** out) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* mv_data = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<double*>(data)),
      static_cast<Py_ssize_t>(nrow) * ncol * sizeof(double), PyBUF_READ);
  PyObject* mv_label =
      label == nullptr
          ? (Py_INCREF(Py_None), Py_None)
          : PyMemoryView_FromMemory(
                reinterpret_cast<char*>(const_cast<float*>(label)),
                static_cast<Py_ssize_t>(nrow) * sizeof(float), PyBUF_READ);
  PyObject* args = Py_BuildValue("(OLisOO)", mv_data, nrow, ncol,
                                 params == nullptr ? "" : params, mv_label,
                                 handle_or_none(reference));
  Py_XDECREF(mv_data);
  Py_XDECREF(mv_label);
  PyObject* ds = call_bridge("dataset_from_mat", args);
  if (ds == nullptr) return -1;
  *out = ds;  // owned reference == handle
  return 0;
}

int GBTN_DatasetFree(void* handle) {
  if (!Py_IsInitialized() || handle == nullptr) return 0;
  Gil gil;
  Py_DECREF(static_cast<PyObject*>(handle));
  return 0;
}

int GBTN_BoosterCreate(void* dataset, const char* params, void** out) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(Os)", static_cast<PyObject*>(dataset),
      params == nullptr ? "" : params);
  PyObject* bst = call_bridge("booster_create", args);
  if (bst == nullptr) return -1;
  *out = bst;
  return 0;
}

// *is_finished = 1 when no further splits are possible (reference
// LGBM_BoosterUpdateOneIter contract).
int GBTN_BoosterUpdateOneIter(void* booster, int* is_finished) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* args = Py_BuildValue("(O)", static_cast<PyObject*>(booster));
  PyObject* r = call_bridge("booster_update", args);
  if (r == nullptr) return -1;
  if (is_finished != nullptr) *is_finished = PyObject_IsTrue(r) ? 1 : 0;
  Py_DECREF(r);
  return 0;
}

int GBTN_BoosterSaveModel(void* booster, int num_iteration,
                          const char* filename) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* args = Py_BuildValue("(Ois)", static_cast<PyObject*>(booster),
                                 num_iteration, filename);
  PyObject* r = call_bridge("booster_save", args);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

// out must hold nrow * num_class doubles (transformed predictions).
int GBTN_BoosterPredictForMat(void* booster, const double* data,
                              long long nrow, int ncol, double* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* mv_in = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<double*>(data)),
      static_cast<Py_ssize_t>(nrow) * ncol * sizeof(double), PyBUF_READ);
  PyObject* r = nullptr;
  {
    PyObject* num_class =
        call_bridge("booster_num_class",
                    Py_BuildValue("(O)", static_cast<PyObject*>(booster)));
    if (num_class == nullptr) {
      Py_XDECREF(mv_in);
      return -1;
    }
    long k = PyLong_AsLong(num_class);
    Py_DECREF(num_class);
    PyObject* mv_out = PyMemoryView_FromMemory(
        reinterpret_cast<char*>(out),
        static_cast<Py_ssize_t>(nrow) * k * sizeof(double), PyBUF_WRITE);
    PyObject* args = Py_BuildValue("(OOLiO)",
                                   static_cast<PyObject*>(booster), mv_in,
                                   nrow, ncol, mv_out);
    Py_XDECREF(mv_out);
    r = call_bridge("booster_predict_into", args);
  }
  Py_XDECREF(mv_in);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int GBTN_BoosterGetNumClass(void* booster, int* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* r = call_bridge(
      "booster_num_class",
      Py_BuildValue("(O)", static_cast<PyObject*>(booster)));
  if (r == nullptr) return -1;
  *out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int GBTN_BoosterFree(void* handle) {
  if (!Py_IsInitialized() || handle == nullptr) return 0;
  Gil gil;
  Py_DECREF(static_cast<PyObject*>(handle));
  return 0;
}

// ------------------------------------------------------ dataset surface
// (LGBM_Dataset* analogues, c_api.h:37-244)

int GBTN_DatasetCreateFromFile(const char* filename, const char* params,
                               void* reference, void** out) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_handle(
      "dataset_from_file",
      Py_BuildValue("(ssO)", filename, params == nullptr ? "" : params,
                    handle_or_none(reference)),
      out);
}

int GBTN_DatasetCreateFromCSR(const int* indptr, long long nindptr,
                              const int* indices, const double* data,
                              long long nelem, long long ncol,
                              const char* params, void* reference,
                              void** out) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* mv_p = mv_read(indptr, nindptr * sizeof(int));
  PyObject* mv_i = mv_read(indices, nelem * sizeof(int));
  PyObject* mv_d = mv_read(data, nelem * sizeof(double));
  PyObject* args = Py_BuildValue(
      "(OLOOLLsO)", mv_p, nindptr, mv_i, mv_d, nelem, ncol,
      params == nullptr ? "" : params, handle_or_none(reference));
  Py_XDECREF(mv_p);
  Py_XDECREF(mv_i);
  Py_XDECREF(mv_d);
  return bridge_handle("dataset_from_csr", args, out);
}

int GBTN_DatasetCreateFromCSC(const int* colptr, long long ncolptr,
                              const int* indices, const double* data,
                              long long nelem, long long nrow,
                              const char* params, void* reference,
                              void** out) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* mv_p = mv_read(colptr, ncolptr * sizeof(int));
  PyObject* mv_i = mv_read(indices, nelem * sizeof(int));
  PyObject* mv_d = mv_read(data, nelem * sizeof(double));
  PyObject* args = Py_BuildValue(
      "(OLOOLLsO)", mv_p, ncolptr, mv_i, mv_d, nelem, nrow,
      params == nullptr ? "" : params, handle_or_none(reference));
  Py_XDECREF(mv_p);
  Py_XDECREF(mv_i);
  Py_XDECREF(mv_d);
  return bridge_handle("dataset_from_csc", args, out);
}

// Streaming construction: preallocate [nrow, ncol], fill via PushRows
// (LGBM_DatasetCreateFromSampledColumn + LGBM_DatasetPushRows flow).
int GBTN_DatasetCreateEmpty(long long nrow, int ncol, const char* params,
                            void* reference, void** out) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_handle(
      "dataset_empty",
      Py_BuildValue("(LisO)", nrow, ncol, params == nullptr ? "" : params,
                    handle_or_none(reference)),
      out);
}

int GBTN_DatasetPushRows(void* dataset, const double* data, long long nrow,
                         int ncol, long long start_row) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* mv = mv_read(data, nrow * ncol * sizeof(double));
  PyObject* args = Py_BuildValue("(OOLiL)", handle_or_none(dataset), mv,
                                 nrow, ncol, start_row);
  Py_XDECREF(mv);
  return bridge_ok("dataset_push_rows", args);
}

int GBTN_DatasetPushRowsByCSR(void* dataset, const int* indptr,
                              long long nindptr, const int* indices,
                              const double* data, long long nelem,
                              long long ncol, long long start_row) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* mv_p = mv_read(indptr, nindptr * sizeof(int));
  PyObject* mv_i = mv_read(indices, nelem * sizeof(int));
  PyObject* mv_d = mv_read(data, nelem * sizeof(double));
  PyObject* args = Py_BuildValue("(OOLOOLLL)", handle_or_none(dataset),
                                 mv_p, nindptr, mv_i, mv_d, nelem, ncol,
                                 start_row);
  Py_XDECREF(mv_p);
  Py_XDECREF(mv_i);
  Py_XDECREF(mv_d);
  return bridge_ok("dataset_push_rows_csr", args);
}

// dtype codes follow the reference c_api: 0=f32, 1=f64, 2=i32.
int GBTN_DatasetSetField(void* dataset, const char* name, const void* data,
                         long long num_el, int dtype) {
  if (!ensure_python()) return -1;
  Gil gil;
  size_t elem = dtype == 1 ? sizeof(double)
                           : dtype == 2 ? sizeof(int) : sizeof(float);
  PyObject* mv = mv_read(data, num_el * elem);
  PyObject* args = Py_BuildValue("(OsOLi)", handle_or_none(dataset), name,
                                 mv, num_el, dtype);
  Py_XDECREF(mv);
  return bridge_ok("dataset_set_field", args);
}

// *out_ptr points into storage owned by the dataset handle (valid until
// the handle is freed) — the reference LGBM_DatasetGetField contract.
int GBTN_DatasetGetField(void* dataset, const char* name,
                         long long* out_len, const void** out_ptr,
                         int* out_type) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* r = call_bridge(
      "dataset_get_field",
      Py_BuildValue("(Os)", handle_or_none(dataset), name));
  if (r == nullptr) return -1;
  long long addr = PyLong_AsLongLong(PyTuple_GetItem(r, 0));
  if (out_len != nullptr) {
    *out_len = PyLong_AsLongLong(PyTuple_GetItem(r, 1));
  }
  if (out_type != nullptr) {
    *out_type = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 2)));
  }
  if (out_ptr != nullptr) *out_ptr = reinterpret_cast<const void*>(addr);
  Py_DECREF(r);
  return 0;
}

int GBTN_DatasetGetNumData(void* dataset, long long* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_ll("dataset_num_data",
                   Py_BuildValue("(O)", handle_or_none(dataset)), out);
}

int GBTN_DatasetGetNumFeature(void* dataset, int* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_int("dataset_num_feature",
                    Py_BuildValue("(O)", handle_or_none(dataset)), out);
}

int GBTN_DatasetSetFeatureNames(void* dataset, const char** names, int n) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* list = PyList_New(n);
  if (list == nullptr) {
    set_error_from_python();
    return -1;
  }
  for (int i = 0; i < n; ++i) {
    PyList_SetItem(list, i, PyUnicode_FromString(names[i]));
  }
  PyObject* args = Py_BuildValue("(OO)", handle_or_none(dataset), list);
  Py_DECREF(list);
  return bridge_ok("dataset_set_feature_names", args);
}

int GBTN_DatasetGetFeatureNames(void* dataset, char** out_strs,
                                int buffer_len, int* out_n) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_string_list("dataset_feature_names",
                            Py_BuildValue("(O)", handle_or_none(dataset)),
                            out_strs, buffer_len, out_n);
}

int GBTN_DatasetSaveBinary(void* dataset, const char* filename) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_ok("dataset_save_binary",
                   Py_BuildValue("(Os)", handle_or_none(dataset), filename));
}

int GBTN_DatasetLoadBinary(const char* filename, void** out) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_handle("dataset_load_binary",
                       Py_BuildValue("(s)", filename), out);
}

int GBTN_DatasetGetSubset(void* dataset, const int* used_row_indices,
                          long long num, const char* params, void** out) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* mv = mv_read(used_row_indices, num * sizeof(int));
  PyObject* args = Py_BuildValue("(OOLs)", handle_or_none(dataset), mv, num,
                                 params == nullptr ? "" : params);
  Py_XDECREF(mv);
  return bridge_handle("dataset_subset", args, out);
}

// ------------------------------------------------------ booster surface
// (LGBM_Booster* analogues, c_api.h:246-719)

int GBTN_BoosterCreateFromModelfile(const char* filename,
                                    int* out_num_iterations, void** out) {
  if (!ensure_python()) return -1;
  Gil gil;
  if (bridge_handle("booster_from_file", Py_BuildValue("(s)", filename),
                    out) != 0) {
    return -1;
  }
  if (out_num_iterations != nullptr) {
    return bridge_int("booster_current_iteration",
                      Py_BuildValue("(O)", handle_or_none(*out)),
                      out_num_iterations);
  }
  return 0;
}

int GBTN_BoosterLoadModelFromString(const char* model_str,
                                    int* out_num_iterations, void** out) {
  if (!ensure_python()) return -1;
  Gil gil;
  if (bridge_handle("booster_from_string",
                    Py_BuildValue("(s)", model_str), out) != 0) {
    return -1;
  }
  if (out_num_iterations != nullptr) {
    return bridge_int("booster_current_iteration",
                      Py_BuildValue("(O)", handle_or_none(*out)),
                      out_num_iterations);
  }
  return 0;
}

int GBTN_BoosterMerge(void* booster, void* other_booster) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_ok("booster_merge",
                   Py_BuildValue("(OO)", handle_or_none(booster),
                                 handle_or_none(other_booster)));
}

int GBTN_BoosterAddValidData(void* booster, void* valid_data,
                             const char* name) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_ok("booster_add_valid",
                   Py_BuildValue("(OOs)", handle_or_none(booster),
                                 handle_or_none(valid_data),
                                 name == nullptr ? "valid" : name));
}

int GBTN_BoosterResetTrainingData(void* booster, void* train_data) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_ok("booster_reset_training_data",
                   Py_BuildValue("(OO)", handle_or_none(booster),
                                 handle_or_none(train_data)));
}

int GBTN_BoosterResetParameter(void* booster, const char* params) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_ok("booster_reset_parameter",
                   Py_BuildValue("(Os)", handle_or_none(booster),
                                 params == nullptr ? "" : params));
}

// grad/hess: [n] f32 = num_data * num_class, the caller-computed gradients
// (LGBM_BoosterUpdateOneIterCustom).
int GBTN_BoosterUpdateOneIterCustom(void* booster, const float* grad,
                                    const float* hess, long long n,
                                    int* is_finished) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* mv_g = mv_read(grad, n * sizeof(float));
  PyObject* mv_h = mv_read(hess, n * sizeof(float));
  PyObject* args = Py_BuildValue("(OOOL)", handle_or_none(booster), mv_g,
                                 mv_h, n);
  Py_XDECREF(mv_g);
  Py_XDECREF(mv_h);
  PyObject* r = call_bridge("booster_update_custom", args);
  if (r == nullptr) return -1;
  if (is_finished != nullptr) *is_finished = PyObject_IsTrue(r) ? 1 : 0;
  Py_DECREF(r);
  return 0;
}

int GBTN_BoosterRollbackOneIter(void* booster) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_ok("booster_rollback",
                   Py_BuildValue("(O)", handle_or_none(booster)));
}

int GBTN_BoosterGetCurrentIteration(void* booster, int* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_int("booster_current_iteration",
                    Py_BuildValue("(O)", handle_or_none(booster)), out);
}

int GBTN_BoosterGetNumFeature(void* booster, int* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_int("booster_num_feature",
                    Py_BuildValue("(O)", handle_or_none(booster)), out);
}

int GBTN_BoosterGetFeatureNames(void* booster, char** out_strs,
                                int buffer_len, int* out_n) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_string_list("booster_feature_names",
                            Py_BuildValue("(O)", handle_or_none(booster)),
                            out_strs, buffer_len, out_n);
}

int GBTN_BoosterGetEvalCounts(void* booster, int* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_int("booster_eval_counts",
                    Py_BuildValue("(O)", handle_or_none(booster)), out);
}

int GBTN_BoosterGetEvalNames(void* booster, char** out_strs, int buffer_len,
                             int* out_n) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_string_list("booster_eval_names",
                            Py_BuildValue("(O)", handle_or_none(booster)),
                            out_strs, buffer_len, out_n);
}

// data_idx: 0 = train, i > 0 = i-th validation set.  out must hold
// GetEvalCounts doubles.
int GBTN_BoosterGetEval(void* booster, int data_idx, int* out_len,
                        double* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  long long len = 0;
  if (bridge_buffer_copy("booster_get_eval",
                         Py_BuildValue("(Oi)", handle_or_none(booster),
                                       data_idx),
                         out, sizeof(double), &len, nullptr) != 0) {
    return -1;
  }
  if (out_len != nullptr) *out_len = static_cast<int>(len);
  return 0;
}

int GBTN_BoosterGetNumPredict(void* booster, int data_idx, long long* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_ll("booster_num_predict",
                   Py_BuildValue("(Oi)", handle_or_none(booster), data_idx),
                   out);
}

// Raw scores of the train/valid data, [num_data, num_class] row-major.
int GBTN_BoosterGetPredict(void* booster, int data_idx, long long* out_len,
                           double* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_buffer_copy(
      "booster_get_predict",
      Py_BuildValue("(Oi)", handle_or_none(booster), data_idx), out,
      sizeof(double), out_len, nullptr);
}

int GBTN_BoosterGetLeafValue(void* booster, int tree_idx, int leaf_idx,
                             double* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_double("booster_get_leaf_value",
                       Py_BuildValue("(Oii)", handle_or_none(booster),
                                     tree_idx, leaf_idx),
                       out);
}

int GBTN_BoosterSetLeafValue(void* booster, int tree_idx, int leaf_idx,
                             double value) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_ok("booster_set_leaf_value",
                   Py_BuildValue("(Oiid)", handle_or_none(booster),
                                 tree_idx, leaf_idx, value));
}

// *out_len = needed bytes (incl. NUL); the copy happens only when
// buffer_len suffices — the reference SaveModelToString convention.
int GBTN_BoosterSaveModelToString(void* booster, int num_iteration,
                                  long long buffer_len, long long* out_len,
                                  char* out_str) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_string("booster_model_string",
                       Py_BuildValue("(Oi)", handle_or_none(booster),
                                     num_iteration),
                       buffer_len, out_len, out_str);
}

int GBTN_BoosterDumpModel(void* booster, int num_iteration,
                          long long buffer_len, long long* out_len,
                          char* out_str) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_string("booster_dump_json",
                       Py_BuildValue("(Oi)", handle_or_none(booster),
                                     num_iteration),
                       buffer_len, out_len, out_str);
}

// predict_type: 0 normal, 1 raw score, 2 leaf index (C_API_PREDICT_*).
int GBTN_BoosterCalcNumPredict(void* booster, long long nrow,
                               int predict_type, int num_iteration,
                               long long* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_ll("booster_calc_num_predict",
                   Py_BuildValue("(OLii)", handle_or_none(booster), nrow,
                                 predict_type, num_iteration),
                   out);
}

int GBTN_BoosterPredict(void* booster, const double* data, long long nrow,
                        int ncol, int predict_type, int num_iteration,
                        long long out_capacity, long long* out_len,
                        double* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* mv_in = mv_read(data, nrow * ncol * sizeof(double));
  PyObject* mv_out = mv_write(out, out_capacity * sizeof(double));
  PyObject* args = Py_BuildValue("(OOLiiiOL)", handle_or_none(booster),
                                 mv_in, nrow, ncol, predict_type,
                                 num_iteration, mv_out, out_capacity);
  Py_XDECREF(mv_in);
  Py_XDECREF(mv_out);
  long long written = 0;
  if (bridge_ll("booster_predict_full_into", args, &written) != 0) return -1;
  if (out_len != nullptr) *out_len = written;
  return 0;
}

int GBTN_BoosterPredictForCSR(void* booster, const int* indptr,
                              long long nindptr, const int* indices,
                              const double* data, long long nelem,
                              long long ncol, int predict_type,
                              int num_iteration, long long out_capacity,
                              long long* out_len, double* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* mv_p = mv_read(indptr, nindptr * sizeof(int));
  PyObject* mv_i = mv_read(indices, nelem * sizeof(int));
  PyObject* mv_d = mv_read(data, nelem * sizeof(double));
  PyObject* mv_out = mv_write(out, out_capacity * sizeof(double));
  PyObject* args = Py_BuildValue(
      "(OOLOOLLiiOL)", handle_or_none(booster), mv_p, nindptr, mv_i, mv_d,
      nelem, ncol, predict_type, num_iteration, mv_out, out_capacity);
  Py_XDECREF(mv_p);
  Py_XDECREF(mv_i);
  Py_XDECREF(mv_d);
  Py_XDECREF(mv_out);
  long long written = 0;
  if (bridge_ll("booster_predict_csr_into", args, &written) != 0) return -1;
  if (out_len != nullptr) *out_len = written;
  return 0;
}

int GBTN_BoosterPredictForCSC(void* booster, const int* colptr,
                              long long ncolptr, const int* indices,
                              const double* data, long long nelem,
                              long long nrow, int predict_type,
                              int num_iteration, long long out_capacity,
                              long long* out_len, double* out) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject* mv_p = mv_read(colptr, ncolptr * sizeof(int));
  PyObject* mv_i = mv_read(indices, nelem * sizeof(int));
  PyObject* mv_d = mv_read(data, nelem * sizeof(double));
  PyObject* mv_out = mv_write(out, out_capacity * sizeof(double));
  PyObject* args = Py_BuildValue(
      "(OOLOOLLiiOL)", handle_or_none(booster), mv_p, ncolptr, mv_i, mv_d,
      nelem, nrow, predict_type, num_iteration, mv_out, out_capacity);
  Py_XDECREF(mv_p);
  Py_XDECREF(mv_i);
  Py_XDECREF(mv_d);
  Py_XDECREF(mv_out);
  long long written = 0;
  if (bridge_ll("booster_predict_csc_into", args, &written) != 0) return -1;
  if (out_len != nullptr) *out_len = written;
  return 0;
}

int GBTN_BoosterPredictForFile(void* booster, const char* data_filename,
                               int has_header, const char* result_filename,
                               int predict_type, int num_iteration) {
  if (!ensure_python()) return -1;
  Gil gil;
  return bridge_ok("booster_predict_for_file",
                   Py_BuildValue("(Osisii)", handle_or_none(booster),
                                 data_filename, has_header, result_filename,
                                 predict_type, num_iteration));
}

}  // extern "C"
