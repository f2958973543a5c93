// rt_native: the framework's native runtime core (CPython C API, no pybind).
//
// Reference analogs (all C++ there too):
//   - memory monitor: src/ray/common/memory_monitor.h (cgroup/proc polling
//     feeding raylet/worker_killing_policy.cc)
//   - chunk integrity: src/ray/object_manager/chunk_object_reader.h pairs
//     with crc32 checks in the object manager protocol
//   - append-only store: src/ray/gcs/store_client/redis_store_client.cc's
//     role (durable KV behind the GCS tables)
//
// Exposed:
//   crc32c(bytes-like[, init]) -> int          (Castagnoli, slice-by-8)
//   memory_info() -> dict                      (system + cgroup v1/v2)
//   process_rss(pid) -> int                    (bytes; -1 if gone)
//   process_memory(pids) -> list[(pid, rss)]   (one pass, sorted desc)
//   LogKV(path)                                (append-only durable dict)
//     .put(key: str, value: bytes)  .get(key) -> bytes|None
//     .delete(key)  .keys() -> list[str]  .compact()  .close()
//     .sync()       len(kv)
//
// Build: python -m ray_tpu._native.build  (g++ via setuptools, no network).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <string>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

// ---------------------------------------------------------------- crc32c ---

static uint32_t crc32c_table[8][256];
static bool crc32c_ready = false;

static void crc32c_init_tables() {
  const uint32_t poly = 0x82f63b78u;  // reflected Castagnoli
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (poly ^ (c >> 1)) : (c >> 1);
    crc32c_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = crc32c_table[0][i];
    for (int t = 1; t < 8; t++) {
      c = crc32c_table[0][c & 0xff] ^ (c >> 8);
      crc32c_table[t][i] = c;
    }
  }
  crc32c_ready = true;
}

static uint32_t crc32c_run(uint32_t crc, const uint8_t* buf, size_t len) {
  crc = ~crc;
  while (len && ((uintptr_t)buf & 7)) {
    crc = crc32c_table[0][(crc ^ *buf++) & 0xff] ^ (crc >> 8);
    len--;
  }
  while (len >= 8) {
    uint64_t word;
    memcpy(&word, buf, 8);
    word ^= crc;  // little-endian assumption (fine for x86/arm linux)
    crc = crc32c_table[7][word & 0xff] ^ crc32c_table[6][(word >> 8) & 0xff] ^
          crc32c_table[5][(word >> 16) & 0xff] ^
          crc32c_table[4][(word >> 24) & 0xff] ^
          crc32c_table[3][(word >> 32) & 0xff] ^
          crc32c_table[2][(word >> 40) & 0xff] ^
          crc32c_table[1][(word >> 48) & 0xff] ^
          crc32c_table[0][(word >> 56) & 0xff];
    buf += 8;
    len -= 8;
  }
  while (len--) crc = crc32c_table[0][(crc ^ *buf++) & 0xff] ^ (crc >> 8);
  return ~crc;
}

static PyObject* py_crc32c(PyObject*, PyObject* args) {
  Py_buffer view;
  unsigned int init = 0;
  if (!PyArg_ParseTuple(args, "y*|I", &view, &init)) return nullptr;
  uint32_t crc;
  Py_BEGIN_ALLOW_THREADS
  crc = crc32c_run((uint32_t)init, (const uint8_t*)view.buf, (size_t)view.len);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  return PyLong_FromUnsignedLong(crc);
}

// ---------------------------------------------------------- memory_info ----

static long long read_ll_file(const char* path) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  char buf[64];
  if (!fgets(buf, sizeof buf, f)) {
    fclose(f);
    return -1;
  }
  fclose(f);
  if (strncmp(buf, "max", 3) == 0) return -1;  // cgroup v2 "max" = unlimited
  return atoll(buf);
}

// parse /proc/meminfo keys (kB units)
static void read_meminfo(long long* total, long long* available) {
  *total = -1;
  *available = -1;
  FILE* f = fopen("/proc/meminfo", "r");
  if (!f) return;
  char line[256];
  while (fgets(line, sizeof line, f)) {
    long long v;
    if (sscanf(line, "MemTotal: %lld kB", &v) == 1) *total = v * 1024;
    else if (sscanf(line, "MemAvailable: %lld kB", &v) == 1)
      *available = v * 1024;
    if (*total >= 0 && *available >= 0) break;
  }
  fclose(f);
}

static PyObject* py_memory_info(PyObject*, PyObject*) {
  long long sys_total, sys_avail;
  long long cg_limit = -1, cg_used = -1;
  Py_BEGIN_ALLOW_THREADS
  read_meminfo(&sys_total, &sys_avail);
  // cgroup v2 first, then v1 (the reference checks both the same way)
  cg_limit = read_ll_file("/sys/fs/cgroup/memory.max");
  if (cg_limit >= 0) {
    cg_used = read_ll_file("/sys/fs/cgroup/memory.current");
  } else {
    cg_limit = read_ll_file("/sys/fs/cgroup/memory/memory.limit_in_bytes");
    if (cg_limit >= (long long)1 << 60) cg_limit = -1;  // v1 "unlimited"
    if (cg_limit >= 0)
      cg_used = read_ll_file("/sys/fs/cgroup/memory/memory.usage_in_bytes");
  }
  Py_END_ALLOW_THREADS
  long long total = sys_total, used = sys_total - sys_avail;
  if (cg_limit > 0 && (sys_total < 0 || cg_limit < sys_total)) {
    total = cg_limit;
    if (cg_used >= 0) used = cg_used;
  }
  return Py_BuildValue(
      "{s:L,s:L,s:L,s:L,s:L,s:L}", "total", total, "used", used, "available",
      total >= 0 && used >= 0 ? total - used : -1, "system_total", sys_total,
      "cgroup_limit", cg_limit, "cgroup_used", cg_used);
}

static long long rss_of(long pid) {
  char path[64];
  snprintf(path, sizeof path, "/proc/%ld/statm", pid);
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  long long size_pages, rss_pages;
  int n = fscanf(f, "%lld %lld", &size_pages, &rss_pages);
  fclose(f);
  if (n != 2) return -1;
  return rss_pages * (long long)sysconf(_SC_PAGESIZE);
}

static PyObject* py_process_rss(PyObject*, PyObject* args) {
  long pid;
  if (!PyArg_ParseTuple(args, "l", &pid)) return nullptr;
  long long rss;
  Py_BEGIN_ALLOW_THREADS
  rss = rss_of(pid);
  Py_END_ALLOW_THREADS
  return PyLong_FromLongLong(rss);
}

static PyObject* py_process_memory(PyObject*, PyObject* args) {
  PyObject* pids;
  if (!PyArg_ParseTuple(args, "O", &pids)) return nullptr;
  PyObject* seq = PySequence_Fast(pids, "expected a sequence of pids");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  std::vector<std::pair<long long, long>> out;
  out.reserve(n);
  for (Py_ssize_t i = 0; i < n; i++) {
    long pid = PyLong_AsLong(PySequence_Fast_GET_ITEM(seq, i));
    if (pid == -1 && PyErr_Occurred()) {
      Py_DECREF(seq);
      return nullptr;
    }
    long long rss = rss_of(pid);
    if (rss >= 0) out.emplace_back(rss, pid);
  }
  Py_DECREF(seq);
  std::sort(out.rbegin(), out.rend());  // largest RSS first
  PyObject* list = PyList_New((Py_ssize_t)out.size());
  if (!list) return nullptr;
  for (size_t i = 0; i < out.size(); i++) {
    PyList_SET_ITEM(list, (Py_ssize_t)i,
                    Py_BuildValue("(lL)", out[i].second, out[i].first));
  }
  return list;
}

// -------------------------------------------------------------- LogKV ------
//
// Durable append-only KV: records are
//   [u32 crc over rest][u32 klen][u32 vlen|0xffffffff=tombstone][key][value]
// Replay on open rebuilds the in-memory index; compact() rewrites live
// entries to <path>.compact then renames (atomic on POSIX).

struct LogKVObject {
  PyObject_HEAD
  std::map<std::string, std::string>* table;
  std::string* path;
  int fd;
};

static int logkv_append(LogKVObject* self, const std::string& key,
                        const char* val, uint32_t vlen, bool tombstone) {
  uint32_t klen = (uint32_t)key.size();
  uint32_t vfield = tombstone ? 0xffffffffu : vlen;
  std::string rec;
  rec.reserve(12 + klen + (tombstone ? 0 : vlen));
  rec.append(8, '\0');  // klen+vfield placeholder (crc prepended later)
  memcpy(&rec[0], &klen, 4);
  memcpy(&rec[4], &vfield, 4);
  rec.append(key);
  if (!tombstone && vlen) rec.append(val, vlen);
  uint32_t crc =
      crc32c_run(0, (const uint8_t*)rec.data(), rec.size());
  std::string frame;
  frame.reserve(4 + rec.size());
  frame.append((const char*)&crc, 4);
  frame.append(rec);
  const char* p = frame.data();
  size_t left = frame.size();
  while (left) {
    ssize_t w = write(self->fd, p, left);
    if (w < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    p += w;
    left -= (size_t)w;
  }
  return 0;
}

// zlib-polynomial crc32: legacy WAL files written by the pure-Python
// fallback of older builds framed records with zlib.crc32. Replay accepts
// either algorithm per record so a toolchain appearing between restarts
// can't silently discard the whole durable KV as a corrupt tail.
static uint32_t crc32_zlib_run(uint32_t crc, const uint8_t* buf, size_t len) {
  static uint32_t table[256];
  static bool ready = false;
  if (!ready) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    ready = true;
  }
  crc = ~crc;
  while (len--) crc = table[(crc ^ *buf++) & 0xff] ^ (crc >> 8);
  return ~crc;
}

static int logkv_replay(LogKVObject* self) {
  FILE* f = fopen(self->path->c_str(), "rb");
  if (!f) return 0;  // fresh store
  const char* stop = nullptr;
  long pos = 0;
  for (;;) {
    pos = ftell(f);
    uint8_t hdr[12];
    size_t n = fread(hdr, 1, 12, f);
    if (n == 0) break;
    if (n < 12) {  // torn tail record: ignore (crash mid-append)
      stop = "torn header";
      break;
    }
    uint32_t crc, klen, vfield;
    memcpy(&crc, hdr, 4);
    memcpy(&klen, hdr + 4, 4);
    memcpy(&vfield, hdr + 8, 4);
    bool tombstone = vfield == 0xffffffffu;
    uint32_t vlen = tombstone ? 0 : vfield;
    if (klen > (1u << 24) || vlen > (1u << 30)) {
      stop = "implausible record lengths";
      break;
    }
    std::string body(8 + klen + vlen, '\0');
    memcpy(&body[0], hdr + 4, 8);
    if (fread(&body[8], 1, klen + vlen, f) < klen + vlen) {
      stop = "torn body";
      break;
    }
    if (crc32c_run(0, (const uint8_t*)body.data(), body.size()) != crc &&
        crc32_zlib_run(0, (const uint8_t*)body.data(), body.size()) != crc) {
      stop = "checksum mismatch";
      break;
    }
    std::string key = body.substr(8, klen);
    if (tombstone)
      self->table->erase(key);
    else
      (*self->table)[key] = body.substr(8 + klen, vlen);
  }
  if (stop) {
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    if (pos < size) {
      fprintf(stderr,
              "rt_native LogKV: replay of %s stopped at offset %ld of %ld "
              "(%s); %ld trailing bytes truncated, %zu keys recovered\n",
              self->path->c_str(), pos, size, stop, size - pos,
              self->table->size());
      // Truncate the unreplayable tail before the O_APPEND open: appends
      // landing after a surviving torn tail would be skipped by every
      // future replay — acked writes silently lost on each restart.
      if (truncate(self->path->c_str(), pos) != 0)
        fprintf(stderr, "rt_native LogKV: truncate(%s, %ld) failed: %s\n",
                self->path->c_str(), pos, strerror(errno));
    }
  }
  fclose(f);
  return 0;
}

static PyObject* LogKV_new(PyTypeObject* type, PyObject*, PyObject*) {
  LogKVObject* self = (LogKVObject*)type->tp_alloc(type, 0);
  if (self) {
    self->table = new std::map<std::string, std::string>();
    self->path = new std::string();
    self->fd = -1;
  }
  return (PyObject*)self;
}

static int LogKV_init(LogKVObject* self, PyObject* args, PyObject*) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return -1;
  *self->path = path;
  logkv_replay(self);
  self->fd = open(path, O_WRONLY | O_CREAT | O_APPEND, 0600);
  if (self->fd < 0) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return -1;
  }
  return 0;
}

static void LogKV_dealloc(LogKVObject* self) {
  if (self->fd >= 0) close(self->fd);
  delete self->table;
  delete self->path;
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyObject* LogKV_put(LogKVObject* self, PyObject* args) {
  const char* key;
  Py_buffer val;
  if (!PyArg_ParseTuple(args, "sy*", &key, &val)) return nullptr;
  int rc;
  Py_BEGIN_ALLOW_THREADS
  rc = logkv_append(self, key, (const char*)val.buf, (uint32_t)val.len, false);
  Py_END_ALLOW_THREADS
  if (rc == 0)
    (*self->table)[key] = std::string((const char*)val.buf, (size_t)val.len);
  PyBuffer_Release(&val);
  if (rc != 0) {
    PyErr_SetString(PyExc_OSError, "LogKV append failed");
    return nullptr;
  }
  Py_RETURN_NONE;
}

static PyObject* LogKV_get(LogKVObject* self, PyObject* args) {
  const char* key;
  if (!PyArg_ParseTuple(args, "s", &key)) return nullptr;
  auto it = self->table->find(key);
  if (it == self->table->end()) Py_RETURN_NONE;
  return PyBytes_FromStringAndSize(it->second.data(),
                                   (Py_ssize_t)it->second.size());
}

static PyObject* LogKV_delete(LogKVObject* self, PyObject* args) {
  const char* key;
  if (!PyArg_ParseTuple(args, "s", &key)) return nullptr;
  auto it = self->table->find(key);
  if (it == self->table->end()) Py_RETURN_FALSE;
  int rc;
  Py_BEGIN_ALLOW_THREADS
  rc = logkv_append(self, key, nullptr, 0, true);
  Py_END_ALLOW_THREADS
  if (rc != 0) {
    PyErr_SetString(PyExc_OSError, "LogKV append failed");
    return nullptr;
  }
  self->table->erase(it);
  Py_RETURN_TRUE;
}

static PyObject* LogKV_keys(LogKVObject* self, PyObject*) {
  PyObject* list = PyList_New((Py_ssize_t)self->table->size());
  if (!list) return nullptr;
  Py_ssize_t i = 0;
  for (auto& kv : *self->table) {
    PyList_SET_ITEM(list, i++,
                    PyUnicode_FromStringAndSize(kv.first.data(),
                                                (Py_ssize_t)kv.first.size()));
  }
  return list;
}

static PyObject* LogKV_sync(LogKVObject* self, PyObject*) {
  int rc;
  Py_BEGIN_ALLOW_THREADS
  rc = fsync(self->fd);
  Py_END_ALLOW_THREADS
  if (rc != 0) {
    PyErr_SetFromErrno(PyExc_OSError);
    return nullptr;
  }
  Py_RETURN_NONE;
}

static PyObject* LogKV_compact(LogKVObject* self, PyObject*) {
  std::string tmp = *self->path + ".compact";
  int tfd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0600);
  if (tfd < 0) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, tmp.c_str());
    return nullptr;
  }
  int old_fd = self->fd;
  self->fd = tfd;
  int rc = 0;
  Py_BEGIN_ALLOW_THREADS
  for (auto& kv : *self->table) {
    if (logkv_append(self, kv.first, kv.second.data(),
                     (uint32_t)kv.second.size(), false) != 0) {
      rc = -1;
      break;
    }
  }
  if (rc == 0) rc = fsync(tfd);
  Py_END_ALLOW_THREADS
  if (rc != 0 || rename(tmp.c_str(), self->path->c_str()) != 0) {
    close(tfd);
    self->fd = old_fd;
    unlink(tmp.c_str());
    PyErr_SetString(PyExc_OSError, "LogKV compact failed");
    return nullptr;
  }
  close(old_fd);
  Py_RETURN_NONE;
}

static PyObject* LogKV_close(LogKVObject* self, PyObject*) {
  if (self->fd >= 0) {
    close(self->fd);
    self->fd = -1;
  }
  Py_RETURN_NONE;
}

static Py_ssize_t LogKV_len(PyObject* self) {
  return (Py_ssize_t)((LogKVObject*)self)->table->size();
}

static PyMethodDef LogKV_methods[] = {
    {"put", (PyCFunction)LogKV_put, METH_VARARGS, "put(key, bytes)"},
    {"get", (PyCFunction)LogKV_get, METH_VARARGS, "get(key) -> bytes|None"},
    {"delete", (PyCFunction)LogKV_delete, METH_VARARGS,
     "delete(key) -> bool"},
    {"keys", (PyCFunction)LogKV_keys, METH_NOARGS, "keys() -> list[str]"},
    {"sync", (PyCFunction)LogKV_sync, METH_NOARGS, "fsync the log"},
    {"compact", (PyCFunction)LogKV_compact, METH_NOARGS,
     "rewrite live entries, drop tombstones"},
    {"close", (PyCFunction)LogKV_close, METH_NOARGS, "close the fd"},
    {nullptr, nullptr, 0, nullptr}};

static PySequenceMethods LogKV_as_seq = {
    LogKV_len, nullptr, nullptr, nullptr, nullptr,
    nullptr,   nullptr, nullptr, nullptr, nullptr};

static PyTypeObject LogKVType = {
    PyVarObject_HEAD_INIT(nullptr, 0) "rt_native.LogKV", /* tp_name */
    sizeof(LogKVObject)};

// ----------------------------------------------------------------- module --

static PyMethodDef rt_methods[] = {
    {"crc32c", py_crc32c, METH_VARARGS, "crc32c(data[, init]) -> int"},
    {"memory_info", py_memory_info, METH_NOARGS,
     "system+cgroup memory -> dict"},
    {"process_rss", py_process_rss, METH_VARARGS, "process_rss(pid) -> int"},
    {"process_memory", py_process_memory, METH_VARARGS,
     "process_memory(pids) -> [(pid, rss)] sorted desc"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef rt_module = {PyModuleDef_HEAD_INIT, "rt_native",
                                       "ray_tpu native runtime core", -1,
                                       rt_methods};

PyMODINIT_FUNC PyInit_rt_native(void) {
  crc32c_init_tables();
  LogKVType.tp_basicsize = sizeof(LogKVObject);
  LogKVType.tp_flags = Py_TPFLAGS_DEFAULT;
  LogKVType.tp_doc = "append-only durable KV (crc32c-framed log + index)";
  LogKVType.tp_new = LogKV_new;
  LogKVType.tp_init = (initproc)LogKV_init;
  LogKVType.tp_dealloc = (destructor)LogKV_dealloc;
  LogKVType.tp_methods = LogKV_methods;
  LogKVType.tp_as_sequence = &LogKV_as_seq;
  if (PyType_Ready(&LogKVType) < 0) return nullptr;
  PyObject* m = PyModule_Create(&rt_module);
  if (!m) return nullptr;
  Py_INCREF(&LogKVType);
  if (PyModule_AddObject(m, "LogKV", (PyObject*)&LogKVType) < 0) {
    Py_DECREF(&LogKVType);
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
