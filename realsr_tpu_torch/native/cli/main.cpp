// realsr-tpu-torch — native CLI binary of the PyTorch port.
//
// The port's own copy of native/cli/main.cpp: the same flags, file listing,
// queues, codec threads, usage text and exit codes, with the device work
// going to realsr_tpu_torch.native_bridge (the PyTorch engine) instead of
// realsr_tpu's. On -g -1 the bridge itself selects the CPU.
//
// The host runtime of the reference is C++ (src/main.cpp: getopt CLI,
// bounded MPMC task queues, load/proc/save thread pools, codecs); so is
// this one. Everything host-side runs native: flag parsing/validation
// (identical surface: -i -o -s -t -m -g -j -x -f -v -h), directory listing
// with collision rename, capacity-8 queues with poison pill -233,
// decode/encode via librealsr_io_torch (libpng/libjpeg/libwebp). The device
// work goes through one embedded CPython call per image into
// realsr_tpu_torch.native_bridge.

#include <Python.h>

#include <algorithm>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dirent.h>
#include <mutex>
#include <queue>
#include <string>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {
unsigned char* rsio_decode(const char* path, int* w, int* h, int* c);
void rsio_free(unsigned char* p);
int rsio_encode(const char* path, int w, int h, int c,
                const unsigned char* pixels, const char* ext);
}

namespace {

void print_usage() {
  std::fprintf(stderr,
               "Usage: realsr-tpu -i infile -o outfile [options]...\n\n");
  std::fprintf(stderr, "  -h                   show this help\n");
  std::fprintf(stderr, "  -v                   verbose output\n");
  std::fprintf(stderr,
               "  -i input-path        input image path (jpg/png/webp) or directory\n");
  std::fprintf(stderr,
               "  -o output-path       output image path (jpg/png/webp) or directory\n");
  std::fprintf(stderr, "  -s scale             upscale ratio (4, default=4)\n");
  std::fprintf(stderr,
               "  -t tile-size         tile size (>=32/0=auto, default=0) can be 0,0,0 for multi-gpu\n");
  std::fprintf(stderr,
               "  -m model-path        realsr model path (default=models-DF2K_JPEG)\n");
  std::fprintf(stderr,
               "  -g gpu-id            gpu device to use (-1=cpu, default=auto) can be 0,1,2 for multi-gpu\n");
  std::fprintf(stderr,
               "  -j load:proc:save    thread count for load/proc/save (default=1:2:2) can be 1:2,2,2:2 for multi-gpu\n");
  std::fprintf(stderr, "  -x                   enable tta mode\n");
  std::fprintf(stderr,
               "  -f format            output image format (jpg/png/webp, default=ext/png)\n");
}

std::vector<int> parse_int_array(const char* s) {
  std::vector<int> out;
  std::string tok;
  for (const char* p = s;; p++) {
    if (*p == ',' || *p == '\0') {
      out.push_back(std::atoi(tok.c_str()));
      tok.clear();
      if (*p == '\0') break;
    } else {
      tok.push_back(*p);
    }
  }
  return out;
}

bool path_is_directory(const std::string& p) {
  struct stat st;
  return stat(p.c_str(), &st) == 0 && S_ISDIR(st.st_mode);
}

bool path_exists(const std::string& p) {
  struct stat st;
  return stat(p.c_str(), &st) == 0;
}

std::string file_extension(const std::string& p) {
  size_t slash = p.find_last_of('/');
  std::string base = slash == std::string::npos ? p : p.substr(slash + 1);
  size_t dot = base.find_last_of('.');
  return dot == std::string::npos ? "" : base.substr(dot + 1);
}

std::string lower(std::string s) {
  for (auto& c : s) c = static_cast<char>(std::tolower(c));
  return s;
}

std::string name_without_ext(const std::string& name) {
  size_t dot = name.find_last_of('.');
  return dot == std::string::npos ? name : name.substr(0, dot);
}

std::vector<std::string> list_directory(const std::string& path) {
  std::vector<std::string> names;
  DIR* d = opendir(path.c_str());
  if (!d) return names;
  while (dirent* e = readdir(d)) {
    std::string n = e->d_name;
    if (n == "." || n == "..") continue;
    if (!path_is_directory(path + "/" + n)) names.push_back(n);
  }
  closedir(d);
  std::sort(names.begin(), names.end());
  return names;
}

// ---- bounded MPMC queue (main.cpp:130-174 semantics) --------------------

struct Task {
  int id = 0;
  std::string inpath, outpath;
  unsigned char* pixels = nullptr;  // owned
  int w = 0, h = 0, c = 0;
  std::vector<unsigned char> out;   // scaled result
  int ow = 0, oh = 0;
  long handle = -1;  // device-resident result (bridge process_async)
};

class TaskQueue {
 public:
  void put(Task v) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_put_.wait(lk, [&] { return q_.size() < 8; });  // capacity 8
    q_.push(std::move(v));
    cv_get_.notify_one();
  }
  Task get() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_get_.wait(lk, [&] { return !q_.empty(); });
    Task v = std::move(q_.front());
    q_.pop();
    cv_put_.notify_one();
    return v;
  }
  // non-blocking pop for opportunistic batch drain (never waits)
  bool try_get(Task* out) {
    std::unique_lock<std::mutex> lk(mu_);
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop();
    cv_put_.notify_one();
    return true;
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_get_, cv_put_;
  std::queue<Task> q_;
};

constexpr int kPoison = -233;  // main.cpp:322

TaskQueue toproc, tosave;

// ---- embedded python bridge ---------------------------------------------

PyObject* g_bridge = nullptr;

bool bridge_init(const std::string& config_json, int* scale) {
  PyGILState_STATE g = PyGILState_Ensure();
  bool ok = false;
  PyObject* mod = PyImport_ImportModule("realsr_tpu_torch.native_bridge");
  if (mod) {
    PyObject* r = PyObject_CallMethod(mod, "init", "s", config_json.c_str());
    if (r) {
      *scale = static_cast<int>(PyLong_AsLong(r));
      Py_DECREF(r);
      g_bridge = mod;
      ok = true;
    } else {
      PyErr_Print();
      Py_DECREF(mod);
    }
  } else {
    PyErr_Print();
  }
  PyGILState_Release(g);
  return ok;
}

// Out-of-box model resolution (realsr_tpu_torch.modelzoo.ensure_model): extended
// search (CWD, exe dir, repo models/, user cache) + first-use placeholder
// weight synthesis for the default DF2K dirs — the same path the Python
// CLI uses, so a fresh clone works with zero setup in both CLIs.
bool bridge_ensure_model(const std::string& model, int scale,
                         std::string* parampath, std::string* modelpath) {
  PyGILState_STATE g = PyGILState_Ensure();
  bool ok = false;
  PyObject* mod = PyImport_ImportModule("realsr_tpu_torch.modelzoo");
  if (mod) {
    PyObject* r = PyObject_CallMethod(mod, "ensure_model", "si",
                                      model.c_str(), scale);
    if (r) {
      const char* s = PyUnicode_AsUTF8(r);
      if (s) {
        std::string both(s);
        size_t nl = both.find('\n');
        if (nl != std::string::npos) {
          *parampath = both.substr(0, nl);
          *modelpath = both.substr(nl + 1);
          ok = true;
        }
      }
      Py_DECREF(r);
    } else {
      PyErr_Print();
    }
    Py_DECREF(mod);
  } else {
    PyErr_Print();
  }
  PyGILState_Release(g);
  return ok;
}

// Optional AOT warm-up (REALSR_TPU_PRECOMPILE=1, Python-CLI parity):
// compile the first input's program set before the pipeline starts.
void bridge_warmup(const std::string& first_path, bool verbose) {
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject* r =
      PyObject_CallMethod(g_bridge, "warmup", "s", first_path.c_str());
  if (r) {
    long n = PyLong_AsLong(r);
    if (n == -1 && PyErr_Occurred()) {
      // non-int return: clear the pending exception here rather than let
      // it surface confusingly on a later CPython call (mirrors
      // bridge_device_count's treatment of -1 as unknown)
      PyErr_Print();
    } else if (verbose) {
      std::fprintf(stderr, "precompiled %ld programs\n", n);
    }
    Py_DECREF(r);
  } else {
    PyErr_Print();
  }
  PyGILState_Release(g);
}

// Dispatch only: the result stays on the device (the engine keeps it there)
// so the save thread's fetch (the one D2H) overlaps this thread's next
// image's compute — the proc/save overlap the reference's pipeline split
// exists for (src/main.cpp:305-416).
bool bridge_process_async(int engine_idx, Task& t, int scale) {
  PyGILState_STATE g = PyGILState_Ensure();
  bool ok = false;
  PyObject* buf = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(t.pixels),
      static_cast<Py_ssize_t>(t.w) * t.h * t.c);
  if (buf) {
    PyObject* r = PyObject_CallMethod(g_bridge, "process_async", "iOiii",
                                      engine_idx, buf, t.w, t.h, t.c);
    Py_DECREF(buf);
    if (r) {
      t.handle = PyLong_AsLong(r);
      t.ow = t.w * scale;
      t.oh = t.h * scale;
      ok = t.handle > 0;
      Py_DECREF(r);
    } else {
      PyErr_Print();
    }
  }
  PyGILState_Release(g);
  return ok;
}

// Same-shape image stack -> one device batch; one handle per task
// (engine cross-image tile batching, as the Python pipeline batches).
bool bridge_process_batch_async(int engine_idx, std::vector<Task>& batch,
                                int scale) {
  PyGILState_STATE g = PyGILState_Ensure();
  bool ok = false;
  PyObject* list = PyList_New(static_cast<Py_ssize_t>(batch.size()));
  if (list) {
    bool built = true;
    for (size_t i = 0; i < batch.size(); i++) {
      PyObject* b = PyBytes_FromStringAndSize(
          reinterpret_cast<const char*>(batch[i].pixels),
          static_cast<Py_ssize_t>(batch[i].w) * batch[i].h * batch[i].c);
      if (!b) { built = false; break; }
      PyList_SET_ITEM(list, static_cast<Py_ssize_t>(i), b);  // steals ref
    }
    if (built) {
      PyObject* r = PyObject_CallMethod(g_bridge, "process_batch_async",
                                        "iOiii", engine_idx, list,
                                        batch[0].w, batch[0].h, batch[0].c);
      if (r && PyList_Check(r) &&
          PyList_Size(r) == static_cast<Py_ssize_t>(batch.size())) {
        for (size_t i = 0; i < batch.size(); i++) {
          batch[i].handle =
              PyLong_AsLong(PyList_GET_ITEM(r, static_cast<Py_ssize_t>(i)));
          batch[i].ow = batch[i].w * scale;
          batch[i].oh = batch[i].h * scale;
        }
        ok = true;
      } else if (!r) {
        PyErr_Print();
      }
      Py_XDECREF(r);
    }
    Py_DECREF(list);
  }
  PyGILState_Release(g);
  return ok;
}

bool bridge_fetch(Task& t) {
  PyGILState_STATE g = PyGILState_Ensure();
  bool ok = false;
  PyObject* r = PyObject_CallMethod(g_bridge, "fetch", "l", t.handle);
  if (r) {
    char* data;
    Py_ssize_t len;
    if (PyBytes_AsStringAndSize(r, &data, &len) == 0) {
      t.out.assign(data, data + len);
      ok = true;
    }
    Py_DECREF(r);
  } else {
    PyErr_Print();
  }
  t.handle = -1;
  PyGILState_Release(g);
  return ok;
}

// ncnn::get_gpu_count analog (reference validates -g against it,
// main.cpp:722-732) — the bridge's accelerator pool size.
long bridge_device_count() {
  PyGILState_STATE g = PyGILState_Ensure();
  long n = -1;
  PyObject* mod = PyImport_ImportModule("realsr_tpu_torch.native_bridge");
  if (mod) {
    PyObject* r = PyObject_CallMethod(mod, "device_count", nullptr);
    if (r) {
      n = PyLong_AsLong(r);
      Py_DECREF(r);
    } else {
      PyErr_Print();
    }
    Py_DECREF(mod);
  } else {
    PyErr_Print();
  }
  PyGILState_Release(g);
  return n;
}

// filesystem_utils.h:167-173 semantics: a model path that does not exist
// as given is retried relative to the executable's directory.
std::string get_executable_directory() {
  char buf[1024];
  ssize_t n = readlink("/proc/self/exe", buf, sizeof(buf) - 1);
  if (n <= 0) return ".";
  buf[n] = '\0';
  std::string p(buf);
  size_t slash = p.find_last_of('/');
  return slash == std::string::npos ? "." : p.substr(0, slash);
}

std::string sanitize_filepath(const std::string& path) {
  // CWD-relative first, then exe-relative (filesystem_utils.h:167-173);
  // absolute paths have no exe-relative reading — leave them untouched so
  // diagnostics show what the user actually typed.
  if (path_exists(path) || (!path.empty() && path[0] == '/')) return path;
  return get_executable_directory() + "/" + path;
}

}  // namespace

int main(int argc, char** argv) {
  std::string inputpath, outputpath;
  int scale = 4;
  std::vector<int> tilesize;
  std::string model = "models-DF2K_JPEG";
  std::vector<int> gpuid;
  int jobs_load = 1, jobs_save = 2;
  std::vector<int> jobs_proc;
  int verbose = 0, tta_mode = 0;
  std::string format = "png";

  int opt;
  while ((opt = getopt(argc, argv, "i:o:s:t:m:g:j:f:vxh")) != -1) {
    switch (opt) {
      case 'i': inputpath = optarg; break;
      case 'o': outputpath = optarg; break;
      case 's': scale = std::atoi(optarg); break;
      case 't': tilesize = parse_int_array(optarg); break;
      case 'm': model = optarg; break;
      case 'g': gpuid = parse_int_array(optarg); break;
      case 'j': {
        std::sscanf(optarg, "%d:%*[^:]:%d", &jobs_load, &jobs_save);
        const char* colon = std::strchr(optarg, ':');
        if (colon) jobs_proc = parse_int_array(colon + 1);
        break;
      }
      case 'f': format = optarg; break;
      case 'v': verbose = 1; break;
      case 'x': tta_mode = 1; break;
      case 'h':
      default:
        print_usage();
        return -1;
    }
  }

  if (inputpath.empty() || outputpath.empty()) {
    print_usage();
    return -1;
  }
  if (scale != 4) {
    std::fprintf(stderr, "invalid scale argument\n");
    return -1;
  }
  size_t n_dev = gpuid.empty() ? 1 : gpuid.size();
  if (!tilesize.empty() && tilesize.size() != n_dev) {
    std::fprintf(stderr, "invalid tilesize argument\n");
    return -1;
  }
  for (int t : tilesize)
    if (t != 0 && t < 32) {
      std::fprintf(stderr, "invalid tilesize argument\n");
      return -1;
    }
  if (jobs_load < 1 || jobs_save < 1) {
    std::fprintf(stderr, "invalid thread count argument\n");
    return -1;
  }
  if (!jobs_proc.empty() && jobs_proc.size() != n_dev) {
    std::fprintf(stderr, "invalid jobs_proc thread count argument\n");
    return -1;
  }
  for (int j : jobs_proc)
    if (j < 1) {
      std::fprintf(stderr, "invalid jobs_proc thread count argument\n");
      return -1;
    }

  if (!path_is_directory(outputpath)) {
    std::string ext = lower(file_extension(outputpath));
    if (ext == "png") format = "png";
    else if (ext == "webp") format = "webp";
    else if (ext == "jpg" || ext == "jpeg") format = "jpg";
    else {
      std::fprintf(stderr, "invalid outputpath extension type\n");
      return -1;
    }
  }
  if (format != "png" && format != "webp" && format != "jpg") {
    std::fprintf(stderr, "invalid format argument\n");
    return -1;
  }

  std::vector<std::string> input_files, output_files;
  if (path_is_directory(inputpath) && path_is_directory(outputpath)) {
    std::string last_fn, last_noext;
    for (const std::string& fn : list_directory(inputpath)) {
      std::string noext = name_without_ext(fn);
      std::string out_fn = noext + "." + format;
      if (noext == last_noext) {  // collision rename (main.cpp:628-643)
        std::string out2 = fn + "." + format;
        std::fprintf(stderr, "both %s and %s output %s ! %s will output %s\n",
                     fn.c_str(), last_fn.c_str(), out_fn.c_str(), fn.c_str(),
                     out2.c_str());
        out_fn = out2;
      } else {
        last_fn = fn;
        last_noext = noext;
      }
      input_files.push_back(inputpath + "/" + fn);
      output_files.push_back(outputpath + "/" + out_fn);
    }
  } else if (!path_is_directory(inputpath) && !path_is_directory(outputpath)) {
    input_files.push_back(inputpath);
    output_files.push_back(outputpath);
  } else {
    std::fprintf(stderr,
                 "inputpath and outputpath must be either file or directory "
                 "at the same time\n");
    return -1;
  }

  // Multi-host (DCN) mode: split the file list across processes — hosts
  // never communicate (tiles never cross chips). Same contract as the
  // Python CLI (realsr_tpu_torch/cli.py).
  const char* shard_env = std::getenv("REALSR_TPU_SHARD");
  const char* nshard_env = std::getenv("REALSR_TPU_NUM_SHARDS");
  if (nshard_env && std::atoi(nshard_env) > 1) {
    int num_shards = std::atoi(nshard_env);
    int shard = shard_env ? std::atoi(shard_env) : -1;
    if (shard < 0 || shard >= num_shards) {
      std::fprintf(stderr, "invalid REALSR_TPU_SHARD / REALSR_TPU_NUM_SHARDS\n");
      return -1;
    }
    std::vector<std::string> in2, out2;
    for (size_t i = shard; i < input_files.size(); i += num_shards) {
      in2.push_back(input_files[i]);
      out2.push_back(output_files[i]);
    }
    input_files.swap(in2);
    output_files.swap(out2);
  }

  int prepadding = 0;
  if (model.find("models-DF2K") != std::string::npos) {
    prepadding = 10;  // main.cpp:661-667
  } else {
    std::fprintf(stderr, "unknown model dir type\n");
    return -1;
  }

  // model paths resolve relative to CWD, then the exe dir
  // (filesystem_utils.h:167-173); extended resolution + first-use weight
  // synthesis for the default DF2K dirs runs through realsr_tpu_torch.modelzoo
  // after the interpreter starts (shared with the Python CLI). A local
  // hit short-circuits without needing Python.
  std::string parampath =
      sanitize_filepath(model + "/x" + std::to_string(scale) + ".param");
  std::string modelpath =
      sanitize_filepath(model + "/x" + std::to_string(scale) + ".bin");
  bool model_resolved = path_exists(parampath) && path_exists(modelpath);

  if (gpuid.empty()) gpuid.push_back(0);
  if (jobs_proc.empty()) jobs_proc.assign(gpuid.size(), 2);
  if (tilesize.empty()) tilesize.assign(gpuid.size(), 0);

  // ---- embedded python ---------------------------------------------------
  Py_Initialize();
  {
    // validate -g against the device pool (reference: "invalid gpu device",
    // main.cpp:723-732). -1 = CPU is always valid.
    bool any_accel = false;
    for (int g : gpuid) any_accel = any_accel || g != -1;
    long dev_count = any_accel ? bridge_device_count() : 0;
    for (int g : gpuid) {
      if (g < -1 || (g >= 0 && dev_count >= 0 && g >= dev_count)) {
        std::fprintf(stderr, "invalid gpu device\n");
        Py_Finalize();
        return -1;
      }
    }
  }
  if (!model_resolved &&
      !bridge_ensure_model(model, scale, &parampath, &modelpath)) {
    std::fprintf(stderr, "model files not found under -m %s\n",
                 model.c_str());
    Py_Finalize();
    return -1;
  }
  {
    // config as JSON (hand-rolled; ints/bools/strings only)
    std::string cfg = "{\"gpuid\":[";
    for (size_t i = 0; i < gpuid.size(); i++)
      cfg += (i ? "," : "") + std::to_string(gpuid[i]);
    cfg += "],\"tilesize\":[";
    for (size_t i = 0; i < tilesize.size(); i++)
      cfg += (i ? "," : "") + std::to_string(tilesize[i]);
    cfg += "],\"jobs_proc\":[";
    for (size_t i = 0; i < jobs_proc.size(); i++)
      cfg += (i ? "," : "") + std::to_string(jobs_proc[i]);
    cfg += "],\"prepadding\":" + std::to_string(prepadding);
    cfg += std::string(",\"tta_mode\":") + (tta_mode ? "true" : "false");
    cfg += ",\"parampath\":\"" + std::string(parampath) + "\"";
    cfg += ",\"modelpath\":\"" + std::string(modelpath) + "\"}";
    int model_scale = 0;
    if (!bridge_init(cfg, &model_scale)) {
      std::fprintf(stderr, "engine init failed\n");
      Py_Finalize();
      return -1;
    }
    if (model_scale != scale) {
      std::fprintf(stderr, "model scale %d != requested %d\n", model_scale,
                   scale);
      Py_Finalize();
      return -1;
    }
    const char* pre = std::getenv("REALSR_TPU_PRECOMPILE");
    if (pre && *pre && std::string(pre) != "0" && !input_files.empty())
      bridge_warmup(input_files[0], verbose);
  }
  PyThreadState* main_state = PyEval_SaveThread();  // release GIL for workers

  // ---- pipeline ----------------------------------------------------------
  int cpu_count = std::max(1u, std::thread::hardware_concurrency());
  jobs_load = std::min(jobs_load, cpu_count);
  jobs_save = std::min(jobs_save, cpu_count);

  std::vector<std::thread> loaders;
  for (int k = 0; k < jobs_load; k++) {
    loaders.emplace_back([&, k] {
      for (size_t i = k; i < input_files.size(); i += jobs_load) {
        Task t;
        t.id = static_cast<int>(i);
        t.inpath = input_files[i];
        t.outpath = output_files[i];
        t.pixels = rsio_decode(t.inpath.c_str(), &t.w, &t.h, &t.c);
        if (!t.pixels) {
          std::fprintf(stderr, "decode image %s failed\n", t.inpath.c_str());
          continue;
        }
        std::string ext = lower(file_extension(t.outpath));
        if (t.c == 4 && (ext == "jpg" || ext == "jpeg")) {
          std::string redirected = t.outpath + ".png";
          std::fprintf(stderr,
                       "image %s has alpha channel ! %s will output %s\n",
                       t.inpath.c_str(), t.inpath.c_str(), redirected.c_str());
          t.outpath = redirected;
        }
        toproc.put(std::move(t));
      }
    });
  }

  // cross-image batching (tiles of same-shape images share conv chunks —
  // engine.process_batch); opt-in like the Python CLI
  const char* ib_env = std::getenv("REALSR_TPU_IMAGE_BATCH");
  const int image_batch = std::max(1, ib_env ? std::atoi(ib_env) : 1);

  int total_proc = 0;
  std::vector<std::thread> procs;
  for (size_t d = 0; d < gpuid.size(); d++) {
    int nthreads = gpuid[d] == -1 ? 1 : jobs_proc[d];
    for (int j = 0; j < nthreads; j++) {
      total_proc++;
      procs.emplace_back([&, d] {
        // a drained non-batchable task is HELD, never re-queued: re-queuing
        // into the bounded queue can deadlock against a blocked producer
        // (same hazard as realsr_tpu_torch/pipeline.py:proc_worker)
        Task pending;
        bool have_pending = false;
        for (;;) {
          Task t;
          if (have_pending) {
            t = std::move(pending);
            have_pending = false;
          } else {
            t = toproc.get();
          }
          if (t.id == kPoison) break;
          std::vector<Task> batch;
          batch.push_back(std::move(t));
          while (static_cast<int>(batch.size()) < image_batch) {
            Task t2;
            if (!toproc.try_get(&t2)) break;  // never wait for more input
            if (t2.id == kPoison || t2.w != batch[0].w ||
                t2.h != batch[0].h || t2.c != batch[0].c) {
              pending = std::move(t2);
              have_pending = true;
              break;
            }
            batch.push_back(std::move(t2));
          }
          bool ok = batch.size() == 1
                        ? bridge_process_async(static_cast<int>(d), batch[0],
                                               scale)
                        : bridge_process_batch_async(static_cast<int>(d),
                                                     batch, scale);
          for (Task& b : batch) {
            rsio_free(b.pixels);
            b.pixels = nullptr;
            if (ok) tosave.put(std::move(b));
            else std::fprintf(stderr, "process %s failed\n", b.inpath.c_str());
          }
        }
      });
    }
  }

  std::vector<std::thread> savers;
  for (int k = 0; k < jobs_save; k++) {
    savers.emplace_back([&] {
      for (;;) {
        Task t = tosave.get();
        if (t.id == kPoison) break;
        if (!bridge_fetch(t)) {  // the one D2H; overlaps proc's next compute
          std::fprintf(stderr, "fetch %s failed\n", t.inpath.c_str());
          continue;
        }
        std::string ext = lower(file_extension(t.outpath));
        int ok = rsio_encode(t.outpath.c_str(), t.ow, t.oh, t.c,
                             t.out.data(), ext.c_str());
        if (ok) {
          if (verbose)
            std::fprintf(stderr, "%s -> %s done\n", t.inpath.c_str(),
                         t.outpath.c_str());
        } else {
          std::fprintf(stderr, "encode image %s failed\n", t.outpath.c_str());
        }
      }
    });
  }

  for (auto& th : loaders) th.join();
  for (int i = 0; i < total_proc; i++) {
    Task end;
    end.id = kPoison;
    toproc.put(std::move(end));
  }
  for (auto& th : procs) th.join();
  for (int i = 0; i < jobs_save; i++) {
    Task end;
    end.id = kPoison;
    tosave.put(std::move(end));
  }
  for (auto& th : savers) th.join();

  PyEval_RestoreThread(main_state);
  Py_Finalize();
  return 0;
}
