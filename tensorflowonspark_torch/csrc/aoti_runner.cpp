// Standalone C++ serving runner for the export's embedded AOTInductor
// package (serving.serialize_embedded): the port's counterpart of
// native/pjrt_runner.cc.  It serves a params-embedded, fixed-batch program
// with no Python in the process.
//
// It dlopens the port's operator library (csrc/flash_ops.cpp, which
// registers tfos::flash_fwd), loads the package once with
// torch::inductor::AOTIModelPackageLoader, feeds raw host buffers, runs the
// program on the device and writes raw output buffers.
//
// Usage:
//   aoti_runner --package apply_embedded.pt2 --device cuda \
//               --ops_lib libflash_ops.so [--batches N] \
//               --input s32:4,1024:tokens.bin [--input ...] --out /tmp/pred
//
// Inputs are dense row-major host buffers in the package's flattened
// argument order (the export descriptor's "embedded_pt2" records it); with
// --batches N each file holds N buffers of the declared shape, one after
// the other, and the package runs once per batch.  Output i of batch b is
// written to <out>.<i>.bin for one batch, <out>.<b>.<i>.bin for several.
// The last line on stdout is one JSON object: the flash kernel's launches
// in this process (and the op's calls, which on the CPU run its plain
// version), the package's load seconds and the batches' run seconds.
//
// Nothing falls back: a failed dlopen of --ops_lib, --device cuda without a
// card or without the library's CUDA implementation, or a package built
// for another device ends the process with exit code 1.
//
// Build: ops/_build.py (build_native("aoti_runner")), g++ against torch.

#include <dlfcn.h>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

#include <ATen/ATen.h>
#include <ATen/Context.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

namespace {

[[noreturn]] void Die(const std::string& msg) {
  std::fprintf(stderr, "aoti_runner: %s\n", msg.c_str());
  std::exit(1);
}

struct InputSpec {
  at::ScalarType dtype;
  std::vector<int64_t> shape;
  std::string path;
};

// The descriptor's short dtype names (serving._SHORT_DTYPES).
at::ScalarType ParseDtype(const std::string& name) {
  if (name == "f32") return at::kFloat;
  if (name == "f64") return at::kDouble;
  if (name == "f16") return at::kHalf;
  if (name == "bf16") return at::kBFloat16;
  if (name == "s8") return at::kChar;
  if (name == "s16") return at::kShort;
  if (name == "s32") return at::kInt;
  if (name == "s64") return at::kLong;
  if (name == "u8") return at::kByte;
  if (name == "pred") return at::kBool;
  Die("unsupported dtype " + name);
}

// dtype:d0,d1,...:path
InputSpec ParseInput(const std::string& arg) {
  size_t a = arg.find(':');
  size_t b = arg.find(':', a == std::string::npos ? a : a + 1);
  if (a == std::string::npos || b == std::string::npos)
    Die("--input wants dtype:shape:path, got " + arg);
  InputSpec spec;
  spec.dtype = ParseDtype(arg.substr(0, a));
  std::stringstream dims(arg.substr(a + 1, b - a - 1));
  std::string d;
  while (std::getline(dims, d, ',')) {
    try {
      spec.shape.push_back(std::stoll(d));
    } catch (const std::exception&) {
      Die("bad dimension '" + d + "' in " + arg);
    }
  }
  spec.path = arg.substr(b + 1);
  return spec;
}

std::string ReadFile(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) Die("cannot read " + path);
  std::stringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

void WriteFile(const std::string& path, const at::Tensor& t) {
  std::ofstream f(path, std::ios::binary);
  if (!f) Die("cannot write " + path);
  f.write(static_cast<const char*>(t.data_ptr()), t.numel() * t.element_size());
}

double Since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
}

int Run(int argc, char** argv) {
  std::string package, device_name = "cuda", ops_lib, out_prefix = "out";
  std::vector<InputSpec> inputs;
  size_t batches = 1;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&](const char* flag) -> std::string {
      if (i + 1 >= argc) Die(std::string(flag) + " needs a value");
      return argv[++i];
    };
    if (a == "--package") package = next("--package");
    else if (a == "--device") device_name = next("--device");
    else if (a == "--ops_lib") ops_lib = next("--ops_lib");
    else if (a == "--input") inputs.push_back(ParseInput(next("--input")));
    else if (a == "--out") out_prefix = next("--out");
    else if (a == "--batches") {
      try {
        batches = static_cast<size_t>(std::stoul(next("--batches")));
      } catch (const std::exception&) {
        Die("--batches wants a number");
      }
      if (batches == 0) Die("--batches must be >= 1");
    } else {
      Die("unknown flag " + a);
    }
  }
  if (package.empty() || ops_lib.empty()) Die("--package and --ops_lib are required");
  if (device_name != "cuda" && device_name != "cpu")
    Die("--device must be cuda or cpu, got " + device_name);

  // 1. The operator library: registers tfos::flash_fwd with the dispatcher.
  void* ops = dlopen(ops_lib.c_str(), RTLD_NOW | RTLD_GLOBAL);
  if (!ops) Die(std::string("dlopen of --ops_lib failed: ") + dlerror());
  using CountFn = long long (*)();
  using FlagFn = int (*)();
  auto launches = reinterpret_cast<CountFn>(dlsym(ops, "tfos_flash_fwd_launches"));
  auto calls = reinterpret_cast<CountFn>(dlsym(ops, "tfos_flash_fwd_calls"));
  auto with_cuda = reinterpret_cast<FlagFn>(dlsym(ops, "tfos_flash_ops_with_cuda"));
  if (!launches || !calls || !with_cuda) Die("--ops_lib " + ops_lib + " is not the port's flash_ops library");
  const bool cuda = device_name == "cuda";
  if (cuda && !at::hasCUDA()) Die("--device cuda, but there is no CUDA card here");
  if (cuda && !with_cuda()) Die("--ops_lib " + ops_lib + " was built without CUDA");

  // 2. The package, loaded once.
  auto t_load = std::chrono::steady_clock::now();
  torch::inductor::AOTIModelPackageLoader loader(package);
  const double load_s = Since(t_load);
  auto meta = loader.get_metadata();
  const std::string built_for = meta.count("AOTI_DEVICE_KEY") ? meta["AOTI_DEVICE_KEY"] : "";
  if (built_for != device_name)
    Die("package " + package + " was built for '" + built_for + "', not --device " + device_name);

  // 3. The batches.
  std::vector<std::string> data;
  std::vector<int64_t> nbytes;
  for (const InputSpec& spec : inputs) {
    int64_t n = c10::elementSize(spec.dtype);
    for (int64_t d : spec.shape) n *= d;
    data.push_back(ReadFile(spec.path));
    nbytes.push_back(n);
    if (data.back().size() != static_cast<size_t>(n) * batches)
      Die(spec.path + " holds " + std::to_string(data.back().size()) + " bytes, want " +
          std::to_string(n * batches) + " (" + std::to_string(batches) + " batches)");
  }
  const at::Device device(cuda ? at::kCUDA : at::kCPU);
  double run_s = 0.0;
  std::vector<std::string> written;
  for (size_t b = 0; b < batches; ++b) {
    std::vector<at::Tensor> args;
    for (size_t i = 0; i < inputs.size(); ++i) {
      at::Tensor host = at::empty(inputs[i].shape, at::TensorOptions().dtype(inputs[i].dtype));
      std::memcpy(host.data_ptr(), data[i].data() + b * nbytes[i], nbytes[i]);
      args.push_back(host.to(device));
    }
    auto t_run = std::chrono::steady_clock::now();
    std::vector<at::Tensor> outs = loader.run(args);
    std::vector<at::Tensor> host_outs;
    for (const at::Tensor& o : outs) host_outs.push_back(o.to(at::kCPU).contiguous());
    run_s += Since(t_run);  // the copies to the host wait for the device
    for (size_t i = 0; i < host_outs.size(); ++i) {
      std::string path = out_prefix + "." +
                         (batches == 1 ? "" : std::to_string(b) + ".") + std::to_string(i) +
                         ".bin";
      WriteFile(path, host_outs[i]);
      written.push_back(path);
      std::printf("batch %zu output %zu: dtype=%s dims=%s bytes=%lld\n", b, i,
                  c10::toString(host_outs[i].scalar_type()),
                  c10::str(host_outs[i].sizes()).c_str(),
                  static_cast<long long>(host_outs[i].numel() * host_outs[i].element_size()));
    }
  }
  std::printf(
      "{\"flash_fwd_launches\": %lld, \"flash_fwd_calls\": %lld, \"load_s\": %.9f, "
      "\"run_s\": %.9f, \"batches\": %zu, \"device\": \"%s\", \"outputs\": %zu}\n",
      launches(), calls(), load_s, run_s, batches, device_name.c_str(), written.size());
  std::fflush(stdout);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  try {
    return Run(argc, argv);
  } catch (const std::exception& e) {  // c10::Error from the loader or a run
    Die(e.what());
  }
}
