// The tfos::flash_fwd operator for a process with no Python: the C++ binding
// of the flash attention forward (csrc/flash_fwd.cu) that
// csrc/aoti_runner.cpp loads before it runs an AOTInductor package.
//
// A package calls the op through the dispatcher by name and schema (its
// proxy executor), so this file declares the schema of the Python op
// (ops/flash_attention.py) letter for letter.  It is a binding of the kernel
// that replaces the Pallas _fwd_kernel (tensorflowonspark_tpu/ops/
// flash_attention.py:49), not a kernel of its own:
//
// - CUDA (built with -DTFOS_WITH_CUDA, linked against the kernel's library):
//   the same checks, head_dim padding and output slicing as the Python
//   wrapper, then the C entry flash_fwd on the current stream.  Bound by
//   what bounds the kernel (bytes, at the serving shapes).
// - CPU: the plain version in ATen (fp32 scores, causal mask, softmax, fp32
//   LSE), so a CPU package can be checked where there is no card.
//
// Only the forward is registered: a served package never reaches the
// backward ops.  A Python process that imported ops.flash_attention already
// defines the op and must not load this library (a second definition
// fails).  tfos_flash_fwd_launches() counts the kernel launches,
// tfos_flash_fwd_calls() the op's calls on either device.
//
// Build: ops/_build.py (build_native("flash_ops")), g++ against torch.

#include <ATen/ATen.h>
#include <torch/library.h>

#include <atomic>
#include <tuple>

#ifdef TFOS_WITH_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

// csrc/flash_fwd.cu
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int batch, int seq_len, int heads, int head_dim,
                         const long long* strides, float scale, int causal, int dtype,
                         void* stream);
extern "C" const char* flash_fwd_error_string(int err);
#endif

namespace {

std::atomic<long long> g_launches{0};
std::atomic<long long> g_calls{0};

constexpr double kNegInf = -1e30;

std::tuple<at::Tensor, at::Tensor> flash_fwd_cpu(const at::Tensor& q, const at::Tensor& k,
                                                 const at::Tensor& v, double scale,
                                                 bool causal) {
  g_calls.fetch_add(1);
  const int64_t batch = q.size(0), seq = q.size(1), heads = q.size(2);
  at::Tensor s = at::einsum("bqhd,bkhd->bhqk", {q.to(at::kFloat), k.to(at::kFloat)}) * scale;
  if (causal) {
    at::Tensor mask = at::ones({seq, seq}, q.options().dtype(at::kBool)).tril();
    s = s.masked_fill(mask.logical_not(), kNegInf);
  }
  at::Tensor lse = at::logsumexp(s, {-1});
  at::Tensor out = at::einsum("bhqk,bkhd->bqhd", {at::softmax(s, -1), v.to(at::kFloat)});
  return {out.to(q.scalar_type()).contiguous(), lse.reshape({batch * heads, seq}).contiguous()};
}

#ifdef TFOS_WITH_CUDA

constexpr int64_t kAlign = 16;  // bytes: the kernels' 16-byte vector copies

bool aligned(const at::Tensor& t) {
  const int64_t elt = t.element_size();
  if (reinterpret_cast<uintptr_t>(t.data_ptr()) % kAlign != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (t.stride(i) * elt % kAlign != 0) return false;
  return true;
}

// _check_kernel_inputs of ops/flash_attention.py
void check_inputs(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v) {
  const at::Tensor* ts[3] = {&q, &k, &v};
  const char* names[3] = {"q", "k", "v"};
  TORCH_CHECK_VALUE(q.dim() == 4 && k.sizes() == q.sizes() && v.sizes() == q.sizes(),
                    "q, k, v must share one [batch, seq, heads, dim] shape, got ", q.sizes(),
                    ", ", k.sizes(), ", ", v.sizes());
  const int64_t d = q.size(3);
  TORCH_CHECK_VALUE(d == 32 || d == 64 || d == 128,
                    "flash_fwd kernel takes head_dim in (32, 64, 128), got ", d);
  TORCH_CHECK_VALUE((q.scalar_type() == at::kFloat || q.scalar_type() == at::kBFloat16) &&
                        k.scalar_type() == q.scalar_type() && v.scalar_type() == q.scalar_type(),
                    "flash_fwd kernel takes float32 or bfloat16 inputs of one dtype, got ",
                    q.scalar_type(), ", ", k.scalar_type(), ", ", v.scalar_type());
  for (int i = 0; i < 3; ++i)
    TORCH_CHECK_VALUE(ts[i]->stride(-1) == 1,
                      "flash_fwd kernel needs a contiguous head_dim (stride 1 on the last axis)");
  for (int i = 0; i < 3; ++i)
    TORCH_CHECK_VALUE(aligned(*ts[i]), "flash_fwd kernel needs ", names[i], " aligned to ",
                      kAlign, " bytes (base pointer and batch, seq, head strides), got pointer "
                      "offset ", reinterpret_cast<uintptr_t>(ts[i]->data_ptr()) % kAlign,
                      " and strides ", ts[i]->strides());
  for (int i = 0; i < 3; ++i)
    TORCH_CHECK_VALUE(ts[i]->is_cuda() && ts[i]->device() == q.device(),
                      "flash_fwd kernel runs on CUDA tensors of one device, got ", q.device(),
                      ", ", k.device(), ", ", v.device());
}

std::tuple<at::Tensor, at::Tensor> flash_fwd_cuda(const at::Tensor& q_in, const at::Tensor& k_in,
                                                  const at::Tensor& v_in, double scale,
                                                  bool causal) {
  g_calls.fetch_add(1);
  check_inputs(q_in, k_in, v_in);
  const int64_t head_dim = q_in.size(3);
  const bool fp32 = q_in.scalar_type() == at::kFloat;
  // _padded_for: the fp32 (FMA) kernel takes head_dim 64 or 128, so 32 is
  // zero-padded to 64 (zero columns add nothing to any product)
  const int64_t run_dim = (fp32 && head_dim == 32) ? 64 : head_dim;
  at::Tensor q = q_in, k = k_in, v = v_in;
  if (run_dim != head_dim) {
    q = at::constant_pad_nd(q_in, {0, run_dim - head_dim});
    k = at::constant_pad_nd(k_in, {0, run_dim - head_dim});
    v = at::constant_pad_nd(v_in, {0, run_dim - head_dim});
  }
  const int64_t batch = q.size(0), seq = q.size(1), heads = q.size(2);
  at::Tensor out = at::empty(q.sizes(), q.options());
  at::Tensor lse = at::empty({batch * heads, seq}, q.options().dtype(at::kFloat));
  long long strides[12];
  const at::Tensor* strided[4] = {&q, &k, &v, &out};
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 3; ++i) strides[3 * t + i] = strided[t]->stride(i);
  c10::cuda::CUDAGuard guard(q.device());
  cudaStream_t stream = c10::cuda::getCurrentCUDAStream(q.device().index()).stream();
  const int err = flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            lse.data_ptr(), static_cast<int>(batch), static_cast<int>(seq),
                            static_cast<int>(heads), static_cast<int>(run_dim), strides,
                            static_cast<float>(scale), causal ? 1 : 0, fp32 ? 0 : 1,
                            static_cast<void*>(stream));
  TORCH_CHECK(err == 0, "flash_fwd kernel launch failed: ", flash_fwd_error_string(err), " (",
              err, ")");
  g_launches.fetch_add(1);
  if (run_dim != head_dim) out = out.narrow(-1, 0, head_dim);
  return {out.contiguous(), lse};
}

#endif  // TFOS_WITH_CUDA

}  // namespace

// The kernel launches this library made in this process.
extern "C" long long tfos_flash_fwd_launches() { return g_launches.load(); }

// The op's calls in this process, on either device.
extern "C" long long tfos_flash_fwd_calls() { return g_calls.load(); }

// Whether this library carries the CUDA implementation.
extern "C" int tfos_flash_ops_with_cuda() {
#ifdef TFOS_WITH_CUDA
  return 1;
#else
  return 0;
#endif
}

TORCH_LIBRARY(tfos, m) {
  m.def("flash_fwd(Tensor q, Tensor k, Tensor v, float scale, bool causal) -> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(tfos, CPU, m) { m.impl("flash_fwd", &flash_fwd_cpu); }

#ifdef TFOS_WITH_CUDA
TORCH_LIBRARY_IMPL(tfos, CUDA, m) { m.impl("flash_fwd", &flash_fwd_cuda); }
#endif
