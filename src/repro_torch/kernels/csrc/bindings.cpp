// PyTorch bindings of the port's CUDA kernels. The only source that
// includes torch/extension.h (slow to compile); the kernels themselves
// (gru.cu, gae.cu, flash_attention.cu, flash_attention_sm90.cu, ssd.cu,
// ssd_sm90.cu)
// see only the CUDA runtime. Outputs are allocated by the
// Python wrappers (repro_torch/kernels/*/kernel.py), which also check
// shapes; this layer checks device, dtype and contiguity, launches on
// PyTorch's current stream and checks every launch.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

size_t gru_forward_smem_bytes(int H, int rows);
size_t gru_backward_smem_bytes(int H, int rows);
size_t gru_backward_part_floats(int A, int T, int B, int H);
cudaError_t launch_gru_forward(const float* gi, const float* wh,
                               const float* bh, const float* h0,
                               const float* resets, float* hs, int A, int T,
                               int B, int H, int rows, cudaStream_t stream);
cudaError_t launch_gru_backward(const float* gi, const float* wh,
                                const float* bh, const float* h0,
                                const float* resets, const float* hs,
                                const float* g, float* gh, float* rgate,
                                float* part, float* dgi, float* dwh,
                                float* dbh, float* dh0, int A, int T, int B,
                                int H, int rows, cudaStream_t stream);
cudaError_t launch_gae_forward(const float* r, const float* v,
                               const float* nv, const float* d, float* adv,
                               int T, int B, float gamma, float gamma_lam,
                               cudaStream_t stream);
cudaError_t launch_gae_backward(const float* g, const float* d, float* dr,
                                float* dnv, int T, int B, float gamma,
                                float gamma_lam, cudaStream_t stream);
cudaError_t launch_flash_attention(const float* q, const float* k,
                                   const float* v, float* o, int BH,
                                   int BHkv, int Tq, int Tk, int D,
                                   int causal, int window, float softcap,
                                   float scale, cudaStream_t stream);
cudaError_t launch_flash_attention_sm90(const void* q, const void* k,
                                        const void* v, void* o, int BH,
                                        int BHkv, int Tq, int Tk, int D,
                                        int causal, int window, float softcap,
                                        float scale, cudaStream_t stream);
size_t flash_attention_sm90_smem_bytes(int D);
size_t ssd_smem_bytes(int L, int P, int N);
cudaError_t launch_ssd_chunk(const void* xw, const float* la, const void* b,
                             const void* c, void* y, float* st, float* cd,
                             bool bf16, int B, int T, int H, int P, int N,
                             int L, int G, cudaStream_t stream);
size_t ssd_sm90_smem_bytes(int L, int P, int N);
cudaError_t launch_ssd_chunk_sm90(const void* xw, const float* la,
                                  const void* b, const void* c, void* y,
                                  float* st, float* cd, int B, int T, int H,
                                  int P, int N, int L, int G,
                                  cudaStream_t stream);

namespace {

void check(const torch::Tensor& x, const char* name) {
  TORCH_CHECK(x.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(x.scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(x.is_contiguous(), name, " must be contiguous");
}

const float* in(const torch::Tensor& x, const char* name) {
  check(x, name);
  return x.data_ptr<float>();
}

float* out(torch::Tensor& x, const char* name) {
  check(x, name);
  return x.data_ptr<float>();
}

// float32 or bfloat16, the same for every tensor of one call
bool half_or_float(const std::vector<torch::Tensor>& xs,
                   const std::vector<const char*>& names) {
  const auto dtype = xs[0].scalar_type();
  TORCH_CHECK(dtype == torch::kFloat32 || dtype == torch::kBFloat16,
              names[0], " must be float32 or bfloat16");
  for (size_t i = 0; i < xs.size(); ++i) {
    TORCH_CHECK(xs[i].is_cuda(), names[i], " must be a CUDA tensor");
    TORCH_CHECK(xs[i].scalar_type() == dtype, names[i], " must be ",
                dtype == torch::kBFloat16 ? "bfloat16" : "float32");
    TORCH_CHECK(xs[i].is_contiguous(), names[i], " must be contiguous");
  }
  return dtype == torch::kBFloat16;
}

void gru_forward(torch::Tensor gi, torch::Tensor wh, torch::Tensor bh,
                 torch::Tensor h0, torch::Tensor resets, torch::Tensor hs,
                 int64_t rows) {
  const c10::cuda::CUDAGuard guard(gi.device());
  const int A = gi.size(0), T = gi.size(1), B = gi.size(2), H = wh.size(1);
  C10_CUDA_CHECK(launch_gru_forward(
      in(gi, "gi"), in(wh, "wh"), in(bh, "bh"), in(h0, "h0"),
      in(resets, "resets"), out(hs, "hs"), A, T, B, H, (int)rows,
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// four kernels: the gate recompute, the adjoint chain, the dW_h/db_h
// partial sums over slices of rows and their sum in slice order
void gru_backward(torch::Tensor gi, torch::Tensor wh, torch::Tensor bh,
                  torch::Tensor h0, torch::Tensor resets, torch::Tensor hs,
                  torch::Tensor g, torch::Tensor gh, torch::Tensor rgate,
                  torch::Tensor part, torch::Tensor dgi, torch::Tensor dwh,
                  torch::Tensor dbh, torch::Tensor dh0, int64_t rows) {
  const c10::cuda::CUDAGuard guard(gi.device());
  const int A = gi.size(0), T = gi.size(1), B = gi.size(2), H = wh.size(1);
  C10_CUDA_CHECK(launch_gru_backward(
      in(gi, "gi"), in(wh, "wh"), in(bh, "bh"), in(h0, "h0"),
      in(resets, "resets"), in(hs, "hs"), in(g, "g"), out(gh, "gh"),
      out(rgate, "rgate"), out(part, "part"), out(dgi, "dgi"),
      out(dwh, "dwh"), out(dbh, "dbh"), out(dh0, "dh0"), A, T, B, H,
      (int)rows,
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void gae_forward(torch::Tensor r, torch::Tensor v, torch::Tensor nv,
                 torch::Tensor d, torch::Tensor adv, double gamma,
                 double gamma_lam) {
  const c10::cuda::CUDAGuard guard(r.device());
  C10_CUDA_CHECK(launch_gae_forward(
      in(r, "rewards"), in(v, "values"), in(nv, "next_values"),
      in(d, "dones"), out(adv, "adv"), r.size(0), r.size(1), (float)gamma,
      (float)gamma_lam, c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void gae_backward(torch::Tensor g, torch::Tensor d, torch::Tensor dr,
                  torch::Tensor dnv, double gamma, double gamma_lam) {
  const c10::cuda::CUDAGuard guard(g.device());
  C10_CUDA_CHECK(launch_gae_backward(
      in(g, "g"), in(d, "dones"), out(dr, "dr"), out(dnv, "dnv"), g.size(0),
      g.size(1), (float)gamma, (float)gamma_lam,
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// float32 only: the FFMA kernel (flash_attention.cu)
void flash_attention(torch::Tensor q, torch::Tensor k, torch::Tensor v,
                     torch::Tensor o, bool causal, int64_t window,
                     double softcap, double scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(launch_flash_attention(
      in(q, "q"), in(k, "k"), in(v, "v"), out(o, "out"), q.size(0),
      k.size(0), q.size(1), k.size(1), q.size(2), causal ? 1 : 0,
      (int)window, (float)softcap, (float)scale,
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// bf16 only: the tensor-core kernel (flash_attention_sm90.cu)
void flash_attention_sm90(torch::Tensor q, torch::Tensor k, torch::Tensor v,
                          torch::Tensor o, bool causal, int64_t window,
                          double softcap, double scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  TORCH_CHECK(half_or_float({q, k, v, o}, {"q", "k", "v", "out"}),
              "q must be bfloat16");
  C10_CUDA_CHECK(launch_flash_attention_sm90(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), q.size(0),
      k.size(0), q.size(1), k.size(1), q.size(2), causal ? 1 : 0,
      (int)window, (float)softcap, (float)scale,
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void ssd_intra_chunk(torch::Tensor xw, torch::Tensor la, torch::Tensor b,
                     torch::Tensor c, torch::Tensor y, torch::Tensor st,
                     torch::Tensor cd, int64_t chunk, int64_t heads_per_block) {
  const c10::cuda::CUDAGuard guard(xw.device());
  const bool bf16 = half_or_float({xw, b, c, y}, {"xw", "b", "c", "y"});
  C10_CUDA_CHECK(launch_ssd_chunk(
      xw.data_ptr(), in(la, "la"), b.data_ptr(), c.data_ptr(), y.data_ptr(),
      out(st, "states"), out(cd, "chunk_decay"), bf16, xw.size(0),
      xw.size(1), xw.size(2), xw.size(3), b.size(2), (int)chunk,
      (int)heads_per_block, c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// bf16 only, P 64, L and N 64 or 128: the tensor-core kernel (ssd_sm90.cu)
void ssd_intra_chunk_sm90(torch::Tensor xw, torch::Tensor la, torch::Tensor b,
                          torch::Tensor c, torch::Tensor y, torch::Tensor st,
                          torch::Tensor cd, int64_t chunk,
                          int64_t heads_per_block) {
  const c10::cuda::CUDAGuard guard(xw.device());
  TORCH_CHECK(half_or_float({xw, b, c, y}, {"xw", "b", "c", "y"}),
              "xw must be bfloat16");
  C10_CUDA_CHECK(launch_ssd_chunk_sm90(
      xw.data_ptr(), in(la, "la"), b.data_ptr(), c.data_ptr(), y.data_ptr(),
      out(st, "states"), out(cd, "chunk_decay"), xw.size(0), xw.size(1),
      xw.size(2), xw.size(3), b.size(2), (int)chunk, (int)heads_per_block,
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("gru_forward_smem_bytes", &gru_forward_smem_bytes);
  m.def("gru_backward_smem_bytes", &gru_backward_smem_bytes);
  m.def("gru_backward_part_floats", &gru_backward_part_floats);
  m.def("gru_forward", &gru_forward);
  m.def("gru_backward", &gru_backward);
  m.def("gae_forward", &gae_forward);
  m.def("gae_backward", &gae_backward);
  m.def("flash_attention", &flash_attention);
  m.def("flash_attention_sm90", &flash_attention_sm90);
  m.def("flash_attention_sm90_smem_bytes", &flash_attention_sm90_smem_bytes);
  m.def("ssd_smem_bytes", &ssd_smem_bytes);
  m.def("ssd_intra_chunk", &ssd_intra_chunk);
  m.def("ssd_sm90_smem_bytes", &ssd_sm90_smem_bytes);
  m.def("ssd_intra_chunk_sm90", &ssd_intra_chunk_sm90);
}
