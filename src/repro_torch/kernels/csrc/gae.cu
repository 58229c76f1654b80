// GAE-lambda scan kernels for Hopper (sm_90a).
//
// Replace the Pallas kernels of repro/kernels/gae/kernel.py:
//   gae_fwd <- _gae_forward / _gae_kernel       (reverse-time advantage scan)
//   gae_bwd <- _gae_backward / _gae_bwd_kernel  (forward-time linear adjoint)
//
// Layout: time-major (T, B) float32, B = every (agent, env) column.
//
// Design. The recursion is sequential in T and independent across B, so
// one thread owns one column and scans it; neighbouring threads read
// neighbouring addresses at every step, so each step's loads coalesce.
// The work is a few flops per element: the bound is the bytes (each input
// read once, each output written once). Every operation is an explicit
// round-to-nearest fp32 intrinsic in the order the plain torch version
// evaluates it, so nvcc contracts nothing into an FMA and the kernel
// matches the plain version bit for bit.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// adv_t = delta_t + (gamma*lam)(1-d_t) adv_{t+1},
// delta_t = r_t + gamma nv_t (1-d_t) - v_t
__global__ void gae_fwd(const float* __restrict__ r,
                        const float* __restrict__ v,
                        const float* __restrict__ nv,
                        const float* __restrict__ d, float* __restrict__ adv,
                        int T, int B, float gamma, float gamma_lam) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float carry = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = (size_t)t * B + b;
    const float nd = __fsub_rn(1.0f, d[i]);
    const float delta =
        __fsub_rn(__fadd_rn(r[i], __fmul_rn(__fmul_rn(gamma, nv[i]), nd)),
                  v[i]);
    carry = __fadd_rn(delta, __fmul_rn(__fmul_rn(gamma_lam, nd), carry));
    adv[i] = carry;
  }
}

// abar_t = g_t + (gamma*lam)(1-d_{t-1}) abar_{t-1};
// dr = abar, dnv = gamma (1-d) abar
__global__ void gae_bwd(const float* __restrict__ g,
                        const float* __restrict__ d, float* __restrict__ dr,
                        float* __restrict__ dnv, int T, int B, float gamma,
                        float gamma_lam) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float carry = 0.0f;
  for (int t = 0; t < T; ++t) {
    const size_t i = (size_t)t * B + b;
    const float nd = __fsub_rn(1.0f, d[i]);
    const float abar = __fadd_rn(g[i], carry);
    dr[i] = abar;
    dnv[i] = __fmul_rn(__fmul_rn(gamma, nd), abar);
    carry = __fmul_rn(__fmul_rn(gamma_lam, nd), abar);
  }
}

constexpr int kThreads = 256;

}  // namespace

cudaError_t launch_gae_forward(const float* r, const float* v,
                               const float* nv, const float* d, float* adv,
                               int T, int B, float gamma, float gamma_lam,
                               cudaStream_t stream) {
  gae_fwd<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      r, v, nv, d, adv, T, B, gamma, gamma_lam);
  return cudaSuccess;
}

cudaError_t launch_gae_backward(const float* g, const float* d, float* dr,
                                float* dnv, int T, int B, float gamma,
                                float gamma_lam, cudaStream_t stream) {
  gae_bwd<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      g, d, dr, dnv, T, B, gamma, gamma_lam);
  return cudaSuccess;
}
