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
// read once, each output written once), but at the DIALS shape (T=16,
// B=1600, 100 KB a launch) what a launch waits for is memory latency: the
// serial carry must not wait for a load at every step. So a thread issues
// the loads of a whole tile of TILE steps (every step at T <= TILE) before
// its carry runs over them, all in flight together; at longer T it issues
// the next tile's loads before the carry runs over this one. Blocks of 32
// threads spread B=1600 columns over 50 SMs (256-thread blocks left it on
// 7). Every operation is an explicit round-to-nearest fp32 intrinsic in
// the order the plain torch version evaluates it, so nvcc contracts
// nothing into an FMA and the kernel matches the plain version bit for
// bit.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE = 16;     // steps whose loads are in flight together
constexpr int kThreads = 32;

// the loads of the steps [lo, lo + n) of column b, n <= TILE
template <int K>
__device__ __forceinline__ void load_tile(const float* const (&src)[K],
                                          float (&dst)[K][TILE], int lo,
                                          int n, int B, int b) {
#pragma unroll
  for (int k = 0; k < TILE; ++k)
    if (k < n) {
      const size_t i = (size_t)(lo + k) * B + b;
#pragma unroll
      for (int q = 0; q < K; ++q) dst[q][k] = src[q][i];
    }
}

// adv_t = delta_t + (gamma*lam)(1-d_t) adv_{t+1},
// delta_t = r_t + gamma nv_t (1-d_t) - v_t; tiles from the last, the next
// tile's loads issued before this one's carry
__global__ void __launch_bounds__(kThreads)
    gae_fwd(const float* __restrict__ r, const float* __restrict__ v,
            const float* __restrict__ nv, const float* __restrict__ d,
            float* __restrict__ adv, int T, int B, float gamma,
            float gamma_lam) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B || T <= 0) return;
  const float* const src[4] = {r, v, nv, d};
  float cur[4][TILE], nxt[4][TILE];
  int hi = T, n = min(TILE, hi);
  load_tile(src, cur, hi - n, n, B, b);
  float carry = 0.0f;
  while (hi > 0) {  // the tile [hi - n, hi)
    const int lo = hi - n, n2 = min(TILE, lo);
    if (n2 > 0) load_tile(src, nxt, lo - n2, n2, B, b);
#pragma unroll
    for (int k = TILE - 1; k >= 0; --k)
      if (k < n) {
        const float nd = __fsub_rn(1.0f, cur[3][k]);
        const float delta =
            __fsub_rn(__fadd_rn(cur[0][k],
                                __fmul_rn(__fmul_rn(gamma, cur[2][k]), nd)),
                      cur[1][k]);
        carry = __fadd_rn(delta, __fmul_rn(__fmul_rn(gamma_lam, nd), carry));
        adv[(size_t)(lo + k) * B + b] = carry;
      }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int k = 0; k < TILE; ++k) cur[q][k] = nxt[q][k];
    hi = lo;
    n = n2;
  }
}

// abar_t = g_t + (gamma*lam)(1-d_{t-1}) abar_{t-1};
// dr = abar, dnv = gamma (1-d) abar; tiles from the first, the next
// tile's loads issued before this one's carry
__global__ void __launch_bounds__(kThreads)
    gae_bwd(const float* __restrict__ g, const float* __restrict__ d,
            float* __restrict__ dr, float* __restrict__ dnv, int T, int B,
            float gamma, float gamma_lam) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B || T <= 0) return;
  const float* const src[2] = {g, d};
  float cur[2][TILE], nxt[2][TILE];
  int n = min(TILE, T);
  load_tile(src, cur, 0, n, B, b);
  float carry = 0.0f;
  for (int lo = 0; lo < T; lo += TILE) {  // the tile [lo, lo + n)
    const int n2 = min(TILE, T - lo - n);
    if (n2 > 0) load_tile(src, nxt, lo + n, n2, B, b);
#pragma unroll
    for (int k = 0; k < TILE; ++k)
      if (k < n) {
        const size_t i = (size_t)(lo + k) * B + b;
        const float nd = __fsub_rn(1.0f, cur[1][k]);
        const float abar = __fadd_rn(cur[0][k], carry);
        dr[i] = abar;
        dnv[i] = __fmul_rn(__fmul_rn(gamma, nd), abar);
        carry = __fmul_rn(__fmul_rn(gamma_lam, nd), abar);
      }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int k = 0; k < TILE; ++k) cur[q][k] = nxt[q][k];
    n = n2;
  }
}

}  // namespace

cudaError_t launch_gae_forward(const float* r, const float* v,
                               const float* nv, const float* d, float* adv,
                               int T, int B, float gamma, float gamma_lam,
                               cudaStream_t stream) {
  gae_fwd<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      r, v, nv, d, adv, T, B, gamma, gamma_lam);
  return cudaGetLastError();
}

cudaError_t launch_gae_backward(const float* g, const float* d, float* dr,
                                float* dnv, int T, int B, float gamma,
                                float gamma_lam, cudaStream_t stream) {
  gae_bwd<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      g, d, dr, dnv, T, B, gamma, gamma_lam);
  return cudaGetLastError();
}
