// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel of repro/kernels/ssd/kernel.py:
//   ssd_chunk <- ssd_intra_chunk / _ssd_chunk_kernel
//
// Layout: xw (B,T,H,P) dt-weighted inputs and b, c (B,T,N), float32 or
// bfloat16 (one dtype for the three); la (B,T,H) float32 log decays.
// Outputs: y (B,T,H,P) in xw's dtype, states (B,nc,H,P,N) float32,
// chunk decay (B,nc,H) float32, with nc = T / L chunks of L steps.
//
// Per (b, chunk, head), all in float32 as the reference:
//   cs    = cumsum(la) over the chunk
//   M     = (C.B^T) * tril(exp(cs_i - cs_j))          (L x L)
//   y     = M . X                                       (L x P)
//   state = sum_j x_j (b_j exp(cs_L - cs_j))^T          (P x N)
//   decay = exp(cs_L)
//
// Design. C.B^T does not depend on the head (b and c are shared across
// heads), so one block owns one (b, chunk) and a group of G heads: it
// computes C.B^T once into shared memory and reuses it for its G heads,
// where the reference's grid recomputes it per head. The wrapper picks G
// so that the grid still fills the card (at mamba2-780m widths, B=2 and
// T=8192: G=16 of 48 heads, 384 blocks). Shared memory at L=128, P=64,
// N=128: C.B^T (64 KB), a buffer that first holds C and then each head's
// M (64 KB), B with rows padded to N+4 floats (66 KB), X (32 KB) and cs --
// 226.5 KB, under the 227 KB a block may opt in to with
// cudaFuncSetAttribute. The cumulative sum is a warp scan. Thread (ty, tx)
// of 16 x 16 owns rows ty + 16r of each product and float4 columns tx +
// 16k; every product is an FFMA chain in fp32 (no tensor cores, no TF32,
// no fast-math), to hold the reference's 2e-4.
//
// Bound: per (b, chunk) the work is ~2 L^2 N + G (2 L^2 P + 2 L P N) FLOP
// over ~(2 L N + G (L P + P N)) x 4 bytes, so at mamba2 widths it is
// bound by operations on the FFMA units; the triangular half of M . X is
// computed (and multiplied by zero) to keep the loop uniform.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NTHREADS = 256;   // 16 x 16
constexpr int MAX_RL = 8;       // L / 16 <= 8: L <= 128
constexpr int MAX_K = 2;        // float4 columns per thread: P, N <= 128

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void fma4(float a, const float4& b, float4& acc) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

size_t smem_floats(int L, int P, int N) {
  const size_t lmax = (size_t)L * (L > N ? L : N);
  return (size_t)L * L + lmax + (size_t)L * (N + 4) + (size_t)L * P + L;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    ssd_chunk(const T* __restrict__ xw, const float* __restrict__ la,
              const T* __restrict__ bm, const T* __restrict__ cm,
              T* __restrict__ y, float* __restrict__ st,
              float* __restrict__ cd, int Tt, int H, int P, int N, int L,
              int G) {
  extern __shared__ float4 smem4[];
  const int NS = N + 4;
  const size_t lmax = (size_t)L * (L > N ? L : N);
  float* cb_s = reinterpret_cast<float*>(smem4);  // L x L
  float* m_s = cb_s + (size_t)L * L;              // L x N (C), then L x L (M)
  float* b_s = m_s + lmax;                        // L x NS
  float* x_s = b_s + (size_t)L * NS;              // L x P
  float* cs_s = x_s + (size_t)L * P;              // L

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ci = blockIdx.x, h0 = blockIdx.y * G, bi = blockIdx.z;
  const int nc = Tt / L, RL = L / 16, P4 = P / 4, N4 = N / 4;
  const size_t row0 = (size_t)bi * Tt + (size_t)ci * L;  // first (b, t) row

  for (int e = tid; e < L * N; e += NTHREADS) {
    const int i = e / N, n = e - i * N;
    b_s[i * NS + n] = to_f32(bm[(row0 + i) * N + n]);
    m_s[i * N + n] = to_f32(cm[(row0 + i) * N + n]);
  }
  __syncthreads();

  // C.B^T, once for the block's heads
  {
    float acc[MAX_RL][MAX_RL];
#pragma unroll
    for (int r = 0; r < MAX_RL; ++r)
#pragma unroll
      for (int c = 0; c < MAX_RL; ++c) acc[r][c] = 0.0f;
    for (int n = 0; n < N; n += 4) {
      float4 bv[MAX_RL];
#pragma unroll
      for (int c = 0; c < MAX_RL; ++c)
        if (c < RL)
          bv[c] = *reinterpret_cast<const float4*>(&b_s[(tx + 16 * c) * NS + n]);
#pragma unroll
      for (int r = 0; r < MAX_RL; ++r) {
        if (r >= RL) break;
        const float4 cv =
            *reinterpret_cast<const float4*>(&m_s[(ty + 16 * r) * N + n]);
#pragma unroll
        for (int c = 0; c < MAX_RL; ++c) {
          if (c >= RL) break;
          acc[r][c] = fmaf(cv.x, bv[c].x, acc[r][c]);
          acc[r][c] = fmaf(cv.y, bv[c].y, acc[r][c]);
          acc[r][c] = fmaf(cv.z, bv[c].z, acc[r][c]);
          acc[r][c] = fmaf(cv.w, bv[c].w, acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_RL; ++r)
#pragma unroll
      for (int c = 0; c < MAX_RL; ++c)
        if (r < RL && c < RL)
          cb_s[(ty + 16 * r) * L + tx + 16 * c] = acc[r][c];
  }

  for (int g = 0; g < G; ++g) {
    const int h = h0 + g;
    __syncthreads();  // C / the previous head's M, X and cs are consumed
    for (int e = tid; e < L * P; e += NTHREADS) {
      const int i = e / P, p = e - i * P;
      x_s[e] = to_f32(xw[((row0 + i) * H + h) * P + p]);
    }
    if (tid < 32) {  // inclusive cumsum of la over the chunk: a warp scan
      const int per = (L + 31) / 32;  // <= 4
      float loc[4];
      float run = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = tid * per + e;
        if (e < per && i < L) run += la[(row0 + i) * H + h];
        loc[e] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, tot, off);
        if (tid >= off) tot += up;
      }
      const float excl = tot - run;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = tid * per + e;
        if (e < per && i < L) cs_s[i] = excl + loc[e];
      }
    }
    __syncthreads();

    for (int e = tid; e < L * L; e += NTHREADS) {
      const int i = e / L, j = e - i * L;
      m_s[e] = j <= i ? cb_s[e] * expf(cs_s[i] - cs_s[j]) : 0.0f;
    }
    __syncthreads();

    // y = M . X
    {
      float4 acc[MAX_RL][MAX_K];
#pragma unroll
      for (int r = 0; r < MAX_RL; ++r)
#pragma unroll
        for (int k = 0; k < MAX_K; ++k) acc[r][k] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < L; j += 4) {
        float4 mv[MAX_RL];
#pragma unroll
        for (int r = 0; r < MAX_RL; ++r)
          if (r < RL)
            mv[r] = *reinterpret_cast<const float4*>(&m_s[(ty + 16 * r) * L + j]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int k = 0; k < MAX_K; ++k) {
            const int pc = tx + 16 * k;
            if (pc >= P4) break;
            const float4 xv =
                *reinterpret_cast<const float4*>(&x_s[(j + jj) * P + 4 * pc]);
#pragma unroll
            for (int r = 0; r < MAX_RL; ++r) {
              if (r >= RL) break;
              const float mm = jj == 0 ? mv[r].x
                               : jj == 1 ? mv[r].y
                               : jj == 2 ? mv[r].z
                                         : mv[r].w;
              fma4(mm, xv, acc[r][k]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MAX_RL; ++r) {
        if (r >= RL) break;
        const int i = ty + 16 * r;
        T* yrow = y + ((row0 + i) * H + h) * P;
#pragma unroll
        for (int k = 0; k < MAX_K; ++k) {
          const int pc = tx + 16 * k;
          if (pc >= P4) break;
          store_as(yrow + 4 * pc + 0, acc[r][k].x);
          store_as(yrow + 4 * pc + 1, acc[r][k].y);
          store_as(yrow + 4 * pc + 2, acc[r][k].z);
          store_as(yrow + 4 * pc + 3, acc[r][k].w);
        }
      }
    }

    // chunk state (P x N) = sum_j x_j (b_j w_j)^T, w_j = exp(cs_L - cs_j)
    {
      const float cs_last = cs_s[L - 1];
      const int RP = (P + 15) / 16;
      float4 acc[MAX_RL][MAX_K];
#pragma unroll
      for (int r = 0; r < MAX_RL; ++r)
#pragma unroll
        for (int k = 0; k < MAX_K; ++k) acc[r][k] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < L; ++j) {
        const float w = expf(cs_last - cs_s[j]);
        float4 bw[MAX_K];
#pragma unroll
        for (int k = 0; k < MAX_K; ++k) {
          const int nc4 = tx + 16 * k;
          if (nc4 < N4) {
            const float4 bv =
                *reinterpret_cast<const float4*>(&b_s[j * NS + 4 * nc4]);
            bw[k] = make_float4(bv.x * w, bv.y * w, bv.z * w, bv.w * w);
          }
        }
#pragma unroll
        for (int r = 0; r < MAX_RL; ++r) {
          const int p = ty + 16 * r;
          if (r >= RP || p >= P) break;
          const float xv = x_s[j * P + p];
#pragma unroll
          for (int k = 0; k < MAX_K; ++k)
            if (tx + 16 * k < N4) fma4(xv, bw[k], acc[r][k]);
        }
      }
      float* sbase = st + (((size_t)bi * nc + ci) * H + h) * P * N;
#pragma unroll
      for (int r = 0; r < MAX_RL; ++r) {
        const int p = ty + 16 * r;
        if (r >= RP || p >= P) break;
#pragma unroll
        for (int k = 0; k < MAX_K; ++k) {
          const int nc4 = tx + 16 * k;
          if (nc4 < N4)
            *reinterpret_cast<float4*>(&sbase[(size_t)p * N + 4 * nc4]) =
                acc[r][k];
        }
      }
      if (tid == 0) cd[((size_t)bi * nc + ci) * H + h] = expf(cs_last);
    }
  }
}

}  // namespace

size_t ssd_smem_bytes(int L, int P, int N) {
  return smem_floats(L, P, N) * sizeof(float);
}

// Requires L % 16 == 0, L <= 128, P % 4 == 0, P <= 128, N % 4 == 0,
// N <= 128, T % L == 0, H % G == 0 (the wrapper checks these).
cudaError_t launch_ssd_chunk(const void* xw, const float* la, const void* b,
                             const void* c, void* y, float* st, float* cd,
                             bool bf16, int B, int T, int H, int P, int N,
                             int L, int G, cudaStream_t stream) {
  if (L % 16 || L > 16 * MAX_RL || P % 4 || P > 64 * MAX_K || N % 4 ||
      N > 64 * MAX_K || T % L || G <= 0 || H % G)
    return cudaErrorInvalidValue;
  const size_t smem = ssd_smem_bytes(L, P, N);
  const dim3 grid(T / L, H / G, B);
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(ssd_chunk<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    ssd_chunk<__nv_bfloat16><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(xw), la,
        static_cast<const __nv_bfloat16*>(b),
        static_cast<const __nv_bfloat16*>(c), static_cast<__nv_bfloat16*>(y),
        st, cd, T, H, P, N, L, G);
  } else {
    err = cudaFuncSetAttribute(ssd_chunk<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    ssd_chunk<float><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const float*>(xw), la, static_cast<const float*>(b),
        static_cast<const float*>(c), static_cast<float*>(y), st, cd, T, H,
        P, N, L, G);
  }
  return cudaGetLastError();
}
