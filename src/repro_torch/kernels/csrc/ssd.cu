// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel of repro/kernels/ssd/kernel.py:
//   ssd_chunk, ssd_tiled_y + ssd_tiled_state,
//   ssd_long_y + ssd_long_state (ssd_chunk_f32_long)
//             <- ssd_intra_chunk / _ssd_chunk_kernel
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
// The tiled pair (ssd_tiled_y, ssd_tiled_state) takes every other shape:
// any chunk L that divides T, any P and N, float32 or bf16 -- the shapes
// whose whole-chunk tiles above overflow a block (at L=256 the L x L score
// tile alone is 256 KB) or break its multiples of 16 and 4. Each block
// computes the chunk's cumulative sum itself (a warp scan, 32 steps at a
// time), then:
//  * ssd_tiled_y: one block per (b, chunk, strip of 32 query rows, head,
//    256 columns of P). Over the strip's live key tiles of 32 (j <= i:
//    tiles past the strip are skipped), C.B^T is summed over N in chunks
//    of 64 staged in shared memory, weighted by exp(cs_i - cs_j) into a
//    32 x 32 tile of M, and M.X is added into registers (2 rows x 16
//    columns a thread);
//  * ssd_tiled_state: one block per (b, chunk, 64 x 64 tile of the P x N
//    state, head), summing x_j (b_j w_j)^T over the chunk in steps of 32
//    rows; the tile at (0, 0) also writes the chunk decay.
// Shared memory is about 54 KB plus the L floats of cs, whatever P and N.
// It recomputes C.B^T per head and per 256 columns of P, and is FFMA on
// fp32 like ssd_chunk: the simple design, right for every shape.
//
// The long-chunk pair (ssd_long_y, ssd_long_state; the route
// ssd_chunk_f32_long): float32 at chunk 256, P 64, N 64 or 128 --
// mamba2-780m's and zamba2-1.2b's layers at Mamba-2's own default chunk.
// It replaces the tiled pair there, which recomputes C.B^T for every head
// and reads each operand with scalar loads for 2 FMAs (7.36 ms at
// 2x8192x48x64, N 128; bound ~27 GFLOP at 67 TFLOP/s of FFMA: 0.41 ms).
// Every product stays FFMA on fp32 (TF32 would break the reference's
// 2e-4), so the design is the FFMA units' register tile:
//  * ssd_long_y: one block per (b, chunk, strip of 64 query rows, G
//    heads), the strip with the most key tiles first. It computes the
//    strip's C.B^T against its live key tiles only (j <= i: 1 to 4 tiles
//    of 64) once into shared memory, transposed (64 KB at the last strip),
//    and reuses it for its G heads. Four groups of 64 threads then take a
//    head each: per key tile the group loads X's 64 x 64 tile into
//    registers, builds M^T = (C.B^T * exp(cs_i - cs_j))^T (zero past the
//    diagonal) in shared memory while the loads fly, stores X, and adds M.X
//    into an 8 x 8 register tile a thread: two float4 reads of M and two
//    of X for every 64 FMAs. The groups synchronise on named barriers of
//    their own, so one group's loads overlap the others' products. 201 KB
//    of shared memory: one block an SM.
//  * ssd_long_state: one block per (b, chunk) and 256 / N heads (a group
//    of N threads a head): w_j = exp(cs_L - cs_j) and the decay from one
//    warp's scan, then the state X^T (B w) over the chunk in 64-row tiles,
//    x_j w_j staged per head and B once for the block, the same 8 x 8
//    tile. Each state element is one thread's FFMA chain over j = 0..255,
//    so the bits repeat.
// The wrapper picks G so that the y grid gives each SM a few blocks.
//
// Bound: per (b, chunk) the work is ~2 L^2 N + G (2 L^2 P + 2 L P N) FLOP
// over ~(2 L N + G (L P + P N)) x 4 bytes, so at mamba2 widths it is
// bound by operations on the FFMA units; the triangular half of M . X is
// computed (and multiplied by zero) to keep the loop uniform.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// the tiled pair: any L, P, N
// ---------------------------------------------------------------------------
constexpr int TR = 32;        // ssd_tiled_y: query rows a strip, keys a tile
constexpr int TNC = 64;       // ssd_tiled_y: N a chunk of C.B^T
constexpr int TPC = 256;      // ssd_tiled_y: columns of P a block
constexpr int TKP = TPC / 16; // ssd_tiled_y: columns a thread
constexpr int TS = 64;        // ssd_tiled_state: rows and columns a tile
constexpr int TJ = 32;        // ssd_tiled_state: chunk rows a step

// inclusive cumsum of la over the chunk into cs_s[0, L), by warp 0, 32
// steps at a time in order; the caller synchronises
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ la,
                                             size_t row0, int H, int h,
                                             int L, float* cs_s) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  float carry = 0.0f;
  for (int base = 0; base < L; base += 32) {
    const int i = base + lane;
    float v = i < L ? la[(row0 + i) * H + h] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    v += carry;
    if (i < L) cs_s[i] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

size_t tiled_y_smem_floats(int L, int P) {
  const int pc = P < TPC ? P : TPC;
  return (size_t)L + 2 * TR * (TNC + 1) + TR * (TR + 1) + (size_t)TR * pc;
}

size_t tiled_state_smem_floats(int L) {
  return (size_t)L + 2 * TJ * TS;
}

// grid (nc * strips, H * P tiles, B)
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    ssd_tiled_y(const T* __restrict__ xw, const float* __restrict__ la,
                const T* __restrict__ bm, const T* __restrict__ cm,
                T* __restrict__ y, int Tt, int H, int P, int N, int L) {
  extern __shared__ float4 smem4[];
  float* cs_s = reinterpret_cast<float*>(smem4);   // L
  float* c_s = cs_s + L;                           // TR x (TNC + 1)
  float* b_s = c_s + TR * (TNC + 1);               // TR x (TNC + 1)
  float* m_s = b_s + TR * (TNC + 1);               // TR x (TR + 1)
  float* x_s = m_s + TR * (TR + 1);                // TR x pc
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int strips = (L + TR - 1) / TR, ptiles = (P + TPC - 1) / TPC;
  const int ci = blockIdx.x / strips, i0 = (blockIdx.x % strips) * TR;
  const int h = blockIdx.y / ptiles, p0 = (blockIdx.y % ptiles) * TPC;
  const int bi = blockIdx.z;
  const int pc = min(TPC, P - p0);
  const size_t row0 = (size_t)bi * Tt + (size_t)ci * L;
  chunk_cumsum(la, row0, H, h, L, cs_s);
  __syncthreads();

  float acc[2][TKP];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int k = 0; k < TKP; ++k) acc[a][k] = 0.0f;
  const int k_end = min(L, i0 + TR);
  for (int k0 = 0; k0 < k_end; k0 += TR) {
    float sacc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    for (int n0 = 0; n0 < N; n0 += TNC) {
      const int nn = min(TNC, N - n0);
      __syncthreads();   // the previous chunk's (or tile's) reads are done
      for (int e = tid; e < TR * TNC; e += NTHREADS) {
        const int r = e / TNC, n = e - r * TNC;
        const bool in_n = n < nn;
        c_s[r * (TNC + 1) + n] = (in_n && i0 + r < L)
            ? to_f32(cm[(row0 + i0 + r) * N + n0 + n]) : 0.0f;
        b_s[r * (TNC + 1) + n] = (in_n && k0 + r < L)
            ? to_f32(bm[(row0 + k0 + r) * N + n0 + n]) : 0.0f;
      }
      __syncthreads();
      for (int n = 0; n < nn; ++n) {
        const float c0 = c_s[ty * (TNC + 1) + n];
        const float c1 = c_s[(ty + 16) * (TNC + 1) + n];
        const float b0 = b_s[tx * (TNC + 1) + n];
        const float b1 = b_s[(tx + 16) * (TNC + 1) + n];
        sacc[0][0] = fmaf(c0, b0, sacc[0][0]);
        sacc[0][1] = fmaf(c0, b1, sacc[0][1]);
        sacc[1][0] = fmaf(c1, b0, sacc[1][0]);
        sacc[1][1] = fmaf(c1, b1, sacc[1][1]);
      }
    }
    // M = C.B^T * exp(cs_i - cs_j) on j <= i; the tile of X beside it
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + ty + 16 * a, j = k0 + tx + 16 * c;
        m_s[(ty + 16 * a) * (TR + 1) + tx + 16 * c] =
            (j <= i && i < L)
                ? sacc[a][c] * expf(cs_s[i] - cs_s[j]) : 0.0f;
      }
    for (int e = tid; e < TR * pc; e += NTHREADS) {
      const int j = e / pc, p = e - j * pc;
      x_s[j * pc + p] = k0 + j < L
          ? to_f32(xw[((row0 + k0 + j) * H + h) * P + p0 + p]) : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < TR; ++j) {
      const float m0 = m_s[ty * (TR + 1) + j];
      const float m1 = m_s[(ty + 16) * (TR + 1) + j];
#pragma unroll
      for (int k = 0; k < TKP; ++k) {
        const int p = tx + 16 * k;
        if (p < pc) {
          const float xv = x_s[j * pc + p];
          acc[0][k] = fmaf(m0, xv, acc[0][k]);
          acc[1][k] = fmaf(m1, xv, acc[1][k]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= L) continue;
    T* yrow = y + ((row0 + i) * H + h) * P + p0;
#pragma unroll
    for (int k = 0; k < TKP; ++k) {
      const int p = tx + 16 * k;
      if (p < pc) store_as(yrow + p, acc[a][k]);
    }
  }
}

// grid (nc * P tiles * N tiles, H, B)
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    ssd_tiled_state(const T* __restrict__ xw, const float* __restrict__ la,
                    const T* __restrict__ bm, float* __restrict__ st,
                    float* __restrict__ cd, int Tt, int H, int P, int N,
                    int L) {
  extern __shared__ float4 smem4[];
  float* cs_s = reinterpret_cast<float*>(smem4);   // L
  float* x_s = cs_s + L;                           // TJ x TS
  float* b_s = x_s + TJ * TS;                      // TJ x TS
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ptiles = (P + TS - 1) / TS, ntiles = (N + TS - 1) / TS;
  const int nc = Tt / L, tiles = ptiles * ntiles;
  const int ci = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int p0 = (tile / ntiles) * TS, n0 = (tile % ntiles) * TS;
  const int h = blockIdx.y, bi = blockIdx.z;
  const size_t row0 = (size_t)bi * Tt + (size_t)ci * L;
  chunk_cumsum(la, row0, H, h, L, cs_s);
  __syncthreads();
  const float cs_last = cs_s[L - 1];

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
  for (int j0 = 0; j0 < L; j0 += TJ) {
    __syncthreads();   // the previous step's reads are done
    for (int e = tid; e < TJ * TS; e += NTHREADS) {
      const int j = e / TS, q = e - j * TS, row = j0 + j;
      const bool in_j = row < L;
      x_s[e] = (in_j && p0 + q < P)
          ? to_f32(xw[((row0 + row) * H + h) * P + p0 + q]) : 0.0f;
      b_s[e] = (in_j && n0 + q < N)
          ? to_f32(bm[(row0 + row) * N + n0 + q]) *
                expf(cs_last - cs_s[row]) : 0.0f;
    }
    __syncthreads();
    const int jn = min(TJ, L - j0);
    for (int j = 0; j < jn; ++j) {
      float xv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = x_s[j * TS + ty + 16 * a];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = b_s[j * TS + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(xv[a], bv[c], acc[a][c]);
    }
  }
  float* sbase = st + (((size_t)bi * nc + ci) * H + h) * P * N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int p = p0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (p < P && n < N) sbase[(size_t)p * N + n] = acc[a][c];
    }
  }
  if (tile == 0 && tid == 0)
    cd[((size_t)bi * nc + ci) * H + h] = expf(cs_last);
}

template <typename T>
cudaError_t launch_tiled(const void* xw, const float* la, const void* b,
                         const void* c, void* y, float* st, float* cd, int B,
                         int T_, int H, int P, int N, int L,
                         cudaStream_t stream) {
  const int nc = T_ / L;
  const size_t ysmem = tiled_y_smem_floats(L, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_tiled_y<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ysmem);
  if (err != cudaSuccess) return err;
  const dim3 ygrid(nc * ((L + TR - 1) / TR), H * ((P + TPC - 1) / TPC), B);
  ssd_tiled_y<T><<<ygrid, NTHREADS, ysmem, stream>>>(
      static_cast<const T*>(xw), la, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), T_, H, P, N, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t ssmem = tiled_state_smem_floats(L) * sizeof(float);
  err = cudaFuncSetAttribute(ssd_tiled_state<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ssmem);
  if (err != cudaSuccess) return err;
  const dim3 sgrid(nc * ((P + TS - 1) / TS) * ((N + TS - 1) / TS), H, B);
  ssd_tiled_state<T><<<sgrid, NTHREADS, ssmem, stream>>>(
      static_cast<const T*>(xw), la, static_cast<const T*>(b), st, cd, T_, H,
      P, N, L);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ssd_chunk_f32_long: float32 at P 64, N 64 or 128, chunk 256
// ---------------------------------------------------------------------------
constexpr int LL = 256;          // the chunk
constexpr int LS = 64;           // query rows a strip, keys a tile
constexpr int LSTRIPS = LL / LS;
constexpr int LP = 64;           // head_dim
constexpr int LGROUPS = 4;       // ssd_long_y: heads in flight, 64 threads each
constexpr int CBS = LS + 4;      // row stride of the strip's (C.B^T)^T

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(group + 1) : "memory");
}

// inclusive cumsum of head h's la over the chunk into cs[0, LL), by one
// warp (lane 0..31): the 8 loads first, then 8 warp scans in order
__device__ __forceinline__ void long_cumsum(const float* __restrict__ la,
                                            size_t row0, int H, int h,
                                            int lane, float* cs) {
  float v[LL / 32];
#pragma unroll
  for (int k = 0; k < LL / 32; ++k) v[k] = la[(row0 + 32 * k + lane) * H + h];
  float carry = 0.0f;
#pragma unroll
  for (int k = 0; k < LL / 32; ++k) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v[k], off);
      if (lane >= off) v[k] += up;
    }
    v[k] += carry;
    cs[32 * k + lane] = v[k];
    carry = __shfl_sync(0xffffffffu, v[k], 31);
  }
}

// 8 x 8 outputs += a (8 rows) x b (8 columns), each a pair of float4
__device__ __forceinline__ void outer8(const float4& a0, const float4& a1,
                                       const float4& b0, const float4& b1,
                                       float (&acc)[8][8]) {
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
}

size_t long_y_smem_floats() {
  // cs per group | (C.B^T)^T of the strip, LL x CBS | per group M^T and X
  // (LS x LS, LS x LP); C and B (LS x (N+4) each) are staged over the
  // group tiles before the heads' loop
  return (size_t)LGROUPS * LL + (size_t)LL * CBS +
         (size_t)LGROUPS * (LS * LS + LS * LP);
}

size_t long_state_smem_floats(int N) {
  const int hs = NTHREADS / N;   // heads a block
  // w per head | B (LS x N) | x w per head (LS x LP)
  return (size_t)hs * LL + (size_t)LS * N + (size_t)hs * LS * LP;
}

// y for one strip of 64 query rows of one (b, chunk) and G heads.
// grid (LSTRIPS x head groups, nc, B): the last strip (the most key
// tiles) first.
__global__ void __launch_bounds__(NTHREADS, 1)
    ssd_long_y(const float* __restrict__ xw, const float* __restrict__ la,
               const float* __restrict__ bm, const float* __restrict__ cm,
               float* __restrict__ y, int Tt, int H, int N, int G) {
  extern __shared__ float4 smem4[];
  float* cs_all = reinterpret_cast<float*>(smem4);  // LGROUPS x LL
  float* cbt = cs_all + LGROUPS * LL;               // cbt[j * CBS + i]
  float* tiles = cbt + LL * CBS;
  const int tid = threadIdx.x;
  const int s = LSTRIPS - 1 - (int)(blockIdx.x % LSTRIPS);
  const int hg = blockIdx.x / LSTRIPS, ci = blockIdx.y, bi = blockIdx.z;
  const int i0 = s * LS, NS = N + 4, N4 = N / 4;
  const size_t row0 = (size_t)bi * Tt + (size_t)ci * LL;

  // (C.B^T)^T of the strip against its live key tiles, once for G heads:
  // thread (ty, tx) owns rows ty + 16r and keys tx + 16c of each tile
  {
    const int tx = tid & 15, ty = tid >> 4;
    float* c_s = tiles;             // LS x NS
    float* b_s = tiles + LS * NS;   // LS x NS
    for (int e = tid; e < LS * N4; e += NTHREADS) {
      const int i = e / N4, n4 = e - i * N4;
      *reinterpret_cast<float4*>(&c_s[i * NS + 4 * n4]) =
          *reinterpret_cast<const float4*>(&cm[(row0 + i0 + i) * N + 4 * n4]);
    }
    for (int kt = 0; kt <= s; ++kt) {
      __syncthreads();   // the previous tile's reads of b_s are done
      for (int e = tid; e < LS * N4; e += NTHREADS) {
        const int j = e / N4, n4 = e - j * N4;
        *reinterpret_cast<float4*>(&b_s[j * NS + 4 * n4]) =
            *reinterpret_cast<const float4*>(
                &bm[(row0 + kt * LS + j) * N + 4 * n4]);
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(&c_s[(ty + 16 * r) * NS + n]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          bv[c] = *reinterpret_cast<const float4*>(&b_s[(tx + 16 * c) * NS + n]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(cv[r].x, bv[c].x, acc[r][c]);
            acc[r][c] = fmaf(cv[r].y, bv[c].y, acc[r][c]);
            acc[r][c] = fmaf(cv[r].z, bv[c].z, acc[r][c]);
            acc[r][c] = fmaf(cv[r].w, bv[c].w, acc[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          cbt[(kt * LS + tx + 16 * c) * CBS + ty + 16 * r] = acc[r][c];
    }
    __syncthreads();   // C.B^T is whole; the staging area is free
  }

  // four groups of 64 threads, one head each at a time; thread (ti, tp)
  // of a group owns rows {4ti, 32 + 4ti} + 0..3 and columns
  // {4tp, 32 + 4tp} + 0..3 of the head's 64 x 64 strip of y
  const int q = tid >> 6, gt = tid & 63, lane = tid & 31;
  const int ti = gt >> 3, tp = gt & 7;
  float* cs = cs_all + q * LL;
  float* mt = tiles + q * (LS * LS + LS * LP);   // mt[j * LS + i]
  float* xs = mt + LS * LS;                      // xs[j * LP + p]
  for (int g = q; g < G; g += LGROUPS) {
    const int h = hg * G + g;
    if (h >= H) break;
    group_sync(q);     // the previous head's cs, M and X are consumed
    if (gt < 32) long_cumsum(la, row0, H, h, lane, cs);
    group_sync(q);
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
    for (int kt = 0; kt <= s; ++kt) {
      // X's tile kt into registers; its loads run while M is built
      // thread gt moves float4 column gt % 16 of rows gt / 16 + 4k
      const int c4 = gt & 15, jr = gt >> 4;
      float4 xr[LS / 4];
#pragma unroll
      for (int k = 0; k < LS / 4; ++k)
        xr[k] = *reinterpret_cast<const float4*>(
            &xw[((row0 + kt * LS + jr + 4 * k) * H + h) * LP + 4 * c4]);
      // M^T[j][i] = C.B^T[i][j] exp(cs_i - cs_j), 0 past the diagonal
      const float4 ci = *reinterpret_cast<const float4*>(&cs[i0 + 4 * c4]);
#pragma unroll 4
      for (int k = 0; k < LS / 4; ++k) {
        const int j = jr + 4 * k, i4 = c4;
        const float4 cb =
            *reinterpret_cast<const float4*>(&cbt[(kt * LS + j) * CBS + 4 * i4]);
        const float cj = cs[kt * LS + j];
        float4 m = make_float4(cb.x * expf(ci.x - cj), cb.y * expf(ci.y - cj),
                               cb.z * expf(ci.z - cj), cb.w * expf(ci.w - cj));
        if (kt == s) {   // the diagonal tile: keys j <= i only
          const int i = 4 * i4;
          if (j > i) m.x = 0.0f;
          if (j > i + 1) m.y = 0.0f;
          if (j > i + 2) m.z = 0.0f;
          if (j > i + 3) m.w = 0.0f;
        }
        *reinterpret_cast<float4*>(&mt[j * LS + 4 * i4]) = m;
      }
#pragma unroll
      for (int k = 0; k < LS / 4; ++k)
        *reinterpret_cast<float4*>(&xs[(jr + 4 * k) * LP + 4 * c4]) = xr[k];
      group_sync(q);
#pragma unroll 4
      for (int j = 0; j < LS; ++j)
        outer8(*reinterpret_cast<const float4*>(&mt[j * LS + 4 * ti]),
               *reinterpret_cast<const float4*>(&mt[j * LS + 32 + 4 * ti]),
               *reinterpret_cast<const float4*>(&xs[j * LP + 4 * tp]),
               *reinterpret_cast<const float4*>(&xs[j * LP + 32 + 4 * tp]),
               acc);
      group_sync(q);   // M and X are read
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = (r < 4 ? 4 * ti : 32 + 4 * ti - 4) + r;
      float* yrow = y + ((row0 + i0 + i) * H + h) * LP;
      *reinterpret_cast<float4*>(&yrow[4 * tp]) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(&yrow[32 + 4 * tp]) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
}

// the chunk states and decays of one (b, chunk) and NTHREADS / N heads,
// one group of N threads a head; grid (head groups, nc, B)
__global__ void __launch_bounds__(NTHREADS, 2)
    ssd_long_state(const float* __restrict__ xw, const float* __restrict__ la,
                   const float* __restrict__ bm, float* __restrict__ st,
                   float* __restrict__ cd, int Tt, int H, int N) {
  extern __shared__ float4 smem4[];
  const int hs = NTHREADS / N, NG = N / 8, N4 = N / 4;
  float* w_s = reinterpret_cast<float*>(smem4);   // hs x LL
  float* b_s = w_s + hs * LL;                     // LS x N
  float* x_s = b_s + LS * N;                      // hs x LS x LP
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ci = blockIdx.y, bi = blockIdx.z, nc = Tt / LL;
  const size_t row0 = (size_t)bi * Tt + (size_t)ci * LL;
  // w_j = exp(cs_L - cs_j) and the decay exp(cs_L): warp k scans head k
  if (warp < hs) {
    const int h = blockIdx.x * hs + warp;
    float* w = w_s + warp * LL;
    if (h < H) {
      long_cumsum(la, row0, H, h, lane, w);
      __syncwarp();
      const float cs_last = w[LL - 1];
      __syncwarp();   // every lane has read cs_L before w overwrites it
      for (int j = lane; j < LL; j += 32) w[j] = expf(cs_last - w[j]);
      if (lane == 0) cd[((size_t)bi * nc + ci) * H + h] = expf(cs_last);
    } else {
      for (int j = lane; j < LL; j += 32) w[j] = 0.0f;
    }
  }
  // thread (tr, tn) of head slot q owns the state's rows {4tr, 32 + 4tr}
  // + 0..3 and columns {4tn, N/2 + 4tn} + 0..3
  const int q = tid / N, gt = tid - q * N, tr = gt / NG, tn = gt - tr * NG;
  const int h = blockIdx.x * hs + q;
  float* xq = x_s + q * LS * LP;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  for (int jt = 0; jt < LSTRIPS; ++jt) {
    __syncthreads();   // w is written; the previous tile is read
    for (int e = tid; e < LS * N4; e += NTHREADS) {
      const int j = e / N4, n4 = e - j * N4;
      *reinterpret_cast<float4*>(&b_s[j * N + 4 * n4]) =
          *reinterpret_cast<const float4*>(
              &bm[(row0 + jt * LS + j) * N + 4 * n4]);
    }
    for (int e = gt; e < LS * LP / 4; e += N) {   // x_j w_j of head h
      const int j = e >> 4, p4 = e & 15;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (h < H) {
        v = *reinterpret_cast<const float4*>(
            &xw[((row0 + jt * LS + j) * H + h) * LP + 4 * p4]);
        const float wj = w_s[q * LL + jt * LS + j];
        v = make_float4(v.x * wj, v.y * wj, v.z * wj, v.w * wj);
      }
      *reinterpret_cast<float4*>(&xq[j * LP + 4 * p4]) = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < LS; ++j)
      outer8(*reinterpret_cast<const float4*>(&xq[j * LP + 4 * tr]),
             *reinterpret_cast<const float4*>(&xq[j * LP + 32 + 4 * tr]),
             *reinterpret_cast<const float4*>(&b_s[j * N + 4 * tn]),
             *reinterpret_cast<const float4*>(&b_s[j * N + N / 2 + 4 * tn]),
             acc);
  }
  if (h >= H) return;
  float* sbase = st + (((size_t)bi * nc + ci) * H + h) * LP * N;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int p = (r < 4 ? 4 * tr : 32 + 4 * tr - 4) + r;
    *reinterpret_cast<float4*>(&sbase[(size_t)p * N + 4 * tn]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(&sbase[(size_t)p * N + N / 2 + 4 * tn]) =
        make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
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

// The larger of the tiled pair's two blocks.
size_t ssd_tiled_smem_bytes(int L, int P) {
  const size_t y = tiled_y_smem_floats(L, P), s = tiled_state_smem_floats(L);
  return (y > s ? y : s) * sizeof(float);
}

// Any L >= 1 that divides T, any P, N >= 1 (the wrapper checks the shared
// memory of the cumulative sum, L floats).
cudaError_t launch_ssd_chunk_tiled(const void* xw, const float* la,
                                   const void* b, const void* c, void* y,
                                   float* st, float* cd, bool bf16, int B,
                                   int T, int H, int P, int N, int L,
                                   cudaStream_t stream) {
  if (L < 1 || T % L || P < 1 || N < 1 || B < 1 || H < 1)
    return cudaErrorInvalidValue;
  if (bf16)
    return launch_tiled<__nv_bfloat16>(xw, la, b, c, y, st, cd, B, T, H, P,
                                       N, L, stream);
  return launch_tiled<float>(xw, la, b, c, y, st, cd, B, T, H, P, N, L,
                             stream);
}

// The larger of the long-chunk pair's two blocks.
size_t ssd_f32_long_smem_bytes(int N) {
  const size_t y = long_y_smem_floats(), s = long_state_smem_floats(N);
  return (y > s ? y : s) * sizeof(float);
}

// float32 only; L 256, P 64, N 64 or 128, T % L == 0, all of xw, b, c
// 16-byte aligned (float4 loads); G >= 1 heads a block of ssd_long_y (the
// last group may be short).
cudaError_t launch_ssd_chunk_f32_long(const float* xw, const float* la,
                                      const float* b, const float* c,
                                      float* y, float* st, float* cd, int B,
                                      int T, int H, int P, int N, int L,
                                      int G, cudaStream_t stream) {
  if (L != LL || P != LP || (N != 64 && N != 128) || T % L || B < 1 ||
      H < 1 || G < 1 || T / L > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(xw) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int nc = T / L;
  const size_t ysmem = long_y_smem_floats() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_long_y, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ysmem);
  if (err != cudaSuccess) return err;
  ssd_long_y<<<dim3(LSTRIPS * ((H + G - 1) / G), nc, B), NTHREADS, ysmem,
               stream>>>(xw, la, b, c, y, T, H, N, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int hs = NTHREADS / N;
  const size_t ssmem = long_state_smem_floats(N) * sizeof(float);
  err = cudaFuncSetAttribute(ssd_long_state,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ssmem);
  if (err != cudaSuccess) return err;
  ssd_long_state<<<dim3((H + hs - 1) / hs, nc, B), NTHREADS, ssmem,
                   stream>>>(xw, la, b, st, cd, T, H, N);
  return cudaGetLastError();
}
