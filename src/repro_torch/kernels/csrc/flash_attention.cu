// Flash attention forward for Hopper (sm_90a), float32 inputs, on FFMA.
//
// Replaces the Pallas kernel of repro/kernels/flash_attention/kernel.py:
//   flash_fwd <- flash_attention_bhsd / _attn_kernel
// for float32 q/k/v (bfloat16 inputs go to flash_attention_sm90.cu, on the
// tensor cores, which float32 could only reach through TF32).
//
// Layout (the reference's flattened rows): q (BH, Tq, D); k, v (BHkv, Tk, D)
// with query row bh reading kv row bh / (BH / BHkv) (GQA: repeated heads are
// never materialised); o (BH, Tq, D). All arithmetic is float32.
//
// Per (q row i, key j): s = (q_i . k_j) * scale, then s = cap*tanh(s/cap)
// when a softcap is given, masked to -1e30 unless j <= i (causal) and
// j > i - window (sliding window); online softmax over key tiles with the
// running max m, normaliser l and accumulator acc; p is zeroed where
// masked; o = acc / max(l, 1e-30).
//
// Design. One block of 256 threads owns one (row bh, 64-query tile) and
// loops over 64-key tiles, but only over the tiles the causal and window
// masks leave live: the range is computed up front from the tile's first
// and last query, so fully masked tiles cost nothing (the reference skips
// them with pl.when). Q, K and V tiles are staged in shared memory: at
// D=256 that is 64 rows x
// (256+4) floats for Q and K, 64 x 256 for V and a 64 x 68 tile of p --
// 211 KB, so the launcher opts in to more than 48 KB with
// cudaFuncSetAttribute and one block runs per SM. Row strides of D+4
// floats make the float4 reads of K rows by 16 neighbouring threads free
// of bank conflicts. Thread (ty, tx) owns queries ty + 16r and keys
// tx + 16c (r, c < 4) of S, and columns 4tx + 64k of the output: each S
// element is a length-D FFMA chain, each output element a length-64 FFMA
// chain per tile. Row max and row sum are reduced over the 16 lanes of a
// half-warp with shuffles. Causal q tiles are launched longest first.
//
// Bound: at gemma2-9b prefill shapes the work is ~1e12 FLOP per layer and
// the bytes ~0.2 GB, so it is bound by operations on fp32 FFMA (67 TFLOP/s
// peak). No fast-math: expf and tanhf are the accurate versions.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 256;   // 16 x 16
constexpr int PS = BK + 4;      // row stride of the p tile (floats)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DC>
constexpr size_t smem_floats() {
  // q and k tiles (BQ, BK rows of D+4), v tile (BK rows of D), p tile
  return (size_t)(BQ + BK) * (64 * DC + 4) + (size_t)BK * 64 * DC +
         (size_t)BQ * PS;
}

// D = 64 * DC
template <int DC>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Tq,
              int Tk,
              int group, int causal, int window, float softcap,
              float scale) {
  constexpr int D = 64 * DC;
  constexpr int QS = D + 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // BQ x QS
  float* k_s = q_s + BQ * QS;                     // BK x QS
  float* v_s = k_s + BK * QS;                     // BK x D
  float* p_s = v_s + BK * D;                      // BQ x PS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = (Tq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // longest tiles first
  const int bh = blockIdx.y;
  const float* qb = q + (size_t)bh * Tq * D;
  const float* kb = k + (size_t)(bh / group) * Tk * D;
  const float* vb = v + (size_t)(bh / group) * Tk * D;

  // the live key range of this query tile
  int k_lo = 0, k_hi = Tk;
  if (causal) k_hi = min(Tk, min(q0 + BQ, Tq));
  if (window > 0) k_lo = max(0, q0 - window + 1);

  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int r = e / D, c = e - r * D, qi = q0 + r;
    q_s[r * QS + c] = qi < Tq ? qb[(size_t)qi * D + c] : 0.0f;
  }

  float m[4], l[4];
  float4 acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) acc[r][dc] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's k_s, v_s and p_s reads are done
    for (int e = tid; e < BK * D; e += NTHREADS) {
      const int r = e / D, c = e - r * D, kj = k0 + r;
      const bool in = kj < Tk;
      k_s[r * QS + c] = in ? kb[(size_t)kj * D + c] : 0.0f;
      v_s[r * D + c] = in ? vb[(size_t)kj * D + c] : 0.0f;
    }
    __syncthreads();

    // s = q . k over D
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * c) * QS + d]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&q_s[(ty + 16 * r) * QS + d]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv.x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv.y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv.z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv.w, kv[c].w, s[r][c]);
        }
      }
    }

    // scale, softcap, mask; online softmax update of this thread's rows
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty + 16 * r;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        float x = s[r][c] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        live[c] = kj < Tk && (!causal || kj <= qi) &&
                  (window <= 0 || kj > qi - window);
        s[r][c] = live[c] ? x : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], half_warp_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = live[c] ? expf(s[r][c] - m_new) : 0.0f;
        p_s[(ty + 16 * r) * PS + tx + 16 * c] = p;
        sum += p;
      }
      l[r] = l[r] * alpha + half_warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        acc[r][dc].x *= alpha;
        acc[r][dc].y *= alpha;
        acc[r][dc].z *= alpha;
        acc[r][dc].w *= alpha;
      }
    }
    __syncthreads();

    // acc += p . v over this tile's keys
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pv[r] = *reinterpret_cast<const float4*>(&p_s[(ty + 16 * r) * PS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int dc = 0; dc < DC; ++dc) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &v_s[(j + jj) * D + 4 * tx + 64 * dc]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = jj == 0 ? pv[r].x
                            : jj == 1 ? pv[r].y
                            : jj == 2 ? pv[r].z
                                      : pv[r].w;
            acc[r][dc].x = fmaf(p, vv.x, acc[r][dc].x);
            acc[r][dc].y = fmaf(p, vv.y, acc[r][dc].y);
            acc[r][dc].z = fmaf(p, vv.z, acc[r][dc].z);
            acc[r][dc].w = fmaf(p, vv.w, acc[r][dc].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= Tq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* orow = o + ((size_t)bh * Tq + qi) * D;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      float* dst = orow + 4 * tx + 64 * dc;
      dst[0] = acc[r][dc].x / den;
      dst[1] = acc[r][dc].y / den;
      dst[2] = acc[r][dc].z / den;
      dst[3] = acc[r][dc].w / den;
    }
  }
}

template <int DC>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int BH, int BHkv, int Tq, int Tk, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<DC>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, BH);
  flash_fwd<DC><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, o, Tq, Tk, BH / BHkv, causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// window <= 0: no sliding window; softcap <= 0: no softcap.
cudaError_t launch_flash_attention(const float* q, const float* k,
                                   const float* v, float* o, int BH,
                                   int BHkv, int Tq, int Tk, int D,
                                   int causal, int window, float softcap,
                                   float scale, cudaStream_t stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || Tq <= 0 || Tk <= 0)
    return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<1>(q, k, v, o, BH, BHkv, Tq, Tk, causal, window, softcap,
                       scale, stream);
    case 128:
      return launch<2>(q, k, v, o, BH, BHkv, Tq, Tk, causal, window, softcap,
                       scale, stream);
    case 256:
      return launch<4>(q, k, v, o, BH, BHkv, Tq, Tk, causal, window, softcap,
                       scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
