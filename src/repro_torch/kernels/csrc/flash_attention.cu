// Flash attention forward for Hopper (sm_90a), on FFMA.
//
// Replaces the Pallas kernel of repro/kernels/flash_attention/kernel.py:
//   flash_fwd, flash_fwd_padded <- flash_attention_bhsd / _attn_kernel
// for float32 q/k/v at any head_dim 1..512 (flash_fwd at 64, 128 and 256,
// flash_fwd_padded at the others). bfloat16 q/k/v at every head_dim go to
// flash_attention_sm90.cu, on the tensor cores, which float32 could only
// reach through TF32; the template keeps its dtype parameter, but only
// float32 is compiled.
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
// Other head dims (flash_fwd_padded): the same template with PADDED set,
// compiled for D = 64 DC, DC in {1, 2, 3, 4, 6, 8}. A head_dim between
// the cases is padded up to the next one: its loads are masked to zero
// past the true D (the wrapper's 1/sqrt(D) scale is the true D's), the
// q.k loop stops at D
// rounded up to 4, the p.v loop skips the 64-column groups past D, and
// only the true D columns are stored. Above D = 256 the query and key
// tiles drop to 32 rows (RQ = CK = 2) so one block's tiles still fit: 202
// KB at D = 512. float32 at D = 64, 128 and 256 runs the instantiation
// without PADDED (the route flash_fwd): its masks, loads and stores are
// the unpadded ones, compiled apart with if constexpr, and the true
// head_dim is the kernel's last argument, unread, so the others keep their
// places (passed among them, it cost the D = 256 case a stack frame and a
// few per cent). Above 512 the 32-row tiles would leave no room; the
// wrapper refuses.
//
// Bound: at gemma2-9b prefill shapes the work is ~1e12 FLOP per layer and
// the bytes ~0.2 GB, so it is bound by operations on fp32 FFMA (67 TFLOP/s
// peak). No fast-math: expf and tanhf are the accurate versions.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NTHREADS = 256;   // 16 x 16
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// BQ = 16 RQ queries a block, BK = 16 CK keys a tile, D = 64 DC
template <int DC, int RQ, int CK>
constexpr size_t smem_floats() {
  // q and k tiles (BQ, BK rows of D+4), v tile (BK rows of D), p tile
  return (size_t)(16 * RQ + 16 * CK) * (64 * DC + 4) +
         (size_t)16 * CK * 64 * DC + (size_t)16 * RQ * (16 * CK + 4);
}

// D = 64 DC. PADDED: the true head_dim Dt <= D is a runtime value, and
// every access past it is masked (flash_fwd_padded); otherwise Dt == D is
// not read (flash_fwd).
template <int DC, int RQ, int CK, typename T, bool PADDED>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Tq, int Tk,
              int group, int causal, int window, float softcap,
              float scale, int Dt) {
  constexpr int D = 64 * DC;
  constexpr int QS = D + 4;
  constexpr int BQ = 16 * RQ, BK = 16 * CK, PS = BK + 4;
  const int Dr = PADDED ? Dt : D;                  // the row stride in global
  const int DL = PADDED ? (Dt + 3) & ~3 : D;       // the q.k loop's extent
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // BQ x QS
  float* k_s = q_s + BQ * QS;                     // BK x QS
  float* v_s = k_s + BK * QS;                     // BK x D
  float* p_s = v_s + BK * D;                      // BQ x PS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = (Tq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // longest tiles first
  const int bh = blockIdx.y;
  const T* qb = q + (size_t)bh * Tq * Dr;
  const T* kb = k + (size_t)(bh / group) * Tk * Dr;
  const T* vb = v + (size_t)(bh / group) * Tk * Dr;

  // the live key range of this query tile
  int k_lo = 0, k_hi = Tk;
  if (causal) k_hi = min(Tk, min(q0 + BQ, Tq));
  if (window > 0) k_lo = max(0, q0 - window + 1);

  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int r = e / D, c = e - r * D, qi = q0 + r;
    if constexpr (PADDED)
      q_s[r * QS + c] =
          (qi < Tq && c < Dt) ? to_f32(qb[(size_t)qi * Dt + c]) : 0.0f;
    else
      q_s[r * QS + c] = qi < Tq ? qb[(size_t)qi * D + c] : 0.0f;
  }

  float m[RQ], l[RQ];
  float4 acc[RQ][DC];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) acc[r][dc] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's k_s, v_s and p_s reads are done
    for (int e = tid; e < BK * D; e += NTHREADS) {
      const int r = e / D, c = e - r * D, kj = k0 + r;
      if constexpr (PADDED) {
        const bool in = kj < Tk && c < Dt;
        k_s[r * QS + c] = in ? to_f32(kb[(size_t)kj * Dt + c]) : 0.0f;
        v_s[r * D + c] = in ? to_f32(vb[(size_t)kj * Dt + c]) : 0.0f;
      } else {
        const bool in = kj < Tk;
        k_s[r * QS + c] = in ? kb[(size_t)kj * D + c] : 0.0f;
        v_s[r * D + c] = in ? vb[(size_t)kj * D + c] : 0.0f;
      }
    }
    __syncthreads();

    // s = q . k over D
    float s[RQ][CK];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DL; d += 4) {
      float4 kv[CK];
#pragma unroll
      for (int c = 0; c < CK; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * c) * QS + d]);
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&q_s[(ty + 16 * r) * QS + d]);
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          s[r][c] = fmaf(qv.x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv.y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv.z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv.w, kv[c].w, s[r][c]);
        }
      }
    }

    // scale, softcap, mask; online softmax update of this thread's rows
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int qi = q0 + ty + 16 * r;
      bool live[CK];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
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
      for (int c = 0; c < CK; ++c) {
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
      float4 pv[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
        pv[r] = *reinterpret_cast<const float4*>(&p_s[(ty + 16 * r) * PS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int dc = 0; dc < DC; ++dc) {
          if constexpr (PADDED) {
            if (64 * dc >= Dt) break;   // columns past the true D
          }
          const float4 vv = *reinterpret_cast<const float4*>(
              &v_s[(j + jj) * D + 4 * tx + 64 * dc]);
#pragma unroll
          for (int r = 0; r < RQ; ++r) {
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
  for (int r = 0; r < RQ; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= Tq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = o + ((size_t)bh * Tq + qi) * Dr;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      if constexpr (PADDED) {
        const int c = 4 * tx + 64 * dc;
        const float vals[4] = {acc[r][dc].x / den, acc[r][dc].y / den,
                               acc[r][dc].z / den, acc[r][dc].w / den};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < Dt) store_as(orow + c + e, vals[e]);
      } else {
        T* dst = orow + 4 * tx + 64 * dc;
        dst[0] = acc[r][dc].x / den;
        dst[1] = acc[r][dc].y / den;
        dst[2] = acc[r][dc].z / den;
        dst[3] = acc[r][dc].w / den;
      }
    }
  }
}

template <int DC, int RQ, int CK, typename T, bool PADDED>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int BHkv, int Tq, int Tk, int D, int causal,
                   int window, float softcap, float scale,
                   cudaStream_t stream) {
  auto fn = flash_fwd<DC, RQ, CK, T, PADDED>;
  const size_t smem = smem_floats<DC, RQ, CK>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + 16 * RQ - 1) / (16 * RQ), BH);
  fn<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, Tk, BH / BHkv,
      causal, window, softcap, scale, D);
  return cudaGetLastError();
}

// a head_dim padded up to the next compiled case (flash_fwd_padded)
cudaError_t launch_padded(const void* q, const void* k, const void* v,
                          void* o, int BH, int BHkv, int Tq, int Tk, int D,
                          int causal, int window, float softcap, float scale,
                          cudaStream_t stream) {
#define FLASH_PADDED(DC, RQ)                                                 \
  return launch<DC, RQ, RQ, float, true>(q, k, v, o, BH, BHkv, Tq, Tk, D,    \
                                         causal, window, softcap, scale,     \
                                         stream)
  if (D <= 64) FLASH_PADDED(1, 4);
  if (D <= 128) FLASH_PADDED(2, 4);
  if (D <= 192) FLASH_PADDED(3, 4);
  if (D <= 256) FLASH_PADDED(4, 4);
  if (D <= 384) FLASH_PADDED(6, 2);
  FLASH_PADDED(8, 2);
#undef FLASH_PADDED
}

}  // namespace

// window <= 0: no sliding window; softcap <= 0: no softcap. q, k, v and o
// are float32.
cudaError_t launch_flash_attention(const float* q, const float* k,
                                   const float* v, float* o, int BH,
                                   int BHkv, int Tq, int Tk, int D,
                                   int causal, int window, float softcap,
                                   float scale, cudaStream_t stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || Tq <= 0 || Tk <= 0 ||
      D < 1 || D > 512)
    return cudaErrorInvalidValue;
#define FLASH_EXACT(DC)                                                    \
  return launch<DC, 4, 4, float, false>(q, k, v, o, BH, BHkv, Tq, Tk, D,  \
                                        causal, window, softcap, scale,   \
                                        stream)
  switch (D) {   // the unpadded float32 cases: flash_fwd
    case 64: FLASH_EXACT(1);
    case 128: FLASH_EXACT(2);
    case 256: FLASH_EXACT(4);
    default:
      return launch_padded(q, k, v, o, BH, BHkv, Tq, Tk, D, causal, window,
                           softcap, scale, stream);
  }
#undef FLASH_EXACT
}
