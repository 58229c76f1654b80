// Flash attention forward for Hopper's tensor cores (sm_90a), bf16 inputs.
//
// Replaces the Pallas kernel of repro/kernels/flash_attention/kernel.py
// (flash_attention_bhsd :95, body _attn_kernel :31) for bfloat16 q/k/v;
// float32 inputs keep the FFMA kernel of flash_attention.cu, since the
// tensor cores would need TF32 for them.
//
// Layout (the reference's flattened rows): q (BH, Tq, D); k, v (BHkv, Tk, D)
// bf16, D = 64, 128 or 256; query row bh reads kv row bh / (BH / BHkv)
// (GQA without repeating heads); o (BH, Tq, D) bf16.
//
// Per (q row i, key j): s = (q_i . k_j) * scale, then s = cap*tanh(s/cap)
// when a softcap is given, masked to -1e30 unless j < Tk, j <= i (causal)
// and j > i - window (sliding window); online softmax over key tiles with
// the running max m, normaliser l and accumulator acc; p is zeroed where
// masked; o = acc / max(l, 1e-30). Softmax runs in base 2 (scores times
// log2 e), which is the same function, and the softcap's tanh is
// 1 - 2 / (e^2x + 1) on the approximate exp2 and reciprocal (absolute
// error ~1e-7, so ~1e-5 on a capped score).
//
// Bound: at gemma2-9b prefill shapes (B=2, T=8192, 16 heads over 8 of
// D=256) a launch does ~0.96 TFLOP on the live (query, key) pairs and moves
// ~0.1 GB, so it is bound by operations on the bf16 tensor cores (989
// TFLOP/s): ~1 ms.
//
// Design. One block owns one (row bh, 128-query tile); 384 threads in three
// warpgroups. Warpgroups 0 and 1 are consumers of 64 query rows each;
// warpgroup 2 is the producer, of which one thread issues every load.
//  - Loads. TMA (cp.async.bulk.tensor) through 3-D tensor maps (D, T, BH),
//    so rows past Tq or Tk are zero-filled and never read from the next
//    head, in boxes of 64 columns (128 B) with the 128-byte swizzle: a tile
//    of R rows is D/64 such boxes placed one after the other (R x 128 B
//    each). Q (128 x D) is loaded once; K and V tiles (64 x D each) go
//    through a 2-stage ring, K and V each with a full barrier (transaction
//    bytes) and an empty barrier that the 8 consumer warps arrive on once
//    their product has read it: K is free a turn before V. The maps come
//    from cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint
//    (no -lcuda), passed as __grid_constant__.
//  - Turns. The two consumer warpgroups take turns at the tensor cores
//    (named barriers 1 and 2). A turn issues O += P V of the warpgroup's
//    last tile and S = Q K^T of its next one as one batch; the softmax of
//    that tile then runs while the other warpgroup's turn keeps the tensor
//    cores busy. The first turn (S only) and the last (P V only) are
//    peeled off the loop: a wgmma under a branch makes ptxas serialise
//    every wgmma of the kernel.
//  - S = Q K^T on wgmma m64n64k16 (bf16 -> f32), A = Q and B = K both
//    K-major from shared memory, D/16 steps; the descriptor advances 32 B a
//    step inside a 128-B swizzle atom and one box (R x 128 B) per 64
//    columns.
//  - O += P V on wgmma m64n{D}k16: A = P from registers (the f32 S
//    accumulator converted in place to bf16 A fragments: the
//    accumulator's layout is the A operand's), B = the V tile read
//    MN-major (the transpose bit), so V is never transposed in memory; 4
//    steps of 16 keys. P is split as P_hi + P_lo, both bf16, and both go
//    through the product: p keeps 16 significant bits. A single bf16 p
//    (relative 2^-9) leaves ~2^-9 E|v| of error where o nears 0, above the
//    1e-3 + 8e-3 |o| the kernel is held to; the split costs half again the
//    products. The output is rounded to bf16.
//  - Registers. Per consumer thread, O is D/2 floats (128 at D=256), S 32,
//    P 32, all live during a turn; setmaxnreg gives consumers 240 and the
//    producer 24.
//  - Masks. The live key range of each q tile is computed up front from
//    its first and last query, so fully masked key tiles are never loaded
//    or computed (the reference skips them with pl.when). Masks are
//    applied only on tiles that straddle the causal diagonal, the window
//    edge or Tk, in the accumulator's fragment layout: thread t of warp w
//    holds rows 16w + t/4 + 8i and columns 8j + 2(t%4) + {0,1}. Row max and
//    row sum reduce over the 4 lanes that share a row. Causal q tiles
//    launch longest first (the q tile is the grid's slow axis).
//  - Output: from registers to bf16, rows >= Tq not written.
//
// The padded route (flash_fwd_sm90_padded<DP>): bf16 at any other head_dim
// d up to 256, in place of the FFMA kernel of flash_attention.cu, which
// widens bf16 to float32 (0.013 of its bound at d = 96). The same body
// at DP = d rounded up to 64 (64, 128, 192 or 256): the tensor maps keep
// the true d as their inner dimension, so TMA reads columns d..DP-1 as
// zeros, which add nothing to Q K^T, and the columns of O past d are not
// stored (the output's row stride is d; 1/sqrt(d) scales the scores as
// before). A map's row stride (2 d bytes) must be a multiple of 16: at
// d % 8 != 0, flash_pad_rows first copies q, k and v into rows of d
// rounded up to 8 (zeros past d), a pass of ~2 x the inputs' bytes that
// counts in the route's time. The unpadded kernels share the body but
// compile none of this (PADDED false), so their code stays the parent's.
// At DP = 192: O is 96 floats a consumer thread; shared memory is Q 48 KB
// plus 2 stages of K and V, 96 KB.
//
// The wide route (flash_fwd_sm90_wide<DP>): bf16 at head_dim 257..512, in
// place of the FFMA kernel of flash_attention.cu, which widens bf16 to
// float32 (1.42 ms at D = 512, 1x4/2x2,048, window 1,024, softcap 50,
// against a bound of 0.013 ms on the bf16 tensor cores). DP is d rounded
// up to 64 (320, 384, 448, 512), read through the same zero-filled maps
// and pad_rows copies as the padded route. The body above cannot take
// DP > 256: a consumer warpgroup's 64 x DP accumulator would be 256
// registers a thread at DP = 512, and 64-key K/V stages would need 320 KB.
// So one block owns 64 query rows, and the two consumer warpgroups split
// O by columns: warpgroup w holds O's columns w DP/2 .. + DP/2 - 1 (128
// floats a thread at DP = 512; setmaxnreg 240/24 as above), with the
// producer warpgroup's one thread issuing every TMA load. K and V tiles
// are 32 keys in a 2-stage ring. V is loaded as two halves of
// ceil(DP/128) boxes, the second from column DP/2, so each half starts on
// a box (a wgmma operand cannot start inside one along N); at DP = 320 and
// 448 a half's last box carries 32 columns of the other half, unread.
// S = Q K^T (64 x 32, m64n32k16) is split by D: each warpgroup runs its
// DP/32 k-steps over its half of the columns (a 32-B step inside a box),
// writes its f32 partial to shared memory, and adds the other's after one
// named barrier (a buffer per warpgroup and parity: 32 KB), so both hold
// the same S (a + b == b + a) and run the same softmax. Computing S whole
// in both warpgroups needs no exchange but a third more tensor-core work
// a tile (S twice, P V's hi and lo once each); the exchange costs 16
// float stores and loads a thread. A turn issues O += P V of the last
// tile (P split into bf16 hi + lo as above, m64n{DP/2}k16, V MN-major)
// and the next tile's S partial as one batch; the first turn and the last
// are peeled, no wgmma under a branch. Shared memory: Q 64 x DP, 2 stages
// of K (32 x DP) and V (2 halves), the partials: 164,936 B at DP = 320,
// 181,320 at 384, 214,088 at 448, 230,472 at 512, of 232,448.
#include <algorithm>

#include "sm90.cuh"

namespace {

constexpr int BQ = 128;         // queries per block (two consumer warpgroups)
constexpr int BK = 64;          // keys per tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr int NTHREADS = 384;   // 2 consumer warpgroups + 1 producer
constexpr int CONSUMER_WARPS = 8;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// shared memory: [slack to 1024-B alignment] Q | K x STAGES | V x STAGES |
// barriers
template <int D>
struct Smem {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, k_full[S], v_full[S], k_empty[S], v_empty[S]
  static constexpr int N_BARS = 1 + 4 * STAGES;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * N_BARS;
};


// bar.sync / bar.arrive on named barrier id for the 256 consumer threads:
// the two consumer warpgroups take turns at the tensor cores
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The body of both kernels. D = 64, 128 or 256 (flash_fwd_sm90), or the
// padded width DP = 64, 128, 192 or 256 (flash_fwd_sm90_padded, PADDED):
// the maps read zeros past the true head_dim d, and only the output's
// store knows d (its row stride and the columns it writes).
template <int D, bool PADDED>
__device__ __forceinline__ void flash_body(
    const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, __nv_bfloat16* __restrict__ o, int Tq, int Tk,
    int group, int causal, int window, float softcap, float scale, int d) {
  using L = Smem<D>;
  constexpr int DC = D / 64;  // 128-byte boxes per row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sq = base + L::Q_OFF, sk = base + L::K_OFF,
                 sv = base + L::V_OFF, bars = base + L::BAR_OFF;
  // barriers: q_full, k_full[s], v_full[s], k_empty[s], v_empty[s]
  const uint32_t q_full = bars;
#define K_FULL(s) (bars + 8u * (1 + (s)))
#define V_FULL(s) (bars + 8u * (1 + STAGES + (s)))
#define K_EMPTY(s) (bars + 8u * (1 + 2 * STAGES + (s)))
#define V_EMPTY(s) (bars + 8u * (1 + 3 * STAGES + (s)))

  const int nq = (Tq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;  // longest tiles first
  const int bh = blockIdx.x;

  // the live key range of this query tile
  int k_lo = 0, k_hi = Tk;
  if (causal) k_hi = min(Tk, min(q0 + BQ, Tq));
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int t_begin = k_lo / BK;
  const int n_tiles = max(0, (k_hi + BK - 1) / BK - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(K_FULL(s), 1);
      mbar_init(V_FULL(s), 1);
      mbar_init(K_EMPTY(s), CONSUMER_WARPS);
      mbar_init(V_EMPTY(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      const int bhkv = bh / group;
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        tma_load(sq + c * BQ * 128, map_q, 64 * c, q0, bh, q_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = (t_begin + it) * BK;
        mbar_wait(K_EMPTY(s), ph ^ 1);
        mbar_expect_tx(K_FULL(s), L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load(sk + s * L::KV_BYTES + c * BK * 128, map_k, 64 * c, k0,
                   bhkv, K_FULL(s));
        mbar_wait(V_EMPTY(s), ph ^ 1);
        mbar_expect_tx(V_FULL(s), L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load(sv + s * L::KV_BYTES + c * BK * 128, map_v, 64 * c, k0,
                   bhkv, V_FULL(s));
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int qw0 = q0 + 64 * wg;
    const int row0 = qw0 + 16 * warp + lane / 4;  // rows row0, row0 + 8
    const int col0 = 2 * (lane % 4);              // + 8j + {0, 1}
    const int my_turn = 1 + wg, next_turn = 2 - wg;  // named barriers 1, 2
    // scores in base 2: s2 = s * scale * log2 e, or with a softcap
    // s2 = C tanh(s * scale / cap), C = cap * log2 e, as
    // C - 2C / (2^(2 log2 e * s * scale / cap) + 1)
    const bool cap = softcap > 0.0f;
    const float qk_scale =
        cap ? 2.0f * LOG2E * scale / softcap : scale * LOG2E;
    const float cap2 = softcap * LOG2E;

    // K-major operands: stride 1024 B between 8-row groups; V MN-major:
    // 1024 B between 8-key groups, BK * 128 B between 64-column boxes
    const uint64_t dq = sw128_desc(sq + wg * 64 * 128, 16, 1024);
    const uint64_t dk = sw128_desc(sk, 16, 1024);
    const uint64_t dv = sw128_desc(sv, BK * 128, 1024);

    float oacc[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) oacc[r] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
    float sacc[32];
    uint32_t p_hi[4][4], p_lo[4][4];  // the last tile's P = P_hi + P_lo

    // the products of one turn; wgmma stays out of branches, or ptxas
    // serialises every wgmma of the kernel
    auto issue_s = [&](int s) {
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sacc, dq + ((c * BQ * 128 + kk * 32) >> 4),
                   dk + ((s * L::KV_BYTES + c * BK * 128 + kk * 32) >> 4),
                   (c | kk) != 0);
    };
    auto issue_pv = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = dv + ((s * L::KV_BYTES + kk * 16 * 128) >> 4);
        wgmma_rs(oacc, p_hi[kk], db, 1);
        wgmma_rs(oacc, p_lo[kk], db, 1);
      }
    };
    auto retire = [&]() {
      wgmma_wait_all();
      fence_regs(oacc);
      fence_regs(sacc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(p_hi[kk]);
        fence_regs(p_lo[kk]);
      }
      __syncwarp();
    };
    // scale and softcap (base 2), mask, online softmax of the tile at k0;
    // rescales O and leaves P in p_hi, p_lo
    auto softmax = [&](int k0) {
      if (cap) {
#pragma unroll
        for (int r = 0; r < 32; ++r)
          sacc[r] = fmaf(-2.0f * cap2, rcp(ex2(sacc[r] * qk_scale) + 1.0f),
                         cap2);
      } else {
#pragma unroll
        for (int r = 0; r < 32; ++r) sacc[r] *= qk_scale;
      }
      uint32_t live = 0xffffffffu;
      if ((causal && k0 + BK - 1 > qw0) ||
          (window > 0 && k0 <= qw0 + 63 - window) || k0 + BK > Tk) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int qi = row0 + 8 * ((r / 2) % 2);
          const int kj = k0 + 8 * (r / 4) + col0 + r % 2;
          const bool ok = kj < Tk && (!causal || kj <= qi) &&
                          (window <= 0 || kj > qi - window);
          if (!ok) {
            live &= ~(1u << r);
            sacc[r] = NEG_INF;
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * i], sacc[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = ex2(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 4 * j + 2 * i + e;
            const float p = (live >> r) & 1u ? ex2(sacc[r] - m_new) : 0.0f;
            sacc[r] = p;
            sum += p;
          }
        l[i] = l[i] * alpha[i] + sum;  // this lane's columns; reduced last
      }
#pragma unroll
      for (int r = 0; r < D / 2; ++r) oacc[r] *= alpha[(r / 2) % 2];
      // P = P_hi + P_lo as bf16 A fragments, one pair per 16 keys
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          split_bf16(sacc[8 * kk + 2 * h], sacc[8 * kk + 2 * h + 1],
                     p_hi[kk][h], p_lo[kk][h]);
    };

    mbar_wait(q_full, 0);
    // Each turn issues O += P V of the last tile and S = Q K^T of the
    // next; the softmax of that tile then runs during the other
    // warpgroup's turn. Warpgroup 0 goes first. No live key tile: no
    // turn, o = 0.
    if (n_tiles > 0) {
      if (wg == 1) turn_pass(1);
      mbar_wait(K_FULL(0), 0);
      turn_wait(my_turn);
      wgmma_fence();
      issue_s(0);
      wgmma_commit();
      turn_pass(next_turn);
      retire();
      if (lane == 0) mbar_arrive(K_EMPTY(0));
      softmax(t_begin * BK);
      for (int it = 1; it < n_tiles; ++it) {
        const int s = it % STAGES, sp = (it - 1) % STAGES;
        mbar_wait(K_FULL(s), (it / STAGES) & 1);
        mbar_wait(V_FULL(sp), ((it - 1) / STAGES) & 1);
        turn_wait(my_turn);
        wgmma_fence();
        issue_pv(sp);
        issue_s(s);
        wgmma_commit();
        turn_pass(next_turn);
        retire();
        if (lane == 0) {
          mbar_arrive(K_EMPTY(s));
          mbar_arrive(V_EMPTY(sp));
        }
        softmax((t_begin + it) * BK);
      }
      const int sp = (n_tiles - 1) % STAGES;
      mbar_wait(V_FULL(sp), ((n_tiles - 1) / STAGES) & 1);
      turn_wait(my_turn);
      wgmma_fence();
      issue_pv(sp);
      wgmma_commit();
      retire();
      if (wg == 0) turn_pass(2);  // warpgroup 1's last turn
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int qi = row0 + 8 * i;
      if (qi >= Tq) continue;
      const float den = fmaxf(l[i], 1e-30f);
      if constexpr (PADDED) {
        // row stride d; columns d..DP-1 of the accumulator are not stored
        __nv_bfloat16* orow = o + ((size_t)bh * Tq + qi) * d;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + col0 + e;
            if (c < d)
              orow[c] = __float2bfloat16_rn(oacc[4 * j + 2 * i + e] / den);
          }
      } else {
        __nv_bfloat16* orow = o + ((size_t)bh * Tq + qi) * D + col0;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(oacc[4 * j + 2 * i] / den,
                                    oacc[4 * j + 2 * i + 1] / den);
      }
    }
  }
#undef K_FULL
#undef V_FULL
#undef K_EMPTY
#undef V_EMPTY
}

// D = 64, 128 or 256
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   __nv_bfloat16* __restrict__ o, int Tq, int Tk, int group,
                   int causal, int window, float softcap, float scale) {
  flash_body<D, false>(&map_q, &map_k, &map_v, o, Tq, Tk, group, causal,
                       window, softcap, scale, D);
}

// DP = 64, 128, 192 or 256, the true head_dim d in (DP - 64, DP]
template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_sm90_padded(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          __nv_bfloat16* __restrict__ o, int Tq, int Tk,
                          int group, int causal, int window, float softcap,
                          float scale, int d) {
  flash_body<DP, true>(&map_q, &map_k, &map_v, o, Tq, Tk, group, causal,
                       window, softcap, scale, d);
}

// ---------------------------------------------------------------------------
// the wide route: bf16 at head_dim 257..512 (flash_fwd_sm90_wide<DP>)
// ---------------------------------------------------------------------------
constexpr int WBQ = 64;   // queries a block
constexpr int WBK = 32;   // keys a tile

// shared memory: [slack to 1024-B alignment] Q | K x STAGES | V x STAGES |
// S partials (2 parities x 2 warpgroups) | barriers
template <int DP>
struct WideSmem {
  static constexpr int DC = DP / 64;              // 128-B boxes of a row
  static constexpr int HALF = DP / 2;             // O columns a warpgroup
  static constexpr int NB = (HALF + 63) / 64;     // boxes of a V half
  static constexpr int Q_BYTES = WBQ * DP * 2;
  static constexpr int K_BYTES = WBK * DP * 2;
  static constexpr int V_HALF = NB * WBK * 128;
  static constexpr int V_BYTES = 2 * V_HALF;
  static constexpr int X_BYTES = WBQ * WBK * 4;   // one 64 x 32 f32 partial
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int X_OFF = V_OFF + STAGES * V_BYTES;
  static constexpr int BAR_OFF = X_OFF + 4 * X_BYTES;
  static constexpr int N_BARS = 1 + 4 * STAGES;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * N_BARS;
};

// DP = 320, 384, 448 or 512, the true head_dim d in (DP - 64, DP]
template <int DP>
__device__ __forceinline__ void flash_wide_body(
    const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, __nv_bfloat16* __restrict__ o, int Tq, int Tk,
    int group, int causal, int window, float softcap, float scale, int d) {
  using L = WideSmem<DP>;
  constexpr int DC = L::DC, HALF = L::HALF, NB = L::NB;
  constexpr int KSTEPS = DP / 32;   // S's k-steps of 16 a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  const uint32_t sq = base + L::Q_OFF, sk = base + L::K_OFF,
                 sv = base + L::V_OFF, bars = base + L::BAR_OFF;
  float4* xbuf = reinterpret_cast<float4*>(smem_raw + pad + L::X_OFF);
  const uint32_t q_full = bars;
#define K_FULL(s) (bars + 8u * (1 + (s)))
#define V_FULL(s) (bars + 8u * (1 + STAGES + (s)))
#define K_EMPTY(s) (bars + 8u * (1 + 2 * STAGES + (s)))
#define V_EMPTY(s) (bars + 8u * (1 + 3 * STAGES + (s)))

  const int nq = (Tq + WBQ - 1) / WBQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * WBQ;  // longest tiles first
  const int bh = blockIdx.x;

  // the live key range of this query tile
  int k_lo = 0, k_hi = Tk;
  if (causal) k_hi = min(Tk, min(q0 + WBQ, Tq));
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int t_begin = k_lo / WBK;
  const int n_tiles = max(0, (k_hi + WBK - 1) / WBK - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(K_FULL(s), 1);
      mbar_init(V_FULL(s), 1);
      mbar_init(K_EMPTY(s), CONSUMER_WARPS);
      mbar_init(V_EMPTY(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load; V goes in two halves of NB
    // boxes, the second from column HALF, so that each warpgroup's half
    // starts on a box
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      const int bhkv = bh / group;
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        tma_load(sq + c * WBQ * 128, map_q, 64 * c, q0, bh, q_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = (t_begin + it) * WBK;
        mbar_wait(K_EMPTY(s), ph ^ 1);
        mbar_expect_tx(K_FULL(s), L::K_BYTES);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load(sk + s * L::K_BYTES + c * WBK * 128, map_k, 64 * c, k0,
                   bhkv, K_FULL(s));
        mbar_wait(V_EMPTY(s), ph ^ 1);
        mbar_expect_tx(V_FULL(s), L::V_BYTES);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int c = 0; c < NB; ++c)
            tma_load(sv + s * L::V_BYTES + hf * L::V_HALF + c * WBK * 128,
                     map_v, hf * HALF + 64 * c, k0, bhkv, V_FULL(s));
      }
    }
  } else {
    // consumer warpgroup wg: all 64 query rows, S over its half of DP and
    // O's columns wg * HALF .. + HALF - 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row0 = q0 + 16 * warp + lane / 4;  // rows row0, row0 + 8
    const int col0 = 2 * (lane % 4);              // + 8j + {0, 1}
    const bool cap = softcap > 0.0f;
    const float qk_scale =
        cap ? 2.0f * LOG2E * scale / softcap : scale * LOG2E;
    const float cap2 = softcap * LOG2E;

    // K-major Q and K: 1024 B between 8-row groups; this warpgroup's
    // k-steps start at column wg * HALF (a 32-B step inside a box). V's
    // half MN-major: WBK * 128 B between 64-column boxes
    const int kk0 = wg * KSTEPS;
    const uint64_t dq = sw128_desc(sq, 16, 1024);
    const uint64_t dk = sw128_desc(sk, 16, 1024);
    const uint64_t dv = sw128_desc(sv + wg * L::V_HALF, WBK * 128, 1024);

    float oacc[HALF / 2];
#pragma unroll
    for (int r = 0; r < HALF / 2; ++r) oacc[r] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
    float sacc[16];
    uint32_t p_hi[2][4], p_lo[2][4];  // the last tile's P = P_hi + P_lo

    // the products of one turn; wgmma stays out of branches, or ptxas
    // serialises every wgmma of the kernel
    auto issue_s = [&](int s) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int kk = kk0 + ks, c = kk / 4, k4 = kk % 4;
        wgmma_ss(sacc, dq + ((c * WBQ * 128 + k4 * 32) >> 4),
                 dk + ((s * L::K_BYTES + c * WBK * 128 + k4 * 32) >> 4),
                 ks != 0);
      }
    };
    auto issue_pv = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t db = dv + ((s * L::V_BYTES + kk * 16 * 128) >> 4);
        wgmma_rs(oacc, p_hi[kk], db, 1);
        wgmma_rs(oacc, p_lo[kk], db, 1);
      }
    };
    auto retire = [&]() {
      wgmma_wait_all();
      fence_regs(oacc);
      fence_regs(sacc);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        fence_regs(p_hi[kk]);
        fence_regs(p_lo[kk]);
      }
      __syncwarp();
    };
    // S = this warpgroup's partial + the other's, through shared memory
    // (a buffer a parity, so a write never meets the other's last read);
    // a + b == b + a, so both warpgroups hold the same S
    auto exchange = [&](int it) {
      float4* mine = xbuf + ((it & 1) * 2 + wg) * (L::X_BYTES / 16);
      const float4* other =
          xbuf + ((it & 1) * 2 + 1 - wg) * (L::X_BYTES / 16);
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4)
        mine[r4 * 128 + tid] = make_float4(sacc[4 * r4], sacc[4 * r4 + 1],
                                           sacc[4 * r4 + 2], sacc[4 * r4 + 3]);
      named_sync(1, 256);
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const float4 v = other[r4 * 128 + tid];
        sacc[4 * r4] += v.x;
        sacc[4 * r4 + 1] += v.y;
        sacc[4 * r4 + 2] += v.z;
        sacc[4 * r4 + 3] += v.w;
      }
    };
    // scale and softcap (base 2), mask, online softmax of the tile at k0;
    // rescales O and leaves P in p_hi, p_lo
    auto softmax = [&](int k0) {
      if (cap) {
#pragma unroll
        for (int r = 0; r < 16; ++r)
          sacc[r] = fmaf(-2.0f * cap2, rcp(ex2(sacc[r] * qk_scale) + 1.0f),
                         cap2);
      } else {
#pragma unroll
        for (int r = 0; r < 16; ++r) sacc[r] *= qk_scale;
      }
      uint32_t live = 0xffffu;
      if ((causal && k0 + WBK - 1 > q0) ||
          (window > 0 && k0 <= q0 + WBQ - 1 - window) || k0 + WBK > Tk) {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const int qi = row0 + 8 * ((r / 2) % 2);
          const int kj = k0 + 8 * (r / 4) + col0 + r % 2;
          const bool ok = kj < Tk && (!causal || kj <= qi) &&
                          (window <= 0 || kj > qi - window);
          if (!ok) {
            live &= ~(1u << r);
            sacc[r] = NEG_INF;
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * i], sacc[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = ex2(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 4 * j + 2 * i + e;
            const float p = (live >> r) & 1u ? ex2(sacc[r] - m_new) : 0.0f;
            sacc[r] = p;
            sum += p;
          }
        l[i] = l[i] * alpha[i] + sum;  // this lane's columns; reduced last
      }
#pragma unroll
      for (int r = 0; r < HALF / 2; ++r) oacc[r] *= alpha[(r / 2) % 2];
      // P = P_hi + P_lo as bf16 A fragments, one pair per 16 keys
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          split_bf16(sacc[8 * kk + 2 * h], sacc[8 * kk + 2 * h + 1],
                     p_hi[kk][h], p_lo[kk][h]);
    };

    mbar_wait(q_full, 0);
    // Each turn issues O += P V of the last tile and this warpgroup's
    // part of S = Q K^T of the next as one batch, then sums S with the
    // other warpgroup's part and runs its softmax. No live key tile: no
    // turn, o = 0.
    if (n_tiles > 0) {
      mbar_wait(K_FULL(0), 0);
      wgmma_fence();
      issue_s(0);
      wgmma_commit();
      retire();
      if (lane == 0) mbar_arrive(K_EMPTY(0));
      exchange(0);
      softmax(t_begin * WBK);
      for (int it = 1; it < n_tiles; ++it) {
        const int s = it % STAGES, sp = (it - 1) % STAGES;
        mbar_wait(K_FULL(s), (it / STAGES) & 1);
        mbar_wait(V_FULL(sp), ((it - 1) / STAGES) & 1);
        wgmma_fence();
        issue_pv(sp);
        issue_s(s);
        wgmma_commit();
        retire();
        if (lane == 0) {
          mbar_arrive(K_EMPTY(s));
          mbar_arrive(V_EMPTY(sp));
        }
        exchange(it);
        softmax((t_begin + it) * WBK);
      }
      const int sp = (n_tiles - 1) % STAGES;
      mbar_wait(V_FULL(sp), ((n_tiles - 1) / STAGES) & 1);
      wgmma_fence();
      issue_pv(sp);
      wgmma_commit();
      retire();
    }

    // row stride d; this warpgroup's columns past d are not stored
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int qi = row0 + 8 * i;
      if (qi >= Tq) continue;
      const float den = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = o + ((size_t)bh * Tq + qi) * d + wg * HALF;
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + col0 + e;
          if (wg * HALF + c < d)
            orow[c] = __float2bfloat16_rn(oacc[4 * j + 2 * i + e] / den);
        }
    }
  }
#undef K_FULL
#undef V_FULL
#undef K_EMPTY
#undef V_EMPTY
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_sm90_wide(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        __nv_bfloat16* __restrict__ o, int Tq, int Tk,
                        int group, int causal, int window, float softcap,
                        float scale, int d) {
  flash_wide_body<DP>(&map_q, &map_k, &map_v, o, Tq, Tk, group, causal,
                      window, softcap, scale, d);
}

// rows of d bf16 -> rows of d8 (d rounded up to 8), zeros past d: the
// copy a head_dim that is no multiple of 8 needs, since a tensor map's row
// stride (2 d bytes) must be a multiple of 16
__global__ void flash_pad_rows(const __nv_bfloat16* __restrict__ src,
                               __nv_bfloat16* __restrict__ dst, size_t rows,
                               int d, int d8) {
  const size_t n = rows * d8;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t r = e / d8;
    const int c = (int)(e - r * d8);
    dst[e] = c < d ? src[r * d + c] : __float2bfloat16_rn(0.0f);
  }
}

// (D, T, rows) bf16 tensor, boxes of 64 columns x box_rows rows, 128-byte
// swizzle, out-of-range elements read as zero
bool make_map(CUtensorMap* map, const void* ptr, int rows, int T, int D,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int BHkv, int Tq, int Tk, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, BH, Tq, D, BQ) || !make_map(&mk, k, BHkv, Tk, D, BK) ||
      !make_map(&mv, v, BHkv, Tk, D, BK))
    return cudaErrorInvalidValue;
  const int smem = Smem<D>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + BQ - 1) / BQ);
  flash_fwd_sm90<D><<<grid, NTHREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Tq, Tk, BH / BHkv, causal,
      window, softcap, scale);
  return cudaGetLastError();
}

// q, k, v hold rows of w bf16 (w = d, or d padded to 8): the maps' inner
// dimension is w, and TMA reads columns w..DP-1 as zeros
template <int DP>
cudaError_t launch_padded(const void* q, const void* k, const void* v,
                          void* o, int BH, int BHkv, int Tq, int Tk, int w,
                          int d, int causal, int window, float softcap,
                          float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, BH, Tq, w, BQ) || !make_map(&mk, k, BHkv, Tk, w, BK) ||
      !make_map(&mv, v, BHkv, Tk, w, BK))
    return cudaErrorInvalidValue;
  const int smem = Smem<DP>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_padded<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + BQ - 1) / BQ);
  flash_fwd_sm90_padded<DP><<<grid, NTHREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Tq, Tk, BH / BHkv, causal,
      window, softcap, scale, d);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        int BH, int BHkv, int Tq, int Tk, int w, int d,
                        int causal, int window, float softcap, float scale,
                        cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, BH, Tq, w, WBQ) ||
      !make_map(&mk, k, BHkv, Tk, w, WBK) ||
      !make_map(&mv, v, BHkv, Tk, w, WBK))
    return cudaErrorInvalidValue;
  const int smem = WideSmem<DP>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_wide<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + WBQ - 1) / WBQ);
  flash_fwd_sm90_wide<DP><<<grid, NTHREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Tq, Tk, BH / BHkv, causal,
      window, softcap, scale, d);
  return cudaGetLastError();
}

cudaError_t pad_rows(const void* src, void* dst, size_t rows, int d, int d8,
                     cudaStream_t stream) {
  const size_t n = rows * d8;
  const unsigned blocks = (unsigned)std::min<size_t>((n + 255) / 256, 65535);
  flash_pad_rows<<<blocks, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<__nv_bfloat16*>(dst),
      rows, d, d8);
  return cudaGetLastError();
}

}  // namespace

// dynamic shared memory of one block at head_dim D, or padded width D = 192,
// or the wide route's DP = 320..512 (0: D not taken)
size_t flash_attention_sm90_smem_bytes(int D) {
  switch (D) {
    case 64:
      return Smem<64>::BYTES;
    case 128:
      return Smem<128>::BYTES;
    case 192:
      return Smem<192>::BYTES;
    case 256:
      return Smem<256>::BYTES;
    case 320:
      return WideSmem<320>::BYTES;
    case 384:
      return WideSmem<384>::BYTES;
    case 448:
      return WideSmem<448>::BYTES;
    case 512:
      return WideSmem<512>::BYTES;
    default:
      return 0;
  }
}

// bf16 q/k/v/o, 16-byte aligned; window <= 0: no sliding window;
// softcap <= 0: no softcap.
cudaError_t launch_flash_attention_sm90(const void* q, const void* k,
                                        const void* v, void* o, int BH,
                                        int BHkv, int Tq, int Tk, int D,
                                        int causal, int window, float softcap,
                                        float scale, cudaStream_t stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || Tq <= 0 || Tk <= 0 ||
      (Tq + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
          16 != 0)
    return cudaErrorMisalignedAddress;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, BH, BHkv, Tq, Tk, causal, window,
                        softcap, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, BH, BHkv, Tq, Tk, causal, window,
                         softcap, scale, stream);
    case 256:
      return launch<256>(q, k, v, o, BH, BHkv, Tq, Tk, causal, window,
                         softcap, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The padded route, bf16 at a head_dim d in 1..256: q (BH, Tq, d), k, v
// (BHkv, Tk, d), o (BH, Tq, d). d % 8 == 0: q, k, v 16-byte aligned, read
// in place. Otherwise q, k, v are first copied into qp, kp, vp (rows of d
// rounded up to 8, zeros past d; 16-byte aligned), the maps' rows.
cudaError_t launch_flash_attention_sm90_padded(
    const void* q, const void* k, const void* v, void* o, void* qp, void* kp,
    void* vp, int BH, int BHkv, int Tq, int Tk, int d, int causal,
    int window, float softcap, float scale, cudaStream_t stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || Tq <= 0 || Tk <= 0 ||
      d < 1 || d > 256 || (Tq + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  const int w = (d + 7) / 8 * 8;
  if (w != d) {
    cudaError_t err = pad_rows(q, qp, (size_t)BH * Tq, d, w, stream);
    if (err == cudaSuccess)
      err = pad_rows(k, kp, (size_t)BHkv * Tk, d, w, stream);
    if (err == cudaSuccess)
      err = pad_rows(v, vp, (size_t)BHkv * Tk, d, w, stream);
    if (err != cudaSuccess) return err;
    q = qp;
    k = kp;
    v = vp;
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int dp = (d + 63) / 64 * 64;
  switch (dp) {
    case 64:
      return launch_padded<64>(q, k, v, o, BH, BHkv, Tq, Tk, w, d, causal,
                               window, softcap, scale, stream);
    case 128:
      return launch_padded<128>(q, k, v, o, BH, BHkv, Tq, Tk, w, d, causal,
                                window, softcap, scale, stream);
    case 192:
      return launch_padded<192>(q, k, v, o, BH, BHkv, Tq, Tk, w, d, causal,
                                window, softcap, scale, stream);
    default:
      return launch_padded<256>(q, k, v, o, BH, BHkv, Tq, Tk, w, d, causal,
                                window, softcap, scale, stream);
  }
}

// The wide route, bf16 at a head_dim d in 257..512, padded to DP = d
// rounded up to 64; the rest as the padded route above.
cudaError_t launch_flash_attention_sm90_wide(
    const void* q, const void* k, const void* v, void* o, void* qp, void* kp,
    void* vp, int BH, int BHkv, int Tq, int Tk, int d, int causal,
    int window, float softcap, float scale, cudaStream_t stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || Tq <= 0 || Tk <= 0 ||
      d <= 256 || d > 512 || (Tq + WBQ - 1) / WBQ > 65535)
    return cudaErrorInvalidValue;
  const int w = (d + 7) / 8 * 8;
  if (w != d) {
    cudaError_t err = pad_rows(q, qp, (size_t)BH * Tq, d, w, stream);
    if (err == cudaSuccess)
      err = pad_rows(k, kp, (size_t)BHkv * Tk, d, w, stream);
    if (err == cudaSuccess)
      err = pad_rows(v, vp, (size_t)BHkv * Tk, d, w, stream);
    if (err != cudaSuccess) return err;
    q = qp;
    k = kp;
    v = vp;
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  switch ((d + 63) / 64 * 64) {
    case 320:
      return launch_wide<320>(q, k, v, o, BH, BHkv, Tq, Tk, w, d, causal,
                              window, softcap, scale, stream);
    case 384:
      return launch_wide<384>(q, k, v, o, BH, BHkv, Tq, Tk, w, d, causal,
                              window, softcap, scale, stream);
    case 448:
      return launch_wide<448>(q, k, v, o, BH, BHkv, Tq, Tk, w, d, causal,
                              window, softcap, scale, stream);
    default:
      return launch_wide<512>(q, k, v, o, BH, BHkv, Tq, Tk, w, d, causal,
                              window, softcap, scale, stream);
  }
}
