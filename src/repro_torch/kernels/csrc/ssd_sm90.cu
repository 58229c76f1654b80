// Mamba-2 SSD intra-chunk block for Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the Pallas kernel of repro/kernels/ssd/kernel.py
// (ssd_intra_chunk :65, body _ssd_chunk_kernel :26) for bfloat16 inputs at
// head_dim P = 64, chunk L = 64 or 128 and state N = 64 or 128 (mamba2-780m:
// P 64, N 128, L 128; zamba2-1.2b: P 64, N 64, L 128), and at L = 256
// (ssd_chunk_sm90_long, below). float32 inputs and other shapes keep the
// FFMA kernels of ssd.cu: the tensor cores would need TF32 for float32,
// which breaks the reference's 2e-4.
//
// Layout: xw (B,T,H,P), b and c (B,T,N) bf16; la (B,T,H) f32 log decays.
// Outputs: y (B,T,H,P) bf16, states (B,nc,H,P,N) f32, chunk decay (B,nc,H)
// f32. Per (b, chunk, head), as the reference:
//   cs    = cumsum(la) over the chunk
//   M     = (C.B^T) * tril(exp(cs_i - cs_j))          (L x L)
//   y     = M . X                                       (L x P)
//   state = sum_j x_j (b_j exp(cs_L - cs_j))^T          (P x N)
//   decay = exp(cs_L)
//
// Bound: at mamba2-780m's layer (B=2, T=8192, H=48) a launch moves ~414 MB
// (x and y in bf16, the f32 states, b, c and la) and does ~45 GFLOP on the
// tensor cores, so it is bound by bytes: ~0.124 ms at 3.35 TB/s. The design
// keeps HBM busy while the tensor cores work.
//
// Design. One block owns one (b, chunk) and a group of G <= 16 heads (the
// last group may be short); 128 (L / 64 + 1) threads: L / 64 consumer
// warpgroups, warpgroup W owning rows 64W..64W+63 of the chunk, and one
// producer warpgroup of which one thread issues every load.
//  - Loads by TMA with the 128-byte swizzle: B and C once per block (2-D
//    maps over (N, B*T), boxes of 64 columns x L rows), then each head's X
//    tile (a 3-D map over (P, H, B*T), box (64, 1, L): L rows of 128 B,
//    strided by H*P in memory) through a 2-stage ring with full and empty
//    mbarriers, so the next head's X is in flight while this one computes.
//    la of the block's heads is read once by ordinary loads; one warp a head
//    scans it into cs (times log2 e, for M) and w_j = exp(cs_L - cs_j) (for
//    the state), and writes exp(cs_L): every exponential of the state and
//    the decay is taken once per (head, j).
//  - C.B^T once per block on wgmma m64n64k16 (bf16 in, f32 sums, exact
//    products), kept in the consumers' registers for all G heads; warpgroup
//    0 computes only its live half (j < 64).
//  - M per head in registers: the mask j <= i and exp(cs_i - cs_j) (ex2 of
//    the log2 e-scaled difference) are applied in the accumulator's fragment
//    layout, and M is split as M_hi + M_lo in bf16, fed straight from
//    registers as the A operand (the accumulator's layout is the A
//    operand's, as in flash_attention_sm90.cu); a single bf16 M (2^-9
//    relative) would not hold the checks. y = M.X on wgmma m64n64k16 with X
//    the B operand read MN-major (the transpose bit), never transposed in
//    memory. Warpgroup 0 skips the masked quarter (j >= 64).
//  - The state as (X * w)^T . B: X * w is formed in f32 and split into bf16
//    hi and lo halves written at X's own swizzled positions (an elementwise
//    op keeps a row a row), both read MN-major as the A operand; B stays
//    exact in bf16, read MN-major as the B operand. Each warpgroup takes its
//    64-column boxes of N (at N = 64 warpgroup 0 takes all of it and
//    warpgroup 1 the larger share of M.X).
//  - Stores: y (bf16) and the states (f32) are written from registers into
//    double-buffered staging tiles in the TMA's swizzled layout (conflict
//    free), then leave by TMA tensor stores (y: box (64, 1, 64) per
//    warpgroup; states: boxes of 32 columns x 64 rows over (N, B*nc*H*P)),
//    which run on while the next head computes; a staging tile is rewritten
//    only once its store from two heads earlier has read it.
//  - Registers: C.B^T 64, y 32, state 32, M_hi/M_lo 64 floats a consumer
//    thread at L = 128; setmaxnreg gives consumers 240 and the producer 24.
//  - Shared memory at L = 128, N = 128: B 32 KB, C (then the y staging) 32
//    KB, X ring 32 KB, X*w hi/lo 32 KB, state staging 64 KB, cs and w 16 KB:
//    209 KB, one block an SM. In flight per SM: the next head's X (16 KB)
//    and up to two heads' stores (96 KB).
//  - Grid: (ceil(H / G), nc, B), heads fastest, so the blocks of one
//    (b, chunk) run side by side and share B and C in L2. The wrapper picks
//    G (kernels/ssd/kernel.py, heads_per_block_sm90).
#include "sm90.cuh"

namespace {

constexpr int P = 64;          // head_dim
constexpr int MAX_G = 16;      // heads a block
constexpr int STAGES = 2;      // X ring
constexpr float LOG2E = 1.4426950408889634f;

// shared memory: [slack to 1024-B alignment] B | C, then y staging x 2 |
// X x STAGES | X*w hi, lo | state staging x 2 | cs*log2e, w | barriers
template <int L, int N>
struct Layout {
  static constexpr int WGS = L / 64;                 // consumer warpgroups
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int NTHREADS = CONSUMERS + 128;
  static constexpr int NBOX = N / 64;                // 64-column boxes of N
  static constexpr int BOX = L * 128;                // one box of L rows
  static constexpr int B_BYTES = L * N * 2;
  static constexpr int X_BYTES = L * P * 2;          // = y tile
  static constexpr int S_BYTES = P * N * 4;          // N / 32 boxes of 8 KB
  static constexpr int CY_BYTES =
      B_BYTES > 2 * X_BYTES ? B_BYTES : 2 * X_BYTES;
  static constexpr int B_OFF = 0;
  static constexpr int CY_OFF = B_OFF + B_BYTES;
  static constexpr int X_OFF = CY_OFF + CY_BYTES;
  static constexpr int XW_OFF = X_OFF + STAGES * X_BYTES;
  static constexpr int S_OFF = XW_OFF + 2 * X_BYTES;
  static constexpr int CS_OFF = S_OFF + 2 * S_BYTES;
  static constexpr int BAR_OFF = CS_OFF + 2 * MAX_G * L * 4;
  // bc_full, x_full[STAGES], x_empty[STAGES]
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

// One consumer warpgroup W, from C.B^T to the last head's stores.
template <int L, int N, int W>
__device__ __forceinline__ void consume(
    uint8_t* smem, uint32_t base, const float* cs2, const float* wj,
    const CUtensorMap* map_y, const CUtensorMap* map_s, int H, int h0,
    int ng, size_t srow0, int row0) {
  using Ly = Layout<L, N>;
  constexpr int NH = W + 1;  // 64-column halves of C.B^T this warpgroup uses
  constexpr int SB =         // 64-column boxes of the state it owns
      W < Ly::NBOX ? (Ly::NBOX - W + Ly::WGS - 1) / Ly::WGS : 0;
  const uint32_t bc_full = base + Ly::BAR_OFF;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int lr0 = 16 * warp + lane / 4;  // rows lr0, lr0 + 8 of the 64
  const int r0 = 64 * W + lr0;           // ... as rows of the chunk
  const int q2 = 2 * (lane % 4);         // columns 8j + q2 + {0, 1}

  // K-major C and B (C.B^T); MN-major X, X*w and B; 1024 B between 8-row
  // groups, one box (BOX) between 64-column boxes
  const uint64_t dc = sw128_desc(base + Ly::CY_OFF + W * 64 * 128, 16, 1024);
  const uint64_t dbk = sw128_desc(base + Ly::B_OFF, 16, 1024);
  const uint64_t dbm = sw128_desc(base + Ly::B_OFF, Ly::BOX, 1024);
  const uint64_t dx = sw128_desc(base + Ly::X_OFF, Ly::BOX, 1024);
  const uint64_t dxw = sw128_desc(base + Ly::XW_OFF, Ly::BOX, 1024);

  float cb[NH][32];
  mbar_wait(bc_full, 0);
  wgmma_fence();
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int c = 0; c < Ly::NBOX; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(cb[hh], dc + ((c * Ly::BOX + kk * 32) >> 4),
                 dbk + ((c * Ly::BOX + hh * 64 * 128 + kk * 32) >> 4),
                 (c | kk) != 0);
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) fence_regs(cb[hh]);

  float yacc[32];
  float sacc[SB > 0 ? SB : 1][32];
  uint32_t mhi[NH][4][4], mlo[NH][4][4];
  for (int g = 0; g < ng; ++g) {
    const int s = g % STAGES, sb = g & 1;
    const uint32_t ph = (g / STAGES) & 1;
    const uint32_t x_full = base + Ly::BAR_OFF + 8 * (1 + s);
    const uint32_t x_empty = base + Ly::BAR_OFF + 8 * (1 + STAGES + s);
    const float* c2 = cs2 + g * L;

    // M = C.B^T * exp(cs_i - cs_j) on j <= i, as bf16 A fragments M_hi +
    // M_lo; fragment register x of step kk holds accumulator entries
    // r = 8kk + 2x + {0, 1}: row r0 + 8 (x % 2), columns 16kk + 8 (x / 2) +
    // q2 + {0, 1}
    const float ci[2] = {c2[r0], c2[r0 + 8]};
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = 8 * kk + 2 * x, row = r0 + 8 * (x % 2);
          const int col = 64 * hh + 16 * kk + 8 * (x / 2) + q2;
          const float2 cj = *reinterpret_cast<const float2*>(c2 + col);
          const float e0 = ex2(ci[x % 2] - cj.x), e1 = ex2(ci[x % 2] - cj.y);
          split_bf16(col <= row ? cb[hh][r] * e0 : 0.0f,
                     col + 1 <= row ? cb[hh][r + 1] * e1 : 0.0f,
                     mhi[hh][kk][x], mlo[hh][kk][x]);
        }

    // y = M . X
    mbar_wait(x_full, ph);
    wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db =
            dx + ((s * Ly::X_BYTES + (64 * hh + 16 * kk) * 128) >> 4);
        wgmma_rs(yacc, mhi[hh][kk], db, (hh | kk) != 0);
        wgmma_rs(yacc, mlo[hh][kk], db, 1);
      }
    wgmma_commit();

    // X * w, split hi / lo, at X's swizzled positions (row j = byte / 128),
    // once every warpgroup's state products of the last head are done
    named_sync(1, Ly::CONSUMERS);
    {
      const uint4* xs =
          reinterpret_cast<const uint4*>(smem + Ly::X_OFF + s * Ly::X_BYTES);
      uint4* hi = reinterpret_cast<uint4*>(smem + Ly::XW_OFF);
      uint4* lo = reinterpret_cast<uint4*>(smem + Ly::XW_OFF + Ly::X_BYTES);
      const float* wg = wj + g * L;
      for (int e = threadIdx.x; e < Ly::X_BYTES / 16; e += Ly::CONSUMERS) {
        const float w = wg[e / 8];
        uint4 v = xs[e], h, l;
        const uint32_t* vin = reinterpret_cast<const uint32_t*>(&v);
        uint32_t* ho = reinterpret_cast<uint32_t*>(&h);
        uint32_t* lw = reinterpret_cast<uint32_t*>(&l);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vin + k));
          split_bf16(f.x * w, f.y * w, ho[k], lw[k]);
        }
        hi[e] = h;
        lo[e] = l;
      }
    }
    fence_proxy_async();
    named_sync(1, Ly::CONSUMERS);

    // state (this warpgroup's 64-column boxes of N) = (X*w)^T . B
    if constexpr (SB > 0) {
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < SB; ++b) {
        const int c = W + b * Ly::WGS;
#pragma unroll
        for (int kk = 0; kk < L / 16; ++kk) {
          const uint64_t db = dbm + ((c * Ly::BOX + kk * 16 * 128) >> 4);
          wgmma_ss_mn(sacc[b], dxw + ((kk * 16 * 128) >> 4), db, kk != 0);
          wgmma_ss_mn(sacc[b], dxw + ((Ly::X_BYTES + kk * 16 * 128) >> 4),
                      db, 1);
        }
      }
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(yacc);
#pragma unroll
    for (int b = 0; b < SB; ++b) fence_regs(sacc[b]);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(mhi[hh][kk]);
        fence_regs(mlo[hh][kk]);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(x_empty);  // X of this stage is read

    // stores: staging tile sb was last read by this warpgroup's stores of
    // two heads ago
    if (tid == 0) bulk_wait_read<1>();
    named_sync(2 + W, 128);
    const uint32_t ys = Ly::CY_OFF + sb * Ly::X_BYTES + W * 64 * 128;
    const uint32_t ss = Ly::S_OFF + sb * Ly::S_BYTES;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lr = lr0 + 8 * i;  // row of the 64-row box; swizzle lr % 8
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            smem + ys + lr * 128 + ((j ^ (lr & 7)) << 4) + 2 * q2) =
            __floats2bfloat162_rn(yacc[4 * j + 2 * i],
                                  yacc[4 * j + 2 * i + 1]);
#pragma unroll
      for (int b = 0; b < SB; ++b) {
        const int c = W + b * Ly::WGS;
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // column 8j + q2 of the 64-column box
          const int box = 2 * c + j / 4, chunk = 2 * (j % 4) + q2 / 4;
          *reinterpret_cast<float2*>(smem + ss + box * 8192 + lr * 128 +
                                     ((chunk ^ (lr & 7)) << 4) +
                                     (4 * q2) % 16) =
              make_float2(sacc[b][4 * j + 2 * i], sacc[b][4 * j + 2 * i + 1]);
        }
      }
    }
    fence_proxy_async();
    named_sync(2 + W, 128);
    if (tid == 0) {
      tma_store(map_y, base + ys, 0, h0 + g, row0 + 64 * W);
#pragma unroll
      for (int b = 0; b < SB; ++b) {
        const int c = W + b * Ly::WGS;
#pragma unroll
        for (int k = 0; k < 2; ++k)
          tma_store(map_s, base + ss + (2 * c + k) * 8192, 32 * (2 * c + k),
                    (int)(srow0 + (size_t)g * P));
      }
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();
}

template <int L, int N>
__global__ void __launch_bounds__(Layout<L, N>::NTHREADS, 1)
    ssd_chunk_sm90(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_c,
                   const __grid_constant__ CUtensorMap map_y,
                   const __grid_constant__ CUtensorMap map_s,
                   const float* __restrict__ la, float* __restrict__ cd,
                   int T, int H, int G) {
  using Ly = Layout<L, N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = raw + pad;
  float* cs2 = reinterpret_cast<float*>(smem + Ly::CS_OFF);  // cs * log2 e
  float* wj = cs2 + MAX_G * L;  // la, then exp(cs_L - cs_j)
  const uint32_t bc_full = base + Ly::BAR_OFF;
#define X_FULL(s) (base + Ly::BAR_OFF + 8u * (1 + (s)))
#define X_EMPTY(s) (base + Ly::BAR_OFF + 8u * (1 + STAGES + (s)))

  const int h0 = blockIdx.x * G, ng = min(G, H - h0);
  const int ci = blockIdx.y, bi = blockIdx.z, nc = T / L;
  const int row0 = bi * T + ci * L;  // first (b, t) row of the chunk
  const size_t cd0 = ((size_t)bi * nc + ci) * H + h0;

  if (threadIdx.x == 0) {
    mbar_init(bc_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(X_FULL(s), 1);
      mbar_init(X_EMPTY(s), Ly::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= Ly::CONSUMERS) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == Ly::CONSUMERS) {
      mbar_expect_tx(bc_full, 2 * Ly::B_BYTES);
#pragma unroll
      for (int c = 0; c < Ly::NBOX; ++c) {
        tma_load_2d(base + Ly::B_OFF + c * Ly::BOX, &map_b, 64 * c, row0,
                    bc_full);
        tma_load_2d(base + Ly::CY_OFF + c * Ly::BOX, &map_c, 64 * c, row0,
                    bc_full);
      }
      for (int g = 0; g < ng; ++g) {
        const int s = g % STAGES;
        mbar_wait(X_EMPTY(s), ((g / STAGES) & 1) ^ 1);
        mbar_expect_tx(X_FULL(s), Ly::X_BYTES);
        tma_load(base + Ly::X_OFF + s * Ly::X_BYTES, &map_x, 0, h0 + g,
                 row0, X_FULL(s));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // la of the block's heads; one warp a head scans it (a lane takes L/32
  // consecutive steps, then a shuffle scan of the lanes' sums)
  for (int e = threadIdx.x; e < L * ng; e += Ly::CONSUMERS) {
    const int i = e / ng, g = e - i * ng;
    wj[g * L + i] = la[(size_t)(row0 + i) * H + h0 + g];
  }
  named_sync(1, Ly::CONSUMERS);
  {
    constexpr int PER = L / 32;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int g = warp; g < ng; g += Ly::CONSUMERS / 32) {
      float loc[PER], run = 0.0f;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        run += wj[g * L + lane * PER + e];
        loc[e] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += up;
      }
      const float excl = tot - run;
      const float last = __shfl_sync(0xffffffffu, excl + loc[PER - 1], 31);
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int i = lane * PER + e;
        const float cs = excl + loc[e];
        cs2[g * L + i] = cs * LOG2E;
        wj[g * L + i] = expf(last - cs);
      }
      if (lane == 0) cd[cd0 + g] = expf(last);
    }
  }
  named_sync(1, Ly::CONSUMERS);

  // first row of this block's states in the (B*nc*H*P, N) view
  const size_t srow0 = cd0 * P;
  if (threadIdx.x < 128) {
    consume<L, N, 0>(smem, base, cs2, wj, &map_y, &map_s, H, h0, ng, srow0,
                     row0);
  } else {
    if constexpr (Ly::WGS == 2)
      consume<L, N, 1>(smem, base, cs2, wj, &map_y, &map_s, H, h0, ng,
                       srow0, row0);
  }
#undef X_FULL
#undef X_EMPTY
}

// ---------------------------------------------------------------------------
// chunk 256: ssd_chunk_sm90_long
// ---------------------------------------------------------------------------
// The same function for bf16 at P = 64, L = 256, N = 64 or 128 (mamba2-780m's
// layer at chunk 256). The kernel above keeps each warpgroup's 64 x L slice
// of C.B^T in registers across heads, 128 floats a thread at L = 256, and its
// shared memory (B, C, an X ring, X*w hi/lo and the staging tiles) would
// need 336 KB at N = 128. So here:
//  - Four consumer warpgroups, W owning rows 64W..64W+63 of the chunk, and
//    one producer warpgroup of which one thread issues every load;
//    setmaxnreg gives the consumers 112 registers and the producer 24 (at
//    640 threads a block starts at 96). Warpgroup W loops over its live
//    key tiles j <= W, flash
//    style: the 64 x 64 tile S = C_W . B_j^T is recomputed for every head on
//    wgmma m64n64k16 (K-major C and B, as above), then masked (j == W),
//    scaled by exp(cs_i - cs_j) and split into M_hi + M_lo A fragments in
//    registers, and y_W += M . X_j. The recompute is ~32 of the launch's
//    ~90 GFLOP of wgmma at mamba2's layer: ~0.03 ms at the bf16 peak.
//  - The state as (X * w)^T . B, on wgmma with the transpose bits, in 64-row
//    tiles of X * w (hi and lo, 16 KB) formed in turn by the warpgroups that
//    own the state's 64-column boxes of N: 0 and 1 (those with the fewest key
//    tiles) at N = 128, 0 at N = 64.
//  - y and the states leave from registers by ordinary stores (a row's 4
//    lanes write 16 B of y and 32 B of a state: whole sectors of the state),
//    so no staging tile: shared memory at N = 128 is B 64 KB, C 64 KB, a
//    2-stage X ring 64 KB, the X * w tile 16 KB and cs, w 16 KB (G <= 8).
//  - la, the cs scan, w_j and the decay as above; the grid is (ceil(H / G),
//    nc, B) with G <= 8 heads a block (kernels/ssd/kernel.py,
//    heads_per_block_long).
// Bound at mamba2-780m's layer (B=2, T=8192, H=48): by bytes, 0.094 ms.
constexpr int LONG_L = 256;
constexpr int LONG_MAX_G = 8;
constexpr int LONG_WGS = LONG_L / 64;     // consumer warpgroups

// shared memory: [slack to 1024-B alignment] B | C | X x STAGES | X*w hi, lo
// (one 64-row tile) | cs*log2e, w | barriers
template <int N>
struct LongLayout {
  static constexpr int L = LONG_L;
  static constexpr int CONSUMERS = 128 * LONG_WGS;
  static constexpr int NTHREADS = CONSUMERS + 128;
  static constexpr int NBOX = N / 64;
  static constexpr int BOX = L * 128;
  static constexpr int B_BYTES = L * N * 2;
  static constexpr int X_BYTES = L * P * 2;
  static constexpr int XW_BYTES = 64 * P * 2;
  static constexpr int B_OFF = 0;
  static constexpr int C_OFF = B_OFF + B_BYTES;
  static constexpr int X_OFF = C_OFF + B_BYTES;
  static constexpr int XW_OFF = X_OFF + STAGES * X_BYTES;
  static constexpr int CS_OFF = XW_OFF + 2 * XW_BYTES;
  static constexpr int BAR_OFF = CS_OFF + 2 * LONG_MAX_G * L * 4;
  // bc_full, x_full[STAGES], x_empty[STAGES]
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

// One consumer warpgroup W of the long kernel, from the first head's y to
// the last head's state.
template <int N, int W>
__device__ __forceinline__ void consume_long(
    uint8_t* smem, uint32_t base, const float* cs2, const float* wj,
    __nv_bfloat16* __restrict__ y, float* __restrict__ st, int H, int h0,
    int ng, size_t srow0, int row0) {
  using Ly = LongLayout<N>;
  constexpr bool STATE = W < Ly::NBOX;  // owns 64-column box W of the state
  constexpr int ST_THREADS = 128 * Ly::NBOX;
  const uint32_t bc_full = base + Ly::BAR_OFF;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int lr0 = 16 * warp + lane / 4;  // rows lr0, lr0 + 8 of the 64
  const int r0 = 64 * W + lr0;           // ... as rows of the chunk
  const int q2 = 2 * (lane % 4);         // columns 8j + q2 + {0, 1}

  const uint64_t dc = sw128_desc(base + Ly::C_OFF + W * 64 * 128, 16, 1024);
  const uint64_t dbk = sw128_desc(base + Ly::B_OFF, 16, 1024);
  const uint64_t dbm = sw128_desc(base + Ly::B_OFF, Ly::BOX, 1024);
  const uint64_t dx = sw128_desc(base + Ly::X_OFF, Ly::BOX, 1024);
  const uint64_t dxw = sw128_desc(base + Ly::XW_OFF, Ly::BOX, 1024);

  mbar_wait(bc_full, 0);
  for (int g = 0; g < ng; ++g) {
    const int s = g % STAGES;
    const uint32_t ph = (g / STAGES) & 1;
    const uint32_t x_full = base + Ly::BAR_OFF + 8 * (1 + s);
    const uint32_t x_empty = base + Ly::BAR_OFF + 8 * (1 + STAGES + s);
    const float* c2 = cs2 + g * Ly::L;
    const float ci[2] = {c2[r0], c2[r0 + 8]};

    // y = sum over key tiles j <= W of M_Wj . X_j
    float yacc[32];
    mbar_wait(x_full, ph);
#pragma unroll
    for (int j = 0; j <= W; ++j) {
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < Ly::NBOX; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sc, dc + ((c * Ly::BOX + kk * 32) >> 4),
                   dbk + ((c * Ly::BOX + j * 64 * 128 + kk * 32) >> 4),
                   (c | kk) != 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      // M's fragment register x of step kk: row r0 + 8 (x % 2), columns
      // 64 j + 16 kk + 8 (x / 2) + q2 + {0, 1}; the mask only on j == W
      uint32_t mhi[4][4], mlo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = 8 * kk + 2 * x, row = r0 + 8 * (x % 2);
          const int col = 64 * j + 16 * kk + 8 * (x / 2) + q2;
          const float2 cj = *reinterpret_cast<const float2*>(c2 + col);
          const float e0 = ex2(ci[x % 2] - cj.x), e1 = ex2(ci[x % 2] - cj.y);
          if (j < W)
            split_bf16(sc[r] * e0, sc[r + 1] * e1, mhi[kk][x], mlo[kk][x]);
          else
            split_bf16(col <= row ? sc[r] * e0 : 0.0f,
                       col + 1 <= row ? sc[r + 1] * e1 : 0.0f, mhi[kk][x],
                       mlo[kk][x]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db =
            dx + ((s * Ly::X_BYTES + (64 * j + 16 * kk) * 128) >> 4);
        wgmma_rs(yacc, mhi[kk], db, (j | kk) != 0);
        wgmma_rs(yacc, mlo[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(yacc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(mhi[kk]);
        fence_regs(mlo[kk]);
      }
    }
    {
      __nv_bfloat16* yr = y + (size_t)(row0 + r0) * H * P +
                          (size_t)(h0 + g) * P + q2;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
          *reinterpret_cast<__nv_bfloat162*>(yr + (size_t)i * 8 * H * P +
                                             8 * jn) =
              __floats2bfloat162_rn(yacc[4 * jn + 2 * i],
                                    yacc[4 * jn + 2 * i + 1]);
    }

    if constexpr (!STATE) {
      __syncwarp();
      if (lane == 0) mbar_arrive(x_empty);  // X of this stage is read
    } else {
      // state box W = (X * w)^T . B, one 64-row tile of X * w at a time
      float sacc[32];
      const float* wg = wj + g * Ly::L;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        named_sync(2, ST_THREADS);  // the last tile's products are done
        const uint4* xs = reinterpret_cast<const uint4*>(
            smem + Ly::X_OFF + s * Ly::X_BYTES + i * Ly::XW_BYTES);
        uint4* hi = reinterpret_cast<uint4*>(smem + Ly::XW_OFF);
        uint4* lo = reinterpret_cast<uint4*>(smem + Ly::XW_OFF + Ly::XW_BYTES);
        for (int e = threadIdx.x; e < Ly::XW_BYTES / 16; e += ST_THREADS) {
          const float w = wg[64 * i + e / 8];
          uint4 v = xs[e], h, l;
          const uint32_t* vin = reinterpret_cast<const uint32_t*>(&v);
          uint32_t* ho = reinterpret_cast<uint32_t*>(&h);
          uint32_t* lw = reinterpret_cast<uint32_t*>(&l);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(vin + k));
            split_bf16(f.x * w, f.y * w, ho[k], lw[k]);
          }
          hi[e] = h;
          lo[e] = l;
        }
        fence_proxy_async();
        named_sync(2, ST_THREADS);
        if (i == 3) {
          __syncwarp();
          if (lane == 0) mbar_arrive(x_empty);  // X of this stage is read
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db =
              dbm + ((W * Ly::BOX + (64 * i + 16 * kk) * 128) >> 4);
          wgmma_ss_mn(sacc, dxw + ((kk * 16 * 128) >> 4), db, (i | kk) != 0);
          wgmma_ss_mn(sacc, dxw + ((Ly::XW_BYTES + kk * 16 * 128) >> 4), db,
                      1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sacc);
      }
      // rows p = lr0 + 8 i, columns 64 W + 8 jn + q2 + {0, 1}
      float* sr = st + (srow0 + (size_t)g * P + lr0) * N + 64 * W + q2;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
          *reinterpret_cast<float2*>(sr + (size_t)i * 8 * N + 8 * jn) =
              make_float2(sacc[4 * jn + 2 * i], sacc[4 * jn + 2 * i + 1]);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(LongLayout<N>::NTHREADS, 1)
    ssd_chunk_sm90_long(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_b,
                        const __grid_constant__ CUtensorMap map_c,
                        const float* __restrict__ la,
                        __nv_bfloat16* __restrict__ y,
                        float* __restrict__ st, float* __restrict__ cd, int T,
                        int H, int G) {
  using Ly = LongLayout<N>;
  constexpr int L = Ly::L;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = raw + pad;
  float* cs2 = reinterpret_cast<float*>(smem + Ly::CS_OFF);  // cs * log2 e
  float* wj = cs2 + LONG_MAX_G * L;  // la, then exp(cs_L - cs_j)
  const uint32_t bc_full = base + Ly::BAR_OFF;
#define X_FULL(s) (base + Ly::BAR_OFF + 8u * (1 + (s)))
#define X_EMPTY(s) (base + Ly::BAR_OFF + 8u * (1 + STAGES + (s)))

  const int h0 = blockIdx.x * G, ng = min(G, H - h0);
  const int ci = blockIdx.y, bi = blockIdx.z, nc = T / L;
  const int row0 = bi * T + ci * L;  // first (b, t) row of the chunk
  const size_t cd0 = ((size_t)bi * nc + ci) * H + h0;

  if (threadIdx.x == 0) {
    mbar_init(bc_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(X_FULL(s), 1);
      mbar_init(X_EMPTY(s), Ly::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= Ly::CONSUMERS) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == Ly::CONSUMERS) {
      mbar_expect_tx(bc_full, 2 * Ly::B_BYTES);
#pragma unroll
      for (int c = 0; c < Ly::NBOX; ++c) {
        tma_load_2d(base + Ly::B_OFF + c * Ly::BOX, &map_b, 64 * c, row0,
                    bc_full);
        tma_load_2d(base + Ly::C_OFF + c * Ly::BOX, &map_c, 64 * c, row0,
                    bc_full);
      }
      for (int g = 0; g < ng; ++g) {
        const int s = g % STAGES;
        mbar_wait(X_EMPTY(s), ((g / STAGES) & 1) ^ 1);
        mbar_expect_tx(X_FULL(s), Ly::X_BYTES);
        tma_load(base + Ly::X_OFF + s * Ly::X_BYTES, &map_x, 0, h0 + g,
                 row0, X_FULL(s));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n" ::: "memory");

  // la of the block's heads; one warp a head scans it (a lane takes L/32
  // consecutive steps, then a shuffle scan of the lanes' sums)
  for (int e = threadIdx.x; e < L * ng; e += Ly::CONSUMERS) {
    const int i = e / ng, g = e - i * ng;
    wj[g * L + i] = la[(size_t)(row0 + i) * H + h0 + g];
  }
  named_sync(1, Ly::CONSUMERS);
  {
    constexpr int PER = L / 32;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int g = warp; g < ng; g += Ly::CONSUMERS / 32) {
      float loc[PER], run = 0.0f;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        run += wj[g * L + lane * PER + e];
        loc[e] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += up;
      }
      const float excl = tot - run;
      const float last = __shfl_sync(0xffffffffu, excl + loc[PER - 1], 31);
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int i = lane * PER + e;
        const float cs = excl + loc[e];
        cs2[g * L + i] = cs * LOG2E;
        wj[g * L + i] = expf(last - cs);
      }
      if (lane == 0) cd[cd0 + g] = expf(last);
    }
  }
  named_sync(1, Ly::CONSUMERS);

  // first row of this block's states in the (B*nc*H*P, N) view
  const size_t srow0 = cd0 * P;
  switch (threadIdx.x / 128) {
    case 0:
      consume_long<N, 0>(smem, base, cs2, wj, y, st, H, h0, ng, srow0, row0);
      break;
    case 1:
      consume_long<N, 1>(smem, base, cs2, wj, y, st, H, h0, ng, srow0, row0);
      break;
    case 2:
      consume_long<N, 2>(smem, base, cs2, wj, y, st, H, h0, ng, srow0, row0);
      break;
    default:
      consume_long<N, 3>(smem, base, cs2, wj, y, st, H, h0, ng, srow0, row0);
      break;
  }
#undef X_FULL
#undef X_EMPTY
}

// a tiled map with the 128-byte swizzle; dims and box innermost first,
// strides (bytes) of every dimension but the first
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
              const void* ptr, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int L, int N>
cudaError_t launch(const void* xw, const float* la, const void* b,
                   const void* c, void* y, float* st, float* cd, int B, int T,
                   int H, int G, cudaStream_t stream) {
  const CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t rows = (cuuint64_t)B * T;
  const cuuint64_t xdims[3] = {P, (cuuint64_t)H, rows};
  const cuuint64_t xstrides[2] = {P * 2, (cuuint64_t)H * P * 2};
  const cuuint32_t xbox[3] = {64, 1, L}, ybox[3] = {64, 1, 64};
  const cuuint64_t bdims[2] = {N, rows}, bstrides[1] = {N * 2};
  const cuuint32_t bbox[2] = {64, L};
  const cuuint64_t sdims[2] = {N, rows / L * H * P}, sstrides[1] = {N * 4};
  const cuuint32_t sbox[2] = {32, 64};
  CUtensorMap mx, mb, mc, my, ms;
  if (!make_map(&mx, BF16, 3, xw, xdims, xstrides, xbox) ||
      !make_map(&mb, BF16, 2, b, bdims, bstrides, bbox) ||
      !make_map(&mc, BF16, 2, c, bdims, bstrides, bbox) ||
      !make_map(&my, BF16, 3, y, xdims, xstrides, ybox) ||
      !make_map(&ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, st, sdims, sstrides,
                sbox))
    return cudaErrorInvalidValue;
  const int smem = Layout<L, N>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_sm90<L, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + G - 1) / G, T / L, B);
  ssd_chunk_sm90<L, N><<<grid, Layout<L, N>::NTHREADS, smem, stream>>>(
      mx, mb, mc, my, ms, la, cd, T, H, G);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_long(const void* xw, const float* la, const void* b,
                        const void* c, void* y, float* st, float* cd, int B,
                        int T, int H, int G, cudaStream_t stream) {
  const CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t rows = (cuuint64_t)B * T;
  const cuuint64_t xdims[3] = {P, (cuuint64_t)H, rows};
  const cuuint64_t xstrides[2] = {P * 2, (cuuint64_t)H * P * 2};
  const cuuint32_t xbox[3] = {64, 1, LONG_L};
  const cuuint64_t bdims[2] = {N, rows}, bstrides[1] = {N * 2};
  const cuuint32_t bbox[2] = {64, LONG_L};
  CUtensorMap mx, mb, mc;
  if (!make_map(&mx, BF16, 3, xw, xdims, xstrides, xbox) ||
      !make_map(&mb, BF16, 2, b, bdims, bstrides, bbox) ||
      !make_map(&mc, BF16, 2, c, bdims, bstrides, bbox))
    return cudaErrorInvalidValue;
  const int smem = LongLayout<N>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_sm90_long<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + G - 1) / G, T / LONG_L, B);
  ssd_chunk_sm90_long<N><<<grid, LongLayout<N>::NTHREADS, smem, stream>>>(
      mx, mb, mc, la, reinterpret_cast<__nv_bfloat16*>(y), st, cd, T, H, G);
  return cudaGetLastError();
}

}  // namespace

// dynamic shared memory of one block of ssd_chunk_sm90_long (0: the shape
// is not taken)
size_t ssd_sm90_long_smem_bytes(int L, int P_, int N) {
  if (P_ != P || L != LONG_L) return 0;
  if (N == 64) return LongLayout<64>::BYTES;
  if (N == 128) return LongLayout<128>::BYTES;
  return 0;
}

// Requires P == 64, L == 256, N in {64, 128}, T % L == 0, 1 <= G <= 8 and
// 16-byte aligned tensors (the wrapper checks these).
cudaError_t launch_ssd_chunk_sm90_long(const void* xw, const float* la,
                                       const void* b, const void* c, void* y,
                                       float* st, float* cd, int B, int T,
                                       int H, int P_, int N, int L, int G,
                                       cudaStream_t stream) {
  if (ssd_sm90_long_smem_bytes(L, P_, N) == 0 || B <= 0 || T <= 0 ||
      T % L || H <= 0 || G < 1 || G > LONG_MAX_G)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(xw) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(st)) %
          16 != 0)
    return cudaErrorMisalignedAddress;
  return N == 64
             ? launch_long<64>(xw, la, b, c, y, st, cd, B, T, H, G, stream)
             : launch_long<128>(xw, la, b, c, y, st, cd, B, T, H, G, stream);
}

// dynamic shared memory of one block (0: the shape is not taken)
size_t ssd_sm90_smem_bytes(int L, int P_, int N) {
  if (P_ != P) return 0;
  if (L == 64 && N == 64) return Layout<64, 64>::BYTES;
  if (L == 64 && N == 128) return Layout<64, 128>::BYTES;
  if (L == 128 && N == 64) return Layout<128, 64>::BYTES;
  if (L == 128 && N == 128) return Layout<128, 128>::BYTES;
  return 0;
}

// Requires P == 64, L and N in {64, 128}, T % L == 0, 1 <= G <= 16 and
// 16-byte aligned tensors (the wrapper checks these).
cudaError_t launch_ssd_chunk_sm90(const void* xw, const float* la,
                                  const void* b, const void* c, void* y,
                                  float* st, float* cd, int B, int T, int H,
                                  int P_, int N, int L, int G,
                                  cudaStream_t stream) {
  if (ssd_sm90_smem_bytes(L, P_, N) == 0 || B <= 0 || T <= 0 || T % L ||
      H <= 0 || G < 1 || G > MAX_G)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(xw) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(st)) %
          16 != 0)
    return cudaErrorMisalignedAddress;
  if (L == 64)
    return N == 64 ? launch<64, 64>(xw, la, b, c, y, st, cd, B, T, H, G,
                                    stream)
                   : launch<64, 128>(xw, la, b, c, y, st, cd, B, T, H, G,
                                     stream);
  return N == 64
             ? launch<128, 64>(xw, la, b, c, y, st, cd, B, T, H, G, stream)
             : launch<128, 128>(xw, la, b, c, y, st, cd, B, T, H, G, stream);
}
