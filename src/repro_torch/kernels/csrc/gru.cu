// GRU recurrence kernels for Hopper (sm_90a).
//
// Replace the Pallas kernels of repro/kernels/gru/kernel.py:
//   gru_fwd (H <= 128), gru_fwd_cluster (128 < H <= 512), gru_fwd_stream
//   (H > 512)                <- _gru_forward / _gru_kernel (the recurrence)
//   gru_bwd_gates, gru_bwd_chain (H <= 128), gru_bwd_chain_cluster
//   (128 < H <= 512) or gru_bwd_chain_stream (H > 512), gru_bwd_weights,
//   gru_bwd_weights_sum
//                            <- _gru_backward / _gru_bwd_kernel (its adjoint)
//
// Layout (leading agent axis A; the reference vmaps the scan over agents):
//   gi (A,T,B,3H) = x.W_i + b_i, precomputed outside;  wh (A,H,3H);
//   bh (A,3H);  h0 (A,B,H);  resets (A,T,B);  hs (A,T,B,H).  All float32.
// Every product is fp32 FFMA: no tensor cores (TF32 would break the
// reference's 1e-5), no fast-math intrinsics, no atomics.
//
// What bounds it. The recurrence is T dependent steps of a small product
// (h.W_h is R x H by H x 3H for a tile of R batch rows): a step's latency
// sets the time, not the bytes (each input is read once) nor the card's
// FLOPs. Inside a step, on one SM, the costs are (counted on the card with
// clock64() marks in a development build):
//  - shared-memory delivery to the product: an SM hands 128 bytes a clock
//    from shared memory to registers, and a broadcast float4 load still
//    costs a warp four of those clocks, so a product whose operand comes
//    from shared memory is bound by it unless each float loaded feeds >= 4
//    FFMA (128 FFMA lanes against 32 floats a clock);
//  - the gate algebra (expf, the reciprocal, tanhf), issue-bound;
//  - the L1 traffic of each lane's own loads of the step's inputs;
//  - a load whose value is used at once: the lane waits for device memory.
// The design:
//  * Thread (v, s) owns UPT hidden units and slice s (of KS) of the
//    reduction axis, and computes partial sums for all R rows of the tile
//    at once (registers blocked over rows and units), so each weight is
//    read once a step and each float of h (or dgh) it loads feeds 3*UPT
//    (forward) or UPT (chain) FFMA. Forward: 1 unit, 4 lanes; chain: 2
//    units, 8 lanes (the faster of the mappings tried on the card). The
//    rows of h and dgh are laid out so that the KS lanes of a unit read
//    consecutive float4s (slot() below): conflict-free broadcasts.
//  * The KS partial sums are folded by warp shuffles that also scatter the
//    rows (reduce-scatter): lane s ends with the finished sums of R/KS
//    rows and runs the gate algebra of those rows for its units, so h
//    (forward) and the carried adjoint (backward) stay in its registers
//    from step to step. Only h (or dgh) goes through shared memory,
//    double-buffered: one barrier a step.
//  * A step's inputs (gi, resets; backward also gh, g, h_{t-1}) are loaded
//    two steps ahead into one of two named register sets (the step loop is
//    unrolled by two), raw, from addresses clamped into the tensors:
//    nothing is computed from a loaded value before the step that uses it
//    (a select or `1 - reset` at load time made every load wait).
//  * H <= 64: W_h stays in registers for all T steps (the "persistent RNN"
//    layout; 48 floats a thread). 64 < H <= 128: W_h (49,152 floats at
//    H=128) cannot live in one block's registers, so it lives in shared
//    memory (rows padded against bank conflicts) and is read once a step
//    for all rows of the tile. This was chosen over a 2-block cluster
//    splitting the 3H columns: a cluster doubles the blocks of a card the
//    main path's 100 agents already nearly fill (132 SMs), and adds a
//    cluster barrier and a DSMEM exchange to every step, to save weight
//    reads that the row blocking already shares over R rows.
//  * The wrapper picks R (2, 4 or 8 rows a tile) from the grid: fewer rows
//    a block shorten its steps, so a card with idle SMs takes smaller
//    tiles (kernels/gru/kernel.py, tile_rows).
//  * H > 128 (gru_fwd_stream, gru_bwd_chain_stream): W_h is 3H x H floats,
//    786,432 bytes at H=256, more than a block's 232,448 of shared memory,
//    so it cannot stay resident. It is streamed from global memory every
//    step instead: an agent's W_h (3 MiB at H=512) is read by all its
//    tiles each step and stays in the 50 MB L2 when the agents' weights
//    fit there. Thread u owns unit u (a loop over units when H exceeds
//    the block) and reads column u of each gate, so a warp's loads are
//    coalesced, and each weight feeds the R rows of the tile from
//    registers: in a block no weight is read by two threads, so staging
//    it in shared memory would add a copy and save no read. Only h (the
//    forward) or dgh and the adjoint (the chain) live in shared memory.
//    The chain's dgh.W_h^T reads rows of W_h: a warp owns a unit, its
//    lanes stride the 3H columns (coalesced), and a fixed shuffle tree
//    sums them, so the bits repeat from run to run. This design is the
//    simple one and has no bound on H but shared memory (2 R H floats
//    forward, 4 R H the chain); both directions keep it above 512 only,
//    and for short sequences on grids of more clusters than the card
//    holds at once (kernels/gru/kernel.py, forward_route, backward_route).
//  * 128 < H <= 512, the forward (gru_fwd_cluster): a thread-block cluster
//    of C CTAs (up to 16) takes one (agent, tile of R rows), and CTA c
//    holds the 3H/C columns of W_h of its H/C units in shared memory for
//    all T steps -- resident weights again, which the cluster makes room
//    for (at H <= 128 it was rejected, above). At the AIP's H=256 a CTA's
//    slice is 98 KB (C = 8, R = 64 rows); at 512, 196 KB (C = 16, R = 8).
//    So W_h is read from memory once a tile, not once a step, and the
//    step's R x H x 3H FMA run from shared memory at 8 (W) and 12 (h)
//    FMA a float loaded. Each CTA runs the gate algebra of its units and
//    writes its slice of the new h into every CTA's copy over distributed
//    shared memory: one cluster barrier a step. The wrapper picks C and R
//    (kernels/gru/kernel.py, cluster_plan), and streams instead where the
//    load of the W_h slices costs more than it saves (forward_route: a
//    short sequence on a grid of more clusters than the card holds at
//    once; benchmarks/torch_tree_times.py --gru-sweep measures both).
//  * 128 < H <= 512, the backward's chain (gru_bwd_chain_cluster): the
//    forward's plan and W_h slices, dh_{t-1} reduce-scattered over the
//    cluster once a step (see the kernel).
//
// The backward splits the serial chain from the parallel work:
//   1. gru_bwd_gates: gh = hp.W_h + b_h for all T.B rows of an agent at
//      once, hp = [h0, hs[:-1]] masked by the reset: a tiled FFMA GEMM,
//      parallel over (agent, 64-row tile, 192-column tile).
//   2. gru_bwd_chain: the adjoint T-1 -> 0. Per step only the gate algebra,
//      dgi, dgh = [da_r, da_z, da_n r] and dh_{t-1} = (d z + dgh.W_h^T)
//      (1 - reset_t); W_h^T is held like the forward's W_h. It writes dgi
//      and r (phase 3 rebuilds dgh from them).
//   3. gru_bwd_weights: dW_h = sum_{t,b} hp^T dgh and db_h = sum dgh over
//      all T.B rows of an agent, parallel over (agent, 64x192 tile of
//      dW_h, slice of rows); gru_bwd_weights_sum then adds the slices in
//      slice order. Rows are summed in a fixed order and nothing is
//      atomic, so the result has the same bits from run to run.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

// 1 / (1 + e^-x): the correctly rounded reciprocal is the correctly
// rounded quotient 1 / y, in fewer instructions than the division
__device__ __forceinline__ float sigmoid_f32(float x) {
  return __frcp_rn(1.0f + expf(-x));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Where element x (of a row cut into KS slices of KPT) is kept, so that
// lane s reads its q-th float4 of the row at ((q * KS) + s) * 4.
template <int KS, int KPT>
__device__ __forceinline__ int slot(int x) {
  const int s = x / KPT, i = x - s * KPT;
  return ((i >> 2) * KS + s) * 4 + (i & 3);
}

// One exchange of the reduce-scatter over lanes s and s ^ M: rows [0, N)
// of v become [0, N/2), this lane's half, summed over both lanes; with one
// row left (N == 1) both lanes keep the whole sum. Lane s sits at lane
// STRIDE * s of its group (the shuffle goes STRIDE * M lanes away).
template <int N, int M, int G, int R, int STRIDE = 1>
struct Fold {
  static __device__ __forceinline__ void run(float (&v)[R][G], int s) {
    if constexpr (N >= 2) {
      const bool up = (s & M) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float send = up ? v[i][g] : v[i + N / 2][g];
          const float keep = up ? v[i + N / 2][g] : v[i][g];
          v[i][g] = keep + __shfl_xor_sync(FULL_MASK, send, M * STRIDE);
        }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g)
        v[0][g] += __shfl_xor_sync(FULL_MASK, v[0][g], M * STRIDE);
    }
    Fold<(N >= 2 ? N / 2 : 1), M / 2, G, R, STRIDE>::run(v, s);
  }
};
template <int N, int G, int R, int STRIDE>
struct Fold<N, 0, G, R, STRIDE> {
  static __device__ __forceinline__ void run(float (&)[R][G], int) {}
};

// The rows a lane owns after the fold over KS lanes: [base, base + RL);
// with R < KS, DUP lanes hold each row and the first of them writes it.
template <int R, int KS>
struct Rows {
  static constexpr int RL = R >= KS ? R / KS : 1;
  static constexpr int DUP = R >= KS ? 1 : KS / R;
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
// One block per (agent, tile of R rows); NV * KS threads, NV = UP / UPT
// unit groups (UP = H padded so that warps are whole, Cfg::units). Thread
// (v, s) owns units v + p * NV (p < UPT) and elements [s * KPT, + KPT) of
// the k axis: W_h in registers with KPT = 16 (H <= 64), in shared memory
// with KPT = 32 (H <= 128).
template <int UPT, int KS, int KPT, int R, bool WREG>
__global__ void __launch_bounds__(WREG ? 256 : 512)
gru_fwd(const float* __restrict__ gi, const float* __restrict__ wh,
        const float* __restrict__ bh, const float* __restrict__ h0,
        const float* __restrict__ resets, float* __restrict__ hs, int T,
        int B, int H, int UP) {
  constexpr int HP = KS * KPT, Q = KPT / 4, WST = HP + 16, G = 3 * UPT;
  constexpr int RL = Rows<R, KS>::RL, DUP = Rows<R, KS>::DUP;
  static_assert(HP % 32 == 0 && KPT % 4 == 0, "rows of whole float4s");
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                 // 2 x R x HP, double-buffered h
  float* w_s = smem + 2 * R * HP;    // 3 UP x WST (W_h in shared memory)
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int NV = UP / UPT, v = tid / KS, s = tid % KS;
  const int a = blockIdx.x, b0 = blockIdx.y * R;
  const int H3 = 3 * H;
  const int base = (s / DUP) * RL;
  const bool lead = s % DUP == 0;
  const float* wa = wh + (size_t)a * H * H3;
  int u[UPT];
  bool unit[UPT];
#pragma unroll
  for (int p = 0; p < UPT; ++p) {
    u[p] = v + p * NV;
    unit[p] = u[p] < H;
  }

  for (int e = tid; e < 2 * R * HP; e += nthr) h_s[e] = 0.0f;
  if constexpr (!WREG)
    for (int e = tid; e < 3 * UP * WST; e += nthr) w_s[e] = 0.0f;
  float w[WREG ? UPT : 1][3][WREG ? KPT : 1];
  if constexpr (WREG) {
#pragma unroll
    for (int p = 0; p < UPT; ++p)
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const int k = s * KPT + i;
          w[p][g][i] = (unit[p] && k < H)
                           ? wa[(size_t)k * H3 + g * H + u[p]] : 0.0f;
        }
  }
  float bias[UPT][3], h[RL][UPT];
#pragma unroll
  for (int p = 0; p < UPT; ++p)
#pragma unroll
    for (int g = 0; g < 3; ++g)
      bias[p][g] = unit[p] ? bh[(size_t)a * H3 + g * H + u[p]] : 0.0f;

  // step t's inputs: gi of step t, and the reset of step t + 1 (h is
  // masked by it at the end of step t, before step t + 1 reads it). Raw
  // loads from addresses clamped into the tensors: nothing is computed
  // from them before the step that uses them, so no lane waits on them.
  struct In {
    float gi[RL][UPT][3], reset_next[RL];
  };
  auto load = [&](int t, In& in) {
    const int tc = min(t, T - 1), tn = min(t + 1, T - 1);
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int b = min(b0 + base + i, B - 1);
      const size_t row = ((size_t)a * T + tc) * B + b;
      in.reset_next[i] = resets[((size_t)a * T + tn) * B + b];
#pragma unroll
      for (int p = 0; p < UPT; ++p)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          in.gi[i][p][g] = gi[row * H3 + g * H + min(u[p], H - 1)];
    }
  };
  In in0, in1;
  load(0, in0);
  load(1, in1);
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const int b = b0 + base + i;
    const float keep = b < B ? 1.0f - resets[(size_t)a * T * B + b] : 0.0f;
#pragma unroll
    for (int p = 0; p < UPT; ++p)
      h[i][p] = (unit[p] && b < B)
                    ? h0[((size_t)a * B + b) * H + u[p]] * keep : 0.0f;
  }
  __syncthreads();  // the zero fill is done before anything is written
  if constexpr (!WREG)
    for (int e = tid; e < H * H3; e += nthr) {   // coalesced in global
      const int k = e / H3, c = e - k * H3, g = c / H, uu = c - g * H;
      w_s[(g * UP + uu) * WST + slot<KS, KPT>(k)] = wa[e];
    }
  if (lead)
#pragma unroll
    for (int i = 0; i < RL; ++i)
#pragma unroll
      for (int p = 0; p < UPT; ++p)
        if (unit[p]) h_s[(base + i) * HP + slot<KS, KPT>(u[p])] = h[i][p];
  __syncthreads();

  auto step = [&](int t, const In& in) {
    const float* hc = h_s + (t & 1) * R * HP;
    float* hn_s = h_s + ((t + 1) & 1) * R * HP;
    float acc[R][G];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < G; ++c) acc[r][c] = 0.0f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float wq[UPT][3][4];
#pragma unroll
      for (int p = 0; p < UPT; ++p)
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          if constexpr (WREG) {
#pragma unroll
            for (int e = 0; e < 4; ++e) wq[p][g][e] = w[p][g][q * 4 + e];
          } else {
            const float4 x =
                ld4(w_s + (g * UP + u[p]) * WST + (q * KS + s) * 4);
            wq[p][g][0] = x.x; wq[p][g][1] = x.y;
            wq[p][g][2] = x.z; wq[p][g][3] = x.w;
          }
        }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 hv = ld4(hc + r * HP + (q * KS + s) * 4);
#pragma unroll
        for (int p = 0; p < UPT; ++p)
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            float& c = acc[r][p * 3 + g];
            c = fmaf(hv.x, wq[p][g][0], c);
            c = fmaf(hv.y, wq[p][g][1], c);
            c = fmaf(hv.z, wq[p][g][2], c);
            c = fmaf(hv.w, wq[p][g][3], c);
          }
      }
    }
    Fold<R, KS / 2, G, R>::run(acc, s);
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int b = b0 + base + i;
      const float keep_next =
          (b < B && t + 1 < T) ? 1.0f - in.reset_next[i] : 0.0f;
#pragma unroll
      for (int p = 0; p < UPT; ++p) {
        const float r =
            sigmoid_f32(in.gi[i][p][0] + (acc[i][p * 3] + bias[p][0]));
        const float z =
            sigmoid_f32(in.gi[i][p][1] + (acc[i][p * 3 + 1] + bias[p][1]));
        const float n =
            tanhf(in.gi[i][p][2] + r * (acc[i][p * 3 + 2] + bias[p][2]));
        const float hn = (1.0f - z) * n + z * h[i][p];
        const bool w_ok = lead && unit[p];
        if (w_ok && b < B) hs[(((size_t)a * T + t) * B + b) * H + u[p]] = hn;
        h[i][p] = hn * keep_next;   // masked as step t + 1 reads it
        if (w_ok) hn_s[(base + i) * HP + slot<KS, KPT>(u[p])] = h[i][p];
      }
    }
    __syncthreads();
  };

  // two named input sets: step t + 2's inputs load while step t + 1 runs
  for (int t = 0; t < T; t += 2) {
    step(t, in0);
    load(t + 2, in0);
    if (t + 1 < T) {
      step(t + 1, in1);
      load(t + 3, in1);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, phase 2: the serial adjoint chain
// ---------------------------------------------------------------------------
// Thread (v, s) owns units v + p * NV (p < UPT): their outputs of
// dh = dgh.W_h^T over slice s (of KS) of the 3H columns, and their gate
// algebra for the rows it owns after the fold. W_h^T in registers with
// KPT = 24 (H <= 64), in shared memory with KPT = 48 (H <= 128).
template <int UPT, int KS, int KPT, int R, bool WREG>
__global__ void __launch_bounds__(WREG ? 256 : 512)
gru_bwd_chain(const float* __restrict__ gi, const float* __restrict__ wh,
              const float* __restrict__ gh, const float* __restrict__ h0,
              const float* __restrict__ resets, const float* __restrict__ hs,
              const float* __restrict__ g, float* __restrict__ dgi,
              float* __restrict__ rgate, float* __restrict__ dh0, int T,
              int B, int H, int UP) {
  constexpr int CP = KS * KPT, Q = KPT / 4, WST = CP + 16;
  constexpr int RL = Rows<R, KS>::RL, DUP = Rows<R, KS>::DUP;
  static_assert(CP % 32 == 0 && KPT % 4 == 0, "rows of whole float4s");
  extern __shared__ __align__(16) float smem[];
  float* dg_s = smem;                 // 2 x R x CP, double-buffered dgh
  float* w_s = smem + 2 * R * CP;     // UP x WST (W_h in shared memory)
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int NV = UP / UPT, v = tid / KS, s = tid % KS;
  const int a = blockIdx.x, b0 = blockIdx.y * R;
  const int H3 = 3 * H;
  const int base = (s / DUP) * RL;
  const bool lead = s % DUP == 0;
  const float* wa = wh + (size_t)a * H * H3;
  int u[UPT];
  bool unit[UPT];
#pragma unroll
  for (int p = 0; p < UPT; ++p) {
    u[p] = v + p * NV;
    unit[p] = u[p] < H;
  }

  for (int e = tid; e < 2 * R * CP; e += nthr) dg_s[e] = 0.0f;
  if constexpr (!WREG)
    for (int e = tid; e < UP * WST; e += nthr) w_s[e] = 0.0f;
  float w[WREG ? UPT : 1][WREG ? KPT : 1];
  if constexpr (WREG) {
#pragma unroll
    for (int p = 0; p < UPT; ++p)
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int c = s * KPT + i;
        w[p][i] = (unit[p] && c < H3) ? wa[(size_t)u[p] * H3 + c] : 0.0f;
      }
  }

  // step t's inputs for the rows and units this lane owns: raw loads from
  // addresses clamped into the tensors, used only when the step runs (see
  // the forward; rows past B get keep 0 at use)
  struct In {
    float reset[RL], hprev[RL][UPT], gout[RL][UPT], gh[RL][UPT][3],
        gi[RL][UPT][3];
  };
  auto load = [&](int t, In& in) {
    const int tc = max(t, 0);
    const float* hrows = tc > 0 ? hs + ((size_t)a * T + tc - 1) * B * H
                                : h0 + (size_t)a * B * H;
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int b = min(b0 + base + i, B - 1);
      const size_t row = ((size_t)a * T + tc) * B + b;
      in.reset[i] = resets[row];
#pragma unroll
      for (int p = 0; p < UPT; ++p) {
        const int uc = min(u[p], H - 1);
        in.hprev[i][p] = hrows[(size_t)b * H + uc];
        in.gout[i][p] = g[row * H + uc];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          in.gh[i][p][q] = gh[row * H3 + q * H + uc];
          in.gi[i][p][q] = gi[row * H3 + q * H + uc];
        }
      }
    }
  };
  In in0, in1;
  load(T - 1, in0);
  load(T - 2, in1);
  __syncthreads();  // the zero fill is done before anything is written
  if constexpr (!WREG)
    for (int e = tid; e < H * H3; e += nthr) {   // coalesced in global
      const int k = e / H3, c = e - k * H3;
      w_s[k * WST + slot<KS, KPT>(c)] = wa[e];
    }

  float dh[RL][UPT];  // adjoint carried onto h_t
#pragma unroll
  for (int i = 0; i < RL; ++i)
#pragma unroll
    for (int p = 0; p < UPT; ++p) dh[i][p] = 0.0f;

  auto step = [&](int t, const In& in) {
    float* dgc = dg_s + (t & 1) * R * CP;
    float dz_h[RL][UPT];   // d * z, the direct path onto h_{t-1}
    float keep[RL];
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int b = b0 + base + i;
      keep[i] = b < B ? 1.0f - in.reset[i] : 0.0f;
#pragma unroll
      for (int p = 0; p < UPT; ++p) {
        const float gh_n = in.gh[i][p][2];
        const float r = sigmoid_f32(in.gi[i][p][0] + in.gh[i][p][0]);
        const float z = sigmoid_f32(in.gi[i][p][1] + in.gh[i][p][1]);
        const float n = tanhf(in.gi[i][p][2] + r * gh_n);
        const float d = in.gout[i][p] + dh[i][p];  // total adjoint on h_t
        const float dn = d * (1.0f - z);
        const float dz = d * (in.hprev[i][p] * keep[i] - n);
        dz_h[i][p] = d * z;
        const float da_n = dn * (1.0f - n * n);
        const float da_z = dz * z * (1.0f - z);
        const float da_r = da_n * gh_n * r * (1.0f - r);
        const bool w_ok = lead && unit[p];
        if (w_ok && b < B) {
          const size_t row = ((size_t)a * T + t) * B + b;
          float* dgo = dgi + row * H3;
          dgo[u[p]] = da_r;
          dgo[H + u[p]] = da_z;
          dgo[2 * H + u[p]] = da_n;
          rgate[row * H + u[p]] = r;
        }
        if (w_ok) {
          float* dgrow = dgc + (base + i) * CP;
          dgrow[slot<KS, KPT>(u[p])] = da_r;
          dgrow[slot<KS, KPT>(H + u[p])] = da_z;
          dgrow[slot<KS, KPT>(2 * H + u[p])] = da_n * r;
        }
      }
    }
    __syncthreads();  // dgh of step t (and, once, W_h) is in shared memory

    float acc[R][UPT];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int p = 0; p < UPT; ++p) acc[r][p] = 0.0f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float wq[UPT][4];
#pragma unroll
      for (int p = 0; p < UPT; ++p) {
        if constexpr (WREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) wq[p][e] = w[p][q * 4 + e];
        } else {
          const float4 x = ld4(w_s + u[p] * WST + (q * KS + s) * 4);
          wq[p][0] = x.x; wq[p][1] = x.y; wq[p][2] = x.z; wq[p][3] = x.w;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 dv = ld4(dgc + r * CP + (q * KS + s) * 4);
#pragma unroll
        for (int p = 0; p < UPT; ++p) {
          float& c = acc[r][p];
          c = fmaf(dv.x, wq[p][0], c);
          c = fmaf(dv.y, wq[p][1], c);
          c = fmaf(dv.z, wq[p][2], c);
          c = fmaf(dv.w, wq[p][3], c);
        }
      }
    }
    Fold<R, KS / 2, UPT, R>::run(acc, s);
#pragma unroll
    for (int i = 0; i < RL; ++i)
#pragma unroll
      for (int p = 0; p < UPT; ++p)
        dh[i][p] = (dz_h[i][p] + acc[i][p]) * keep[i];
  };

  for (int t = T - 1; t >= 0; t -= 2) {   // as in the forward
    step(t, in0);
    load(t - 2, in0);
    if (t >= 1) {
      step(t - 1, in1);
      load(t - 3, in1);
    }
  }
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const int b = b0 + base + i;
#pragma unroll
    for (int p = 0; p < UPT; ++p)
      if (lead && unit[p] && b < B)
        dh0[((size_t)a * B + b) * H + u[p]] = dh[i][p];
  }
}

// ---------------------------------------------------------------------------
// H > 128: W_h streamed from global memory (L2) every step
// ---------------------------------------------------------------------------
constexpr int STREAM_THREADS = 512;

// forward: one block per (agent, tile of R rows); thread u owns units
// u, u + blockDim.x, ... Shared memory: h, 2 x R x H, double-buffered and
// masked by the next step's reset as the next step reads it.
template <int R>
__global__ void __launch_bounds__(STREAM_THREADS)
gru_fwd_stream(const float* __restrict__ gi, const float* __restrict__ wh,
               const float* __restrict__ bh, const float* __restrict__ h0,
               const float* __restrict__ resets, float* __restrict__ hs,
               int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int a = blockIdx.x, b0 = blockIdx.y * R, H3 = 3 * H;
  const float* wa = wh + (size_t)a * H * H3;
  const float* ba = bh + (size_t)a * H3;
  for (int e = tid; e < R * H; e += nthr) {
    const int r = e / H, u = e - r * H, b = b0 + r;
    smem[e] = b < B ? h0[((size_t)a * B + b) * H + u] *
                          (1.0f - resets[(size_t)a * T * B + b])
                    : 0.0f;
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* hc = smem + (t & 1) * R * H;
    float* hn = smem + ((t + 1) & 1) * R * H;
    for (int u = tid; u < H; u += nthr) {
      float acc[R][3];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.0f;
      const float* w = wa + u;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float* wk = w + (size_t)k * H3;
        const float w0 = __ldg(wk), w1 = __ldg(wk + H), w2 = __ldg(wk + 2 * H);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hv = hc[r * H + k];
          acc[r][0] = fmaf(hv, w0, acc[r][0]);
          acc[r][1] = fmaf(hv, w1, acc[r][1]);
          acc[r][2] = fmaf(hv, w2, acc[r][2]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        if (b >= B) {
          hn[r * H + u] = 0.0f;
          continue;
        }
        const size_t row = ((size_t)a * T + t) * B + b;
        const float* g = gi + row * H3;
        const float rg = sigmoid_f32(g[u] + (acc[r][0] + ba[u]));
        const float z = sigmoid_f32(g[H + u] + (acc[r][1] + ba[H + u]));
        const float n = tanhf(g[2 * H + u] + rg * (acc[r][2] + ba[2 * H + u]));
        const float hnew = (1.0f - z) * n + z * hc[r * H + u];
        hs[row * H + u] = hnew;
        const float keep_next =
            t + 1 < T ? 1.0f - resets[((size_t)a * T + t + 1) * B + b] : 0.0f;
        hn[r * H + u] = hnew * keep_next;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 128 < H <= 512: W_h resident in the shared memory of a thread-block cluster
// ---------------------------------------------------------------------------
constexpr int CLUSTER_THREADS = 256;
constexpr int CLUSTER_RT = 8;      // rows of a thread's tile (a row group)
constexpr int CLUSTER_UT = 4;      // units of a thread's tile
constexpr int CLUSTER_UNITS = 32;  // hidden units a CTA of the cluster owns
constexpr int MAX_CLUSTER = 16;    // CTAs of a cluster (above 8: non-portable)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// 4- and 16-byte copies from global to shared memory, in flight until
// cp_wait_all
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the cluster barrier, every thread of every CTA: writes before a thread's
// arrive (to any CTA's shared memory) are seen by every thread after its
// wait; between the two a thread may work on what the barrier does not
// guard
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// x into the shared memory of CTA `rank` of the cluster, at the place that
// `addr` (an address of this CTA's shared memory) has there
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t rank,
                                           float4 x) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   remote),
               "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
               : "memory");
}

// One cluster of C CTAs per (agent, tile of R rows); CTA c (its rank in the
// cluster) owns hidden units [c U, (c + 1) U), U = CLUSTER_UNITS: their 3U
// columns of W_h (r, z and n) stay in its shared memory for all T steps.
// Each CTA keeps the whole h of the tile, double-buffered: a step computes
// gh = h.W_h for its columns and R rows, runs the gate algebra of its
// units, and writes its slice of the new h into every CTA's other buffer
// (distributed shared memory), then one cluster barrier. Thread (v, s, grp)
// owns units c U + 4 v .. + 3 and rows 8 grp .. + 7, and float4 chunks
// s, s + KS, s + 2 KS, ... of the reduction axis; KS partial sums are
// folded by shuffles that scatter the rows (Fold), so the sums run in a
// fixed order and the bits repeat from run to run. A float of W_h loaded
// feeds 8 FMA (the rows), a float of h 12 (the units' three gates).
// Shared memory: W_h's rows of the CTA's 3U columns as in global memory
// (so they load as 16-byte asynchronous copies), their float4 chunks
// swizzled by the row (w_chunk) so that the eight lanes of a quarter-warp,
// which read eight rows, hit eight bank groups; h 2 x R x HP floats; HP =
// H rounded up to 4 KS rows of W_h and columns of h, zeros past H.
template <int KS>
__device__ __forceinline__ int w_chunk(int k, int g, int v) {
  // rows k of one float4 chunk of the reduction axis, lanes s of it; at 4
  // lanes a quarter-warp holds two unit groups, hence the factor 2
  constexpr int M = KS == 4 ? 2 : 1;
  return 8 * g + (v ^ (((k >> 2) * M) & 7));
}

template <int KS>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
gru_fwd_cluster(const float* __restrict__ gi, const float* __restrict__ wh,
                const float* __restrict__ bh, const float* __restrict__ h0,
                const float* __restrict__ resets, float* __restrict__ hs,
                int T, int B, int H, int C, int R, int HP) {
  constexpr int RT = CLUSTER_RT, UT = CLUSTER_UT, G = 3 * UT;
  constexpr int U = CLUSTER_UNITS, NV = U / UT, WS = 3 * U;
  static_assert(NV == 8, "a gate's units of a CTA are 8 float4 chunks");
  constexpr int RL = Rows<RT, KS>::RL, DUP = Rows<RT, KS>::DUP;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                  // HP x WS: this CTA's columns of W_h
  float* h_s = smem + HP * WS;        // 2 x R x HP
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int s = tid % KS, v = (tid / KS) % NV, grp = tid / (KS * NV);
  const int rank = (int)cluster_rank();
  const int a = blockIdx.y, b0 = (blockIdx.x / C) * R, H3 = 3 * H;
  const int unit0 = rank * U, u0 = unit0 + UT * v;   // this thread's units
  const bool live = u0 < H;
  const int base = grp * RT + (s / DUP) * RL;   // its rows after the fold
  const bool lead = s % DUP == 0;
  const float* wa = wh + (size_t)a * H * H3;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // W_h's rows k < H: 16-byte asynchronous copies of the chunks of 4 units
  // that lie wholly below H (all in flight at once) where the hidden is a
  // multiple of 4 and the tensor starts 16-byte aligned (then so does every
  // chunk), else 4-byte ones; zeros past H. h0 likewise.
  const bool wide_w = H % 4 == 0 && reinterpret_cast<uintptr_t>(wh) % 16 == 0;
  const bool wide_h = H % 4 == 0 && reinterpret_cast<uintptr_t>(h0) % 16 == 0;
  for (int e = tid; e < H * 3 * NV; e += nthr) {
    const int k = e / (3 * NV), gc = e - k * 3 * NV, g = gc / NV,
              c = gc - g * NV, u = unit0 + UT * c;
    float* dst = w_s + k * WS + 4 * w_chunk<KS>(k, g, c);
    const float* src = wa + (size_t)k * H3 + g * H + u;
    if (wide_w && u + UT <= H) {
      cp_async16(dst, src);
    } else {
      for (int p = 0; p < UT; ++p) {
        if (u + p < H)
          cp_async4(dst + p, src + p);
        else
          dst[p] = 0.0f;
      }
    }
  }
  // zeros: W_h's rows H..HP-1, the second h buffer, the first's rows past B
  const int w_end = HP * WS, h1 = w_end + R * HP;
  for (int e = H * WS + 4 * tid; e < h1 + R * HP; e += 4 * nthr) {
    const int r = (e - w_end) / HP;
    if (e < w_end || e >= h1 || b0 + r >= B)
      *reinterpret_cast<float4*>(smem + e) = zero4;
  }
  // h0 masked by the first step's reset, zeros past H
  for (int e = tid; e < R * (HP / 4); e += nthr) {
    const int r = e / (HP / 4), k = 4 * (e - r * (HP / 4)), b = b0 + r;
    if (b >= B) continue;
    const float keep = 1.0f - resets[(size_t)a * T * B + b];
    const float* src = h0 + ((size_t)a * B + b) * H + k;
    float4 x = zero4;
    if (wide_h && k < H) {
      x = ld4(src);
    } else if (k < H) {
      x.x = src[0];
      x.y = k + 1 < H ? src[1] : 0.0f;
      x.z = k + 2 < H ? src[2] : 0.0f;
      x.w = k + 3 < H ? src[3] : 0.0f;
    }
    *reinterpret_cast<float4*>(h_s + r * HP + k) =
        make_float4(x.x * keep, x.y * keep, x.z * keep, x.w * keep);
  }
  cp_wait_all();
  float bias[3][UT];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int p = 0; p < UT; ++p)
      bias[g][p] = u0 + p < H ? bh[(size_t)a * H3 + g * H + u0 + p] : 0.0f;

  // a step's inputs for the rows and units this lane holds after the fold,
  // raw, from addresses clamped into the tensors: gi, and the next step's
  // reset (h is masked by it as the next step reads it)
  float in_gi[RL][UT][3], reset_next[RL];
  auto load = [&](int t) {
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int b = min(b0 + base + i, B - 1);
      const size_t row = ((size_t)a * T + t) * B + b;
      reset_next[i] = resets[((size_t)a * T + min(t + 1, T - 1)) * B + b];
#pragma unroll
      for (int p = 0; p < UT; ++p)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          in_gi[i][p][g] = gi[row * H3 + g * H + min(u0 + p, H - 1)];
    }
  };
  load(0);
  cluster_arrive();   // every CTA's zeros, W_h and h0 are in place
  cluster_wait();

  for (int t = 0; t < T; ++t) {
    const float* hc = h_s + (t & 1) * R * HP;
    const uint32_t hn = smem_addr(h_s + ((t + 1) & 1) * R * HP);
    float acc[RT][G];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < G; ++c) acc[r][c] = 0.0f;
    const float* hrow = hc + grp * RT * HP;
    const int nq = HP / (4 * KS);
    for (int q = 0; q < nq; ++q) {
      const int k = 4 * (q * KS + s);
      // W_h rows k .. k + 3 of the three gates' 4 units (one chunk each)
      float4 w4[4][3];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          w4[j][g] = ld4(w_s + (k + j) * WS + 4 * w_chunk<KS>(k, g, v));
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 hv = ld4(hrow + r * HP + k);
        const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            acc[r][g * UT] = fmaf(h4[j], w4[j][g].x, acc[r][g * UT]);
            acc[r][g * UT + 1] = fmaf(h4[j], w4[j][g].y, acc[r][g * UT + 1]);
            acc[r][g * UT + 2] = fmaf(h4[j], w4[j][g].z, acc[r][g * UT + 2]);
            acc[r][g * UT + 3] = fmaf(h4[j], w4[j][g].w, acc[r][g * UT + 3]);
          }
      }
    }
    Fold<RT, KS / 2, G, RT>::run(acc, s);
    float hnew[RL][UT];
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int r = base + i, b = b0 + r;
      if (!live) continue;
      const float4 hp4 = ld4(hc + r * HP + u0);
      const float hprev[UT] = {hp4.x, hp4.y, hp4.z, hp4.w};
      const float keep_next =
          (b < B && t + 1 < T) ? 1.0f - reset_next[i] : 0.0f;
      float out[UT];
#pragma unroll
      for (int p = 0; p < UT; ++p) {
        const float rg =
            sigmoid_f32(in_gi[i][p][0] + (acc[i][p] + bias[0][p]));
        const float z =
            sigmoid_f32(in_gi[i][p][1] + (acc[i][UT + p] + bias[1][p]));
        const float n = tanhf(in_gi[i][p][2] +
                              rg * (acc[i][2 * UT + p] + bias[2][p]));
        hnew[i][p] = (1.0f - z) * n + z * hprev[p];
        // masked as step t + 1 reads it
        out[p] = u0 + p < H ? hnew[i][p] * keep_next : 0.0f;
      }
      if (lead) {
        const float4 x = make_float4(out[0], out[1], out[2], out[3]);
        for (int c = 0; c < C; ++c)
          st_cluster(hn + (uint32_t)(r * HP + u0) * 4u, (uint32_t)c, x);
      }
    }
    // the new h is in every CTA after the barrier; its release waits for
    // this thread's writes, so the outputs and the next step's loads go
    // between its arrive and its wait
    cluster_arrive();
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int b = b0 + base + i;
      if (!live || !lead || b >= B) continue;
      float* out = hs + (((size_t)a * T + t) * B + b) * H + u0;
#pragma unroll
      for (int p = 0; p < UT; ++p)
        if (u0 + p < H) out[p] = hnew[i][p];
    }
    if (t + 1 < T) load(t + 1);
    cluster_wait();
  }
}

// backward, phase 2: per step, (A) the gate algebra of every (row, unit)
// of the tile, which writes dgi, r and the dgh row into shared memory and
// the direct path d z onto the adjoint; (B) dh_{t-1} = (d z + dgh.W_h^T)
// (1 - reset_t), a warp per unit. Shared memory: dgh (R x 3H) and the
// carried adjoint (R x H).
template <int R>
__global__ void __launch_bounds__(STREAM_THREADS)
gru_bwd_chain_stream(const float* __restrict__ gi,
                     const float* __restrict__ wh,
                     const float* __restrict__ gh,
                     const float* __restrict__ h0,
                     const float* __restrict__ resets,
                     const float* __restrict__ hs,
                     const float* __restrict__ g, float* __restrict__ dgi,
                     float* __restrict__ rgate, float* __restrict__ dh0,
                     int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int a = blockIdx.x, b0 = blockIdx.y * R, H3 = 3 * H;
  float* dg_s = smem;               // R x 3H
  float* dh_s = smem + R * H3;      // R x H
  const float* wa = wh + (size_t)a * H * H3;
  for (int e = tid; e < R * H; e += nthr) dh_s[e] = 0.0f;
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    for (int u = tid; u < H; u += nthr) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        const bool valid = b < B;
        const int bc = min(b, B - 1);
        const size_t row = ((size_t)a * T + t) * B + bc;
        const float keep = valid ? 1.0f - resets[row] : 0.0f;
        const float hprev = t > 0 ? hs[(row - B) * H + u]
                                  : h0[((size_t)a * B + bc) * H + u];
        const float* ghr = gh + row * H3;
        const float* gir = gi + row * H3;
        const float gh_n = ghr[2 * H + u];
        const float rg = sigmoid_f32(gir[u] + ghr[u]);
        const float z = sigmoid_f32(gir[H + u] + ghr[H + u]);
        const float n = tanhf(gir[2 * H + u] + rg * gh_n);
        const float d = g[row * H + u] + dh_s[r * H + u];
        const float dn = d * (1.0f - z);
        const float dz = d * (hprev * keep - n);
        const float da_n = dn * (1.0f - n * n);
        const float da_z = dz * z * (1.0f - z);
        const float da_r = da_n * gh_n * rg * (1.0f - rg);
        if (valid) {
          float* dgo = dgi + row * H3;
          dgo[u] = da_r;
          dgo[H + u] = da_z;
          dgo[2 * H + u] = da_n;
          rgate[row * H + u] = rg;
        }
        float* dgrow = dg_s + r * H3;
        dgrow[u] = valid ? da_r : 0.0f;
        dgrow[H + u] = valid ? da_z : 0.0f;
        dgrow[2 * H + u] = valid ? da_n * rg : 0.0f;
        dh_s[r * H + u] = d * z;   // the direct path, finished in (B)
      }
    }
    __syncthreads();
    for (int u = warp; u < H; u += nwarps) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      const float* wrow = wa + (size_t)u * H3;
      for (int c = lane; c < H3; c += 32) {
        const float wv = __ldg(wrow + c);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(dg_s[r * H3 + c], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[r] += __shfl_xor_sync(FULL_MASK, acc[r], off);
      if (lane == 0)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int b = b0 + r;
          const float keep =
              b < B ? 1.0f - resets[((size_t)a * T + t) * B + b] : 0.0f;
          dh_s[r * H + u] = (dh_s[r * H + u] + acc[r]) * keep;
        }
    }
    __syncthreads();
  }
  for (int e = tid; e < R * H; e += nthr) {
    const int r = e / H, u = e - r * H, b = b0 + r;
    if (b < B) dh0[((size_t)a * B + b) * H + u] = dh_s[e];
  }
}

// ---------------------------------------------------------------------------
// 128 < H <= 512, the backward chain: W_h resident across a cluster
// ---------------------------------------------------------------------------
constexpr int CHAIN_KB = 64;   // rows of W_h (outputs k) of a product block

// Where float4 chunk (gate g, units 4v .. 4v + 3 of the CTA's 32) of row k
// of the chain's W_h slice is kept: swizzled within its gate by k / 8, so
// that the 8 lanes of a quarter-warp, which read rows 8 apart, hit 8 bank
// groups.
__device__ __forceinline__ int chain_chunk(int k, int g, int v) {
  return 8 * g + (v ^ ((k >> 3) & 7));
}

// One cluster of C CTAs per (agent, tile of R = 8 RPT rows), as the cluster
// forward; CTA c (its rank) owns units [c U, (c + 1) U), U = CLUSTER_UNITS,
// and keeps the same slice of W_h as the forward: the 3U columns of its
// units' gates, for all KP rows (H rounded up to CHAIN_KB, zeros past H),
// in shared memory for all T steps. A step t (T-1 -> 0) is a reduce-scatter
// of dh_{t-1} = (d z + dgh.W_h^T) (1 - reset_t) over the cluster:
//  (A) thread (warp w, lane) runs the gate algebra of unit c U + lane for
//      rows w, w + 8, ... (RPT of them), with the carried adjoint in its
//      registers: dgi and r (kept for the global stores), the direct path
//      d z, and the CTA's 3U columns of dgh into shared memory;
//  (B) the CTA's partial product P = dgh[:, its 3U] . W_h[:, its 3U]^T for
//      all R rows and all KP outputs k: thread (kl, s, grp) takes tiles of
//      8 rows x 8 outputs (k = 64 kb + 8 kl .. + 7) over slice s (of KS) of
//      the 3U columns, read as float4s (4 FMA a float loaded), and folds
//      the KS slices by shuffles (Fold, lanes 8 apart). The 32 outputs of
//      CTA c' go as float4s into slot c of c''s buffer over distributed
//      shared memory; then one cluster barrier, whose arrive is followed by
//      the step's global stores and the next step's loads (the arrive
//      compiles to a fence that would wait for earlier global stores);
//  (C) each thread adds the C slots of its (row, unit) in the order
//      c = 0 .. C-1 to d z, masked by the reset: the carried adjoint.
// Every sum runs in a fixed order, so the bits repeat from run to run. The
// slots are double-buffered by the step's parity; the CTA's dgh lives in
// the buffer its own (C) read the step before (gate g, row r, unit lane at
// slot g: the thread that wrote it is the one that read those slots), which
// nobody writes again before the next barrier. Shared memory: KP x 3U
// floats of W_h and 2 x C x R x U of slots; at H = 512 (C = 16, R = 8) and
// at 256 (C = 8, R = 64) 229,376 bytes.
template <int KS, int RPT>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
gru_bwd_chain_cluster(const float* __restrict__ gi,
                      const float* __restrict__ wh,
                      const float* __restrict__ gh,
                      const float* __restrict__ h0,
                      const float* __restrict__ resets,
                      const float* __restrict__ hs,
                      const float* __restrict__ g, float* __restrict__ dgi,
                      float* __restrict__ rgate, float* __restrict__ dh0,
                      int T, int B, int H, int C, int KP) {
  constexpr int U = CLUSTER_UNITS, WS = 3 * U, R = 8 * RPT;
  constexpr int RL = 8 / KS;            // rows of a tile a lane ends with
  constexpr int QN = WS / 4 / KS;       // float4 chunks a lane sums
  constexpr int NGRP = CLUSTER_THREADS / (8 * KS);
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                    // KP x WS
  float* slots = smem + KP * WS;        // 2 x C x R x U
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster_rank();
  const int a = blockIdx.y, b0 = (blockIdx.x / C) * R, H3 = 3 * H;
  const int unit0 = rank * U, u = unit0 + lane, uc = min(u, H - 1);
  const bool live = u < H;
  const int kl = tid & 7, s = (tid >> 3) & (KS - 1), grp = tid / (8 * KS);
  const int ntiles = RPT * (KP / CHAIN_KB);   // (row group, k block)
  const int buf = C * R * U;
  const float* wa = wh + (size_t)a * H * H3;

  // W_h's rows k < H: 16-byte asynchronous copies of the chunks of 4 units
  // that lie wholly below H where the hidden is a multiple of 4 and the
  // tensor is 16-byte aligned, else 4-byte ones; zeros elsewhere
  const bool wide_w = H % 4 == 0 && reinterpret_cast<uintptr_t>(wh) % 16 == 0;
  for (int e = tid; e < KP * 3 * 8; e += CLUSTER_THREADS) {
    const int k = e / 24, gc = e - k * 24, gg = gc / 8, v = gc - gg * 8,
              u4 = unit0 + 4 * v;
    float* dst = w_s + k * WS + 4 * chain_chunk(k, gg, v);
    if (k < H && wide_w && u4 + 4 <= H) {
      cp_async16(dst, wa + (size_t)k * H3 + gg * H + u4);
    } else {
      for (int p = 0; p < 4; ++p) {
        if (k < H && u4 + p < H)
          cp_async4(dst + p, wa + (size_t)k * H3 + gg * H + u4 + p);
        else
          dst[p] = 0.0f;
      }
    }
  }

  // step t's inputs for this thread's rows and unit: raw loads from
  // addresses clamped into the tensors, used only when the step runs
  struct In {
    float reset[RPT], hprev[RPT], gout[RPT], gh[RPT][3], gi[RPT][3];
  };
  auto load = [&](int t, In& in) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int b = min(b0 + warp + 8 * i, B - 1);
      const size_t row = ((size_t)a * T + t) * B + b;
      in.reset[i] = resets[row];
      in.hprev[i] = t > 0 ? hs[(row - B) * H + uc]
                          : h0[((size_t)a * B + b) * H + uc];
      in.gout[i] = g[row * H + uc];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        in.gh[i][q] = gh[row * H3 + q * H + uc];
        in.gi[i][q] = gi[row * H3 + q * H + uc];
      }
    }
  };
  In in;
  load(T - 1, in);
  float dh[RPT];   // the adjoint carried onto h_t
#pragma unroll
  for (int i = 0; i < RPT; ++i) dh[i] = 0.0f;
  cp_wait_all();
  cluster_arrive();   // every CTA's W_h slice is in place
  cluster_wait();

  for (int t = T - 1; t >= 0; --t) {
    float* cur = slots + (t & 1) * buf;          // this step's partial sums
    float* dg = slots + ((t + 1) & 1) * buf;     // this CTA's dgh
    // (A) the gate algebra
    float dz_h[RPT], keep[RPT], out[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = warp + 8 * i;
      const bool valid = b0 + r < B;
      keep[i] = valid ? 1.0f - in.reset[i] : 0.0f;
      const float gh_n = in.gh[i][2];
      const float rg = sigmoid_f32(in.gi[i][0] + in.gh[i][0]);
      const float z = sigmoid_f32(in.gi[i][1] + in.gh[i][1]);
      const float n = tanhf(in.gi[i][2] + rg * gh_n);
      const float d = in.gout[i] + dh[i];   // total adjoint on h_t
      const float dn = d * (1.0f - z);
      const float dz = d * (in.hprev[i] * keep[i] - n);
      dz_h[i] = d * z;
      const float da_n = dn * (1.0f - n * n);
      const float da_z = dz * z * (1.0f - z);
      const float da_r = da_n * gh_n * rg * (1.0f - rg);
      out[i][0] = da_r;
      out[i][1] = da_z;
      out[i][2] = da_n;
      out[i][3] = rg;
      const bool on = valid && live;
      dg[r * U + lane] = on ? da_r : 0.0f;
      dg[(R + r) * U + lane] = on ? da_z : 0.0f;
      dg[(2 * R + r) * U + lane] = on ? da_n * rg : 0.0f;
    }
    __syncthreads();   // the CTA's dgh (and, once, W_h) is in shared memory

    // (B) the partial product, tile by tile; every lane of a warp takes
    // part in each round (the fold's shuffles), lanes past the last tile
    // on a repeat of it whose sums they drop
    for (int t0 = 0; t0 < ntiles; t0 += NGRP) {
      const int tile = min(t0 + grp, ntiles - 1);
      const int rg = tile % RPT, k0 = (tile / RPT) * CHAIN_KB + 8 * kl;
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[r][m] = 0.0f;
      const float* wrow = w_s + k0 * WS;
      const float* drow = dg + 8 * rg * U;
#pragma unroll 1
      for (int q = 0; q < QN; ++q) {
        const int jc = q * KS + s, gg = jc >> 3, v = jc & 7;
        const int col = 4 * chain_chunk(k0, gg, v);   // rows k0 .. k0 + 7
        float4 w4[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) w4[m] = ld4(wrow + m * WS + col);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 dv = ld4(drow + (gg * R + r) * U + 4 * v);
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            float& c = acc[r][m];
            c = fmaf(dv.x, w4[m].x, c);
            c = fmaf(dv.y, w4[m].y, c);
            c = fmaf(dv.z, w4[m].z, c);
            c = fmaf(dv.w, w4[m].w, c);
          }
        }
      }
      Fold<8, KS / 2, 8, 8, 8>::run(acc, s);
      if (t0 + grp < ntiles && k0 < C * U) {
        // rows 8 rg + s RL + i, outputs k0 .. k0 + 7 of CTA k0 / U
        const uint32_t dst = smem_addr(
            cur + (rank * R + 8 * rg + s * RL) * U + (k0 & (U - 1)));
        const uint32_t to = (uint32_t)(k0 / U);
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          st_cluster(dst + i * U * 4, to,
                     make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
          st_cluster(dst + i * U * 4 + 16, to,
                     make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
        }
      }
    }
    cluster_arrive();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int b = b0 + warp + 8 * i;
      if (!live || b >= B) continue;
      const size_t row = ((size_t)a * T + t) * B + b;
      float* dgo = dgi + row * H3;
      dgo[u] = out[i][0];
      dgo[H + u] = out[i][1];
      dgo[2 * H + u] = out[i][2];
      rgate[row * H + u] = out[i][3];
    }
    if (t > 0) load(t - 1, in);
    cluster_wait();

    // (C) the carried adjoint: the cluster's slots in rank order
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = warp + 8 * i;
      float sum = 0.0f;
      for (int c = 0; c < C; ++c) sum += cur[(c * R + r) * U + lane];
      dh[i] = (dz_h[i] + sum) * keep[i];
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + warp + 8 * i;
    if (live && b < B) dh0[((size_t)a * B + b) * H + u] = dh[i];
  }
}

// ---------------------------------------------------------------------------
// backward, phases 1 and 3: tiled FFMA products over all T.B rows
// ---------------------------------------------------------------------------
constexpr int GEMM_THREADS = 256;       // 16 x 16
constexpr int TM = 64;                  // tile rows: thread rows ty*4 + i
constexpr int TN = 192;                 // tile columns: tx + 16 j, j < 12
constexpr int XS = TM + 4;              // a shared row of the x operand
constexpr int KC = 16;                  // phase 1: depth of a k chunk
constexpr int MC = 16;                  // phase 3: rows of a chunk
constexpr int SLICE_ROWS = 128;         // phase 3: rows of a slice (>= MC)
constexpr int MAX_SLICES = 64;

// hp[m][k] for row m = t * B + b of agent a is h_{t-1} (h0 at t = 0)
// masked by reset_t, as the forward step saw it. The fetches below load
// its two raw inputs from addresses clamped into the tensors, into
// registers, and the product h * (1 - reset) is formed only when the
// chunk is stored to shared memory: a fetch never waits on its loads.
struct HpRaw {
  float h, reset;
};

__device__ __forceinline__ HpRaw hp_raw(const float* __restrict__ h0,
                                        const float* __restrict__ resets,
                                        const float* __restrict__ hs, int a,
                                        int m, int k, int T, int B, int H) {
  m = min(m, T * B - 1);
  k = min(k, H - 1);
  const int t = m / B, b = m - t * B;
  const size_t row = ((size_t)a * T + t) * B + b;
  const float* src = t > 0 ? hs + (row - B) * H : h0 + ((size_t)a * B + b) * H;
  return {src[k], resets[row]};
}

__device__ __forceinline__ float hp_of(HpRaw x, bool in_range) {
  return in_range ? x.h * (1.0f - x.reset) : 0.0f;
}

// acc[i][j] += sum over the depth of x_s[d][ty*4+i] * y_s[d][tx+16j]
template <int DEPTH>
__device__ __forceinline__ void tile_mac(const float* x_s, const float* y_s,
                                         float (&acc)[4][12], int ty,
                                         int tx) {
#pragma unroll 4
  for (int d = 0; d < DEPTH; ++d) {
    const float4 xv = ld4(x_s + d * XS + ty * 4);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const float y = y_s[d * TN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(xs[i], y, acc[i][j]);
    }
  }
}

// phase 1: gh[a, m, :] = hp[m] . W_h + b_h; grid (A, m tiles, 3H tiles).
// The next k chunk is loaded into registers while this one is multiplied.
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gru_bwd_gates(const float* __restrict__ wh, const float* __restrict__ bh,
              const float* __restrict__ h0, const float* __restrict__ resets,
              const float* __restrict__ hs, float* __restrict__ gh, int T,
              int B, int H) {
  constexpr int XN = KC * TM / GEMM_THREADS, YN = KC * TN / GEMM_THREADS;
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                  // KC x XS: hp^T chunk
  float* y_s = smem + KC * XS;        // KC x TN: W_h chunk
  const int a = blockIdx.x, m0 = blockIdx.y * TM, n0 = blockIdx.z * TN;
  const int M = T * B, H3 = 3 * H, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* wa = wh + (size_t)a * H * H3;
  HpRaw xr[XN];
  float yr[YN];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XN; ++i) {   // k fastest: coalesced rows of hp
      const int e = tid + i * GEMM_THREADS, mm = e / KC, kk = e % KC;
      xr[i] = hp_raw(h0, resets, hs, a, m0 + mm, k0 + kk, T, B, H);
    }
#pragma unroll
    for (int i = 0; i < YN; ++i) {
      const int e = tid + i * GEMM_THREADS, kk = e / TN, nn = e % TN;
      yr[i] = wa[(size_t)min(k0 + kk, H - 1) * H3 + min(n0 + nn, H3 - 1)];
    }
  };
  float acc[4][12] = {};
  fetch(0);
  for (int k0 = 0; k0 < H; k0 += KC) {
#pragma unroll
    for (int i = 0; i < XN; ++i) {
      const int e = tid + i * GEMM_THREADS, mm = e / KC, kk = e % KC;
      x_s[kk * XS + mm] = hp_of(xr[i], m0 + mm < M && k0 + kk < H);
    }
#pragma unroll
    for (int i = 0; i < YN; ++i) {
      const int e = tid + i * GEMM_THREADS, kk = e / TN, nn = e % TN;
      y_s[e] = (k0 + kk < H && n0 + nn < H3) ? yr[i] : 0.0f;
    }
    __syncthreads();
    if (k0 + KC < H) fetch(k0 + KC);
    tile_mac<KC>(x_s, y_s, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < H3)
        gh[((size_t)a * M + m) * H3 + n] =
            acc[i][j] + bh[(size_t)a * H3 + n];
    }
  }
}

// phase 3: over rows [slice * rows, + rows) of agent a, the partial sums
// part[a, slice, k, n] = sum_m hp[m][k] dgh[m][n] (k < H) and
// part[a, slice, H, n] = sum_m dgh[m][n], dgh = [dgi_r, dgi_z, dgi_n r];
// grid (A, H tiles x 3H tiles, slices). Rows in order, one at a time;
// the next chunk is loaded into registers while this one is multiplied.
__global__ void __launch_bounds__(GEMM_THREADS)
gru_bwd_weights(const float* __restrict__ h0,
                const float* __restrict__ resets,
                const float* __restrict__ hs, const float* __restrict__ dgi,
                const float* __restrict__ rgate, float* __restrict__ part,
                int T, int B, int H, int rows) {
  constexpr int XN = MC * TM / GEMM_THREADS, YN = MC * TN / GEMM_THREADS;
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                  // MC x XS: hp rows
  float* y_s = smem + MC * XS;        // MC x TN: dgh rows
  const int H3 = 3 * H, n_tiles = (H3 + TN - 1) / TN;
  const int a = blockIdx.x, k0 = (blockIdx.y / n_tiles) * TM;
  const int n0 = (blockIdx.y % n_tiles) * TN, slice = blockIdx.z;
  const int M = T * B, tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = slice * rows, r1 = min(M, r0 + rows);
  const bool bias_sums = k0 == 0 && ty == 0;
  const float* dga = dgi + (size_t)a * M * H3;
  const float* ra = rgate + (size_t)a * M * H;
  HpRaw xr[XN];
  float yr[YN], rr[YN];   // dgi, and r where the column is an n gate
  auto fetch = [&](int m0) {
#pragma unroll
    for (int i = 0; i < XN; ++i) {   // k fastest: coalesced rows of hp
      const int e = tid + i * GEMM_THREADS, mm = e / TM, kk = e % TM;
      xr[i] = hp_raw(h0, resets, hs, a, m0 + mm, k0 + kk, T, B, H);
    }
#pragma unroll
    for (int i = 0; i < YN; ++i) {
      const int e = tid + i * GEMM_THREADS, mm = e / TN, nn = e % TN;
      const size_t m = min(m0 + mm, M - 1);
      const int n = min(n0 + nn, H3 - 1);
      yr[i] = dga[m * H3 + n];
      rr[i] = ra[m * H + max(n - 2 * H, 0)];
    }
  };
  float acc[4][12] = {}, db[12] = {};
  fetch(r0);
  for (int m0 = r0; m0 < r1; m0 += MC) {
#pragma unroll
    for (int i = 0; i < XN; ++i) {
      const int e = tid + i * GEMM_THREADS, mm = e / TM, kk = e % TM;
      x_s[mm * XS + kk] = hp_of(xr[i], m0 + mm < r1 && k0 + kk < H);
    }
#pragma unroll
    for (int i = 0; i < YN; ++i) {
      const int e = tid + i * GEMM_THREADS, mm = e / TN, nn = e % TN;
      const int n = n0 + nn;
      y_s[e] = (m0 + mm < r1 && n < H3)
                   ? (n >= 2 * H ? yr[i] * rr[i] : yr[i]) : 0.0f;
    }
    __syncthreads();
    if (m0 + MC < r1) fetch(m0 + MC);
    tile_mac<MC>(x_s, y_s, acc, ty, tx);
    if (bias_sums)
      for (int mm = 0; mm < MC; ++mm)
#pragma unroll
        for (int j = 0; j < 12; ++j) db[j] += y_s[mm * TN + tx + 16 * j];
    __syncthreads();
  }
  float* pa = part + ((size_t)a * gridDim.z + slice) * (H + 1) * H3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int n = n0 + tx + 16 * j;
      if (k < H && n < H3) pa[(size_t)k * H3 + n] = acc[i][j];
    }
  }
  if (bias_sums)
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < H3) pa[(size_t)H * H3 + n] = db[j];
    }
}

// dwh[a, e] (and dbh[a, n], row H) = sum over slices, in slice order
__global__ void gru_bwd_weights_sum(const float* __restrict__ part,
                                    float* __restrict__ dwh,
                                    float* __restrict__ dbh, int A,
                                    int slices, int H) {
  const int n = (H + 1) * 3 * H;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)A * n) return;
  const size_t a = idx / n, e = idx - a * n;
  const float* p = part + a * slices * n + e;
  float sum = 0.0f;
  for (int sl = 0; sl < slices; ++sl) sum += p[(size_t)sl * n];
  if (e < (size_t)H * 3 * H)
    dwh[a * H * 3 * H + e] = sum;
  else
    dbh[a * 3 * H + e - (size_t)H * 3 * H] = sum;
}

// ---------------------------------------------------------------------------
// configuration and launch
// ---------------------------------------------------------------------------
constexpr int RESIDENT_HIDDEN = 128;  // W_h resident up to this width
constexpr int REG_HIDDEN = 64;         // W_h in registers up to this width

// A configuration of the recurrent kernels: UPT units a thread, KS lanes
// over the reduction axis, KPT of its elements a lane (16 / 32 for the
// forward's H, 24 / 48 for the chain's 3H), W_h in registers or not.
template <int UPT_, int KS_, int KPT_, bool WREG_>
struct Cfg {
  static constexpr int UPT = UPT_, KS = KS_, KPT = KPT_;
  static constexpr bool WREG = WREG_;
  // units padded so the block's warps are whole
  static int units(int H) {
    const int m = 32 * UPT / KS;
    return (H + m - 1) / m * m;
  }
  static int threads(int H) { return units(H) / UPT * KS; }
};
using FwdReg = Cfg<1, 4, 16, true>;
using FwdSmem = Cfg<1, 4, 32, false>;
using ChainReg = Cfg<2, 8, 24, true>;
using ChainSmem = Cfg<2, 8, 48, false>;

template <typename C>
size_t fwd_smem_of(int H, int rows) {
  const int hp = C::KS * C::KPT;
  const size_t w = C::WREG ? 0 : (size_t)3 * C::units(H) * (hp + 16);
  return ((size_t)2 * rows * hp + w) * sizeof(float);
}

template <typename C>
size_t chain_smem_of(int H, int rows) {
  const int cp = C::KS * C::KPT;
  const size_t w = C::WREG ? 0 : (size_t)C::units(H) * (cp + 16);
  return ((size_t)2 * rows * cp + w) * sizeof(float);
}

size_t fwd_smem(int H, int rows) {
  if (H > RESIDENT_HIDDEN) return (size_t)2 * rows * H * sizeof(float);
  return H <= REG_HIDDEN ? fwd_smem_of<FwdReg>(H, rows)
                         : fwd_smem_of<FwdSmem>(H, rows);
}

size_t chain_smem(int H, int rows) {
  if (H > RESIDENT_HIDDEN) return (size_t)4 * rows * H * sizeof(float);
  return H <= REG_HIDDEN ? chain_smem_of<ChainReg>(H, rows)
                         : chain_smem_of<ChainSmem>(H, rows);
}

// threads of a streaming block: the units, in whole warps, up to 512
int stream_threads(int H) {
  return min(STREAM_THREADS, (H + 31) / 32 * 32);
}

int weight_slices(int M) {
  return min(MAX_SLICES, max(1, (M + SLICE_ROWS - 1) / SLICE_ROWS));
}

// rows of a slice: a whole number of chunks, the slices cover M
int slice_rows(int M, int slices) {
  const int rows = (M + slices - 1) / slices;
  return (rows + MC - 1) / MC * MC;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel fn, size_t bytes) {
  return cudaFuncSetAttribute((const void*)fn,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename C, int R>
cudaError_t fwd_at(const float* gi, const float* wh, const float* bh,
                   const float* h0, const float* resets, float* hs, int A,
                   int T, int B, int H, cudaStream_t stream) {
  auto fn = gru_fwd<C::UPT, C::KS, C::KPT, R, C::WREG>;
  const size_t smem = fwd_smem_of<C>(H, R);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(A, (B + R - 1) / R);
  fn<<<grid, C::threads(H), smem, stream>>>(gi, wh, bh, h0, resets, hs, T,
                                            B, H, C::units(H));
  return cudaGetLastError();
}

template <typename C, int R>
cudaError_t chain_at(const float* gi, const float* wh, const float* gh,
                     const float* h0, const float* resets, const float* hs,
                     const float* g, float* dgi, float* rgate, float* dh0,
                     int A, int T, int B, int H, cudaStream_t stream) {
  auto fn = gru_bwd_chain<C::UPT, C::KS, C::KPT, R, C::WREG>;
  const size_t smem = chain_smem_of<C>(H, R);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(A, (B + R - 1) / R);
  fn<<<grid, C::threads(H), smem, stream>>>(
      gi, wh, gh, h0, resets, hs, g, dgi, rgate, dh0, T, B, H, C::units(H));
  return cudaGetLastError();
}

template <int R>
cudaError_t fwd_rows(const float* gi, const float* wh, const float* bh,
                     const float* h0, const float* resets, float* hs, int A,
                     int T, int B, int H, cudaStream_t stream) {
  if (H > RESIDENT_HIDDEN) {
    const size_t smem = fwd_smem(H, R);
    cudaError_t err = allow_smem(gru_fwd_stream<R>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(A, (B + R - 1) / R);
    gru_fwd_stream<R><<<grid, stream_threads(H), smem, stream>>>(
        gi, wh, bh, h0, resets, hs, T, B, H);
    return cudaGetLastError();
  }
  if (H <= REG_HIDDEN)
    return fwd_at<FwdReg, R>(gi, wh, bh, h0, resets, hs, A, T, B, H, stream);
  return fwd_at<FwdSmem, R>(gi, wh, bh, h0, resets, hs, A, T, B, H, stream);
}

template <int R>
cudaError_t chain_rows(const float* gi, const float* wh, const float* gh,
                       const float* h0, const float* resets, const float* hs,
                       const float* g, float* dgi, float* rgate, float* dh0,
                       int A, int T, int B, int H, cudaStream_t stream) {
  if (H > RESIDENT_HIDDEN) {
    const size_t smem = chain_smem(H, R);
    cudaError_t err = allow_smem(gru_bwd_chain_stream<R>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(A, (B + R - 1) / R);
    gru_bwd_chain_stream<R><<<grid, stream_threads(H), smem, stream>>>(
        gi, wh, gh, h0, resets, hs, g, dgi, rgate, dh0, T, B, H);
    return cudaGetLastError();
  }
  if (H <= REG_HIDDEN)
    return chain_at<ChainReg, R>(gi, wh, gh, h0, resets, hs, g, dgi, rgate,
                                 dh0, A, T, B, H, stream);
  return chain_at<ChainSmem, R>(gi, wh, gh, h0, resets, hs, g, dgi, rgate,
                                dh0, A, T, B, H, stream);
}

// the cluster forward: lanes a unit group over the reduction axis, so that
// a CTA has CLUSTER_THREADS threads
int cluster_ks(int rows) {
  return CLUSTER_THREADS * CLUSTER_RT * CLUSTER_UT / (CLUSTER_UNITS * rows);
}

int cluster_hp(int H, int ks) { return (H + 4 * ks - 1) / (4 * ks) * (4 * ks); }

size_t cluster_smem(int H, int rows) {
  return ((size_t)3 * CLUSTER_UNITS + 2 * rows) *
         cluster_hp(H, cluster_ks(rows)) * sizeof(float);
}

bool cluster_plan_ok(int H, int ctas, int rows) {
  return H > RESIDENT_HIDDEN && ctas <= MAX_CLUSTER &&
         ctas == (H + CLUSTER_UNITS - 1) / CLUSTER_UNITS &&
         (rows == 8 || rows == 16 || rows == 32 || rows == 64) &&
         cluster_smem(H, rows) <= 232448;
}

template <int KS>
cudaError_t cluster_config(int A, int B, int H, int ctas, int rows,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  auto fn = gru_fwd_cluster<KS>;
  const size_t smem = cluster_smem(H, rows);
  cudaError_t err = allow_smem(fn, smem);
  if (err == cudaSuccess && ctas > 8)
    err = cudaFuncSetAttribute((const void*)fn,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(ctas * ((B + rows - 1) / rows), A);
  cfg->blockDim = dim3(CLUSTER_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int KS>
cudaError_t cluster_at(const float* gi, const float* wh, const float* bh,
                       const float* h0, const float* resets, float* hs, int A,
                       int T, int B, int H, int ctas, int rows,
                       cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cluster_config<KS>(A, B, H, ctas, rows, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, gru_fwd_cluster<KS>, gi, wh, bh, h0, resets,
                           hs, T, B, H, ctas, rows, cluster_hp(H, KS));
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int KS>
int cluster_occupancy(int H, int ctas, int rows) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (cluster_config<KS>(1, rows, H, ctas, rows, 0, &cfg, &attr) !=
      cudaSuccess)
    return -1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, (const void*)gru_fwd_cluster<KS>,
                                        &cfg) == cudaSuccess ? n : -1;
}

bool supported(int H, int rows) {
  return H >= 1 && (rows == 2 || rows == 4 || rows == 8);
}

// the cluster chain: rows of W_h rounded up to a product block, shared
// memory, and lanes a product tile (as many as keep a CTA's threads busy)
int chain_kp(int H) { return (H + CHAIN_KB - 1) / CHAIN_KB * CHAIN_KB; }

size_t chain_cluster_smem(int H, int ctas, int rows) {
  return ((size_t)chain_kp(H) * 3 * CLUSTER_UNITS +
          (size_t)2 * ctas * rows * CLUSTER_UNITS) * sizeof(float);
}

int chain_cluster_ks(int H, int rows) {
  const int tiles = rows / 8 * (chain_kp(H) / CHAIN_KB);
  return tiles <= 8 ? 4 : tiles <= 16 ? 2 : 1;
}

bool chain_plan_ok(int H, int ctas, int rows) {
  return H > RESIDENT_HIDDEN && ctas <= MAX_CLUSTER &&
         ctas == (H + CLUSTER_UNITS - 1) / CLUSTER_UNITS &&
         (rows == 8 || rows == 16 || rows == 32 || rows == 64) &&
         chain_cluster_smem(H, ctas, rows) <= 232448;
}

template <int KS, int RPT>
cudaError_t chain_cluster_config(int A, int B, int H, int ctas,
                                 cudaStream_t stream, cudaLaunchConfig_t* cfg,
                                 cudaLaunchAttribute* attr) {
  auto fn = gru_bwd_chain_cluster<KS, RPT>;
  const int rows = 8 * RPT;
  const size_t smem = chain_cluster_smem(H, ctas, rows);
  cudaError_t err = allow_smem(fn, smem);
  if (err == cudaSuccess && ctas > 8)
    err = cudaFuncSetAttribute((const void*)fn,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(ctas * ((B + rows - 1) / rows), A);
  cfg->blockDim = dim3(CLUSTER_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int KS, int RPT>
cudaError_t chain_cluster_at(const float* gi, const float* wh, const float* gh,
                             const float* h0, const float* resets,
                             const float* hs, const float* g, float* dgi,
                             float* rgate, float* dh0, int A, int T, int B,
                             int H, int ctas, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      chain_cluster_config<KS, RPT>(A, B, H, ctas, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, gru_bwd_chain_cluster<KS, RPT>, gi, wh, gh,
                           h0, resets, hs, g, dgi, rgate, dh0, T, B, H, ctas,
                           chain_kp(H));
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int KS, int RPT>
int chain_cluster_occupancy(int H, int ctas) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (chain_cluster_config<KS, RPT>(1, 8 * RPT, H, ctas, 0, &cfg, &attr) !=
      cudaSuccess)
    return -1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(
             &n, (const void*)gru_bwd_chain_cluster<KS, RPT>, &cfg) ==
                 cudaSuccess ? n : -1;
}

// The instantiations the plans reach (chain_cluster_ks of rows 8..64 at
// hidden 129..512), by (lanes, rows): the cluster chain at a plan, or the
// clusters the card holds at once (launch false)
cudaError_t chain_cluster(bool launch, int* active, const float* gi,
                          const float* wh, const float* gh, const float* h0,
                          const float* resets, const float* hs,
                          const float* g, float* dgi, float* rgate,
                          float* dh0, int A, int T, int B, int H, int ctas,
                          int rows, cudaStream_t stream) {
#define CHAIN_CASE(KS, RPT)                                                   \
  if (chain_cluster_ks(H, rows) == KS && rows == 8 * RPT) {                   \
    if (!launch) {                                                            \
      *active = chain_cluster_occupancy<KS, RPT>(H, ctas);                    \
      return cudaSuccess;                                                     \
    }                                                                         \
    return chain_cluster_at<KS, RPT>(gi, wh, gh, h0, resets, hs, g, dgi,      \
                                     rgate, dh0, A, T, B, H, ctas, stream);   \
  }
  CHAIN_CASE(4, 1)
  CHAIN_CASE(4, 2)
  CHAIN_CASE(2, 2)
  CHAIN_CASE(2, 4)
  CHAIN_CASE(1, 4)
  CHAIN_CASE(1, 8)
#undef CHAIN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

size_t gru_forward_smem_bytes(int H, int rows) { return fwd_smem(H, rows); }

size_t gru_backward_smem_bytes(int H, int rows) {
  return chain_smem(H, rows);
}

// Floats of the backward's scratch for the dW_h/db_h partial sums.
size_t gru_backward_part_floats(int A, int T, int B, int H) {
  return (size_t)A * weight_slices(T * B) * (H + 1) * 3 * H;
}

// Each launcher returns the first error of its configuration calls and
// launches (cudaGetLastError after each launch).
cudaError_t launch_gru_forward(const float* gi, const float* wh,
                               const float* bh, const float* h0,
                               const float* resets, float* hs, int A, int T,
                               int B, int H, int rows, cudaStream_t stream) {
  if (!supported(H, rows)) return cudaErrorInvalidValue;
  switch (rows) {
    case 2: return fwd_rows<2>(gi, wh, bh, h0, resets, hs, A, T, B, H, stream);
    case 4: return fwd_rows<4>(gi, wh, bh, h0, resets, hs, A, T, B, H, stream);
    default: return fwd_rows<8>(gi, wh, bh, h0, resets, hs, A, T, B, H,
                                stream);
  }
}

// dynamic shared memory of the cluster forward's CTA, 0 for a plan it
// does not take
size_t gru_forward_cluster_smem_bytes(int H, int ctas, int rows) {
  return cluster_plan_ok(H, ctas, rows) ? cluster_smem(H, rows) : 0;
}

// clusters of this plan the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot run one, -1: an error)
int gru_forward_cluster_max_active(int H, int ctas, int rows) {
  if (!cluster_plan_ok(H, ctas, rows)) return -1;
  switch (cluster_ks(rows)) {
    case 4: return cluster_occupancy<4>(H, ctas, rows);
    case 8: return cluster_occupancy<8>(H, ctas, rows);
    case 16: return cluster_occupancy<16>(H, ctas, rows);
    default: return cluster_occupancy<32>(H, ctas, rows);
  }
}

// The cluster forward at a plan of the wrapper's (kernels/gru/kernel.py,
// cluster_plan): `ctas` CTAs a cluster (H / CLUSTER_UNITS, rounded up),
// `rows` batch rows a tile. A plan the card refuses returns its error.
cudaError_t launch_gru_forward_cluster(const float* gi, const float* wh,
                                       const float* bh, const float* h0,
                                       const float* resets, float* hs, int A,
                                       int T, int B, int H, int ctas,
                                       int rows, cudaStream_t stream) {
  if (!cluster_plan_ok(H, ctas, rows) || A < 1 || A > 65535 || T < 1 ||
      B < 1)
    return cudaErrorInvalidValue;
  switch (cluster_ks(rows)) {
    case 4: return cluster_at<4>(gi, wh, bh, h0, resets, hs, A, T, B, H,
                                 ctas, rows, stream);
    case 8: return cluster_at<8>(gi, wh, bh, h0, resets, hs, A, T, B, H,
                                 ctas, rows, stream);
    case 16: return cluster_at<16>(gi, wh, bh, h0, resets, hs, A, T, B, H,
                                   ctas, rows, stream);
    default: return cluster_at<32>(gi, wh, bh, h0, resets, hs, A, T, B, H,
                                   ctas, rows, stream);
  }
}

// dynamic shared memory of the cluster chain's CTA, 0 for a plan it does
// not take
size_t gru_backward_cluster_smem_bytes(int H, int ctas, int rows) {
  return chain_plan_ok(H, ctas, rows) ? chain_cluster_smem(H, ctas, rows) : 0;
}

// clusters of the cluster chain's plan the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot run one, -1: an error)
int gru_backward_cluster_max_active(int H, int ctas, int rows) {
  if (!chain_plan_ok(H, ctas, rows)) return -1;
  int active = -1;
  const cudaError_t err =
      chain_cluster(false, &active, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1,
                    1, rows, H, ctas, rows, 0);
  return err == cudaSuccess ? active : -1;
}

// Scratch: gh (A,T,B,3H), written by phase 1 for phase 2; rgate
// (A,T,B,H), the r gate, written by phase 2 for phase 3; part
// (gru_backward_part_floats), phase 3's partial sums. ctas 0: the chain is
// gru_bwd_chain (H <= 128) or gru_bwd_chain_stream at `rows` (2, 4 or 8);
// ctas > 0: gru_bwd_chain_cluster at the plan (ctas, rows) of the
// wrapper's (kernels/gru/kernel.py, cluster_plan).
cudaError_t launch_gru_backward(const float* gi, const float* wh,
                                const float* bh, const float* h0,
                                const float* resets, const float* hs,
                                const float* g, float* gh, float* rgate,
                                float* part, float* dgi, float* dwh,
                                float* dbh, float* dh0, int A, int T, int B,
                                int H, int rows, int ctas,
                                cudaStream_t stream) {
  if (ctas > 0 ? !chain_plan_ok(H, ctas, rows) || A > 65535
               : !supported(H, rows))
    return cudaErrorInvalidValue;
  const int M = T * B, H3 = 3 * H, n_tiles = (H3 + TN - 1) / TN;
  const dim3 gates_grid(A, (M + TM - 1) / TM, n_tiles);
  gru_bwd_gates<<<gates_grid, GEMM_THREADS,
                  (size_t)(KC * XS + KC * TN) * sizeof(float), stream>>>(
      wh, bh, h0, resets, hs, gh, T, B, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (ctas > 0) {
    err = chain_cluster(true, nullptr, gi, wh, gh, h0, resets, hs, g, dgi,
                        rgate, dh0, A, T, B, H, ctas, rows, stream);
  } else switch (rows) {
    case 2: err = chain_rows<2>(gi, wh, gh, h0, resets, hs, g, dgi, rgate,
                                dh0, A, T, B, H, stream); break;
    case 4: err = chain_rows<4>(gi, wh, gh, h0, resets, hs, g, dgi, rgate,
                                dh0, A, T, B, H, stream); break;
    default: err = chain_rows<8>(gi, wh, gh, h0, resets, hs, g, dgi, rgate,
                                 dh0, A, T, B, H, stream); break;
  }
  if (err != cudaSuccess) return err;
  const int slices = weight_slices(M);
  const size_t wsmem = (size_t)(MC * XS + MC * TN) * sizeof(float);
  err = allow_smem(gru_bwd_weights, wsmem);
  if (err != cudaSuccess) return err;
  const dim3 weights_grid(A, ((H + TM - 1) / TM) * n_tiles, slices);
  gru_bwd_weights<<<weights_grid, GEMM_THREADS, wsmem, stream>>>(
      h0, resets, hs, dgi, rgate, part, T, B, H, slice_rows(M, slices));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)A * (H + 1) * H3;
  gru_bwd_weights_sum<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      part, dwh, dbh, A, slices, H);
  return cudaGetLastError();
}
