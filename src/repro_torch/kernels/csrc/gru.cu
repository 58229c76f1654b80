// GRU recurrence kernels for Hopper (sm_90a).
//
// Replace the Pallas kernels of repro/kernels/gru/kernel.py:
//   gru_fwd  <- _gru_forward / _gru_kernel      (the recurrence over T)
//   gru_bwd  <- _gru_backward / _gru_bwd_kernel (its reverse-time adjoint)
//
// Layout (leading agent axis A; the reference vmaps the scan over agents):
//   gi (A,T,B,3H) = x.W_i + b_i, precomputed outside;  wh (A,H,3H);
//   bh (A,3H);  h0 (A,B,H);  resets (A,T,B);  hs (A,T,B,H).  All float32.
//
// Design. The recurrence is sequential in T and tiny per step (h.W_h is a
// BT x H by H x 3H product), so on this card it is bound by the latency of
// the T dependent steps, not by bytes (each input is read once) or FLOPs.
// One block owns one (agent, batch tile): W_h stays in shared memory for
// all T steps (rows padded to 3H+1 floats, so both the forward's column
// reads and the backward's row reads are free of bank conflicts), and so
// does h. Thread (j, row) computes hidden unit j of one batch row: three
// length-H dot products with FFMA in fp32, the gates, the update. No
// tensor cores and no fast-math intrinsics: the reference computes in
// fp32 and the port is held to it at 1e-5.
//
// The backward walks T-1 -> 0, recomputing the gates from
// h_{t-1} = (t ? hs[t-1] : h0) masked by the reset, as the reference does.
// dW_h and db_h accumulate in shared memory; each element has one owning
// thread that sums the tile's rows in a fixed order, and the per-tile
// partials are summed over tiles in tile order by gru_sum_tiles (no
// atomics), so the gradient is deterministic.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void gru_fwd(const float* __restrict__ gi,
                        const float* __restrict__ wh,
                        const float* __restrict__ bh,
                        const float* __restrict__ h0,
                        const float* __restrict__ resets,
                        float* __restrict__ hs, int T, int B, int H) {
  extern __shared__ float smem[];
  const int H3 = 3 * H, ws = H3 + 1, BT = blockDim.y;
  float* w_s = smem;            // H x ws
  float* h_s = w_s + H * ws;    // BT x H
  const int a = blockIdx.x, j = threadIdx.x, lb = threadIdx.y;
  const int b = blockIdx.y * BT + lb;
  const bool valid = b < B;
  const int tid = lb * H + j, nthr = BT * H;

  const float* wa = wh + (size_t)a * H * H3;
  for (int e = tid; e < H * H3; e += nthr) {
    const int k = e / H3;
    w_s[k * ws + (e - k * H3)] = wa[e];
  }
  const float* ba = bh + (size_t)a * H3;
  const float br = ba[j], bz = ba[H + j], bn = ba[2 * H + j];
  float h = valid ? h0[((size_t)a * B + b) * H + j] : 0.0f;
  h_s[lb * H + j] = h;
  __syncthreads();

  const float* hrow = h_s + lb * H;
  for (int t = 0; t < T; ++t) {
    const size_t row = ((size_t)a * T + t) * B + b;
    // this step's inputs are loaded before the dot products, so their
    // memory latency overlaps the loop instead of following it
    float keep = 0.0f, g_r = 0.0f, g_z = 0.0f, g_n = 0.0f;
    if (valid) {
      keep = 1.0f - resets[row];
      const float* g = gi + row * H3;
      g_r = g[j];
      g_z = g[H + j];
      g_n = g[2 * H + j];
    }
    float ar = 0.0f, az = 0.0f, an = 0.0f;
    for (int k = 0; k < H; ++k) {
      const float hk = hrow[k] * keep;
      const float* wk = w_s + k * ws;
      ar = fmaf(hk, wk[j], ar);
      az = fmaf(hk, wk[H + j], az);
      an = fmaf(hk, wk[2 * H + j], an);
    }
    float hn = 0.0f;
    if (valid) {
      const float r = sigmoid_f32(g_r + (ar + br));
      const float z = sigmoid_f32(g_z + (az + bz));
      const float n = tanhf(g_n + r * (an + bn));
      hn = (1.0f - z) * n + z * (h * keep);
      hs[row * H + j] = hn;
    }
    __syncthreads();  // every read of h_s for step t is done
    h_s[lb * H + j] = hn;
    h = hn;
    __syncthreads();
  }
}

__global__ void gru_bwd(const float* __restrict__ gi,
                        const float* __restrict__ wh,
                        const float* __restrict__ bh,
                        const float* __restrict__ h0,
                        const float* __restrict__ resets,
                        const float* __restrict__ hs,
                        const float* __restrict__ g,
                        float* __restrict__ dgi,
                        float* __restrict__ dwh_part,
                        float* __restrict__ dbh_part,
                        float* __restrict__ dh0, int T, int B, int H) {
  extern __shared__ float smem[];
  const int H3 = 3 * H, ws = H3 + 1, BT = blockDim.y;
  float* w_s = smem;              // H x ws
  float* dw_s = w_s + H * ws;     // H x H3
  float* db_s = dw_s + H * H3;    // H3
  float* hp_s = db_s + H3;        // BT x H   masked h_{t-1}
  float* dg_s = hp_s + BT * H;    // BT x H3  adjoint on gh
  const int a = blockIdx.x, j = threadIdx.x, lb = threadIdx.y;
  const int b = blockIdx.y * BT + lb;
  const bool valid = b < B;
  const int tid = lb * H + j, nthr = BT * H;
  const int rows = min(BT, B - (int)blockIdx.y * BT);

  const float* wa = wh + (size_t)a * H * H3;
  for (int e = tid; e < H * H3; e += nthr) {
    const int k = e / H3;
    w_s[k * ws + (e - k * H3)] = wa[e];
    dw_s[e] = 0.0f;
  }
  for (int c = tid; c < H3; c += nthr) db_s[c] = 0.0f;
  const float* ba = bh + (size_t)a * H3;
  const float br = ba[j], bz = ba[H + j], bn = ba[2 * H + j];

  float dh = 0.0f;  // adjoint carried onto h_t
  for (int t = T - 1; t >= 0; --t) {
    const size_t row = ((size_t)a * T + t) * B + b;
    float keep = 0.0f, hp = 0.0f, g_r = 0.0f, g_z = 0.0f, g_n = 0.0f;
    float g_out = 0.0f;  // this step's output cotangent
    if (valid) {
      keep = 1.0f - resets[row];
      const float hprev = t > 0 ? hs[(row - B) * H + j]
                                : h0[((size_t)a * B + b) * H + j];
      hp = hprev * keep;
      const float* gr = gi + row * H3;
      g_r = gr[j];
      g_z = gr[H + j];
      g_n = gr[2 * H + j];
      g_out = g[row * H + j];
    }
    hp_s[lb * H + j] = hp;
    __syncthreads();

    const float* hrow = hp_s + lb * H;
    float ar = 0.0f, az = 0.0f, an = 0.0f;
    for (int k = 0; k < H; ++k) {
      const float hk = hrow[k];
      const float* wk = w_s + k * ws;
      ar = fmaf(hk, wk[j], ar);
      az = fmaf(hk, wk[H + j], az);
      an = fmaf(hk, wk[2 * H + j], an);
    }
    float da_r = 0.0f, da_z = 0.0f, da_n = 0.0f, r = 0.0f, dhp = 0.0f;
    if (valid) {
      const float h_n = an + bn;
      r = sigmoid_f32(g_r + (ar + br));
      const float z = sigmoid_f32(g_z + (az + bz));
      const float n = tanhf(g_n + r * h_n);
      const float d = g_out + dh;  // total adjoint on h_t
      const float dn = d * (1.0f - z);
      const float dz = d * (hp - n);
      dhp = d * z;
      da_n = dn * (1.0f - n * n);
      const float dr = da_n * h_n;
      da_z = dz * z * (1.0f - z);
      da_r = dr * r * (1.0f - r);
      float* dgo = dgi + row * H3;
      dgo[j] = da_r;
      dgo[H + j] = da_z;
      dgo[2 * H + j] = da_n;
    }
    float* dgrow = dg_s + lb * H3;
    dgrow[j] = da_r;
    dgrow[H + j] = da_z;
    dgrow[2 * H + j] = da_n * r;
    __syncthreads();

    // adjoint on the masked h_{t-1}: d*z + dgh . W_h[j, :]
    const float* wj = w_s + j * ws;
    for (int c = 0; c < H3; ++c) dhp = fmaf(dgrow[c], wj[c], dhp);
    dh = dhp * keep;
    // dW_h += hp^T dgh and db_h += sum_rows dgh, one owner per element
    for (int e = tid; e < H * H3; e += nthr) {
      const int k = e / H3, c = e - k * H3;
      float s = dw_s[e];
      for (int rb = 0; rb < rows; ++rb)
        s = fmaf(hp_s[rb * H + k], dg_s[rb * H3 + c], s);
      dw_s[e] = s;
    }
    for (int c = tid; c < H3; c += nthr) {
      float s = db_s[c];
      for (int rb = 0; rb < rows; ++rb) s += dg_s[rb * H3 + c];
      db_s[c] = s;
    }
    __syncthreads();
  }

  if (valid) dh0[((size_t)a * B + b) * H + j] = dh;
  const size_t part = (size_t)a * gridDim.y + blockIdx.y;
  for (int e = tid; e < H * H3; e += nthr)
    dwh_part[part * H * H3 + e] = dw_s[e];
  for (int c = tid; c < H3; c += nthr) dbh_part[part * H3 + c] = db_s[c];
}

// out[a, e] = sum over tiles, in tile order, of part[a, tile, e]
__global__ void gru_sum_tiles(const float* __restrict__ part,
                              float* __restrict__ out, int A, int tiles,
                              int n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)A * n) return;
  const size_t a = idx / n, e = idx - a * n;
  const float* p = part + a * tiles * n + e;
  float s = 0.0f;
  for (int tile = 0; tile < tiles; ++tile) s += p[(size_t)tile * n];
  out[idx] = s;
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

size_t gru_forward_smem_bytes(int H, int block_rows) {
  return ((size_t)H * (3 * H + 1) + (size_t)block_rows * H) * sizeof(float);
}

size_t gru_backward_smem_bytes(int H, int block_rows) {
  return ((size_t)H * (3 * H + 1) + (size_t)H * 3 * H + 3 * H +
          (size_t)block_rows * 4 * H) * sizeof(float);
}

// Each launcher returns the error of its configuration calls; the caller
// checks the launch itself right after (cudaGetLastError).
cudaError_t launch_gru_forward(const float* gi, const float* wh,
                               const float* bh, const float* h0,
                               const float* resets, float* hs, int A, int T,
                               int B, int H, int block_rows,
                               cudaStream_t stream) {
  const size_t smem = gru_forward_smem_bytes(H, block_rows);
  cudaError_t err = allow_smem((const void*)gru_fwd, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(A, (B + block_rows - 1) / block_rows), block(H, block_rows);
  gru_fwd<<<grid, block, smem, stream>>>(gi, wh, bh, h0, resets, hs, T, B, H);
  return cudaSuccess;
}

cudaError_t launch_gru_backward(const float* gi, const float* wh,
                                const float* bh, const float* h0,
                                const float* resets, const float* hs,
                                const float* g, float* dgi, float* dwh_part,
                                float* dbh_part, float* dh0, int A, int T,
                                int B, int H, int block_rows,
                                cudaStream_t stream) {
  const size_t smem = gru_backward_smem_bytes(H, block_rows);
  cudaError_t err = allow_smem((const void*)gru_bwd, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(A, (B + block_rows - 1) / block_rows), block(H, block_rows);
  gru_bwd<<<grid, block, smem, stream>>>(gi, wh, bh, h0, resets, hs, g, dgi,
                                         dwh_part, dbh_part, dh0, T, B, H);
  return cudaSuccess;
}

cudaError_t launch_gru_sum_tiles(const float* part, float* out, int A,
                                 int tiles, int n, cudaStream_t stream) {
  const size_t total = (size_t)A * n;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  gru_sum_tiles<<<blocks, threads, 0, stream>>>(part, out, A, tiles, n);
  return cudaSuccess;
}
