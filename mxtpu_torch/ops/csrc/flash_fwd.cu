// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// that mxtpu_torch/ops/flash_attention.py loads through ctypes.
//
// Replaces the TPU kernel mxtpu/ops/pallas_attention.py::_flash_kernel
// (launched by _flash_forward_pallas).  It computes the same function:
// S = (Q K^T) * sm_scale on f32 scores, an optional top-left-aligned
// causal mask (q_idx >= k_idx) with the mask value -1e30, an online
// softmax over key tiles with a running max, a running sum and an f32
// accumulator, the probabilities rounded to V's dtype before P V, the
// final divide with l clamped at 1e-30, O in Q's dtype, and, when asked,
// the per-row LSE = m + log(l) in f32 of shape (bh, Tq).
//
// Design for the GPU (not a block-by-block copy of the Pallas grid):
//   * grid (bh, ceil(Tq / 64)); one block owns 64 query rows and loops
//     over 64-row key tiles itself, so the running max, sum and
//     accumulator never leave the block (the TPU kernel carried them in
//     VMEM scratch across a sequential grid axis);
//   * key tiles wholly above the causal diagonal are never loaded;
//   * ragged Tq and Tk are masked in the kernel (rows past Tq are not
//     written, keys past Tk score -1e30), so the caller pads nothing;
//   * head dims 16, 32, 64 and 128.
// Two paths, by dtype:
//   * bf16 (the served path): tensor cores.  4 warps, 16 query rows a
//     warp; both products are mma.sync m16n8k16 with bf16 operands and
//     f32 accumulation, as the TPU kernel's native-dtype MXU products.
//     S, P and O stay in registers: the S accumulator's layout is P's
//     operand layout, so P is rounded to bf16 in place.  K/V tiles are
//     double-buffered in shared memory by cp.async (the next tile loads
//     while this one computes); V enters P V through ldmatrix.trans.
//   * f32: every product is an f32 FMA on the CUDA cores (no TF32: JAX's
//     f32 path is exact f32).  16 x 16 threads, S and P in shared memory.
//
// Bound at the served shape (bh 64, T 1024, d 128, bf16, causal):
//   operations 4 * bh * T^2 * d / 2 = 17.2 GFLOP -> 17 us at 989 TFLOP/s;
//   bytes q, k, v and o = 4 * 64 * 1024 * 128 * 2 B = 67 MB -> 20 us at
//   3.35 TB/s; so the least time is about 20 us and memory bounds it,
//   with the operations close behind.  The design reads each q tile once
//   and writes each o tile once, and keeps S and P on chip, so
//   device-memory traffic stays near those 67 MB (the K/V tiles that
//   the q tiles of one head share are re-read from the 50 MB L2).  For
//   the operations it runs both products on the tensor cores; mma.sync
//   reaches a fraction of the wgmma rate, and wgmma with TMA-fed tiles
//   is the next step for speed.
#include "mma_bf16.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // key rows per tile

// ------------------------------------------------------------ f32 path

namespace f32 {

constexpr int NTHREADS = 256;      // 16 x 16 threads
constexpr int S_STRIDE = BK + 16;  // score row stride: two rows of a warp
                                   // land 16 banks apart

// Row stride of the q and k tiles: an odd number of words, so the 16 key
// rows a warp reads at one depth hit 16 banks.
template <int D>
struct Tile {
  static constexpr int QK_STRIDE = D + 1;
  static constexpr size_t smem_bytes() {
    return (size_t)(BQ * QK_STRIDE + BK * QK_STRIDE + BK * D +
                    BQ * S_STRIDE + 3 * BQ) * sizeof(float);
  }
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, int tq, int tk, float sm_scale,
           int causal) {
  constexpr int QKS = Tile<D>::QK_STRIDE;
  constexpr int RPT = BQ / 16;  // query rows per thread
  constexpr int CPT = BK / 16;  // score columns per thread
  constexpr int DPT = D / 16;   // output columns per thread
  constexpr int ROWS_PER_WARP = BQ / (NTHREADS / 32);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sk = sq + BQ * QKS;
  float* sv = sk + BK * QKS;
  float* ss = sv + BK * D;        // scores, then P
  float* sm = ss + BQ * S_STRIDE;  // running max
  float* sl = sm + BQ;             // running sum
  float* sa = sl + BQ;             // this tile's rescale

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const float* qb = q + (size_t)bh * tq * D;
  const float* kb = k + (size_t)bh * tk * D;
  const float* vb = v + (size_t)bh * tk * D;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    sq[r * QKS + c] = (q0 + r < tq) ? qb[(size_t)(q0 + r) * D + c] : 0.f;
  }
  if (tid < BQ) {
    sm[tid] = NEG_INF;
    sl[tid] = 0.f;
  }
  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  // causal: this q tile's last row sees keys up to q0 + BQ - 1
  const int k_end = causal ? min(tk, q0 + BQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < tk;
      sk[r * QKS + c] = in ? kb[(size_t)(k0 + r) * D + c] : 0.f;
      sv[r * D + c] = in ? vb[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, columns tx + 16 j
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sq[(ty + 16 * i) * QKS + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sk[(tx + 16 * j) * QKS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kj = k0 + c;
        float x = s[i][j] * sm_scale;  // the scale applies to f32 scores
        if (kj >= tk || (causal && q0 + r < kj)) x = NEG_INF;
        ss[r * S_STRIDE + c] = x;
      }
    __syncthreads();

    // online softmax: each warp owns ROWS_PER_WARP rows, 2 columns a lane
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      float* row = ss + r * S_STRIDE;
      const float x0 = row[lane], x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      row[lane] = p0;
      row[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sa[r] = alpha;
        sl[r] = alpha * sl[r] + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float alpha = sa[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ss[(ty + 16 * i) * S_STRIDE + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = sv[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  float* ob = o + (size_t)bh * tq * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= tq) continue;
    const float l = fmaxf(sl[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      ob[(size_t)(q0 + r) * D + tx + 16 * j] = acc[i][j] / l;
  }
  if (lse != nullptr && tid < BQ && q0 + tid < tq)
    lse[(size_t)bh * tq + q0 + tid] = sm[tid] + logf(fmaxf(sl[tid], 1e-30f));
}

}  // namespace f32

// ------------------------------------------------- bf16 tensor-core path

namespace tc {

using namespace mma_bf16;
using bf16 = mma_bf16::bf16;
constexpr int NTHREADS = 128;  // 4 warps x 16 query rows = BQ

// Tile row stride in elements: rows stay 16-byte aligned (cp.async,
// ldmatrix) and sit 4 banks apart, so the 8 rows a fragment load or an
// ldmatrix phase touches hit 32 distinct banks.
template <int D>
struct Tile {
  static constexpr int STRIDE = D + 8;
  // q, then two buffers each of k and v
  static constexpr size_t smem_bytes() {
    return (size_t)(BQ + 4 * BK) * STRIDE * sizeof(bf16);
  }
};

// With the fragment layouts of mma_bf16.cuh a thread holds two query
// rows of the warp, g and g+8, and the C fragments of two neighbouring
// 8-key tiles of S are the A fragment of one 16-key step of P V.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, int tq, int tk, float sm_scale,
           int causal) {
  constexpr int STR = Tile<D>::STRIDE;
  constexpr int SW = STR / 2;     // row stride in 32-bit words
  constexpr int KSTEPS = D / 16;  // depth steps of Q K^T
  constexpr int NS = BK / 8;      // 8-key tiles of S
  constexpr int NO = D / 8;       // 8-column tiles of O
  constexpr int CHUNKS = D / 8;   // 16-byte pieces of a row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + BQ * STR;      // two buffers
  bf16* sv = sk + 2 * BK * STR;  // two buffers

  const int bh = blockIdx.x;
  // the q tiles with the most causal key tiles start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const bf16* qb = q + (size_t)bh * tq * D;
  const bf16* kb = k + (size_t)bh * tk * D;
  const bf16* vb = v + (size_t)bh * tk * D;

  // 64 rows from src (rows r0.., of which those >= rmax read as zeros)
  auto load_tile = [&](bf16* dst, const bf16* src, int r0, int rmax) {
    for (int i = tid; i < 64 * CHUNKS; i += NTHREADS) {
      const int r = i / CHUNKS, col = (i % CHUNKS) * 8;
      const bool in = r0 + r < rmax;
      cp_async16(dst + r * STR + col,
                 src + (size_t)(in ? r0 + r : 0) * D + col, in);
    }
  };

  // causal: this q tile's last row sees keys up to q0 + BQ - 1
  const int k_end = causal ? min(tk, q0 + BQ) : tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  load_tile(sq, qb, q0, tq);
  load_tile(sk, kb, 0, tk);
  load_tile(sv, vb, 0, tk);
  cp_async_commit();

  uint32_t qf[KSTEPS][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every reader of tile t - 1 is done
    if (t == 0) {
      const uint32_t* q32 = reinterpret_cast<const uint32_t*>(sq);
      const int r = warp * 16 + g;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        qf[kk][0] = q32[r * SW + kk * 8 + c];
        qf[kk][1] = q32[(r + 8) * SW + kk * 8 + c];
        qf[kk][2] = q32[r * SW + kk * 8 + 4 + c];
        qf[kk][3] = q32[(r + 8) * SW + kk * 8 + 4 + c];
      }
    }
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1;
      load_tile(sk + nb * BK * STR, kb, (t + 1) * BK, tk);
      load_tile(sv + nb * BK * STR, vb, (t + 1) * BK, tk);
      cp_async_commit();
    }
    const bf16* ck = sk + (t & 1) * BK * STR;
    const bf16* cv = sv + (t & 1) * BK * STR;
    const uint32_t* k32 = reinterpret_cast<const uint32_t*>(ck);
    const int k0 = t * BK;

    // S = Q K^T: B of key tile j is K's rows j*8.. read as words
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const uint32_t* kr = k32 + (j * 8 + g) * SW + kk * 8 + c;
        mma(s[j], qf[kk], kr[0], kr[4]);
      }

    // the scale applies to the f32 scores; mask where the tile may
    // reach past Tk or above this warp's part of the diagonal
    const bool edge =
        k0 + BK > tk || (causal && k0 + BK - 1 > q0 + warp * 16);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sm_scale;
        if (edge) {
          const int key = k0 + j * 8 + 2 * c + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (key >= tk || (causal && row < key)) x = NEG_INF;
        }
        s[j][e] = x;
      }

    // online softmax over this tile; a row's 4 threads are one quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = expf(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * h] = expf(s[j][2 * h] - m_new);
        s[j][2 * h + 1] = expf(s[j][2 * h + 1] - m_new);
        sum += s[j][2 * h] + s[j][2 * h + 1];
      }
      // the running sum keeps the f32 probabilities; alpha is the same
      // in the whole quad, so the shares add up to the row's sum
      l[h] = alpha * l[h] + sum;
      m[h] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
    }

    // acc += P V: P rounded to bf16 (V's dtype) in the A layout; B of
    // columns n2*16.. comes from V's rows by ldmatrix.trans (lanes 8i..
    // 8i+7 address matrix i: keys +8 for odd i, columns +8 for i >= 2)
    const int mi = lane / 8;
    const bf16* vrow = cv + ((lane % 8) + (mi & 1) * 8) * STR + (mi >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                              pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + kk * 16 * STR + n2 * 16);
        mma(acc[2 * n2], pa, b[0], b[1]);
        mma(acc[2 * n2 + 1], pa, b[2], b[3]);
      }
    }
  }

  bf16* ob = o + (size_t)bh * tq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    const int row = row0 + 8 * h;
    if (row >= tq) continue;
    const float lc = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + n * 8 + 2 * c) =
          pack(acc[n][2 * h] / lc, acc[n][2 * h + 1] / lc);
    if (lse != nullptr && c == 0)
      lse[(size_t)bh * tq + row] = m[h] + logf(lc);
  }
}

}  // namespace tc

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int bh, tq, tk;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <typename T>
cudaError_t run(void (*kern)(const T*, const T*, const T*, T*, float*, int,
                             int, float, int),
                int nthreads, size_t smem, const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.tq + BQ - 1) / BQ);
  kern<<<grid, nthreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.tq, a.tk, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const Args& a) {
  if (dtype == 0)
    return run<float>(f32::kernel<D>, f32::NTHREADS,
                      f32::Tile<D>::smem_bytes(), a);
  return run<tc::bf16>(tc::kernel<D>, tc::NTHREADS, tc::Tile<D>::smem_bytes(),
                       a);
}

}  // namespace

// q (bh, tq, d), k and v (bh, tk, d), o (bh, tq, d): contiguous, one
// dtype (0 float32, 1 bfloat16), 16-byte aligned.  lse (bh, tq) float32,
// or null.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int tq, int tk, int d, int dtype,
                         float sm_scale, int causal, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, bh, tq, tk, sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 16: return (int)launch<16>(dtype, a);
    case 32: return (int)launch<32>(dtype, a);
    case 64: return (int)launch<64>(dtype, a);
    case 128: return (int)launch<128>(dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
