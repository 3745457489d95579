// Flash-attention backward for Hopper (sm_90a): two kernels with a plain
// C interface that mxtpu_torch/ops/flash_attention.py loads through
// ctypes.
//
// Replaces the TPU kernels of mxtpu/ops/pallas_attention.py (launched by
// _flash_backward_pallas), with their shared block math _bwd_p_ds:
//   flash_bwd_dq  <- _flash_bwd_dq_kernel:  dq = sum_j dS_j K_j
//   flash_bwd_dkv <- _flash_bwd_dkv_kernel: dk = sum_i dS_i^T Q_i,
//                                           dv = sum_i P_i^T G_i
// Both rebuild the scores against the LSE the forward saved:
// S = (Q K^T) * sm_scale on f32 scores, masked scores -1e30 (causal is
// top-left aligned, q_idx >= k_idx), P = exp(S - lse), dP = G V^T,
// dS = P * (dP - delta) * sm_scale in f32, with delta = rowsum(O * G)
// computed by the caller in f32.  Every product takes its operands in
// their own dtype with f32 accumulation, and P and dS are rounded to the
// operands' dtype before they enter a product (_dot_f32 casts the f32
// side down).  In f32 that rounding changes nothing; in bf16 it is the
// JAX kernel's semantics.  The JAX package sends ragged lengths to its
// f32 jnp sweeps (_flash_bwd), which do not round P and dS; these
// kernels keep the cast-down rule at every length, so in f32 they equal
// those sweeps and in bf16 they equal the block kernels' math.
//
// Design for the GPU: one kernel template, two modes.  A block owns 64
// "rows" and loops over 64-wide "column" tiles, so each output is
// accumulated in f32 registers and written once, with no atomics (the
// result is deterministic):
//   * dq: grid (bh, ceil(Tq / 64)); rows are queries, columns keys.  The
//     row operands are Q and G, the column tiles K and V, and
//     dq += dS K.  Key tiles past the causal diagonal are skipped.
//   * dk/dv: grid (bh, ceil(Tk / 64)); rows are keys, columns queries.
//     The row operands are K and V, the column tiles Q and G, and the
//     transposed blocks S^T = K Q^T and dP^T = V G^T give
//     dv += P^T G and dk += dS^T Q.  Query tiles before the causal
//     diagonal are skipped.
// Ragged Tq and Tk are masked in the kernel: rows past the end are read
// as zeros and not written, and columns past the end score -1e30.
// Head dims 16, 32, 64 and 128.  Two paths, by dtype:
//   * bf16: tensor cores.  4 warps, 16 rows a warp.  All products are
//     mma.sync m16n8k16 (mma_bf16.cuh).  The two score-like products
//     leave their blocks in registers in the C layout, which after P and
//     dS are rounded to bf16 is the A layout of the next product; the
//     column tiles enter that product through ldmatrix.trans.  Column
//     tiles are double-buffered in shared memory by cp.async.
//   * f32: every product is an f32 FMA on the CUDA cores (no TF32: JAX's
//     f32 path is exact f32).  16 x 16 threads, P and dS in shared memory.
//
// Bound at the training shape (bh 64, T 1024, d 128, bf16, causal;
// bh * T (T + 1) / 2 = 33.6 M kept (q, k) pairs):
//   dq:    6 d flops a kept pair (S, dP, dS K) = 25.8 GFLOP -> 26 us at
//          989 TFLOP/s; bytes q, k, v, g read, dq written (5 * 16.8 MB)
//          plus lse and delta (0.5 MB) = 84.4 MB -> 25 us at 3.35 TB/s;
//   dk/dv: 8 d flops a kept pair (S, dP, P^T G, dS^T Q) = 34.4 GFLOP ->
//          35 us; bytes q, k, v, g read, dk and dv written (6 * 16.8 MB)
//          plus lse and delta = 101 MB -> 30 us.
// Both are bound by operations, just, so the design keeps every product
// on the tensor cores and every score block on chip: S, P, dP and dS
// never touch device memory, the row operands are read once, and the
// column tiles a head's blocks share are re-read from the 50 MB L2.
// mma.sync reaches a fraction of the wgmma rate; wgmma with TMA-fed
// tiles, and one fused sweep, are the next steps for speed.
#include "mma_bf16.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BR = 64;  // rows a block owns
constexpr int BC = 64;  // columns a loop step takes

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;  // (bh, tq) f32
  void *out1, *out2;         // dq and nothing, or dk and dv
  int bh, tq, tk;
  float sm_scale;
  int causal;
};

// Rows and columns of one mode.  Score element (row, col) is the pair
// (query, key) in dq and (key, query) in dk/dv.
template <bool DKV>
struct Mode {
  __device__ static int n_rows(const Args& a) { return DKV ? a.tk : a.tq; }
  __device__ static int n_cols(const Args& a) { return DKV ? a.tq : a.tk; }
  // the first row of this block: in dq the q tiles with the most key
  // tiles start first; in dk/dv the key tiles that see the most queries
  // are the low ones already
  __device__ static int row0() {
    return DKV ? blockIdx.y * BR : (gridDim.y - 1 - blockIdx.y) * BR;
  }
  // the columns a causal block visits: [begin, end)
  __device__ static int col_begin(const Args& a, int r0) {
    return (DKV && a.causal) ? r0 / BC * BC : 0;
  }
  __device__ static int col_end(const Args& a, int r0) {
    return (!DKV && a.causal) ? min(a.tk, r0 + BR) : n_cols(a);
  }
  __device__ static bool masked(const Args& a, int row, int col) {
    return col >= n_cols(a) ||
           (a.causal && (DKV ? col < row : row < col));  // q_idx < k_idx
  }
};

// ------------------------------------------------------------ f32 path

namespace f32 {

constexpr int NTHREADS = 256;      // 16 x 16 threads
constexpr int S_STRIDE = BC + 16;  // P / dS row stride: two rows of a warp
                                   // land 16 banks apart

// Row stride of the operand tiles: an odd number of words, so the 16
// rows a warp reads at one depth hit 16 banks.
template <int D>
struct Tile {
  static constexpr int STRIDE = D + 1;
  // two row operands, two column tiles, P and dS, row and column stats
  static constexpr size_t smem_bytes() {
    return (size_t)(2 * BR * STRIDE + 2 * BC * STRIDE + 2 * BR * S_STRIDE +
                    2 * BR + 2 * BC) * sizeof(float);
  }
};

template <int D, bool DKV>
__global__ void __launch_bounds__(NTHREADS) kernel(Args a) {
  using M = Mode<DKV>;
  constexpr int ST = Tile<D>::STRIDE;
  constexpr int RPT = BR / 16;  // rows per thread
  constexpr int CPT = BC / 16;  // score columns per thread
  constexpr int DPT = D / 16;   // output columns per thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sx1 = reinterpret_cast<float*>(smem_raw);
  float* sx2 = sx1 + BR * ST;
  float* sc1 = sx2 + BR * ST;
  float* sc2 = sc1 + BC * ST;
  float* sp = sc2 + BC * ST;        // P
  float* sds = sp + BR * S_STRIDE;  // dS
  float* srs = sds + BR * S_STRIDE; // row lse, row delta (dq)
  float* scs = srs + 2 * BR;        // column lse, column delta (dk/dv)

  const int bh = blockIdx.x;
  const int r0 = M::row0();
  const int n_rows = M::n_rows(a), n_cols = M::n_cols(a);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const size_t qo = (size_t)bh * a.tq * D, ko = (size_t)bh * a.tk * D;
  const float* Q = static_cast<const float*>(a.q) + qo;
  const float* G = static_cast<const float*>(a.g) + qo;
  const float* K = static_cast<const float*>(a.k) + ko;
  const float* V = static_cast<const float*>(a.v) + ko;
  const float* X1 = DKV ? K : Q;  // row operands
  const float* X2 = DKV ? V : G;
  const float* C1 = DKV ? Q : K;  // column tiles
  const float* C2 = DKV ? G : V;
  const float* lse = a.lse + (size_t)bh * a.tq;
  const float* dlt = a.delta + (size_t)bh * a.tq;

  for (int i = tid; i < BR * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    const bool in = r0 + r < n_rows;
    sx1[r * ST + c] = in ? X1[(size_t)(r0 + r) * D + c] : 0.f;
    sx2[r * ST + c] = in ? X2[(size_t)(r0 + r) * D + c] : 0.f;
  }
  // rows past Tq get lse = delta = 0: their Q and G rows are zeros, so
  // P stays finite and dS is 0
  if (!DKV && tid < BR) {
    const bool in = r0 + tid < n_rows;
    srs[tid] = in ? lse[r0 + tid] : 0.f;
    srs[BR + tid] = in ? dlt[r0 + tid] : 0.f;
  }

  float acc1[RPT][DPT], acc2[RPT][DPT];  // dq or dk; dv
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc1[i][j] = acc2[i][j] = 0.f;

  const int c_end = M::col_end(a, r0);
  for (int c0 = M::col_begin(a, r0); c0 < c_end; c0 += BC) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BC * D; i += NTHREADS) {
      const int r = i / D, c = i % D;
      const bool in = c0 + r < n_cols;
      sc1[r * ST + c] = in ? C1[(size_t)(c0 + r) * D + c] : 0.f;
      sc2[r * ST + c] = in ? C2[(size_t)(c0 + r) * D + c] : 0.f;
    }
    if (DKV && tid < BC) {
      const bool in = c0 + tid < n_cols;
      scs[tid] = in ? lse[c0 + tid] : 0.f;
      scs[BC + tid] = in ? dlt[c0 + tid] : 0.f;
    }
    __syncthreads();

    // S = X1 C1^T and dP = X2 C2^T for rows ty + 16 i, columns tx + 16 j
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float x1[RPT], x2[RPT], y1[CPT], y2[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        x1[i] = sx1[(ty + 16 * i) * ST + d];
        x2[i] = sx2[(ty + 16 * i) * ST + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        y1[j] = sc1[(tx + 16 * j) * ST + d];
        y2[j] = sc2[(tx + 16 * j) * ST + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(x1[i], y1[j], s[i][j]);
          dp[i][j] = fmaf(x2[i], y2[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float x = s[i][j] * a.sm_scale;  // the scale applies to f32 scores
        if (M::masked(a, r0 + r, c0 + c)) x = NEG_INF;
        const float l = DKV ? scs[c] : srs[r];
        const float dl = DKV ? scs[BC + c] : srs[BR + r];
        const float p = expf(x - l);
        sp[r * S_STRIDE + c] = p;
        sds[r * S_STRIDE + c] = p * (dp[i][j] - dl) * a.sm_scale;
      }
    __syncthreads();

    // acc1 += dS C1; in dk/dv also acc2 += P C2
#pragma unroll 4
    for (int kk = 0; kk < BC; ++kk) {
      float ds[RPT], pv[RPT], y1[DPT], y2[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        ds[i] = sds[(ty + 16 * i) * S_STRIDE + kk];
        pv[i] = DKV ? sp[(ty + 16 * i) * S_STRIDE + kk] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        y1[j] = sc1[kk * ST + tx + 16 * j];
        y2[j] = DKV ? sc2[kk * ST + tx + 16 * j] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          acc1[i][j] = fmaf(ds[i], y1[j], acc1[i][j]);
          if constexpr (DKV) acc2[i][j] = fmaf(pv[i], y2[j], acc2[i][j]);
        }
    }
  }

  float* o1 = static_cast<float*>(a.out1) + (size_t)bh * n_rows * D;
  float* o2 = DKV ? static_cast<float*>(a.out2) + (size_t)bh * n_rows * D
                  : nullptr;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      o1[(size_t)row * D + tx + 16 * j] = acc1[i][j];
      if constexpr (DKV) o2[(size_t)row * D + tx + 16 * j] = acc2[i][j];
    }
  }
}

}  // namespace f32

// ------------------------------------------------- bf16 tensor-core path

namespace tc {

using namespace mma_bf16;
using bf16 = mma_bf16::bf16;
constexpr int NTHREADS = 128;  // 4 warps x 16 rows = BR

// Tile row stride in elements: rows stay 16-byte aligned (cp.async,
// ldmatrix) and sit 4 banks apart, so the 8 rows of a fragment load or
// an ldmatrix phase hit 32 distinct banks.
template <int D>
struct Tile {
  static constexpr int STRIDE = D + 8;
  // two row operands, two buffers each of two column tiles, and two
  // buffers of column stats (lse, delta)
  static constexpr size_t smem_bytes() {
    return (size_t)(2 * BR + 4 * BC) * STRIDE * sizeof(bf16) +
           (size_t)2 * 2 * BC * sizeof(float);
  }
};

template <int D, bool DKV>
__global__ void __launch_bounds__(NTHREADS) kernel(Args a) {
  using M = Mode<DKV>;
  constexpr int STR = Tile<D>::STRIDE;
  constexpr int SW = STR / 2;     // row stride in 32-bit words
  constexpr int KSTEPS = D / 16;  // depth steps of the score products
  constexpr int NS = BC / 8;      // 8-column tiles of a score block
  constexpr int NO = D / 8;       // 8-column tiles of an output
  constexpr int CHUNKS = D / 8;   // 16-byte pieces of a row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sx1 = reinterpret_cast<bf16*>(smem_raw);
  bf16* sx2 = sx1 + BR * STR;
  bf16* sc1 = sx2 + BR * STR;      // two buffers
  bf16* sc2 = sc1 + 2 * BC * STR;  // two buffers
  float* sst = reinterpret_cast<float*>(sc2 + 2 * BC * STR);  // two buffers

  const int bh = blockIdx.x;
  const int r0 = M::row0();
  const int n_rows = M::n_rows(a), n_cols = M::n_cols(a);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int wr = warp * 16 + g;  // this thread's rows in the block: wr, wr+8

  const size_t qo = (size_t)bh * a.tq * D, ko = (size_t)bh * a.tk * D;
  const bf16* Q = static_cast<const bf16*>(a.q) + qo;
  const bf16* G = static_cast<const bf16*>(a.g) + qo;
  const bf16* K = static_cast<const bf16*>(a.k) + ko;
  const bf16* V = static_cast<const bf16*>(a.v) + ko;
  const bf16* X1 = DKV ? K : Q;  // row operands
  const bf16* X2 = DKV ? V : G;
  const bf16* C1 = DKV ? Q : K;  // column tiles
  const bf16* C2 = DKV ? G : V;
  const float* lse = a.lse + (size_t)bh * a.tq;
  const float* dlt = a.delta + (size_t)bh * a.tq;

  // 64 rows from src (rows r_0.., of which those >= rmax read as zeros)
  auto load_tile = [&](bf16* dst, const bf16* src, int r_0, int rmax) {
    for (int i = tid; i < 64 * CHUNKS; i += NTHREADS) {
      const int r = i / CHUNKS, col = (i % CHUNKS) * 8;
      const bool in = r_0 + r < rmax;
      cp_async16(dst + r * STR + col,
                 src + (size_t)(in ? r_0 + r : 0) * D + col, in);
    }
  };
  // dk/dv: the column tile's lse and delta; columns past Tq read 0
  auto load_stats = [&](int buf, int c_0) {
    float* dst = sst + buf * 2 * BC;
    for (int i = tid; i < BC; i += NTHREADS) {
      const bool in = c_0 + i < n_cols;
      dst[i] = in ? lse[c_0 + i] : 0.f;
      dst[BC + i] = in ? dlt[c_0 + i] : 0.f;
    }
  };

  const int c_begin = M::col_begin(a, r0);
  const int c_end = M::col_end(a, r0);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + BC - 1) / BC : 0;
  load_tile(sx1, X1, r0, n_rows);
  load_tile(sx2, X2, r0, n_rows);
  if (n_tiles > 0) {
    load_tile(sc1, C1, c_begin, n_cols);
    load_tile(sc2, C2, c_begin, n_cols);
    if (DKV) load_stats(0, c_begin);
  }
  cp_async_commit();

  // dq: this thread's two rows' lse and delta (rows past Tq: 0, see f32)
  float row_l[2] = {0.f, 0.f}, row_d[2] = {0.f, 0.f};
  if (!DKV) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wr + 8 * h;
      if (row < n_rows) {
        row_l[h] = lse[row];
        row_d[h] = dlt[row];
      }
    }
  }

  float acc1[NO][4], acc2[NO][4];  // dq or dk; dv (unused in dq)
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[n][e] = acc2[n][e] = 0.f;

  const uint32_t* x1w = reinterpret_cast<const uint32_t*>(sx1);
  const uint32_t* x2w = reinterpret_cast<const uint32_t*>(sx2);
  // ldmatrix.trans addresses: lanes 8i..8i+7 address matrix i, rows +8
  // for odd i, columns +8 for i >= 2
  const int mi = lane / 8;
  const int ld_off = ((lane % 8) + (mi & 1) * 8) * STR + (mi >> 1) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every reader of tile t - 1 is done
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1;
      const int cn = c_begin + (t + 1) * BC;
      load_tile(sc1 + nb * BC * STR, C1, cn, n_cols);
      load_tile(sc2 + nb * BC * STR, C2, cn, n_cols);
      cp_async_commit();
      if (DKV) load_stats(nb, cn);
    }
    const bf16* c1 = sc1 + (t & 1) * BC * STR;
    const bf16* c2 = sc2 + (t & 1) * BC * STR;
    const uint32_t* c1w = reinterpret_cast<const uint32_t*>(c1);
    const uint32_t* c2w = reinterpret_cast<const uint32_t*>(c2);
    const float* st = sst + (t & 1) * 2 * BC;
    const int c0 = c_begin + t * BC;

    // S = X1 C1^T and dP = X2 C2^T: B of column tile j is the tile's
    // rows j*8.. read as words
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t a1[4] = {x1w[wr * SW + kk * 8 + c],
                              x1w[(wr + 8) * SW + kk * 8 + c],
                              x1w[wr * SW + kk * 8 + 4 + c],
                              x1w[(wr + 8) * SW + kk * 8 + 4 + c]};
      const uint32_t a2[4] = {x2w[wr * SW + kk * 8 + c],
                              x2w[(wr + 8) * SW + kk * 8 + c],
                              x2w[wr * SW + kk * 8 + 4 + c],
                              x2w[(wr + 8) * SW + kk * 8 + 4 + c]};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const uint32_t* b1 = c1w + (j * 8 + g) * SW + kk * 8 + c;
        const uint32_t* b2 = c2w + (j * 8 + g) * SW + kk * 8 + c;
        mma(s[j], a1, b1[0], b1[4]);
        mma(dp[j], a2, b2[0], b2[4]);
      }
    }

    // P and dS in f32; masking only where the tile may reach past the
    // end or across this warp's part of the diagonal
    const int wrow0 = r0 + warp * 16;
    const bool edge =
        c0 + BC > n_cols ||
        (a.causal && (DKV ? c0 < wrow0 + 15 : c0 + BC - 1 > wrow0));
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = j * 8 + 2 * c + (e & 1);  // column in the tile
        float x = s[j][e] * a.sm_scale;
        if (edge && M::masked(a, r0 + wr + 8 * (e >> 1), c0 + cl))
          x = NEG_INF;
        const float l = DKV ? st[cl] : row_l[e >> 1];
        const float dl = DKV ? st[BC + cl] : row_d[e >> 1];
        const float p = expf(x - l);
        dp[j][e] = p * (dp[j][e] - dl) * a.sm_scale;  // dS
        s[j][e] = p;                                   // P
      }

    // acc1 += dS C1 and (dk/dv) acc2 += P C2: dS and P rounded to bf16 in
    // the A layout, C1 and C2 through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint32_t da[4] = {pack(dp[2 * kk][0], dp[2 * kk][1]),
                              pack(dp[2 * kk][2], dp[2 * kk][3]),
                              pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, c1 + ld_off + kk * 16 * STR + n2 * 16);
        mma(acc1[2 * n2], da, b[0], b[1]);
        mma(acc1[2 * n2 + 1], da, b[2], b[3]);
      }
      if constexpr (DKV) {
        const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                                pack(s[2 * kk][2], s[2 * kk][3]),
                                pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, c2 + ld_off + kk * 16 * STR + n2 * 16);
          mma(acc2[2 * n2], pa, b[0], b[1]);
          mma(acc2[2 * n2 + 1], pa, b[2], b[3]);
        }
      }
    }
  }

  bf16* o1 = static_cast<bf16*>(a.out1) + (size_t)bh * n_rows * D;
  bf16* o2 = static_cast<bf16*>(a.out2) + (size_t)bh * n_rows * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + wr + 8 * h;
    if (row >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(o1 + (size_t)row * D + n * 8 + 2 * c) =
          pack(acc1[n][2 * h], acc1[n][2 * h + 1]);
      if constexpr (DKV)
        *reinterpret_cast<uint32_t*>(o2 + (size_t)row * D + n * 8 + 2 * c) =
            pack(acc2[n][2 * h], acc2[n][2 * h + 1]);
    }
  }
}

}  // namespace tc

template <bool DKV>
cudaError_t run(void (*kern)(Args), int nthreads, size_t smem,
                const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_rows = DKV ? a.tk : a.tq;
  const dim3 grid(a.bh, (n_rows + BR - 1) / BR);
  kern<<<grid, nthreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool DKV>
cudaError_t launch(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 0)
    return run<DKV>(f32::kernel<D, DKV>, f32::NTHREADS,
                    f32::Tile<D>::smem_bytes(), a, stream);
  return run<DKV>(tc::kernel<D, DKV>, tc::NTHREADS, tc::Tile<D>::smem_bytes(),
                  a, stream);
}

template <bool DKV>
int dispatch(int d, int dtype, const Args& a, void* stream) {
  if (a.bh <= 0 || a.tq <= 0 || a.tk <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return (int)launch<16, DKV>(dtype, a, s);
    case 32: return (int)launch<32, DKV>(dtype, a, s);
    case 64: return (int)launch<64, DKV>(dtype, a, s);
    case 128: return (int)launch<128, DKV>(dtype, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q and g (bh, tq, d), k and v (bh, tk, d), dq (bh, tq, d), dk and dv
// (bh, tk, d): contiguous, one dtype (0 float32, 1 bfloat16), 16-byte
// aligned.  lse and delta (bh, tq) float32, contiguous.  Each launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* g, const void* lse,
                            const void* delta, void* dq, int bh, int tq,
                            int tk, int d, int dtype, float sm_scale,
                            int causal, void* stream) {
  const Args a{q, k, v, g,
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               dq, nullptr, bh, tq, tk, sm_scale, causal};
  return dispatch<false>(d, dtype, a, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* g, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int tq, int tk, int d, int dtype,
                             float sm_scale, int causal, void* stream) {
  const Args a{q, k, v, g,
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               dk, dv, bh, tq, tk, sm_scale, causal};
  return dispatch<true>(d, dtype, a, stream);
}
