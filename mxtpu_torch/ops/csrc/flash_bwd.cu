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
// Design for the GPU: one kernel template, two modes.  A block owns a
// block of "rows" and loops over "column" tiles, so each output is
// accumulated in f32 registers and written once, with no atomics (the
// result is deterministic):
//   * dq: rows are queries, columns keys.  The row operands are Q and G,
//     the column tiles K and V, and dq += dS K.  Key tiles past the
//     causal diagonal are skipped.
//   * dk/dv: rows are keys, columns queries.  The row operands are K and
//     V, the column tiles Q and G, and the transposed blocks S^T = K Q^T
//     and dP^T = V G^T give dv += P^T G and dk += dS^T Q.  Query tiles
//     before the causal diagonal are skipped.
// Ragged Tq and Tk are masked in the kernel: rows past the end are read
// as zeros and not written, and columns past the end get P = 0.  Head
// dims 16, 32, 64 and 128.  Three paths, chosen by dtype and head dim at
// compile time:
//   * bf16, d = 64 and 128 (the trained path; namespace wg): warp-
//     specialised wgmma.  A block of 384 threads owns 128 rows at a time:
//     one producer warpgroup (one thread of it issues every TMA copy; the
//     warpgroup gives up its registers with setmaxnreg) and two consumer
//     warpgroups of 64 rows each.  The row operands come in once an item
//     by TMA (3-D tensor maps over (d, T, bh), 64-column boxes with the
//     128-byte swizzle: rows past the end read as zeros and the next head
//     is never read); 64-wide column tiles stream through a ring of 3
//     (d = 128) or 4 shared-memory stages, each with a `full` mbarrier
//     (expect_tx) and an `empty` one the 8 consumer warps arrive on.
//     In dk/dv the
//     producer's warp also copies each tile's column stats (lse and
//     delta) into its stage by cp.async, which the `full` barrier tracks
//     (cp.async.mbarrier.arrive): a tensor map cannot take their 4-byte
//     rows at every Tq, and copies through registers would put a round
//     trip to memory into every tile's issue.  Per tile, S and dP are
//     wgmma m64n64k16 with both operands K-major in shared memory, two
//     groups, so that P = 2^(s * sm_scale * log2(e) - lse * log2(e)) (one
//     FFMA and one ex2) runs while dP is in flight; then the mask, dS in
//     f32, P and dS rounded to bf16 straight from the accumulators into
//     wgmma's register A fragment, and the accumulating products are
//     wgmma m64n{d}k16 with the column tile read MN-major (transposed)
//     from the same stage.  A warpgroup skips (waits for and releases)
//     the tiles wholly above its part of the diagonal, which are the
//     first it visits: dk/dv visits query tiles ascending, dq key tiles
//     descending.  No branch surrounds a wgmma issue or wait, so ptxas
//     keeps them asynchronous.  Each warp's 16 output rows go out
//     through a padded buffer of its own in shared memory, as whole rows
//     in 16-byte pieces (straight from the fragments, a warp's store
//     touches 8 rows, and both kernels were slower on an H100: PERF.md).
//     Setmaxnreg gives the producer 32 registers (24 spilled in dk/dv)
//     and each consumer thread 232.  Persistent: one block an SM walks
//     (row block, head) items, heaviest first within a head, in a zigzag
//     over blocks; the rows are released after the item's last score
//     products, so the next item's rows load under its last products and
//     its output stores.
//   * bf16, d = 16 and 32 (namespace tc): the earlier mma.sync design,
//     kept because those widths need the 32- and 64-byte swizzles on the
//     wgmma path and no model uses them: 4 warps, 16 rows a warp, 64-row
//     blocks and 64-wide column tiles double-buffered by cp.async; the
//     score blocks stay in registers in the C layout, which after P and
//     dS are rounded to bf16 is the A layout of the next product; the
//     column tiles enter that product through ldmatrix.trans.
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
// on the tensor cores (wgmma, the only way to their full rate on this
// card) and every score block on chip: S, P, dP and dS never touch
// device memory, the row operands are read once, and the column tiles a
// head's blocks share are re-read from the 50 MB L2, each by 128 rows
// (with 64-row blocks, twice as often).
#include "hopper.cuh"
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

// ------------------------------- bf16 wgmma path (d = 64 and 128, sm_90a)

namespace wg {

using namespace hopper;
using bf16 = __nv_bfloat16;
using mma_bf16::pack;

constexpr int BR = 128;            // rows a work item: 2 warpgroups x 64
constexpr int BC = 64;             // columns a tile
constexpr int NTHREADS = 384;      // producer warpgroup, 2 consumer ones
constexpr int CONSUMER_WARPS = 8;  // arrivals that release a stage
constexpr float LOG2E = 1.44269504088896341f;
// A column tile's rows are the reduction of the accumulating products
// (dq += dS K, dk += dS^T Q, dv += P^T G), so as their B (rows x d) it is
// MN-major: read it transposed
constexpr int C_TRANS = 1;

template <int D>
struct Tile {
  static constexpr int BOXES = D / 64;  // 64-column (128-byte) boxes a row
  // column tiles in flight (at d = 128, 4 leave no room for the output
  // buffers, and 3 were as fast on an H100)
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr uint32_t ROW_BOX = BR * 128;     // one box of X1 or X2
  static constexpr uint32_t ROW_BYTES = BR * D * 2;
  static constexpr uint32_t COL_BOX = BC * 128;     // one box of C1 or C2
  static constexpr uint32_t COL_BYTES = BC * D * 2;
  static constexpr uint32_t STAT_BYTES = 2 * BC * 4;  // a tile's lse, delta
  // a consumer warp's 16 output rows, each padded by 16 bytes so that
  // the fragment's 4-byte writes meet 32 banks
  static constexpr uint32_t OUT_STRIDE = D * 2 + 16;
  static constexpr uint32_t OUT_WARP_BYTES = 16 * OUT_STRIDE;
  // X1, X2, the C1 stages, the C2 stages, the column stats, the output
  // buffers, the barriers; and room to align the base to 1024 bytes (the
  // swizzle atom)
  static constexpr size_t smem_bytes() {
    return 1024 + 2 * ROW_BYTES + STAGES * (2 * COL_BYTES + STAT_BYTES) +
           CONSUMER_WARPS * OUT_WARP_BYTES + (2 + 2 * STAGES) * 8;
  }
};

// 4 bytes from global memory into shared memory, asynchronously (zeros
// where `in` is false; src must be a valid address all the same)
__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// one arrival on bar once this thread's earlier cp.async copies have
// landed (counted among the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The w-th work item: row block rb of head w / n_rb, where the row blocks
// of a head are ordered heaviest first under a causal mask (dk/dv: the
// low key blocks see the most queries; dq: the high query blocks see the
// most keys).  Its column tiles [c_begin, c_begin + n_tiles * BC) are
// visited ascending in dk/dv and descending in dq, so that the tiles a
// warpgroup skips (wholly above its part of the causal diagonal) come
// first in both.
template <bool DKV>
struct Item {
  int bh, r0, c_begin, n_tiles;
  __device__ __forceinline__ Item(int w, int n_rb, int tq, int tk,
                                  int causal) {
    bh = w / n_rb;
    const int rb = w % n_rb;
    if (DKV) {
      r0 = rb * BR;
      c_begin = causal ? r0 : 0;  // queries before the block's first key
      n_tiles = c_begin < tq ? (tq - c_begin + BC - 1) / BC : 0;
    } else {
      r0 = (n_rb - 1 - rb) * BR;
      c_begin = 0;
      // causal: the block's last row sees keys up to r0 + BR - 1
      const int c_end = causal ? min(tk, r0 + BR) : tk;
      n_tiles = (c_end + BC - 1) / BC;
    }
  }
  // the first column of the j-th tile visited
  __device__ __forceinline__ int col0(int j) const {
    return DKV ? c_begin + j * BC : (n_tiles - 1 - j) * BC;
  }
  // the tiles warpgroup cw (rows r0 + 64 cw ..) skips at the start: all of
  // them if it has no row before the end, else those wholly above its
  // part of the causal diagonal (dk/dv: the query tile at r0 for the
  // second warpgroup; dq: the last key tile for the first, where the
  // second sees one more)
  __device__ __forceinline__ int skip(int cw, int tq, int tk,
                                      int causal) const {
    const int rw = r0 + 64 * cw;
    if (rw >= (DKV ? tk : tq)) return n_tiles;
    if (!causal) return 0;
    if (DKV) return min(cw, n_tiles);
    return n_tiles - (min(tk, rw + 64) + BC - 1) / BC;
  }
};

__device__ __forceinline__ int item_of(int round, int n_items) {
  const int g = gridDim.x, b = blockIdx.x;
  const int w = round * g + (round % 2 == 0 ? b : g - 1 - b);
  return w < n_items ? w : -1;
}

// acc (+)= X C^T for the warpgroup's 64 rows of X (at xw) and the column
// tile at ct, 16 deep a step; at d = 128 steps 4-7 read the second box.
// One committed group.
template <int D>
__device__ __forceinline__ void issue_xc(float (&acc)[BC / 2],
                                         const unsigned char* xw,
                                         const unsigned char* ct) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(acc, desc_sw128(xw + (kk / 4) * Tile<D>::ROW_BOX + off, 16, 1024),
             desc_sw128(ct + (kk / 4) * Tile<D>::COL_BOX + off, 16, 1024),
             kk > 0);
  }
  wgmma_commit();
}

// acc += A C for A in registers (bf16, 64 columns) and the column tile at
// ct read transposed (TRANS = C_TRANS), 16 of its rows a step: two 8-row
// groups 1024 bytes apart; at d = 128 the second 64 columns are the next
// box (the leading offset).  Not committed.
template <int D, int TRANS>
__device__ __forceinline__ void issue_ac(float (&acc)[D / 2],
                                         const uint32_t (&a)[BC / 16][4],
                                         const unsigned char* ct) {
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk)
    wgmma_rs<TRANS>(acc, a[kk],
                    desc_sw128(ct + kk * 16 * 128, Tile<D>::COL_BOX, 1024));
}

// A 64 x 64 block of f32 accumulators rounded to bf16 in wgmma's register
// A layout: 8-column groups 2kk and 2kk+1 are the 16-deep step kk
__device__ __forceinline__ void pack_a(uint32_t (&a)[BC / 16][4],
                                       const float (&acc)[BC / 2]) {
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// A warp's 16 rows of an output (acc, the accumulator of m64n{d}) to
// rows rbase.. of out, those before n_rows: rounded to bf16 into the
// warp's buffer buf in the fragment layout, then read back and stored
// 16 bytes a thread, whole rows a warp instruction (written straight
// from the fragments, each store of a warp would touch 8 rows).
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           unsigned char* buf, bf16* out,
                                           int rbase, int n_rows, int lane) {
  using T = Tile<D>;
  constexpr int CHUNKS = D * 2 / 16;        // 16-byte pieces a row
  constexpr int ROWS_A_STEP = 32 / CHUNKS;  // rows a warp instruction
  const int g = lane / 4, c = lane % 4;
  __syncwarp();  // the buffer's earlier reads are done
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(buf + (g + 8 * h) * T::OUT_STRIDE +
                                   16 * j + 4 * c) =
          pack(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 / ROWS_A_STEP; ++i) {
    const int r = i * ROWS_A_STEP + lane / CHUNKS, k = lane % CHUNKS;
    const uint4 v =
        *reinterpret_cast<const uint4*>(buf + r * T::OUT_STRIDE + 16 * k);
    if (rbase + r < n_rows)
      *reinterpret_cast<uint4*>(
          reinterpret_cast<unsigned char*>(out + (size_t)(rbase + r) * D) +
          16 * k) = v;
  }
}

// One kernel, two modes, as the tc path: rows are queries and columns
// keys in dq (X1 = Q, X2 = G, C1 = K, C2 = V), rows keys and columns
// queries in dk/dv (X1 = K, X2 = V, C1 = Q, C2 = G).  Each tile gives
// S = X1 C1^T and dP = X2 C2^T (transposed blocks in dk/dv), P and dS,
// then out1 += dS C1 and, in dk/dv, out2 += P C2.  scale_log2 = sm_scale
// * log2(e).  Persistent: one block an SM walks its work items
// (item_of), and the producer loads the next item's rows while the
// consumers finish this one.
template <int D, bool DKV>
__global__ void __launch_bounds__(NTHREADS, 1)
    kernel(const __grid_constant__ CUtensorMap tm_x1,
           const __grid_constant__ CUtensorMap tm_x2,
           const __grid_constant__ CUtensorMap tm_c1,
           const __grid_constant__ CUtensorMap tm_c2,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ out1, bf16* __restrict__ out2, int n_bh,
           int tq, int tk, float scale_log2, float sm_scale, int causal) {
  using T = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sx1 =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sx2 = sx1 + T::ROW_BYTES;
  unsigned char* sc1 = sx2 + T::ROW_BYTES;          // C1 stages
  unsigned char* sc2 = sc1 + T::STAGES * T::COL_BYTES;  // C2 stages
  // per stage (dk/dv): lse, then delta, of the tile's 64 columns
  float* sst = reinterpret_cast<float*>(sc2 + T::STAGES * T::COL_BYTES);
  unsigned char* sout =
      reinterpret_cast<unsigned char*>(sst + T::STAGES * 2 * BC);
  uint64_t* full_x = reinterpret_cast<uint64_t*>(
      sout + CONSUMER_WARPS * T::OUT_WARP_BYTES);
  uint64_t* empty_x = full_x + 1;
  uint64_t* full = empty_x + 1;
  uint64_t* empty = full + T::STAGES;

  const int n_rows = DKV ? tk : tq, n_cols = DKV ? tq : tk;
  const int n_rb = (n_rows + BR - 1) / BR;
  const int n_items = n_bh * n_rb;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(full_x, 1);
    mbar_init(empty_x, CONSUMER_WARPS);
    for (int s = 0; s < T::STAGES; ++s) {
      // dk/dv: also the 32 lanes of the producer warp that copy the
      // stats
      mbar_init(&full[s], DKV ? 33 : 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Tiles are counted across items (it): the it-th tile is in stage
  // it % STAGES, on that stage's barriers' (it / STAGES)-th phase.
  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA copy; in
    // dk/dv its warp also copies the column stats (lse, delta) by
    // cp.async, tracked by the stage's barrier (a tensor map cannot take
    // their rows of 4 bytes at every Tq)
    reg_dealloc<32>();
    const int lane = tid % 32;
    if (DKV ? tid < 32 : tid == 0) {
      if (lane == 0) {
        prefetch_tensormap(&tm_x1);
        prefetch_tensormap(&tm_x2);
        prefetch_tensormap(&tm_c1);
        prefetch_tensormap(&tm_c2);
      }
      int it = 0;
      for (int r = 0;; ++r) {
        const int w = item_of(r, n_items);
        if (w < 0) break;
        const Item<DKV> item(w, n_rb, tq, tk, causal);
        if (lane == 0) {
          // every consumer warp is done with the previous item's rows
          if (r > 0) mbar_wait(empty_x, (r - 1) & 1);
          mbar_arrive_expect_tx(full_x, 2 * T::ROW_BYTES);
#pragma unroll
          for (int b = 0; b < T::BOXES; ++b) {
            tma_load_3d(sx1 + b * T::ROW_BOX, &tm_x1, full_x, 64 * b,
                        item.r0, item.bh);
            tma_load_3d(sx2 + b * T::ROW_BOX, &tm_x2, full_x, 64 * b,
                        item.r0, item.bh);
          }
        }
        for (int j = 0; j < item.n_tiles; ++j, ++it) {
          const int s = it % T::STAGES;
          const int c0 = item.col0(j);
          // every consumer warp released this stage's previous tile
          if (it >= T::STAGES) mbar_wait(&empty[s], (it / T::STAGES - 1) & 1);
          if (DKV) {
            // columns past Tq get 0 (they are masked)
            const float* l = lse + (size_t)item.bh * tq;
            const float* dl = delta + (size_t)item.bh * tq;
            float* st = sst + s * 2 * BC;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = c0 + lane + 32 * h;
              const bool in = col < tq;
              cp_async4(st + lane + 32 * h, l + (in ? col : 0), in);
              cp_async4(st + BC + lane + 32 * h, dl + (in ? col : 0), in);
            }
            cp_async_arrive(&full[s]);
          }
          if (lane == 0) {
            // the full boxes are counted, rows past the end too (TMA
            // writes zeros)
            mbar_arrive_expect_tx(&full[s], 2 * T::COL_BYTES);
#pragma unroll
            for (int b = 0; b < T::BOXES; ++b) {
              tma_load_3d(sc1 + s * T::COL_BYTES + b * T::COL_BOX, &tm_c1,
                          &full[s], 64 * b, c0, item.bh);
              tma_load_3d(sc2 + s * T::COL_BYTES + b * T::COL_BOX, &tm_c2,
                          &full[s], 64 * b, c0, item.bh);
            }
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 rows of each item each
    reg_alloc<232>();
    // the warpgroup index, read from lane 0 so that the compiler sees it
    // uniform and keeps the wgmma descriptors in uniform registers
    const int cw = __shfl_sync(0xffffffffu, tid / 128, 0) - 1;
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const unsigned char* x1w = sx1 + cw * 64 * 128;  // this warpgroup's rows
    const unsigned char* x2w = sx2 + cw * 64 * 128;
    int it = 0;
    for (int r = 0;; ++r) {
      const int w = item_of(r, n_items);
      if (w < 0) break;
      const Item<DKV> item(w, n_rb, tq, tk, causal);
      const int n_tiles = item.n_tiles;
      const int rbase = item.r0 + cw * 64 + warp * 16;  // this warp's 1st row
      const int row0 = rbase + g;  // this thread's rows: row0 and row0 + 8

      float acc1[D / 2];                  // dq or dk
      float acc2[DKV ? D / 2 : 1];        // dv
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc1[i] = 0.f;
#pragma unroll
      for (int i = 0; i < (DKV ? D / 2 : 1); ++i) acc2[i] = 0.f;
      // dq: this thread's rows' -lse * log2(e) and delta; rows past Tq
      // get 0, so that P stays finite and dS is 0 (their Q and G are 0)
      float nl_row[2] = {0.f, 0.f}, dl_row[2] = {0.f, 0.f};
      if (!DKV) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row < tq) {
            nl_row[h] = -lse[(size_t)item.bh * tq + row] * LOG2E;
            dl_row[h] = delta[(size_t)item.bh * tq + row];
          }
        }
      }

      mbar_wait(full_x, r & 1);
      // the tiles this warpgroup skips: each is waited for, so that the
      // stage's previous phase is complete, and released
      const int skip = item.skip(cw, tq, tk, causal);
      for (int j = 0; j < skip; ++j) {
        const int s = (it + j) % T::STAGES;
        mbar_wait(&full[s], ((it + j) / T::STAGES) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      if (skip >= n_tiles) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_x);
      }

      for (int j = skip; j < n_tiles; ++j) {
        const int s = (it + j) % T::STAGES;
        const int c0 = item.col0(j);
        const unsigned char* c1t = sc1 + s * T::COL_BYTES;
        const unsigned char* c2t = sc2 + s * T::COL_BYTES;
        const float* st = sst + s * 2 * BC;
        float sacc[BC / 2], dpacc[BC / 2];
        uint32_t pa[BC / 16][4], da[BC / 16][4];

        // S and dP: two groups, the exponentials of S run under dP
        mbar_wait(&full[s], ((it + j) / T::STAGES) & 1);
        wgmma_fence();
        issue_xc<D>(sacc, x1w, c1t);
        issue_xc<D>(dpacc, x2w, c2t);
        wgmma_wait<1>();
        fence_regs(sacc);
        // P = 2^(s * sm_scale * log2(e) - lse * log2(e)): one FFMA and
        // one ex2 a score.  Score 4 jj + e is row row0 + 8 (e / 2),
        // column c0 + 8 jj + 2c + e % 2.
#pragma unroll
        for (int jj = 0; jj < BC / 8; ++jj) {
          float2 nl2 = make_float2(0.f, 0.f);
          if (DKV) {
            nl2 = *reinterpret_cast<const float2*>(st + 8 * jj + 2 * c);
            nl2.x *= -LOG2E;
            nl2.y *= -LOG2E;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float nl = DKV ? ((e & 1) ? nl2.y : nl2.x) : nl_row[e >> 1];
            sacc[4 * jj + e] =
                exp2_approx(fmaf(sacc[4 * jj + e], scale_log2, nl));
          }
        }
        wgmma_wait<0>();
        fence_regs(dpacc);
        if (j == n_tiles - 1) {
          // every product that reads the rows is done: the producer may
          // load the next item's
          __syncwarp();
          if (lane == 0) mbar_arrive(empty_x);
        }
        {
          // P = 0 for columns past the end and, causal, for q < k, where
          // this warp's rows can meet either
          const bool edge =
              c0 + BC > n_cols ||
              (causal && (DKV ? c0 < rbase + 15 : c0 + BC - 1 > rbase));
          if (edge) {
#pragma unroll
            for (int i = 0; i < BC / 2; ++i) {
              const int col = c0 + 8 * (i / 4) + 2 * c + (i & 1);
              const int row = row0 + 8 * ((i / 2) & 1);
              if (col >= n_cols || (causal && (DKV ? col < row : row < col)))
                sacc[i] = 0.f;
            }
          }
        }
        // dS = P (dP - delta) sm_scale in f32
#pragma unroll
        for (int jj = 0; jj < BC / 8; ++jj) {
          const float2 dl2 =
              DKV ? *reinterpret_cast<const float2*>(st + BC + 8 * jj + 2 * c)
                  : make_float2(0.f, 0.f);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jj + e;
            const float dl = DKV ? ((e & 1) ? dl2.y : dl2.x) : dl_row[e >> 1];
            dpacc[i] = sacc[i] * (dpacc[i] - dl) * sm_scale;
          }
        }
        // P and dS rounded to bf16, then out1 += dS C1 and (dk/dv)
        // out2 += P C2
        pack_a(da, dpacc);
        if constexpr (DKV) pack_a(pa, sacc);
        wgmma_fence();
        issue_ac<D, C_TRANS>(acc1, da, c1t);
        if constexpr (DKV) issue_ac<D, C_TRANS>(acc2, pa, c2t);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc1);
        if constexpr (DKV) fence_regs(acc2);
        // this warp is done with stage s (its wgmmas retired)
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      it += n_tiles;

      // the outputs, rounded to bf16; rows past the end are not written
      unsigned char* wbuf = sout + (cw * 4 + warp) * T::OUT_WARP_BYTES;
      const size_t base = (size_t)item.bh * n_rows * D;
      store_rows<D>(acc1, wbuf, out1 + base, rbase, n_rows, lane);
      if constexpr (DKV)
        store_rows<D>(acc2, wbuf, out2 + base, rbase, n_rows, lane);
    }
  }
}

}  // namespace wg

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

// The wgmma path: tensor maps over the row operands (boxes of 128 rows)
// and the column tiles (64 rows), and one block an SM, or one an item.
template <int D, bool DKV>
cudaError_t run_wg(const Args& a, cudaStream_t stream) {
  const int n_rows = DKV ? a.tk : a.tq, n_cols = DKV ? a.tq : a.tk;
  CUtensorMap maps[4];
  if (!hopper::tensor_map(&maps[0], DKV ? a.k : a.q, a.bh, n_rows, D,
                          wg::BR) ||
      !hopper::tensor_map(&maps[1], DKV ? a.v : a.g, a.bh, n_rows, D,
                          wg::BR) ||
      !hopper::tensor_map(&maps[2], DKV ? a.q : a.k, a.bh, n_cols, D,
                          wg::BC) ||
      !hopper::tensor_map(&maps[3], DKV ? a.g : a.v, a.bh, n_cols, D,
                          wg::BC))
    return cudaErrorInvalidValue;
  const size_t smem = wg::Tile<D>::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      wg::kernel<D, DKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long items = (long long)a.bh * ((n_rows + wg::BR - 1) / wg::BR);
  const int grid = (int)(items < sms ? items : sms);
  wg::kernel<D, DKV><<<grid, wg::NTHREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.delta,
      static_cast<wg::bf16*>(a.out1), static_cast<wg::bf16*>(a.out2), a.bh,
      a.tq, a.tk, a.sm_scale * wg::LOG2E, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <int D, bool DKV>
cudaError_t launch(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 0)
    return run<DKV>(f32::kernel<D, DKV>, f32::NTHREADS,
                    f32::Tile<D>::smem_bytes(), a, stream);
  if constexpr (D >= 64)
    return run_wg<D, DKV>(a, stream);
  else
    return run<DKV>(tc::kernel<D, DKV>, tc::NTHREADS,
                    tc::Tile<D>::smem_bytes(), a, stream);
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
