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
// Design for the GPU (not a block-by-block copy of the Pallas grid): a
// block owns a tile of query rows and loops over key tiles itself, so the
// running max, sum and accumulator never leave the block (the TPU kernel
// carried them in VMEM scratch across a sequential grid axis); key tiles
// wholly above the causal diagonal are never loaded; ragged Tq and Tk are
// handled in the kernel (rows past Tq are not written, keys past Tk score
// as masked), so the caller pads nothing.  Head dims 16, 32, 64 and 128.
// Three paths, chosen by dtype and head dim at compile time:
//   * bf16, d = 64 and 128 (the served and trained path; namespace wg):
//     warp-specialised wgmma.  A block of 384 threads owns 128 query rows
//     at a time: one producer warpgroup (one thread of it issues every
//     copy; the warpgroup gives up its registers with setmaxnreg) and two
//     consumer warpgroups of 64 rows each.  Q and 128-key tiles of K and V
//     come in by TMA (3-D tensor maps over (d, T, bh), 64-column boxes
//     with the 128-byte swizzle: out-of-range rows read as zeros and the
//     next head is never read), K and V through a ring of shared-memory
//     stages; each stage has a `full` mbarrier for K, one for V (with
//     expect_tx byte counts) and an `empty` one the 8 consumer warps
//     arrive on, and phase parities alone order producer and consumers.
//     S = Q K^T is wgmma m64n128k16 with both operands from shared memory
//     (K is K-major, as wgmma's B wants it); the online softmax runs in
//     registers in the log2 domain, p = 2^(s * sm_scale * log2(e) - m)
//     in one FFMA and one ex2 (the scale still applies to the f32 score,
//     and the LSE goes back to the natural log); P is rounded to bf16
//     from the S accumulators into wgmma's register A fragment, and
//     O += P V is wgmma m64n{d}k16 with V read MN-major (transposed) from
//     the same tiles.  Key tiles run from the last to the first, so that
//     only the first tile processed can need a mask.  The kernel is
//     persistent: one block an SM walks (q tile, head) items, the q tiles
//     of a head together, and its producer loads the next item's Q and
//     K/V while the consumers finish the current one.
//     Each consumer warpgroup runs its products one after the other (P V
//     of the previous tile, S of this one, then the softmax), and the two
//     warpgroups take turns on the tensor cores through named barriers.
//     Overlapping one warpgroup's softmax with its own next S (FA3's
//     intra-warpgroup pipelining) needs S, O and P live at once: ptxas
//     then spills and serialises every wgmma, and with P staged through
//     shared memory instead it inserts waits; both were slower on the
//     card (PERF.md, PR 3).
//   * bf16, d = 16 and 32 (namespace tc): the earlier mma.sync design,
//     kept because those widths need the 32- and 64-byte swizzles on the
//     wgmma path and no served or trained model uses them: 4 warps x 16
//     query rows, mma.sync m16n8k16, cp.async double-buffered K/V tiles,
//     V through ldmatrix.trans.
//   * f32: every product is an f32 FMA on the CUDA cores (no TF32: JAX's
//     f32 path is exact f32).  16 x 16 threads, S and P in shared memory.
//
// Bound at the served shape (bh 64, T 1024, d 128, bf16, causal):
//   operations 4 * d per kept (query, key) pair = 17.2 GFLOP -> 17 us at
//   989 TFLOP/s; bytes q, k, v and o = 4 * 64 * 1024 * 128 * 2 B = 67 MB
//   -> 20 us at 3.35 TB/s; so the least time is about 20 us and memory
//   bounds it, with the operations close behind.  The design reads each
//   q tile once and writes each o tile once and keeps S and P on chip,
//   so device-memory traffic stays near those 67 MB.  The K/V tiles that
//   the q tiles of one head share are re-read from L2, 151 MB of it at
//   this shape, each tile serving 128 query rows; that stream, not the
//   products, sets most of the kernel's time on the card (PERF.md).
#include <math.h>

#include "hopper.cuh"
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

// ------------------------------------ bf16 mma.sync path (d = 16 and 32)

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

// ------------------------------- bf16 wgmma path (d = 64 and 128, sm_90a)

namespace wg {

using namespace hopper;
using bf16 = __nv_bfloat16;
using mma_bf16::pack;

constexpr int BQ = 128;             // query rows a block: 2 warpgroups x 64
constexpr int BK = 128;             // keys a tile
constexpr int NTHREADS = 384;       // producer warpgroup, 2 consumer ones
constexpr int CONSUMER_WARPS = 8;   // arrivals that release a stage
constexpr float LN2 = 0.69314718055994531f;
// V's rows are keys, so as wgmma's B (keys x d) it is MN-major: read it
// transposed
constexpr int V_TRANS = 1;

template <int D>
struct Tile {
  static constexpr int BOXES = D / 64;  // 64-column (128-byte) boxes a row
  static constexpr int STAGES = D == 128 ? 3 : 4;  // K/V tiles in flight
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr uint32_t Q_BOX = BQ * 128;       // one box of Q
  static constexpr uint32_t KV_BOX = BK * 128;      // one box of K or V
  // Q, the K stages, the V stages, the barriers; and room to align the
  // base to 1024 bytes (the swizzle atom)
  static constexpr size_t smem_bytes() {
    return 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + (2 + 3 * STAGES) * 8;
  }
};

// SIGN * S = SIGN * Q K^T (64 rows of Q at qw, the K tile at
// kt), 16 deep a step; at d = 128 steps 4-7 read the second box.  A
// negative scale negates S through wgmma's scale-a (exact: it negates
// the bf16 products).  One committed group.
template <int D, int SIGN>
__device__ __forceinline__ void issue_qk(float (&sacc)[BK / 2],
                                         const unsigned char* qw,
                                         const unsigned char* kt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<SIGN>(
        sacc, desc_sw128(qw + (kk / 4) * Tile<D>::Q_BOX + off, 16, 1024),
        desc_sw128(kt + (kk / 4) * Tile<D>::KV_BOX + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V (P in registers, the V tile at vt), 16 keys a step: two
// 8-row groups of V 1024 bytes apart; at d = 128 the second 64 columns
// are the next box.  One committed group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         const unsigned char* vt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<V_TRANS>(oacc, pa[kk],
                      desc_sw128(vt + kk * 16 * 128, Tile<D>::KV_BOX, 1024));
  wgmma_commit();
}

// One tile's step of the online softmax in the log2 domain, in place:
// sacc holds t = sign(scale) * s (masked keys at -inf) and becomes
// p = 2^(t * |scale_log2| - m), one FFMA and one ex2 a score, with m the
// running max of t * |scale_log2| = s * scale_log2.  Returns in alpha
// the rescale of the rows' earlier sums.  A row's 4 threads are one
// quad.  Straight-line code: it runs while a wgmma is in flight.
__device__ __forceinline__ void softmax_step(float (&sacc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             float abs_scale) {
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * h], sacc[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row with every key of the tile masked keeps its max
    const float m_new = fmaxf(m[h], abs_scale * mx);
    alpha[h] = exp2_approx(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    sacc[i] = exp2_approx(fmaf(sacc[i], abs_scale, -m[(i / 2) & 1]));
    sum[(i / 2) & 1] += sacc[i];
  }
  // the running sum keeps the f32 probabilities; alpha is the same in
  // the whole quad, so the shares add up to the row's sum
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
}

// P rounded to bf16 (V's dtype): the accumulators of 8-key groups 2kk and
// 2kk+1 are the A fragment of the 16-key step kk of P V
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&sacc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
}

// The w-th work item: query tile n_qt - 1 - w % n_qt of head w / n_qt, so
// that the q tiles of a head run close together in time and re-read its
// K and V from L2 (heaviest first across all heads instead was 5% slower
// at the served shape, on an H100).  Block b takes items b, 2G - 1 - b,
// 2G + b, ... (G = gridDim.x): a zigzag that evens out the causal
// tiles' unequal work.
struct Item {
  int bh, q0, n_tiles;
  __device__ __forceinline__ Item(int w, int n_qt, int tk, int causal) {
    bh = w / n_qt;
    q0 = (n_qt - 1 - w % n_qt) * BQ;
    // causal: this q tile's last row sees keys up to q0 + BQ - 1
    const int k_end = causal ? min(tk, q0 + BQ) : tk;
    n_tiles = (k_end + BK - 1) / BK;
  }
};

__device__ __forceinline__ int item_of(int round, int n_items) {
  const int g = gridDim.x, b = blockIdx.x;
  const int w = round * g + (round % 2 == 0 ? b : g - 1 - b);
  return w < n_items ? w : -1;
}

// abs_scale = |sm_scale| * log2(e), SIGN = the sign of sm_scale, 1 or -1
// (the host makes a zero scale a tiny positive one).  A persistent kernel:
// one block an SM walks its work items (item_of), and the producer loads
// the next item's Q and K/V tiles while the consumers finish this one.
template <int D, int SIGN>
__global__ void __launch_bounds__(NTHREADS, 1)
    kernel(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
           float* __restrict__ lse, int n_bh, int tq, int tk,
           float abs_scale, int causal) {
  using T = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sk = sq + T::Q_BYTES;                // K stages
  unsigned char* sv = sk + T::STAGES * T::KV_BYTES;   // V stages
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sv + T::STAGES * T::KV_BYTES);
  uint64_t* empty_q = full_q + 1;
  uint64_t* full_k = empty_q + 1;
  uint64_t* full_v = full_k + T::STAGES;
  uint64_t* empty = full_v + T::STAGES;

  const int n_qt = (tq + BQ - 1) / BQ;
  const int n_items = n_bh * n_qt;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, CONSUMER_WARPS);
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Within an item, key tiles go from the last to the first: the last is
  // the only one that can reach past Tk or above the diagonal (BQ = BK,
  // so the diagonal tile is the last), so only the first tile processed
  // is masked, before anything is in flight.  Tiles are counted across
  // items (it): the it-th tile is in stage it % STAGES, on that stage's
  // barriers' (it / STAGES)-th phase.
  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA copy
    reg_dealloc<24>();
    if (tid == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      int it = 0;
      for (int r = 0;; ++r) {
        const int w = item_of(r, n_items);
        if (w < 0) break;
        const Item item(w, n_qt, tk, causal);
        // every consumer warp is done with the previous item's Q
        if (r > 0) mbar_wait(empty_q, (r - 1) & 1);
        mbar_arrive_expect_tx(full_q, T::Q_BYTES);
#pragma unroll
        for (int b = 0; b < T::BOXES; ++b)
          tma_load_3d(sq + b * T::Q_BOX, &tm_q, full_q, 64 * b, item.q0,
                      item.bh);
        for (int j = 0; j < item.n_tiles; ++j, ++it) {
          const int s = it % T::STAGES;
          const int k0 = (item.n_tiles - 1 - j) * BK;
          // every consumer warp released this stage's previous tile
          if (it >= T::STAGES) mbar_wait(&empty[s], (it / T::STAGES - 1) & 1);
          // the full box is counted, rows past Tk too (TMA writes zeros)
          mbar_arrive_expect_tx(&full_k[s], T::KV_BYTES);
#pragma unroll
          for (int b = 0; b < T::BOXES; ++b)
            tma_load_3d(sk + s * T::KV_BYTES + b * T::KV_BOX, &tm_k,
                        &full_k[s], 64 * b, k0, item.bh);
          mbar_arrive_expect_tx(&full_v[s], T::KV_BYTES);
#pragma unroll
          for (int b = 0; b < T::BOXES; ++b)
            tma_load_3d(sv + s * T::KV_BYTES + b * T::KV_BOX, &tm_v,
                        &full_v[s], 64 * b, k0, item.bh);
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 query rows of each item each
    reg_alloc<240>();
    // the warpgroup index, read from lane 0 so that the compiler sees
    // it uniform and keeps the wgmma descriptors in uniform registers
    const int cw = __shfl_sync(0xffffffffu, tid / 128, 0) - 1;
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const unsigned char* qw = sq + cw * 64 * 128;  // this warpgroup's Q rows
    int it = 0;
    for (int r = 0;; ++r) {
      const int w = item_of(r, n_items);
      if (w < 0) break;
      const Item item(w, n_qt, tk, causal);
      const int n_tiles = item.n_tiles;
      const int rbase = item.q0 + cw * 64 + warp * 16;  // this warp's 1st row
      const int row0 = rbase + g;  // this thread's rows: row0 and row0 + 8

      float oacc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
      float m[2] = {-1e30f, -1e30f};  // running max of s * scale_log2
      float l[2] = {0.f, 0.f};        // this thread's share of the row sums
      float alpha[2];
      float sacc[BK / 2];
      uint32_t pa[BK / 16][4];

      // the last key tile: S, its mask, the softmax, P
      mbar_wait(full_q, r & 1);
      mbar_wait(&full_k[it % T::STAGES], (it / T::STAGES) & 1);
      issue_qk<D, SIGN>(sacc, qw, sk + (it % T::STAGES) * T::KV_BYTES);
      wgmma_wait<0>();
      fence_regs(sacc);
      {
        // mask keys past Tk and, causal, above the diagonal, where this
        // warp's rows can meet either
        const int k0 = (n_tiles - 1) * BK;
        const bool edge = k0 + BK > tk || (causal && k0 + BK - 1 > rbase);
        if (edge) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int key = k0 + (i / 4) * 8 + 2 * c + (i & 1);
            const int row = row0 + 8 * ((i / 2) & 1);
            if (key >= tk || (causal && row < key)) sacc[i] = -INFINITY;
          }
        }
      }
      softmax_step(sacc, m, l, alpha, abs_scale);
      pack_p(pa, sacc);

      // Then, a tile a step: the previous tile's P V (it needs that
      // tile's P and this row max), then this tile's S and softmax.  Each
      // product is one batch of 8 wgmmas waited on at once.  The two
      // consumer warpgroups take turns to issue theirs (named barriers 1
      // and 2, warpgroup 0 first), so that one's softmax runs while the
      // other's products do; the arrivals on each barrier match its
      // syncs within an item.
      if (cw == 1 && n_tiles > 1) named_arrive(1, 256);
      for (int j = 1; j < n_tiles; ++j) {
        const int s = (it + j) % T::STAGES, sp = (it + j - 1) % T::STAGES;
        mbar_wait(&full_v[sp], ((it + j - 1) / T::STAGES) & 1);
        // O to tile j-1's running max before P V adds to it
#pragma unroll
        for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i / 2) & 1];
        named_sync(1 + cw, 256);  // this warpgroup's turn
        issue_pv<D>(oacc, pa, sv + sp * T::KV_BYTES);
        wgmma_wait<0>();
        fence_regs(oacc);
        // this warp is done with stage sp (its wgmmas retired)
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[sp]);
        mbar_wait(&full_k[s], ((it + j) / T::STAGES) & 1);
        issue_qk<D, SIGN>(sacc, qw, sk + s * T::KV_BYTES);
        // the other warpgroup's turn
        if (cw == 0 || j < n_tiles - 1) named_arrive(2 - cw, 256);
        wgmma_wait<0>();
        fence_regs(sacc);
        softmax_step(sacc, m, l, alpha, abs_scale);
        pack_p(pa, sacc);
      }
      // every S of the item is in: Q may be replaced by the next item's
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_q);

      // the first key tile's P V
      {
        const int sp = (it + n_tiles - 1) % T::STAGES;
        mbar_wait(&full_v[sp], ((it + n_tiles - 1) / T::STAGES) & 1);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i / 2) & 1];
        issue_pv<D>(oacc, pa, sv + sp * T::KV_BYTES);
        wgmma_wait<0>();
        fence_regs(oacc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[sp]);
      }
      it += n_tiles;

      bf16* ob = o + (size_t)item.bh * tq * D;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int row = row0 + 8 * h;
        if (row >= tq) continue;
        const float lc = fmaxf(l[h], 1e-30f);
        const float inv = 1.f / lc;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + 8 * j + 2 * c) =
              pack(oacc[4 * j + 2 * h] * inv, oacc[4 * j + 2 * h + 1] * inv);
        if (lse != nullptr && c == 0)
          lse[(size_t)item.bh * tq + row] = m[h] * LN2 + logf(lc);
      }
    }
  }
}

}  // namespace wg

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

template <int D, int SIGN>
cudaError_t run_wg(const Args& a, const CUtensorMap (&maps)[3],
                   float abs_scale) {
  const size_t smem = wg::Tile<D>::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      wg::kernel<D, SIGN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // one block an SM (the kernel is persistent), or one an item
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long items = (long long)a.bh * ((a.tq + wg::BQ - 1) / wg::BQ);
  const int grid = (int)(items < sms ? items : sms);
  wg::kernel<D, SIGN><<<grid, wg::NTHREADS, smem, a.stream>>>(
      maps[0], maps[1], maps[2], static_cast<wg::bf16*>(a.o),
      static_cast<float*>(a.lse), a.bh, a.tq, a.tk, abs_scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_wg(const Args& a) {
  CUtensorMap maps[3];
  if (!hopper::tensor_map(&maps[0], a.q, a.bh, a.tq, D, wg::BQ) ||
      !hopper::tensor_map(&maps[1], a.k, a.bh, a.tk, D, wg::BK) ||
      !hopper::tensor_map(&maps[2], a.v, a.bh, a.tk, D, wg::BK))
    return cudaErrorInvalidValue;
  // sm_scale * log2(e); a zero scale (every score 0) becomes a tiny one,
  // which gives the same uniform weights and keeps masked keys at 0
  float scale_log2 = a.sm_scale * 1.44269504088896341f;
  if (scale_log2 == 0.f) scale_log2 = 1e-30f;
  return scale_log2 < 0.f ? run_wg<D, -1>(a, maps, -scale_log2)
                          : run_wg<D, 1>(a, maps, scale_log2);
}

template <int D>
cudaError_t launch(int dtype, const Args& a) {
  if (dtype == 0)
    return run<float>(f32::kernel<D>, f32::NTHREADS,
                      f32::Tile<D>::smem_bytes(), a);
  if constexpr (D >= 64)
    return run_wg<D>(a);
  else
    return run<tc::bf16>(tc::kernel<D>, tc::NTHREADS,
                         tc::Tile<D>::smem_bytes(), a);
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
