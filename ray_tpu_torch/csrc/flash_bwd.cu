// Flash-attention backward for Hopper (sm_90a), CUDA C++ with a plain C ABI.
//
// Replaces ray_tpu/ops/pallas/flash.py:_dq_kernel and :_dkv_kernel (both
// launched by _flash_bwd_bhsd). With p recomputed from the forward's saved
// log-sum-exp, per (batch, q-head), query row i and key j:
//   s    = (q_i . k_j) * scale                fp32 sums, scale after the dot
//   p    = exp(s - lse_i) where j is visible to i and lse_i > NEG_INF / 2,
//          else 0 (keys >= sk masked; causal: j > i + q_offset[batch])
//   dp   = do_i . v_j
//   ds   = p * (dp - delta_i) * scale,        delta_i = sum_d o_i * do_i
//   dq_i = sum_j ds * k_j,  dk_j = sum_i ds * q_i,  dv_j = sum_i p * do_i
// GQA: dk and dv of a kv head sum over the hq / hkv query heads that read
// it.
//
// Two kernels, launched in this order on one stream, as JAX launches two:
// - flash_bwd_dq_kernel writes dq and delta = rowsum(o * do) (JAX takes
//   delta outside the kernels, flash.py:221; here it rides along with the
//   do rows the dq kernel reads anyway);
// - flash_bwd_dkv_kernel reads delta and writes dk and dv, summed over the
//   GQA group in registers: no atomics, and the result does not depend on
//   scheduling (two launches give the same bits).
// Both recompute s and dp: 14 * d FLOPs per visible (query, key) pair and
// q head (dq 6d, dkv 8d) against the function's 10 * d. That is the price
// of determinism without a dq scratch of atomics.
//
// The code dispatches on dtype:
// - bfloat16 (namespace tcb): tensor-core kernels, below.
// - float32 (namespace simt): the fp32 CUDA-core kernels, held to 1e-4 of
//   the plain version; a bf16 call never reaches them.
//
// What bounds it on an H100: at training lengths the FLOPs. At s = 2048
// the backward does hundreds of FLOPs per byte it must move, far above the
// 295 FLOP/byte ridge of bf16, so the products belong on the tensor cores
// (989 TFLOP/s bf16 dense, against 67 TFLOP/s on the fp32 CUDA cores).
// What the bf16 design does about it:
// - All five products (s, dp, dq, dk, dv) are mma.sync.m16n8k16 with bf16
//   operands and fp32 sums. s and dp multiply the bf16 inputs exactly and
//   sum in fp32, as JAX's preferred_element_type=f32 does. p and ds are
//   formed in fp32 (ds's cancellation dp - delta happens before any
//   rounding) and rounded to bf16 only as the A operand of the three second
//   products, as the forward rounds p before PV (flash.py:83).
// - Block tiles shared by all warps, each warp owning 16 rows:
//   dq: one block per (batch * q-head, 64 query rows), 4 warps. K/V tiles
//   of 64 keys stream up to the rows' causal diagonal; the last query
//   tiles, which see the most keys, are launched first.
//   dkv: one block per (batch * kv-head, 64 keys), 4 warps. K and V stay
//   resident while Q/dO tiles (64 queries, 32 at d 128) of every q head of
//   the group stream from the first query that sees the block's keys
//   (k0 - q_offset). s^T = K Q^T and dp^T = V dO^T put the keys in the M
//   rows, so p^T and ds^T leave the accumulators already in the A layout
//   of dv += p^T dO and dk += ds^T Q; in the dq kernel ds feeds dq += ds K
//   the same way. No product's operand makes a trip through shared memory.
// - Operands come from shared tiles by ldmatrix (.trans where the product
//   needs the transposed tile, K for dq and Q/dO for dk/dv), the 16-byte
//   chunks of each row swizzled so that neither form has bank conflicts
//   (tensor_core.cuh).
// - The streamed tiles are double-buffered with cp.async (16 bytes a
//   thread): tile t + 1 loads while tile t computes. lse and delta of each
//   query tile ride along in shared memory.
// - Causal work per dkv block falls linearly with its key index; the grid
//   is (batch * kv-head, key tile), so the heaviest (first) key tiles are
//   dispatched first and the light ones fill the tail.
// - Tiles wholly above the diagonal are never visited. Ragged edges,
//   per-row offsets and dead rows are masked per element only in a tile
//   that an edge cuts for the warp's rows; a tile the warp sees whole
//   skips the masks (p = 2**x on the special-function unit).
// Inputs are read in place through their [b, s, h, d] strides (rows
// 16-byte aligned); dq, dk, dv are written contiguous. Registers hold the
// dk/dv accumulators (at d 128, 128 floats a lane); ptxas must report no
// spills (chip_smoke.py checks).

#include <type_traits>

#include "flash_common.cuh"
#include "tensor_core.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // [b, hq, sq] contiguous
  float* delta;        // [b, hq, sq] contiguous: dq kernel writes, dkv reads
  void* dq;            // [b, sq, hq, d] contiguous, q's dtype
  void* dk;            // [b, sk, hkv, d] contiguous, k's dtype
  void* dv;            // [b, sk, hkv, d] contiguous, v's dtype
  const int* qoff;     // [b] int32
  int b, sq, sk, hq, hkv;
  long long q_sb, q_ss, q_sh;   // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  float scale;
  int causal;
};

// ---------------------------------------------------------------- fp32
// CUDA-core kernels, taken only for float32 inputs.
namespace simt {

using rtt::NEG_INF;
using rtt::warp_sum;
using T = float;
using Elem = rtt::Elem<float>;

constexpr int WARPS = 4;
constexpr int ROWS = 4;            // per warp: query rows (dq), keys (dkv)
constexpr int BR = WARPS * ROWS;   // per block: query rows (dq), keys (dkv)
constexpr int BT = 32;             // streamed tile: keys (dq), queries (dkv)

template <int D>
struct Shape {
  static constexpr int PW = Elem::PER_WORD;
  static constexpr int WPR = D / PW;                       // words per row
  static constexpr int KS = (WPR % 2) ? WPR : WPR + 1;     // odd: no bank conflicts
  static constexpr int CPR = WPR / 4;                      // 16-byte chunks per row
  static constexpr int PER_LANE = BT * CPR / 32;           // chunks per lane per tile
  static constexpr int UNR = PER_LANE < 4 ? PER_LANE : 4;
  static constexpr int NWV = (WPR + 31) / 32;              // row words per lane
  static constexpr int TILE_WORDS = BT * KS;               // one streamed tile
  static constexpr int ROW_WORDS = ROWS * D;               // the warp's fp32 rows
  static constexpr int XCH_WORDS = 2 * BT * ROWS;          // p and ds, per lane
  static constexpr int WARP_WORDS = 2 * TILE_WORDS + 2 * ROW_WORDS + XCH_WORDS;
  static constexpr int BYTES = WARPS * WARP_WORDS * 4;
  static_assert(WPR % 4 == 0, "head_dim must fill whole 16-byte chunks");
  static_assert(PER_LANE % UNR == 0, "chunk unroll must divide the tile");
  static_assert(TILE_WORDS % 4 == 0 && WARP_WORDS % 4 == 0, "16-byte tiles");
  static_assert(ROWS == 4, "a float4 holds one column of the warp's rows");
};

// Rows [base, base + BT) of two matrices (row strides in elements) into two
// warp-private tiles of row stride KS; rows at or past `limit` read as 0.
template <int D>
__device__ __forceinline__ void stage_pair(
    uint32_t* ta, uint32_t* tb, const T* a, long long a_rs, const T* b,
    long long b_rs, int base, int limit, int lane) {
  using S = Shape<D>;
  constexpr int CPR = S::CPR, KS = S::KS;
#pragma unroll
  for (int c0 = 0; c0 < S::PER_LANE; c0 += S::UNR) {
    uint4 ra[S::UNR], rb[S::UNR];
#pragma unroll
    for (int u = 0; u < S::UNR; ++u) {
      const int c = (c0 + u) * 32 + lane;
      const int j = c / CPR, cw = c % CPR;
      const int row = base + j;
      ra[u] = make_uint4(0, 0, 0, 0);
      rb[u] = make_uint4(0, 0, 0, 0);
      if (row < limit) {
        ra[u] = __ldg(reinterpret_cast<const uint4*>(a + row * a_rs) + cw);
        rb[u] = __ldg(reinterpret_cast<const uint4*>(b + row * b_rs) + cw);
      }
    }
#pragma unroll
    for (int u = 0; u < S::UNR; ++u) {
      const int c = (c0 + u) * 32 + lane;
      const int j = c / CPR, cw = c % CPR;
      uint32_t* da = ta + j * KS + cw * 4;
      uint32_t* db = tb + j * KS + cw * 4;
      da[0] = ra[u].x; da[1] = ra[u].y; da[2] = ra[u].z; da[3] = ra[u].w;
      db[0] = rb[u].x; db[1] = rb[u].y; db[2] = rb[u].z; db[3] = rb[u].w;
    }
  }
}

// Rows [0, ROWS) of a (n valid rows) unpacked to fp32 column-major: element
// (r, c) at dst[c * ROWS + r], so one float4 holds a column of all rows.
// Rows past n are zeros. Lane owns words lane, lane + 32, ...
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const T* a,
                                          long long a_rs, int n, int lane) {
  using S = Shape<D>;
  constexpr int PW = S::PW, WPR = S::WPR;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    for (int w = lane; w < WPR; w += 32) {
      uint32_t word = 0;
      if (r < n)
        word = __ldg(reinterpret_cast<const uint32_t*>(a + r * a_rs) + w);
      float x[PW];
      Elem::unpack(word, x);
#pragma unroll
      for (int e = 0; e < PW; ++e) dst[(w * PW + e) * ROWS + r] = x[e];
    }
  }
}

// acc[ROWS][NWV * PW] (fp32) rounded to T and written as rows of a
// contiguous [*, D] matrix, row r at out + r * row_stride.
template <int D>
__device__ __forceinline__ void store_rows(
    void* out, long long row_stride, int n,
    const float (&acc)[ROWS][Shape<D>::NWV * Shape<D>::PW], int lane) {
  using S = Shape<D>;
  constexpr int PW = S::PW, WPR = S::WPR, NWV = S::NWV;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= n) break;
    uint32_t* row = reinterpret_cast<uint32_t*>(static_cast<T*>(out) +
                                                r * row_stride);
#pragma unroll
    for (int i = 0; i < NWV; ++i) {
      const int w = lane + 32 * i;
      if (w < WPR) row[w] = Elem::pack(&acc[r][i * PW]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_kernel(const Params p) {
  using S = Shape<D>;
  constexpr int PW = S::PW, WPR = S::WPR, KS = S::KS, NWV = S::NWV;
  extern __shared__ __align__(16) uint32_t smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int bi = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int r0 = blockIdx.y * BR + warp * ROWS;
  const int nr = min(ROWS, p.sq - r0);
  if (nr <= 0) return;   // no block barrier in this kernel
  const int off = p.qoff[bi];

  uint32_t* kt = smem + warp * S::WARP_WORDS;
  uint32_t* vt = kt + S::TILE_WORDS;
  float* qs = reinterpret_cast<float*>(vt + S::TILE_WORDS);
  float* dos = qs + S::ROW_WORDS;
  float4* xds = reinterpret_cast<float4*>(dos + S::ROW_WORDS);   // [BT]

  const long long rbase_q = (long long)bi * p.q_sb + (long long)r0 * p.q_ss +
                            (long long)h * p.q_sh;
  const T* qb = static_cast<const T*>(p.q) + rbase_q;
  const T* dob = static_cast<const T*>(p.dout) + (long long)bi * p.do_sb +
                 (long long)r0 * p.do_ss + (long long)h * p.do_sh;
  const T* ob = static_cast<const T*>(p.o) + (long long)bi * p.o_sb +
                (long long)r0 * p.o_ss + (long long)h * p.o_sh;
  const T* kb = static_cast<const T*>(p.k) + (long long)bi * p.k_sb +
                (long long)hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + (long long)bi * p.v_sb +
                (long long)hk * p.v_sh;

  load_rows<D>(qs, qb, p.q_ss, nr, lane);
  load_rows<D>(dos, dob, p.do_ss, nr, lane);
  __syncwarp();

  // delta = rowsum(o * do): o as stored, widened to fp32
  const long long row_lse = ((long long)bi * p.hq + h) * p.sq + r0;
  float lse[ROWS], delta[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float part = 0.f;
    if (r < nr) {
      for (int w = lane; w < WPR; w += 32) {
        float x[PW];
        Elem::unpack(__ldg(reinterpret_cast<const uint32_t*>(
                            ob + r * p.o_ss) + w), x);
#pragma unroll
        for (int e = 0; e < PW; ++e) part += x[e] * dos[(w * PW + e) * ROWS + r];
      }
    }
    delta[r] = warp_sum(part);
    lse[r] = r < nr ? p.lse[row_lse + r] : NEG_INF;
    if (lane == 0 && r < nr) p.delta[row_lse + r] = delta[r];
  }

  // keys these rows can see: [0, kend)
  int kend = p.sk;
  if (p.causal) kend = min(kend, r0 + nr + off);
  kend = max(kend, 0);
  const int ntiles = (kend + BT - 1) / BT;

  float acc[ROWS][NWV * PW];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int i = 0; i < NWV * PW; ++i) acc[r][i] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int kbase = t * BT;
    stage_pair<D>(kt, vt, kb, p.k_ss, vb, p.v_ss, kbase, kend, lane);
    __syncwarp();

    // s and dp for key (kbase + lane), all rows of the warp
    float s[ROWS], dp[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = dp[r] = 0.f;
    const uint32_t* krow = kt + lane * KS;
    const uint32_t* vrow = vt + lane * KS;
#pragma unroll 4
    for (int w = 0; w < WPR; ++w) {
      float kx[PW], vx[PW];
      Elem::unpack(krow[w], kx);
      Elem::unpack(vrow[w], vx);
#pragma unroll
      for (int e = 0; e < PW; ++e) {
        const float4 qc = reinterpret_cast<const float4*>(qs)[w * PW + e];
        const float4 dc = reinterpret_cast<const float4*>(dos)[w * PW + e];
        s[0] = fmaf(qc.x, kx[e], s[0]); s[1] = fmaf(qc.y, kx[e], s[1]);
        s[2] = fmaf(qc.z, kx[e], s[2]); s[3] = fmaf(qc.w, kx[e], s[3]);
        dp[0] = fmaf(dc.x, vx[e], dp[0]); dp[1] = fmaf(dc.y, vx[e], dp[1]);
        dp[2] = fmaf(dc.z, vx[e], dp[2]); dp[3] = fmaf(dc.w, vx[e], dp[3]);
      }
    }

    const int key = kbase + lane;
    float ds[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      bool ok = (r < nr) && (key < kend) && (lse[r] > NEG_INF / 2);
      if (p.causal) ok = ok && (r0 + r + off >= key);
      const float pr = ok ? expf(s[r] * p.scale - lse[r]) : 0.f;
      ds[r] = pr * (dp[r] - delta[r]) * p.scale;
    }
    xds[lane] = make_float4(ds[0], ds[1], ds[2], ds[3]);
    __syncwarp();

    // dq += ds K: lane owns head-dim words lane, lane + 32, ...
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      const float4 d4 = xds[j];
      const float dj[ROWS] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int i = 0; i < NWV; ++i) {
        const int w = lane + 32 * i;
        if (w < WPR) {
          float kx[PW];
          Elem::unpack(kt[j * KS + w], kx);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
#pragma unroll
            for (int e = 0; e < PW; ++e)
              acc[r][i * PW + e] = fmaf(dj[r], kx[e], acc[r][i * PW + e]);
          }
        }
      }
    }
    __syncwarp();
  }

  store_rows<D>(static_cast<T*>(p.dq) +
                       (((long long)bi * p.sq + r0) * p.hq + h) * D,
                   (long long)p.hq * D, nr, acc, lane);
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkv_kernel(const Params p) {
  using S = Shape<D>;
  constexpr int PW = S::PW, WPR = S::WPR, KS = S::KS, NWV = S::NWV;
  extern __shared__ __align__(16) uint32_t smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bhk = blockIdx.x;
  const int bi = bhk / p.hkv, hk = bhk % p.hkv;
  const int group = p.hq / p.hkv;
  const int k0 = blockIdx.y * BR + warp * ROWS;
  const int nk = min(ROWS, p.sk - k0);
  if (nk <= 0) return;   // no block barrier in this kernel
  const int off = p.qoff[bi];

  uint32_t* qt = smem + warp * S::WARP_WORDS;
  uint32_t* dt = qt + S::TILE_WORDS;
  float* ks = reinterpret_cast<float*>(dt + S::TILE_WORDS);
  float* vs = ks + S::ROW_WORDS;
  float4* xp = reinterpret_cast<float4*>(vs + S::ROW_WORDS);   // [BT]
  float4* xds = xp + BT;                                        // [BT]

  load_rows<D>(ks, static_cast<const T*>(p.k) + (long long)bi * p.k_sb +
                          (long long)k0 * p.k_ss + (long long)hk * p.k_sh,
                  p.k_ss, nk, lane);
  load_rows<D>(vs, static_cast<const T*>(p.v) + (long long)bi * p.v_sb +
                          (long long)k0 * p.v_ss + (long long)hk * p.v_sh,
                  p.v_ss, nk, lane);
  __syncwarp();

  // the first query that sees key k0; every query before it sees none of
  // this warp's keys, so those tiles are never visited
  const int qstart = p.causal ? max(0, k0 - off) : 0;
  const int ntiles = (max(p.sq - qstart, 0) + BT - 1) / BT;

  float acc_k[ROWS][NWV * PW], acc_v[ROWS][NWV * PW];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int i = 0; i < NWV * PW; ++i) acc_k[r][i] = acc_v[r][i] = 0.f;
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = static_cast<const T*>(p.q) + (long long)bi * p.q_sb +
                  (long long)h * p.q_sh;
    const T* dob = static_cast<const T*>(p.dout) + (long long)bi * p.do_sb +
                   (long long)h * p.do_sh;
    const long long row0 = ((long long)bi * p.hq + h) * p.sq;

    for (int t = 0; t < ntiles; ++t) {
      const int qbase = qstart + t * BT;
      stage_pair<D>(qt, dt, qb, p.q_ss, dob, p.do_ss, qbase, p.sq, lane);
      const int qi = qbase + lane;
      const bool valid = qi < p.sq;
      const float lse = valid ? p.lse[row0 + qi] : NEG_INF;
      const float delta = valid ? p.delta[row0 + qi] : 0.f;
      __syncwarp();

      // s and dp for query (qbase + lane), all keys of the warp
      float s[ROWS], dp[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = dp[r] = 0.f;
      const uint32_t* qrow = qt + lane * KS;
      const uint32_t* drow = dt + lane * KS;
#pragma unroll 4
      for (int w = 0; w < WPR; ++w) {
        float qx[PW], dx[PW];
        Elem::unpack(qrow[w], qx);
        Elem::unpack(drow[w], dx);
#pragma unroll
        for (int e = 0; e < PW; ++e) {
          const float4 kc = reinterpret_cast<const float4*>(ks)[w * PW + e];
          const float4 vc = reinterpret_cast<const float4*>(vs)[w * PW + e];
          s[0] = fmaf(kc.x, qx[e], s[0]); s[1] = fmaf(kc.y, qx[e], s[1]);
          s[2] = fmaf(kc.z, qx[e], s[2]); s[3] = fmaf(kc.w, qx[e], s[3]);
          dp[0] = fmaf(vc.x, dx[e], dp[0]); dp[1] = fmaf(vc.y, dx[e], dp[1]);
          dp[2] = fmaf(vc.z, dx[e], dp[2]); dp[3] = fmaf(vc.w, dx[e], dp[3]);
        }
      }

      float pr[ROWS], ds[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        bool ok = valid && (r < nk) && (lse > NEG_INF / 2);
        if (p.causal) ok = ok && (qi + off >= k0 + r);
        pr[r] = ok ? expf(s[r] * p.scale - lse) : 0.f;
        ds[r] = pr[r] * (dp[r] - delta) * p.scale;
      }
      xp[lane] = make_float4(pr[0], pr[1], pr[2], pr[3]);
      xds[lane] = make_float4(ds[0], ds[1], ds[2], ds[3]);
      __syncwarp();

      // dv += p^T dO, dk += ds^T Q: lane owns head-dim words lane, +32, ...
#pragma unroll 2
      for (int j = 0; j < BT; ++j) {
        const float4 p4 = xp[j], d4 = xds[j];
        const float pj[ROWS] = {p4.x, p4.y, p4.z, p4.w};
        const float dj[ROWS] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int i = 0; i < NWV; ++i) {
          const int w = lane + 32 * i;
          if (w < WPR) {
            float qx[PW], dx[PW];
            Elem::unpack(qt[j * KS + w], qx);
            Elem::unpack(dt[j * KS + w], dx);
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
#pragma unroll
              for (int e = 0; e < PW; ++e) {
                acc_v[r][i * PW + e] = fmaf(pj[r], dx[e], acc_v[r][i * PW + e]);
                acc_k[r][i * PW + e] = fmaf(dj[r], qx[e], acc_k[r][i * PW + e]);
              }
            }
          }
        }
      }
      __syncwarp();
    }
  }

  const long long out0 = (((long long)bi * p.sk + k0) * p.hkv + hk) * D;
  store_rows<D>(static_cast<T*>(p.dk) + out0, (long long)p.hkv * D, nk,
                   acc_k, lane);
  store_rows<D>(static_cast<T*>(p.dv) + out0, (long long)p.hkv * D, nk,
                   acc_v, lane);
}

// Launch one kernel (which: 0 = dq, 1 = dkv), or with `config` fill it as
// rtt_flash_bwd_config describes instead.
template <int D>
cudaError_t run(int which, const Params* p, int* config, cudaStream_t stream) {
  using S = Shape<D>;
  static bool opted[2][64] = {};
  const auto kernel = which == 0 ? flash_bwd_dq_kernel<D>
                                 : flash_bwd_dkv_kernel<D>;
  const cudaError_t err = rtt::opt_in_smem(kernel, S::BYTES, opted[which]);
  if (err != cudaSuccess) return err;
  if (config) {
    config[0] = BR;
    config[1] = BT;
    config[2] = WARPS * 32;
    config[3] = S::BYTES;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &config[4], kernel, WARPS * 32, S::BYTES);
  }
  const dim3 grid(which == 0 ? p->b * p->hq : p->b * p->hkv,
                  ((which == 0 ? p->sq : p->sk) + BR - 1) / BR);
  kernel<<<grid, WARPS * 32, S::BYTES, stream>>>(*p);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------- bf16
// Tensor-core kernels: every product is mma.sync m16n8k16 (bf16 in, fp32
// sums) on operands that ldmatrix reads from swizzled shared tiles.
namespace tcb {

using namespace rtt::tc;
using BF = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

// Tile sizes by head_dim (each warp owns 16 rows of its block):
// - dq kernel: DQ_ROWS query rows per block, K/V streamed DQ_KEYS keys at
//   a time;
// - dkv kernel: DKV_KEYS keys per block (K and V resident), Q/dO streamed
//   DKV_QUERIES queries at a time. At d 128 the dk + dv accumulators of a
//   warp are 128 floats a lane, so the streamed tile is halved to keep
//   s^T and dp^T (BM / 2 floats a lane each) within the register file.
// Chosen on an H100 with ray_tpu_torch/tools/tune_flash_bwd.py: 128-row
// dq blocks and 128-key dkv blocks (8 warps) were slower at the 1b train
// shape, fewer registers per thread for more resident blocks spilled or
// lost more than they gained, and 64-query tiles at d 128 spill.
template <int D>
struct Cfg {
  static constexpr int DQ_ROWS = 64;
  static constexpr int DQ_KEYS = 64;
  static constexpr int DKV_KEYS = 64;
  static constexpr int DKV_QUERIES = D >= 128 ? 32 : 64;

  static constexpr int DQ_THREADS = DQ_ROWS / 16 * 32;
  static constexpr int DKV_THREADS = DKV_KEYS / 16 * 32;
  // dynamic shared memory: Q and dO tiles, two K/V stages, delta
  static constexpr int DQ_BYTES = 2 * DQ_ROWS * D * 2 + 4 * DQ_KEYS * D * 2 +
                                  DQ_ROWS * 4;
  // K and V tiles, two Q/dO stages, two lse/delta stages
  static constexpr int DKV_BYTES = 2 * DKV_KEYS * D * 2 +
                                   4 * DKV_QUERIES * D * 2 +
                                   4 * DKV_QUERIES * 4;
};

// 2**x on the special-function unit; results below 2**-126 flush to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float dot8_bf16(uint4 a, uint4 b) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(wa[i] << 16), __uint_as_float(wb[i] << 16), acc);
    acc = fmaf(__uint_as_float(wa[i] & 0xffff0000u),
               __uint_as_float(wb[i] & 0xffff0000u), acc);
  }
  return acc;
}

// rows [0, 16) of the warp's slice, as (row g, g + 8) x (two columns per
// n8 tile): acc[nt][2j], acc[nt][2j + 1] is (row g + 8j, cols nt*8 + 2t,
// +1). Row r is written at out + r * row_stride when r < n.
template <int D>
__device__ __forceinline__ void store_acc(BF* out, long long row_stride,
                                          int n, const float (&acc)[D / 8][4],
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = g + 8 * j;
    if (r >= n) continue;
    uint32_t* row = reinterpret_cast<uint32_t*>(out + r * row_stride);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      row[(nt * 8 + 2 * t) / 2] = pack_bf16(acc[nt][2 * j], acc[nt][2 * j + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::DQ_THREADS)
flash_bwd_dq_kernel(const Params p) {
  using C = Cfg<D>;
  using TL = Tile<D>;
  constexpr int BM = C::DQ_ROWS, BN = C::DQ_KEYS, THREADS = C::DQ_THREADS;
  constexpr int CH = TL::CHUNKS;
  constexpr int Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int bi = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  // the last query tiles see the most keys: they are launched first
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int nrows = min(BM, p.sq - m0);
  const int off = p.qoff[bi];

  const uint32_t sQ = smem_addr(smem), sdO = sQ + Q_BYTES;
  const uint32_t sKV = sdO + Q_BYTES;   // stage s: K at + 2s KV_BYTES, V after
  float* sdelta = reinterpret_cast<float*>(smem + 2 * Q_BYTES + 4 * KV_BYTES);

  const BF* qb = static_cast<const BF*>(p.q) + bi * p.q_sb +
                 (long long)m0 * p.q_ss + h * p.q_sh;
  const BF* dob = static_cast<const BF*>(p.dout) + bi * p.do_sb +
                  (long long)m0 * p.do_ss + h * p.do_sh;
  const BF* ob = static_cast<const BF*>(p.o) + bi * p.o_sb +
                 (long long)m0 * p.o_ss + h * p.o_sh;
  const BF* kb = static_cast<const BF*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const BF* vb = static_cast<const BF*>(p.v) + bi * p.v_sb + hk * p.v_sh;

  // keys these rows can see: [0, kend)
  int kend = p.sk;
  if (p.causal) kend = min(kend, m0 + nrows + off);
  kend = max(kend, 0);
  const int ntiles = (kend + BN - 1) / BN;

  auto load_kv = [&](int tile) {
    const uint32_t stage = sKV + (tile & 1) * 2 * KV_BYTES;
    const int k0 = tile * BN;
    load_tile_async<D, BN, THREADS>(stage, kb + (long long)k0 * p.k_ss, p.k_ss,
                                    kend - k0, tid);
    load_tile_async<D, BN, THREADS>(stage + KV_BYTES, vb + (long long)k0 * p.v_ss,
                                    p.v_ss, kend - k0, tid);
  };

  load_tile_async<D, BM, THREADS>(sQ, qb, p.q_ss, nrows, tid);
  load_tile_async<D, BM, THREADS>(sdO, dob, p.do_ss, nrows, tid);
  cp_async_commit();
  if (ntiles > 0) load_kv(0);
  cp_async_commit();
  cp_async_wait<1>();   // Q and dO have landed (this thread's copies)
  __syncthreads();      // ... and every other thread's

  // delta = rowsum(o * do) for the warp's 16 rows: o as stored, do from
  // its shared tile; written out for the dkv kernel
  const long long row_lse = ((long long)bi * p.hq + h) * p.sq + m0;
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int idx = i * 32 + lane;
    const int r = warp * 16 + idx / CH, c = idx % CH;
    float part = 0.f;
    if (r < nrows) {
      const uint4 ov = __ldg(reinterpret_cast<const uint4*>(ob + r * p.o_ss) + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(
          smem + (TL::addr(sdO, r, c) - sQ));
      part = dot8_bf16(ov, dv);
    }
#pragma unroll
    for (int o = CH / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(rtt::FULL, part, o);
    if (c == 0) {
      sdelta[r] = part;
      if (r < nrows) p.delta[row_lse + r] = part;
    }
  }
  __syncwarp();

  // this lane's two rows: g and g + 8 of the warp's 16
  const int row0 = m0 + warp * 16 + g;
  float lse2[2], delta2[2];
  bool live[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = warp * 16 + g + 8 * j;
    const float l = r < nrows ? p.lse[row_lse + r] : rtt::NEG_INF;
    live[j] = r < nrows && l > rtt::NEG_INF / 2;
    lse2[j] = l * LOG2E;
    delta2[j] = sdelta[r];
  }
  const float scale_log2 = p.scale * LOG2E;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // ldmatrix row/chunk of this lane: A operands (16 rows x 16 columns),
  // B operands for two n8 tiles (non-transposed and transposed)
  const int a_row = warp * 16 + (lane & 15), a_chunk = lane >> 4;
  const int b_row = ((lane >> 4) << 3) + (lane & 7), b_chunk = (lane >> 3) & 1;
  const int bt_row = (((lane >> 3) & 1) << 3) + (lane & 7), bt_chunk = lane >> 4;

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) load_kv(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();   // this tile's K/V; the next may still be in flight
    __syncthreads();
    const uint32_t sK = sKV + (tile & 1) * 2 * KV_BYTES, sV = sK + KV_BYTES;
    const int kbase = tile * BN;

    // s = Q K^T and dp = dO V^T: 16 rows x BN keys per warp
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t aq[4], ado[4];
      ldmatrix_x4(aq, TL::addr(sQ, a_row, 2 * kc + a_chunk));
      ldmatrix_x4(ado, TL::addr(sdO, a_row, 2 * kc + a_chunk));
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, TL::addr(sK, 16 * np + b_row, 2 * kc + b_chunk));
        ldmatrix_x4(bv, TL::addr(sV, 16 * np + b_row, 2 * kc + b_chunk));
        mma_bf16(s[2 * np], aq, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * np], ado, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ado, bv[2], bv[3]);
      }
    }

    // p from the saved lse, ds = p (dp - delta) scale, both fp32; ds
    // overwrites s. Masks apply only where the tile is not visible whole to
    // all of the warp's rows (which then are all live).
    auto p_ds = [&](auto masked) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e >> 1;
          float pr = exp2_approx(fmaf(s[nt][e], scale_log2, -lse2[j]));
          if constexpr (decltype(masked)::value) {
            const int key = kbase + nt * 8 + 2 * t + (e & 1);
            bool ok = live[j] && key < kend;
            if (p.causal) ok = ok && key <= row0 + 8 * j + off;
            pr = ok ? pr : 0.f;
          }
          s[nt][e] = pr * (dp[nt][e] - delta2[j]) * p.scale;
        }
      }
    };
    const bool whole = warp * 16 + 16 <= nrows && kbase + BN <= p.sk &&
                       (!p.causal || kbase + BN - 1 <= m0 + warp * 16 + off);
    if (whole) p_ds(std::false_type{});
    else p_ds(std::true_type{});

    // dq += ds K: ds (bf16) is the A operand straight from registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, TL::addr(sK, 16 * kk + bt_row, 2 * np + bt_chunk));
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before reuse
  }

  store_acc<D>(static_cast<BF*>(p.dq) +
                   (((long long)bi * p.sq + m0 + warp * 16) * p.hq + h) * D,
               (long long)p.hq * D, nrows - warp * 16, acc, lane);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::DKV_THREADS)
flash_bwd_dkv_kernel(const Params p) {
  using C = Cfg<D>;
  using TL = Tile<D>;
  constexpr int BN = C::DKV_KEYS, BM = C::DKV_QUERIES;
  constexpr int THREADS = C::DKV_THREADS;
  constexpr int KV_BYTES = BN * D * 2, Q_BYTES = BM * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bhk = blockIdx.x;
  const int bi = bhk / p.hkv, hk = bhk % p.hkv;
  const int group = p.hq / p.hkv;
  // the first key tiles are seen by the most queries: natural order
  // already launches the heaviest blocks first
  const int k0 = blockIdx.y * BN;
  const int nkeys = min(BN, p.sk - k0);
  const int off = p.qoff[bi];

  const uint32_t sK = smem_addr(smem), sV = sK + KV_BYTES;
  const uint32_t sQ0 = sV + KV_BYTES;   // stage s: Q at + 2s Q_BYTES, dO after
  float* srow = reinterpret_cast<float*>(smem + 2 * KV_BYTES + 4 * Q_BYTES);
  const uint32_t srow_addr = smem_addr(srow);   // stage s: lse, delta [BM] each

  // the first query that sees key k0; every query before it sees none of
  // this block's keys, so those tiles are never visited
  const int qstart = p.causal ? max(0, k0 - off) : 0;
  const int ntq = (max(p.sq - qstart, 0) + BM - 1) / BM;
  const int nit = group * ntq;   // (q head of the group, query tile)

  load_tile_async<D, BN, THREADS>(
      sK, static_cast<const BF*>(p.k) + bi * p.k_sb + (long long)k0 * p.k_ss +
              hk * p.k_sh, p.k_ss, nkeys, tid);
  load_tile_async<D, BN, THREADS>(
      sV, static_cast<const BF*>(p.v) + bi * p.v_sb + (long long)k0 * p.v_ss +
              hk * p.v_sh, p.v_ss, nkeys, tid);
  cp_async_commit();

  auto load_q = [&](int it) {
    const int h = hk * group + it / ntq;
    const int qbase = qstart + (it % ntq) * BM;
    const int st = it & 1;
    const uint32_t stage = sQ0 + st * 2 * Q_BYTES;
    load_tile_async<D, BM, THREADS>(
        stage, static_cast<const BF*>(p.q) + bi * p.q_sb +
                (long long)qbase * p.q_ss + h * p.q_sh, p.q_ss, p.sq - qbase, tid);
    load_tile_async<D, BM, THREADS>(
        stage + Q_BYTES, static_cast<const BF*>(p.dout) + bi * p.do_sb +
                          (long long)qbase * p.do_ss + h * p.do_sh,
        p.do_ss, p.sq - qbase, tid);
    const long long row = ((long long)bi * p.hq + h) * p.sq + qbase;
    for (int i = tid; i < 2 * BM; i += THREADS) {
      const int q = i % BM;
      const float* src = (i < BM ? p.lse : p.delta) + row + q;
      cp_async_4(srow_addr + (st * 2 * BM + i) * 4,
                 qbase + q < p.sq ? src : p.lse, qbase + q < p.sq);
    }
  };

  if (nit > 0) load_q(0);
  cp_async_commit();

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  const int key0 = k0 + warp * 16 + g;   // this lane's keys: key0, key0 + 8
  const float scale_log2 = p.scale * LOG2E;
  const int a_row = warp * 16 + (lane & 15), a_chunk = lane >> 4;
  const int b_row = ((lane >> 4) << 3) + (lane & 7), b_chunk = (lane >> 3) & 1;
  const int bt_row = (((lane >> 3) & 1) << 3) + (lane & 7), bt_chunk = lane >> 4;

  for (int it = 0; it < nit; ++it) {
    if (it + 1 < nit) load_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();   // K, V and this stage; the next may be in flight
    __syncthreads();
    const int st = it & 1;
    const int qbase = qstart + (it % ntq) * BM;
    const uint32_t sQ = sQ0 + st * 2 * Q_BYTES, sdO = sQ + Q_BYTES;
    const float* slse = srow + st * 2 * BM;
    const float* sdelta = slse + BM;

    // s^T = K Q^T and dp^T = V dO^T: keys are the M rows, so p^T and ds^T
    // come out in the A layout of the dv and dk products
    float s[BM / 8][4], dp[BM / 8][4];
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ak[4], av[4];
      ldmatrix_x4(ak, TL::addr(sK, a_row, 2 * kc + a_chunk));
      ldmatrix_x4(av, TL::addr(sV, a_row, 2 * kc + a_chunk));
#pragma unroll
      for (int np = 0; np < BM / 16; ++np) {
        uint32_t bq[4], bd[4];
        ldmatrix_x4(bq, TL::addr(sQ, 16 * np + b_row, 2 * kc + b_chunk));
        ldmatrix_x4(bd, TL::addr(sdO, 16 * np + b_row, 2 * kc + b_chunk));
        mma_bf16(s[2 * np], ak, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ak, bq[2], bq[3]);
        mma_bf16(dp[2 * np], av, bd[0], bd[1]);
        mma_bf16(dp[2 * np + 1], av, bd[2], bd[3]);
      }
    }

    // p^T (into s) and ds^T = p^T (dp^T - delta) scale (into dp), fp32.
    // Masks apply only where the tile is not visible whole to all of the
    // warp's keys (its queries are then all live).
    auto p_ds = [&](auto masked) {
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt) {
        const int ql = nt * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(slse + ql);
        const float2 d2 = *reinterpret_cast<const float2*>(sdelta + ql);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = (e & 1) ? l2.y : l2.x;
          const float dl = (e & 1) ? d2.y : d2.x;
          float pr = exp2_approx(fmaf(s[nt][e], scale_log2, -l * LOG2E));
          if constexpr (decltype(masked)::value) {
            const int qi = qbase + ql + (e & 1);
            const int key = key0 + 8 * (e >> 1);
            bool ok = qi < p.sq && key < p.sk && l > rtt::NEG_INF / 2;
            if (p.causal) ok = ok && qi + off >= key;
            pr = ok ? pr : 0.f;
          }
          s[nt][e] = pr;
          dp[nt][e] = pr * (dp[nt][e] - dl) * p.scale;
        }
      }
    };
    const bool whole = qbase + BM <= p.sq && k0 + warp * 16 + 16 <= p.sk &&
                       (!p.causal || qbase + off >= k0 + warp * 16 + 15);
    if (whole) p_ds(std::false_type{});
    else p_ds(std::true_type{});

    // dv += p^T dO and dk += ds^T Q, p^T and ds^T (bf16) from registers
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t ap[4], ads[4];
      pack_a(ap, s[2 * kk], s[2 * kk + 1]);
      pack_a(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bd[4], bq[4];
        ldmatrix_x4_trans(bd, TL::addr(sdO, 16 * kk + bt_row, 2 * np + bt_chunk));
        ldmatrix_x4_trans(bq, TL::addr(sQ, 16 * kk + bt_row, 2 * np + bt_chunk));
        mma_bf16(acc_v[2 * np], ap, bd[0], bd[1]);
        mma_bf16(acc_v[2 * np + 1], ap, bd[2], bd[3]);
        mma_bf16(acc_k[2 * np], ads, bq[0], bq[1]);
        mma_bf16(acc_k[2 * np + 1], ads, bq[2], bq[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before reuse
  }
  cp_async_wait<0>();

  const long long out0 =
      (((long long)bi * p.sk + k0 + warp * 16) * p.hkv + hk) * D;
  store_acc<D>(static_cast<BF*>(p.dk) + out0, (long long)p.hkv * D,
               nkeys - warp * 16, acc_k, lane);
  store_acc<D>(static_cast<BF*>(p.dv) + out0, (long long)p.hkv * D,
               nkeys - warp * 16, acc_v, lane);
}

// Launch one kernel (which: 0 = dq, 1 = dkv), or with `config` fill it as
// rtt_flash_bwd_config describes instead.
template <int D>
cudaError_t run(int which, const Params* p, int* config, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool opted[2][64] = {};
  const bool dq = which == 0;
  const auto kernel = dq ? flash_bwd_dq_kernel<D> : flash_bwd_dkv_kernel<D>;
  const int threads = dq ? C::DQ_THREADS : C::DKV_THREADS;
  const int bytes = dq ? C::DQ_BYTES : C::DKV_BYTES;
  const int rows = dq ? C::DQ_ROWS : C::DKV_KEYS;
  const cudaError_t err = rtt::opt_in_smem(kernel, bytes, opted[which]);
  if (err != cudaSuccess) return err;
  if (config) {
    config[0] = rows;
    config[1] = dq ? C::DQ_KEYS : C::DKV_QUERIES;
    config[2] = threads;
    config[3] = bytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&config[4], kernel,
                                                         threads, bytes);
  }
  const dim3 grid(dq ? p->b * p->hq : p->b * p->hkv,
                  ((dq ? p->sq : p->sk) + rows - 1) / rows);
  kernel<<<grid, threads, bytes, stream>>>(*p);
  return cudaGetLastError();
}

}  // namespace tcb

template <int D>
cudaError_t by_dtype(int which, int dtype, const Params* p, int* config,
                     cudaStream_t stream) {
  if (dtype == 0) return simt::run<D>(which, p, config, stream);
  if (dtype == 1) return tcb::run<D>(which, p, config, stream);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int head_dim, int which, int dtype, const Params* p,
                     int* config, cudaStream_t stream) {
  if (which != 0 && which != 1) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: return by_dtype<16>(which, dtype, p, config, stream);
    case 64: return by_dtype<64>(which, dtype, p, config, stream);
    case 128: return by_dtype<128>(which, dtype, p, config, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// which: 0 = the dq kernel (writes dq and delta), 1 = the dkv kernel (reads
// delta, writes dk and dv). dtype: 0 = float32 (CUDA-core kernels), 1 =
// bfloat16 (tensor-core kernels). Returns a cudaError_t (0 on success).
int rtt_flash_bwd(int which, int dtype, int head_dim,
                  const void* q, const void* k, const void* v,
                  const void* o, const void* dout, const float* lse,
                  float* delta, void* dq, void* dk, void* dv,
                  const int* qoff, int b, int sq, int sk, int hq, int hkv,
                  long long q_sb, long long q_ss, long long q_sh,
                  long long k_sb, long long k_ss, long long k_sh,
                  long long v_sb, long long v_ss, long long v_sh,
                  long long o_sb, long long o_ss, long long o_sh,
                  long long do_sb, long long do_ss, long long do_sh,
                  float scale, int causal, void* stream) {
  Params p{q, k, v, o, dout, lse, delta, dq, dk, dv, qoff, b, sq, sk, hq, hkv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, do_sb, do_ss, do_sh, scale, causal};
  return dispatch(head_dim, which, dtype, &p, nullptr,
                  static_cast<cudaStream_t>(stream));
}

// The tiling of one backward kernel on the current device: out[0] rows per
// block (queries for dq, keys for dkv), out[1] the streamed tile (keys,
// queries), out[2] threads per block, out[3] dynamic shared memory bytes,
// out[4] blocks resident per SM. Returns a cudaError_t.
int rtt_flash_bwd_config(int which, int dtype, int head_dim, int* out) {
  return dispatch(head_dim, which, dtype, nullptr, out, nullptr);
}

const char* rtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
