// Flash-attention backward for Hopper (sm_90a), CUDA C++ with a plain C ABI.
//
// Replaces ray_tpu/ops/pallas/flash.py:_dq_kernel and :_dkv_kernel (both
// launched by _flash_bwd_bhsd). With p recomputed from the forward's saved
// log-sum-exp, per (batch, q-head), query row i and key j:
//   s    = (q_i . k_j) * scale                fp32, scale after the dot
//   p    = exp(s - lse_i) where j is visible to i and lse_i > NEG_INF / 2,
//          else 0 (keys >= sk masked; causal: j > i + q_offset[batch])
//   dp   = do_i . v_j
//   ds   = p * (dp - delta_i) * scale,        delta_i = sum_d o_i * do_i
//   dq_i = sum_j ds * k_j,  dk_j = sum_i ds * q_i,  dv_j = sum_i p * do_i
// Every product and sum is fp32 (bf16 inputs are widened exactly); p stays
// fp32, unlike the forward's PV. GQA: dk and dv of a kv head sum over the
// hq / hkv query heads that read it.
//
// Two kernels, launched in this order on one stream:
// - flash_bwd_dq_kernel: one block per (batch * q-head, 16-row query tile),
//   4 warps of 4 query rows. Each warp loads its q and do rows (fp32), takes
//   delta = rowsum(o * do) from o as stored and writes it out for the dkv
//   kernel (JAX takes delta outside the kernels, flash.py:221; here it rides
//   along with the do rows the dq kernel reads anyway), then streams 32-key
//   tiles of K and V up to its rows' causal diagonal: one key per lane for
//   s and dp, one head-dim slice per lane for dq += ds K.
// - flash_bwd_dkv_kernel: one block per (batch * kv-head, 16-key tile),
//   4 warps of 4 keys. Each warp holds its k and v rows (fp32) and, for
//   every q head of its GQA group, streams 32-query tiles of Q and dO from
//   the first query that sees its keys: one query per lane for s and dp,
//   one head-dim slice per lane for dv += p^T dO and dk += ds^T Q. dk and
//   dv accumulate in registers across the whole group and are written once:
//   the GQA sum needs no atomics and no repeated K/V, and the result does
//   not depend on scheduling.
// Tiles are warp-private shared memory (odd row stride: no bank conflicts),
// filled with 16-byte loads, so warps never wait on one another. Inputs are
// read in place through their [b, s, h, d] strides; dq, dk, dv are written
// contiguous.
//
// What bounds it on an H100: at training lengths the FLOPs. The function
// needs 10 * d per visible (query, key) pair per q head (s, dp, dq, dk, dv:
// 2d each); two kernels that each recompute s and dp do 14 * d (dq 6d, dkv
// 8d). At s = 2048 that is hundreds of FLOPs per byte moved, far above the
// 295 FLOP/byte ridge. What this design does about it: both kernels stop at
// the causal diagonal (tiles wholly above it are never visited), so only
// the visible half of the pairs is paid for, and recomputing s and dp
// instead of storing p (s^2 floats a head) keeps the bytes at O(s * d). The
// products run on the fp32 CUDA cores, not the tensor cores (no mma/wgmma,
// no TMA yet); that is the gap to the bound and later work.
//
// Registers, not shared memory, hold the dk/dv accumulators: a 16-key block
// at head_dim 128 needs 16 KB of fp32 dk + dv, spread over 4 warps as 32
// floats a lane, so no 64 KB key-tile accumulator is ever needed.

#include "flash_common.cuh"

namespace {

using rtt::Elem;
using rtt::NEG_INF;
using rtt::warp_sum;

constexpr int WARPS = 4;
constexpr int ROWS = 4;            // per warp: query rows (dq), keys (dkv)
constexpr int BR = WARPS * ROWS;   // per block: query rows (dq), keys (dkv)
constexpr int BT = 32;             // streamed tile: keys (dq), queries (dkv)

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

template <typename T, int D>
struct Shape {
  static constexpr int PW = Elem<T>::PER_WORD;
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
template <typename T, int D>
__device__ __forceinline__ void stage_pair(
    uint32_t* ta, uint32_t* tb, const T* a, long long a_rs, const T* b,
    long long b_rs, int base, int limit, int lane) {
  using S = Shape<T, D>;
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
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* a,
                                          long long a_rs, int n, int lane) {
  using S = Shape<T, D>;
  constexpr int PW = S::PW, WPR = S::WPR;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    for (int w = lane; w < WPR; w += 32) {
      uint32_t word = 0;
      if (r < n)
        word = __ldg(reinterpret_cast<const uint32_t*>(a + r * a_rs) + w);
      float x[PW];
      Elem<T>::unpack(word, x);
#pragma unroll
      for (int e = 0; e < PW; ++e) dst[(w * PW + e) * ROWS + r] = x[e];
    }
  }
}

// acc[ROWS][NWV * PW] (fp32) rounded to T and written as rows of a
// contiguous [*, D] matrix, row r at out + r * row_stride.
template <typename T, int D>
__device__ __forceinline__ void store_rows(
    void* out, long long row_stride, int n,
    const float (&acc)[ROWS][Shape<T, D>::NWV * Shape<T, D>::PW], int lane) {
  using S = Shape<T, D>;
  constexpr int PW = S::PW, WPR = S::WPR, NWV = S::NWV;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= n) break;
    uint32_t* row = reinterpret_cast<uint32_t*>(static_cast<T*>(out) +
                                                r * row_stride);
#pragma unroll
    for (int i = 0; i < NWV; ++i) {
      const int w = lane + 32 * i;
      if (w < WPR) row[w] = Elem<T>::pack(&acc[r][i * PW]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_kernel(const Params p) {
  using S = Shape<T, D>;
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

  load_rows<T, D>(qs, qb, p.q_ss, nr, lane);
  load_rows<T, D>(dos, dob, p.do_ss, nr, lane);
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
        Elem<T>::unpack(__ldg(reinterpret_cast<const uint32_t*>(
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
    stage_pair<T, D>(kt, vt, kb, p.k_ss, vb, p.v_ss, kbase, kend, lane);
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
      Elem<T>::unpack(krow[w], kx);
      Elem<T>::unpack(vrow[w], vx);
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
          Elem<T>::unpack(kt[j * KS + w], kx);
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

  store_rows<T, D>(static_cast<T*>(p.dq) +
                       (((long long)bi * p.sq + r0) * p.hq + h) * D,
                   (long long)p.hq * D, nr, acc, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkv_kernel(const Params p) {
  using S = Shape<T, D>;
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

  load_rows<T, D>(ks, static_cast<const T*>(p.k) + (long long)bi * p.k_sb +
                          (long long)k0 * p.k_ss + (long long)hk * p.k_sh,
                  p.k_ss, nk, lane);
  load_rows<T, D>(vs, static_cast<const T*>(p.v) + (long long)bi * p.v_sb +
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
      stage_pair<T, D>(qt, dt, qb, p.q_ss, dob, p.do_ss, qbase, p.sq, lane);
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
        Elem<T>::unpack(qrow[w], qx);
        Elem<T>::unpack(drow[w], dx);
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
            Elem<T>::unpack(qt[j * KS + w], qx);
            Elem<T>::unpack(dt[j * KS + w], dx);
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
  store_rows<T, D>(static_cast<T*>(p.dk) + out0, (long long)p.hkv * D, nk,
                   acc_k, lane);
  store_rows<T, D>(static_cast<T*>(p.dv) + out0, (long long)p.hkv * D, nk,
                   acc_v, lane);
}

template <typename T, int D>
cudaError_t launch(int which, const Params& p, cudaStream_t stream) {
  using S = Shape<T, D>;
  static bool opted_dq[64] = {}, opted_dkv[64] = {};
  cudaError_t err;
  if (which == 0) {
    err = rtt::opt_in_smem(flash_bwd_dq_kernel<T, D>, S::BYTES, opted_dq);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.b * p.hq, (p.sq + BR - 1) / BR);
    flash_bwd_dq_kernel<T, D><<<grid, WARPS * 32, S::BYTES, stream>>>(p);
  } else {
    err = rtt::opt_in_smem(flash_bwd_dkv_kernel<T, D>, S::BYTES, opted_dkv);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.b * p.hkv, (p.sk + BR - 1) / BR);
    flash_bwd_dkv_kernel<T, D><<<grid, WARPS * 32, S::BYTES, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int head_dim, int which, const Params& p,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(which, p, stream);
    case 64: return launch<T, 64>(which, p, stream);
    case 128: return launch<T, 128>(which, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// which: 0 = the dq kernel (writes dq and delta), 1 = the dkv kernel (reads
// delta, writes dk and dv). dtype: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t (0 on success).
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which != 0 && which != 1) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_d<float>(head_dim, which, p, st);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(head_dim, which, p, st);
  return cudaErrorInvalidValue;
}

const char* rtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
