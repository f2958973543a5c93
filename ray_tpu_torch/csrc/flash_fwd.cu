// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C ABI.
//
// Replaces ray_tpu/ops/pallas/flash.py:_fwd_kernel (launched by
// _flash_fwd_bhsd). Computes, per (batch, q-head) and query row,
//   s = (q . k) * scale           fp32 products and sums, scale after the dot
//   keys >= sk masked; causal: keys > row + q_offset[batch] masked
//   streaming softmax with a running max m, running sum l, fp32 accumulator
//   p rounded to V's dtype before the PV product, l summed from fp32 p
//   o = acc / l (0 where l == 0), lse = m + log(l) (NEG_INF where l == 0)
// q, k, v are read in place through their [b, s, h, d] strides (d must be
// contiguous); the GQA kv head is h / (hq / hkv); the ragged key edge and
// the causal edge are masked here, so nothing is padded or repeated.
//
// What bounds it on an H100:
// - Prefill at long s is bounded by FLOPs: 4 * s_q * s_k * d per head
//   (halved by the causal mask), far above the 295 FLOP/byte ridge.
// - Decode at s_q = 1 is bounded by the bytes of the K/V cache it reads:
//   every key of the row is read once for a handful of FLOPs.
// What this simple design does about each: the K loop of every warp stops
// at its rows' causal diagonal, so neither the FLOPs nor the cache bytes
// past a row's position are spent (a decode row at position p reads p + 1
// keys, not max_len). When a block holds fewer than 16 query rows (decode),
// its four warps split the key tiles among themselves and merge their
// (m, l, acc) at the end, so all four warps stream K/V instead of one.
// K/V tiles come in with 16-byte loads into shared memory. The products
// run on the fp32 CUDA cores, not the tensor cores (no wgmma, no TMA yet):
// prefill sits far from its FLOP bound, which is later work.
//
// Layout of one block: 4 warps, 4 query rows per warp (16 rows), one block
// per (batch * q-head, 16-row query tile). A warp owns private shared
// tiles of 32 keys (one key per lane for Q.K, one head-dim slice per lane
// for P.V), so warps never wait for one another inside the K loop.

#include "flash_common.cuh"

namespace {

using rtt::Elem;
using rtt::FULL;
using rtt::NEG_INF;
using rtt::warp_max;
using rtt::warp_sum;

constexpr int WARPS = 4;
constexpr int ROWS = 4;             // query rows per warp
constexpr int BQ = WARPS * ROWS;    // query rows per block
constexpr int BK = 32;              // keys per tile: one per lane

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;             // [b, sq, hq, d] contiguous, q's dtype
  float* lse;          // [b, hq, sq] contiguous
  const int* qoff;     // [b] int32
  int b, sq, sk, hq, hkv;
  long long q_sb, q_ss, q_sh;   // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal;
};

template <typename T, int D>
struct Shape {
  static constexpr int PW = Elem<T>::PER_WORD;
  static constexpr int WPR = D / PW;                       // words per row
  static constexpr int KS = (WPR % 2) ? WPR : WPR + 1;     // odd: no bank conflicts
  static constexpr int CPR = WPR / 4;                      // 16-byte chunks per row
  static constexpr int PER_LANE = BK * CPR / 32;           // chunks per lane per tile
  static constexpr int UNR = PER_LANE < 4 ? PER_LANE : 4;
  static constexpr int NWV = (WPR + 31) / 32;              // V words per lane
  static constexpr int K_WORDS = BK * KS;
  static constexpr int V_WORDS = BK * WPR;
  static constexpr int Q_WORDS = ROWS * D;                 // fp32 q rows
  static constexpr int WARP_WORDS = K_WORDS + V_WORDS + Q_WORDS;
  static constexpr int BYTES = WARPS * WARP_WORDS * 4;
  static_assert(WPR % 4 == 0, "head_dim must fill whole 16-byte chunks");
  static_assert(PER_LANE % UNR == 0, "chunk unroll must divide the tile");
  static_assert(K_WORDS % 4 == 0 && WARP_WORDS % 4 == 0, "16-byte tiles");
  static_assert(WARPS * ROWS * (D + 2) <= WARPS * WARP_WORDS, "merge fits");
};

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const Params p) {
  using S = Shape<T, D>;
  constexpr int PW = S::PW, WPR = S::WPR, KS = S::KS, CPR = S::CPR;
  constexpr int NWV = S::NWV;
  extern __shared__ __align__(16) uint32_t smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int bi = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = blockIdx.y * BQ;
  const int nrows = min(BQ, p.sq - q0);
  const int groups = (nrows + ROWS - 1) / ROWS;            // 1..4
  const int splits = groups == 1 ? 4 : (groups == 2 ? 2 : 1);
  const int g = warp / splits, split = warp % splits;
  const bool active = g < groups;
  const int r0 = q0 + g * ROWS;
  const int nr = active ? min(ROWS, p.sq - r0) : 0;
  const int off = p.qoff[bi];

  uint32_t* kt = smem + warp * S::WARP_WORDS;
  uint32_t* vt = kt + S::K_WORDS;
  float* qs = reinterpret_cast<float*>(vt + S::V_WORDS);

  const T* qb = static_cast<const T*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + hk * p.v_sh;

  // this warp's query rows, unpacked to fp32 (zeros past the last row)
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    for (int w = lane; w < WPR; w += 32) {
      float x[PW];
      uint32_t word = 0;
      if (r < nr)
        word = __ldg(reinterpret_cast<const uint32_t*>(
            qb + (long long)(r0 + r) * p.q_ss) + w);
      Elem<T>::unpack(word, x);
#pragma unroll
      for (int e = 0; e < PW; ++e) qs[r * D + w * PW + e] = x[e];
    }
  }
  __syncwarp();

  // keys this warp's rows can see: [0, kend)
  int kend = p.sk;
  if (p.causal) kend = min(kend, r0 + nr + off);
  if (nr == 0) kend = 0;
  kend = max(kend, 0);
  const int ntiles = (kend + BK - 1) / BK;

  float m[ROWS], l[ROWS], acc[ROWS][NWV * PW];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NWV * PW; ++i) acc[r][i] = 0.f;
  }

  for (int t = split; t < ntiles; t += splits) {
    const int kbase = t * BK;
    // stage K and V tiles: 16-byte global loads, batched for ILP
#pragma unroll
    for (int c0 = 0; c0 < S::PER_LANE; c0 += S::UNR) {
      uint4 kr[S::UNR], vr[S::UNR];
#pragma unroll
      for (int u = 0; u < S::UNR; ++u) {
        const int c = (c0 + u) * 32 + lane;
        const int j = c / CPR, cw = c % CPR;
        const int key = kbase + j;
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
        if (key < kend) {
          kr[u] = __ldg(reinterpret_cast<const uint4*>(
              kb + (long long)key * p.k_ss) + cw);
          vr[u] = __ldg(reinterpret_cast<const uint4*>(
              vb + (long long)key * p.v_ss) + cw);
        }
      }
#pragma unroll
      for (int u = 0; u < S::UNR; ++u) {
        const int c = (c0 + u) * 32 + lane;
        const int j = c / CPR, cw = c % CPR;
        uint32_t* kd = kt + j * KS + cw * 4;
        kd[0] = kr[u].x; kd[1] = kr[u].y; kd[2] = kr[u].z; kd[3] = kr[u].w;
        *reinterpret_cast<uint4*>(vt + j * WPR + cw * 4) = vr[u];
      }
    }
    __syncwarp();

    // S = Q K^T for key (kbase + lane), all rows of the warp
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const uint32_t* krow = kt + lane * KS;
#pragma unroll 8
    for (int w = 0; w < WPR; ++w) {
      float kv[PW];
      Elem<T>::unpack(krow[w], kv);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int e = 0; e < PW; ++e)
          s[r] = fmaf(qs[r * D + w * PW + e], kv[e], s[r]);
      }
    }

    // online softmax, one row at a time (every lane ends with m, l)
    const int key = kbase + lane;
    float pv[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      bool ok = (r < nr) && (key < kend);
      if (p.causal) ok = ok && (r0 + r + off >= key);
      const float sr = ok ? s[r] * p.scale : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sr));
      // a row with no visible key yet keeps m == NEG_INF; exp(0) = 1
      // would poison it, so its p and alpha are zeroed
      const bool dead = m_new <= NEG_INF / 2;
      const float alpha = dead ? 0.f : expf(m[r] - m_new);
      const float pr = dead ? 0.f : expf(sr - m_new);
      l[r] = l[r] * alpha + warp_sum(pr);
      m[r] = m_new;
      pv[r] = Elem<T>::round(pr);
#pragma unroll
      for (int i = 0; i < NWV * PW; ++i) acc[r][i] *= alpha;
    }

    // acc += P V: lane owns head-dim words lane, lane + 32, ...
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pj[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pj[r] = __shfl_sync(FULL, pv[r], j);
#pragma unroll
      for (int i = 0; i < NWV; ++i) {
        const int w = lane + 32 * i;
        if (w < WPR) {
          float vv[PW];
          Elem<T>::unpack(vt[j * WPR + w], vv);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
#pragma unroll
            for (int e = 0; e < PW; ++e)
              acc[r][i * PW + e] = fmaf(pj[r], vv[e], acc[r][i * PW + e]);
          }
        }
      }
    }
    __syncwarp();
  }

  // warps that split one row group's keys merge their partial softmax
  if (splits > 1) {
    __syncthreads();  // every warp is done with its tiles: reuse smem
    float* cm = reinterpret_cast<float*>(smem);
    float* cl = cm + WARPS * ROWS;
    float* ca = cl + WARPS * ROWS;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (lane == 0) {
        cm[warp * ROWS + r] = m[r];
        cl[warp * ROWS + r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < NWV; ++i) {
        const int w = lane + 32 * i;
        if (w < WPR) {
#pragma unroll
          for (int e = 0; e < PW; ++e)
            ca[(warp * ROWS + r) * D + w * PW + e] = acc[r][i * PW + e];
        }
      }
    }
    __syncthreads();
    if (active && split == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float mm = NEG_INF;
        for (int sp = 0; sp < splits; ++sp)
          mm = fmaxf(mm, cm[(warp + sp) * ROWS + r]);
        float ll = 0.f;
        float a[NWV * PW];
#pragma unroll
        for (int i = 0; i < NWV * PW; ++i) a[i] = 0.f;
        for (int sp = 0; sp < splits; ++sp) {
          const int src = (warp + sp) * ROWS + r;
          const float wgt = expf(cm[src] - mm);
          ll += cl[src] * wgt;
#pragma unroll
          for (int i = 0; i < NWV; ++i) {
            const int w = lane + 32 * i;
            if (w < WPR) {
#pragma unroll
              for (int e = 0; e < PW; ++e)
                a[i * PW + e] += ca[src * D + w * PW + e] * wgt;
            }
          }
        }
        m[r] = mm;
        l[r] = ll;
#pragma unroll
        for (int i = 0; i < NWV * PW; ++i) acc[r][i] = a[i];
      }
    }
  }

  if (!active || split != 0) return;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= nr) break;
    const int row = r0 + r;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const long long obase = (((long long)bi * p.sq + row) * p.hq + h) * D;
    uint32_t* orow = reinterpret_cast<uint32_t*>(static_cast<T*>(p.o) + obase);
#pragma unroll
    for (int i = 0; i < NWV; ++i) {
      const int w = lane + 32 * i;
      if (w < WPR) {
        float x[PW];
#pragma unroll
        for (int e = 0; e < PW; ++e) x[e] = acc[r][i * PW + e] / l_safe;
        orow[w] = Elem<T>::pack(x);
      }
    }
    if (lane == 0)
      p.lse[((long long)bi * p.hq + h) * p.sq + row] =
          l[r] == 0.f ? NEG_INF : m[r] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using S = Shape<T, D>;
  static bool opted_in[64] = {};
  cudaError_t err = rtt::opt_in_smem(flash_fwd_kernel<T, D>, S::BYTES,
                                     opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.b * p.hq, (p.sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, WARPS * 32, S::BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int head_dim, const Params& p, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
int rtt_flash_fwd(int dtype, int head_dim,
                  const void* q, const void* k, const void* v,
                  void* o, float* lse, const int* qoff,
                  int b, int sq, int sk, int hq, int hkv,
                  long long q_sb, long long q_ss, long long q_sh,
                  long long k_sb, long long k_ss, long long k_sh,
                  long long v_sb, long long v_ss, long long v_sh,
                  float scale, int causal, void* stream) {
  Params p{q, k, v, o, lse, qoff, b, sq, sk, hq, hkv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(head_dim, p, st);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(head_dim, p, st);
  return cudaErrorInvalidValue;
}

const char* rtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
