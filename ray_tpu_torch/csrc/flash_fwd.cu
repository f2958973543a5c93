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
// contiguous, rows 16-byte aligned); the GQA kv head is h / (hq / hkv); the
// ragged key edge and the causal edge are masked here, so nothing is padded
// or repeated. o is written [b, sq, hq, d] and lse [b, hq, sq], contiguous.
//
// What bounds it on an H100:
// - Training and prefill (s_q in the hundreds or thousands) are bounded by
//   FLOPs: 4 * d per visible (query, key) pair and q head, hundreds of
//   FLOPs per byte moved, far above the 295 FLOP/byte ridge of bf16. The
//   products belong on the tensor cores (989 TFLOP/s bf16 dense, against
//   67 TFLOP/s on the fp32 CUDA cores).
// - Decode (s_q = 1) is bounded by the bytes of the K/V cache it reads:
//   every key of the row is read once for a handful of FLOPs. What counts
//   there is how many loads are in flight, not which unit multiplies.
//
// Three kernels; rtt_flash_fwd picks one (pick, at the end of the file):
// - tcb (bfloat16 beyond decode): the tensor-core kernel. One block
//   per (batch * q-head, 64 query rows), 4 warps of 16 rows. The Q tile is
//   loaded once with cp.async into a swizzled shared tile (tensor_core.cuh)
//   and held as mma A fragments in registers; K/V tiles of 64 keys are
//   double-buffered with cp.async up to the block's causal diagonal. s = Q
//   K^T and o += P V are mma.sync m16n8k16 (bf16 in, fp32 sums, as JAX's
//   preferred_element_type=f32); the online softmax runs in registers, its
//   row max and row sum across the 4 lanes of a quad. p is formed in fp32,
//   l summed from it, and p rounded to bf16 only as the A operand of P V,
//   packed straight from the s accumulators (flash.py:83's p.astype). A
//   warp skips the tiles past its own rows' diagonal and the masks of a
//   tile it sees whole; the last query tiles, which see the most keys, are
//   launched first.
// - dec (bfloat16 decode: s_q <= DEC_MAX_SQ and s_q * group <= 16): the
//   split-KV kernel, built for the bytes bound. One block per (batch *
//   kv-head, key chunk): its rows are the GQA group's q heads x s_q, packed
//   into one 16-row mma tile, so each K/V byte is read once per kv head and
//   not once per q head. The chunks are whole 64-key tiles; their count
//   (splits, grid.y) is set by the wrapper from (b, hkv, s_k, SM count)
//   alone, never from positions, so that a b 1 call still covers the card
//   (and a CUDA graph can hold the launch). Each block clips its chunk to
//   its row's causal end, read on the device, and streams its tiles
//   through STAGES cp.async stages; its 4 warps take 16 keys of every tile
//   each (mma.sync for both products, as tcb) and merge their (m, l, acc)
//   in shared memory at the end. With one split the block writes o and
//   lse; with more, each writes (o_i normalised in fp32, lse_i) to the
//   wrapper's scratch and a second kernel, launched by the same call as a
//   programmatic dependent (its launch overlaps the first kernel's tail),
//   merges the splits in a fixed order (JAX's context._merge over n
//   partials), so two launches give the same bits.
// - simt (float32): the CUDA-core kernel.
//   One block per (batch * q-head, 16 query rows), 4 warps of 4 rows, each
//   warp streaming private 32-key tiles through shared memory with 16-byte
//   loads. Each warp's K loop stops at its rows' causal diagonal, so a
//   decode row at position p reads p + 1 keys, not max_len; when a block
//   holds fewer than 16 rows (decode), its four warps split the key tiles
//   and merge their (m, l, acc) at the end, so all four stream K/V.
// All give dead rows (no visible key) o = 0 and lse = NEG_INF, and repeat
// their bits from launch to launch.

#include <type_traits>

#include "flash_common.cuh"
#include "tensor_core.cuh"

namespace {

using rtt::FULL;
using rtt::NEG_INF;

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
  // dec only: key chunks (grid.y), keys per chunk (set by dec::run), and
  // with splits > 1 the fp32 scratch: o_i [splits, b, hq, sq, d], then
  // lse_i [splits, b, hq, sq]
  int splits, chunk;
  float* scratch;
};

// grid.y holds one query tile per index
constexpr int MAX_GRID_Y = 65535;

// ---------------------------------------------------------------- simt
// CUDA-core kernel, float32 only.
namespace simt {

using Elem = rtt::Elem<float>;
using rtt::warp_max;
using rtt::warp_sum;

constexpr int WARPS = 4;
constexpr int ROWS = 4;             // query rows per warp
constexpr int BQ = WARPS * ROWS;    // query rows per block
constexpr int BK = 32;              // keys per tile: one per lane

template <int D>
struct Shape {
  static constexpr int PW = Elem::PER_WORD;
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

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const Params p) {
  using S = Shape<D>;
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

  const float* qb = static_cast<const float*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + bi * p.v_sb + hk * p.v_sh;

  // this warp's query rows, unpacked to fp32 (zeros past the last row)
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    for (int w = lane; w < WPR; w += 32) {
      float x[PW];
      uint32_t word = 0;
      if (r < nr)
        word = __ldg(reinterpret_cast<const uint32_t*>(
            qb + (long long)(r0 + r) * p.q_ss) + w);
      Elem::unpack(word, x);
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
      Elem::unpack(krow[w], kv);
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
      pv[r] = Elem::round(pr);
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
          Elem::unpack(vt[j * WPR + w], vv);
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
    uint32_t* orow = reinterpret_cast<uint32_t*>(static_cast<float*>(p.o) + obase);
#pragma unroll
    for (int i = 0; i < NWV; ++i) {
      const int w = lane + 32 * i;
      if (w < WPR) {
        float x[PW];
#pragma unroll
        for (int e = 0; e < PW; ++e) x[e] = acc[r][i * PW + e] / l_safe;
        orow[w] = Elem::pack(x);
      }
    }
    if (lane == 0)
      p.lse[((long long)bi * p.hq + h) * p.sq + row] =
          l[r] == 0.f ? NEG_INF : m[r] + logf(l_safe);
  }
}

// Launch the kernel, or with `config` fill config[1..5] as
// rtt_flash_fwd_config describes instead.
template <int D>
cudaError_t run(const Params* p, int* config, cudaStream_t stream) {
  using S = Shape<D>;
  static bool opted_in[64] = {};
  cudaError_t err = rtt::opt_in_smem(flash_fwd_kernel<D>, S::BYTES,
                                     opted_in);
  if (err != cudaSuccess) return err;
  if (config) {
    config[1] = BQ;
    config[2] = BK;
    config[3] = WARPS * 32;
    config[4] = S::BYTES;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &config[5], flash_fwd_kernel<D>, WARPS * 32, S::BYTES);
  }
  const int tiles = (p->sq + BQ - 1) / BQ;
  if (tiles > MAX_GRID_Y) return cudaErrorInvalidValue;
  const dim3 grid(p->b * p->hq, tiles);
  flash_fwd_kernel<D><<<grid, WARPS * 32, S::BYTES, stream>>>(*p);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------- bf16
// Tensor-core kernel: both products are mma.sync m16n8k16 (bf16 in, fp32
// sums) on operands that ldmatrix reads from swizzled shared tiles.
namespace tcb {

using namespace rtt::tc;
using BF = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Tile sizes by head_dim: ROWS query rows per block (16 per warp), K/V
// streamed KEYS keys at a time, two stages. At d 128 the o accumulator is
// 64 floats a lane and the Q fragments 32 registers; s takes KEYS / 2.
// Chosen on an H100 with ray_tpu_torch/tools/tune_flash_fwd.py: 128-row
// blocks (8 warps) were 30 % slower at the 1b train shape, 128-key tiles
// at d 64 7 % slower, 32-key tiles at d 128 17 % slower, and capping d 64
// at 128 registers for a 4th block an SM spilled.
template <int D>
struct Cfg {
  static constexpr int ROWS = 64;
  static constexpr int KEYS = 64;
  static constexpr int THREADS = ROWS / 16 * 32;
  // dynamic shared memory: the Q tile and two K/V stages
  static constexpr int BYTES = ROWS * D * 2 + 4 * KEYS * D * 2;
};

// 2**x on the special-function unit; results below 2**-126 flush to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
flash_fwd_kernel(const Params p) {
  using C = Cfg<D>;
  using TL = Tile<D>;
  constexpr int BM = C::ROWS, BN = C::KEYS, THREADS = C::THREADS;
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

  const uint32_t sQ = smem_addr(smem);
  const uint32_t sKV = sQ + Q_BYTES;   // stage s: K at + 2s KV_BYTES, V after

  const BF* qb = static_cast<const BF*>(p.q) + bi * p.q_sb +
                 (long long)m0 * p.q_ss + h * p.q_sh;
  const BF* kb = static_cast<const BF*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const BF* vb = static_cast<const BF*>(p.v) + bi * p.v_sb + hk * p.v_sh;

  // keys the block's rows can see: [0, kend)
  int kend = p.sk;
  if (p.causal) kend = min(kend, m0 + nrows + off);
  kend = max(kend, 0);
  const int ntiles = (kend + BN - 1) / BN;
  // ... and this warp's 16 rows: [0, wkend); a warp past the last row
  // sees none
  const int w0 = m0 + warp * 16;
  const int wrows = min(16, nrows - warp * 16);
  int wkend = wrows > 0 ? kend : 0;
  if (p.causal) wkend = min(wkend, w0 + wrows + off);

  auto load_kv = [&](int tile) {
    const uint32_t stage = sKV + (tile & 1) * 2 * KV_BYTES;
    const int k0 = tile * BN;
    load_tile_async<D, BN, THREADS>(stage, kb + (long long)k0 * p.k_ss, p.k_ss,
                                    kend - k0, tid);
    load_tile_async<D, BN, THREADS>(stage + KV_BYTES, vb + (long long)k0 * p.v_ss,
                                    p.v_ss, kend - k0, tid);
  };

  load_tile_async<D, BM, THREADS>(sQ, qb, p.q_ss, nrows, tid);
  cp_async_commit();
  if (ntiles > 0) load_kv(0);
  cp_async_commit();
  cp_async_wait<1>();   // Q has landed (this thread's copies)
  __syncthreads();      // ... and every other thread's

  // ldmatrix row/chunk of this lane: A operands (16 rows x 16 columns),
  // B operands for two n8 tiles (non-transposed and transposed)
  const int a_row = warp * 16 + (lane & 15), a_chunk = lane >> 4;
  const int b_row = ((lane >> 4) << 3) + (lane & 7), b_chunk = (lane >> 3) & 1;
  const int bt_row = (((lane >> 3) & 1) << 3) + (lane & 7), bt_chunk = lane >> 4;

  // the warp's Q rows as A fragments, held for the whole K loop
  uint32_t aq[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldmatrix_x4(aq[kc], TL::addr(sQ, a_row, 2 * kc + a_chunk));

  // this lane's two rows, g and g + 8 of the warp's 16: running max (in
  // units of log2, scale included) and this lane's part of the running sum
  float m2[2] = {NEG_INF, NEG_INF}, l2[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float scale_log2 = p.scale * LOG2E;

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) load_kv(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();   // this tile's K/V; the next may still be in flight
    __syncthreads();
    const int kbase = tile * BN;
    if (kbase < wkend) {  // else no key of the tile is visible to the warp
      const uint32_t sK = sKV + (tile & 1) * 2 * KV_BYTES, sV = sK + KV_BYTES;

      // s = Q K^T: 16 rows x BN keys per warp
      float s[BN / 8][4];
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, TL::addr(sK, 16 * np + b_row, 2 * kc + b_chunk));
          mma_bf16(s[2 * np], aq[kc], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], aq[kc], bk[2], bk[3]);
        }
      }

      // online softmax in registers: s becomes p (fp32), the row's max and
      // sum taken over the 4 lanes of its quad. Masks apply only where the
      // tile is not visible whole to all of the warp's rows (which then all
      // have a visible key, so none is dead).
      auto softmax = [&](auto masked) {
        constexpr bool MASKED = decltype(masked)::value;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = w0 + g + 8 * j;
          float mx = m2[j];
#pragma unroll
          for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
            for (int e = 2 * j; e < 2 * j + 2; ++e) {
              float x = s[nt][e] * scale_log2;
              if constexpr (MASKED) {
                const int key = kbase + nt * 8 + 2 * t + (e & 1);
                bool ok = row < p.sq && key < p.sk;
                if (p.causal) ok = ok && key <= row + off;
                x = ok ? x : NEG_INF;
              }
              s[nt][e] = x;
              mx = fmaxf(mx, x);
            }
          }
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
          // a row with no visible key yet keeps m == NEG_INF; 2**0 = 1
          // would poison it, so its p and alpha are zeroed
          const bool dead = MASKED && mx <= NEG_INF / 2;
          const float alpha = dead ? 0.f : exp2_approx(m2[j] - mx);
          m2[j] = mx;
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
            for (int e = 2 * j; e < 2 * j + 2; ++e) {
              const float pr = dead ? 0.f : exp2_approx(s[nt][e] - mx);
              s[nt][e] = pr;
              sum += pr;
            }
          }
          l2[j] = l2[j] * alpha + sum;
#pragma unroll
          for (int nt = 0; nt < D / 8; ++nt) {
            acc[nt][2 * j] *= alpha;
            acc[nt][2 * j + 1] *= alpha;
          }
        }
      };
      const bool whole = wrows == 16 && kbase + BN <= p.sk &&
                         (!p.causal || kbase + BN - 1 <= w0 + off);
      if (whole) softmax(std::false_type{});
      else softmax(std::true_type{});

      // o += P V: p rounded to bf16 is the A operand straight from the
      // accumulators; V's B operand by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t a[4];
        pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, TL::addr(sV, 16 * kk + bt_row, 2 * np + bt_chunk));
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before reuse
  }
  cp_async_wait<0>();

  // the row sums over the quad; o = acc / l (0 for a dead row, whose acc
  // is 0), lse = m + log(l) in natural units
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float l = l2[j];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    const int r = warp * 16 + g + 8 * j;
    if (r >= nrows) continue;
    const int row = m0 + r;
    const float inv = l == 0.f ? 0.f : 1.f / l;
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        static_cast<BF*>(p.o) + (((long long)bi * p.sq + row) * p.hq + h) * D);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      orow[(nt * 8 + 2 * t) / 2] =
          pack_bf16(acc[nt][2 * j] * inv, acc[nt][2 * j + 1] * inv);
    if (t == 0)
      p.lse[((long long)bi * p.hq + h) * p.sq + row] =
          l == 0.f ? NEG_INF : m2[j] * LN2 + logf(l);
  }
}

// Launch the kernel, or with `config` fill config[1..5] as
// rtt_flash_fwd_config describes instead.
template <int D>
cudaError_t run(const Params* p, int* config, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool opted_in[64] = {};
  const cudaError_t err = rtt::opt_in_smem(flash_fwd_kernel<D>, C::BYTES,
                                           opted_in);
  if (err != cudaSuccess) return err;
  if (config) {
    config[1] = C::ROWS;
    config[2] = C::KEYS;
    config[3] = C::THREADS;
    config[4] = C::BYTES;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &config[5], flash_fwd_kernel<D>, C::THREADS, C::BYTES);
  }
  const int tiles = (p->sq + C::ROWS - 1) / C::ROWS;
  if (tiles > MAX_GRID_Y) return cudaErrorInvalidValue;
  const dim3 grid(p->b * p->hq, tiles);
  flash_fwd_kernel<D><<<grid, C::THREADS, C::BYTES, stream>>>(*p);
  return cudaGetLastError();
}

}  // namespace tcb

// ---------------------------------------------------------------- dec
// Decode kernel (bf16, s_q * group <= 16 rows): split-KV. One block per
// (batch * kv-head, key chunk); Q (the GQA group's rows) is one 16-row mma
// tile, K/V tiles of 64 keys stream through STAGES cp.async stages, and
// each of the 4 warps takes 16 keys of every tile. The shipped dispatch
// (DEC_MAX_SQ = 1) gives it one query row per q head; the handling of
// s_q > 1 (row r is query r / group, each row its own causal end) serves
// only the "dec" variant of tools/tune_flash_fwd.py (DEC_MAX_SQ = 16),
// whose crossover against tcb is the measurement behind DEC_MAX_SQ.
namespace dec {

using namespace rtt::tc;
using BF = __nv_bfloat16;
using tcb::exp2_approx;
using tcb::LN2;
using tcb::LOG2E;

constexpr int ROWS = 16;             // a block's rows: group x s_q, padded
constexpr int KEYS = 64;             // keys per streamed tile
constexpr int WARPS = 4;             // 16 keys of every tile each
constexpr int THREADS = WARPS * 32;
// K/V tiles in flight: the next STAGES - 1 tiles load while one is used.
// Measured at the decode shapes (tools/tune_flash_fwd.py, PERF.md): 2
// stages within 4 % of 3, 4 stages up to 8 % slower.
constexpr int STAGES = 3;
// The merge launches as a programmatic dependent of the kernel (run): up
// to 1 us less a split call at the decode shapes than a plain launch.
constexpr int PDL = 1;

template <int D>
struct Cfg {
  static constexpr int Q_BYTES = ROWS * D * 2;
  static constexpr int KV_BYTES = KEYS * D * 2;   // one K or one V tile
  static constexpr int STAGE_BYTES = STAGES * 2 * KV_BYTES;
  static constexpr int BYTES = Q_BYTES + STAGE_BYTES;
  // the warps' (m, l, acc) for their merge, in the stages once drained
  static constexpr int MERGE_BYTES = WARPS * ROWS * (D + 2) * 4;
  static_assert(MERGE_BYTES <= STAGE_BYTES, "the merge fits the stages");
};

// Whole 64-key tiles per chunk, or 0 when `splits` chunks of whole tiles
// cannot cover [0, sk) with none of them empty (ops/flash.py:decode_chunk).
inline int chunk_tiles(int sk, int splits) {
  const int tiles = (sk + KEYS - 1) / KEYS;
  if (splits < 1 || splits > tiles) return 0;
  const int per = (tiles + splits - 1) / splits;
  return (tiles + per - 1) / per == splits ? per : 0;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params p) {
  using C = Cfg<D>;
  using TL = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];

  // the merge's blocks may be scheduled once every block here has started;
  // they wait for this grid's writes (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bi = blockIdx.x / p.hkv, hk = blockIdx.x % p.hkv;
  const int split = blockIdx.y;
  const int group = p.hq / p.hkv;
  // row r of the tile: query r / group of q head hk * group + r % group
  const int nrows = group * p.sq;
  const int off = p.qoff[bi];

  // keys of this block: its chunk [lo, lo + chunk), clipped to the keys
  // and to the rows' causal end (off + sq, read here on the device)
  const int lo = split * p.chunk;
  int hi = min(p.sk, lo + p.chunk);
  if (p.causal) hi = min(hi, off + p.sq);
  const int ntiles = hi > lo ? (hi - lo + KEYS - 1) / KEYS : 0;

  const uint32_t sQ = smem_addr(smem);
  const uint32_t sKV = sQ + C::Q_BYTES;   // stage s: K at + 2s KV_BYTES, V after
  const BF* kb = static_cast<const BF*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const BF* vb = static_cast<const BF*>(p.v) + bi * p.v_sb + hk * p.v_sh;

  auto load_kv = [&](int tile) {
    if (tile < ntiles) {
      const uint32_t stage = sKV + (tile % STAGES) * 2 * C::KV_BYTES;
      const int k0 = lo + tile * KEYS;
      load_tile_async<D, KEYS, THREADS>(stage, kb + (long long)k0 * p.k_ss,
                                        p.k_ss, hi - k0, tid);
      load_tile_async<D, KEYS, THREADS>(stage + C::KV_BYTES,
                                        vb + (long long)k0 * p.v_ss, p.v_ss,
                                        hi - k0, tid);
    }
    cp_async_commit();   // empty past the last tile: the group count holds
  };

  // the Q tile (rows past nrows zero-filled), then the first tiles
  if (ntiles > 0) {
    const BF* qb = static_cast<const BF*>(p.q) + bi * p.q_sb +
                   (long long)hk * group * p.q_sh;
    for (int idx = tid; idx < ROWS * TL::CHUNKS; idx += THREADS) {
      const int r = idx / TL::CHUNKS, c = idx % TL::CHUNKS;
      const bool ok = r < nrows;
      const BF* src = qb + (ok ? (r / group) * p.q_ss + (r % group) * p.q_sh +
                                     c * 8 : 0);
      cp_async_16(TL::addr(sQ, r, c), src, ok);
    }
  }
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_kv(s);
  cp_async_wait<STAGES - 1>();   // Q has landed (this thread's copies)
  __syncthreads();               // ... and every other thread's

  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int b_row = ((lane >> 4) << 3) + (lane & 7), b_chunk = (lane >> 3) & 1;
  const int bt_row = (((lane >> 3) & 1) << 3) + (lane & 7), bt_chunk = lane >> 4;
  uint32_t aq[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldmatrix_x4(aq[kc], TL::addr(sQ, a_row, 2 * kc + a_chunk));

  // this lane's rows g and g + 8: the last key each sees; every row sees
  // the keys below whole_end
  int last[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    last[j] = p.causal ? min(hi - 1, (g + 8 * j) / group + off) : hi - 1;
  const int whole_end = p.causal ? min(hi, off + 1) : hi;

  float m2[2] = {NEG_INF, NEG_INF}, l2[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float scale_log2 = p.scale * LOG2E;

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<STAGES - 2>();   // this tile's K/V (this thread's copies)
    __syncthreads();               // ... and all; the stage of tile - 1 is free
    load_kv(tile + STAGES - 1);
    const int kw = lo + tile * KEYS + warp * 16;   // this warp's 16 keys
    if (kw < hi) {
      const uint32_t sK = sKV + (tile % STAGES) * 2 * C::KV_BYTES;
      const uint32_t sV = sK + C::KV_BYTES;

      // s = Q K^T: 16 rows x 16 keys
      float s[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t bk[4];
        ldmatrix_x4(bk, TL::addr(sK, 16 * warp + b_row, 2 * kc + b_chunk));
        mma_bf16(s[0], aq[kc], bk[0], bk[1]);
        mma_bf16(s[1], aq[kc], bk[2], bk[3]);
      }

      // online softmax as in tcb; masks only where an edge cuts the keys
      auto softmax = [&](auto masked) {
        constexpr bool MASKED = decltype(masked)::value;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float mx = m2[j];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 2 * j; e < 2 * j + 2; ++e) {
              float x = s[nt][e] * scale_log2;
              if constexpr (MASKED) {
                const int key = kw + nt * 8 + 2 * t + (e & 1);
                x = key <= last[j] ? x : NEG_INF;
              }
              s[nt][e] = x;
              mx = fmaxf(mx, x);
            }
          }
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
          // a row with no visible key yet keeps m == NEG_INF; its p and
          // alpha are zeroed
          const bool dead = MASKED && mx <= NEG_INF / 2;
          const float alpha = dead ? 0.f : exp2_approx(m2[j] - mx);
          m2[j] = mx;
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 2 * j; e < 2 * j + 2; ++e) {
              const float pr = dead ? 0.f : exp2_approx(s[nt][e] - mx);
              s[nt][e] = pr;
              sum += pr;
            }
          }
          l2[j] = l2[j] * alpha + sum;
#pragma unroll
          for (int nt = 0; nt < D / 8; ++nt) {
            acc[nt][2 * j] *= alpha;
            acc[nt][2 * j + 1] *= alpha;
          }
        }
      };
      if (kw + 16 <= whole_end) softmax(std::false_type{});
      else softmax(std::true_type{});

      // o += P V: p rounded to bf16 as the A operand, V by ldmatrix.trans
      uint32_t a[4];
      pack_a(a, s[0], s[1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, TL::addr(sV, 16 * warp + bt_row, 2 * np + bt_chunk));
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the stages: reuse them

  // the warps merge their (m, l, acc): m in log2 units, l summed over the
  // quad first
  float* mw = reinterpret_cast<float*>(smem + C::Q_BYTES);   // [WARPS][ROWS]
  float* lw = mw + WARPS * ROWS;                              // [WARPS][ROWS]
  float* aw = lw + WARPS * ROWS;                              // [WARPS][ROWS][D]
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float l = l2[j];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    const int r = warp * ROWS + g + 8 * j;
    if (t == 0) {
      mw[r] = m2[j];
      lw[r] = l;
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(aw + r * D + nt * 8 + 2 * t) =
          make_float2(acc[nt][2 * j], acc[nt][2 * j + 1]);
  }
  __syncthreads();

  // each thread: 4 columns of a row. o = acc / l (0 for a dead row), lse =
  // m + log(l) in natural units (NEG_INF for a dead row)
  constexpr int C4 = D / 4;
  for (int idx = tid; idx < nrows * C4; idx += THREADS) {
    const int r = idx / C4, c = (idx % C4) * 4;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, mw[w * ROWS + r]);
    float l = 0.f, x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      // a warp that saw no key of the row has l = acc = 0
      const float wt = exp2_approx(mw[w * ROWS + r] - m);
      l += lw[w * ROWS + r] * wt;
      const float4 a4 = *reinterpret_cast<const float4*>(aw + (w * ROWS + r) * D + c);
      x[0] += a4.x * wt;
      x[1] += a4.y * wt;
      x[2] += a4.z * wt;
      x[3] += a4.w * wt;
    }
    const float inv = l == 0.f ? 0.f : 1.f / l;
    const float lse = l == 0.f ? NEG_INF : m * LN2 + logf(l);
    const int qi = r / group, h = hk * group + r % group;
    // row (bi, h, qi) of the [b, hq, sq] layout
    const long long row = ((long long)bi * p.hq + h) * p.sq + qi;
    if (p.splits == 1) {
      uint2 packed;
      packed.x = pack_bf16(x[0] * inv, x[1] * inv);
      packed.y = pack_bf16(x[2] * inv, x[3] * inv);
      *reinterpret_cast<uint2*>(static_cast<BF*>(p.o) +
          (((long long)bi * p.sq + qi) * p.hq + h) * D + c) = packed;
      if (c == 0) p.lse[row] = lse;
    } else {
      const long long rows = (long long)p.b * p.hq * p.sq;
      const long long prow = split * rows + row;
      *reinterpret_cast<float4*>(p.scratch + prow * D + c) =
          make_float4(x[0] * inv, x[1] * inv, x[2] * inv, x[3] * inv);
      if (c == 0) p.scratch[p.splits * rows * D + prow] = lse;
    }
  }
}

// The splits' (o_i, lse_i) merged into o and lse, in split order:
// m = max lse_i, w_i = exp(lse_i - m) (0 for a dead partial), o = sum
// o_i w_i / sum w_i, lse = m + log(sum w_i); a row with every partial dead
// gets o = 0 and lse = NEG_INF. Each thread: 4 columns of a row.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_combine_kernel(const Params p) {
  constexpr int C4 = D / 4, PER_BLOCK = THREADS / C4;
  // every write of the split kernel is visible past this point
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long rows = (long long)p.b * p.hq * p.sq;
  const long long row = (long long)blockIdx.x * PER_BLOCK + threadIdx.x / C4;
  const int c = (threadIdx.x % C4) * 4;
  if (row >= rows) return;
  const float* lse_i = p.scratch + p.splits * rows * D;
  float m = NEG_INF;
  for (int i = 0; i < p.splits; ++i) m = fmaxf(m, lse_i[i * rows + row]);
  const bool dead = m <= NEG_INF / 2;
  float den = 0.f;
  for (int i = 0; i < p.splits; ++i) {
    const float li = lse_i[i * rows + row];
    den += (dead || li <= NEG_INF / 2) ? 0.f : expf(li - m);
  }
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < p.splits; ++i) {
    const float li = lse_i[i * rows + row];
    if (dead || li <= NEG_INF / 2) continue;
    const float wt = expf(li - m) / den;
    const float4 o4 = *reinterpret_cast<const float4*>(
        p.scratch + (i * rows + row) * D + c);
    x[0] += o4.x * wt;
    x[1] += o4.y * wt;
    x[2] += o4.z * wt;
    x[3] += o4.w * wt;
  }
  // row = (bi * hq + h) * sq + qi; o is [b, sq, hq, d]
  const int qi = row % p.sq;
  const long long bh = row / p.sq;
  const int h = bh % p.hq;
  const long long bi = bh / p.hq;
  uint2 packed;
  packed.x = pack_bf16(x[0], x[1]);
  packed.y = pack_bf16(x[2], x[3]);
  *reinterpret_cast<uint2*>(static_cast<BF*>(p.o) +
                            ((bi * p.sq + qi) * p.hq + h) * D + c) = packed;
  if (c == 0) p.lse[row] = dead ? NEG_INF : m + logf(den);
}

// Launch the kernel (and, with splits > 1, the merge), or with `config`
// fill config[1..5] as rtt_flash_fwd_config describes instead.
template <int D>
cudaError_t run(const Params* p, int* config, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool opted_in[64] = {};
  const cudaError_t err = rtt::opt_in_smem(flash_fwd_kernel<D>, C::BYTES,
                                           opted_in);
  if (err != cudaSuccess) return err;
  if (config) {
    config[1] = ROWS;
    config[2] = KEYS;
    config[3] = THREADS;
    config[4] = C::BYTES;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &config[5], flash_fwd_kernel<D>, THREADS, C::BYTES);
  }
  const int per = chunk_tiles(p->sk, p->splits);
  if (p->sq * (p->hq / p->hkv) > ROWS || per == 0 || p->splits > MAX_GRID_Y ||
      (p->splits > 1 && p->scratch == nullptr))
    return cudaErrorInvalidValue;
  Params lp = *p;
  lp.chunk = per * KEYS;
  const dim3 grid(p->b * p->hkv, p->splits);
  flash_fwd_kernel<D><<<grid, THREADS, C::BYTES, stream>>>(lp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p->splits == 1) return e;
  // a programmatic dependent launch: the merge's launch overlaps the
  // kernel's last blocks instead of following its drain
  const long long rows = (long long)p->b * p->hq * p->sq;
  const int per_block = THREADS / (D / 4);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + per_block - 1) / per_block);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = PDL;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_fwd_combine_kernel<D>, lp);
}

}  // namespace dec

// The one place that picks the kernel: float32 calls take the CUDA-core
// kernel; bfloat16 calls of at most DEC_MAX_SQ query rows whose GQA group
// times s_q fits dec's 16-row tile (decode, also at the 1b preset's group
// of 8) the split-KV decode kernel; every other bfloat16 call the
// tensor-core kernel. Measured with ray_tpu_torch/tools/tune_flash_fwd.py
// on an H100 80GB HBM3 at 700 W (PERF.md): the tensor-core kernel is
// faster than the CUDA-core one at every row count from 1 to 64 (bf16, d
// 128, b 8, s_k 1024, 32 heads); dec is 1.05x (7b, b 8) to 2.7x (b 1,
// 4,096 keys) faster than it at the serve path's decode shapes, as fast at
// 1 row with every key visible, and no faster from 2 to 16 rows: dec
// takes single rows.
constexpr int DEC_MAX_SQ = 1;

enum Kernel { SIMT = 0, TCB = 1, DEC = 2 };

Kernel pick(int dtype, int sq, int group) {
  if (dtype == 0) return SIMT;
  return sq <= DEC_MAX_SQ && sq * group <= dec::ROWS ? DEC : TCB;
}

template <int D>
cudaError_t by_kernel(int dtype, const Params* p, int sq, int group,
                      int* config, cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const Kernel which = pick(dtype, sq, group);
  if (config) {
    config[0] = which;
    config[6] = DEC_MAX_SQ + 1;
    config[7] = which == DEC ? dec::STAGES : which == TCB ? 2 : 1;
  }
  if (which == DEC) return dec::run<D>(p, config, stream);
  // only dec splits the keys
  if (p && (p->splits != 1 || p->scratch)) return cudaErrorInvalidValue;
  if (which == TCB) return tcb::run<D>(p, config, stream);
  return simt::run<D>(p, config, stream);
}

cudaError_t dispatch(int dtype, int head_dim, int sq, int group,
                     const Params* p, int* config, cudaStream_t stream) {
  if (group < 1) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: return by_kernel<16>(dtype, p, sq, group, config, stream);
    case 64: return by_kernel<64>(dtype, p, sq, group, config, stream);
    case 128: return by_kernel<128>(dtype, p, sq, group, config, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The kernel a call takes: 0 = CUDA cores (simt), 1 = tensor cores (tcb),
// 2 = split-KV decode (dec); -1 for a dtype no kernel takes. group = hq /
// hkv. Touches no device.
int rtt_flash_fwd_kernel(int dtype, int sq, int group) {
  if ((dtype != 0 && dtype != 1) || group < 1) return -1;
  return pick(dtype, sq, group);
}

// dtype: 0 = float32, 1 = bfloat16; the kernel is rtt_flash_fwd_kernel's
// pick. splits: dec's key chunks (1 for the other kernels); scratch: with
// splits > 1, fp32 room for splits * b * hq * sq * (head_dim + 1) values.
// Returns a cudaError_t (0 on success); cudaErrorInvalidValue without
// launching when sq needs more query tiles than grid.y holds, or for a
// split count whose chunks of whole 64-key tiles would not cover the keys
// with none empty.
int rtt_flash_fwd(int dtype, int head_dim,
                  const void* q, const void* k, const void* v,
                  void* o, float* lse, const int* qoff,
                  int b, int sq, int sk, int hq, int hkv,
                  long long q_sb, long long q_ss, long long q_sh,
                  long long k_sb, long long k_ss, long long k_sh,
                  long long v_sb, long long v_ss, long long v_sh,
                  float scale, int causal, int splits, float* scratch,
                  void* stream) {
  Params p{q, k, v, o, lse, qoff, b, sq, sk, hq, hkv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           scale, causal, splits, 0, scratch};
  if (hkv < 1) return cudaErrorInvalidValue;
  return dispatch(dtype, head_dim, sq, hq / hkv, &p, nullptr,
                  static_cast<cudaStream_t>(stream));
}

// The kernel a call with sq query rows and GQA group hq / hkv takes on the
// current device, and its tiling: out[0] the kernel (as
// rtt_flash_fwd_kernel), out[1] query rows per block, out[2] keys per
// streamed tile, out[3] threads per block, out[4] dynamic shared memory
// bytes, out[5] blocks resident per SM, out[6] the fewest bf16 rows that
// take the tensor-core kernel at group 1, out[7] K/V stages in flight.
// Returns a cudaError_t.
int rtt_flash_fwd_config(int dtype, int head_dim, int sq, int group,
                         int* out) {
  return dispatch(dtype, head_dim, sq, group, nullptr, out, nullptr);
}

const char* rtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
