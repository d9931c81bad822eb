// Paged GQA chunk-prefill attention for Hopper (sm_90a), incremental prefill.
//
// Replaces repro/kernels/prefill_attention.py: paged_chunk_attention_pallas
// (body _chunk_kernel). The C queries of one request's prompt chunk, at
// absolute positions start..start+C-1, attend causally over that request's
// pages through one block table, with an fp32 online softmax.
//
// Bound on the H100: operations for a long chunk. The chunk does
// 4 * H * D * sum_t (start + t + 1) FLOPs (QK^T plus PV over the visible
// keys) against one read of the live pages, V * D * 2 (K and V) * 2 (bf16)
// bytes per key: at H / V = 8 query heads per KV head that is
// 16 * (start + C/2) FLOPs per byte, above the ~295 FLOP/B ridge once the
// context passes about 20 tokens. So the products run on the tensor cores
// and the key range is split so that one request's chunk fills the card.
//
// Rows. A block's 64 rows are (token, query head) pairs of one KV head: all
// g = H / V heads of 64 / g tokens, in the Pallas kernel's [V, C*G] order
// (row r: token t0 + r / g, head vh * g + r % g), so each K/V tile is read
// once for all g heads. Where g does not divide 64 the remainder rows are
// padding. Four warps hold 16 rows each; their Q fragments come from
// ldmatrix once and stay in registers.
//
// Keys. A key tile is 64 positions, copied with 16-byte cp.async straight
// from the engine's pool [frames, page, L, 2, vh, hd] through the layer
// slice's strides: each key row is D contiguous bf16 at frame * sf +
// (position in page) * st, its frame read from the block table and clamped.
// Tiles go through a three-stage ring with padded rows (conflict-free
// ldmatrix), two in flight while one computes; the Q tile waits in the
// third stage until its fragments are taken, so the ring is all the shared
// memory a block needs (about 104 KB at D 128: two blocks on an SM).
//
// Products. S = Q K^T and O += P V on mma.sync m16n8k16, bf16 in and fp32
// out, K fragments from ldmatrix and V fragments from ldmatrix.trans issued
// a few products ahead, the fragment maps of flash_attention.cu. S is
// scaled in fp32 (with log2(e) for exp2; the Pallas kernel scales q in fp32
// before its product, so the two differ by rounding only). The online
// softmax state of a thread's two rows lives in registers, reduced over the
// quad with shuffles. Masks are applied in registers, only on tiles that
// cross the first query position or the live end (a tile-uniform branch).
// P is rounded to bf16 and fed straight back as the A operand of PV (the
// Pallas kernel keeps P in fp32: the one numeric departure).
//
// Split KV. A block's keys [0, k_end) are cut into fixed spans of kSpan keys
// (four 64-key tiles at D <= 128). The bounds depend only on key position: never on
// C, start, the grid or the SM count. The grid is (token tile, KV head,
// span), and a span that starts past its tile's k_end exits at once. A tile
// with one span writes acc / max(l, 1e-30) as bf16 directly; a tile with
// more writes fp32 partials (m, l, acc) per row, and chunk_combine_kernel
// merges them in span order, skipping empty spans (l = 0) without reading
// their acc, with no atomics. A fully masked tile is an exact no-op on a
// row's (m, l, acc), and the direct write and the combine of one non-empty
// span do the same arithmetic, so a query row's output bits depend only on
// its position and the keys up to it: not on the chunk that carries it, and
// not from run to run. Spans of 256 keys give 32 x 2 x 4 = 256 blocks at the
// serving chunk (C 256, context 1024, H 16, V 2): one wave at two blocks
// per SM, where one block per tile gave 64 on 132 SMs. Spans of 2 tiles
// would double the partials the combine writes and reads; spans of 8 tiles
// would leave 128 blocks, under one block per SM.
//
// Semantics kept from the Pallas kernel: table entries clamped into
// [0, npages-1]; the caller passes context_len clamped into [0, nb*page] and
// start into [0, context_len]; a key is visible when kpos < live_end and
// kpos <= qpos, live_end = ceil(cl / page) * page (no separate length mask
// inside the last live page); masked scores are -1e30 and their
// probabilities exactly 0; l is clamped at 1e-30, so context_len 0 writes
// zeros; the key walk stops at the tile's last query position.
//
// Head dim 256 (gemma). The instance walks 32-key tiles (8 to a span, so
// the spans' bounds, and with them the bits, follow the same positions as
// at the other dims) and keeps Q in a shared tile of its own, taking each
// k-step's fragment one step ahead: the O accumulator is 128 registers a
// thread at D 256, and Q's fragments would add 64. About 134 KB of shared
// memory, above the 48 KB default (set once with cudaFuncSetAttribute):
// one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;        // (token, query head) rows per block
constexpr int kSpan = 256;       // key positions per split span
constexpr int kWarps = 4;        // 16 rows each
constexpr int kThreads = 32 * kWarps;
// padded shared rows: 8 spare bf16 (16 bytes) per row put the 8 rows of
// every ldmatrix on distinct banks
constexpr int kPad = 8;
// the K/V ring: stage i holds key tile i mod 3 as K then V, [BK][D + kPad]
// each; where the Q fragments stay in registers the Q tile waits in the
// last stage's K slot, else it has a slot of its own after the ring
constexpr int kStages = 3;
// ldmatrix loads issued ahead of the products that use them
constexpr int kPrefetch = 4;

// key positions per tile (a divisor of kSpan), and whether the Q
// fragments stay in registers for the whole key walk
template <int D>
__host__ __device__ constexpr int block_keys() { return D > 128 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr bool q_in_regs() { return D <= 128; }

struct Pool {
  const __nv_bfloat16* base;
  int sf, st, sh;  // element strides of frame, token and head (d is unit)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// keys [0, k_end) that some row of token tile x may see: the live pages,
// none past the tile's last query position. Both kernels and the host use
// it, so they agree on every tile's spans
__host__ __device__ __forceinline__ int tile_key_end(int x, int tq, int C,
                                                     int start, int live_end) {
  const int t_end = (x + 1) * tq < C ? (x + 1) * tq : C;
  return live_end < start + t_end ? live_end : start + t_end;
}

__host__ __device__ __forceinline__ int spans_of(int k_end) {
  return k_end > kSpan ? (k_end + kSpan - 1) / kSpan : 1;
}

// spans of a launch: those of its last token tile, which sees the most keys
// (the grid's depth, and what the scratch is sized for)
int launch_spans(int C, int H, int V, int page, int start, int cl) {
  const int tq = kRows / (H / V);
  const int live_end = (cl + page - 1) / page * page;
  return spans_of(tile_key_end((C - 1) / tq, tq, C, start, live_end));
}

// bf16 elements of the ring and, where it has its own slot, the Q tile
template <int D>
__host__ __device__ constexpr int tile_elems() {
  return (2 * kStages * block_keys<D>() + (q_in_regs<D>() ? 0 : kRows))
         * (D + kPad);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(tile_elems<D>())
         + sizeof(int2) * kSpan;
}

template <int D>
__device__ __forceinline__ __nv_bfloat16* stage_k(__nv_bfloat16* ring, int st) {
  return ring + 2 * st * block_keys<D>() * (D + kPad);
}

template <int D>
__device__ __forceinline__ __nv_bfloat16* stage_v(__nv_bfloat16* ring, int st) {
  return ring + (2 * st + 1) * block_keys<D>() * (D + kPad);
}

// the block's 64 query rows into a padded shared tile; padding rows (past
// the tile's tokens or the chunk) are zero-filled
template <int D>
__device__ __forceinline__ void load_q(__nv_bfloat16* dst,
                                       const __nv_bfloat16* q, int t0, int C,
                                       int g, int vh, int q_st, int q_sh,
                                       int tid) {
  constexpr int kChunks = D / 8;  // 16-byte pieces per row
  constexpr int LD = D + kPad;
  const int real = kRows / g * g;
#pragma unroll
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const int t = t0 + r / g;
    const bool ok = r < real && t < C;
    const __nv_bfloat16* src =
        ok ? q + static_cast<long long>(t) * q_st
               + static_cast<long long>(vh * g + r % g) * q_sh + c * 8
           : q;
    cp_async16(dst + r * LD + c * 8, src, ok);
  }
}

// one key tile of K and V into the ring through the block table: `rows`
// holds the tile's (frame, position in page) pairs; rows at or past n are
// zero-filled
template <int D>
__device__ __forceinline__ void load_kv(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                        Pool pk, Pool pv, const int2* rows,
                                        int n, int tid) {
  constexpr int kChunks = D / 8;
  constexpr int LD = D + kPad;
#pragma unroll
  for (int i = tid; i < block_keys<D>() * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = r < n;
    const int2 fo = ok ? rows[r] : make_int2(0, 0);
    cp_async16(ks + r * LD + c * 8,
               pk.base + static_cast<long long>(fo.x) * pk.sf
                   + static_cast<long long>(fo.y) * pk.st + c * 8, ok);
    cp_async16(vs + r * LD + c * 8,
               pv.base + static_cast<long long>(fo.x) * pv.sf
                   + static_cast<long long>(fo.y) * pv.st + c * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) chunk_split_kernel(
    const __nv_bfloat16* __restrict__ q, Pool kv_k, Pool kv_v,
    const int* __restrict__ block_table, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int C, int H, int V, int page, int npages,
    int start, int cl, int q_st, int q_sh) {
  constexpr int LD = D + kPad;
  constexpr int BK = block_keys<D>();
  constexpr bool QREG = q_in_regs<D>();
  constexpr int KS = D / 16;   // k-steps of QK^T over D
  constexpr int ND = D / 8;    // n-tiles of O over D
  constexpr int NK = BK / 8;   // n-tiles of S over a key tile
  constexpr int KI = KS * (NK / 2);         // QK^T items of a key tile
  constexpr int VI = (BK / 16) * (ND / 2);  // PV items of a key tile
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Qs = QREG ? stage_k<D>(ring, kStages - 1)  // until taken
                           : ring + 2 * kStages * BK * LD;
  int2* rows_s = reinterpret_cast<int2*>(ring + tile_elems<D>());

  const int g = H / V, tq = kRows / g;
  const int x = blockIdx.x, vh = blockIdx.y, s = blockIdx.z;
  const int t0 = x * tq;
  const int live_end = (cl + page - 1) / page * page;
  const int k_end = tile_key_end(x, tq, C, start, live_end);
  const int n_spans = spans_of(k_end);
  if (s >= n_spans) return;    // past the tile's last visible key
  const int span_lo = s * kSpan;
  // keys of this span; 0 only for a tile that sees no key (context 0)
  const int n_keys = max(0, min(k_end, span_lo + kSpan) - span_lo);
  const int nt = (n_keys + BK - 1) / BK;
  const int q_lo = start + t0;  // the tile's first query position

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, cq = lane & 3;  // mma fragment row / column pair
  const int row0 = warp * 16;
  // this block's KV head
  const Pool pk{kv_k.base + static_cast<long long>(vh) * kv_k.sh, kv_k.sf,
                kv_k.st, kv_k.sh};
  const Pool pv{kv_v.base + static_cast<long long>(vh) * kv_v.sh, kv_v.sf,
                kv_v.st, kv_v.sh};

  // the span's keys as (frame, position in page), table entries clamped
  // into the pool; kpos < k_end <= nb * page keeps j inside the table
  for (int r = tid; r < n_keys; r += kThreads) {
    const int kpos = span_lo + r, j = kpos / page;
    rows_s[r] = make_int2(min(max(block_table[j], 0), npages - 1),
                          kpos - j * page);
  }
  __syncthreads();

  // prologue: Q with the first key tile, then the second key tile
  if (nt > 0) {
    load_q<D>(Qs, q, t0, C, g, vh, q_st, q_sh, tid);
    load_kv<D>(stage_k<D>(ring, 0), stage_v<D>(ring, 0), pk, pv, rows_s,
               min(BK, n_keys), tid);
    cp_async_commit();
    if (nt > 1)
      load_kv<D>(stage_k<D>(ring, 1), stage_v<D>(ring, 1), pk, pv,
                 rows_s + BK, min(BK, n_keys - BK), tid);
    cp_async_commit();
  }

  // this thread's rows gq and gq + 8 of its warp: query positions, -1 for
  // padding rows (masked on every edge tile; never written)
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gq + 8 * r;
    const int t = t0 + row / g;
    qpos[r] = (row < tq * g && t < C) ? start + t : -1;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};  // log2 domain
  float l_run[2] = {0.0f, 0.0f};         // this thread's columns only

  // Q fragments: all k-steps in registers, or a two-step ring of them
  // filled from the shared Q tile one k-step ahead
  unsigned qa[QREG ? KS : 2][4];
  const int q_frag = (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                   + (lane >> 4) * 8;
  // this lane's ldmatrix row address within a K (x4) or V (x4.trans) item
  const int k_frag = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int v_frag = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  for (int i = 0; i < nt; ++i) {
    const int st = i % kStages;
    cp_async_wait<1>();  // tile i is here; tile i + 1 may be in flight
    __syncthreads();     // ... for every thread, and tile i - 1 is done
    if (QREG && i == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qa[ks], Qs + q_frag + ks * 16);
      __syncthreads();   // Q's slot is the third stage, refilled next
    }
    // keep two tiles in flight: tile i + 2 goes where tile i - 1 was
    if (i + 2 < nt) {
      const int nx = (i + 2) % kStages;
      load_kv<D>(stage_k<D>(ring, nx), stage_v<D>(ring, nx), pk, pv,
                 rows_s + (i + 2) * BK, min(BK, n_keys - (i + 2) * BK), tid);
    }
    cp_async_commit();
    const __nv_bfloat16* Kt = stage_k<D>(ring, st);
    const __nv_bfloat16* Vt = stage_v<D>(ring, st);

    // S = Q K^T over this key tile: rows gq, gq + 8; keys 8n + 2cq + {0,1}.
    // Item i is (k-step i / (NK/2), key pair i % (NK/2)); each item's K
    // fragments are loaded kPrefetch items ahead of its two products
    float sc[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
    unsigned fr[kPrefetch][4];
    if (!QREG) ldsm_x4(qa[0], Qs + q_frag);
#pragma unroll
    for (int j = 0; j < kPrefetch && j < KI; ++j)
      ldsm_x4(fr[j], Kt + k_frag + (j % (NK / 2)) * 16 * LD + (j / (NK / 2)) * 16);
#pragma unroll
    for (int j = 0; j < KI; ++j) {
      const int ks = j / (NK / 2), n2 = j % (NK / 2), f = j % kPrefetch;
      if (!QREG && n2 == 0 && ks + 1 < KS)
        ldsm_x4(qa[(ks + 1) & 1], Qs + q_frag + (ks + 1) * 16);
      const int qi = QREG ? ks : (ks & 1);
      mma_bf16(sc[2 * n2], qa[qi], fr[f][0], fr[f][1]);
      mma_bf16(sc[2 * n2 + 1], qa[qi], fr[f][2], fr[f][3]);
      if (j + kPrefetch < KI) {
        const int jj = j + kPrefetch;
        ldsm_x4(fr[f], Kt + k_frag + (jj % (NK / 2)) * 16 * LD + (jj / (NK / 2)) * 16);
      }
    }
    // the first V fragments load while the softmax runs
#pragma unroll
    for (int j = 0; j < kPrefetch && j < VI; ++j)
      ldsm_x4_trans(fr[j], Vt + v_frag + (j / (ND / 2)) * 16 * LD + (j % (ND / 2)) * 16);

    // scale in fp32 (never fused into a later add, so a score's bits do not
    // depend on whether its tile is masked), mask in registers where the
    // tile crosses the first query position or the live end
    const int k_lo = span_lo + i * BK;
    const bool edge = k_lo + BK > live_end || k_lo + BK - 1 > q_lo;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = __fmul_rn(sc[n][e], scale_log2);
        if (edge) {
          const int kpos = k_lo + n * 8 + 2 * cq + (e & 1);
          if (!(kpos < live_end && kpos <= qpos[e >> 1])) v = kNegInf;
        }
        sc[n][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    // P = exp(S - m); a masked score gives exactly 0, even on a row that
    // has seen no visible key yet (where m is still -1e30)
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = sc[n][e];
        const float p = v == kNegInf ? 0.0f : exp2f(v - m_run[e >> 1]);
        sc[n][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P (bf16) from the S registers as the A operand. Item i is
    // (key step i / (ND/2), d pair i % (ND/2)), its V fragments loaded
    // kPrefetch items ahead
    unsigned pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
    }
#pragma unroll
    for (int j = 0; j < VI; ++j) {
      const int kk = j / (ND / 2), n2 = j % (ND / 2), f = j % kPrefetch;
      mma_bf16(acc[2 * n2], pa[kk], fr[f][0], fr[f][1]);
      mma_bf16(acc[2 * n2 + 1], pa[kk], fr[f][2], fr[f][3]);
      if (j + kPrefetch < VI) {
        const int jj = j + kPrefetch;
        ldsm_x4_trans(fr[f], Vt + v_frag + (jj / (ND / 2)) * 16 * LD + (jj % (ND / 2)) * 16);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  // partial rows per KV head: C * g, in the Pallas [V, C*G] order
  const long long rows_v = static_cast<long long>(C) * g;
  const long long n_part = static_cast<long long>(gridDim.z) * V * rows_v;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] < 0) continue;
    const int row = row0 + gq + 8 * r;
    if (n_spans == 1) {
      // out [C, H, D] contiguous: the layout attn_out reads
      const int t = t0 + row / g, h = vh * g + row % g;
      const float inv = 1.0f / fmaxf(l_run[r], 1e-30f);
      __nv_bfloat16* orow = out + (static_cast<long long>(t) * H + h) * D + 2 * cq;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
            acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    } else {
      const long long R = (static_cast<long long>(s) * V + vh) * rows_v
                        + static_cast<long long>(t0) * g + row;
      float* arow = part + R * D + 2 * cq;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(arow + n * 8) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      if (cq == 0) {  // the quad agrees on m and l
        part[n_part * D + R] = m_run[r];
        part[n_part * D + n_part + R] = l_run[r];
      }
    }
  }
}

// grid (C, V): the g rows of token t under KV head vh, where t's tile has
// more than one span. Merges the spans in order: the largest m of the
// non-empty spans, each span's weight, the sums
__global__ void __launch_bounds__(kThreads) chunk_combine_kernel(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ out, int C,
    int H, int V, int D, int page, int start, int cl, int S) {
  const int t = blockIdx.x, vh = blockIdx.y;
  const int g = H / V, tq = kRows / g;
  const int live_end = (cl + page - 1) / page * page;
  const int n_spans = spans_of(tile_key_end(t / tq, tq, C, start, live_end));
  if (n_spans == 1) return;  // the split kernel wrote these rows
  const long long rows_v = static_cast<long long>(C) * g;
  const long long n_part = static_cast<long long>(S) * V * rows_v;
  const float* p_m = part + n_part * D;
  const float* p_l = p_m + n_part;
  const long long step = static_cast<long long>(V) * rows_v;  // next span
  const int d4 = D / 4;
  for (int i = threadIdx.x; i < g * d4; i += kThreads) {
    const int gi = i / d4, c = i - gi * d4;
    const long long r0 = static_cast<long long>(vh) * rows_v
                       + static_cast<long long>(t) * g + gi;
    float m = kNegInf;
    for (int sp = 0; sp < n_spans; ++sp) {
      const long long r = r0 + sp * step;
      if (p_l[r] > 0.0f) m = fmaxf(m, p_m[r]);
    }
    float l = 0.0f;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int sp = 0; sp < n_spans; ++sp) {
      const long long r = r0 + sp * step;
      const float ls = p_l[r];
      if (ls > 0.0f) {  // an empty span left no visible key: never read
        const float w = exp2f(p_m[r] - m);
        const float4 ps = *reinterpret_cast<const float4*>(part + r * D + 4 * c);
        l = fmaf(ls, w, l);
        a.x = fmaf(ps.x, w, a.x);
        a.y = fmaf(ps.y, w, a.y);
        a.z = fmaf(ps.z, w, a.z);
        a.w = fmaf(ps.w, w, a.w);
      }
    }
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    __nv_bfloat16* o = out + (static_cast<long long>(t) * H + vh * g + gi) * D + 4 * c;
    reinterpret_cast<__nv_bfloat162*>(o)[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
    reinterpret_cast<__nv_bfloat162*>(o)[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
  }
}

// the dynamic shared-memory attribute, set once per template instance
template <int D>
cudaError_t prepare() {
  static const cudaError_t err =
      smem_bytes<D>() > 48 * 1024
          ? cudaFuncSetAttribute(chunk_split_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem_bytes<D>()))
          : cudaSuccess;
  return err;
}

template <int D>
int launch(const void* q, Pool kv_k, Pool kv_v, const void* bt, void* part,
           void* out, int C, int H, int V, int page, int npages, int start,
           int cl, int q_st, int q_sh, cudaStream_t stream) {
  const cudaError_t err = prepare<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tq = kRows / (H / V);
  const int S = launch_spans(C, H, V, page, start, cl);
  if (S > 1 && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((C + tq - 1) / tq, V, S);
  chunk_split_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), kv_k, kv_v,
      static_cast<const int*>(bt), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), C, H, V, page, npages, start, cl, q_st, q_sh);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess || S == 1) return static_cast<int>(e1);
  chunk_combine_kernel<<<dim3(C, V), kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), C, H,
      V, D, page, start, cl, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Spans of a launch: the wrapper sizes its scratch by it. C >= 1, H / V at
// most 64; start and cl come clamped, as for paged_chunk_attention_bf16.
extern "C" int paged_chunk_splits(int C, int H, int V, int page, int start,
                                  int cl) {
  return launch_spans(C, H, V, page, start, cl);
}

// q [C,H,D] addressed as t*q_st + h*q_sh + d; pages addressed as
// base + frame*sf + token*st + head*sh + d; the 16-byte copies need q and
// the pages 16-byte aligned with strides in multiples of 8 elements (the
// wrapper checks). block_table [nb] int32; out [C,H,D] contiguous; part an
// fp32 scratch of S*V*C*(H/V)*(D+2) floats, S = paged_chunk_splits(...),
// unused (may be null) when S is 1. start and cl come clamped by the
// caller. D must be 16, 32, 64, 128 or 256 and H / V at most 64. Launches on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for
// unsupported shapes.
extern "C" int paged_chunk_attention_bf16(
    const void* q, const void* k, const void* v, const void* block_table,
    void* part, void* out, int C, int H, int V, int D, int page, int nb,
    int npages, int start, int cl, int q_st, int q_sh, int k_sf, int k_st,
    int k_sh, int v_sf, int v_st, int v_sh, void* stream) {
  if (V <= 0 || H % V != 0 || H / V > kRows || C <= 0 || npages <= 0
      || cl > nb * page)
    return static_cast<int>(cudaErrorInvalidValue);
  const Pool kv_k{static_cast<const __nv_bfloat16*>(k), k_sf, k_st, k_sh};
  const Pool kv_v{static_cast<const __nv_bfloat16*>(v), v_sf, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, kv_k, kv_v, block_table, part, out, C, H, V, page, npages, start, cl, q_st, q_sh, st);
    case 32: return launch<32>(q, kv_k, kv_v, block_table, part, out, C, H, V, page, npages, start, cl, q_st, q_sh, st);
    case 64: return launch<64>(q, kv_k, kv_v, block_table, part, out, C, H, V, page, npages, start, cl, q_st, q_sh, st);
    case 128: return launch<128>(q, kv_k, kv_v, block_table, part, out, C, H, V, page, npages, start, cl, q_st, q_sh, st);
    case 256: return launch<256>(q, kv_k, kv_v, block_table, part, out, C, H, V, page, npages, start, cl, q_st, q_sh, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
