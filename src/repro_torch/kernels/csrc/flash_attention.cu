// Flash attention forward for Hopper (sm_90a), prefill path.
//
// Replaces repro/kernels/flash_attention.py: flash_attention_pallas (body
// _flash_kernel). Dense attention with causal, sliding-window and kv_len
// masks; pos_offset aligns the queries to the last Sq keys; GQA maps query
// head h to KV head h / (H / V); fp32 online softmax, bf16 in and out.
//
// Bound on the H100: operations for long prompts. Under the causal mask a
// prefill does about 2 * B * H * Sq * Sk * D FLOPs (QK^T plus PV, halved by
// the mask) against O((Sq + Sk) * D) bytes, so the products belong on the
// tensor cores. Design (FlashAttention-2 on mma.sync m16n8k16, bf16 in,
// fp32 accumulate): one block of 4 warps per (query tile of 64 rows, head,
// batch row), each warp owning 16 query rows. The Q fragments are taken
// with ldmatrix once and stay in registers for the whole key walk. Key
// tiles of 64 go through cp.async into a three-stage shared ring with
// padded rows (conflict-free ldmatrix): the next two tiles' copies are in
// flight while one computes, so one barrier per tile suffices, and the Q
// tile waits in the third stage until its fragments are taken, so the
// ring is all the shared memory a block needs (two blocks fit on an SM).
// K fragments come from ldmatrix and V fragments from ldmatrix.trans, each
// issued a few products ahead of its use: the asm statements keep program
// order, and a heavy causal tile shares its SM with at most one light one,
// so a warp has to hide its own load latency. S = Q K^T accumulates in
// fp32 registers from the unscaled bf16 q and k and is scaled in fp32
// (folded with log2(e) for exp2). Masks are applied in registers, only on
// tiles that cross a mask edge; whole tiles are pruned exactly as
// _flash_kernel prunes them. Each thread keeps the online softmax state of
// its two rows, reduced over the quad with shuffles. P is rounded to bf16
// in registers and fed straight back as the A operand of the PV product
// (Pallas keeps P in fp32: the one numeric departure). O accumulates in
// fp32 registers and is normalised by max(l, 1e-30). Tile sizes are
// constants, and every reduction runs in a fixed order with no atomics, so
// the output bits do not depend on the shape of the call. Heavy causal
// tiles launch first.
//
// Head dim 256 (gemma, paligemma). At D 256 the O accumulator alone is 16
// rows x 256 fp32 per warp, 128 registers a thread, and the Q fragments of
// the smaller dims would add 64 more: the instance keeps Q in a shared
// tile of its own and takes each k-step's fragment with ldmatrix one step
// ahead, and walks 32-key tiles, so the scores, the P fragments and the
// ring's fragments stay near 50 registers. Its shared memory (a three-
// stage ring of 32-key K/V tiles plus the Q tile, 132 KB) is above the
// 48 KB default, set per launch with cudaFuncSetAttribute; one block fits
// on an SM. The arithmetic per key and its order are those of the other
// dims.

#include <cuda.h>     // CUtensorMap and its encoder's enums (the encoder is
                      // looked up in the loaded libcuda at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBQ = 64;
constexpr int kWarps = 4;  // 16 query rows each
constexpr int kThreads = 32 * kWarps;

// key positions per tile, and whether the Q fragments stay in registers
// for the whole key walk (else they come from a shared Q tile per k-step)
template <int D>
__host__ __device__ constexpr int block_keys() { return D > 128 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr bool q_in_regs() { return D <= 128; }

struct Strides {
  int b, h, s;  // element strides of batch, head and sequence (d is unit)
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

__device__ __forceinline__ bool visible(int qpos, int kpos, int kv_len,
                                        int causal, int window) {
  bool ok = kpos < kv_len;
  if (causal) {
    ok = ok && kpos <= qpos;
    if (window > 0) ok = ok && kpos > qpos - window;
  }
  return ok;
}

// _flash_kernel's block-level pruning: a key tile runs unless the masks
// leave it empty for every row of the query tile
__device__ __forceinline__ bool tile_live(int k_lo, int bk, int q_lo,
                                          int q_hi, int kv_len, int causal,
                                          int window) {
  bool live = k_lo < kv_len;
  if (causal) {
    live = live && k_lo <= q_hi;
    if (window > 0) live = live && k_lo + bk - 1 > q_lo - window;
  }
  return live;
}

// padded shared rows: 8 spare bf16 (16 bytes) per row put the 8 rows of
// every ldmatrix on distinct banks
constexpr int kPad = 8;
// the K/V ring: stage i holds key tile i mod 3 as K then V, [BK][D + kPad]
// each; where the Q fragments stay in registers, the Q tile waits in the
// last stage's K slot until they are taken, else it has a slot of its own
// after the ring
constexpr int kStages = 3;
// ldmatrix loads issued ahead of the products that use them
constexpr int kPrefetch = 4;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16)
         * static_cast<size_t>(2 * kStages * block_keys<D>()
                               + (q_in_regs<D>() ? 0 : kBQ))
         * (D + kPad);
}

template <int D>
__device__ __forceinline__ __nv_bfloat16* stage_k(__nv_bfloat16* ring, int st) {
  return ring + 2 * st * block_keys<D>() * (D + kPad);
}

template <int D>
__device__ __forceinline__ __nv_bfloat16* stage_v(__nv_bfloat16* ring, int st) {
  return ring + (2 * st + 1) * block_keys<D>() * (D + kPad);
}

// rows [r0, r0 + ROWS) of a [S, D] slice into a padded shared tile; rows
// at or past `limit` are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int limit, int stride, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte pieces per row
  constexpr int LD = D + kPad;
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = r0 + r < limit;
    const __nv_bfloat16* g = ok ? src + static_cast<long long>(r0 + r) * stride + c * 8
                                : src;
    cp_async16(dst + r * LD + c * 8, g, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int H, int V, int Sq, int Sk, int kv_len,
    int causal, int window, int pos_off, Strides qs_, Strides ks_,
    Strides vs_, Strides os_) {
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

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest causal tiles first
  const int kvh = h / (H / V);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;    // mma fragment row / column pair
  const int q0 = qt * kBQ;

  const __nv_bfloat16* qb = q + static_cast<long long>(b) * qs_.b
                          + static_cast<long long>(h) * qs_.h;
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * ks_.b
                          + static_cast<long long>(kvh) * ks_.h;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * vs_.b
                          + static_cast<long long>(kvh) * vs_.h;
  __nv_bfloat16* ob = o + static_cast<long long>(b) * os_.b
                    + static_cast<long long>(h) * os_.h;

  // the live key tiles form one contiguous run: each mask keeps a prefix
  // or a suffix of the tiles
  const int q_lo = q0 + pos_off, q_hi = q_lo + kBQ - 1;
  const int nk = (Sk + BK - 1) / BK;
  int jt_begin = nk, jt_end = 0;
  for (int jt = 0; jt < nk; ++jt) {
    if (tile_live(jt * BK, BK, q_lo, q_hi, kv_len, causal, window)) {
      jt_begin = min(jt_begin, jt);
      jt_end = jt + 1;
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};  // rows gq and gq + 8, log2 domain
  float l_run[2] = {0.0f, 0.0f};         // this thread's columns only

  // prologue: Q with the first key tile, then the second key tile
  if (jt_begin < jt_end) {
    load_tile<D, kBQ>(Qs, qb, q0, Sq, qs_.s, tid);
    load_tile<D, BK>(stage_k<D>(ring, 0), kb, jt_begin * BK, Sk, ks_.s, tid);
    load_tile<D, BK>(stage_v<D>(ring, 0), vb, jt_begin * BK, Sk, vs_.s, tid);
    cp_async_commit();
    if (jt_begin + 1 < jt_end) {
      load_tile<D, BK>(stage_k<D>(ring, 1), kb, (jt_begin + 1) * BK, Sk, ks_.s, tid);
      load_tile<D, BK>(stage_v<D>(ring, 1), vb, (jt_begin + 1) * BK, Sk, vs_.s, tid);
    }
    cp_async_commit();
  }

  // Q fragments: all k-steps in registers, or a two-step ring of them
  // filled from the shared Q tile one k-step ahead
  unsigned qa[QREG ? KS : 2][4];
  const int row0 = warp * 16;
  const int q_frag = (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                   + (lane >> 4) * 8;
  // this lane's ldmatrix row address within a K (x4) or V (x4.trans) item
  const int k_frag = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int v_frag = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  for (int jt = jt_begin; jt < jt_end; ++jt) {
    const int i = jt - jt_begin, st = i % kStages;
    cp_async_wait<1>();  // tile jt is here; tile jt + 1 may be in flight
    __syncthreads();     // ... for every thread, and tile jt - 1 is done
    if (QREG && i == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qa[ks], Qs + q_frag + ks * 16);
      __syncthreads();   // Q's slot is the third stage, refilled next
    }
    // keep two tiles in flight: tile jt + 2 goes where tile jt - 1 was
    if (jt + 2 < jt_end) {
      const int nx = (i + 2) % kStages;
      load_tile<D, BK>(stage_k<D>(ring, nx), kb, (jt + 2) * BK, Sk, ks_.s, tid);
      load_tile<D, BK>(stage_v<D>(ring, nx), vb, (jt + 2) * BK, Sk, vs_.s, tid);
    }
    cp_async_commit();
    const __nv_bfloat16* Kt = stage_k<D>(ring, st);
    const __nv_bfloat16* Vt = stage_v<D>(ring, st);

    // S = Q K^T over this key tile: rows gq, gq + 8; keys 8n + 2tq + {0,1}.
    // Item i is (k-step i / (NK/2), key pair i % (NK/2)); each item's K
    // fragments are loaded kPrefetch items ahead of its two products
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    unsigned fr[kPrefetch][4];
    if (!QREG) ldsm_x4(qa[0], Qs + q_frag);
#pragma unroll
    for (int i = 0; i < kPrefetch && i < KI; ++i)
      ldsm_x4(fr[i], Kt + k_frag + (i % (NK / 2)) * 16 * LD + (i / (NK / 2)) * 16);
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const int ks = i / (NK / 2), n2 = i % (NK / 2), f = i % kPrefetch;
      if (!QREG && n2 == 0 && ks + 1 < KS)
        ldsm_x4(qa[(ks + 1) & 1], Qs + q_frag + (ks + 1) * 16);
      const int qi = QREG ? ks : (ks & 1);
      mma_bf16(s[2 * n2], qa[qi], fr[f][0], fr[f][1]);
      mma_bf16(s[2 * n2 + 1], qa[qi], fr[f][2], fr[f][3]);
      if (i + kPrefetch < KI) {
        const int j = i + kPrefetch;
        ldsm_x4(fr[f], Kt + k_frag + (j % (NK / 2)) * 16 * LD + (j / (NK / 2)) * 16);
      }
    }
    // the first V fragments load while the softmax runs
#pragma unroll
    for (int i = 0; i < kPrefetch && i < VI; ++i)
      ldsm_x4_trans(fr[i], Vt + v_frag + (i / (ND / 2)) * 16 * LD + (i % (ND / 2)) * 16);

    // scale in fp32, mask in registers where the tile crosses a mask edge
    const int k_lo = jt * BK;
    const bool edge = k_lo + BK - 1 >= kv_len
        || (causal && (k_lo + BK - 1 > q_lo
                       || (window > 0 && k_lo <= q_hi - window)));
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int qpos = q_lo + row0 + gq + (e >> 1) * 8;
          const int kpos = k_lo + n * 8 + 2 * tq + (e & 1);
          if (!visible(qpos, kpos, kv_len, causal, window)) x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
        const float x = s[n][e];
        const float p = x == kNegInf ? 0.0f : exp2f(x - m_run[e >> 1]);
        s[n][e] = p;
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
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int i = 0; i < VI; ++i) {
      const int kk = i / (ND / 2), n2 = i % (ND / 2), f = i % kPrefetch;
      mma_bf16(acc[2 * n2], pa[kk], fr[f][0], fr[f][1]);
      mma_bf16(acc[2 * n2 + 1], pa[kk], fr[f][2], fr[f][3]);
      if (i + kPrefetch < VI) {
        const int j = i + kPrefetch;
        ldsm_x4_trans(fr[f], Vt + v_frag + (j / (ND / 2)) * 16 * LD + (j % (ND / 2)) * 16);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + gq + r * 8;
    if (row >= Sq) continue;
    // the row's natural-log sum of exponents, for the backward (training
    // only: the serving path passes no buffer)
    if (lse != nullptr && tq == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + row] =
          (m_run[r] + log2f(l_run[r])) * kLn2;
    __nv_bfloat16* orow = ob + static_cast<long long>(row) * os_.s + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * r] / l_run[r], acc[n][2 * r + 1] / l_run[r]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int V, int Sq, int Sk, int kv_len, int causal,
           int window, int pos_off, Strides qs_, Strides ks_, Strides vs_,
           Strides os_, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, os_);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B,H,Sq,D], k/v [B,V,Sk,D], o [B,H,Sq,D], each addressed through its
// (batch, head, sequence) element strides with unit stride along D. The
// 16-byte copies need q, k and v 16-byte aligned with strides in multiples
// of 8 elements (the wrapper checks). D must be 16, 32, 64, 128 or 256.
// lse, when not null, receives each query row's natural-log sum of
// exponents as fp32 [B,H,Sq] (contiguous), which the backward reads; the
// output bits do not depend on it.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an unsupported D.
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int V,
    int Sq, int Sk, int D, int kv_len, int causal, int window, int pos_off,
    int q_sb, int q_sh, int q_ss, int k_sb, int k_sh, int k_ss, int v_sb,
    int v_sh, int v_ss, int o_sb, int o_sh, int o_ss, void* stream) {
  const Strides qs_{q_sb, q_sh, q_ss}, ks_{k_sb, k_sh, k_ss};
  const Strides vs_{v_sb, v_sh, v_ss}, os_{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, l, B, H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, os_, st);
    case 32: return launch<32>(q, k, v, o, l, B, H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, os_, st);
    case 64: return launch<64>(q, k, v, o, l, B, H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, os_, st);
    case 128: return launch<128>(q, k, v, o, l, B, H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, os_, st);
    case 256: return launch<256>(q, k, v, o, l, B, H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, os_, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// Flash attention backward (training): dQ, dK and dV of the forward above.
//
// Differentiates repro/kernels/flash_attention.py: flash_attention_pallas,
// whose gradient the reference takes with jax.grad of its jnp twin
// attn_chunked (repro/models/layers.py). Same masks, GQA and strides as the
// forward; D 16, 32, 64, 128 and 256.
//
// Bound on the H100: operations. With P recomputed from Q, K and the
// forward's log-sum-exp, the backward runs five products (Q K^T, dO V^T,
// P^T dO, dS^T Q, dS K) against the forward's two; the dQ pass recomputes
// the first two, so seven run. Every product is a Hopper warpgroup product
// (wgmma m64nNk16, bf16 in, fp32 accumulate) on tiles that TMA copies into
// 128-byte-swizzled shared memory (64- and 32-byte swizzles at D 32 and 16),
// kept full by a producer through an mbarrier ring. Four launches, no
// atomics anywhere, so the gradients are bitwise repeatable:
//   1. prep: Delta = rowsum(dO * O) and the log-sum-exp in the log2 domain,
//      each fp32 [B, H, Sq rounded up to 64], one warp per row; padding rows
//      get Delta 0 and kPadLse, so their P is exactly 0;
//   2. dK/dV: a block of one consumer and one producer warpgroup holds a
//      64-key tile of K and V and walks a *unit* of its items, an item
//      being one query head of the group times one live 64-query tile,
//      heads outermost. Each key tile's items are split near-evenly into
//      units of at most C, so a group's query heads (or, at g 1, its query
//      range) spread over several blocks: C, from the shape and the SM
//      count, is the least that keeps the blocks within two per SM (one
//      fits on an SM at a time), so every SM takes about as many items.
//      The trade-off: a smaller C balances better but each unit writes its
//      fp32 partial dK and dV (64 keys x D x 8 bytes) to scratch and the
//      combine reads them back. Per item the consumer forms
//      S^T = K Q^T and dP^T = V dO^T with wgmma (A = the K or V tile, B =
//      the stage's Q or dO tile, both K-major; each accumulator starts from
//      its column's -LSE / scale or -Delta), P^T = exp2(S^T scale) under
//      the masks and dS^T = P^T (dP^T - Delta) in the accumulator
//      registers, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as
//      bf16 A operands straight from those registers (the first product's
//      accumulator layout is the register A layout of the second) and dO,
//      Q as MN-major B tiles. At D 256 the two fp32 accumulators (64 keys x 256
//      each) exceed a warpgroup's registers, so each unit runs as two
//      blocks (blockIdx.z), each owning half of D for dK and dV and both
//      forming S^T and dP^T over the whole D: 2 of the 5 products run
//      twice. (32-key tiles, the forward's answer at D 256, do not suit
//      wgmma, whose M is 64.) The producer drops to 24 registers with
//      setmaxnreg and the consumer rises to 240 (dK, dV, S^T and dP^T are
//      192 of them): no spills. A ring of four stages (two at D 256) keeps
//      the next items' Q, dO, LSE and Delta in flight;
//   3. combine: per key row, the units' partials summed in unit order (unit
//      0 first), dK times 1/sqrt(D), written bf16; zero where no query sees
//      the key;
//   4. dQ: one block of one consumer warpgroup and a producer warp per
//      (64-query tile, head, batch row), heaviest causal tiles first, holds
//      its Q and dO tiles and walks the live 64-key tiles through a
//      two-stage ring: S = Q K^T and dP = dO V^T again, dS in registers,
//      dQ += dS K with K as an MN-major B tile (two blocks an SM at D <=
//      128, one at D 256, where dQ alone is 128 registers).
// The 1/sqrt(D) scale is applied to the fp32 scores and to dQ and dK at the
// end. Whole tiles are pruned exactly as in the forward, and masks are
// applied in registers only on tiles that cross a mask edge. P and dS are
// rounded to bf16 as product operands, as the forward rounds P.
// ---------------------------------------------------------------------------

namespace {

constexpr int kBwdRows = 64;      // rows of every tile: a warpgroup's M
constexpr int kWarpgroup = 128;
constexpr int kBwdStages = 2;     // the dQ producer's ring
// the log-sum-exp of a padding query row: its P underflows to exactly 0
constexpr float kPadLse = 1e30f;

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
// floor(a / b) for b > 0
__host__ __device__ inline int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// a [64 rows][D] bf16 tile as TMA writes it and wgmma reads it: D cut into
// chunks of one swizzle row (min(2D, 128) bytes), each chunk a [64][chunk]
// swizzled block
template <int D>
struct Tile {
  static constexpr int kRowBytes = D * 2 >= 128 ? 128 : D * 2;
  static constexpr int kChunk = kRowBytes / 2;        // elements
  static constexpr int kChunks = D / kChunk;
  static constexpr int kChunkBytes = kBwdRows * kRowBytes;
  static constexpr int kBytes = kBwdRows * D * 2;
  // wgmma descriptor swizzle mode: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
};

// The shape and masks of a backward call, and its dK/dV units.
struct BwdArgs {
  int B, H, V, Sq, Sk, kv_len, causal, window, pos_off;
  int nq;            // 64-query tiles
  int sq_pad;        // Sq rounded up to 64: rows of the prep buffers
  int nkb;           // 64-key tiles
  int halves;        // dK/dV blocks per unit: 2 at D 256 (one per D half)
  int per_unit;      // C: items of a unit at most
  int units;         // units of one (batch row, KV head)
};

// the run of 64-query tiles [begin, begin + count) that sees a key of the
// 64-key tile starting at k0: _flash_kernel's tile pruning solved for the tile
// index (each mask keeps a prefix or a suffix of the tiles)
__host__ __device__ inline int live_q_tiles(const BwdArgs& a, int k0,
                                            int& begin) {
  begin = 0;
  if (k0 >= a.kv_len) return 0;
  const int k_last = imin(k0 + kBwdRows, a.kv_len) - 1;
  int end = a.nq;
  if (a.causal) {
    // some query of the tile at or after k0: pos_off + 64 qt + 63 >= k0
    begin = imax(0, -floor_div(a.pos_off + kBwdRows - 1 - k0, kBwdRows));
    // and k_last inside its window: pos_off + 64 qt < k_last + window
    if (a.window > 0)
      end = imin(end, floor_div(k_last + a.window - 1 - a.pos_off, kBwdRows) + 1);
  }
  return imax(end - begin, 0);
}

// items of 64-key tile kb (g heads x its live query tiles) and its units
__host__ __device__ inline int block_units(const BwdArgs& a, int kb, int& qt0,
                                           int& nqt, int& items) {
  nqt = live_q_tiles(a, kb * kBwdRows, qt0);
  items = (a.H / a.V) * nqt;
  return (items + a.per_unit - 1) / a.per_unit;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// -- mbarriers, TMA --------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed; a wait past 10 s
// (no copy or product of these kernels comes near) traps, so a fault shows
// as a launch error rather than a card that never finishes
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > 10000000000ull) __trap();
  }
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a contiguous run of bytes (a multiple of 16, 16-byte aligned) into
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the D chunks of one 64-row tile of a [B, heads, S, D] map
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int row, int head,
                                         int b) {
  using T = Tile<D>;
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c)
    tma_load(dst + c * T::kChunkBytes, map, bar, c * T::kChunk, row, head, b);
}

// -- warpgroup products ----------------------------------------------------

__device__ __forceinline__ uint64_t gmma_desc(unsigned addr, unsigned lbo,
                                              unsigned sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16
         | static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32
         | static_cast<uint64_t>(layout) << 62;
}

// descriptors of a tile at shared address t read K-major (rows are M or
// N, D is the contraction) or MN-major as a B operand (D is N, the 64 rows
// are the contraction; N runs on from one chunk to the next LBO apart);
// each k-step's descriptor is the tile's plus a constant offset
template <int D>
__device__ __forceinline__ uint64_t desc_k(unsigned t) {
  using T = Tile<D>;
  return gmma_desc(t, 16, 8 * T::kRowBytes, T::kLayout);
}
template <int D>
__device__ __forceinline__ uint64_t desc_mn(unsigned t) {
  using T = Tile<D>;
  return gmma_desc(t, T::kChunkBytes, 8 * T::kRowBytes, T::kLayout);
}
// K-major k-step ks: D columns [16 ks, 16 ks + 16)
template <int D>
__device__ __forceinline__ uint64_t step_k(uint64_t desc, int ks) {
  using T = Tile<D>;
  const int col = ks * 16;
  return desc + (((col / T::kChunk) * T::kChunkBytes + (col % T::kChunk) * 2) >> 4);
}
// MN-major k-step kk: rows [16 kk, 16 kk + 16), N from chunk c0 on
template <int D>
__device__ __forceinline__ uint64_t step_mn(uint64_t desc, int kk, int c0) {
  using T = Tile<D>;
  return desc + ((c0 * T::kChunkBytes + kk * 16 * T::kRowBytes) >> 4);
}
// a value the compiler cannot hoist out of the loop that computes it: the
// K and V tiles' descriptors are rebuilt per item rather than held in
// registers (16 k-steps' worth) across the walk
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// 2^x in one special-function instruction, subnormal results flushed to
// zero (P's smallest values; they vanish in the bf16 products anyway)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keep the compiler from moving reads of an accumulator across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d[64 x 64] (+)= A * B^T: A and B 64-row K-major tiles in shared memory
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x N] += A * B: A (64 x 16, bf16) in registers in the accumulator's
// row layout, B an MN-major (N contiguous) tile in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const unsigned (&a)[4],
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const unsigned (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const unsigned (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const unsigned (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const unsigned (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const unsigned (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// -- the four kernels ------------------------------------------------------

// Delta[b, h, row] = sum_d dO * O and lse2 = lse * log2(e), both fp32
// [B, H, sq_pad]; padding rows get 0 and kPadLse. One warp per row.
__global__ void __launch_bounds__(kThreads) flash_bwd_prep_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dO,
    const float* __restrict__ lse, float* __restrict__ lse2,
    float* __restrict__ delta, int H, int Sq, int sq_pad, int D, Strides os_,
    Strides dos_) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z, lane = threadIdx.x & 31;
  if (row >= sq_pad) return;
  float acc = 0.0f;
  if (row < Sq) {
    const __nv_bfloat16* orow = o + static_cast<long long>(b) * os_.b
        + static_cast<long long>(h) * os_.h + static_cast<long long>(row) * os_.s;
    const __nv_bfloat16* drow = dO + static_cast<long long>(b) * dos_.b
        + static_cast<long long>(h) * dos_.h
        + static_cast<long long>(row) * dos_.s;
    for (int d = lane; d < D; d += 32)
      acc += __bfloat162float(orow[d]) * __bfloat162float(drow[d]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    const long long at = (static_cast<long long>(b) * H + h) * sq_pad + row;
    delta[at] = acc;
    lse2[at] = row < Sq
        ? lse[(static_cast<long long>(b) * H + h) * Sq + row] * kLog2e : kPadLse;
  }
}

// shared memory of the dK/dV block, from a 1024-byte aligned base: its K
// and V tiles, the ring's Q and dO tiles, LSE and Delta rows, barriers
template <int D>
struct DkdvSmem {
  // D columns of dK and dV a block accumulates: all, or at D 256 one half
  // (blockIdx.z), S^T and dP^T still over the whole D
  static constexpr int kDW = D > 128 ? D / 2 : D;
  // one consumer warpgroup and one producer warpgroup. A block of two
  // consumers (on two key tiles, or on dK and dV apart) measured no faster
  // on the H100, and with two consumers that each hold dK, dV, S^T and
  // dP^T (192 accumulator registers) ptxas keeps part of them in local
  // memory whatever setmaxnreg grants, and serializes the products
  static constexpr int kThreadsN = 2 * kWarpgroup;
  // the ring's stages: four where they fit beside K and V (D <= 128),
  // else two
  static constexpr int kStages = D > 128 ? 2 : 4;
  static constexpr int kT = Tile<D>::kBytes;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kT;
  static constexpr int kQ = kV + kT;
  static constexpr int kDO = kQ + kStages * kT;
  static constexpr int kL = kDO + kStages * kT;              // [stage][64]
  static constexpr int kDl = kL + kStages * kBwdRows * 4;    // [stage][64]
  static constexpr int kBar = kDl + kStages * kBwdRows * 4;  // kv, full, empty
  static constexpr size_t kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// the registers the consumer warpgroup rises to and the producer
// warpgroup drops to; the launch checks that the kernel's own count
// leaves the pool enough
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

template <int D>
__global__ void __launch_bounds__(DkdvSmem<D>::kThreadsN, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta,
                      float* __restrict__ part_k, float* __restrict__ part_v,
                      BwdArgs a) {
  using S = DkdvSmem<D>;
  using T = Tile<D>;
  constexpr int kDW = S::kDW;
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  const float inv_scale_log2 = 1.0f / scale_log2;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sm + S::kBar);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + S::kStages;

  const int bv = blockIdx.y, b = bv / a.V, kvh = bv % a.V, g = a.H / a.V;
  // this block's unit: key tiles in order (heaviest first under the
  // causal mask), each cut into units of at most per_unit items
  int kb = 0, u = blockIdx.x, qt0 = 0, nqt = 0, items = 0;
  for (; kb < a.nkb; ++kb) {
    const int units = block_units(a, kb, qt0, nqt, items);
    if (u < units) break;
    u -= units;
  }
  // the key tile's items split near-evenly over its units
  const int n_units = (items + a.per_unit - 1) / a.per_unit;
  const int it0 = u * items / n_units, it1 = (u + 1) * items / n_units;
  const int k0 = kb * kBwdRows;
  // the unit's slab of the partials: [B * V][units][64 keys][D]
  const long long slab = (static_cast<long long>(bv) * a.units + blockIdx.x)
                         * kBwdRows * D;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < S::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroup) {
    // producer warpgroup: K and V once, then each item's Q, dO, LSE and
    // Delta, all issued by its first thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == kWarpgroup) {
      mbar_expect_tx(bar_kv, 2 * S::kT);
      tma_tile<D>(sm + S::kK, &tm_k, bar_kv, k0, kvh, b);
      tma_tile<D>(sm + S::kV, &tm_v, bar_kv, k0, kvh, b);
      for (int it = it0, i = 0; it < it1; ++it, ++i) {
        const int st = i % S::kStages, use = i / S::kStages;
        mbar_wait(&empty[st], (use & 1) ^ 1);
        const int h = kvh * g + it / nqt, qt = qt0 + it % nqt;
        mbar_expect_tx(&full[st], 2 * S::kT + 2 * kBwdRows * 4);
        tma_tile<D>(sm + S::kQ + st * S::kT, &tm_q, &full[st], qt * kBwdRows, h, b);
        tma_tile<D>(sm + S::kDO + st * S::kT, &tm_do, &full[st], qt * kBwdRows, h, b);
        const long long row = (static_cast<long long>(b) * a.H + h) * a.sq_pad
                              + qt * kBwdRows;
        bulk_load(sm + S::kL + st * kBwdRows * 4, lse2 + row, kBwdRows * 4, &full[st]);
        bulk_load(sm + S::kDl + st * kBwdRows * 4, delta + row, kBwdRows * 4, &full[st]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // this block's D columns of dK and dV, from chunk c0
  const int c0 = blockIdx.z * (kDW / T::kChunk);
  const uint64_t dK = desc_k<D>(smem_u32(sm + S::kK));
  const uint64_t dV = desc_k<D>(smem_u32(sm + S::kV));

  float dk[kDW / 2], dv[kDW / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < kDW / 2; ++i) dk[i] = dv[i] = 0.0f;

  mbar_wait(bar_kv, 0);
  for (int it = it0, i = 0; it < it1; ++it, ++i) {
    const int st = i % S::kStages;
    const int q_lo = a.pos_off + (qt0 + it % nqt) * kBwdRows;
    const int q_hi = q_lo + kBwdRows - 1;
    mbar_wait(&full[st], (i / S::kStages) & 1);
    const unsigned sQ = smem_u32(sm + S::kQ + st * S::kT);
    const unsigned sdO = smem_u32(sm + S::kDO + st * S::kT);
    const uint64_t kK = opaque(dK), kV = opaque(dV);
    const uint64_t kQ = desc_k<D>(sQ), kdO = desc_k<D>(sdO);
    const float* Lt = reinterpret_cast<const float*>(sm + S::kL) + st * kBwdRows;
    const float* Dt = reinterpret_cast<const float*>(sm + S::kDl) + st * kBwdRows;

    // S^T = K Q^T - LSE / scale and dP^T = V dO^T - Delta: 64 keys x 64
    // queries, each accumulator started from its column's -LSE / scale or
    // -Delta, so neither row needs registers of its own
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * tq);
      const float2 dl = *reinterpret_cast<const float2*>(Dt + 8 * j + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = -((e & 1) ? l.y : l.x) * inv_scale_log2;
        dp[4 * j + e] = -((e & 1) ? dl.y : dl.x);
      }
    }
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss64(s, step_k<D>(kK, ks), step_k<D>(kQ, ks), 1);
    wg_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss64(dp, step_k<D>(kV, ks), step_k<D>(kdO, ks), 1);
    wg_commit();

    // P^T = exp2(S^T scale) under the masks while dP^T runs; row = key,
    // col = query
    const bool edge = k0 + kBwdRows - 1 >= a.kv_len
        || (a.causal && (k0 + kBwdRows - 1 > q_lo
                         || (a.window > 0 && k0 <= q_hi - a.window)));
    wg_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tq + (e & 1);
        const int kpos = k0 + 16 * warp + gq + 8 * (e >> 1);
        const bool vis = !edge || visible(q_lo + col, kpos, a.kv_len,
                                          a.causal, a.window);
        s[4 * j + e] = vis ? exp2_ftz(s[4 * j + e] * scale_log2) : 0.0f;
      }
    }
    wg_wait<0>();
    fence_regs(dp);
    // dS^T = P^T (dP^T - Delta); both to bf16 A fragments
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] *= s[i];
    unsigned pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
    }
    // dV += P^T dO and dK += dS^T Q over the 64 queries
    fence_regs(dv);
    fence_regs(dk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<kDW>(dv, pa[kk], step_mn<D>(desc_mn<D>(sdO), kk, c0));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<kDW>(dk, da[kk], step_mn<D>(desc_mn<D>(sQ), kk, c0));
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // the unit's fp32 partials (dK unscaled)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = 16 * warp + gq + 8 * r;
    float* pk = part_k + slab + row * D + c0 * T::kChunk + 2 * tq;
    float* pv = part_v + slab + row * D + c0 * T::kChunk + 2 * tq;
#pragma unroll
    for (int j = 0; j < kDW / 8; ++j) {
      *reinterpret_cast<float2*>(pk + 8 * j) = make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(pv + 8 * j) = make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// dK (times 1/sqrt(D)) and dV of kCombineRows<D> key rows of (batch row,
// KV head) blockIdx.y, one thread per row and 8 columns: the key tile's
// units' partials summed in unit order, bf16
template <int D>
constexpr int kCombineRows = 2048 / D > 64 ? 64 : 2048 / D;
template <int D>
constexpr int kCombineThreads = kCombineRows<D> * (D / 8);   // 256 at D >= 32

template <int D>
__global__ void __launch_bounds__(kCombineThreads<D>) flash_bwd_combine_kernel(
    const float* __restrict__ part_k, const float* __restrict__ part_v,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    BwdArgs a, Strides dks_, Strides dvs_) {
  const int row0 = blockIdx.x * kCombineRows<D>;
  const int kb = row0 / kBwdRows, bv = blockIdx.y;
  const int b = bv / a.V, kvh = bv % a.V;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  int first = 0, n = 0, qt0, nqt, items;
  for (int j = 0; j <= kb; ++j) {
    const int units = block_units(a, j, qt0, nqt, items);
    if (j < kb) first += units; else n = units;
  }
  const int key = row0 + static_cast<int>(threadIdx.x) / (D / 8);
  const int r = key - kb * kBwdRows, c = (threadIdx.x % (D / 8)) * 8;
  if (key >= a.Sk) return;
  const long long unit_floats = static_cast<long long>(kBwdRows) * D;
  const long long at = (static_cast<long long>(bv) * a.units + first)
                       * unit_floats + static_cast<long long>(r) * D + c;
  float sk[8], sv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sk[e] = sv[e] = 0.0f;
#pragma unroll 4
  for (int u = 0; u < n; ++u) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const long long i = at + u * unit_floats + 4 * h2;
      const float4 x = *reinterpret_cast<const float4*>(part_k + i);
      const float4 y = *reinterpret_cast<const float4*>(part_v + i);
      sk[4 * h2] += x.x; sk[4 * h2 + 1] += x.y; sk[4 * h2 + 2] += x.z; sk[4 * h2 + 3] += x.w;
      sv[4 * h2] += y.x; sv[4 * h2 + 1] += y.y; sv[4 * h2 + 2] += y.z; sv[4 * h2 + 3] += y.w;
    }
  }
  uint4 ok, ov;
  ok.x = pack_bf16(sk[0] * scale, sk[1] * scale);
  ok.y = pack_bf16(sk[2] * scale, sk[3] * scale);
  ok.z = pack_bf16(sk[4] * scale, sk[5] * scale);
  ok.w = pack_bf16(sk[6] * scale, sk[7] * scale);
  ov.x = pack_bf16(sv[0], sv[1]);
  ov.y = pack_bf16(sv[2], sv[3]);
  ov.z = pack_bf16(sv[4], sv[5]);
  ov.w = pack_bf16(sv[6], sv[7]);
  *reinterpret_cast<uint4*>(dk + static_cast<long long>(b) * dks_.b
      + static_cast<long long>(kvh) * dks_.h + static_cast<long long>(key) * dks_.s + c) = ok;
  *reinterpret_cast<uint4*>(dv + static_cast<long long>(b) * dvs_.b
      + static_cast<long long>(kvh) * dvs_.h + static_cast<long long>(key) * dvs_.s + c) = ov;
}

// shared memory of the dQ block: its Q and dO tiles, the ring's K and V
// tiles, its LSE and Delta rows, barriers (q, full, empty)
template <int D>
struct DqSmem {
  static constexpr int kThreadsN = kWarpgroup + 32;
  static constexpr int kT = Tile<D>::kBytes;
  static constexpr int kQ = 0;
  static constexpr int kDO = kT;
  static constexpr int kK = 2 * kT;
  static constexpr int kV = kK + kBwdStages * kT;
  static constexpr int kL = kV + kBwdStages * kT;
  static constexpr int kDl = kL + kBwdRows * 4;
  static constexpr int kBar = kDl + kBwdRows * 4;
  static constexpr size_t kBytes = kBar + 8 * (1 + 2 * kBwdStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(DqSmem<D>::kThreadsN, D > 128 ? 1 : 2)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, BwdArgs a, Strides dqs_) {
  using S = DqSmem<D>;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float scale_log2 = kLog2e * scale;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + S::kBar);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kBwdStages;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.V);
  const int q0 = qt * kBwdRows;
  const int q_lo = q0 + a.pos_off, q_hi = q_lo + kBwdRows - 1;
  const int nk = (a.Sk + kBwdRows - 1) / kBwdRows;
  int jt_begin = nk, jt_end = 0;
  for (int jt = 0; jt < nk; ++jt) {
    if (tile_live(jt * kBwdRows, kBwdRows, q_lo, q_hi, a.kv_len, a.causal,
                  a.window)) {
      jt_begin = imin(jt_begin, jt);
      jt_end = jt + 1;
    }
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroup) {
    // producer warp: Q, dO, LSE and Delta once, then each live K/V tile
    if (threadIdx.x == kWarpgroup) {
      const long long row = (static_cast<long long>(b) * a.H + h) * a.sq_pad + q0;
      mbar_expect_tx(bar_q, 2 * S::kT + 2 * kBwdRows * 4);
      tma_tile<D>(sm + S::kQ, &tm_q, bar_q, q0, h, b);
      tma_tile<D>(sm + S::kDO, &tm_do, bar_q, q0, h, b);
      bulk_load(sm + S::kL, lse2 + row, kBwdRows * 4, bar_q);
      bulk_load(sm + S::kDl, delta + row, kBwdRows * 4, bar_q);
      for (int jt = jt_begin, i = 0; jt < jt_end; ++jt, ++i) {
        const int st = i % kBwdStages, use = i / kBwdStages;
        mbar_wait(&empty[st], (use & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * S::kT);
        tma_tile<D>(sm + S::kK + st * S::kT, &tm_k, &full[st], jt * kBwdRows, kvh, b);
        tma_tile<D>(sm + S::kV + st * S::kT, &tm_v, &full[st], jt * kBwdRows, kvh, b);
      }
    }
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const uint64_t dQ = desc_k<D>(smem_u32(sm + S::kQ));
    const uint64_t ddO = desc_k<D>(smem_u32(sm + S::kDO));
    float dqa[D / 2], s[32], dp[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;

    mbar_wait(bar_q, 0);
    float lse_r[2], dl_r[2];   // rows 16 warp + gq and + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse_r[r] = reinterpret_cast<const float*>(sm + S::kL)[16 * warp + gq + 8 * r];
      dl_r[r] = reinterpret_cast<const float*>(sm + S::kDl)[16 * warp + gq + 8 * r];
    }
    for (int jt = jt_begin, i = 0; jt < jt_end; ++jt, ++i) {
      const int st = i % kBwdStages;
      mbar_wait(&full[st], (i / kBwdStages) & 1);
      const unsigned sK = smem_u32(sm + S::kK + st * S::kT);
      const unsigned sV = smem_u32(sm + S::kV + st * S::kT);
      const uint64_t kQ = opaque(dQ), kdO = opaque(ddO);
      const uint64_t kK = desc_k<D>(sK), kV = desc_k<D>(sV);

      // S = Q K^T and dP = dO V^T: 64 queries x 64 keys
      fence_regs(s);
      fence_regs(dp);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss64(s, step_k<D>(kQ, ks), step_k<D>(kK, ks), ks > 0);
      wg_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss64(dp, step_k<D>(kdO, ks), step_k<D>(kV, ks), ks > 0);
      wg_commit();

      const int k_lo = jt * kBwdRows;
      const bool edge = k_lo + kBwdRows - 1 >= a.kv_len
          || (a.causal && (k_lo + kBwdRows - 1 > q_lo
                           || (a.window > 0 && k_lo <= q_hi - a.window)));
      wg_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q_lo + 16 * warp + gq + 8 * (e >> 1);
          const int kpos = k_lo + 8 * j + 2 * tq + (e & 1);
          const bool vis = !edge || visible(qpos, kpos, a.kv_len, a.causal,
                                            a.window);
          const float x = s[4 * j + e] * scale_log2 - lse_r[e >> 1];
          s[4 * j + e] = vis ? exp2_ftz(x) : 0.0f;
        }
      }
      wg_wait<0>();
      fence_regs(dp);
      unsigned da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl_r[e >> 1]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      // dQ += dS K over the 64 keys
      fence_regs(dqa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(dqa, da[kk], step_mn<D>(desc_mn<D>(sK), kk, 0));
      wg_commit();
      wg_wait<0>();
      fence_regs(dqa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + gq + 8 * r;
      if (row >= a.Sq) continue;
      __nv_bfloat16* out = dq + static_cast<long long>(b) * dqs_.b
          + static_cast<long long>(h) * dqs_.h
          + static_cast<long long>(row) * dqs_.s + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
            dqa[4 * j + 2 * r] * scale, dqa[4 * j + 2 * r + 1] * scale);
    }
  }
}

// -- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the process has loaded (no link
// against it)
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
        : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// a [B, heads, S, D] bf16 tensor read as 64-row tiles of swizzled D chunks;
// rows past S read as zeros
template <int D>
int make_tile_map(CUtensorMap* map, const void* p, int B, int heads, int S,
                  Strides st) {
  using T = Tile<D>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  // a dimension of one element may carry any stride: give it a legal one
  auto bytes = [](int n, int stride) {
    return n == 1 ? cuuint64_t{16} : static_cast<cuuint64_t>(stride) * 2;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(S, st.s), bytes(heads, st.h),
                                 bytes(B, st.b)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kChunk), kBwdRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<void*>(p), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess)
    return 132;
  return n;
}

// The call's dK/dV units: each 64-key tile's items split near-evenly into
// units of at most C items, C the least that keeps the blocks within
// kUnitsPerSm per SM (one dK/dV block fits on an SM). Every SM then takes
// about as many items, up to one unit's worth: a smaller C would balance
// better but writes more fp32 partials for the combine to read.
constexpr int kUnitsPerSm = 2;

BwdArgs plan_bwd(int B, int H, int V, int Sq, int Sk, int D, int kv_len,
                 int causal, int window, int pos_off) {
  BwdArgs a{B, H, V, Sq, Sk, kv_len, causal, window, pos_off};
  a.nq = (Sq + kBwdRows - 1) / kBwdRows;
  a.sq_pad = a.nq * kBwdRows;
  a.nkb = (Sk + kBwdRows - 1) / kBwdRows;
  a.halves = D > 128 ? 2 : 1;
  a.per_unit = 1;
  long long total = 0;
  int qt0, nqt, items, most = 1;
  for (int kb = 0; kb < a.nkb; ++kb) {
    block_units(a, kb, qt0, nqt, items);
    total += items;
    most = imax(most, items);
  }
  // the blocks a unit of one (batch row, KV head) stands for, and the
  // units of each (b, v) the card holds at kUnitsPerSm an SM
  const long long per_bv = static_cast<long long>(B) * V * a.halves;
  const long long want = imax(1, static_cast<int>(
      static_cast<long long>(kUnitsPerSm) * sm_count() / per_bv));
  a.per_unit = imax(1, static_cast<int>((total + want - 1) / want));
  for (;; ++a.per_unit) {
    a.units = 0;
    for (int kb = 0; kb < a.nkb; ++kb)
      a.units += block_units(a, kb, qt0, nqt, items);
    if (a.units <= want || a.per_unit >= most) break;
  }
  return a;
}

// scratch layout: lse2 and delta [B, H, sq_pad] fp32, then the dK and dV
// partials [B * V][units][block keys][D] fp32, each part 256-byte aligned
struct Scratch {
  size_t lse2, delta, part_k, part_v, bytes;
};

Scratch scratch_layout(const BwdArgs& a, int D) {
  auto up = [](size_t n) { return (n + 255) / 256 * 256; };
  const size_t rows = up(sizeof(float) * a.B * a.H * static_cast<size_t>(a.sq_pad));
  const size_t part = up(sizeof(float) * a.B * a.V * static_cast<size_t>(a.units)
                         * kBwdRows * D);
  return {0, rows, 2 * rows, 2 * rows + part, 2 * rows + 2 * part};
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int D>
int launch_bwd(const BwdArgs& a, const void* q, const void* k, const void* v,
               const void* dO, unsigned char* scratch, void* dq, void* dk,
               void* dv, Strides qs_, Strides ks_, Strides vs_,
               Strides dos_, Strides dqs_, Strides dks_, Strides dvs_,
               cudaStream_t stream) {
  using bf = __nv_bfloat16;
  using SK = DkdvSmem<D>;
  using SQ = DqSmem<D>;
  const Scratch sc = scratch_layout(a, D);
  const float* lse2 = reinterpret_cast<const float*>(scratch + sc.lse2);
  const float* delta = reinterpret_cast<const float*>(scratch + sc.delta);
  float* part_k = reinterpret_cast<float*>(scratch + sc.part_k);
  float* part_v = reinterpret_cast<float*>(scratch + sc.part_v);
  CUtensorMap tq, tk, tv, tdo;
  int err = make_tile_map<D>(&tq, q, a.B, a.H, a.Sq, qs_);
  if (!err) err = make_tile_map<D>(&tk, k, a.B, a.V, a.Sk, ks_);
  if (!err) err = make_tile_map<D>(&tv, v, a.B, a.V, a.Sk, vs_);
  if (!err) err = make_tile_map<D>(&tdo, dO, a.B, a.H, a.Sq, dos_);
  if (!err) err = allow_smem(flash_bwd_dkdv_kernel<D>, SK::kBytes);
  if (!err) err = allow_smem(flash_bwd_dq_kernel<D>, SQ::kBytes);
  if (err) return err;
  // setmaxnreg.inc waits for registers the producer's .dec returned to the
  // block: refuse a build whose register count would leave it waiting
  cudaFuncAttributes attr;
  err = static_cast<int>(cudaFuncGetAttributes(&attr, flash_bwd_dkdv_kernel<D>));
  if (err) return err;
  if (kConsumerRegs - attr.numRegs > attr.numRegs - kProducerRegs)
    return static_cast<int>(cudaErrorInvalidConfiguration);

  if (a.units > 0) {
    dim3 grid(a.units, a.B * a.V, a.halves);
    flash_bwd_dkdv_kernel<D><<<grid, SK::kThreadsN, SK::kBytes, stream>>>(
        tq, tk, tv, tdo, lse2, delta, part_k, part_v, a);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  flash_bwd_combine_kernel<D><<<dim3(a.nkb * kBwdRows / kCombineRows<D>,
                                     a.B * a.V), kCombineThreads<D>, 0,
                                stream>>>(
      part_k, part_v, static_cast<bf*>(dk), static_cast<bf*>(dv), a, dks_,
      dvs_);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  flash_bwd_dq_kernel<D><<<dim3(a.nq, a.H, a.B), SQ::kThreadsN, SQ::kBytes,
                           stream>>>(tq, tk, tv, tdo, lse2, delta,
                                     static_cast<bf*>(dq), a, dqs_);
  return static_cast<int>(cudaGetLastError());
}

bool bwd_head_dim(int D) {
  return D == 16 || D == 32 || D == 64 || D == 128 || D == 256;
}

}  // namespace

// Bytes of scratch flash_attention_bwd_bf16 needs for this call (the
// prep rows and the dK/dV partials); -1 for an unsupported D.
extern "C" long long flash_attention_bwd_scratch_bytes(
    int B, int H, int V, int Sq, int Sk, int D, int kv_len, int causal,
    int window, int pos_off) {
  if (!bwd_head_dim(D)) return -1;
  const BwdArgs a = plan_bwd(B, H, V, Sq, Sk, D, kv_len, causal, window,
                             pos_off);
  return static_cast<long long>(scratch_layout(a, D).bytes);
}

// The gradients of flash_attention_fwd_bf16's output: q, k, v, o and dO as
// the forward takes them (strided, unit stride along D, 16-byte aligned
// with strides in multiples of 8 elements), lse the forward's fp32
// [B,H,Sq] log-sum-exp, scratch of flash_attention_bwd_scratch_bytes
// bytes (256-byte aligned); dq [B,H,Sq,D] and dk / dv [B,V,Sk,D] written
// through their strides (every row, zeros where the masks hide a key or
// query from all others). D must be 16, 32, 64, 128 or 256. Four launches
// on `stream`: prep, dK/dV, combine, dQ. Returns the first error that is
// not cudaSuccess (cudaErrorInvalidValue for an unsupported D or a tensor
// map the encoder refuses).
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int B, int H, int V, int Sq, int Sk, int D, int kv_len,
    int causal, int window, int pos_off, int q_sb, int q_sh, int q_ss,
    int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb,
    int o_sh, int o_ss, int do_sb, int do_sh, int do_ss, int dq_sb,
    int dq_sh, int dq_ss, int dk_sb, int dk_sh, int dk_ss, int dv_sb,
    int dv_sh, int dv_ss, void* stream) {
  if (!bwd_head_dim(D)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs_{q_sb, q_sh, q_ss}, ks_{k_sb, k_sh, k_ss};
  const Strides vs_{v_sb, v_sh, v_ss}, os_{o_sb, o_sh, o_ss};
  const Strides dos_{do_sb, do_sh, do_ss}, dqs_{dq_sb, dq_sh, dq_ss};
  const Strides dks_{dk_sb, dk_sh, dk_ss}, dvs_{dv_sb, dv_sh, dv_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdArgs a = plan_bwd(B, H, V, Sq, Sk, D, kv_len, causal, window,
                             pos_off);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  const Scratch lay = scratch_layout(a, D);

  dim3 grid_p(a.sq_pad / kWarps, H, B);
  flash_bwd_prep_kernel<<<grid_p, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dO), static_cast<const float*>(lse),
      reinterpret_cast<float*>(sc + lay.lse2),
      reinterpret_cast<float*>(sc + lay.delta), H, Sq, a.sq_pad, D, os_, dos_);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  switch (D) {
    case 16: return launch_bwd<16>(a, q, k, v, dO, sc, dq, dk, dv, qs_, ks_, vs_, dos_, dqs_, dks_, dvs_, st);
    case 32: return launch_bwd<32>(a, q, k, v, dO, sc, dq, dk, dv, qs_, ks_, vs_, dos_, dqs_, dks_, dvs_, st);
    case 64: return launch_bwd<64>(a, q, k, v, dO, sc, dq, dk, dv, qs_, ks_, vs_, dos_, dqs_, dks_, dvs_, st);
    case 128: return launch_bwd<128>(a, q, k, v, dO, sc, dq, dk, dv, qs_, ks_, vs_, dos_, dqs_, dks_, dvs_, st);
    default: return launch_bwd<256>(a, q, k, v, dO, sc, dq, dk, dv, qs_, ks_, vs_, dos_, dqs_, dks_, dvs_, st);
  }
}
