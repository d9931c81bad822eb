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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// forward; D 16-128 (at D 256 the two fp32 accumulators of the dK/dV block
// exceed the registers: the wrapper refuses it).
//
// Bound on the H100: operations. With P recomputed from Q, K and the
// forward's log-sum-exp, the backward runs five products (Q K^T, dO V^T,
// P^T dO, dS^T Q, dS K) against the forward's two, so about 2.5x the
// forward's FLOPs, all on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate). FlashAttention-2's split, with no atomics, so the
// gradients are bitwise repeatable and do not depend on the launch:
//   1. preprocess: Delta = rowsum(dO * O) in fp32, one warp per row, a
//      fixed shuffle tree;
//   2. dK/dV: one block of 4 warps per (key tile of 64, KV head, batch
//      row), each warp owning 16 keys. K and V sit in shared memory for
//      the whole walk; the block walks the g query heads of its KV head
//      and their live query tiles of 32 in a fixed order, each tile's Q,
//      dO, LSE and Delta double-buffered through cp.async. Per tile it
//      forms S^T = K Q^T and dP^T = V dO^T in registers, P^T = exp(S^T -
//      LSE) under the masks, dS^T = P^T (dP^T - Delta), and accumulates
//      dV += P^T dO and dK += dS^T Q in fp32 registers, P^T and dS^T
//      rounded to bf16 as A operands straight from the score registers;
//   3. dQ: one block per (query tile of 64, head, batch row), the forward's
//      walk over live key tiles (double-buffered K and V), S and dP again,
//      dQ += dS K.
// The 1/sqrt(D) scale is applied to the fp32 scores and to dQ and dK at
// the end. Whole tiles are pruned exactly as in the forward, and masks are
// applied in registers only on tiles that cross a mask edge.
// ---------------------------------------------------------------------------

namespace {

constexpr int kBwdKeys = 64;   // keys of a dK/dV block, 16 per warp
constexpr int kBwdQ = 32;      // queries of the dK/dV block's inner tile
// the log-sum-exp of a padding query row: its P underflows to exactly 0
constexpr float kPadLse = 1e30f;

// the lane's ldmatrix row address within a 16x16 item of a padded tile:
// A operand (rows = M, non-trans), B operand stored [n][k] (non-trans),
// B operand stored [k][n] (trans); the forward's q_frag / k_frag / v_frag
template <int LD>
__device__ __forceinline__ int frag_a(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ int frag_b(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
}
template <int LD>
__device__ __forceinline__ int frag_bt(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
}

// acc[16 x 8N] += A[16 rows of `a` from row 0, D cols] * B^T, where B is a
// [8N][D] padded tile (both row-major over D): the QK^T-shaped product
template <int D, int N>
__device__ __forceinline__ void product_abt(float (&acc)[N][4],
                                            const __nv_bfloat16* a,
                                            const __nv_bfloat16* bm,
                                            int lane) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    unsigned fa[4];
    ldsm_x4(fa, a + frag_a<LD>(lane) + ks * 16);
#pragma unroll
    for (int n2 = 0; n2 < N / 2; ++n2) {
      unsigned fb[4];
      ldsm_x4(fb, bm + frag_b<LD>(lane) + n2 * 16 * LD + ks * 16);
      mma_bf16(acc[2 * n2], fa, fb[0], fb[1]);
      mma_bf16(acc[2 * n2 + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc[16 x D] += P[16 x 16K] (bf16 fragments pa) * B, B a [16K][D] padded
// tile: the PV-shaped product
template <int D, int K>
__device__ __forceinline__ void product_pb(float (&acc)[D / 8][4],
                                           unsigned (&pa)[K][4],
                                           const __nv_bfloat16* bm, int lane) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      unsigned fb[4];
      ldsm_x4_trans(fb, bm + frag_bt<LD>(lane) + kk * 16 * LD + n2 * 16);
      mma_bf16(acc[2 * n2], pa[kk], fb[0], fb[1]);
      mma_bf16(acc[2 * n2 + 1], pa[kk], fb[2], fb[3]);
    }
  }
}

// score registers (C layout of N n-tiles) -> bf16 A fragments
template <int N>
__device__ __forceinline__ void to_a_frags(unsigned (&pa)[N / 2][4],
                                           const float (&s)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// rows gq and gq + 8 of a warp's [16 x D] fp32 accumulator, times `scale`,
// to bf16 rows [r0, r0 + 16) of a strided [S, D] slice (rows >= limit kept)
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, int stride,
                                           int r0, int limit,
                                           float (&acc)[D / 8][4],
                                           float scale, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + gq + r * 8;
    if (row >= limit) continue;
    __nv_bfloat16* out = dst + static_cast<long long>(row) * stride + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// Delta[b, h, row] = sum_d dO * O (fp32), one warp per row
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dO,
    float* __restrict__ delta, int H, int Sq, int D, Strides os_,
    Strides dos_) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z, lane = threadIdx.x & 31;
  if (row >= Sq) return;
  const __nv_bfloat16* orow = o + static_cast<long long>(b) * os_.b
      + static_cast<long long>(h) * os_.h + static_cast<long long>(row) * os_.s;
  const __nv_bfloat16* drow = dO + static_cast<long long>(b) * dos_.b
      + static_cast<long long>(h) * dos_.h
      + static_cast<long long>(row) * dos_.s;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32)
    acc += __bfloat162float(orow[d]) * __bfloat162float(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * Sq + row] = acc;
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(
             2 * kBwdKeys + 2 * 2 * kBwdQ) * (D + kPad)
         + sizeof(float) * 2 * 2 * kBwdQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
    int V, int Sq, int Sk, int kv_len, int causal, int window, int pos_off,
    Strides qs_, Strides ks_, Strides vs_, Strides dos_, Strides dks_,
    Strides dvs_) {
  constexpr int LD = D + kPad;
  constexpr int BKV = kBwdKeys, BQ = kBwdQ;
  constexpr int ND = D / 8;    // n-tiles over D
  constexpr int NQ = BQ / 8;   // n-tiles over a query tile
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float scale_log2 = kLog2e * scale;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BKV * LD;
  __nv_bfloat16* Qring = Vs + BKV * LD;        // stage st: Q, then dO
  float* Lring = reinterpret_cast<float*>(Qring + 2 * 2 * BQ * LD);
  // stage st: LSE (log2 domain), then Delta

  const int kvh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int g = H / V;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int k0 = kt * BKV, row0 = warp * 16;

  const __nv_bfloat16* kb = k + static_cast<long long>(b) * ks_.b
                          + static_cast<long long>(kvh) * ks_.h;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * vs_.b
                          + static_cast<long long>(kvh) * vs_.h;

  // the live query tiles form one contiguous run, as the forward's key tiles
  const int nq = (Sq + BQ - 1) / BQ;
  int qt_begin = nq, qt_end = 0;
  for (int qt = 0; qt < nq; ++qt) {
    const int q_lo = pos_off + qt * BQ;
    if (tile_live(k0, BKV, q_lo, q_lo + BQ - 1, kv_len, causal, window)) {
      qt_begin = min(qt_begin, qt);
      qt_end = qt + 1;
    }
  }
  const int nqt = max(qt_end - qt_begin, 0);
  const int n_items = g * nqt;  // (head, query tile), heads outermost

  auto fetch = [&](int it, int st) {
    const int h = kvh * g + it / nqt;
    const int q0 = (qt_begin + it % nqt) * BQ;
    __nv_bfloat16* Qt = Qring + st * 2 * BQ * LD;
    load_tile<D, BQ>(Qt, q + static_cast<long long>(b) * qs_.b
                             + static_cast<long long>(h) * qs_.h,
                     q0, Sq, qs_.s, tid);
    load_tile<D, BQ>(Qt + BQ * LD, dO + static_cast<long long>(b) * dos_.b
                                       + static_cast<long long>(h) * dos_.h,
                     q0, Sq, dos_.s, tid);
    if (tid < BQ) {
      const int row = q0 + tid;
      const long long at = (static_cast<long long>(b) * H + h) * Sq + row;
      float* Lt = Lring + st * 2 * BQ;
      Lt[tid] = row < Sq ? lse[at] * kLog2e : kPadLse;
      Lt[BQ + tid] = row < Sq ? delta[at] : 0.0f;
    }
  };

  load_tile<D, BKV>(Ks, kb, k0, Sk, ks_.s, tid);
  load_tile<D, BKV>(Vs, vb, k0, Sk, vs_.s, tid);
  if (n_items > 0) fetch(0, 0);
  cp_async_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;

  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1;
    cp_async_wait<0>();  // item it (and K, V) landed for this thread...
    __syncthreads();     // ... for every thread; item it - 1 is done
    if (it + 1 < n_items) fetch(it + 1, st ^ 1);
    cp_async_commit();
    const __nv_bfloat16* Qt = Qring + st * 2 * BQ * LD;
    const __nv_bfloat16* dOt = Qt + BQ * LD;
    const float* Lt = Lring + st * 2 * BQ;
    const int q_lo = pos_off + (qt_begin + it % nqt) * BQ;
    const int q_hi = q_lo + BQ - 1;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    product_abt<D, NQ>(s, Ks + row0 * LD, Qt, lane);
    product_abt<D, NQ>(dp, Vs + row0 * LD, dOt, lane);

    const bool edge = k0 + BKV - 1 >= kv_len
        || (causal && (k0 + BKV - 1 > q_lo
                       || (window > 0 && k0 <= q_hi - window)));
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * tq + (e & 1);
        const int kpos = k0 + row0 + gq + (e >> 1) * 8;
        const bool vis = !edge || visible(q_lo + col, kpos, kv_len, causal,
                                          window);
        const float p = vis ? exp2f(s[n][e] * scale_log2 - Lt[col]) : 0.0f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - Lt[BQ + col]);   // dS^T
      }
    }
    unsigned pa[NQ / 2][4];
    to_a_frags<NQ>(pa, s);
    product_pb<D, NQ / 2>(dv_acc, pa, dOt, lane);   // dV += P^T dO
    to_a_frags<NQ>(pa, dp);
    product_pb<D, NQ / 2>(dk_acc, pa, Qt, lane);    // dK += dS^T Q
  }
  cp_async_wait<0>();

  store_rows<D>(dk + static_cast<long long>(b) * dks_.b
                   + static_cast<long long>(kvh) * dks_.h,
                dks_.s, k0 + row0, Sk, dk_acc, scale, lane);
  store_rows<D>(dv + static_cast<long long>(b) * dvs_.b
                   + static_cast<long long>(kvh) * dvs_.h,
                dvs_.s, k0 + row0, Sk, dv_acc, 1.0f, lane);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(__nv_bfloat16)
         * static_cast<size_t>(2 * kBQ + 2 * 2 * 64) * (D + kPad);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int H, int V, int Sq, int Sk, int kv_len,
    int causal, int window, int pos_off, Strides qs_, Strides ks_,
    Strides vs_, Strides dos_, Strides dqs_) {
  constexpr int LD = D + kPad;
  constexpr int BK = 64;
  constexpr int ND = D / 8, NK = BK / 8;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float scale_log2 = kLog2e * scale;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + kBQ * LD;
  __nv_bfloat16* ring = dOs + kBQ * LD;   // stage st: K, then V

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest causal tiles first
  const int kvh = h / (H / V);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int q0 = qt * kBQ, row0 = warp * 16;
  const int q_lo = q0 + pos_off, q_hi = q_lo + kBQ - 1;

  const __nv_bfloat16* kb = k + static_cast<long long>(b) * ks_.b
                          + static_cast<long long>(kvh) * ks_.h;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * vs_.b
                          + static_cast<long long>(kvh) * vs_.h;

  const int nk = (Sk + BK - 1) / BK;
  int jt_begin = nk, jt_end = 0;
  for (int jt = 0; jt < nk; ++jt) {
    if (tile_live(jt * BK, BK, q_lo, q_hi, kv_len, causal, window)) {
      jt_begin = min(jt_begin, jt);
      jt_end = jt + 1;
    }
  }

  float lse2[2], dlt[2];   // rows gq and gq + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + gq + r * 8;
    const long long at = (static_cast<long long>(b) * H + h) * Sq + row;
    lse2[r] = row < Sq ? lse[at] * kLog2e : kPadLse;
    dlt[r] = row < Sq ? delta[at] : 0.0f;
  }

  if (jt_begin < jt_end) {
    load_tile<D, kBQ>(Qs, q + static_cast<long long>(b) * qs_.b
                              + static_cast<long long>(h) * qs_.h,
                      q0, Sq, qs_.s, tid);
    load_tile<D, kBQ>(dOs, dO + static_cast<long long>(b) * dos_.b
                                + static_cast<long long>(h) * dos_.h,
                      q0, Sq, dos_.s, tid);
    load_tile<D, BK>(ring, kb, jt_begin * BK, Sk, ks_.s, tid);
    load_tile<D, BK>(ring + BK * LD, vb, jt_begin * BK, Sk, vs_.s, tid);
  }
  cp_async_commit();

  float dq_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.0f;

  for (int jt = jt_begin; jt < jt_end; ++jt) {
    const int st = (jt - jt_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (jt + 1 < jt_end) {
      __nv_bfloat16* nx = ring + (st ^ 1) * 2 * BK * LD;
      load_tile<D, BK>(nx, kb, (jt + 1) * BK, Sk, ks_.s, tid);
      load_tile<D, BK>(nx + BK * LD, vb, (jt + 1) * BK, Sk, vs_.s, tid);
    }
    cp_async_commit();
    const __nv_bfloat16* Kt = ring + st * 2 * BK * LD;
    const __nv_bfloat16* Vt = Kt + BK * LD;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x BK keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    product_abt<D, NK>(s, Qs + row0 * LD, Kt, lane);
    product_abt<D, NK>(dp, dOs + row0 * LD, Vt, lane);

    const int k_lo = jt * BK;
    const bool edge = k_lo + BK - 1 >= kv_len
        || (causal && (k_lo + BK - 1 > q_lo
                       || (window > 0 && k_lo <= q_hi - window)));
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qpos = q_lo + row0 + gq + r * 8;
        const int kpos = k_lo + n * 8 + 2 * tq + (e & 1);
        const bool vis = !edge || visible(qpos, kpos, kv_len, causal, window);
        const float p = vis ? exp2f(s[n][e] * scale_log2 - lse2[r]) : 0.0f;
        dp[n][e] = p * (dp[n][e] - dlt[r]);   // dS
      }
    }
    unsigned pa[NK / 2][4];
    to_a_frags<NK>(pa, dp);
    product_pb<D, NK / 2>(dq_acc, pa, Kt, lane);   // dQ += dS K
  }
  cp_async_wait<0>();

  store_rows<D>(dq + static_cast<long long>(b) * dqs_.b
                   + static_cast<long long>(h) * dqs_.h,
                dqs_.s, q0 + row0, Sq, dq_acc, scale, lane);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int D>
int launch_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const __nv_bfloat16* dO,
               const float* lse, const float* delta, __nv_bfloat16* dq,
               __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int H, int V,
               int Sq, int Sk, int kv_len, int causal, int window,
               int pos_off, Strides qs_, Strides ks_, Strides vs_,
               Strides dos_, Strides dqs_, Strides dks_, Strides dvs_,
               cudaStream_t stream) {
  constexpr size_t smem_kv = dkdv_smem_bytes<D>();
  constexpr size_t smem_q = dq_smem_bytes<D>();
  int err = allow_smem(flash_bwd_dkdv_kernel<D>, smem_kv);
  if (err) return err;
  err = allow_smem(flash_bwd_dq_kernel<D>, smem_q);
  if (err) return err;
  dim3 grid_kv(V, B, (Sk + kBwdKeys - 1) / kBwdKeys);
  flash_bwd_dkdv_kernel<D><<<grid_kv, kThreads, smem_kv, stream>>>(
      q, k, v, dO, lse, delta, dk, dv, H, V, Sq, Sk, kv_len, causal, window,
      pos_off, qs_, ks_, vs_, dos_, dks_, dvs_);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dim3 grid_q(H, B, (Sq + kBQ - 1) / kBQ);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, smem_q, stream>>>(
      q, k, v, dO, lse, delta, dq, H, V, Sq, Sk, kv_len, causal, window,
      pos_off, qs_, ks_, vs_, dos_, dqs_);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The gradients of flash_attention_fwd_bf16's output: q, k, v, o and dO as
// the forward takes them (strided, unit stride along D, 16-byte aligned
// with strides in multiples of 8 elements), lse the forward's fp32
// [B,H,Sq] log-sum-exp, delta fp32 [B,H,Sq] scratch; dq [B,H,Sq,D] and
// dk / dv [B,V,Sk,D] written through their strides (every row, zeros where
// the masks hide a key or query from all others). D must be 16, 32, 64 or
// 128. Three launches on `stream`: Delta, dK/dV, dQ. Returns the first
// cudaGetLastError() that is not cudaSuccess, or cudaErrorInvalidValue
// for an unsupported D.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int V, int Sq, int Sk, int D, int kv_len,
    int causal, int window, int pos_off, int q_sb, int q_sh, int q_ss,
    int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb,
    int o_sh, int o_ss, int do_sb, int do_sh, int do_ss, int dq_sb,
    int dq_sh, int dq_ss, int dk_sb, int dk_sh, int dk_ss, int dv_sb,
    int dv_sh, int dv_ss, void* stream) {
  if (D != 16 && D != 32 && D != 64 && D != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs_{q_sb, q_sh, q_ss}, ks_{k_sb, k_sh, k_ss};
  const Strides vs_{v_sb, v_sh, v_ss}, os_{o_sb, o_sh, o_ss};
  const Strides dos_{do_sb, do_sh, do_ss}, dqs_{dq_sb, dq_sh, dq_ss};
  const Strides dks_{dk_sb, dk_sh, dk_ss}, dvs_{dv_sb, dv_sh, dv_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const bf* qp = static_cast<const bf*>(q);
  const bf* kp = static_cast<const bf*>(k);
  const bf* vp = static_cast<const bf*>(v);
  const bf* dop = static_cast<const bf*>(dO);
  const float* lp = static_cast<const float*>(lse);
  float* dlp = static_cast<float*>(delta);
  bf* dqp = static_cast<bf*>(dq);
  bf* dkp = static_cast<bf*>(dk);
  bf* dvp = static_cast<bf*>(dv);

  dim3 grid_d((Sq + kWarps - 1) / kWarps, H, B);
  flash_bwd_delta_kernel<<<grid_d, kThreads, 0, st>>>(
      static_cast<const bf*>(o), dop, dlp, H, Sq, D, os_, dos_);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  switch (D) {
    case 16: return launch_bwd<16>(qp, kp, vp, dop, lp, dlp, dqp, dkp, dvp, B, H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, dos_, dqs_, dks_, dvs_, st);
    case 32: return launch_bwd<32>(qp, kp, vp, dop, lp, dlp, dqp, dkp, dvp, B, H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, dos_, dqs_, dks_, dvs_, st);
    case 64: return launch_bwd<64>(qp, kp, vp, dop, lp, dlp, dqp, dkp, dvp, B, H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, dos_, dqs_, dks_, dvs_, st);
    default: return launch_bwd<128>(qp, kp, vp, dop, lp, dlp, dqp, dkp, dvp, B, H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, dos_, dqs_, dks_, dvs_, st);
  }
}
