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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;  // 16 query rows each
constexpr int kThreads = 32 * kWarps;

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
__device__ __forceinline__ bool tile_live(int k_lo, int q_lo, int q_hi,
                                          int kv_len, int causal, int window) {
  bool live = k_lo < kv_len;
  if (causal) {
    live = live && k_lo <= q_hi;
    if (window > 0) live = live && k_lo + kBK - 1 > q_lo - window;
  }
  return live;
}

// padded shared rows: 8 spare bf16 (16 bytes) per row put the 8 rows of
// every ldmatrix on distinct banks
constexpr int kPad = 8;
// the K/V ring: stage i holds key tile i mod 3 as K then V, [BK][D + kPad]
// each; the Q tile waits in the last stage's K slot until its fragments
// are in registers
constexpr int kStages = 3;
// ldmatrix loads issued ahead of the products that use them
constexpr int kPrefetch = 4;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(2 * kStages * kBK)
         * (D + kPad);
}

template <int D>
__device__ __forceinline__ __nv_bfloat16* stage_k(__nv_bfloat16* ring, int st) {
  return ring + 2 * st * kBK * (D + kPad);
}

template <int D>
__device__ __forceinline__ __nv_bfloat16* stage_v(__nv_bfloat16* ring, int st) {
  return ring + (2 * st + 1) * kBK * (D + kPad);
}

// rows [r0, r0 + 64) of a [S, D] slice into a padded shared tile; rows at
// or past `limit` are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int limit, int stride, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte pieces per row
  constexpr int LD = D + kPad;
#pragma unroll
  for (int i = tid; i < kBK * kChunks; i += kThreads) {
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
    int H, int V, int Sq, int Sk, int kv_len, int causal, int window,
    int pos_off, Strides qs_, Strides ks_, Strides vs_, Strides os_) {
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;   // k-steps of QK^T over D
  constexpr int ND = D / 8;    // n-tiles of O over D
  constexpr int NK = kBK / 8;  // n-tiles of S over a key tile
  constexpr int KI = KS * (NK / 2);          // QK^T items of a key tile
  constexpr int VI = (kBK / 16) * (ND / 2);  // PV items of a key tile
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Qs = stage_k<D>(ring, kStages - 1);  // until its fragments load

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
  const int nk = (Sk + kBK - 1) / kBK;
  int jt_begin = nk, jt_end = 0;
  for (int jt = 0; jt < nk; ++jt) {
    if (tile_live(jt * kBK, q_lo, q_hi, kv_len, causal, window)) {
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
    load_tile<D>(Qs, qb, q0, Sq, qs_.s, tid);
    load_tile<D>(stage_k<D>(ring, 0), kb, jt_begin * kBK, Sk, ks_.s, tid);
    load_tile<D>(stage_v<D>(ring, 0), vb, jt_begin * kBK, Sk, vs_.s, tid);
    cp_async_commit();
    if (jt_begin + 1 < jt_end) {
      load_tile<D>(stage_k<D>(ring, 1), kb, (jt_begin + 1) * kBK, Sk, ks_.s, tid);
      load_tile<D>(stage_v<D>(ring, 1), vb, (jt_begin + 1) * kBK, Sk, vs_.s, tid);
    }
    cp_async_commit();
  }

  unsigned qa[KS][4];
  const int row0 = warp * 16;
  // this lane's ldmatrix row address within a K (x4) or V (x4.trans) item
  const int k_frag = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int v_frag = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  for (int jt = jt_begin; jt < jt_end; ++jt) {
    const int i = jt - jt_begin, st = i % kStages;
    cp_async_wait<1>();  // tile jt is here; tile jt + 1 may be in flight
    __syncthreads();     // ... for every thread, and tile jt - 1 is done
    if (i == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qa[ks], Qs + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                            + ks * 16 + (lane >> 4) * 8);
      __syncthreads();   // Q's slot is the third stage, refilled next
    }
    // keep two tiles in flight: tile jt + 2 goes where tile jt - 1 was
    if (jt + 2 < jt_end) {
      const int nx = (i + 2) % kStages;
      load_tile<D>(stage_k<D>(ring, nx), kb, (jt + 2) * kBK, Sk, ks_.s, tid);
      load_tile<D>(stage_v<D>(ring, nx), vb, (jt + 2) * kBK, Sk, vs_.s, tid);
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
#pragma unroll
    for (int i = 0; i < kPrefetch && i < KI; ++i)
      ldsm_x4(fr[i], Kt + k_frag + (i % (NK / 2)) * 16 * LD + (i / (NK / 2)) * 16);
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const int ks = i / (NK / 2), n2 = i % (NK / 2), f = i % kPrefetch;
      mma_bf16(s[2 * n2], qa[ks], fr[f][0], fr[f][1]);
      mma_bf16(s[2 * n2 + 1], qa[ks], fr[f][2], fr[f][3]);
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
    const int k_lo = jt * kBK;
    const bool edge = k_lo + kBK - 1 >= kv_len
        || (causal && (k_lo + kBK - 1 > q_lo
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
    unsigned pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
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
    __nv_bfloat16* orow = ob + static_cast<long long>(row) * os_.s + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * r] / l_run[r], acc[n][2 * r + 1] / l_run[r]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int V, int Sq, int Sk, int kv_len, int causal, int window,
           int pos_off, Strides qs_, Strides ks_, Strides vs_, Strides os_,
           cudaStream_t stream) {
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
      H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, os_);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B,H,Sq,D], k/v [B,V,Sk,D], o [B,H,Sq,D], each addressed through its
// (batch, head, sequence) element strides with unit stride along D. The
// 16-byte copies need q, k and v 16-byte aligned with strides in multiples
// of 8 elements (the wrapper checks). D must be 16, 32, 64 or 128. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported D.
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H, int V,
    int Sq, int Sk, int D, int kv_len, int causal, int window, int pos_off,
    int q_sb, int q_sh, int q_ss, int k_sb, int k_sh, int k_ss, int v_sb,
    int v_sh, int v_ss, int o_sb, int o_sh, int o_ss, void* stream) {
  const Strides qs_{q_sb, q_sh, q_ss}, ks_{k_sb, k_sh, k_ss};
  const Strides vs_{v_sb, v_sh, v_ss}, os_{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, os_, st);
    case 32: return launch<32>(q, k, v, o, B, H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, os_, st);
    case 64: return launch<64>(q, k, v, o, B, H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, os_, st);
    case 128: return launch<128>(q, k, v, o, B, H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, os_, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
