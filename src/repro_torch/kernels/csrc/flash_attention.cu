// Flash attention forward for Hopper (sm_90a), prefill path.
//
// Replaces repro/kernels/flash_attention.py: flash_attention_pallas (body
// _flash_kernel). Dense attention with causal, sliding-window and kv_len
// masks; pos_offset aligns the queries to the last Sq keys; GQA maps query
// head h to KV head h / (H / V); fp32 online softmax, bf16 in and out.
//
// Bound on the H100: operations for long prompts. Under the causal mask a
// prefill does about 2 * B * H * Sq * Sk * D FLOPs (QK^T plus PV, halved by
// the mask) against O((Sq + Sk) * D) bytes. Design: one thread block per
// (query tile of 64 rows, head, batch row) keeps its query tile and the
// running (m, l, acc) on chip and walks KV tiles of 64 keys only up to the
// causal bound, skipping tiles the masks leave empty exactly as the Pallas
// kernel prunes them, so no score matrix ever reaches device memory. This
// first version multiplies with fp32 FMAs out of shared memory (4 x 4 score
// and 4 x D/16 output register tiles per thread); tensor cores (mma/wgmma)
// are later work. Reductions run in a fixed order: no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Strides {
  int b, h, s;  // element strides of batch, head and sequence (d is unit)
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int kv_len,
                                        int causal, int window) {
  bool ok = kpos < kv_len;
  if (causal) {
    ok = ok && kpos <= qpos;
    if (window > 0) ok = ok && kpos > qpos - window;
  }
  return ok;
}

template <int D>
size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1)
                          + static_cast<size_t>(kBK) * (D + 1)
                          + static_cast<size_t>(kBK) * D
                          + static_cast<size_t>(kBQ) * (kBK + 1) + 3 * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int H, int V, int Sq, int Sk, int kv_len, int causal, int window,
    int pos_off, Strides qs_, Strides ks_, Strides vs_, Strides os_) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int CJ = D / 16;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ, D+1] scaled queries
  float* Ks = Qs + kBQ * DP;      // [BK, D+1]
  float* Vs = Ks + kBK * DP;      // [BK, D]
  float* Ps = Vs + kBK * D;       // [BQ, BK+1] scores, then probabilities
  float* m_s = Ps + kBQ * PP;     // [BQ]
  float* l_s = m_s + kBQ;         // [BQ]
  float* a_s = l_s + kBQ;         // [BQ]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / V);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * kBQ;

  const __nv_bfloat16* qb = q + static_cast<long long>(b) * qs_.b
                          + static_cast<long long>(h) * qs_.h;
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * ks_.b
                          + static_cast<long long>(kvh) * ks_.h;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * vs_.b
                          + static_cast<long long>(kvh) * vs_.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float x = 0.0f;
    if (q0 + r < Sq) x = __bfloat162float(qb[static_cast<long long>(q0 + r) * qs_.s + d]) * scale;
    Qs[r * DP + d] = x;
  }
  for (int i = tid; i < kBQ; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }

  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.0f;

  const int q_lo = q0 + pos_off;
  const int q_hi = q_lo + kBQ - 1;
  const int nk = (Sk + kBK - 1) / kBK;
  for (int jt = 0; jt < nk; ++jt) {
    const int k_lo = jt * kBK, k_hi = k_lo + kBK - 1;
    bool live = k_lo < kv_len;
    if (causal) {
      live = live && k_lo <= q_hi;
      if (window > 0) live = live && k_hi > q_lo - window;
    }
    if (!live) continue;  // uniform across the block
    __syncthreads();      // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      float kx = 0.0f, vx = 0.0f;
      if (k_lo + r < Sk) {
        kx = __bfloat162float(kb[static_cast<long long>(k_lo + r) * ks_.s + d]);
        vx = __bfloat162float(vb[static_cast<long long>(k_lo + r) * vs_.s + d]);
      }
      Ks[r * DP + d] = kx;
      Vs[r * D + d] = vx;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, cols tx + 16 c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) bk[c] = Ks[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(a[i], bk[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        Ps[r * PP + col] = visible(q_lo + r, k_lo + col, kv_len, causal, window)
                               ? s[i][c] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, lanes own cols l, l+32
    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      float* row = Ps + r * PP;
      const float m_prev = m_s[r];
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = visible(q_lo + r, k_lo + lane, kv_len, causal, window)
                           ? expf(s0 - m_new) : 0.0f;
      const float p1 = visible(q_lo + r, k_lo + lane + 32, kv_len, causal, window)
                           ? expf(s1 - m_new) : 0.0f;
      row[lane] = p0;
      row[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P V for rows ty + 16 i, cols tx + 16 c
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] *= alpha;
    }
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const float vx = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vx, acc[i][c]);
      }
    }
  }
  __syncthreads();

  __nv_bfloat16* ob = o + static_cast<long long>(b) * os_.b
                    + static_cast<long long>(h) * os_.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < CJ; ++c)
      ob[static_cast<long long>(q0 + r) * os_.s + tx + 16 * c] = __float2bfloat16(acc[i][c] / l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int V, int Sq, int Sk, int kv_len, int causal, int window,
           int pos_off, Strides qs_, Strides ks_, Strides vs_, Strides os_,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaFuncSetAttribute(flash_fwd_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, V, Sq, Sk, kv_len, causal, window, pos_off, qs_, ks_, vs_, os_);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B,H,Sq,D], k/v [B,V,Sk,D], o [B,H,Sq,D], each addressed through its
// (batch, head, sequence) element strides with unit stride along D.
// D must be 16, 32, 64 or 128. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported D.
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
