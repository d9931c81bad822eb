// Paged GQA decode attention for Hopper (sm_90a).
//
// Replaces repro/kernels/decode_attention.py: paged_decode_attention_pallas
// (body _decode_kernel). One query token per request attends over the KV
// pages its block-table row names, with an fp32 online softmax over pages.
//
// Bound on the H100: device-memory bytes. Each launch reads about
// B * cl * V * D * 2 (K and V) * 2 (bf16) bytes of KV and does 4 FLOPs per
// byte read, far below the ~295 FLOP/B ridge. Design: one thread block per
// (request b, KV head v) holds the g = H / V query rows of that head in
// shared memory, so every K/V byte is read from device memory once and
// reused by all g query heads. Pages are read in place from the engine's
// 6-D pool [frames, page, L, 2, vh, hd] through the layer slice's strides:
// the layer slice never becomes a copy. KV is not split across blocks, so
// the reduction order is fixed (no atomics, bitwise run to run).
//
// Semantics kept from the Pallas kernel: table entries clamped into
// [0, npages-1]; lengths clamped into [0, nb*page]; a row with cl <= 0
// writes zeros; masked scores are -1e30; l is clamped at 1e-30.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, __nv_bfloat16* __restrict__ out,
    int H, int V, int D, int page, int nb, int npages, int window,
    int q_sb, int q_sh, int k_sf, int k_st, int k_sh, int v_sf, int v_st,
    int v_sh) {
  const int b = blockIdx.x;
  const int vh = blockIdx.y;
  const int g = H / V;
  const int kd = D + 1;  // padded K rows: conflict-free column reads
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  extern __shared__ float smem[];
  float* qs = smem;              // [g, D]  scaled queries
  float* ks = qs + g * D;        // [page, D+1]
  float* vs = ks + page * kd;    // [page, D]
  float* acc = vs + page * D;    // [g, D]
  float* sc = acc + g * D;       // [g, page]  scores, then probabilities
  float* m_s = sc + g * page;    // [g]
  float* l_s = m_s + g;          // [g]
  float* a_s = l_s + g;          // [g]  rescale factor of this page

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = kThreads / 32;
  const int cl = min(max(context_lens[b], 0), nb * page);
  __nv_bfloat16* o = out + (static_cast<long long>(b) * H + vh * g) * D;
  if (cl <= 0) {
    for (int i = tid; i < g * D; i += kThreads) o[i] = __float2bfloat16(0.0f);
    return;
  }
  for (int i = tid; i < g * D; i += kThreads) {
    const int gi = i / D, d = i - gi * D;
    const long long off = static_cast<long long>(b) * q_sb
                        + static_cast<long long>(vh * g + gi) * q_sh + d;
    qs[i] = __bfloat162float(q[off]) * scale;
    acc[i] = 0.0f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }
  __syncthreads();

  const int n_pages = (cl + page - 1) / page;
  for (int j = 0; j < n_pages; ++j) {
    if (window > 0 && (j + 1) * page <= cl - window) continue;  // dead page
    const int frame = min(max(block_tables[b * nb + j], 0), npages - 1);
    const __nv_bfloat16* kp = k + static_cast<long long>(frame) * k_sf
                            + static_cast<long long>(vh) * k_sh;
    const __nv_bfloat16* vp = v + static_cast<long long>(frame) * v_sf
                            + static_cast<long long>(vh) * v_sh;
    for (int i = tid; i < page * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      ks[t * kd + d] = __bfloat162float(kp[static_cast<long long>(t) * k_st + d]);
      vs[i] = __bfloat162float(vp[static_cast<long long>(t) * v_st + d]);
    }
    __syncthreads();
    // scores s[gi, t] = q[gi] . k[t], masked to -1e30 outside the context
    for (int i = tid; i < g * page; i += kThreads) {
      const int gi = i / page, t = i - gi * page;
      const int kpos = j * page + t;
      const bool valid = kpos < cl && (window <= 0 || kpos >= cl - window);
      float s = kNegInf;
      if (valid) {
        const float* qr = qs + gi * D;
        const float* kr = ks + t * kd;
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
      }
      sc[i] = s;
    }
    __syncthreads();
    // online softmax, one warp per query row
    for (int gi = warp; gi < g; gi += nwarps) {
      float* row = sc + gi * page;
      const float m_prev = m_s[gi];
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, row[t]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.0f;
      for (int t = lane; t < page; t += 32) {
        const int kpos = j * page + t;
        const bool valid = kpos < cl && (window <= 0 || kpos >= cl - window);
        const float p = valid ? expf(row[t] - m_new) : 0.0f;
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[gi] = alpha;
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();
    // acc[gi, d] = acc * alpha + sum_t p[gi, t] * v[t, d]
    for (int i = tid; i < g * D; i += kThreads) {
      const int gi = i / D, d = i - gi * D;
      const float* pr = sc + gi * page;
      float a = acc[i] * a_s[gi];
      for (int t = 0; t < page; ++t) a = fmaf(pr[t], vs[t * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < g * D; i += kThreads) {
    const int gi = i / D;
    o[i] = __float2bfloat16(acc[i] / fmaxf(l_s[gi], 1e-30f));
  }
}

}  // namespace

// q [B,H,D], pages addressed as base + frame*sf + token*st + head*sh + d,
// block_tables [B,nb] int32, context_lens [B] int32, out [B,H,D]
// contiguous. Launches on `stream`; returns cudaGetLastError().
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* block_tables,
    const void* context_lens, void* out, int B, int H, int V, int D,
    int page, int nb, int npages, int window, int q_sb, int q_sh, int k_sf,
    int k_st, int k_sh, int v_sf, int v_st, int v_sh, void* stream) {
  const int g = H / V;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(g) * D * 2 + static_cast<size_t>(page) * (2 * D + 1)
       + static_cast<size_t>(g) * page + 3 * g);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(paged_decode_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  dim3 grid(B, V);
  paged_decode_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<__nv_bfloat16*>(out),
      H, V, D, page, nb, npages, window, q_sb, q_sh, k_sf, k_st, k_sh, v_sf,
      v_st, v_sh);
  return static_cast<int>(cudaGetLastError());
}
