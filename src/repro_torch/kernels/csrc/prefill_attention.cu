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
// context passes about 20 tokens. Design: one thread block per (tile of
// query tokens, KV head). The tile's 64 rows are (token, query head) pairs
// holding all g = H / V heads of 64 / g tokens, so each K/V tile is read
// into shared memory once and serves 64 rows, as the decode kernel serves
// its g heads. The block walks key positions in tiles of 64 through the
// block table, in order, only up to the tile's last query position (causal
// pruning: a chunk's work stays O(C * prefix)), and reads pages in place
// from the engine's 6-D pool [frames, page, L, 2, vh, hd] through the layer
// slice's strides. Products are fp32 FMAs out of shared memory (4 x 4 score
// and 4 x D/16 output register tiles per thread), as in flash_attention.cu;
// tensor cores (mma/wgmma) and TMA are later work. KV is not split across
// blocks, so the reduction order is fixed (no atomics, bitwise run to run).
//
// Semantics kept from the Pallas kernel: table entries clamped into
// [0, npages-1]; the caller passes context_len clamped into [0, nb*page] and
// start into [0, context_len]; a page is live when j * page < context_len,
// and inside live pages a key is masked only by kpos <= qpos (no separate
// length mask); masked scores are -1e30; l is clamped at 1e-30, so
// context_len 0 writes zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;     // (token, query head) rows per block
constexpr int kBK = 64;       // key positions per tile
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kRows) * (D + 1)
                          + static_cast<size_t>(kBK) * (D + 1)
                          + static_cast<size_t>(kBK) * D
                          + static_cast<size_t>(kRows) * (kBK + 1) + 3 * kRows)
         + sizeof(int) * kRows;
}

template <int D>
__global__ void __launch_bounds__(kThreads) paged_chunk_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ block_table,
    __nv_bfloat16* __restrict__ out, int C, int H, int V, int page, int nb,
    int npages, int start, int cl, int q_st, int q_sh, int k_sf, int k_st,
    int k_sh, int v_sf, int v_st, int v_sh) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int CJ = D / 16;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  extern __shared__ float smem[];
  float* Qs = smem;               // [rows, D+1] scaled queries
  float* Ks = Qs + kRows * DP;    // [BK, D+1]
  float* Vs = Ks + kBK * DP;      // [BK, D]
  float* Ps = Vs + kBK * D;       // [rows, BK+1] scores, then probabilities
  float* m_s = Ps + kRows * PP;   // [rows]
  float* l_s = m_s + kRows;       // [rows]
  float* a_s = l_s + kRows;       // [rows] rescale factor of this tile
  int* qpos_s = reinterpret_cast<int*>(a_s + kRows);  // [rows], -1: padding

  const int g = H / V;
  const int tq = kRows / g;               // query tokens per block
  const int t0 = blockIdx.x * tq;
  const int vh = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;

  // row r holds token t0 + r / g and query head vh * g + r % g (the Pallas
  // kernel's [V, C*G] row order within the KV head)
  for (int r = tid; r < kRows; r += kThreads) {
    const int t = t0 + r / g;
    qpos_s[r] = (r < tq * g && t < C) ? start + t : -1;
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float x = 0.0f;
    if (qpos_s[r] >= 0) {
      const int t = t0 + r / g, h = vh * g + r % g;
      x = __bfloat162float(q[static_cast<long long>(t) * q_st
                             + static_cast<long long>(h) * q_sh + d]) * scale;
    }
    Qs[r * DP + d] = x;
  }

  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.0f;

  // keys [0, k_end) may be visible to some row of this block: live pages
  // only, and none past the block's last query position
  const int live_end = (cl + page - 1) / page * page;
  const int q_hi = start + min(t0 + tq, C) - 1;
  const int k_end = min(live_end, q_hi + 1);
  const __nv_bfloat16* kb = k + static_cast<long long>(vh) * k_sh;
  const __nv_bfloat16* vb = v + static_cast<long long>(vh) * v_sh;

  for (int k_lo = 0; k_lo < k_end; k_lo += kBK) {
    __syncthreads();      // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const int kpos = k_lo + r;
      float kx = 0.0f, vx = 0.0f;
      if (kpos < k_end) {
        const int j = kpos / page, off = kpos - j * page;
        const int frame = min(max(block_table[j], 0), npages - 1);
        kx = __bfloat162float(kb[static_cast<long long>(frame) * k_sf
                                 + static_cast<long long>(off) * k_st + d]);
        vx = __bfloat162float(vb[static_cast<long long>(frame) * v_sf
                                 + static_cast<long long>(off) * v_st + d]);
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
        const int kpos = k_lo + tx + 16 * c;
        Ps[r * PP + tx + 16 * c] =
            (kpos < live_end && kpos <= qpos_s[r]) ? s[i][c] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, lanes own cols l, l+32
    for (int rr = 0; rr < kRows / (kThreads / 32); ++rr) {
      const int r = warp * (kRows / (kThreads / 32)) + rr;
      float* row = Ps + r * PP;
      const int qp = qpos_s[r];
      const float m_prev = m_s[r];
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const int k0 = k_lo + lane, k1 = k_lo + lane + 32;
      const float p0 = (k0 < live_end && k0 <= qp) ? expf(s0 - m_new) : 0.0f;
      const float p1 = (k1 < live_end && k1 <= qp) ? expf(s1 - m_new) : 0.0f;
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

  // out [C, H, D] contiguous: the layout attn_out reads
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (qpos_s[r] < 0) continue;
    const int t = t0 + r / g, h = vh * g + r % g;
    const float l = fmaxf(l_s[r], 1e-30f);
    __nv_bfloat16* o = out + (static_cast<long long>(t) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CJ; ++c) o[tx + 16 * c] = __float2bfloat16(acc[i][c] / l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bt,
           void* out, int C, int H, int V, int page, int nb, int npages,
           int start, int cl, int q_st, int q_sh, int k_sf, int k_st, int k_sh,
           int v_sf, int v_st, int v_sh, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaFuncSetAttribute(paged_chunk_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int tq = kRows / (H / V);
  dim3 grid((C + tq - 1) / tq, V);
  paged_chunk_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(bt),
      static_cast<__nv_bfloat16*>(out), C, H, V, page, nb, npages, start, cl,
      q_st, q_sh, k_sf, k_st, k_sh, v_sf, v_st, v_sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [C,H,D] addressed as t*q_st + h*q_sh + d; pages addressed as
// base + frame*sf + token*st + head*sh + d; block_table [nb] int32;
// out [C,H,D] contiguous. start and cl come clamped by the caller. D must be
// 16, 32, 64 or 128 and H / V at most 64. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for unsupported shapes.
extern "C" int paged_chunk_attention_bf16(
    const void* q, const void* k, const void* v, const void* block_table,
    void* out, int C, int H, int V, int D, int page, int nb, int npages,
    int start, int cl, int q_st, int q_sh, int k_sf, int k_st, int k_sh,
    int v_sf, int v_st, int v_sh, void* stream) {
  if (V <= 0 || H % V != 0 || H / V > kRows || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, block_table, out, C, H, V, page, nb, npages, start, cl, q_st, q_sh, k_sf, k_st, k_sh, v_sf, v_st, v_sh, st);
    case 32: return launch<32>(q, k, v, block_table, out, C, H, V, page, nb, npages, start, cl, q_st, q_sh, k_sf, k_st, k_sh, v_sf, v_st, v_sh, st);
    case 64: return launch<64>(q, k, v, block_table, out, C, H, V, page, nb, npages, start, cl, q_st, q_sh, k_sf, k_st, k_sh, v_sf, v_st, v_sh, st);
    case 128: return launch<128>(q, k, v, block_table, out, C, H, V, page, nb, npages, start, cl, q_st, q_sh, k_sf, k_st, k_sh, v_sf, v_st, v_sh, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
