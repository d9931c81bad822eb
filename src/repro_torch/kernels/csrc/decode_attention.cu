// Paged GQA decode attention for Hopper (sm_90a), split across KV.
//
// Replaces repro/kernels/decode_attention.py: paged_decode_attention_pallas
// (body _decode_kernel). One query token per request attends over the KV
// pages its block-table row names, with an fp32 softmax.
//
// Bound on the H100: device-memory bytes. Each launch reads about
// B * cl * V * D * 2 (K and V) * 2 (bf16) bytes of KV and does 4 FLOPs per
// byte read, far below the ~295 FLOP/B ridge, so the design is about
// having enough blocks reading at once, in 16-byte pieces. Pages are read
// in place from the engine's 6-D pool [frames, page, L, 2, vh, hd] through
// the layer slice's strides: the layer slice never becomes a copy.
//
// Two kernels, launched back to back on the caller's stream:
//  1. decode_split_kernel, grid (B, V, S): split s of request b covers the
//     fixed span of kPagesPerSplit table pages [s * P, (s + 1) * P). Its
//     bounds depend only on the page index, never on the batch or the
//     card. The block copies the span's live K and V rows into shared
//     memory with 16-byte cp.async (K and V in two groups, so V is still
//     arriving while the scores are computed), holds the g = H / V query
//     rows of its KV head, so every K/V byte is read once for all of them,
//     computes each score with a group of lanes splitting D (D / 8 of them
//     hold 8 values each; the group is rounded up to a power of two, and a
//     lane past D adds zero) and a shuffle reduction, takes the fp32
//     softmax of the span's scores and writes the
//     partial (m, l, acc [g, D]) in fp32 to a scratch the wrapper
//     allocates. A span with no live token writes m = -1e30, l = 0.
//  2. decode_combine_kernel, grid (B, H): merges the partials of each
//     (b, v, g) in split order, with no atomics, and writes
//     acc / max(l, 1e-30) as bf16.
// Every sum runs in a fixed order, so the output bits repeat from run to
// run and a request's bits do not depend on the rest of its batch.
//
// Semantics kept from the Pallas kernel: table entries clamped into
// [0, npages-1]; lengths clamped into [0, nb*page]; a row with cl <= 0
// writes zeros; a key is visible when kpos < cl and, with a window,
// kpos >= cl - window (masked scores are -1e30); l is clamped at 1e-30.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kPagesPerSplit = 4;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // query rows whose score reductions interleave

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

struct PoolView {
  const __nv_bfloat16* base;
  int sf, st, sh;  // element strides of frame, token and head (d is unit)
};

// the span's live rows [lo, hi) of one pool view into a dense [n, D] tile;
// `frames` holds the span's clamped table entries, t0 its first token
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, PoolView pv,
                                          const int* frames, int t0, int lo,
                                          int hi, int vh, int D, int page) {
  const int chunks = D / 8;
  const int n = (hi - lo) * chunks;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const int t = lo + r - t0, j = t / page;
    const __nv_bfloat16* src = pv.base + static_cast<long long>(frames[j]) * pv.sf
                             + static_cast<long long>(t - j * page) * pv.st
                             + static_cast<long long>(vh) * pv.sh + c * 8;
    cp_async16(dst + r * D + c * 8, src);
  }
}

// kPadLanes: D / 8 is not a power of two, so the score groups carry lanes
// past D; a power-of-two D compiles without the test (the test at run time
// for every D took 1.13x the time at D 256 and 1.02x at D 128, one H100,
// kernels/ab_decode.py)
template <bool kPadLanes>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const __nv_bfloat16* __restrict__ q, PoolView kv_k, PoolView kv_v,
    const int* __restrict__ block_tables, const int* __restrict__ context_lens,
    float* __restrict__ part, int H, int V, int D, int page, int nb,
    int npages, int window, int S, int q_sb, int q_sh) {
  const int b = blockIdx.x, vh = blockIdx.y, s = blockIdx.z;
  const int g = H / V;
  const int span = kPagesPerSplit * page;
  const long long rows = static_cast<long long>(gridDim.x) * V * S * g;
  const long long row0 = ((static_cast<long long>(b) * V + vh) * S + s) * g;
  float* p_acc = part + row0 * D;
  float* p_m = part + rows * D + row0;
  float* p_l = p_m + rows;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [span][D]
  __nv_bfloat16* vs = ks + span * D;                                // [span][D]
  const int gp = (g + kRows - 1) / kRows * kRows;
  float* qs = reinterpret_cast<float*>(vs + span * D);              // [gp][D]
  float* sc = qs + gp * D;                                          // [g][span]
  float* ml = sc + g * span;                                        // [2][g]
  int* frames = reinterpret_cast<int*>(ml + 2 * g);                 // [P]

  // the span's table entries, clamped into the pool, read beside the length
  const int t0 = s * span;
  if (threadIdx.x < kPagesPerSplit) {
    const int j = s * kPagesPerSplit + threadIdx.x;
    frames[threadIdx.x] = j < nb ? min(max(block_tables[static_cast<long long>(b) * nb + j], 0),
                                       npages - 1)
                                 : 0;
  }
  const int cl = min(max(context_lens[b], 0), nb * page);
  const int lo = max(t0, window > 0 ? cl - window : 0);
  const int hi = min(t0 + span, cl);
  if (lo >= hi) {  // no live key in this span
    for (int i = threadIdx.x; i < g; i += kThreads) {
      p_m[i] = kNegInf;
      p_l[i] = 0.0f;
    }
    return;
  }
  const int n = hi - lo;
  __syncthreads();

  load_rows(ks, kv_k, frames, t0, lo, hi, vh, D, page);
  cp_async_commit();
  load_rows(vs, kv_v, frames, t0, lo, hi, vh, D, page);
  cp_async_commit();

  // the g query rows, scaled in fp32; rows g .. gp-1 are zero
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  for (int i = threadIdx.x; i < gp * D; i += kThreads) {
    const int gi = i / D, d = i - gi * D;
    qs[i] = gi < g ? __bfloat162float(q[static_cast<long long>(b) * q_sb
                                        + static_cast<long long>(vh * g + gi) * q_sh + d])
                         * scale
                   : 0.0f;
  }
  cp_async_wait<1>();  // K is here; V may still be in flight
  __syncthreads();

  // scores: a group of `lanes` lanes per key row, each lane 8 of its D
  // values, kRows query rows at a time so their shuffle reductions
  // interleave; `lanes` is D / 8 rounded up to a power of two, and a lane
  // at or past D (li * 8 >= D) adds zero. Every lane of a warp runs the
  // same number of rounds, so the shuffles stay converged
  const int chunks = D / 8;
  int lanes = 1;
  while (lanes < chunks) lanes <<= 1;
  const int groups = kThreads / lanes;
  const int grp = threadIdx.x / lanes, li = threadIdx.x - grp * lanes;
  const bool in_d = !kPadLanes || li < chunks;
  for (int base = 0; base < n; base += groups) {
    const int t = base + grp;
    float kf[8];
    if (t < n && in_d) {
      unpack8(*reinterpret_cast<const uint4*>(ks + t * D + li * 8), kf);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = 0.0f;
    }
    for (int g0 = 0; g0 < g; g0 += kRows) {
      float dot[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (in_d) {
          const float4* qr = reinterpret_cast<const float4*>(qs + (g0 + r) * D + li * 8);
          const float4 a = qr[0], c = qr[1];
          dot[r] = a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3]
                 + c.x * kf[4] + c.y * kf[5] + c.z * kf[6] + c.w * kf[7];
        } else {
          dot[r] = 0.0f;
        }
      }
      for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
      }
      if (t < n && li == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (g0 + r < g) sc[(g0 + r) * span + t] = dot[r];
      }
    }
  }
  __syncthreads();

  // softmax over the span's live keys, one warp per query row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int gi = warp; gi < g; gi += kWarps) {
    float* row = sc + gi * span;
    float mx = kNegInf;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, row[t]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(row[t] - mx);
      row[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[gi] = mx;
      ml[g + gi] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // acc[gi, 8c .. 8c+7] = sum_t p[gi, t] v[t, 8c .. 8c+7]
  for (int i = threadIdx.x; i < g * chunks; i += kThreads) {
    const int gi = i / chunks, c = i - gi * chunks;
    const float* pr = sc + gi * span;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      float vf[8];
      unpack8(*reinterpret_cast<const uint4*>(vs + t * D + c * 8), vf);
      const float p = pr[t];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    float4* dst = reinterpret_cast<float4*>(p_acc + gi * D + c * 8);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  for (int i = threadIdx.x; i < g; i += kThreads) {
    p_m[i] = ml[i];
    p_l[i] = ml[g + i];
  }
}

__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ part, const int* __restrict__ context_lens,
    __nv_bfloat16* __restrict__ out, int H, int V, int D, int page, int nb,
    int S) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = H / V, vh = h / g, gi = h - vh * g;
  const long long rows = static_cast<long long>(gridDim.x) * V * S * g;
  const long long row0 = (static_cast<long long>(b) * V + vh) * S * g + gi;
  const float* p_m = part + rows * D;
  const float* p_l = p_m + rows;
  __nv_bfloat16* o = out + (static_cast<long long>(b) * H + h) * D;
  const int cl = min(max(context_lens[b], 0), nb * page);
  if (cl <= 0) {
    for (int d = threadIdx.x; d < D; d += kThreads) o[d] = __float2bfloat16(0.0f);
    return;
  }
  extern __shared__ float sm[];  // [S] maxima, then weights; [S] sums
  float* sl = sm + S;
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const long long r = row0 + static_cast<long long>(s) * g;
    sm[s] = p_m[r];
    sl[s] = p_l[r];
  }
  __syncthreads();
  // splits in order: the global max, each split's weight, the sum
  float m = kNegInf;
  for (int s = 0; s < S; ++s)
    if (sl[s] > 0.0f) m = fmaxf(m, sm[s]);
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += kThreads)
    sm[s] = sl[s] > 0.0f ? expf(sm[s] - m) : 0.0f;
  __syncthreads();
  float l = 0.0f;
  for (int s = 0; s < S; ++s) l = fmaf(sl[s], sm[s], l);
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float acc = 0.0f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      // a span with no live key left its acc unwritten: skip, never read
      if (sl[s] > 0.0f)
        acc = fmaf(part[(row0 + static_cast<long long>(s) * g) * D + d], sm[s], acc);
    }
    o[d] = __float2bfloat16(acc * inv);
  }
}

size_t split_smem_bytes(int g, int D, int page) {
  const size_t span = static_cast<size_t>(kPagesPerSplit) * page;
  const size_t gp = (g + kRows - 1) / kRows * kRows;
  return 2 * span * D * sizeof(__nv_bfloat16)
         + sizeof(float) * (gp * D + g * span + 2 * g)
         + sizeof(int) * kPagesPerSplit;
}

}  // namespace

// The table pages one split covers: the wrapper sizes its scratch by it.
extern "C" int paged_decode_pages_per_split() { return kPagesPerSplit; }

// q [B,H,D]; pages addressed as base + frame*sf + token*st + head*sh + d
// (16-byte aligned, strides in multiples of 8 elements, D a multiple of 8
// up to 256); block_tables [B,nb] int32; context_lens [B] int32; part
// an fp32 scratch of B*V*S*g*(D+2) floats, S = ceil(nb / pages per split);
// out [B,H,D] contiguous; S up to 6144 (the combine's shared memory).
// Launches both kernels on `stream`; returns cudaGetLastError().
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* block_tables,
    const void* context_lens, void* part, void* out, int B, int H, int V,
    int D, int page, int nb, int npages, int window, int q_sb, int q_sh,
    int k_sf, int k_st, int k_sh, int v_sf, int v_st, int v_sh, void* stream) {
  const int g = H / V;
  const int S = (nb + kPagesPerSplit - 1) / kPagesPerSplit;
  const size_t smem = split_smem_bytes(g, D, page);
  const int chunks = D / 8;
  const bool pad = (chunks & (chunks - 1)) != 0;
  auto split = pad ? decode_split_kernel<true> : decode_split_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PoolView kv_k{static_cast<const __nv_bfloat16*>(k), k_sf, k_st, k_sh};
  const PoolView kv_v{static_cast<const __nv_bfloat16*>(v), v_sf, v_st, v_sh};
  split<<<dim3(B, V, S), kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), kv_k, kv_v,
      static_cast<const int*>(block_tables), static_cast<const int*>(context_lens),
      static_cast<float*>(part), H, V, D, page, nb, npages, window, S, q_sb,
      q_sh);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<dim3(B, H), kThreads, 2 * S * sizeof(float), st>>>(
      static_cast<const float*>(part), static_cast<const int*>(context_lens),
      static_cast<__nv_bfloat16*>(out), H, V, D, page, nb, S);
  return static_cast<int>(cudaGetLastError());
}
