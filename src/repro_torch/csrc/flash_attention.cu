// Causal/windowed GQA attention for prefill, and single-query decode
// attention against a position-annotated ring-buffer KV cache, written by
// hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/flash_attention/kernel.py::
// flash_attention (grid (B, H, n_q, n_k), the k axis sequential with the
// online-softmax state in VMEM scratch) and ::decode_attention (grid
// (B, Kv, n_t), the cache axis sequential).
//
// Both take float32 or bfloat16 q/k/v (bf16 is the model's compute dtype,
// f32 the conformance dtype), accumulate in float32, round the softmax
// probabilities to v's dtype before P.V (as _flash_body's p.astype(v.dtype)
// does) and write the output in q's dtype.  A key is admitted for a query
// when kp >= 0 (-1 marks an empty or pad slot), kp <= qp when causal, and
// qp - kp < window when window > 0: the reference's mask.  A query row that
// admits no key is written as 0, never NaN (the reference's contract calls
// such a row garbage; the oracle returns a uniform average there).
//
// flash_kernel (prefill).  What bounds it on the H100: operations.  A
// prefill of S queries against its own keys does ~4 S^2/2 Dh flops per head
// against O(S Dh) bytes; this first version runs them on the float32 pipes
// (mma.sync/wgmma on bf16 tiles come later), so the bound it is held to
// (989 TFLOP/s bf16) is far off.  What the design does about it: one block
// per (q tile of BQ rows, head, batch row); a loop inside the block over
// k tiles replaces the TPU's sequential k grid axis.  The Q tile and the
// current K (then V) tile sit in shared memory as float32; each of the 256
// threads computes a (BQ/16) x (BK/16) piece of S = Q K^T from registers,
// keeps its rows' running max and sum (m, l) and a (BQ/16) x (Dh/16) piece
// of the accumulator, and the probabilities go through shared memory into
// P.V.  GQA maps head h to kv head h / (H / Kv).  Work the mask refuses is
// skipped two ways: with k_index_aligned (slot j holds position j, or
// positions are index-aligned up to a left-pad offset) a causal q tile
// stops at its last row's index, as _flash_body's causal block skip does;
// and every k tile whose keys are all refused for every query of the q
// tile (from the tile's position range: no valid key, all keys after the
// last query, or all beyond the window) is skipped.  The second skip only
// reads positions, so it is sound for any positions, a wrapped ring
// included; it is what makes a left-padded prefill cost its prompt, not its
// bucket.  Ragged S and T tails are masked in the kernel.
//
// decode_split_kernel + decode_combine_kernel (decode).  What bounds it:
// bytes.  One query per (row, head) reads every valid K/V row of the cache
// once (2 Dh flops per byte pair).  What the design does about it: the
// cache is read in its native (B, T, Kv, Dh) layout through its strides
// (no copy), 16 bytes a thread.  At 8 rows x 8 kv heads there are only 64
// (b, kv) pairs for 132 SMs, so T is split into chunks of bkv slots across
// blocks (flash-decoding): block (split, kv, b) computes the G = H / Kv
// query heads of its kv head over its chunk (each K/V row is read once for
// all G heads), skipping chunks and rows whose positions are refused, and
// writes an unnormalised partial (m, l, acc); a second kernel combines the
// partials of each (b, h) in split order.  No atomics, so the result is
// bit-for-bit repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF (running max)
constexpr int kFlashThreads = 256;
constexpr int kDecodeThreads = 128;
constexpr int kMaxGroup = 8;       // query heads per kv head (decode)
constexpr int kMaxBkv = 512;       // cache slots per decode block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// p rounded to v's dtype and back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// eight consecutive elements (16-byte aligned) as float32
__device__ __forceinline__ void load8(float* out, const float* ptr) {
  const float4 a = *reinterpret_cast<const float4*>(ptr);
  const float4 b = *reinterpret_cast<const float4*>(ptr + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(float* out, const __nv_bfloat16* ptr) {
  const uint4 raw = *reinterpret_cast<const uint4*>(ptr);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ bool admitted(int qp, int kp, int causal,
                                         int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window == 0 || qp - kp < window);
}

// ---------------------------------------------------------------------------
// prefill
// ---------------------------------------------------------------------------
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_pos;  // (B, S) or null: token i at position i
  const int* k_pos;  // (B, T) or null
  long long qs[3], ks[3], vs[3], os[3];  // element strides of (b, head, row)
  long long qps, kps;                    // row strides of q_pos / k_pos
  int heads, kv_heads, s, t;
  int causal, window, aligned;
  float scale;
};

template <int DH, int RI, int CJ>
constexpr int flash_smem_bytes() {
  return (16 * RI * (DH + 1) + 16 * CJ * (DH + 1) + 16 * RI * (16 * CJ + 1)) *
             4 + (16 * RI + 16 * CJ) * 4;
}

template <typename T, int DH, int RI, int CJ>
__global__ void __launch_bounds__(kFlashThreads)
    flash_kernel(const FlashParams p) {
  constexpr int BQ = 16 * RI, BK = 16 * CJ, DJ = DH / 16;
  constexpr int QLD = DH + 1, PLD = BK + 1;  // odd strides: no bank conflicts
  extern __shared__ float smem[];
  float* qs = smem;                // BQ x QLD
  float* kvs = qs + BQ * QLD;      // BK x QLD: the K tile, then the V tile
  float* ps = kvs + BK * QLD;      // BQ x PLD
  int* qp_s = reinterpret_cast<int*>(ps + BQ * PLD);  // BQ
  int* kp_s = qp_s + BQ;                               // BK
  __shared__ int q_lo, q_hi, live;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int nq = min(BQ, p.s - q0);
  const int kvh = h / (p.heads / p.kv_heads);
  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[1];
  T* o = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[1];

  for (int i = tid; i < BQ * DH; i += kFlashThreads) {
    const int r = i / DH, d = i % DH;
    qs[r * QLD + d] = r < nq ? to_float(q[(q0 + r) * p.qs[2] + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += kFlashThreads)
    qp_s[r] = r < nq ? (p.q_pos ? p.q_pos[b * p.qps + q0 + r] : q0 + r) : -1;
  __syncthreads();
  if (tid == 0) {  // the q tile's position range (rows past S excluded)
    int lo = qp_s[0], hi = qp_s[0];
    for (int r = 1; r < nq; ++r) {
      lo = min(lo, qp_s[r]);
      hi = max(hi, qp_s[r]);
    }
    q_lo = lo;
    q_hi = hi;
  }

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int n_k = (p.t + BK - 1) / BK;
  // the reference's causal block skip: k tiles past the q tile's last row
  const int kt_end =
      (p.causal && p.aligned) ? min(n_k, (q0 + BQ - 1) / BK + 1) : n_k;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK, nk = min(BK, p.t - k0);
    for (int c = tid; c < BK; c += kFlashThreads)
      kp_s[c] = c < nk ? (p.k_pos ? p.k_pos[b * p.kps + k0 + c] : k0 + c) : -1;
    __syncthreads();
    if (tid == 0) {  // does any (query, key) pair of the two tiles survive?
      int lo = 0x7fffffff, hi = -1;
      for (int c = 0; c < nk; ++c) {
        if (kp_s[c] >= 0) {
          lo = min(lo, kp_s[c]);
          hi = max(hi, kp_s[c]);
        }
      }
      live = hi >= 0 && (!p.causal || lo <= q_hi) &&
             (p.window == 0 || hi > q_lo - p.window);
    }
    __syncthreads();
    if (!live) continue;

    for (int i = tid; i < BK * DH; i += kFlashThreads) {
      const int c = i / DH, d = i % DH;
      kvs[c * QLD + d] = c < nk ? to_float(k[(k0 + c) * p.ks[2] + d]) : 0.f;
    }
    __syncthreads();

    float sc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = qs[(ty + 16 * i) * QLD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = kvs[(tx + 16 * j) * QLD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // online softmax: a row's 16 threads (same ty) share its max and sum
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i, qp = qp_s[r];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const bool ok = admitted(qp, kp_s[tx + 16 * j], p.causal, p.window);
        sc[i][j] = ok ? sc[i][j] * p.scale : -CUDART_INF_F;
        mt = fmaxf(mt, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float pij = expf(sc[i][j] - m_new);  // refused: exp(-inf) = 0
        rs += pij;
        ps[r * PLD + tx + 16 * j] = round_to<T>(pij);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // S is done with the K tile

    for (int i = tid; i < BK * DH; i += kFlashThreads) {
      const int c = i / DH, d = i % DH;
      kvs[c * QLD + d] = c < nk ? to_float(v[(k0 + c) * p.vs[2] + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < nk; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = ps[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = kvs[c * QLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    // the next tile writes only kp_s before its first barrier; the K/V and
    // P buffers are rewritten after it, once every thread is past P.V
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        o[(q0 + r) * p.os[2] + tx + 16 * j] = from_float<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int DH, int RI, int CJ>
int launch_flash(const FlashParams& p, int batch, cudaStream_t stream) {
  constexpr int smem = flash_smem_bytes<DH, RI, CJ>();
  static bool configured = false;  // once per instantiation and process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, DH, RI, CJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((p.s + 16 * RI - 1) / (16 * RI), p.heads, batch);
  flash_kernel<T, DH, RI, CJ><<<grid, kFlashThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int flash_tiles(const FlashParams& p, int batch, int bq, int bk,
                cudaStream_t stream) {
  if (bq == 64 && bk == 64) return launch_flash<T, DH, 4, 4>(p, batch, stream);
  if (bq == 64 && bk == 32) return launch_flash<T, DH, 4, 2>(p, batch, stream);
  if (bq == 32 && bk == 64) return launch_flash<T, DH, 2, 4>(p, batch, stream);
  if (bq == 32 && bk == 32) return launch_flash<T, DH, 2, 2>(p, batch, stream);
  return -1;
}

template <typename T>
int flash_dh(const FlashParams& p, int batch, int dh, int bq, int bk,
             cudaStream_t stream) {
  switch (dh) {
    case 16: return flash_tiles<T, 16>(p, batch, bq, bk, stream);
    case 32: return flash_tiles<T, 32>(p, batch, bq, bk, stream);
    case 64: return flash_tiles<T, 64>(p, batch, bq, bk, stream);
    case 128: return flash_tiles<T, 128>(p, batch, bq, bk, stream);
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------
struct DecodeParams {
  const void* q;        // (B, 1, H, Dh), contiguous
  const void* k;        // (B, T, Kv, Dh) through ks
  const void* v;        // (B, T, Kv, Dh) through vs
  const int* q_pos;     // (B, 1)
  const int* k_pos;     // (B, T) through kps
  float* m_part;        // (B, Kv, nsplit, G)
  float* l_part;        // (B, Kv, nsplit, G)
  float* acc_part;      // (B, Kv, nsplit, G, Dh)
  long long ks[3], vs[3];  // element strides of (b, t, kv head)
  long long kps;
  int heads, kv_heads, t, bkv, nsplit, window;
  float scale;
};

template <int DH>
constexpr int decode_smem_bytes() {
  // q (G x Dh) + logits (G x bkv) + partial sums (groups x G x Dh) + flags
  return (kMaxGroup * DH + kMaxGroup * kMaxBkv +
          kDecodeThreads * 8 * kMaxGroup) * 4 + kMaxBkv;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kDecodeThreads)
    decode_split_kernel(const DecodeParams p) {
  constexpr int VEC = 8, TPK = DH / VEC, NGRP = kDecodeThreads / TPK;
  const int G = p.heads / p.kv_heads;
  extern __shared__ float smem[];
  float* qs = smem;                // G x Dh
  float* ls = qs + G * DH;         // G x bkv: logits, then probabilities
  float* red = ls + G * p.bkv;     // NGRP x G x Dh
  unsigned char* ok_s = reinterpret_cast<unsigned char*>(red + NGRP * G * DH);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = split * p.bkv, n = min(p.bkv, p.t - t0);
  const int qp = p.q_pos[b];
  const long long part =
      (static_cast<long long>(b * p.kv_heads + kvh) * p.nsplit + split) * G;

  int any = 0;
  for (int t = tid; t < n; t += kDecodeThreads) {
    const bool ok = admitted(qp, p.k_pos[b * p.kps + t0 + t], 1, p.window);
    ok_s[t] = ok;
    any |= ok;
  }
  if (!__syncthreads_or(any)) {  // nothing admitted: an empty partial
    for (int i = tid; i < G * DH; i += kDecodeThreads)
      p.acc_part[part * DH + i] = 0.f;
    if (tid < G) {
      p.m_part[part + tid] = kNegInf;
      p.l_part[part + tid] = 0.f;
    }
    return;
  }
  const T* q = static_cast<const T*>(p.q) +
               (static_cast<long long>(b) * p.heads + kvh * G) * DH;
  for (int i = tid; i < G * DH; i += kDecodeThreads) qs[i] = to_float(q[i]);
  __syncthreads();

  // logits: a team of TPK threads per key, 8 elements a thread
  const int grp = tid / TPK, lane = tid % TPK;
  const T* kb = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[2] +
                lane * VEC;
  const T* vb = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[2] +
                lane * VEC;
  for (int base = 0; base < n; base += NGRP) {  // same trip count per warp
    const int t = base + grp;
    const bool ok = t < n && ok_s[t];
    float kf[VEC];
    if (ok) {
      load8(kf, kb + (t0 + t) * p.ks[1]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[e] = 0.f;
    }
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s = fmaf(qs[g * DH + lane * VEC + e], kf[e], s);
#pragma unroll
      for (int off = TPK / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0 && t < n) ls[g * p.bkv + t] = ok ? s * p.scale : -CUDART_INF_F;
    }
  }
  __syncthreads();

  // this chunk's max and sum for each query head: one warp a head
  const int warp = tid / 32, wl = tid % 32;
  for (int g = warp; g < G; g += kDecodeThreads / 32) {
    float mx = kNegInf;
    for (int t = wl; t < n; t += 32) mx = fmaxf(mx, ls[g * p.bkv + t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int t = wl; t < n; t += 32) {
      const float e = expf(ls[g * p.bkv + t] - mx);  // refused: 0
      sum += e;
      ls[g * p.bkv + t] = round_to<T>(e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (wl == 0) {
      p.m_part[part + g] = mx;
      p.l_part[part + g] = sum;
    }
  }
  __syncthreads();

  // P.V over the admitted rows, then a fixed-order sum over the teams
  float acc[kMaxGroup][VEC];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  for (int base = 0; base < n; base += NGRP) {
    const int t = base + grp;
    if (t < n && ok_s[t]) {
      float vf[VEC];
      load8(vf, vb + (t0 + t) * p.vs[1]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
          const float pg = ls[g * p.bkv + t];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        red[(grp * G + g) * DH + lane * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * DH; i += kDecodeThreads) {
    float s = 0.f;
    for (int gi = 0; gi < NGRP; ++gi) s += red[gi * G * DH + i];
    p.acc_part[part * DH + i] = s;
  }
}

// one block per (b, h): the partials of every split, in split order
template <typename T>
__global__ void decode_combine_kernel(const DecodeParams p, void* out,
                                      int dh) {
  const int G = p.heads / p.kv_heads;
  const int bh = blockIdx.x, b = bh / p.heads, h = bh % p.heads;
  const int kvh = h / G, g = h % G;
  const long long base =
      static_cast<long long>(b * p.kv_heads + kvh) * p.nsplit;
  float mx = kNegInf;
  for (int s = 0; s < p.nsplit; ++s) mx = fmaxf(mx, p.m_part[(base + s) * G + g]);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float l = 0.f, o = 0.f;
    for (int s = 0; s < p.nsplit; ++s) {
      const long long i = (base + s) * G + g;
      const float w = expf(p.m_part[i] - mx);
      l += p.l_part[i] * w;
      o += p.acc_part[i * dh + d] * w;
    }
    static_cast<T*>(out)[static_cast<long long>(bh) * dh + d] =
        from_float<T>(o / fmaxf(l, 1e-30f));
  }
}

template <typename T, int DH>
int launch_decode(const DecodeParams& p, void* out, int batch,
                  cudaStream_t stream) {
  constexpr int max_smem = decode_smem_bytes<DH>();
  static bool configured = false;  // once per instantiation and process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int G = p.heads / p.kv_heads;
  const int smem = (G * DH + G * p.bkv + kDecodeThreads * 8 * G) * 4 + p.bkv;
  const dim3 grid(p.nsplit, p.kv_heads, batch);
  decode_split_kernel<T, DH><<<grid, kDecodeThreads, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<batch * p.heads, DH, 0, stream>>>(p, out, DH);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int decode_dh(const DecodeParams& p, void* out, int batch, int dh,
              cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_decode<T, 16>(p, out, batch, stream);
    case 32: return launch_decode<T, 32>(p, out, batch, stream);
    case 64: return launch_decode<T, 64>(p, out, batch, stream);
    case 128: return launch_decode<T, 128>(p, out, batch, stream);
    default: return -1;
  }
}

}  // namespace

// Prefill attention on `stream`; returns cudaGetLastError() (0 on success)
// or -1 for a (dtype, dh, bq, bk) without an instantiation.  dtype 0 is
// float32, 1 bfloat16.  strides holds the element strides of dims 0-2 of q,
// k, v and o (12 values; dim 3 has stride 1).  q_pos/k_pos are null in index
// mode.  The caller checks shapes, dtypes, devices and heads % kv_heads.
extern "C" int flash_attention_fwd(
    int dtype, int dh, int bq, int bk, const void* q, const void* k,
    const void* v, void* o, const int* q_pos, const int* k_pos,
    const long long* strides, long long q_pos_stride, long long k_pos_stride,
    int batch, int heads, int kv_heads, int s, int t, int causal, int window,
    int aligned, float scale, cudaStream_t stream) {
  FlashParams p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_pos = q_pos; p.k_pos = k_pos;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.qps = q_pos_stride; p.kps = k_pos_stride;
  p.heads = heads; p.kv_heads = kv_heads; p.s = s; p.t = t;
  p.causal = causal; p.window = window; p.aligned = aligned;
  p.scale = scale;
  if (dtype == 0) return flash_dh<float>(p, batch, dh, bq, bk, stream);
  if (dtype == 1) return flash_dh<__nv_bfloat16>(p, batch, dh, bq, bk, stream);
  return -1;
}

// Decode attention on `stream` (the split pass, then the combine pass);
// returns cudaGetLastError() or -1 for a (dtype, dh) without an
// instantiation.  strides holds the element strides of dims 0-2 of k and of
// v (6 values; dim 3 has stride 1, rows 16-byte aligned).  The partial
// buffers hold batch * kv_heads * ceil(t / bkv) * (heads / kv_heads)
// (x dh for acc) floats.  The caller checks shapes, dtypes, alignment,
// heads / kv_heads <= 8 and bkv <= 512.
extern "C" int decode_attention_fwd(
    int dtype, int dh, const void* q, const void* k, const void* v, void* o,
    const int* q_pos, const int* k_pos, float* m_part, float* l_part,
    float* acc_part, const long long* strides, long long k_pos_stride,
    int batch, int heads, int kv_heads, int t, int bkv, int window,
    float scale, cudaStream_t stream) {
  DecodeParams p;
  p.q = q; p.k = k; p.v = v;
  p.q_pos = q_pos; p.k_pos = k_pos;
  p.m_part = m_part; p.l_part = l_part; p.acc_part = acc_part;
  for (int i = 0; i < 3; ++i) {
    p.ks[i] = strides[i];
    p.vs[i] = strides[3 + i];
  }
  p.kps = k_pos_stride;
  p.heads = heads; p.kv_heads = kv_heads; p.t = t; p.bkv = bkv;
  p.nsplit = (t + bkv - 1) / bkv;
  p.window = window; p.scale = scale;
  if (dtype == 0) return decode_dh<float>(p, o, batch, dh, stream);
  if (dtype == 1) return decode_dh<__nv_bfloat16>(p, o, batch, dh, stream);
  return -1;
}

extern "C" const char* attention_error_string(int err) {
  if (err == -1) return "no kernel instantiated for this dtype/head_dim/tile";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
