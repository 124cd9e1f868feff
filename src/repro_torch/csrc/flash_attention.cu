// Causal/windowed GQA attention for prefill, and single-query decode
// attention against a position-annotated ring-buffer KV cache, written by
// hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/flash_attention/kernel.py::
// flash_attention (grid (B, H, n_q, n_k), the k axis sequential with the
// online-softmax state in VMEM scratch) and ::decode_attention (grid
// (B, Kv, n_t), the cache axis sequential).
//
// Prefill runs bfloat16 (the model's compute dtype) on flash_wgmma_kernel
// and float32 (the conformance dtype) on flash_kernel; decode takes either.
// All accumulate in float32, round the softmax probabilities to v's dtype
// before P.V (as _flash_body's p.astype(v.dtype) does) while the row sums
// keep them unrounded, and write the output in q's dtype.  A key is
// admitted for a query when kp >= 0 (-1 marks an empty or pad slot),
// kp <= qp when causal, and qp - kp < window when window > 0: the
// reference's mask.  A query row that admits no key gets what the plain
// version and the reference's XLA path give it, never NaN: the uniform
// average of v over all T slots, empty ones included (keyless_value).  Such
// rows reach real outputs: a left-padded prompt's pad rows take MoE
// capacity, and a prompt longer than a sliding window leaves the rows of
// its first positions keyless in every windowed layer, which a global
// layer then reads.
//
// Prefill.  What bounds it on the H100: operations.  A prefill of S
// queries against its own keys does ~4 S^2/2 Dh flops per head against
// O(S Dh) bytes.  Both prefill kernels run one block per (q tile, head,
// batch row) with a loop over k tiles inside the block in place of the
// TPU's sequential k grid axis; GQA maps head h to kv head h / (H / Kv).
// Work the mask refuses is skipped two ways: with k_index_aligned (slot j
// holds position j, or positions are index-aligned up to a left-pad offset)
// a causal q tile stops at its last row's index, as _flash_body's causal
// block skip does; and every k tile whose keys are all refused for every
// query of the q tile (from the tile's position range: no valid key, all
// keys after the last query, or all beyond the window) is skipped.  The
// second skip only reads positions, so it is sound for any positions, a
// wrapped ring included; it is what makes a left-padded prefill cost its
// prompt, not its bucket.  Ragged S and T tails are masked in the kernel.
//
// flash_wgmma_kernel (bfloat16, the serving path).  The products run on the
// tensor cores (989 TFLOP/s bf16 against 67 on the float32 pipes):
//   * S = Q K^T is wgmma.mma_async m64n{BK}k16 bf16 -> f32 with Q and K in
//     128-byte-swizzled shared memory; each warpgroup owns 64 query rows
//     (bq 64: one warpgroup, bq 128: two).  O += P V is wgmma m64n64k16
//     with P converted to bf16 in registers (the accumulator's fragment is
//     the A operand's register layout, so P never touches shared memory)
//     and V read as the MN-major (transposed) B operand from the same
//     swizzled layout as K.
//   * The online softmax (row max, the correction, row sums) runs on the
//     accumulator fragment in registers: a row lives in a quad of threads,
//     its max takes two shuffles, its sum stays per thread until the end.
//     exp is exp2f of the logit times scale * log2(e), folded into one
//     multiply (within the bf16 tolerance; no fast-math flag).
//   * Q is copied once, and K and V tiles go through a two-stage ring with
//     cp.async (16 bytes a thread, zero-filled past T) written straight into
//     the swizzled layout, so the next tile's copy overlaps this tile's
//     products; strided views (the model's transposed q, k, v) are read in
//     place, rows 16-byte aligned (the wrapper checks).
//   * Before the loop, every warp takes k tiles, reads their positions and
//     reduces min and max with warp reductions: dead tiles drop out of a
//     compact list of live tiles (so the ring prefetches only live ones),
//     and tiles where every (query, key) pair is admitted are marked and
//     skip the per-element mask.  The q tile's position range is a warp
//     reduction too.
//   * q tiles run last-first (the grid's slowest axis), so a causal
//     prefill's heaviest tiles start first.
//   No atomics: the result is bit-for-bit repeatable.
//
// flash_kernel (float32, the conformance dtype, where ORACLE_TOL 2e-4 rules
// out TF32 tensor cores): the float32 pipes.  The Q tile and the current K
// (then V) tile sit in shared memory; each of the 256 threads computes a
// (BQ/16) x (BK/16) piece of S = Q K^T from registers, keeps its rows'
// running max and sum and a (BQ/16) x (Dh/16) piece of the accumulator, and
// the probabilities go through shared memory into P.V.
//
// decode_kernel (decode).  What bounds it: bytes.  One query per (row,
// head) reads every admitted K/V row of the cache once (2 Dh flops per byte
// pair).  The cache is read in its native (B, T, Kv, Dh) layout through its
// strides (no copy), 16 bytes a thread.  At 8 rows x 8 kv heads there are
// only 64 (b, kv) pairs for 132 SMs, so T is split into chunks of bkv slots
// across blocks (flash-decoding): block (kv, b, split) computes the G = H /
// Kv query heads of its kv head over its chunk (each K/V row is read once
// for all G heads), skipping rows whose positions are refused, and writes
// an unnormalised partial (m, l, acc).  A row's split boundaries depend on
// T alone, never on the batch or the other rows' fills.
//   The first decode was two launches: the split pass, where every split
// wrote a partial, and a combine kernel that read them all back.  At the
// serving fills only 320 of 2048 split blocks hold an admitted row, so
// 1728 wrote, and the combine re-read, 4.2 MB of zero partials (0.0482 ms
// as a CUDA graph against a 0.0057 ms bound on an H100 SXM at 700 W).  Now:
//   * one launch: each block, after writing its partial, fences and counts
//     itself in on a per-(b, kv) arrival counter (atomicAdd); the last to
//     arrive combines that pair's partials in split order, writes the
//     output and sets the counter back to 0 for the next call (and every
//     graph replay).  The atomic only picks the block that combines; every
//     sum keeps one fixed order, so a result is bit-for-bit repeatable;
//   * a split with no admitted row writes only m = -1e30 and l = 0; the
//     combine skips it without reading its acc.  The combine reads each
//     split's m and l in parallel, a split a thread, and sums the outputs
//     over a list of the live splits, so that it costs a few round trips
//     to L2, not one a split;
//   * a block takes two splits, z and z + nsplit / 2, so half as many
//     blocks arrive (an empty split costs a fence and an atomic in a block
//     of its own), while the first splits of an unwrapped cache, where its
//     admitted rows lie, stay one a block; z is the grid's slowest axis, so
//     they start first;
//   * in a live block each thread keeps its 8 elements of the G heads' q in
//     registers (MAXG, 4, 8 or 16, bounds G at compile time), issues the K
//     loads of several passes (8 in bf16, 4 in float32: 32 registers)
//     before it uses the first, interleaves the heads' shuffle sums, and
//     issues V's first passes before the softmax, so they arrive while it
//     runs.
//   Tried on the way (serving shape, bkv 128, CUDA graphs, H100 SXM at
// 700 W, intermediate builds of this file): the first one-launch version,
// with the combine reading split after split, a head's dot product and
// shuffles at a time and the split the fastest grid axis, took 0.0415 ms,
// its combine 0.0115 of it; issuing one or two passes' loads at a time in
// it, 0.0484 and 0.0466 ms; with the combine and the loads as above but a
// split a block, 0.0265 ms.  Not tried: K and V tiles in shared memory by
// TMA, a cluster along the split axis combining in distributed shared
// memory.

#include <cuda_bf16.h>
#include <stdint.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF (running max)
constexpr int kFlashThreads = 256;
constexpr int kDecodeThreads = 128;
constexpr int kMaxGroup = 16;      // query heads per kv head (decode)
constexpr int kMaxBkv = 512;       // cache slots per decode block
constexpr int kWindow = kDecodeThreads;  // splits the decode combine takes
                                         // at a time
constexpr int kSplitsPerBlock = 2;       // decode splits a block takes

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

// eight consecutive elements (16-byte aligned) as loaded, before the
// conversion to float32: a thread issues several before it uses one
template <typename T>
struct Raw8;
template <>
struct Raw8<float> {
  float4 a, b;
};
template <>
struct Raw8<__nv_bfloat16> {
  uint4 a;
};
__device__ __forceinline__ Raw8<float> load_raw8(const float* ptr) {
  return {*reinterpret_cast<const float4*>(ptr),
          *reinterpret_cast<const float4*>(ptr + 4)};
}
__device__ __forceinline__ Raw8<__nv_bfloat16> load_raw8(
    const __nv_bfloat16* ptr) {
  return {*reinterpret_cast<const uint4*>(ptr)};
}
__device__ __forceinline__ void unpack8(float* out, const Raw8<float>& x) {
  out[0] = x.a.x; out[1] = x.a.y; out[2] = x.a.z; out[3] = x.a.w;
  out[4] = x.b.x; out[5] = x.b.y; out[6] = x.b.z; out[7] = x.b.w;
}
__device__ __forceinline__ void unpack8(float* out,
                                        const Raw8<__nv_bfloat16>& x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x.a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// A query row that admits no key.  The plain version fills every refused
// logit with -1e30, so the softmax of such a row weighs each of the T slots
// 1 / T (rounded to v's dtype, as every probability is before P.V) and the
// row is that weight times the sum of v over all T slots, empty ones
// included; the reference's XLA path gives the same row.  keyless_value
// writes it for one kv head (`v`: T rows `ld` elements apart) to
// red[0, DH) in a fixed order (each thread a fixed set of rows, then the
// teams' sums in team order), so a result is repeatable.  Every thread of
// the block calls it; red holds THREADS * VEC floats of shared memory.
// Which rows admit no key depends on the positions alone, so a block calls
// it only when it holds such a row, and the other blocks pay nothing.  A
// block reads the whole of v alone, so each thread keeps U loads in flight
// (16 x 16 bytes in bf16: 64 KB a 256-thread block) before it adds any.
// VEC is 8 (rows 16-byte aligned) or 1 (any float32 view).
template <typename T, int DH, int THREADS, int VEC>
__device__ void keyless_value(const T* v, long long ld, int t, float* red,
                              int tid) {
  constexpr int TPR = DH / VEC;        // threads a row
  constexpr int ROWS = THREADS / TPR;  // rows a pass
  constexpr int U = VEC == 1 ? 8 : (sizeof(T) == 2 ? 16 : 8);
  const int grp = tid / TPR, c = (tid % TPR) * VEC;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int base = 0; base < t; base += U * ROWS) {
    if constexpr (VEC == 8) {
      Raw8<T> raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = base + u * ROWS + grp;
        raw[u] = r < t ? load_raw8(v + r * ld + c) : Raw8<T>{};
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x[8];
        unpack8(x, raw[u]);  // a zero-filled Raw8 adds 0
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += x[e];
      }
    } else {
      T raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = base + u * ROWS + grp;
        raw[u] = r < t ? v[r * ld + c] : T(0.f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) acc[0] += to_float(raw[u]);
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) red[grp * DH + c + e] = acc[e];
  __syncthreads();
  float sum = 0.f;
  if (tid < DH)
    for (int g = 0; g < ROWS; ++g) sum += red[g * DH + tid];
  __syncthreads();
  if (tid < DH) red[tid] = sum * round_to<T>(1.f / static_cast<float>(t));
  __syncthreads();
}

__device__ __forceinline__ bool admitted(int qp, int kp, int causal,
                                         int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window == 0 || qp - kp < window);
}

// ---------------------------------------------------------------------------
// prefill, float32 on the FMA pipes
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

template <int DH, int RI, int CJ>
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
  const float* q =
      static_cast<const float*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const float* k =
      static_cast<const float*>(p.k) + b * p.ks[0] + kvh * p.ks[1];
  const float* v =
      static_cast<const float*>(p.v) + b * p.vs[0] + kvh * p.vs[1];
  float* o = static_cast<float*>(p.o) + b * p.os[0] + h * p.os[1];

  for (int i = tid; i < BQ * DH; i += kFlashThreads) {
    const int r = i / DH, d = i % DH;
    qs[r * QLD + d] = r < nq ? q[(q0 + r) * p.qs[2] + d] : 0.f;
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
      kvs[c * QLD + d] = c < nk ? k[(k0 + c) * p.ks[2] + d] : 0.f;
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
        ps[r * PLD + tx + 16 * j] = pij;
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
      kvs[c * QLD + d] = c < nk ? v[(k0 + c) * p.vs[2] + d] : 0.f;
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

  // l = 0 exactly when a row admitted no key (an admitted key's own
  // probability at the row max is 1)
  bool keyless = false;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r < nq && l[i] != 0.f) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        o[(q0 + r) * p.os[2] + tx + 16 * j] = acc[i][j] / l[i];
    }
    keyless |= r < nq && l[i] == 0.f;
  }
  // rows that admit no key: the block of the group's first head writes them
  // for every head of the group (which rows they are, and their value, do
  // not depend on the head)
  const int group = p.heads / p.kv_heads;
  if (__syncthreads_or(keyless) && h % group == 0) {
    keyless_value<float, DH, kFlashThreads, 1>(v, p.vs[2], p.t, ps, tid);
    for (int hh = h; hh < h + group; ++hh) {
      float* oh = static_cast<float*>(p.o) + b * p.os[0] + hh * p.os[1];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
        if (r < nq && l[i] == 0.f) {
#pragma unroll
          for (int j = 0; j < DJ; ++j)
            oh[(q0 + r) * p.os[2] + tx + 16 * j] = ps[tx + 16 * j];
        }
      }
    }
  }
}

template <int DH, int RI, int CJ>
int launch_flash(const FlashParams& p, int batch, cudaStream_t stream) {
  constexpr int smem = flash_smem_bytes<DH, RI, CJ>();
  static bool configured = false;  // once per instantiation and process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<DH, RI, CJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((p.s + 16 * RI - 1) / (16 * RI), p.heads, batch);
  flash_kernel<DH, RI, CJ><<<grid, kFlashThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int flash_tiles(const FlashParams& p, int batch, int bq, int bk,
                cudaStream_t stream) {
  if (bq == 64 && bk == 64) return launch_flash<DH, 4, 4>(p, batch, stream);
  if (bq == 64 && bk == 32) return launch_flash<DH, 4, 2>(p, batch, stream);
  if (bq == 32 && bk == 64) return launch_flash<DH, 2, 4>(p, batch, stream);
  if (bq == 32 && bk == 32) return launch_flash<DH, 2, 2>(p, batch, stream);
  return -1;
}

int flash_dh(const FlashParams& p, int batch, int dh, int bq, int bk,
             cudaStream_t stream) {
  switch (dh) {
    case 16: return flash_tiles<16>(p, batch, bq, bk, stream);
    case 32: return flash_tiles<32>(p, batch, bq, bk, stream);
    case 64: return flash_tiles<64>(p, batch, bq, bk, stream);
    case 128: return flash_tiles<128>(p, batch, bq, bk, stream);
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// prefill, bfloat16: wgmma on the tensor cores, a cp.async K/V ring
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's finished cp.async writes, made visible to wgmma's reads
// (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving an accumulator's reads or writes across
// an asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma's shared-memory descriptor of a 128-byte-swizzled operand: the
// start address, then both byte offsets 1024 (the next 8 rows along K;
// no product spans two 64-element blocks along the other dimension, so
// that offset is never read), then the swizzle mode
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 64, float32) (+)= A (64 x 16, shared) . B (64 x 16, shared)^T
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 128, float32) (+)= A (64 x 16, shared) . B (128 x 16, shared)^T
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64, float32) += A (64 x 16, registers) . B (16 x 64, shared,
// MN-major: tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The bf16 kernel's shared memory.  A tile of R rows of Dh bf16 is stored
// as max(1, Dh / 64) blocks of R rows x 128 bytes (64 elements; a narrower
// head fills the front of each row), the 16-byte chunk c of row r at chunk
// c ^ (r % 8): the 128-byte swizzle, read by wgmma without bank conflicts.
// Q, K and V tiles share the layout (V is read as the MN-major operand).
template <int DH, int BQ, int BK>
struct WgTile {
  static constexpr int NB = DH < 64 ? 1 : DH / 64;  // 64-element blocks
  static constexpr int THREADS = 2 * BQ;           // a warpgroup a 64 rows
  static constexpr int Q_BYTES = BQ * 128 * NB;
  static constexpr int KV_BYTES = BK * 128 * NB;   // one K or V tile
  static constexpr int STAGES = 2;                 // the K/V ring
  // alignment slack, Q, the ring's K and V tiles and key positions, then
  // four ints (the q tile's position range, the live-tile count); the
  // live-tile list follows, one int a k tile
  static constexpr int FIXED =
      1024 + Q_BYTES + STAGES * (2 * KV_BYTES + BK * 4) + 16;
};

// rows [row0, row0 + R) of a (rows, DH) bf16 view with row stride `ld`
// into the swizzled layout at `dst`, asynchronously; rows from `n` on are
// zero-filled
template <int DH, int R, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long long ld, int row0, int n,
                                                int tid) {
  constexpr int CHUNKS = DH / 8;
#pragma unroll
  for (int i = tid; i < R * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = r < n;
    const __nv_bfloat16* g = ok ? src + (row0 + r) * ld + c * 8 : src;
    cp_async16(dst + (c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4),
               g, ok);
  }
}

template <int DH, int BQ, int BK>
__global__ void __launch_bounds__(2 * BQ, 1)
    flash_wgmma_kernel(const FlashParams p) {
  using L = WgTile<DH, BQ, BK>;
  constexpr int NS = BK / 2;   // S accumulator floats a thread (64 x BK)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t kv_s = q_s + L::Q_BYTES;  // stage st: K, then V
  int* kp_s = reinterpret_cast<int*>(smem + L::Q_BYTES +
                                     L::STAGES * 2 * L::KV_BYTES);
  int* info = kp_s + L::STAGES * BK;
  int* tiles = info + 4;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  // q tiles last-first: a causal prefill's heaviest tiles start first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int nq = min(BQ, p.s - q0);
  const int kvh = h / (p.heads / p.kv_heads);
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks[0] + kvh * p.ks[1];
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs[0] + kvh * p.vs[1];
  bf16* o = static_cast<bf16*>(p.o) + b * p.os[0] + h * p.os[1];
  auto q_pos = [&](int r) {  // r < nq
    return p.q_pos ? p.q_pos[b * p.qps + q0 + r] : q0 + r;
  };
  auto k_pos = [&](int j) {
    return j < p.t ? (p.k_pos ? p.k_pos[b * p.kps + j] : j) : -1;
  };

  load_tile_async<DH, BQ, L::THREADS>(q_s, q, p.qs[2], q0, nq, tid);
  cp_async_commit();

  // the q tile's position range (rows past S excluded)
  if (warp == 0) {
    int lo = 0x7fffffff, hi = -0x7fffffff;
    for (int r = lane; r < nq; r += 32) {
      const int qp = q_pos(r);
      lo = min(lo, qp);
      hi = max(hi, qp);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      info[0] = lo;
      info[1] = hi;
    }
  }
  __syncthreads();
  const int q_lo = info[0], q_hi = info[1];
  // each k tile's position range, a warp a tile: 0 dead, 1 live, 2 every
  // pair admitted
  const int n_k = (p.t + BK - 1) / BK;
  const int kt_end =  // the reference's causal block skip
      (p.causal && p.aligned) ? min(n_k, (q0 + BQ - 1) / BK + 1) : n_k;
  for (int kt = warp; kt < kt_end; kt += L::THREADS / 32) {
    int lo = 0x7fffffff, hi = -1, pad = 0;
    for (int c = lane; c < BK; c += 32) {
      const int kp = k_pos(kt * BK + c);
      if (kp >= 0) {
        lo = min(lo, kp);
        hi = max(hi, kp);
      } else {
        pad = 1;
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    pad = __any_sync(0xffffffffu, pad);
    if (lane == 0) {
      const bool live = hi >= 0 && (!p.causal || lo <= q_hi) &&
                        (p.window == 0 || hi > q_lo - p.window);
      const bool full = !pad && (!p.causal || hi <= q_lo) &&
                        (p.window == 0 || q_hi - lo < p.window);
      tiles[kt] = live ? 1 + full : 0;
    }
  }
  __syncthreads();
  if (warp == 0) {  // the live tiles in order, as index << 1 | full
    int count = 0;
    for (int base = 0; base < kt_end; base += 32) {
      const int kt = base + lane;
      const int f = kt < kt_end ? tiles[kt] : 0;
      const unsigned live = __ballot_sync(0xffffffffu, f != 0);
      if (f) tiles[count + __popc(live & ((1u << lane) - 1))] = kt << 1 | (f == 2);
      count += __popc(live);
    }
    if (lane == 0) info[2] = count;
  }
  __syncthreads();
  const int n_live = info[2];

  auto issue = [&](int stage, int kt) {  // one k tile into the ring
    const int k0 = kt * BK, nk = min(BK, p.t - k0);
    const uint32_t ks = kv_s + stage * 2 * L::KV_BYTES;
    load_tile_async<DH, BK, L::THREADS>(ks, k, p.ks[2], k0, nk, tid);
    load_tile_async<DH, BK, L::THREADS>(ks + L::KV_BYTES, v, p.vs[2], k0, nk,
                                        tid);
    for (int c = tid; c < BK; c += L::THREADS)
      kp_s[stage * BK + c] = k_pos(k0 + c);
    cp_async_commit();
  };

  // this thread's two rows of its warpgroup's 64 and its quad lane
  const int wg = tid / 128, tq = lane % 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4, r1 = r0 + 8;
  const int qp0 = r0 < nq ? q_pos(r0) : -1, qp1 = r1 < nq ? q_pos(r1) : -1;
  const float sl2 = p.scale * 1.4426950408889634f;  // scale * log2(e)
  const uint32_t qa = q_s + wg * 64 * 128;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[L::NB][32];
#pragma unroll
  for (int nb = 0; nb < L::NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  float s[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;

  if (n_live > 0) issue(0, tiles[0] >> 1);
  for (int it = 0; it < n_live; ++it) {
    const int st = it & 1, entry = tiles[it];
    if (it + 1 < n_live) {  // the next live tile's copy overlaps this one
      issue(st ^ 1, tiles[it + 1] >> 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t ks = kv_s + st * 2 * L::KV_BYTES, vs = ks + L::KV_BYTES;

    // S = Q K^T: Dh / 16 products of 64 x BK x 16
    fence_regs<NS>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint64_t da =
          sw128_desc(qa + (kk / 4) * (BQ * 128) + (kk % 4) * 32);
      const uint64_t db =
          sw128_desc(ks + (kk / 4) * (BK * 128) + (kk % 4) * 32);
      if constexpr (BK == 64) {
        wgmma_ss_n64(s, da, db, kk > 0);
      } else {
        wgmma_ss_n128(s, da, db, kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<NS>(s);

    // the mask (only where a pair may be refused), then the online softmax
    // in log2 units; s[4j + e] is row r0 and s[4j + 2 + e] row r1, key
    // 8j + 2 tq + e
    const int* kp = kp_s + st * BK;
    float mt0 = -CUDART_INF_F, mt1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[4 * j + e] * sl2, x1 = s[4 * j + 2 + e] * sl2;
        if (!(entry & 1)) {
          const int kpos = kp[8 * j + 2 * tq + e];
          if (!admitted(qp0, kpos, p.causal, p.window)) x0 = -CUDART_INF_F;
          if (!admitted(qp1, kpos, p.causal, p.window)) x1 = -CUDART_INF_F;
        }
        s[4 * j + e] = x0;
        s[4 * j + 2 + e] = x1;
        mt0 = fmaxf(mt0, x0);
        mt1 = fmaxf(mt1, x1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, off));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, off));
    }
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // P in bf16 as wgmma's A fragments: key step kk takes the accumulator's
    // columns 16 kk .. 16 kk + 15, which are already in the A layout
    uint32_t pa[BK / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float e00 = exp2f(s[4 * j] - mn0), e01 = exp2f(s[4 * j + 1] - mn0);
      const float e10 = exp2f(s[4 * j + 2] - mn1),
                  e11 = exp2f(s[4 * j + 3] - mn1);  // refused: exp2(-inf) = 0
      rs0 += e00 + e01;
      rs1 += e10 + e11;
      pa[j / 2][(j % 2) * 2] = pack_bf16(e00, e01);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(e10, e11);
    }
    l0 = l0 * c0 + rs0;  // this thread's share of the row sums, unrounded
    l1 = l1 * c1 + rs1;
#pragma unroll
    for (int nb = 0; nb < L::NB; ++nb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[nb][4 * j] *= c0;
        acc[nb][4 * j + 1] *= c0;
        acc[nb][4 * j + 2] *= c1;
        acc[nb][4 * j + 3] *= c1;
      }
      fence_regs<32>(acc[nb]);
    }

    // O += P V: per 16 keys and 64 columns of Dh, one 64 x 64 x 16 product
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < L::NB; ++nb)
        wgmma_rs_n64(acc[nb], pa[kk],
                     sw128_desc(vs + nb * (BK * 128) + kk * 2048));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int nb = 0; nb < L::NB; ++nb) fence_regs<32>(acc[nb]);
    __syncthreads();  // every warpgroup is done with this stage
  }
  cp_async_wait<0>();  // the Q copy, when no tile was live

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // l = 0 exactly when a row admitted no key
  const bool live0 = r0 < nq && l0 != 0.f, live1 = r1 < nq && l1 != 0.f;
  const bool keyless0 = r0 < nq && l0 == 0.f, keyless1 = r1 < nq && l1 == 0.f;
#pragma unroll
  for (int nb = 0; nb < L::NB; ++nb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nb * 64 + 8 * j + 2 * tq;
      if (col < DH) {
        if (live0)
          *reinterpret_cast<uint32_t*>(o + (q0 + r0) * p.os[2] + col) =
              pack_bf16(acc[nb][4 * j] / l0, acc[nb][4 * j + 1] / l0);
        if (live1)
          *reinterpret_cast<uint32_t*>(o + (q0 + r1) * p.os[2] + col) =
              pack_bf16(acc[nb][4 * j + 2] / l1, acc[nb][4 * j + 3] / l1);
      }
    }
  }
  // rows that admit no key: the block of the group's first head writes them
  // for every head of the group (which rows they are, and their value, do
  // not depend on the head), its K/V ring reused for the sums
  const int group = p.heads / p.kv_heads;
  if (__syncthreads_or(keyless0 || keyless1) && h % group == 0) {
    float* val = reinterpret_cast<float*>(smem + L::Q_BYTES);
    keyless_value<bf16, DH, L::THREADS, 8>(v, p.vs[2], p.t, val, tid);
    for (int hh = h; hh < h + group; ++hh) {
      bf16* oh = static_cast<bf16*>(p.o) + b * p.os[0] + hh * p.os[1];
#pragma unroll
      for (int nb = 0; nb < L::NB; ++nb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = nb * 64 + 8 * j + 2 * tq;
          if (col < DH) {
            const uint32_t x = pack_bf16(val[col], val[col + 1]);
            if (keyless0)
              *reinterpret_cast<uint32_t*>(oh + (q0 + r0) * p.os[2] + col) = x;
            if (keyless1)
              *reinterpret_cast<uint32_t*>(oh + (q0 + r1) * p.os[2] + col) = x;
          }
        }
      }
    }
  }
}

template <int DH, int BQ, int BK>
int launch_flash_wgmma(const FlashParams& p, int batch, cudaStream_t stream) {
  using L = WgTile<DH, BQ, BK>;
  const int smem = L::FIXED + 4 * ((p.t + BK - 1) / BK);
  static int configured = 0;  // the most asked for so far, per process
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<DH, BQ, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const dim3 grid(p.heads, batch, (p.s + BQ - 1) / BQ);
  flash_wgmma_kernel<DH, BQ, BK><<<grid, L::THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int flash_wgmma_tiles(const FlashParams& p, int batch, int bq, int bk,
                      cudaStream_t stream) {
  if (bq == 128 && bk == 128)
    return launch_flash_wgmma<DH, 128, 128>(p, batch, stream);
  if (bq == 128 && bk == 64)
    return launch_flash_wgmma<DH, 128, 64>(p, batch, stream);
  if (bq == 64 && bk == 128)
    return launch_flash_wgmma<DH, 64, 128>(p, batch, stream);
  if (bq == 64 && bk == 64)
    return launch_flash_wgmma<DH, 64, 64>(p, batch, stream);
  return -1;
}

int flash_wgmma_dh(const FlashParams& p, int batch, int dh, int bq, int bk,
                   cudaStream_t stream) {
  switch (dh) {
    case 16: return flash_wgmma_tiles<16>(p, batch, bq, bk, stream);
    case 32: return flash_wgmma_tiles<32>(p, batch, bq, bk, stream);
    case 64: return flash_wgmma_tiles<64>(p, batch, bq, bk, stream);
    case 128: return flash_wgmma_tiles<128>(p, batch, bq, bk, stream);
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
  void* o;              // (B, 1, H, Dh), contiguous
  const int* q_pos;     // (B, 1)
  const int* k_pos;     // (B, T) through kps
  float* m_part;        // (B, Kv, nsplit, G)
  float* l_part;        // (B, Kv, nsplit, G)
  float* acc_part;      // (B, Kv, nsplit, G, Dh); an empty split's unwritten
  int* arrivals;        // (B, Kv): splits done; 0 before and after a call
  long long ks[3], vs[3];  // element strides of (b, t, kv head)
  long long kps;
  int heads, kv_heads, t, bkv, nsplit, window;
  float scale;
};

// the decode kernel's dynamic shared memory at its largest: logits
// (G x bkv) + partial sums (groups x G x Dh) + flags; the combine reuses
// the first two
constexpr int kDecodeMaxSmem =
    (kMaxGroup * kMaxBkv + kDecodeThreads * 8 * kMaxGroup) * 4 + kMaxBkv;

// One launch a call: block (kv, b, split) writes the partial (m, l, acc) of
// the G query heads of kv head kv over its chunk of bkv slots; the block
// that arrives last for (b, kv) combines the partials in split order.
// MAXG (4, 8 or 16) bounds G at compile time, so that q, the logits and the
// accumulators of the G heads sit in registers, unrolled.  At 8 < G <= 16
// one 16-head tile measured as fast as two 8-head tiles looping over the
// same K/V rows (0.0500 against 0.0502 ms at G = 12, 0.0561 against 0.0564
// at G = 16: the engine's 8-row step on a 4096-slot cache, bf16, Dh 128,
// CUDA graphs, H100 SXM at 700 W), so the kernel keeps the one tile.
template <typename T, int DH, int MAXG>
__global__ void __launch_bounds__(kDecodeThreads)
    decode_kernel(const DecodeParams p) {
  constexpr int VEC = 8, TPK = DH / VEC, NGRP = kDecodeThreads / TPK;
  // passes whose loads are issued together: 32 registers of raw rows
  constexpr int U = sizeof(T) == 2 ? 8 : 4;
  const int G = p.heads / p.kv_heads;
  extern __shared__ float smem[];
  float* ls = smem;                // G x bkv: logits, then probabilities
  float* red = ls + G * p.bkv;     // NGRP x G x Dh
  unsigned char* ok_s = reinterpret_cast<unsigned char*>(red + NGRP * G * DH);
  __shared__ int is_last, n_live, warp_live[kDecodeThreads / 32];
  __shared__ float mx_s[MAXG], l_s[MAXG], warp_mx[kDecodeThreads / 32][MAXG];

  // Block z of a (kv, b) pair takes splits z, z + Z, ... (Z = gridDim.z,
  // kSplitsPerBlock of them): the blocks of a pair that arrive, and the
  // empty splits that each pays a fence and an atomic for, are fewer, while
  // an unwrapped cache's admitted rows, in its first splits, stay one split
  // a block.  The split index is the grid's slowest axis, so those first
  // splits start first.
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, wl = tid % 32;
  const int qp = p.q_pos[b];
  const long long bk = static_cast<long long>(b) * p.kv_heads + kvh;
  for (int split = blockIdx.z; split < p.nsplit; split += gridDim.z) {
  const int t0 = split * p.bkv, n = min(p.bkv, p.t - t0);
  const long long part = (bk * p.nsplit + split) * G;

  int any = 0;
  for (int t = tid; t < n; t += kDecodeThreads) {
    const bool ok = admitted(qp, p.k_pos[b * p.kps + t0 + t], 1, p.window);
    ok_s[t] = ok;
    any |= ok;
  }
  if (!__syncthreads_or(any)) {
    // nothing admitted: m and l only, and the combine skips this split
    if (tid < G) {
      p.m_part[part + tid] = kNegInf;
      p.l_part[part + tid] = 0.f;
    }
  } else {
    // logits: a team of TPK threads per key, 8 elements a thread, this
    // lane's 8 elements of every head's q in registers; the K rows of U
    // passes loaded before the first is used, and the heads' shuffle sums
    // interleaved
    const int grp = tid / TPK, lane = tid % TPK;
    float qr[MAXG][VEC];
    {
      const T* q = static_cast<const T*>(p.q) +
                   (static_cast<long long>(b) * p.heads + kvh * G) * DH +
                   lane * VEC;
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          qr[g][e] = g < G ? to_float(q[g * DH + e]) : 0.f;
    }
    const T* kb = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[2] +
                  lane * VEC;
    const T* vb = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[2] +
                  lane * VEC;
    for (int base = 0; base < n; base += U * NGRP) {  // same trips per warp
      Raw8<T> raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = base + u * NGRP + grp;
        raw[u] = t < n && ok_s[t] ? load_raw8(kb + (t0 + t) * p.ks[1])
                                  : Raw8<T>{};
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = base + u * NGRP + grp;
        float kf[VEC], sg[MAXG];
        unpack8(kf, raw[u]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          sg[g] = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) sg[g] = fmaf(qr[g][e], kf[e], sg[g]);
        }
#pragma unroll
        for (int off = TPK / 2; off > 0; off >>= 1)
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            sg[g] += __shfl_xor_sync(0xffffffffu, sg[g], off);
        if (lane == 0 && t < n)
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < G)
              ls[g * p.bkv + t] = ok_s[t] ? sg[g] * p.scale : -CUDART_INF_F;
      }
    }
    // V's first U passes in flight across the softmax
    Raw8<T> raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = u * NGRP + grp;
      raw[u] = t < n && ok_s[t] ? load_raw8(vb + (t0 + t) * p.vs[1])
                                : Raw8<T>{};
    }
    __syncthreads();

    // this chunk's max and sum for each query head: one warp a head
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
    float acc[MAXG][VEC];
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
    for (int base = 0; base < n; base += U * NGRP) {
      if (base > 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = base + u * NGRP + grp;
          raw[u] = t < n && ok_s[t] ? load_raw8(vb + (t0 + t) * p.vs[1])
                                    : Raw8<T>{};
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = base + u * NGRP + grp;
        if (t < n && ok_s[t]) {
          float vf[VEC];
          unpack8(vf, raw[u]);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
              const float pg = ls[g * p.bkv + t];
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
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
  __syncthreads();  // the shared tiles are the next split's
  }

  // arrival: the partials are visible on the device before the count
  // moves; the last block of (b, kv) resets the count for the next call
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    is_last = atomicAdd(p.arrivals + bk, 1) == gridDim.z - 1;
    if (is_last) p.arrivals[bk] = 0;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // The combine, in split order, a window of kWindow splits at a time (a
  // split a thread): the max over every split first, then for each window
  // the weights exp(m - max), the list of the splits that admitted a row,
  // and each output's sum over that list.  An empty split (l = 0) adds
  // nothing, and its acc, never written, is not read.  The partials come
  // from L2 (__ldcg): other blocks wrote them.
  const float* mp = p.m_part + bk * p.nsplit * G;
  const float* lp = p.l_part + bk * p.nsplit * G;
  const float* ap = p.acc_part + bk * p.nsplit * G * DH;
  float* w_s = smem;                          // kWindow x G: exp(m - max)
  float* lw_s = w_s + kWindow * G;            // kWindow x G: l exp(m - max)
  int* live_s = reinterpret_cast<int*>(lw_s + kWindow * G);  // kWindow
  float m0[MAXG], l0[MAXG];  // the first window's, kept from the max pass
  {
    float mx[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) mx[g] = kNegInf;
    for (int s = tid; s < p.nsplit; s += kDecodeThreads) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        const float m = g < G ? __ldcg(mp + s * G + g) : kNegInf;
        if (s == tid) {
          m0[g] = m;
          l0[g] = g < G ? __ldcg(lp + s * G + g) : 0.f;
        }
        mx[g] = fmaxf(mx[g], m);
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
      if (wl == 0) warp_mx[warp][g] = mx[g];
    }
  }
  __syncthreads();
  if (tid < G) {  // the max is exact in any order
    float mx = kNegInf;
    for (int wi = 0; wi < kDecodeThreads / 32; ++wi)
      mx = fmaxf(mx, warp_mx[wi][tid]);
    mx_s[tid] = mx;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  constexpr int OUT = (MAXG * DH + kDecodeThreads - 1) / kDecodeThreads;
  float o[OUT];
#pragma unroll
  for (int j = 0; j < OUT; ++j) o[j] = 0.f;
  for (int s0 = 0; s0 < p.nsplit; s0 += kWindow) {
    const int s = s0 + tid;
    bool live = false;
    if (s < p.nsplit) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float m = s0 ? __ldcg(mp + s * G + g) : m0[g];
          const float l = s0 ? __ldcg(lp + s * G + g) : l0[g];
          const float w = l == 0.f ? 0.f : expf(m - mx_s[g]);
          w_s[tid * G + g] = w;
          lw_s[tid * G + g] = l * w;
          live |= l != 0.f;
        }
      }
    }
    // the live splits of the window, in order (a ballot a warp)
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (wl == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    for (int wi = 0; wi < warp; ++wi) before += warp_live[wi];
    if (live) live_s[before + __popc(ballot & ((1u << wl) - 1u))] = tid;
    if (tid == 0) {
      int total = 0;
      for (int wi = 0; wi < kDecodeThreads / 32; ++wi) total += warp_live[wi];
      n_live = total;
    }
    __syncthreads();
    if (tid < G)
      for (int x = 0; x < n_live; ++x) l_s[tid] += lw_s[live_s[x] * G + tid];
#pragma unroll 4
    for (int x = 0; x < n_live; ++x) {
      const int sx = live_s[x];
#pragma unroll
      for (int j = 0; j < OUT; ++j) {
        const int i = tid + j * kDecodeThreads;
        if (i < G * DH)
          o[j] += __ldcg(ap + (static_cast<long long>(s0 + sx) * G) * DH + i) *
                  w_s[sx * G + i / DH];
      }
    }
    __syncthreads();
  }
  T* out = static_cast<T*>(p.o) +
           (static_cast<long long>(b) * p.heads + kvh * G) * DH;
  if (l_s[0] == 0.f) {
    // the row admits no key (its G heads share its position): every split
    // was empty, and the row is the plain version's value
    keyless_value<T, DH, kDecodeThreads, 8>(
        static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[2], p.vs[1],
        p.t, smem, tid);
    for (int i = tid; i < G * DH; i += kDecodeThreads)
      out[i] = from_float<T>(smem[i % DH]);
    return;
  }
#pragma unroll
  for (int j = 0; j < OUT; ++j) {
    const int i = tid + j * kDecodeThreads;
    if (i < G * DH) out[i] = from_float<T>(o[j] / l_s[i / DH]);
  }
}

template <typename T, int DH, int MAXG>
int launch_decode(const DecodeParams& p, int batch, cudaStream_t stream) {
  static bool configured = false;  // once per instantiation and process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, DH, MAXG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kDecodeMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int G = p.heads / p.kv_heads;
  const int smem = (G * p.bkv + kDecodeThreads * 8 * G) * 4 + p.bkv;
  const dim3 grid(p.kv_heads, batch,
                  (p.nsplit + kSplitsPerBlock - 1) / kSplitsPerBlock);
  decode_kernel<T, DH, MAXG><<<grid, kDecodeThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int decode_group(const DecodeParams& p, int batch, cudaStream_t stream) {
  const int g = p.heads / p.kv_heads;
  if (g <= 4) return launch_decode<T, DH, 4>(p, batch, stream);
  if (g <= 8) return launch_decode<T, DH, 8>(p, batch, stream);
  return launch_decode<T, DH, 16>(p, batch, stream);
}

template <typename T>
int decode_dh(const DecodeParams& p, int batch, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return decode_group<T, 16>(p, batch, stream);
    case 32: return decode_group<T, 32>(p, batch, stream);
    case 64: return decode_group<T, 64>(p, batch, stream);
    case 128: return decode_group<T, 128>(p, batch, stream);
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
  if (dtype == 0) return flash_dh(p, batch, dh, bq, bk, stream);
  if (dtype == 1) return flash_wgmma_dh(p, batch, dh, bq, bk, stream);
  return -1;
}

// Decode attention on `stream`, one launch; returns cudaGetLastError() or
// -1 for a (dtype, dh) without an instantiation.  strides holds the element
// strides of dims 0-2 of k and of v (6 values; dim 3 has stride 1, rows
// 16-byte aligned).  The partial buffers hold batch * kv_heads * ceil(t /
// bkv) * (heads / kv_heads) (x dh for acc) floats; `arrivals` holds batch *
// kv_heads ints that are 0 before the call and are 0 again after it.  A
// launch that faults midway may leave them nonzero: a process that caught
// such an error must not reuse that buffer.  The caller checks shapes,
// dtypes, alignment, heads / kv_heads <= 16 and bkv <= 512.
extern "C" int decode_attention_fwd(
    int dtype, int dh, const void* q, const void* k, const void* v, void* o,
    const int* q_pos, const int* k_pos, float* m_part, float* l_part,
    float* acc_part, int* arrivals, const long long* strides,
    long long k_pos_stride, int batch, int heads, int kv_heads, int t,
    int bkv, int window, float scale, cudaStream_t stream) {
  DecodeParams p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_pos = q_pos; p.k_pos = k_pos;
  p.m_part = m_part; p.l_part = l_part; p.acc_part = acc_part;
  p.arrivals = arrivals;
  for (int i = 0; i < 3; ++i) {
    p.ks[i] = strides[i];
    p.vs[i] = strides[3 + i];
  }
  p.kps = k_pos_stride;
  p.heads = heads; p.kv_heads = kv_heads; p.t = t; p.bkv = bkv;
  p.nsplit = (t + bkv - 1) / bkv;
  p.window = window; p.scale = scale;
  if (dtype == 0) return decode_dh<float>(p, batch, dh, stream);
  if (dtype == 1) return decode_dh<__nv_bfloat16>(p, batch, dh, stream);
  return -1;
}

extern "C" const char* attention_error_string(int err) {
  if (err == -1) return "no kernel instantiated for this dtype/head_dim/tile";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
