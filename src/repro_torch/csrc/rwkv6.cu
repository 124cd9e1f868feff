// The RWKV6 WKV (data-dependent-decay linear attention), written by hand
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6/kernel.py::
// wkv_chunked_pallas (grid (B*H, n_chunks), the chunk axis sequential with
// the Dh x Dv state in VMEM scratch), and computes what the model's WKV
// computes (repro/models/rwkv.py::wkv_chunked), which the Pallas kernel
// does not quite: it takes an initial state (null means zeros, the Pallas
// kernel's start) and writes the final state, which the Pallas kernel
// drops.  Per chunk c of C tokens, with lw the log-decays (<= 0), lw_cum
// their running sum inside the chunk, lw_before = lw_cum - lw and cw the
// chunk's total:
//
//   A[t,s] = sum_d r[t,d] k[s,d] exp(lw_before[t,d] - lw_cum[s,d])
//            for s < t (strict lower triangle), else 0
//   y      = A v + diag(r . (u * k)) v + (r * exp(lw_before)) S_c
//   S_c+1  = diag(exp(cw)) S_c + dS_c,  dS_c = (k * exp(cw - lw_cum))^T v
//
// What bounds it on the H100: bytes.  At the serving shape (B 8, H 40,
// S 2048, Dh = Dv 64) r, k, v, the log-decays and y are 168 MB each: ~0.84
// GB, 0.25 ms at 3.35 TB/s; the fewest flops, ~1.1e10 (ops.py::least_flops,
// 0.16 ms on the float32 pipes), come below that.  A decode step (S 1) is
// its state, 10.5 MB in and out: 3.3 us.
//
// The design.  The first kernel ran one block per (b, h) looping over the
// chunks with the state on chip: 320 blocks, 1.21 waves of 264 slots, seven
// barriers a chunk, one precise expf per (t, s, d) of the triangle, and a
// decode step paid a whole chunk's set-up (2.519 ms and 0.0385 ms as CUDA
// graphs on an H100 SXM at 700 W).  Now:
//
//  * S == 1: wkv_step_kernel.  y[j] = sum_d r[d] (S[d,j] + u[d] k[d] v[j]),
//    S[d,j] <- exp(w[d]) S[d,j] + k[d] v[j].  Grid (Dv / 16, H, B): a block
//    holds a Dh x 16 slice of the state, a float4 a thread, read once and
//    written once; y is reduced over d by warp shuffles and then across the
//    warps, in a fixed order.  No chunk, no transpose, no scan.
//  * S > 1: three kernels, parallel over chunks (the decomposition GPU
//    linear-attention kernels use):
//      1. wkv_delta_kernel, one block per (chunk, h, b): dS_c and exp(cw_c)
//         into a float32 scratch the wrapper allocates.  Its tiles stay
//         row-major, copied by cp.async, and the scan along the tokens is
//         a thread a channel;
//      2. wkv_scan_kernel, one block per (Dv slice of 32, h, b), two float4
//         of a row a thread: the chunks in order, S_c+1 = diag(exp(cw_c))
//         S_c + dS_c.  It overwrites each dS_c with S_c, the state at chunk
//         c's start, in place (one scratch of B H n Dh Dv floats, not two),
//         and writes the final state;
//      3. wkv_output_kernel, one block per (chunk, h, b): y from the
//         chunk's r, k, v, log-decays and S_c, read from the scratch, never
//         from the state buffer, which step 2 has already overwritten.
//    About 2.0 GB move against the 0.84 GB bound (k, v and the decays are
//    read twice, dS and S_c once each way), in 10240 blocks at the serving
//    shape in place of 320.
//  * Fewer expf in the triangle.  Every exponent of a valid term is <= 0,
//    and the intra-chunk factor is never split as exp(lw_before[t]) *
//    exp(-lw_cum[s]): with log-decays down to -e a step, exp(-lw_cum)
//    overflows within a chunk.  Instead the chunk is cut into sub-chunks of
//    kSub = 8 tokens.  A diagonal 8 x 8 block keeps the direct form, one
//    expf per (t, s, d).  An off-diagonal block (s in sub-chunk J before
//    t's sub-chunk I) factors at the sub-chunks' edges:
//      exp(lw_before[t] - B_I) * exp(B_I - E_J) * exp(E_J - lw_cum[s])
//    with E_J = lw_cum at J's last token and B_I = E_{I-1} (0 for I = 0).
//    All three exponents are <= 0, so no factor overflows, and the block is
//    a plain product of r~ = r exp(lw_before - B_I) and k~ = k exp(E_J -
//    lw_cum) scaled per channel: O(C Dh) expf a chunk, not O(C^2 Dh); at
//    C = 64, 224 pairs of the 2016 keep the direct form (9x fewer expf
//    there).  Sub-chunks of 8, not 16: a thread's chain of expf is what the
//    diagonal blocks take, and at 8 their tiles, split over two lanes, fit
//    160 of the 256 threads (at 16, 288).  The inter-chunk term reuses r~:
//    r exp(lw_before) = r~ exp(B_I).
//  * The output kernel is bound by its many short phases more than by any
//    one product.  Its tiles come in one round trip: r, k and the decays
//    by 4-byte cp.async along rows (coalesced) into swizzled row-major
//    staging in tiles that are still free, then a conflict-free transpose
//    in shared memory; v and S_c by cp.async into regions that free up as
//    the triangle is built, so a block takes 75 KB and three fit an SM.
//    The diagonal blocks' expf chains have no per-element branch (a branch
//    a term serialised them) and are split over two lanes; the bonus runs
//    on the threads the diagonal tiles leave idle.
//  * expf is the precise one (no fast math: a fast variant would be a
//    separately named backend); every product is float32 FMA (no TF32: the
//    (3e-4, 3e-4) tolerance); no atomics, every sum has one fixed order, so
//    a result is bit-for-bit repeatable.
//  * Any S >= 1: the last chunk may be ragged.  Its tokens past S are loaded
//    as r = k = v = lw = 0, so they add nothing to y or the state, and they
//    are not written.  The reference kernel requires S % chunk == 0
//    (kernel.py:79-80).
//
// Tried on the way, at the serving shape, as CUDA graphs on an H100 SXM at
// 700 W (intermediate builds of this file): the first three-kernel version
// took 2.15 ms (output 1.42, state increments 0.52, scan 0.22); sub-chunks
// of 16 tokens with the diagonal tiles one a thread and a branch a term,
// 1.36 ms of output kernel; staging every tile in registers (108 of them)
// slowed the output kernel (1.42 -> 1.67 ms); a scan issuing 8 chunks'
// loads at once (60 registers, half the blocks an SM) went from 0.22 to
// 0.37 ms; the output kernel at 512 threads with every triangle chain on
// four lanes went from 1.36 to 1.50 ms; transposed tiles loaded through
// registers a 16-byte piece a lane cost the state increments 0.47 ms
// (0.25 ms row-major) and the output kernel 0.97 ms (0.94 ms staged by
// cp.async).  All reverted.  Not tried: mma.sync in a 3xTF32 split for the
// dense products, TMA, one kernel that hands the state from chunk to chunk
// (decoupled look-back), which would read k, v and the decays once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // the chunk kernels' block
constexpr int kSub = 8;        // tokens of a sub-chunk
constexpr int kSlice = 16;     // state columns a one-token block holds
constexpr int kScanCols = 32;  // state columns a scan block holds

struct WkvParams {
  const float* r;
  const float* k;
  const float* v;
  const float* w;        // log-decays
  const float* u;        // (H, Dh) contiguous
  const float* s_in;     // (B, H, Dh, Dh) contiguous, or null for zeros
  float* s_out;          // (B, H, Dh, Dh) contiguous; may be s_in
  float* y;
  float* ds;             // (B, H, n, Dh, Dv) scratch: dS_c, then S_c
  float* ecw;            // (B, H, n, Dh) scratch: exp(cw_c)
  long long rs[3], ks[3], vs[3], ws[3], ys[3];  // element strides (b, h, t)
  int heads, seq, nchunks;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ float at(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}
__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
// 16 bytes global -> shared without registers; zeros when !pred
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}
// 4 bytes global -> shared; zero when !pred
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---------------------------------------------------------------------------
// S == 1
// ---------------------------------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(DH * kSlice / 4)
    wkv_step_kernel(const WkvParams p) {
  constexpr int DV = DH, SQ = kSlice / 4, WARPS = DH * SQ / 32;
  __shared__ float part[WARPS][kSlice];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d = tid / SQ, q = tid % SQ;  // a warp: 8 channels x 4 quads
  const int col = blockIdx.x * kSlice + 4 * q, h = blockIdx.y,
            b = blockIdx.z;
  const float rd = p.r[b * p.rs[0] + h * p.rs[1] + d];
  const float kd = p.k[b * p.ks[0] + h * p.ks[1] + d];
  const float wd = p.w[b * p.ws[0] + h * p.ws[1] + d];
  const float ud = p.u[h * DH + d];
  const float4 vv = ld4(p.v + b * p.vs[0] + h * p.vs[1] + col);
  const long long s_off =
      (static_cast<long long>(b) * p.heads + h) * DH * DV + d * DV + col;
  const float4 s = p.s_in ? ld4(p.s_in + s_off) : zero4();

  const float bonus = rd * (ud * kd);
  float y[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) y[c] = rd * at(s, c) + bonus * at(vv, c);
  const float e = expf(wd);
  st4(p.s_out + s_off,
      make_float4(e * s.x + kd * vv.x, e * s.y + kd * vv.y,
                  e * s.z + kd * vv.z, e * s.w + kd * vv.w));

  // the sum over d: the warp's 8 channels, then the warps in order
#pragma unroll
  for (int off = SQ; off < 32; off *= 2)
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] += __shfl_xor_sync(0xffffffffu, y[c], off);
  if (lane < SQ)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[warp][4 * lane + c] = y[c];
  __syncthreads();
  if (tid < kSlice) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) acc += part[i][tid];
    p.y[b * p.ys[0] + h * p.ys[1] + blockIdx.x * kSlice + tid] = acc;
  }
}

// ---------------------------------------------------------------------------
// S > 1: the chunk kernels
// ---------------------------------------------------------------------------

// Rows t0 .. t0 + C - 1 of a (.., S, DH) tensor into a row-major C x DH
// tile, 16 bytes a lane (coalesced, cp.async, no registers); tokens past
// the end are 0.  Complete after cp_async_wait_all.
template <int C, int DH>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long stride, int t0,
                                          int valid) {
  constexpr int QUADS = C * DH / 4;
#pragma unroll
  for (int j = 0; j < (QUADS + kThreads - 1) / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int t = i / (DH / 4), q = i % (DH / 4);
    if (i < QUADS)
      cp_async16(dst + 4 * i,
                 t < valid ? src + (t0 + t) * stride + 4 * q : src,
                 t < valid);
  }
}

// Rows t0 .. t0 + C - 1 of a (.., S, DH) tensor into a C x DH staging
// tile, 4 bytes a lane along the row (coalesced, cp.async, no registers),
// element (t, d) at t * DH + (d ^ (t % 32)); transpose_staged then moves
// it to a DH x C tile.  The swizzle keeps both passes free of bank
// conflicts: the copy's lanes differ in d, the transpose's in t.
template <int C, int DH>
__device__ __forceinline__ void stage_rows(float* stage, const float* src,
                                           long long stride, int t0,
                                           int valid) {
  static_assert(DH % 32 == 0, "the swizzle stays inside a row");
#pragma unroll 4
  for (int j = 0; j < C * DH / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads, t = i / DH, d = i % DH;
    cp_async4(stage + t * DH + (d ^ (t % 32)),
              t < valid ? src + (t0 + t) * stride + d : src, t < valid);
  }
}
template <int C, int DH>
__device__ __forceinline__ void transpose_staged(float* dst,
                                                 const float* stage) {
#pragma unroll 4
  for (int j = 0; j < C * DH / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads, t = i % C, d = i / C;
    dst[d * C + t] = stage[t * DH + (d ^ (t % 32))];
  }
}

// lw_cum and lw_before along each channel of a DH x C tile, a warp a
// channel (32 tokens a step): lw is read from lb_t and replaced by
// lw_before, lw_cum goes to lc_t
template <int C, int DH>
__device__ __forceinline__ void scan_channels(float* lb_t, float* lc_t) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // a warp's channels unrolled, so that their shuffle chains overlap
#pragma unroll
  for (int j = 0; j < DH / (kThreads / 32); ++j) {
    const int d = warp + j * (kThreads / 32);
    float carry = 0.f;
#pragma unroll
    for (int t0w = 0; t0w < C; t0w += 32) {
      const int t = t0w + lane;
      const float lw = t < C ? lb_t[d * C + t] : 0.f;
      float x = lw;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float o = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += o;
      }
      x += carry;
      if (t < C) {
        lc_t[d * C + t] = x;
        lb_t[d * C + t] = x - lw;
      }
      carry = __shfl_sync(0xffffffffu, x, 31);
    }
  }
}

template <int C, int DH>
constexpr int delta_smem_floats() {
  return 3 * C * DH;
}

// 1. dS_c = (k * exp(cw - lw_cum))^T v and exp(cw) of one chunk.  The
//    tiles stay row-major (C x DH), copied by cp.async, coalesced and
//    without registers; the scan along the tokens is a thread a channel
//    (lanes on consecutive channels, so conflict-free)
template <int C, int DH>
__global__ void __launch_bounds__(kThreads)
    wkv_delta_kernel(const WkvParams p) {
  constexpr int DV = DH, CQ = DV / 4;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // C x DH: k, then decayed
  float* lc_s = k_s + C * DH;   // C x DH: lw, then lw_cum
  float* v_s = lc_s + C * DH;   // C x DV

  const int tid = threadIdx.x;
  const int ch = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = ch * C, valid = min(C, p.seq - t0);
  copy_rows<C, DH>(k_s, p.k + b * p.ks[0] + h * p.ks[1], p.ks[2], t0,
                         valid);
  copy_rows<C, DH>(lc_s, p.w + b * p.ws[0] + h * p.ws[1], p.ws[2], t0,
                         valid);
  copy_rows<C, DV>(v_s, p.v + b * p.vs[0] + h * p.vs[1], p.vs[2], t0,
                         valid);
  cp_async_wait_all();
  __syncthreads();
  if (tid < DH) {
    float x = 0.f;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      x += lc_s[t * DH + tid];
      lc_s[t * DH + tid] = x;
    }
  }
  __syncthreads();

  const long long cidx =
      (static_cast<long long>(b) * p.heads + h) * p.nchunks + ch;
  const float* cw = lc_s + (C - 1) * DH;
#pragma unroll 4
  for (int j = 0; j < DH * C / kThreads; ++j) {  // past the end k is 0
    const int i = tid + j * kThreads;
    k_s[i] *= expf(cw[i % DH] - lc_s[i]);
  }
  if (tid < DH) p.ecw[cidx * DH + tid] = expf(cw[tid]);
  __syncthreads();

  float* ds = p.ds + cidx * DH * DV;
  for (int i = tid; i < (DH / 4) * CQ; i += kThreads) {
    const int di = i / CQ, q = i % CQ;
    float sn[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sn[a][c] = 0.f;
#pragma unroll 4
    for (int s = 0; s < valid; ++s) {
      const float4 ks4 = ld4(k_s + s * DH + 4 * di);
      const float4 vs4 = ld4(v_s + s * DV + 4 * q);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sn[a][c] += at(ks4, a) * at(vs4, c);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
      st4(ds + (4 * di + a) * DV + 4 * q,
          make_float4(sn[a][0], sn[a][1], sn[a][2], sn[a][3]));
  }
}

// 2. the chunks in order for a Dh x 32 slice of the state, two float4 of
//    a row a thread (two chains, and one wave of blocks at the serving
//    shape): S_c over dS_c, then S_c+1 = diag(exp(cw_c)) S_c + dS_c; the
//    final state out
template <int DH>
__global__ void __launch_bounds__(DH * 4) wkv_scan_kernel(const WkvParams p) {
  constexpr int DV = DH, STEP = DH * DV;
  const int tid = threadIdx.x, d = tid / 4, q = tid % 4;
  const int col = blockIdx.x * kScanCols + 4 * q, h = blockIdx.y,
            b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.heads + h;
  const long long s_off = bh * DH * DV + d * DV + col;
  float4 s[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    s[j] = p.s_in ? ld4(p.s_in + s_off + 16 * j) : zero4();
  float* ds = p.ds + bh * p.nchunks * STEP + d * DV + col;
  const float* ecw = p.ecw + bh * p.nchunks * DH + d;
  float4 next[2] = {ld4(ds), ld4(ds + 16)};
  float e_next = ecw[0];
  for (int c = 0; c < p.nchunks; ++c) {
    float4 delta[2] = {next[0], next[1]};
    const float e = e_next;
    float* here = ds + static_cast<long long>(c) * STEP;
    if (c + 1 < p.nchunks) {  // the next chunk's loads before these stores
      next[0] = ld4(here + STEP);
      next[1] = ld4(here + STEP + 16);
      e_next = ecw[(c + 1) * DH];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      st4(here + 16 * j, s[j]);  // S_c over dS_c
      s[j] = make_float4(e * s[j].x + delta[j].x, e * s[j].y + delta[j].y,
                         e * s[j].z + delta[j].z, e * s[j].w + delta[j].w);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) st4(p.s_out + s_off + 16 * j, s[j]);
}

// S_c fits beside A^T in the lw_before and lw_cum tiles (C = Dh): then it
// has no tile of its own
template <int C, int DH>
__host__ __device__ constexpr bool state_over_lc() {
  return DH * DH <= 2 * DH * C - C * C;
}

template <int C, int DH>
constexpr int output_smem_floats() {
  constexpr int NS = C / kSub;
  return 4 * DH * C + C + NS * DH + NS * (NS - 1) / 2 * DH + DH +
         (state_over_lc<C, DH>() ? 0 : DH * DH);
}

// 3. y of one chunk from its inputs and S_c
template <int C, int DH>
__global__ void __launch_bounds__(kThreads, 3)
    wkv_output_kernel(const WkvParams p) {
  constexpr int DV = DH, NS = C / kSub, RT = C / 4, CQ = DV / 4;
  // lower 2 x 2 tiles of a diagonal block, and the upper ones read as 0
  constexpr int DIAG_TILES = (kSub / 2) * (kSub / 2 + 1) / 2;
  constexpr int ZERO_TILES = kSub / 4;
  constexpr int OFF_TILES = NS * (NS - 1) / 2 * (kSub / 4) * (kSub / 4);
  static_assert(kSub % 4 == 0, "4 x 4 tiles");
  static_assert(C % kSub == 0 && C * C <= 2 * DH * C, "A^T fits lb and lc");
  static_assert(2 * NS * DIAG_TILES <= kThreads && OFF_TILES <= kThreads &&
                    NS * ZERO_TILES <= kThreads,
                "one triangle tile a thread");
  static_assert(2 * NS * DIAG_TILES + C <= kThreads,
                "the bonus on the threads past the diagonal tiles");

  extern __shared__ float4 smem4[];
  float* r_t = reinterpret_cast<float*>(smem4);  // DH x C: r, then r~
  float* k_t = r_t + DH * C;    // DH x C: k, then k~
  float* lb_t = k_t + DH * C;   // DH x C: lw, then lw_before
  float* lc_t = lb_t + DH * C;  // DH x C: lw_cum
  float* diag = lc_t + DH * C;  // C: the bonus r . (u * k)
  float* eb = diag + C;         // NS x DH: exp(B_I)
  float* xf = eb + NS * DH;     // pairs J < I x DH: exp(B_I - E_J)
  float* u_s = xf + NS * (NS - 1) / 2 * DH;  // DH: u
  // Once the decays are spent: A^T (C x C, [s][t]) over lw_before, S_c
  // (DH x DV) over lw_cum beside it where it fits, else a tile of its own,
  // and, once k~ is spent, v (C x DV) over k.  Three blocks an SM fit at
  // C = Dh = 64, where a tile each took two.
  float* a_t = lb_t;
  float* s_s = state_over_lc<C, DH>() ? lb_t + C * C : u_s + DH;
  float* v_s = k_t;

  const int tid = threadIdx.x;
  const int ch = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = ch * C, valid = min(C, p.seq - t0);
  const long long cidx =
      (static_cast<long long>(b) * p.heads + h) * p.nchunks + ch;
  const float* sc = p.ds + cidx * DH * DV;  // S_c
  const float* vg = p.v + b * p.vs[0] + h * p.vs[1];
  // r, k and the log-decays staged row-major over lw_before, lw_cum and k
  // (all free yet), then moved to their transposed tiles in the order that
  // frees each destination before it is written: r (lw_before -> r), the
  // decays (k -> lw_before), k (lw_cum -> k)
  stage_rows<C, DH>(lb_t, p.r + b * p.rs[0] + h * p.rs[1], p.rs[2], t0,
                    valid);
  stage_rows<C, DH>(lc_t, p.k + b * p.ks[0] + h * p.ks[1], p.ks[2], t0,
                    valid);
  stage_rows<C, DH>(k_t, p.w + b * p.ws[0] + h * p.ws[1], p.ws[2], t0,
                    valid);
  if (!state_over_lc<C, DH>()) copy_rows<DH, DV>(s_s, sc, DV, 0, DH);
  if (tid < DH) u_s[tid] = p.u[h * DH + tid];
  cp_async_wait_all();
  __syncthreads();
  transpose_staged<C, DH>(r_t, lb_t);
  __syncthreads();
  transpose_staged<C, DH>(lb_t, k_t);
  __syncthreads();
  transpose_staged<C, DH>(k_t, lc_t);
  __syncthreads();

  scan_channels<C, DH>(lb_t, lc_t);
  __syncthreads();

  // the diagonal blocks in the direct form: their lower 2 x 2 register
  // tiles, each on two adjacent lanes that take half the channels and are
  // summed by one shuffle, in a fixed order (whole warps work, and each
  // thread's chain of expf is half as long)
  float dacc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  const int dtile = tid / 2, dhalf = tid % 2;
  int dtt = 0, dss = dtile % DIAG_TILES;  // (row, col) pair of the block
  while (dss > dtt) {
    dss -= dtt + 1;
    ++dtt;
  }
  const int dblk = dtile / DIAG_TILES;
  const int dt = dblk * kSub + 2 * dtt, ds0 = dblk * kSub + 2 * dss;
  // 1 below the diagonal, 0 on it: a product, not a branch, so that the
  // four chains of expf of an iteration overlap (a per-element branch
  // serialises them); an element on the diagonal takes exp(0) = 1 x 0
  float below[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) below[a][c] = ds0 + c < dt + a ? 1.f : 0.f;
  if (dtile < NS * DIAG_TILES) {
#pragma unroll 4
    for (int d = dhalf * (DH / 2); d < (dhalf + 1) * (DH / 2); ++d) {
      const float2 rt = *reinterpret_cast<const float2*>(r_t + d * C + dt);
      const float2 bt = *reinterpret_cast<const float2*>(lb_t + d * C + dt);
      const float2 ks = *reinterpret_cast<const float2*>(k_t + d * C + ds0);
      const float2 cs = *reinterpret_cast<const float2*>(lc_t + d * C + ds0);
      const float rr[2] = {rt.x, rt.y}, bb[2] = {bt.x, bt.y};
      const float kk[2] = {ks.x, ks.y}, cc[2] = {cs.x, cs.y};
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          dacc[a][c] += (below[a][c] * rr[a]) * kk[c] *
                        expf(fminf(bb[a] - cc[c], 0.f));
    }
  }
  // the threads past the diagonal tiles: the bonus r . (u * k) a token
  const int tok = tid - 2 * NS * DIAG_TILES;
  if (tok >= 0 && tok < C) {
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d)
      acc += r_t[d * C + tok] * (u_s[d] * k_t[d * C + tok]);
    diag[tok] = acc;
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float other = __shfl_xor_sync(0xffffffffu, dacc[a][c], 1);
      dacc[a][c] = dhalf ? other + dacc[a][c] : dacc[a][c] + other;
    }
  __syncthreads();

  // r to its sub-chunk's start, k to its sub-chunk's end; the edges'
  // factors
#pragma unroll 4
  for (int j = 0; j < DH * C / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int d = i / C, t = i % C, sub = t / kSub;
    const float* lc = lc_t + d * C;
    // (the last sub-chunk's k~ is not used: decayed to the chunk's end, so
    // without a branch)
    r_t[i] *= expf(lb_t[i] - (sub ? lc[sub * kSub - 1] : 0.f));
    k_t[i] *= expf(lc[sub * kSub + kSub - 1] - lc_t[i]);
  }
  for (int i = tid; i < NS * DH; i += kThreads) {
    const int sub = i / DH, d = i % DH;
    eb[i] = sub ? expf(lc_t[d * C + sub * kSub - 1]) : 1.f;
  }
  for (int i = tid; i < NS * (NS - 1) / 2 * DH; i += kThreads) {
    const int pair = i / DH, d = i % DH;
    int bi = 1, bj = pair;  // pairs in order (1,0), (2,0), (2,1), (3,0), ...
    while (bj >= bi) {
      bj -= bi;
      ++bi;
    }
    xf[i] = expf(lc_t[d * C + bi * kSub - 1] -
                 lc_t[d * C + bj * kSub + kSub - 1]);
  }
  __syncthreads();
  if (state_over_lc<C, DH>()) copy_rows<DH, DV>(s_s, sc, DV, 0, DH);

  // A^T: the diagonal tiles (and the upper 2 x 2 tile of each 4 x 4 one
  // on the diagonal, which the rows' sums read as 0), then the
  // off-diagonal blocks as products
  if (dtile < NS * DIAG_TILES && dhalf == 0)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int a = 0; a < 2; ++a)
        a_t[(ds0 + c) * C + dt + a] = dacc[a][c];
  if (tid < NS * ZERO_TILES) {
    const int t = 4 * tid;  // rows t, t + 1 x keys t + 2, t + 3
#pragma unroll
    for (int c = 2; c < 4; ++c)
#pragma unroll
      for (int a = 0; a < 2; ++a) a_t[(t + c) * C + t + a] = 0.f;
  }
  constexpr int SQ4 = kSub / 4;  // 4 x 4 tiles along a sub-chunk
  if (tid < OFF_TILES) {
    const int pair = tid / (SQ4 * SQ4), ti = (tid % (SQ4 * SQ4)) / SQ4,
              si = tid % SQ4;
    int bi = 1, bj = pair;
    while (bj >= bi) {
      bj -= bi;
      ++bi;
    }
    const int t = bi * kSub + 4 * ti, s = bj * kSub + 4 * si;
    const float* x = xf + pair * DH;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float4 rt = ld4(r_t + d * C + t);
      const float4 ks = ld4(k_t + d * C + s);
      const float xd = x[d];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float rx = at(rt, a) * xd;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] += rx * at(ks, c);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      st4(a_t + (s + c) * C + t,
          make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]));
  }
  __syncthreads();
  copy_rows<C, DV>(v_s, vg, p.vs[2], t0, valid);  // over k~, spent
  // r~ exp(B_I) = r exp(lw_before), for the inter-chunk term
  for (int i = tid; i < DH * C; i += kThreads)
    r_t[i] *= eb[(i % C) / kSub * DH + i / C];
  cp_async_wait_all();
  __syncthreads();

  // y = A v + diag v + (r exp(lw_before)) S_c for the real rows
  float* y = p.y + b * p.ys[0] + h * p.ys[1];
  for (int i = tid; i < RT * CQ; i += kThreads) {
    const int ti = i / CQ, q = i % CQ;
    if (4 * ti >= valid) continue;
    float o[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[a][c] = 0.f;
    for (int s = 0; s < 4 * ti + 4; ++s) {
      const float4 at4 = ld4(a_t + s * C + 4 * ti);
      const float4 vs4 = ld4(v_s + s * DV + 4 * q);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[a][c] += at(at4, a) * at(vs4, c);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 vt = ld4(v_s + (4 * ti + a) * DV + 4 * q);
      const float dg = diag[4 * ti + a];
#pragma unroll
      for (int c = 0; c < 4; ++c) o[a][c] += dg * at(vt, c);
    }
    for (int d = 0; d < DH; ++d) {
      const float4 rd = ld4(r_t + d * C + 4 * ti);
      const float4 sd = ld4(s_s + d * DV + 4 * q);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[a][c] += at(rd, a) * at(sd, c);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (4 * ti + a < valid)
        st4(y + static_cast<long long>(t0 + 4 * ti + a) * p.ys[2] + 4 * q,
            make_float4(o[a][0], o[a][1], o[a][2], o[a][3]));
  }
}

// once per kernel and process: dynamic shared memory above 48 KB, and all
// of L1 as shared memory, so that as many blocks as fit share an SM
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return 0;
  cudaError_t err = cudaSuccess;
  if (bytes > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  configured = true;
  return 0;
}

template <int C, int DH>
int launch_chunks(const WkvParams& p, int batch, cudaStream_t stream) {
  constexpr int delta_smem = delta_smem_floats<C, DH>() * 4;
  constexpr int out_smem = output_smem_floats<C, DH>() * 4;
  static bool delta_ok = false, out_ok = false;
  int err = allow_smem(wkv_delta_kernel<C, DH>, delta_smem, delta_ok);
  if (!err) err = allow_smem(wkv_output_kernel<C, DH>, out_smem, out_ok);
  if (err) return err;
  const dim3 chunks(p.nchunks, p.heads, batch);
  wkv_delta_kernel<C, DH><<<chunks, kThreads, delta_smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv_scan_kernel<DH>
      <<<dim3(DH / kScanCols, p.heads, batch), DH * 4, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv_output_kernel<C, DH><<<chunks, kThreads, out_smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch(const WkvParams& p, int chunk, int batch, cudaStream_t stream) {
  if (p.seq == 1) {
    wkv_step_kernel<DH>
        <<<dim3(DH / kSlice, p.heads, batch), DH * kSlice / 4, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (chunk == 16) return launch_chunks<16, DH>(p, batch, stream);
  if (chunk == 32) return launch_chunks<32, DH>(p, batch, stream);
  if (chunk == 64) return launch_chunks<64, DH>(p, batch, stream);
  return -1;
}

}  // namespace

// The WKV of `seq` tokens on `stream`; returns cudaGetLastError() (0 on
// success) or -1 for a (chunk, dh) without an instantiation.  One token
// runs wkv_step_kernel; more run the three chunk kernels, which need the
// scratch: ds B*H*n*dh*dh floats and ecw B*H*n*dh floats, n = ceil(seq /
// chunk) (both unused, and may be null, when seq == 1).
// r, k, v, w and y are float32 (B, H, S, Dh) with a contiguous last
// dimension, 16-byte aligned rows; strides holds the element strides of
// their dims 0-2 in that order (15 values).  u is (H, Dh) contiguous;
// s_in (null for zeros) and s_out are (B, H, Dh, Dh) contiguous, and may
// be the same buffer: a block reads its slice of the state before it
// writes that slice, and the output kernel reads S_c from the scratch.
extern "C" int rwkv6_wkv_fwd(int chunk, int dh, const float* r,
                             const float* k, const float* v, const float* w,
                             const float* u, const float* s_in, float* s_out,
                             float* y, float* ds, float* ecw,
                             const long long* strides, int batch, int heads,
                             int seq, void* stream) {
  WkvParams p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = w;
  p.u = u;
  p.s_in = s_in;
  p.s_out = s_out;
  p.y = y;
  p.ds = ds;
  p.ecw = ecw;
  for (int i = 0; i < 3; ++i) {
    p.rs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.ws[i] = strides[9 + i];
    p.ys[i] = strides[12 + i];
  }
  p.heads = heads;
  p.seq = seq;
  p.nchunks = (seq + chunk - 1) / chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 32) return launch<32>(p, chunk, batch, s);
  if (dh == 64) return launch<64>(p, chunk, batch, s);
  return -1;
}

extern "C" const char* rwkv6_error_string(int err) {
  if (err == -1) return "no kernel instantiated for this chunk/dh";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
