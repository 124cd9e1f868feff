// The chunked RWKV6 WKV (data-dependent-decay linear attention), written by
// hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6/kernel.py::
// wkv_chunked_pallas (grid (B*H, n_chunks), the chunk axis sequential with
// the Dh x Dv state in VMEM scratch), and computes what the model's WKV
// computes (repro/models/rwkv.py::wkv_chunked), which the Pallas kernel
// does not quite: it takes an initial state (null means zeros, the Pallas
// kernel's start) and writes the final state, which the Pallas kernel
// drops.  Per chunk of C tokens, with lw the log-decays (<= 0), lw_cum
// their running sum inside the chunk, lw_before = lw_cum - lw and cw the
// chunk's total:
//
//   A[t,s] = sum_d r[t,d] k[s,d] exp(min(lw_before[t,d] - lw_cum[s,d], 0))
//            for s < t (strict lower triangle), else 0
//   y      = A v + diag(r . (u * k)) v + (r * exp(lw_before)) S
//   S      = diag(exp(cw)) S + (k * exp(cw - lw_cum))^T v
//
// Every exponent of a valid term is <= 0.  The intra-chunk factor is taken
// in this direct form, one exp per (t, s, d), and never factored as
// exp(lw_before[t]) * exp(-lw_cum[s]): with log-decays down to -e a step,
// exp(-lw_cum) overflows within a chunk.  expf is the precise one (no fast
// math): a fast variant would be a separately named backend.
//
// Any S >= 1: the last chunk may be ragged.  Its tokens past S are loaded
// as r = k = v = lw = 0, so they add nothing to y or the state, and they are
// not written; the loops over rows and keys stop at the last real token, so
// the one-token decode step costs one token and the state.  The reference
// kernel requires S % chunk == 0 (kernel.py:79-80).
//
// What bounds it on the H100: at the serving shape (B 8, H 40, S 2048,
// Dh = Dv 64) the least it can take is the bytes, ~0.85 GB (0.25 ms at
// 3.35 TB/s); the fewest flops, ~1.1e10 (ops.py::least_flops, 0.16 ms on
// the float32 pipes), come below that.  This chunked form does ~1.6e10 (the
// strict triangle besides) plus ~1.3e9 precise expf for the intra-chunk
// factor.  What the design does about it: one block per (b, h) loops over
// the chunks and keeps S on chip for the whole sequence (the TPU's
// sequential chunk axis), so S touches device memory once in and once out.
// A chunk's r, k, lw_before and lw_cum sit in shared memory transposed
// (Dh x C), so a thread reads four consecutive tokens of one channel as one
// float4; v and the state sit row-major.  The (C x C) matrix A is built in
// 4 x 4 register tiles over the lower triangle only (136 tiles at C = 64),
// then y and the state update are 4 x 4 register tiles too.  No atomics:
// every sum has one fixed order, so a result is bit-for-bit repeatable.
// mma.sync, wgmma and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct WkvParams {
  const float* r;
  const float* k;
  const float* v;
  const float* w;        // log-decays
  const float* u;        // (H, Dh) contiguous
  const float* s_in;     // (B, H, Dh, Dh) contiguous, or null for zeros
  float* s_out;          // (B, H, Dh, Dh) contiguous; may be s_in
  float* y;
  long long rs[3], ks[3], vs[3], ws[3], ys[3];  // element strides (b, h, t)
  int heads, seq;
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

// floats of shared memory a block takes
template <int C, int DH>
constexpr int wkv_smem_floats() {
  return 4 * DH * C + C * DH + DH * DH + 2 * DH + C + (C > DH ? C * C : 0);
}

template <int C, int DH>
__global__ void __launch_bounds__(kThreads, 2) wkv_kernel(const WkvParams p) {
  constexpr int DV = DH;
  constexpr int RT = C / 4;                    // row tiles of a chunk
  constexpr int A_TILES = RT * (RT + 1) / 2;   // lower-triangle 4x4 tiles
  constexpr int CQ = DV / 4;                   // column quads of S and v
  static_assert(A_TILES <= kThreads, "one triangle tile a thread");
  static_assert(C <= kThreads, "one token of the bonus a thread");

  extern __shared__ float4 smem4[];
  float* r_t = reinterpret_cast<float*>(smem4);  // DH x C: r, then r*exp(lb)
  float* k_t = r_t + DH * C;    // DH x C: k, then k * exp(cw - lc)
  float* lb_t = k_t + DH * C;   // DH x C: lw, then lw_before
  float* lc_t = lb_t + DH * C;  // DH x C: lw_cum
  float* v_s = lc_t + DH * C;   // C x DV
  float* s_s = v_s + C * DV;    // DH x DV: the state
  float* cw = s_s + DH * DV;    // DH: the chunk's total log-decay
  float* ecw = cw + DH;         // DH: exp(cw)
  float* diag = ecw + DH;       // C: the bonus r . (u * k)
  // A^T (C x C, [s][t]) overwrites lw_before once the decays are taken
  float* a_t = C <= DH ? lb_t : diag + C;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const float* r = p.r + b * p.rs[0] + h * p.rs[1];
  const float* k = p.k + b * p.ks[0] + h * p.ks[1];
  const float* v = p.v + b * p.vs[0] + h * p.vs[1];
  const float* w = p.w + b * p.ws[0] + h * p.ws[1];
  const float* u = p.u + h * DH;
  float* y = p.y + b * p.ys[0] + h * p.ys[1];
  const long long s_off = (static_cast<long long>(b) * p.heads + h) * DH * DV;

  for (int i = tid; i < DH * CQ; i += kThreads) {
    const int d = i / CQ, q = i % CQ;
    st4(s_s + d * DV + 4 * q,
        p.s_in ? ld4(p.s_in + s_off + d * DV + 4 * q)
               : make_float4(0.f, 0.f, 0.f, 0.f));
  }

  // this thread's tile (ati, asi), asi <= ati, of A's lower triangle
  int ati = 0, asi = tid;
  while (asi > ati) {
    asi -= ati + 1;
    ++ati;
  }

  const int nchunks = (p.seq + C - 1) / C;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int t0 = ch * C;
    const int valid = min(C, p.seq - t0);

    // 1. r, k, lw transposed into Dh x C (lanes on consecutive tokens), v
    //    row-major; tokens past the end are 0
    for (int i = tid; i < C * (DH / 4); i += kThreads) {
      const int t = i % C, dq = i / C;
      float4 rr = make_float4(0.f, 0.f, 0.f, 0.f), kk = rr, ww = rr;
      if (t < valid) {
        const long long row = t0 + t;
        rr = ld4(r + row * p.rs[2] + 4 * dq);
        kk = ld4(k + row * p.ks[2] + 4 * dq);
        ww = ld4(w + row * p.ws[2] + 4 * dq);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r_t[(4 * dq + j) * C + t] = at(rr, j);
        k_t[(4 * dq + j) * C + t] = at(kk, j);
        lb_t[(4 * dq + j) * C + t] = at(ww, j);
      }
    }
    for (int i = tid; i < C * CQ; i += kThreads) {
      const int t = i / CQ, q = i % CQ;
      st4(v_s + t * DV + 4 * q,
          t < valid ? ld4(v + static_cast<long long>(t0 + t) * p.vs[2] + 4 * q)
                    : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    __syncthreads();

    // 2. lw_cum and lw_before along each channel (a warp scans a row of C
    //    tokens, 32 a step); the bonus of each token
    for (int d = warp; d < DH; d += kThreads / 32) {
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
      if (lane == 0) {
        cw[d] = carry;
        ecw[d] = expf(carry);
      }
    }
    if (tid < C) {
      float acc = 0.f;
      for (int d = 0; d < DH; ++d)
        acc += r_t[d * C + tid] * (u[d] * k_t[d * C + tid]);
      diag[tid] = acc;
    }
    __syncthreads();

    // 3. A's lower-triangle tiles that hold a real row, in registers
    const bool build = tid < A_TILES && 4 * ati < valid;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if (build) {
#pragma unroll 2
      for (int d = 0; d < DH; ++d) {
        const float4 rt = ld4(r_t + d * C + 4 * ati);
        const float4 bt = ld4(lb_t + d * C + 4 * ati);
        const float4 ks = ld4(k_t + d * C + 4 * asi);
        const float4 cs = ld4(lc_t + d * C + 4 * asi);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] += at(rt, i) * at(ks, j) *
                         expf(fminf(at(bt, i) - at(cs, j), 0.f));
      }
    }
    __syncthreads();

    // 4. the decays, in place: r to the chunk's start, k to its end
    for (int i = tid; i < DH * C; i += kThreads) {
      if (i % C < valid) {
        r_t[i] *= expf(lb_t[i]);
        k_t[i] *= expf(cw[i / C] - lc_t[i]);
      }
    }
    __syncthreads();

    // 5. A^T into shared memory, 0 on and above the diagonal
    if (build) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = 4 * asi + j;
        float col[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) col[i] = s < 4 * ati + i ? acc[i][j] : 0.f;
        st4(a_t + s * C + 4 * ati, make_float4(col[0], col[1], col[2], col[3]));
      }
    }
    __syncthreads();

    // 6. y = A v + diag v + (r * exp(lw_before)) S for the real rows
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
    __syncthreads();

    // 7. S = diag(exp(cw)) S + (k * exp(cw - lw_cum))^T v
    for (int i = tid; i < (DH / 4) * CQ; i += kThreads) {
      const int di = i / CQ, q = i % CQ;
      float sn[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 sd = ld4(s_s + (4 * di + a) * DV + 4 * q);
        const float e = ecw[4 * di + a];
#pragma unroll
        for (int c = 0; c < 4; ++c) sn[a][c] = e * at(sd, c);
      }
      for (int s = 0; s < valid; ++s) {
        const float4 vs4 = ld4(v_s + s * DV + 4 * q);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float kd = k_t[(4 * di + a) * C + s];
#pragma unroll
          for (int c = 0; c < 4; ++c) sn[a][c] += kd * at(vs4, c);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        st4(s_s + (4 * di + a) * DV + 4 * q,
            make_float4(sn[a][0], sn[a][1], sn[a][2], sn[a][3]));
    }
    __syncthreads();
  }

  for (int i = tid; i < DH * CQ; i += kThreads) {
    const int d = i / CQ, q = i % CQ;
    st4(p.s_out + s_off + d * DV + 4 * q, ld4(s_s + d * DV + 4 * q));
  }
}

template <int C, int DH>
int launch(const WkvParams& p, int batch, cudaStream_t stream) {
  constexpr int smem = wkv_smem_floats<C, DH>() * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_kernel<C, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.heads, batch);
  wkv_kernel<C, DH><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int dispatch_dh(const WkvParams& p, int dh, int batch, cudaStream_t stream) {
  if (dh == 32) return launch<C, 32>(p, batch, stream);
  if (dh == 64) return launch<C, 64>(p, batch, stream);
  return -1;
}

}  // namespace

// The WKV of `seq` tokens on `stream`; returns cudaGetLastError() (0 on
// success) or -1 for a (chunk, dh) without an instantiation.
// r, k, v, w and y are float32 (B, H, S, Dh) with a contiguous last
// dimension, 16-byte aligned rows; strides holds the element strides of
// their dims 0-2 in that order (15 values).  u is (H, Dh) contiguous;
// s_in (null for zeros) and s_out are (B, H, Dh, Dh) contiguous, and may
// be the same buffer: each block reads its state before it writes it.
extern "C" int rwkv6_wkv_fwd(int chunk, int dh, const float* r,
                             const float* k, const float* v, const float* w,
                             const float* u, const float* s_in, float* s_out,
                             float* y, const long long* strides, int batch,
                             int heads, int seq, void* stream) {
  WkvParams p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = w;
  p.u = u;
  p.s_in = s_in;
  p.s_out = s_out;
  p.y = y;
  for (int i = 0; i < 3; ++i) {
    p.rs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.ws[i] = strides[9 + i];
    p.ys[i] = strides[12 + i];
  }
  p.heads = heads;
  p.seq = seq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk == 16) return dispatch_dh<16>(p, dh, batch, s);
  if (chunk == 32) return dispatch_dh<32>(p, dh, batch, s);
  if (chunk == 64) return dispatch_dh<64>(p, dh, batch, s);
  return -1;
}

extern "C" const char* rwkv6_error_string(int err) {
  if (err == -1) return "no kernel instantiated for this chunk/dh";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
