// BatchNorm with its epilogue (PReLU, or a skip add) on NHWC tensors, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses it with its neighbours.  It was added for the SRGAN generator's 33
// BatchNorms a step, which ran as the composition of models/layers.py
// BatchNorm.forward and PReLU (or + skip): an f32 copy of the bf16
// activation, cuDNN's NCHW kernels with NHWC <-> NCHW transposes around
// them, the cast back, and the epilogue as separate elementwise passes,
// forward and backward.  ops/bn_act.py holds that composition as the plain
// version and the wrapper.
//
// What it computes, on x: R rows of C channels (NHWC flattened) in the
// compute dtype T (bf16 or f32), statistics and every sum in f32:
//
//   training: mean, var = batch statistics (biased); running_mean and
//             running_var move by `momentum` towards mean and the
//             unbiased var; num_batches_tracked += 1
//   eval:     mean, var = running_mean, running_var
//   xhat = (x - mean) * invstd,  invstd = 1 / sqrt(var + eps)
//   z    = T(fma(xhat, gamma, beta))          (rounded, as the composition)
//   out  = z | z >= 0 ? z : T(T(slope) * z) | T(z + skip)
//
// and backward, with dz = dy, or for PReLU dz = z >= 0 ? dy : T(dy *
// T(slope)) (what autograd gives the composition):
//
//   dbeta = sum dz,  dgamma = sum dz * xhat,  dslope = T(sum_{z<0} T(dy*z))
//   dx = T(invstd * gamma * (dz - mean(dz) - xhat * mean(dz * xhat)))
//        (eval: T(invstd * gamma * dz));  dskip = dy.
//
// The mask and z are recomputed from x with the forward's expression
// (bn_out below), so they are the forward's bit for bit; the forward saves
// x, mean and invstd and nothing of f32 size.
//
// Bound on this card (H100 SXM): bytes.  At the SRGAN pretrain's
// (128, 24, 24, 64) bf16 one activation is 9.44 MB, 2.82 us at 3.35 TB/s:
// a forward reads x and writes out (5.6 us; 8.5 with the skip), a backward
// reads x and dy and writes dx (8.5 us).  The arithmetic is a few FLOP a
// byte, far below the card's balance.
//
// Design.  Two launches each way, both over the same grid: CTA b owns the
// rows [b * rpb, (b + 1) * rpb), read with 16-byte loads, 8 channels a
// thread (C / 8 threads a row, NT / (C / 8) rows in flight a CTA, UNROLL
// rows a thread).  The first launch reduces (forward: count, mean and M2 by
// Welford per thread and Chan's merge per CTA; backward: sum dz, sum
// dz * xhat and the slope's sum) into one partial a CTA in a scratch
// buffer; the second merges the partials of all CTAs (each CTA the same
// merge, in the same order, so each gets the same statistics) and makes the
// elementwise pass over its rows again, which the first pass left in the
// 50 MB L2.  CTA 0 alone writes what is per channel: the running
// statistics, mean and invstd for the backward, dgamma, dbeta, dslope.  No
// atomics, no host read, nothing allocated: the scratch comes from the
// wrapper, so the four launches can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;       // threads a CTA
constexpr int FWD_UNROLL = 4;  // rows a thread has in flight, forward
constexpr int BWD_UNROLL = 2;  // backward (x and dy: the same bytes)
constexpr int MAX_C = 256;

enum Epilogue { EPI_NONE = 0, EPI_PRELU = 1, EPI_ADD = 2 };

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The BatchNorm output z of one element, rounded to T: the one expression
// of every pass that needs it (forward apply, both backward passes).
template <typename T>
__device__ __forceinline__ float bn_out(float xhat, float gamma, float beta) {
  return rnd<T>(fmaf(xhat, gamma, beta));
}

// A thread's share of its CTA's rows: thread (lane, g) reads channels
// g * 8 .. g * 8 + 7 of rows start + lane, start + lane + lanes, ...
// Threads past lanes * (C / 8) read none.
struct Rows {
  int lane, g, lanes, start, end;
};

__device__ __forceinline__ Rows rows_of(int R, int C, int rpb) {
  const int groups = C / 8;
  Rows s;
  s.lanes = NT / groups;
  s.g = threadIdx.x % groups;
  s.lane = threadIdx.x / groups;
  s.start = blockIdx.x * rpb;
  s.end = min(R, s.start + rpb);
  if (s.lane >= s.lanes) s.start = s.end;
  return s;
}

// Rows of partial b (the rows its CTA owned).
__device__ __forceinline__ float rows_in(int b, int R, int rpb) {
  return (float)max(0, min(R, (b + 1) * rpb) - b * rpb);
}

// Chan's merge of (nb, mb, qb) into (n, m, q): count, mean, M2.
__device__ __forceinline__ void chan(float& n, float& m, float& q, float nb,
                                     float mb, float qb) {
  if (nb == 0.f) return;
  const float n2 = n + nb, d = mb - m, f = nb / n2;
  m = fmaf(d, f, m);
  q += qb + d * d * n * f;
  n = n2;
}

// Sum over NT threads of v (every thread calls it); the result in all.
// sh: NT / 32 floats.
__device__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) sh[threadIdx.x / 32] = v;
  __syncthreads();
  float out = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) out += sh[w];
  __syncthreads();
  return out;
}

// Forward pass 1 (training): each CTA's (mean, M2) per channel into
// part[b][0][c], part[b][1][c]; its count is rows_in(b).
template <typename T>
__global__ void __launch_bounds__(NT)
    bn_stats(const T* __restrict__ x, float* __restrict__ part, int R, int C,
             int rpb) {
  __shared__ float sh_m[NT * 8];
  __shared__ float sh_q[NT * 8];
  __shared__ float sh_n[NT];
  const Rows s = rows_of(R, C, rpb);
  float mean[8], m2[8], n = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) mean[i] = m2[i] = 0.f;
  for (int r0 = s.start + s.lane; r0 < s.end; r0 += FWD_UNROLL * s.lanes) {
    float v[FWD_UNROLL][8];
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u) {
      const int r = r0 + u * s.lanes;
      if (r < s.end) load8(x + (size_t)r * C + s.g * 8, v[u]);
    }
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u) {
      if (r0 + u * s.lanes >= s.end) break;
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = v[u][i] - mean[i];
        mean[i] = fmaf(d, inv, mean[i]);
        m2[i] = fmaf(d, v[u][i] - mean[i], m2[i]);
      }
    }
  }
  if (s.lane < s.lanes) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sh_m[s.lane * C + s.g * 8 + i] = mean[i];
      sh_q[s.lane * C + s.g * 8 + i] = m2[i];
    }
    if (s.g == 0) sh_n[s.lane] = n;
  }
  __syncthreads();
  // lanes k, k + K, ... of channel c by thread (c, k), then the K parts
  const int K = NT / C, c = threadIdx.x % C, k = threadIdx.x / C;
  float an = 0.f, am = 0.f, aq = 0.f;
  if (k < K) {
    for (int l = k; l < s.lanes; l += K)
      chan(an, am, aq, sh_n[l], sh_m[l * C + c], sh_q[l * C + c]);
  }
  __syncthreads();
  if (k < K) {
    sh_n[k * C + c] = an;
    sh_m[k * C + c] = am;
    sh_q[k * C + c] = aq;
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float n2 = 0.f, m = 0.f, q = 0.f;
    for (int j = 0; j < K; ++j)
      chan(n2, m, q, sh_n[j * C + c], sh_m[j * C + c], sh_q[j * C + c]);
    part[(size_t)blockIdx.x * 2 * C + c] = m;
    part[(size_t)blockIdx.x * 2 * C + C + c] = q;
  }
}

// Forward pass 2: mean and invstd per channel (training: merged from the P
// partials; eval: the running statistics), CTA 0's updates, then out over
// the CTA's rows.  stats[0:C] = mean, stats[C:2C] = invstd, for backward.
template <typename T, int EPI>
__global__ void __launch_bounds__(NT)
    bn_apply(const T* __restrict__ x, const T* __restrict__ skip,
             T* __restrict__ y, const float* __restrict__ part, int P,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             const float* __restrict__ slope, float* running_mean,
             float* running_var, long long* num_batches, float* stats, int R,
             int C, int rpb, float eps, float momentum, int train) {
  __shared__ float sh[NT];
  __shared__ float sh_mean[MAX_C];
  __shared__ float sh_invstd[MAX_C];
  const Rows s = rows_of(R, C, rpb);
  const int K = NT / C, c = threadIdx.x % C, k = threadIdx.x / C;
  // the first rows' loads go out before the merge
  float v[FWD_UNROLL][8], w[FWD_UNROLL][8];
  int r0 = s.start + s.lane;
#pragma unroll
  for (int u = 0; u < FWD_UNROLL; ++u) {
    const int r = r0 + u * s.lanes;
    if (r < s.end) {
      load8(x + (size_t)r * C + s.g * 8, v[u]);
      if constexpr (EPI == EPI_ADD) load8(skip + (size_t)r * C + s.g * 8, w[u]);
    }
  }
  if (train) {
    // mean = sum_b n_b mean_b / R; M2 = sum_b M2_b + n_b (mean_b - mean)^2
    float acc = 0.f;
    if (k < K)
#pragma unroll 8
      for (int b = k; b < P; b += K)
        acc = fmaf(rows_in(b, R, rpb), part[(size_t)b * 2 * C + c], acc);
    sh[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < C) {
      float t = 0.f;
      for (int j = 0; j < K; ++j) t += sh[j * C + c];
      sh_mean[c] = t / (float)R;
    }
    __syncthreads();
    const float m = sh_mean[c];
    acc = 0.f;
    if (k < K)
#pragma unroll 8
      for (int b = k; b < P; b += K) {
        const float d = part[(size_t)b * 2 * C + c] - m;
        acc += part[(size_t)b * 2 * C + C + c] + rows_in(b, R, rpb) * d * d;
      }
    __syncthreads();
    sh[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < C) {
      float m2 = 0.f;
      for (int j = 0; j < K; ++j) m2 += sh[j * C + c];
      sh_invstd[c] = 1.f / sqrtf(m2 / (float)R + eps);
      if (blockIdx.x == 0) {
        const float unbiased = m2 / (float)(R - 1);
        running_mean[c] = (1.f - momentum) * running_mean[c] + momentum * m;
        running_var[c] = (1.f - momentum) * running_var[c] + momentum * unbiased;
        if (c == 0) *num_batches += 1;
      }
    }
  } else if (threadIdx.x < C) {
    sh_mean[c] = running_mean[c];
    sh_invstd[c] = 1.f / sqrtf(running_var[c] + eps);
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x < C) {
    stats[c] = sh_mean[c];
    stats[C + c] = sh_invstd[c];
  }
  float mu[8], is[8], ga[8], be[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ch = s.g * 8 + i;
    mu[i] = sh_mean[ch];
    is[i] = sh_invstd[ch];
    ga[i] = gamma[ch];
    be[i] = beta[ch];
  }
  const float a = EPI == EPI_PRELU ? rnd<T>(slope[0]) : 0.f;
  for (; r0 < s.end; r0 += FWD_UNROLL * s.lanes) {
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u) {
      const int r = r0 + u * s.lanes;
      if (r >= s.end) break;
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float z = bn_out<T>((v[u][i] - mu[i]) * is[i], ga[i], be[i]);
        if constexpr (EPI == EPI_PRELU) {
          o[i] = z >= 0.f ? z : rnd<T>(a * z);
        } else if constexpr (EPI == EPI_ADD) {
          o[i] = z + w[u][i];
        } else {
          o[i] = z;
        }
      }
      store8(y + (size_t)r * C + s.g * 8, o);
    }
    const int next = r0 + FWD_UNROLL * s.lanes;
#pragma unroll
    for (int u = 0; u < FWD_UNROLL; ++u) {
      const int r = next + u * s.lanes;
      if (r < s.end) {
        load8(x + (size_t)r * C + s.g * 8, v[u]);
        if constexpr (EPI == EPI_ADD) load8(skip + (size_t)r * C + s.g * 8, w[u]);
      }
    }
  }
}

// dz of 8 elements and the slope's terms, from x, dy and the statistics.
template <typename T, bool PRELU>
__device__ __forceinline__ void grad_of(const float (&xv)[8],
                                        const float (&dyv)[8],
                                        const float (&mu)[8],
                                        const float (&is)[8],
                                        const float (&ga)[8],
                                        const float (&be)[8], float a,
                                        float (&xhat)[8], float (&dz)[8],
                                        float& slope_sum) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    xhat[i] = (xv[i] - mu[i]) * is[i];
    dz[i] = dyv[i];
    if constexpr (PRELU) {
      const float z = bn_out<T>(xhat[i], ga[i], be[i]);
      if (!(z >= 0.f)) {
        dz[i] = rnd<T>(dyv[i] * a);
        slope_sum += rnd<T>(dyv[i] * z);
      }
    }
  }
}

// Backward pass 1: each CTA's sum dz, sum dz * xhat per channel and its
// slope sum into part[b][0:C], part[b][C:2C], part[b][2C].
template <typename T, bool PRELU>
__global__ void __launch_bounds__(NT)
    bn_bwd_reduce(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ stats,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta,
                  const float* __restrict__ slope, float* __restrict__ part,
                  int R, int C, int rpb) {
  __shared__ float sh_a[NT * 8];
  __shared__ float sh_b[NT * 8];
  const Rows s = rows_of(R, C, rpb);
  float mu[8], is[8], ga[8], be[8], sdz[8], sdzx[8], ssl = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ch = s.g * 8 + i;
    mu[i] = stats[ch];
    is[i] = stats[C + ch];
    ga[i] = gamma[ch];
    be[i] = beta[ch];
    sdz[i] = sdzx[i] = 0.f;
  }
  const float a = PRELU ? rnd<T>(slope[0]) : 0.f;
  for (int r0 = s.start + s.lane; r0 < s.end; r0 += BWD_UNROLL * s.lanes) {
    float xv[BWD_UNROLL][8], dyv[BWD_UNROLL][8];
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const int r = r0 + u * s.lanes;
      if (r < s.end) {
        load8(x + (size_t)r * C + s.g * 8, xv[u]);
        load8(dy + (size_t)r * C + s.g * 8, dyv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      if (r0 + u * s.lanes >= s.end) break;
      float xhat[8], dz[8];
      grad_of<T, PRELU>(xv[u], dyv[u], mu, is, ga, be, a, xhat, dz, ssl);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sdz[i] += dz[i];
        sdzx[i] = fmaf(dz[i], xhat[i], sdzx[i]);
      }
    }
  }
  if (s.lane < s.lanes) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sh_a[s.lane * C + s.g * 8 + i] = sdz[i];
      sh_b[s.lane * C + s.g * 8 + i] = sdzx[i];
    }
  }
  __syncthreads();
  const int K = NT / C, c = threadIdx.x % C, k = threadIdx.x / C;
  float ta = 0.f, tb = 0.f;
  if (k < K)
    for (int l = k; l < s.lanes; l += K) {
      ta += sh_a[l * C + c];
      tb += sh_b[l * C + c];
    }
  __syncthreads();
  if (k < K) {
    sh_a[k * C + c] = ta;
    sh_b[k * C + c] = tb;
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * (2 * C + 1);
  if (threadIdx.x < C) {
    float sa = 0.f, sb = 0.f;
    for (int j = 0; j < K; ++j) {
      sa += sh_a[j * C + c];
      sb += sh_b[j * C + c];
    }
    out[c] = sa;
    out[C + c] = sb;
  }
  if (PRELU) {
    __syncthreads();
    const float total = block_sum(ssl, sh_a);
    if (threadIdx.x == 0) out[2 * C] = total;
  }
}

// Backward pass 2: the P partials merged, CTA 0's dgamma, dbeta, dslope,
// then dx over the CTA's rows.
template <typename T, bool PRELU>
__global__ void __launch_bounds__(NT)
    bn_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy,
              T* __restrict__ dx, const float* __restrict__ stats,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              const float* __restrict__ slope,
              const float* __restrict__ part, int P, float* dgamma,
              float* dbeta, float* dslope, int R, int C, int rpb,
              int train) {
  __shared__ float sh_a[NT];
  __shared__ float sh_b[NT];
  __shared__ float sh_mdz[MAX_C];
  __shared__ float sh_mdzx[MAX_C];
  const Rows s = rows_of(R, C, rpb);
  const int K = NT / C, c = threadIdx.x % C, k = threadIdx.x / C;
  const size_t stride = 2 * C + 1;
  float xv[BWD_UNROLL][8], dyv[BWD_UNROLL][8];
  int r0 = s.start + s.lane;
#pragma unroll
  for (int u = 0; u < BWD_UNROLL; ++u) {
    const int r = r0 + u * s.lanes;
    if (r < s.end) {
      load8(x + (size_t)r * C + s.g * 8, xv[u]);
      load8(dy + (size_t)r * C + s.g * 8, dyv[u]);
    }
  }
  float ta = 0.f, tb = 0.f;
  if (k < K)
#pragma unroll 8
    for (int b = k; b < P; b += K) {
      ta += part[b * stride + c];
      tb += part[b * stride + C + c];
    }
  sh_a[threadIdx.x] = ta;
  sh_b[threadIdx.x] = tb;
  __syncthreads();
  if (threadIdx.x < C) {
    float sa = 0.f, sb = 0.f;
    for (int j = 0; j < K; ++j) {
      sa += sh_a[j * C + c];
      sb += sh_b[j * C + c];
    }
    sh_mdz[c] = train ? sa / (float)R : 0.f;
    sh_mdzx[c] = train ? sb / (float)R : 0.f;
    if (blockIdx.x == 0) {
      dbeta[c] = sa;
      dgamma[c] = sb;
    }
  }
  if (PRELU && blockIdx.x == 0) {
    float t = 0.f;
#pragma unroll 4
    for (int b = threadIdx.x; b < P; b += NT) t += part[b * stride + 2 * C];
    __syncthreads();
    const float total = block_sum(t, sh_a);
    if (threadIdx.x == 0) dslope[0] = rnd<T>(total);
  }
  __syncthreads();
  float mu[8], is[8], ga[8], be[8], k1[8], mdz[8], mdzx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ch = s.g * 8 + i;
    mu[i] = stats[ch];
    is[i] = stats[C + ch];
    ga[i] = gamma[ch];
    be[i] = beta[ch];
    k1[i] = is[i] * ga[i];
    mdz[i] = sh_mdz[ch];
    mdzx[i] = sh_mdzx[ch];
  }
  const float a = PRELU ? rnd<T>(slope[0]) : 0.f;
  float unused = 0.f;
  for (; r0 < s.end; r0 += BWD_UNROLL * s.lanes) {
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const int r = r0 + u * s.lanes;
      if (r >= s.end) break;
      float xhat[8], dz[8], o[8];
      grad_of<T, PRELU>(xv[u], dyv[u], mu, is, ga, be, a, xhat, dz, unused);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o[i] = k1[i] * (dz[i] - mdz[i] - xhat[i] * mdzx[i]);
      store8(dx + (size_t)r * C + s.g * 8, o);
    }
    const int next = r0 + BWD_UNROLL * s.lanes;
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const int r = next + u * s.lanes;
      if (r < s.end) {
        load8(x + (size_t)r * C + s.g * 8, xv[u]);
        load8(dy + (size_t)r * C + s.g * 8, dyv[u]);
      }
    }
  }
}

cudaError_t on_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

template <typename T, int EPI>
cudaError_t fwd(int train, const void* x, const void* skip, void* y,
                const void* gamma, const void* beta, const void* slope,
                void* running_mean, void* running_var, void* num_batches,
                void* part, void* stats, int R, int C, int ctas, int rpb,
                float eps, float momentum, cudaStream_t stream) {
  if (train) {
    bn_stats<T><<<ctas, NT, 0, stream>>>(static_cast<const T*>(x),
                                         static_cast<float*>(part), R, C, rpb);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  bn_apply<T, EPI><<<ctas, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(skip),
      static_cast<T*>(y), static_cast<const float*>(part), ctas,
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(slope), static_cast<float*>(running_mean),
      static_cast<float*>(running_var), static_cast<long long*>(num_batches),
      static_cast<float*>(stats), R, C, rpb, eps, momentum, train);
  return cudaGetLastError();
}

template <typename T, bool PRELU>
cudaError_t bwd(int train, const void* x, const void* dy, void* dx,
                const void* gamma, const void* beta, const void* slope,
                const void* stats, void* part, void* dgamma, void* dbeta,
                void* dslope, int R, int C, int ctas, int rpb,
                cudaStream_t stream) {
  bn_bwd_reduce<T, PRELU><<<ctas, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(stats), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(slope),
      static_cast<float*>(part), R, C, rpb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_bwd_dx<T, PRELU><<<ctas, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<const float*>(stats), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(slope),
      static_cast<const float*>(part), ctas, static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<float*>(dslope), R, C, rpb,
      train);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The forward on `stream` of `device`: T = bf16 when `bf16`, else f32;
// `epi` 0 none, 1 PReLU (slope: one f32), 2 skip add; `train` 1 for batch
// statistics (two launches), 0 for the running ones (one).  part: ctas * 2
// * C f32 of scratch; stats: 2 * C f32 out (mean, invstd).  The grid is
// `ctas` CTAs of `rpb` rows (the wrapper's bn_act_grid).  Returns the
// cudaError_t of the launches (0 on success).
int bn_act_fwd_launch(int bf16, int epi, int train, const void* x,
                      const void* skip, void* y, const void* gamma,
                      const void* beta, const void* slope, void* running_mean,
                      void* running_var, void* num_batches, void* part,
                      void* stats, int R, int C, int ctas, int rpb, float eps,
                      float momentum, int device, void* stream) {
  cudaError_t err = on_device(device);
  if (err != cudaSuccess) return (int)err;
  if (C % 8 || C > MAX_C || C < 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BN_FWD(T, E)                                                          \
  fwd<T, E>(train, x, skip, y, gamma, beta, slope, running_mean, running_var, \
            num_batches, part, stats, R, C, ctas, rpb, eps, momentum, st)
  if (bf16) {
    err = epi == EPI_PRELU ? BN_FWD(__nv_bfloat16, EPI_PRELU)
          : epi == EPI_ADD ? BN_FWD(__nv_bfloat16, EPI_ADD)
                           : BN_FWD(__nv_bfloat16, EPI_NONE);
  } else {
    err = epi == EPI_PRELU ? BN_FWD(float, EPI_PRELU)
          : epi == EPI_ADD ? BN_FWD(float, EPI_ADD)
                           : BN_FWD(float, EPI_NONE);
  }
#undef BN_FWD
  return (int)err;
}

// The backward: dx (T), dgamma and dbeta (C f32), dslope (one f32, PReLU
// only) from x and dy (T) and the forward's stats; part: ctas * (2 * C +
// 1) f32 of scratch.  `epi` as the forward's (the skip add's and no
// epilogue's backward are the same: dz = dy).
int bn_act_bwd_launch(int bf16, int epi, int train, const void* x,
                      const void* dy, void* dx, const void* gamma,
                      const void* beta, const void* slope, const void* stats,
                      void* part, void* dgamma, void* dbeta, void* dslope,
                      int R, int C, int ctas, int rpb, int device,
                      void* stream) {
  cudaError_t err = on_device(device);
  if (err != cudaSuccess) return (int)err;
  if (C % 8 || C > MAX_C || C < 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BN_BWD(T, P)                                                        \
  bwd<T, P>(train, x, dy, dx, gamma, beta, slope, stats, part, dgamma,      \
            dbeta, dslope, R, C, ctas, rpb, st)
  if (bf16) {
    err = epi == EPI_PRELU ? BN_BWD(__nv_bfloat16, true)
                           : BN_BWD(__nv_bfloat16, false);
  } else {
    err = epi == EPI_PRELU ? BN_BWD(float, true) : BN_BWD(float, false);
  }
#undef BN_BWD
  return (int)err;
}

const char* bn_act_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
