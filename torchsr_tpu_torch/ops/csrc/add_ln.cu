// HAT's residual adds and LayerNorm in one pass over rows of C channels,
// bf16 in and out, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no HAT.  It was added because
// HAT's trunk ran each of its 86 LayerNorms a tile batch as the composition
// in models/hat.py (a bf16 -> f32 copy of the (8, 256, 256, 180) map,
// PyTorch's LayerNorm on the f32 copy, an f32 -> bf16 copy), with the
// residual adds before it as passes of their own over the same map.
// ops/add_ln.py holds that composition as the plain version and the wrapper.
//
// What it computes, for each row of R rows of C channels (NHWC flattened),
// with K = 0, 1 or 2 terms t_k and their f32 scales:
//
//   s = x;  for k < K:  s = bf16(s + bf16(t_k * scale_k))
//   stream = s                                      (written when K > 0)
//   mean = sum(s) / C,  var = sum((s - mean)^2) / C  (f32, from the bf16 s)
//   normed = bf16((s - mean) * rsqrt(var + eps) * weight + bias)
//
// The adds round where the composition rounds (x + proj(a), then
// conv * conv_scale, then their sum; a scale of 1 multiplies exactly), so
// the stream is the composition's bit for bit.  weight and bias are f32.
// Nothing of f32 goes to device memory.
//
// Bound on this card (H100 SXM): bytes.  At (8, 256, 256, 180) one map is
// 189 MB: two terms read three maps and write two (0.282 ms at 3.35 TB/s),
// one term reads two and writes two (0.225 ms), none reads one and writes
// one (0.113 ms).  The arithmetic is a few FLOP a byte.
//
// Design.  A row is only 360 bytes, so each CTA owns a run of `rows`
// consecutive rows (even, so that the run starts 16-byte aligned; 64 rows at
// C = 180, ~23 KB a map) and copies the run of each input into shared memory
// with 16-byte cp.async copies, all in flight at once (69 KB with two terms;
// three CTAs an SM keep ~200 KB of loads in flight).  Each warp then takes
// its rows from shared memory, 4 channels (8 bytes) a lane: it forms the
// stream in registers, writes it back over x's copy, reduces the row's sum
// and then its squared deviations with warp shuffles, and writes the
// normalised row over the first term's copy (over x's when K = 0).  Last,
// the CTA copies the stream and the normalised run out with 16-byte stores.
// The grid is one CTA a run; no atomics, no host read, nothing allocated,
// so the launches can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_BYTES = 23040;  // bytes of one map's run a CTA, about
constexpr int MAX_C = 512;         // 4 chunks of 4 channels a lane

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* t0;
  const __nv_bfloat16* t1;
  __nv_bfloat16* stream;
  __nv_bfloat16* normed;
  const float* weight;
  const float* bias;
  float scale0, scale1, eps;
  int R, C, rows;  // rows: a CTA's run
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load4(const unsigned char* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(unsigned char* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// `bytes` (a multiple of 8) from global `src` into shared `dst`: 16-byte
// copies in flight, the last 8 bytes (when `bytes` is not a multiple of 16)
// by thread 0.  Both start 16-byte aligned.
__device__ __forceinline__ void copy_in(unsigned char* dst,
                                        const unsigned char* src,
                                        size_t bytes) {
  const size_t n16 = bytes >> 4;
  for (size_t i = threadIdx.x; i < n16; i += THREADS)
    cp_async16(dst + 16 * i, src + 16 * i);
  if ((bytes & 8) && threadIdx.x == 0)
    *reinterpret_cast<uint2*>(dst + bytes - 8) =
        *reinterpret_cast<const uint2*>(src + bytes - 8);
}

__device__ __forceinline__ void copy_out(unsigned char* dst,
                                         const unsigned char* src,
                                         size_t bytes) {
  const size_t n16 = bytes >> 4;
  for (size_t i = threadIdx.x; i < n16; i += THREADS)
    *reinterpret_cast<uint4*>(dst + 16 * i) =
        *reinterpret_cast<const uint4*>(src + 16 * i);
  if ((bytes & 8) && threadIdx.x == 0)
    *reinterpret_cast<uint2*>(dst + bytes - 8) =
        *reinterpret_cast<const uint2*>(src + bytes - 8);
}

// K terms; NCH chunks of 4 channels a lane (C <= 128 * NCH).
template <int K, int NCH>
__global__ void __launch_bounds__(THREADS) add_ln(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.C;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * p.rows;
  const int n = min(p.rows, static_cast<int>(p.R - row0));
  const size_t slot = static_cast<size_t>(p.rows) * C * 2;  // a map's run
  const size_t bytes = static_cast<size_t>(n) * C * 2;
  const size_t base = row0 * C * 2;
  unsigned char* sx = smem;
  unsigned char* s0 = smem + slot;
  unsigned char* s1 = smem + 2 * slot;

  copy_in(sx, reinterpret_cast<const unsigned char*>(p.x) + base, bytes);
  if (K > 0)
    copy_in(s0, reinterpret_cast<const unsigned char*>(p.t0) + base, bytes);
  if (K > 1)
    copy_in(s1, reinterpret_cast<const unsigned char*>(p.t1) + base, bytes);

  // the lane's channels while the copies fly: 4 * (lane + 32 j) + 0..3
  const int lane = threadIdx.x & 31;
  const int chunks = C >> 2;
  float w[NCH][4], b[NCH][4];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int ch = lane + 32 * j;
    const float4 wv = ch < chunks
        ? reinterpret_cast<const float4*>(p.weight)[ch]
        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 bv = ch < chunks
        ? reinterpret_cast<const float4*>(p.bias)[ch]
        : make_float4(0.f, 0.f, 0.f, 0.f);
    w[j][0] = wv.x, w[j][1] = wv.y, w[j][2] = wv.z, w[j][3] = wv.w;
    b[j][0] = bv.x, b[j][1] = bv.y, b[j][2] = bv.z, b[j][3] = bv.w;
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
  __syncthreads();

  unsigned char* sout = K > 0 ? s0 : sx;
  const float inv_c = 1.0f / static_cast<float>(C);
  for (int r = threadIdx.x >> 5; r < n; r += WARPS) {
    float v[NCH][4];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int ch = lane + 32 * j;
      const size_t off = (static_cast<size_t>(r) * C + 4 * ch) * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = 0.f;
      if (ch < chunks) {
        load4(sx + off, v[j]);
        if (K > 0) {
          float t[4];
          load4(s0 + off, t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[j][e] = round_bf16(v[j][e] + round_bf16(t[e] * p.scale0));
        }
        if (K > 1) {
          float t[4];
          load4(s1 + off, t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[j][e] = round_bf16(v[j][e] + round_bf16(t[e] * p.scale1));
        }
        if (K > 0) store4(sx + off, v[j]);
        sum += (v[j][0] + v[j][1]) + (v[j][2] + v[j][3]);
      }
    }
    const float mean = warp_sum(sum) * inv_c;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (lane + 32 * j < chunks) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = v[j][e] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_c + p.eps);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int ch = lane + 32 * j;
      if (ch < chunks) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = (v[j][e] - mean) * rstd * w[j][e] + b[j][e];
        store4(sout + (static_cast<size_t>(r) * C + 4 * ch) * 2, o);
      }
    }
  }
  __syncthreads();

  if (K > 0)
    copy_out(reinterpret_cast<unsigned char*>(p.stream) + base, sx, bytes);
  copy_out(reinterpret_cast<unsigned char*>(p.normed) + base, sout, bytes);
}

cudaError_t on_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

template <int K, int NCH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  void (*kernel)(Params) = add_ln<K, NCH>;
  const int smem = (K + 1) * p.rows * p.C * 2;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int ctas = (p.R + p.rows - 1) / p.rows;
  kernel<<<ctas, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_terms(const Params& p, cudaStream_t stream) {
  switch ((p.C / 4 + 31) / 32) {
    case 1: return launch<K, 1>(p, stream);
    case 2: return launch<K, 2>(p, stream);
    case 3: return launch<K, 3>(p, stream);
    default: return launch<K, 4>(p, stream);
  }
}

}  // namespace

extern "C" {

// One call on `stream` of `device`: x, t0, t1 (R, C) bf16 (t0 and t1 read
// when `terms` > 0, > 1), stream and normed (R, C) bf16 out (stream written
// when `terms` > 0), weight and bias (C,) f32; every pointer 16-byte
// aligned, C a multiple of 4 in [4, 512], terms 0, 1 or 2.  Returns the
// cudaError_t of the launch (0 on success).
int add_ln_launch(const void* x, const void* t0, const void* t1,
                  void* stream_out, void* normed, const void* weight,
                  const void* bias, int terms, float scale0, float scale1,
                  float eps, int R, int C, int device, void* stream) {
  cudaError_t err = on_device(device);
  if (err != cudaSuccess) return (int)err;
  if (R < 1 || C < 4 || C > MAX_C || C % 4 || terms < 0 || terms > 2)
    return (int)cudaErrorInvalidValue;
  // an even run of ~TILE_BYTES a map (C * 2 bytes a row)
  const int even = (TILE_BYTES / (2 * C)) & ~1;
  const int rows = even < 2 ? 2 : even;
  Params p{static_cast<const __nv_bfloat16*>(x),
           static_cast<const __nv_bfloat16*>(t0),
           static_cast<const __nv_bfloat16*>(t1),
           static_cast<__nv_bfloat16*>(stream_out),
           static_cast<__nv_bfloat16*>(normed),
           static_cast<const float*>(weight),
           static_cast<const float*>(bias),
           scale0, scale1, eps, R, C, rows};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(terms == 0   ? launch_terms<0>(p, st)
               : terms == 1 ? launch_terms<1>(p, st)
                            : launch_terms<2>(p, st));
}

const char* add_ln_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
