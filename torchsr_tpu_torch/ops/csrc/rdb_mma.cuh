// Helpers shared by the RDB kernels (rdb_fwd.cu, rdb_bwd.cu, rdb_ext.cu,
// rdb_ilv.cu): shared-memory addresses, ldmatrix, storage-type
// conversions, LeakyReLU(0.2), the backward's fixed-order reduce of its
// f32 partials, and, for the Hopper kernels (rdb_fwd_sm90.cuh,
// rdb_bwd_sm90.cuh, rdb_ilv.cu), the feature buffer's layout and the
// caller's five kernels as pointers and strides.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace rdb {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Two neighbouring elements (an even index) as one 4- or 8-byte access.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : v * 0.2f;
}

// Image b's row y is buffer row b * HP + Y0 + y: HP = H, Y0 = 0 for the
// (B, H, W, 192) feature buffer (B1, B2); HP = H + 2, Y0 = 1 for the
// row-extended one (B7, B8).  The forward's x and out and the backward's
// g and dx are unpadded (B, H, W, 64) in both.
struct Layout {
  int B, H, W, HP, Y0;
  __device__ __forceinline__ size_t pix(int b, int y, int x) const {
    return ((size_t)b * HP + Y0 + y) * W + x;
  }
  __device__ __forceinline__ size_t dense(int b, int y, int x) const {
    return ((size_t)b * H + y) * W + x;
  }
};

// The caller's five HWIO kernels: element (ky, kx, ci, co) of kernel i at
// p[i] + ky s[i][0] + kx s[i][1] + ci s[i][2] + co s[i][3].
template <typename TW>
struct Weights {
  const TW* p[5];
  long long s[5][4];
};

template <typename TW>
Weights<TW> weights_of(const void* const* wptr, const long long* wstride) {
  Weights<TW> w;
  for (int i = 0; i < 5; ++i) {
    w.p[i] = static_cast<const TW*>(wptr[i]);
    for (int k = 0; k < 4; ++k) w.s[i][k] = wstride[4 * i + k];
  }
  return w;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// dw[e] = sum_g dw_part[g][e] (e < n); db[c] = sum_b db_part[b][c]: the
// wgrad partials and the prep's db partials of one conv, summed in a
// fixed order (deterministic; no atomics).  A template, so that only the
// libraries that launch it compile it.
template <int NT>
__global__ void __launch_bounds__(NT)
reduce_partials(const float* __restrict__ dw_part, int groups, int n,
                const float* __restrict__ db_part, int nblocks, int cout,
                float* __restrict__ dw, float* __restrict__ db) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e < n) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += dw_part[(size_t)g * n + e];
    dw[e] = s;
  } else if (e < n + cout) {
    const int c = e - n;
    float s = 0.f;
    for (int b = 0; b < nblocks; ++b) s += db_part[(size_t)b * cout + c];
    db[c] = s;
  }
}

// The reduce above on `stream` of `device`; the cudaError_t as an int.
inline int launch_reduce(const void* dw_part, int groups, int n,
                         const void* db_part, int nblocks, int cout,
                         void* dw, void* db, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int NT = 256;
  const int blocks = (n + cout + NT - 1) / NT;
  reduce_partials<NT><<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dw_part), groups, n,
      static_cast<const float*>(db_part), nblocks, cout,
      static_cast<float*>(dw), static_cast<float*>(db));
  return (int)cudaGetLastError();
}

}  // namespace rdb
