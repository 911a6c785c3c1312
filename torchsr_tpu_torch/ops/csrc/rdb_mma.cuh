// Helpers shared by the RDB kernels (rdb_fwd.cu, rdb_bwd.cu, rdb_ext.cu,
// rdb_ilv.cu): shared-memory addresses, ldmatrix, storage-type
// conversions, LeakyReLU(0.2), the backward's fixed-order reduce of its
// f32 partials, and, for the Hopper kernels (rdb_fwd_sm90.cuh,
// rdb_fwd_tf32_sm90.cuh, rdb_bwd_sm90.cuh, rdb_ilv.cu), the feature
// buffer's layout and the caller's five kernels as pointers and strides;
// for the two forwards (bf16 and 3xTF32) their runs and the row exchange
// of their epilogues.
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

// ------------------------------------------------- the forwards' runs

// Run t of a forward, image by image: output pixels p0 .. p0 + n - 1 of
// image b (y * W + x); its y row m (0 .. n + 2 e - 1) is pixel p0 - e +
// m.  Its halo box starts at image pixel (r0 - 1, hx0), hw = box_w pixels
// a row; y row m's A row for tap ky is box pixel m + ky hw.
struct Run {
  int b, p0, n, e, r0, hx0, hw;
};

// The runs of a forward with M y rows a run (rdb_fwd_sm90.cuh: WIDE_M =
// M = 128; rdb_fwd_tf32_sm90.cuh: M = 128, WIDE_M = 96; ops/rdb.py
// fwd_runs mirrors both).  Where W <= NARROW_W, a run is rows_per_run(W)
// whole image rows (the last of an image may hold fewer): every
// horizontal tap that crosses a row end is masked, so its y rows are its
// own pixels.  Else a run is up to WIDE_M - 2 pixels inside one row (a
// row's runs of equal length), its y rows its pixels and one beyond each
// end.  A run's halo is one TMA box of the rows above and below: box_w x
// box_h pixels.  Convs 1-4 take one persistent CTA per run up to CTAS,
// each of conv 5's two halves (its grid's y) half as many.
template <int M, int WIDE_M, int NARROW_W, int CTAS>
struct FwdRuns {
  static __host__ __device__ int rows_per_run(int W) { return M / W; }
  static __host__ __device__ int runs_per_row(int W) {
    return (W + WIDE_M - 3) / (WIDE_M - 2);
  }
  static __host__ __device__ int run_len(int W) {
    return (W + runs_per_row(W) - 1) / runs_per_row(W);
  }
  static __host__ __device__ int runs_per_image(int H, int W) {
    return W <= NARROW_W ? (H + rows_per_run(W) - 1) / rows_per_run(W)
                         : H * runs_per_row(W);
  }
  static __host__ __device__ int box_w(int W) {
    return W <= NARROW_W ? W : run_len(W) + 2;
  }
  static __host__ __device__ int box_h(int W) {
    return W <= NARROW_W ? rows_per_run(W) + 2 : 3;
  }
  static int slot_ctas(int s, int B, int H, int W) {
    const int runs = B * runs_per_image(H, W), cap = s < 4 ? CTAS : CTAS / 2;
    return runs < 1 ? 1 : runs < cap ? runs : cap;
  }
  static __device__ __forceinline__ Run run_of(int t, int H, int W) {
    const int per = runs_per_image(H, W);
    Run r;
    r.b = t / per;
    const int q = t % per;
    r.hw = box_w(W);
    if (W <= NARROW_W) {
      const int rows = rows_per_run(W);
      r.r0 = q * rows;
      r.p0 = r.r0 * W;
      r.n = min(rows, H - r.r0) * W;
      r.e = 0;
      r.hx0 = 0;
    } else {
      const int nx = runs_per_row(W), len = run_len(W);
      const int x0 = (q % nx) * len;
      r.r0 = q / nx;
      r.p0 = r.r0 * W + x0;
      r.n = min(len, W - x0);
      r.e = 1;
      r.hx0 = x0 - 1;
    }
    return r;
  }
};

// The forwards' epilogue exchange.  A warpgroup's accumulators `a` of
// 16-row tile T (lane: gq = lane / 4, tq = lane % 4) hold y rows 16 T +
// gq + 8 h, columns 8 j + 2 tq (+ 1) of y0 (a[4 j + 2 h]), y1 (j + 4) and
// y2 (j + 8).  The output at y row m takes y0 of row m - 1 and y2 of row
// m + 1: from the lanes four below and above, across the tile's two 8-row
// halves, and from the neighbour tiles' boundary rows through shared
// memory: bnd0[T], tile T's last y0 row; bnd1[T], its first y2 row.
__device__ __forceinline__ void fwd_store_bounds(const float (&a)[48],
                                                 float (*bnd0)[32],
                                                 float (*bnd1)[32], int T,
                                                 int gq, int tq) {
  if (gq == 7) {
#pragma unroll
    for (int k2 = 0; k2 < 8; ++k2)
      bnd0[T][8 * (k2 / 2) + 2 * tq + k2 % 2] = a[4 * (k2 / 2) + k2 % 2 + 2];
  }
  if (gq == 0) {
#pragma unroll
    for (int k2 = 0; k2 < 8; ++k2)
      bnd1[T][8 * (k2 / 2) + 2 * tq + k2 % 2] = a[4 * (k2 / 2 + 8) + k2 % 2];
  }
}

// The lane's 8 sums at y row 16 T + gq + 8 h (columns 8 (k2 / 2) + 2 tq +
// k2 % 2): y1, plus y0 of the row above where the pixel (column x of a
// W-wide image) has a left neighbour and y2 of the row below where it has
// a right one, plus the bias `bv`.  Every lane of the warp calls it.
__device__ __forceinline__ void fwd_combine(const float (&a)[48],
                                            const float (*bnd0)[32],
                                            const float (*bnd1)[32], int T,
                                            int h, int gq, int tq, int lane,
                                            int x, int W,
                                            const float (&bv)[8],
                                            float (&v)[8]) {
  const unsigned all = 0xffffffffu;
#pragma unroll
  for (int k2 = 0; k2 < 8; ++k2) {
    const int a0 = 4 * (k2 / 2) + k2 % 2, a2 = a0 + 32;
    const int col = 8 * (k2 / 2) + 2 * tq + k2 % 2;
    const float up0 = __shfl_up_sync(all, a[a0 + 2 * h], 4);
    const float wrap0 = __shfl_sync(all, a[a0], (lane + 28) & 31);
    const float dn2 = __shfl_down_sync(all, a[a2 + 2 * h], 4);
    const float wrap2 = __shfl_sync(all, a[a2 + 2], (lane + 4) & 31);
    float left, right;
    if (h == 0) {
      left = gq > 0 ? up0 : T > 0 ? bnd0[T - 1][col] : 0.f;
      right = gq < 7 ? dn2 : wrap2;
    } else {
      left = gq > 0 ? up0 : wrap0;
      right = gq < 7 ? dn2 : T < 7 ? bnd1[T + 1][col] : 0.f;
    }
    float v1 = a[a0 + 16 + 2 * h];
    if (x > 0) v1 = left + v1;
    if (x < W - 1) v1 += right;
    v[k2] = v1 + bv[k2];
  }
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
