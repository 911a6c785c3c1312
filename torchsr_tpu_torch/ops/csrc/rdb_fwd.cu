// Residual dense block (RDB) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel torchsr_tpu/ops/pallas/rdb.py:142
// (_rdb_fwd_kernel, launched by _rdb_fwd :440 through fused_rdb :875).
// One RDB is five dense 3x3 SAME convolutions on NHWC activations:
// conv i reads the first C_in = 64 + 32 i channels of a feature buffer
// and appends its C_out = 32 outputs (after bias and LeakyReLU(0.2));
// conv 5 (C_in 192, C_out 64) gives out = x + scale * (conv5 + b5).
//
// Design.  The TPU kernel keeps whole images and the dense-concat
// buffer in VMEM (many MB); an SM has at most 227 KB of shared memory,
// so here the concat lives in device memory instead: the wrapper
// (ops/rdb.py) allocates one (B*H*W, 192) NHWC buffer holding x in
// channels [0, 64), and one direct-conv kernel, templated on
// C_in/C_out, is launched five times.  Launch i reads channels
// [0, C_in) and writes channels [C_in, C_in + 32) of the same buffer
// (disjoint ranges, so the concat costs nothing); launch 5 writes the
// block output.  Each CTA computes a spatial tile of one image for all
// C_out channels, staging its input tile with a 1-pixel halo (zeros
// outside the image) and the matching weight slice in shared memory,
// a slice of input channels at a time.  Both storage types accumulate
// in f32, as the TPU kernel does, and store in the storage type.
//
//  * bf16 (serving under AMP): an implicit GEMM on the tensor cores,
//    mma.sync m16n8k16 bf16 -> f32.  A CTA is 8 warps over an 8 x 32
//    pixel tile; each warp owns one row (two 16-pixel M tiles) and all
//    C_out.  For tap (dy, dx) the A tile of 16 output pixels is 16
//    consecutive halo pixels, read with ldmatrix straight from the
//    staged tile (pixel rows padded to 80 bytes: conflict-free).
//  * f32 (--disable-amp): FFMA on the CUDA cores (tensor cores would
//    round to TF32).  An 8 x 16 tile; each thread owns 4 neighbouring
//    pixels of a row x 8 output channels, so 6 staged inputs serve 3
//    horizontal taps.
//
// Bound on this card (H100 SXM).  At the serving shape, 16 tiles of
// 64 x 64 pixels, one RDB is 65,536 px x 479,232 FLOP = 31.4 GFLOP.
// The unavoidable bytes (x in, out) are 16.8 MB in bf16: 5 us at
// 3.35 TB/s, so the block is compute-bound: 31.7 us at the 989 TFLOP/s
// bf16 tensor-core peak, 469 us at the 67 TFLOP/s f32 FMA peak.  The
// five-launch buffer rereads each conv's C_in prefix (~117 MB in bf16,
// ~35 us from HBM), about the compute bound; staging is synchronous and
// mma.sync reaches a fraction of wgmma's rate.  The fast version
// (wgmma fed by TMA with the staging pipelined, or one fused launch per
// block with a 5-pixel recomputed halo) is later work.

#include "rdb_mma.cuh"

namespace {

constexpr int FEAT = 192;  // feature buffer width

// ---------------------------------------------------------------- bf16

namespace tensor_core {

constexpr int TH = 8;                  // output rows per CTA = warps
constexpr int TW = 32;                 // output columns per CTA
constexpr int HALO_W = TW + 2;
constexpr int HALO_PX = (TH + 2) * HALO_W;
constexpr int KC = 32;                 // input channels per stage
constexpr int LDS = KC + 8;            // 80-byte rows: ldmatrix conflict-free
constexpr int NT = TH * 32;

template <int COUT>
constexpr size_t smem_bytes() {
  return (size_t)(HALO_PX + 9 * COUT) * LDS * sizeof(__nv_bfloat16);
}

using rdb::ldmatrix_x4;
using rdb::mma_bf16;

// feat: (B, H, W, FEAT) bf16; w: HWIO (3, 3, CIN, COUT) bf16; bias:
// (COUT,) f32.  LAST = false: dst == feat, writes channels
// [CIN, CIN + COUT).  LAST = true: dst is (B, H, W, COUT).
template <int CIN, int COUT, bool LAST>
__global__ void __launch_bounds__(NT)
conv3x3_bf16(const __nv_bfloat16* __restrict__ feat,
             const __nv_bfloat16* __restrict__ w,
             const float* __restrict__ bias, __nv_bfloat16* __restrict__ dst,
             int H, int W, float scale) {
  static_assert(CIN % KC == 0 && COUT % 16 == 0, "channel tiling");
  constexpr int NTILES = COUT / 8;
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  __nv_bfloat16* in_s = smem_bf16;                 // [HALO_PX][LDS]
  __nv_bfloat16* w_s = smem_bf16 + HALO_PX * LDS;  // [9][COUT][LDS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t img = (size_t)blockIdx.z * H * W;

  float acc[2][NTILES][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < NTILES; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;

  for (int c0 = 0; c0 < CIN; c0 += KC) {
    __syncthreads();  // the previous stage is fully consumed
    // input tile + halo: 16-byte chunks of 8 channels
    for (int i = tid; i < HALO_PX * (KC / 8); i += NT) {
      const int px = i / (KC / 8), ch = i % (KC / 8);
      const int gy = y0 - 1 + px / HALO_W, gx = x0 - 1 + px % HALO_W;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = *reinterpret_cast<const uint4*>(
            feat + (img + (size_t)gy * W + gx) * FEAT + c0 + ch * 8);
      *reinterpret_cast<uint4*>(in_s + px * LDS + ch * 8) = v;
    }
    // weights HWIO -> [tap][co][ci]: 8 output channels per load, ci
    // fastest across threads so the transposed stores do not conflict
    for (int i = tid; i < 9 * (COUT / 8) * KC; i += NT) {
      const int ci = i % KC, r = i / KC;
      const int tap = r / (COUT / 8), co = (r % (COUT / 8)) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(
          w + ((size_t)tap * CIN + c0 + ci) * COUT + co);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w_s[(tap * COUT + co + k) * LDS + ci] = e[k];
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          ldmatrix_x4(a[j], in_s + ((warp + ky) * HALO_W + 16 * j + kx +
                                    (lane % 16)) * LDS +
                                ks * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NTILES / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, w_s + (tap * COUT + np * 16 + (lane % 8) +
                                8 * (lane / 16)) * LDS +
                             ks * 16 + 8 * ((lane / 8) % 2));
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_bf16(acc[j][2 * np], a[j], b[0], b[1]);
            mma_bf16(acc[j][2 * np + 1], a[j], b[2], b[3]);
          }
        }
      }
    }
  }

  // C fragment: rows g and g + 8 of each 16-pixel tile, channels 2t, 2t+1
  const int gy = y0 + warp;
  if (gy >= H) return;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    const int co = n * 8 + 2 * t;
    const float b0 = bias[co], b1 = bias[co + 1];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gx = x0 + 16 * j + g + 8 * h;
        if (gx >= W) continue;
        const size_t pix = img + (size_t)gy * W + gx;
        float v0 = acc[j][n][2 * h] + b0, v1 = acc[j][n][2 * h + 1] + b1;
        if constexpr (LAST) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
              feat + pix * FEAT + co);
          v0 = v0 * scale + __low2float(r);
          v1 = v1 * scale + __high2float(r);
          *reinterpret_cast<__nv_bfloat162*>(dst + pix * COUT + co) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          v0 = v0 >= 0.f ? v0 : v0 * 0.2f;
          v1 = v1 >= 0.f ? v1 : v1 * 0.2f;
          *reinterpret_cast<__nv_bfloat162*>(dst + pix * FEAT + CIN + co) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
  }
}

}  // namespace tensor_core

// ----------------------------------------------------------------- f32

namespace cuda_core {

constexpr int TH = 8;
constexpr int TW = 16;
constexpr int HALO_W = TW + 2;
constexpr int HALO_PX = (TH + 2) * HALO_W;
constexpr int IN_LD = HALO_PX + 1;     // odd: conflict-free staging
constexpr int KC = 16;                 // input channels per stage
constexpr int PX = 4;                  // pixels per thread (one row)
constexpr int CO = 8;                  // output channels per thread
constexpr int PGROUPS = TH * TW / PX;  // pixel groups per tile

template <int COUT>
__host__ __device__ constexpr int threads_for() {
  return PGROUPS * (COUT / CO);
}

template <int COUT>
constexpr size_t smem_bytes() {
  return (size_t)(KC * IN_LD + 9 * KC * COUT) * sizeof(float);
}

// As conv3x3_bf16, in f32: w is HWIO (3, 3, CIN, COUT) f32.
template <int CIN, int COUT, bool LAST>
__global__ void __launch_bounds__(threads_for<COUT>())
conv3x3_f32(const float* __restrict__ feat, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ dst,
            int H, int W, float scale) {
  static_assert(CIN % KC == 0 && COUT % CO == 0, "channel tiling");
  constexpr int NCOG = COUT / CO;
  constexpr int NT = threads_for<COUT>();
  extern __shared__ __align__(16) float smem_f32[];
  float* in_s = smem_f32;              // [KC][IN_LD]
  float* w_s = smem_f32 + KC * IN_LD;  // [9][KC][COUT]

  const int tid = threadIdx.x;
  const int cog = tid % NCOG;
  const int pg = tid / NCOG;
  const int ty = pg / (TW / PX);
  const int tx0 = (pg % (TW / PX)) * PX;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const size_t img = (size_t)blockIdx.z * H * W;

  float acc[PX][CO];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[p][c] = 0.f;

  for (int c0 = 0; c0 < CIN; c0 += KC) {
    __syncthreads();  // the previous stage is fully consumed
    for (int i = tid; i < HALO_PX * KC; i += NT) {
      const int px = i / KC, ci = i % KC;
      const int gy = y0 - 1 + px / HALO_W;
      const int gx = x0 - 1 + px % HALO_W;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = feat[(img + (size_t)gy * W + gx) * FEAT + c0 + ci];
      in_s[ci * IN_LD + px] = v;
    }
    for (int i = tid; i < 9 * KC * COUT; i += NT) {
      const int tap = i / (KC * COUT), r = i % (KC * COUT);
      w_s[i] = w[((size_t)tap * CIN + c0) * COUT + r];
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < KC; ++ci) {
      const float* in_c = in_s + ci * IN_LD;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float a[PX + 2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j)
          a[j] = in_c[(ty + ky) * HALO_W + tx0 + j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wp = reinterpret_cast<const float4*>(
              w_s + ((ky * 3 + kx) * KC + ci) * COUT + cog * CO);
          const float4 wa = wp[0], wb = wp[1];
          const float wv[CO] = {wa.x, wa.y, wa.z, wa.w,
                                wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int c = 0; c < CO; ++c)
              acc[p][c] = fmaf(a[p + kx], wv[c], acc[p][c]);
        }
      }
    }
  }

  const int gy = y0 + ty;
  if (gy >= H) return;
  float b[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) b[c] = bias[cog * CO + c];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int gx = x0 + tx0 + p;
    if (gx >= W) continue;
    const size_t pix = img + (size_t)gy * W + gx;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      const int co = cog * CO + c;
      const float v = acc[p][c] + b[c];
      if constexpr (LAST) {
        dst[pix * COUT + co] = v * scale + feat[pix * FEAT + co];
      } else {
        dst[pix * FEAT + CIN + co] = v >= 0.f ? v : v * 0.2f;
      }
    }
  }
}

}  // namespace cuda_core

template <int CIN, int COUT, bool LAST>
cudaError_t launch(bool bf16, const void* feat, const void* w,
                   const void* bias, void* dst, int B, int H, int W,
                   float scale, cudaStream_t stream) {
  if (bf16) {
    auto kernel = tensor_core::conv3x3_bf16<CIN, COUT, LAST>;
    constexpr size_t smem = tensor_core::smem_bytes<COUT>();
    cudaError_t err = rdb::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((W + tensor_core::TW - 1) / tensor_core::TW, (H + tensor_core::TH - 1) / tensor_core::TH, B);
    kernel<<<grid, tensor_core::NT, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(feat),
        static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(dst), H, W, scale);
  } else {
    auto kernel = cuda_core::conv3x3_f32<CIN, COUT, LAST>;
    constexpr size_t smem = cuda_core::smem_bytes<COUT>();
    cudaError_t err = rdb::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((W + cuda_core::TW - 1) / cuda_core::TW,
                    (H + cuda_core::TH - 1) / cuda_core::TH, B);
    kernel<<<grid, cuda_core::threads_for<COUT>(), smem, stream>>>(
        static_cast<const float*>(feat), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(dst), H, W,
        scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One conv of the block on `stream` of `device`.  stage 0..3 appends
// 32 channels to `feat` (dst must equal feat); stage 4 writes the block
// output to dst.  is_bf16 selects bf16 storage (else f32).  Returns the
// cudaError_t of the launch (0 on success).
int rdb_conv3x3_launch(int stage, int is_bf16, const void* feat,
                       const void* w, const void* bias, void* dst, int B,
                       int H, int W, float scale, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  switch (stage) {
    case 0: return (int)launch<64, 32, false>(bf16, feat, w, bias, dst, B, H, W, scale, s);
    case 1: return (int)launch<96, 32, false>(bf16, feat, w, bias, dst, B, H, W, scale, s);
    case 2: return (int)launch<128, 32, false>(bf16, feat, w, bias, dst, B, H, W, scale, s);
    case 3: return (int)launch<160, 32, false>(bf16, feat, w, bias, dst, B, H, W, scale, s);
    case 4: return (int)launch<192, 64, true>(bf16, feat, w, bias, dst, B, H, W, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* rdb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
