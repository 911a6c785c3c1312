// Residual dense block (RDB) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel torchsr_tpu/ops/pallas/rdb.py:142
// (_rdb_fwd_kernel, launched by _rdb_fwd :440 through fused_rdb :875).
// One RDB is five dense 3x3 SAME convolutions on NHWC activations:
// conv i reads the first C_in = 64 + 32 i channels of a feature buffer
// and appends its C_out = 32 outputs (after bias and LeakyReLU(0.2));
// conv 5 (C_in 192, C_out 64) gives out = x + scale * (conv5 + b5).
//
// The TPU kernel keeps whole images and the dense-concat buffer in VMEM
// (many MB); an SM has at most 227 KB of shared memory, so here the
// concat lives in device memory instead: one (B*H*W, 192) NHWC buffer
// holding x in channels [0, 64); conv i reads channels [0, C_in) and
// writes [C_in, C_in + 32) of the same buffer (disjoint ranges, so the
// concat costs nothing); conv 5 writes the block output.  Both storage
// types accumulate in f32, as the TPU kernel does, and store in the
// storage type.
//
//  * bf16 (serving and training under AMP): one C entry of six launches
//    from csrc/rdb_fwd_sm90.cuh (a prep that packs the caller's kernels,
//    then five convs with the TPU kernel's kx-packed N = 96 product on
//    wgmma, the first of which reads x and copies it into the buffer;
//    design and bound there).
//  * f32 (--disable-amp, eval, render): one direct-conv kernel on the
//    CUDA cores (tensor cores would round to TF32), templated on
//    C_in/C_out and launched five times; the wrapper (ops/rdb.py) copies
//    x into the buffer.  An 8 x 16 tile; each thread owns 4 neighbouring
//    pixels of a row x 8 output channels, so 6 staged inputs serve 3
//    horizontal taps.  Bound on this card (H100 SXM) at the serving
//    shape: 31.4 GFLOP, 0.469 ms at the 67 TFLOP/s f32 FMA peak.

#include "rdb_fwd_sm90.cuh"
#include "rdb_mma.cuh"

namespace {

constexpr int FEAT = 192;  // feature buffer width

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
cudaError_t launch(const void* feat, const void* w, const void* bias,
                   void* dst, int B, int H, int W, float scale,
                   cudaStream_t stream) {
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
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 block forward: x (B, H, W, 64) into feat (B, H, W, 192) and
// its four grown slices, the block output into out (B, H, W, 64).  wptr
// and wstride: the five HWIO kernels' pointers and (ky, kx, ci, co)
// element strides, f32 (w_f32 = 1) or bf16; bptr: the five f32 biases;
// wpack: scratch for the packed weights (rdb_fwd_sm90::WPACK bf16).
// Returns the cudaError_t of the first failed launch (0 on success), as
// every entry point below.
int rdb_fwd_bf16_launch(const void* x, void* feat, void* out,
                        const void* wptr, const void* wstride, int w_f32,
                        const void* bptr, void* wpack, int B, int H, int W,
                        float scale, int device, void* stream) {
  return rdb_fwd_sm90::launch_fwd_entry(
      x, feat, out, static_cast<const void* const*>(wptr),
      static_cast<const long long*>(wstride), w_f32,
      static_cast<const void* const*>(bptr), wpack, B, H, W, 0, scale,
      device, stream);
}

// The bf16 forward's schedule at (B, H, W) into out (18 ints), as
// rdb_fwd_sm90::fwd_schedule_of lays it out; host only, always 0.
int rdb_fwd_bf16_schedule(int B, int H, int W, int* out) {
  rdb_fwd_sm90::fwd_schedule_of(B, H, W, out);
  return 0;
}

// One f32 conv of the block on `stream` of `device`.  stage 0..3
// appends 32 channels to `feat` (dst must equal feat); stage 4 writes
// the block output to dst.
int rdb_fwd_f32_launch(int stage, const void* feat, const void* w,
                       const void* bias, void* dst, int B, int H, int W,
                       float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return (int)launch<64, 32, false>(feat, w, bias, dst, B, H, W, scale, s);
    case 1: return (int)launch<96, 32, false>(feat, w, bias, dst, B, H, W, scale, s);
    case 2: return (int)launch<128, 32, false>(feat, w, bias, dst, B, H, W, scale, s);
    case 3: return (int)launch<160, 32, false>(feat, w, bias, dst, B, H, W, scale, s);
    case 4: return (int)launch<192, 64, true>(feat, w, bias, dst, B, H, W, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* rdb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
