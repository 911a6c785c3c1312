// Residual dense block (RDB) backward for Hopper (sm_90a).
//
// Replaces the TPU kernel torchsr_tpu/ops/pallas/rdb.py:495
// (_rdb_bwd_kernel, launched by _rdb_bwd :686 from the custom-VJP rule
// _fused_rdb_bwd :853).  Inputs: the output cotangent g (B, H, W, 64) and
// the forward's (B, H, W, 192) feature buffer (x, then the four
// post-activation 32-channel slices) that csrc/rdb_fwd.cu filled.  With
// the convs i = 0..4 (C_in = 64 + 32 i, C_out = 32, or 64 for conv 5):
//
//   da_4 = scale * g;  da_i = dF[:, C_in(i) : +32] * LReLU'(feat there)
//   dy_i = round(da_i) to the working dtype;  db_i = sum_p da_i
//   dW_i[ky][kx][ci][co] = sum_p feat[p + (ky-1, kx-1)][ci] * dy_i[p][co]
//   dF = sum_i conv3x3(dy_i, flip(W_i) with C_in <-> C_out), over C_in(i)
//   dx = dF[:, :64] + g
//
// Products take working-dtype operands (bf16 under AMP, else f32) and
// sum in f32; dW and db are f32; dx is stored in g's dtype: the
// precision contract of rdb.py:538-577.  Every dy_i lands in one
// (B, H, W, 192) buffer DY = [dy_0 | ... | dy_4], which the wrapper
// returns.
//
// bf16: csrc/rdb_bwd_sm90.cuh, eight launches (prep, four slot convs, dx,
// wgrad, reduce) on wgmma with cp.async rings and persistent CTAs; each
// slot's dense gradient is one conv over DY's later channels, so no f32
// dense gradient reaches device memory (the TPU kernel kept it in VMEM,
// rdb.py:536).  Design and bound in that header.
//
// f32 (--disable-amp): FFMA on the CUDA cores (tensor cores would round
// to TF32), per conv in reverse: prep (da_i -> dy_i into DY, per-block
// db partials), wgrad (per-CTA f32 partials of dW over 8 x 32 tiles),
// the fixed-order reduce (rdb_mma.cuh), and the dgrad as a direct conv
// of dy_i with the flipped, transposed kernel (from the wrapper) into an
// f32 dF: stored by conv 5, added by the others; conv 1 also writes dx.
// At the training shape (64, 32, 32, 64) the 62.8 GFLOP are 0.94 ms at
// the 67 TFLOP/s FMA peak (H100 SXM).

#include "rdb_bwd_sm90.cuh"
#include "rdb_mma.cuh"

namespace {

using rdb::allow_smem;

constexpr int FEAT = 192;  // feature buffer and DY width
constexpr int CH = 64;     // block input/output channels
constexpr int TH = 8;      // tile rows
constexpr int TW = 32;     // wgrad tile columns
constexpr int HALO_W = TW + 2;
constexpr int HALO_PX = (TH + 2) * HALO_W;
constexpr int NT = 256;     // threads of a prep / wgrad CTA
constexpr int CCHUNK = 32;  // input channels per wgrad CTA, dF channels per dgrad CTA

// The tile (b, y0, x0) of tile index `tl` in a batch of B images.
struct Tile {
  int b, y0, x0;
};
__device__ __forceinline__ Tile tile_of(int tl, int H, int W) {
  const int tw = (W + TW - 1) / TW, th = (H + TH - 1) / TH;
  Tile t;
  t.b = tl / (th * tw);
  const int r = tl % (th * tw);
  t.y0 = (r / tw) * TH;
  t.x0 = (r % tw) * TW;
  return t;
}

// ---------------------------------------------------------------- prep

// da -> dy_STAGE (DY channels 32 STAGE .. +C_out) and per-block partial
// sums of da.  STAGE 4 reads g (M, 64) and scales it; stages 0..3 read
// dF's slot [lo, lo + 32) and the sign of the same slot of feat.
template <int STAGE>
__global__ void __launch_bounds__(NT)
prep(const float* __restrict__ src, const float* __restrict__ feat,
     float* __restrict__ dy, float* __restrict__ db_part, int M, int ppb,
     float scale) {
  constexpr int COUT = STAGE == 4 ? CH : 32;
  constexpr int ROWS = NT / COUT;
  constexpr int LO = CH + 32 * STAGE;  // conv STAGE's output slot
  __shared__ float red[NT];
  const int c = threadIdx.x % COUT, r = threadIdx.x / COUT;
  const int p0 = blockIdx.x * ppb;
  const int p1 = min(p0 + ppb, M);
  float sum = 0.f;
  for (int p = p0 + r; p < p1; p += ROWS) {
    float da;
    if constexpr (STAGE == 4) {
      da = src[(size_t)p * CH + c] * scale;
    } else {
      const float act = feat[(size_t)p * FEAT + LO + c];
      da = src[(size_t)p * FEAT + LO + c] *
           (0.2f + 0.8f * (act > 0.f ? 1.f : 0.f));
    }
    dy[(size_t)p * FEAT + 32 * STAGE + c] = da;
    sum += da;
  }
  red[threadIdx.x] = sum;
  __syncthreads();
  if (r == 0) {
    float total = 0.f;
    for (int k = 0; k < ROWS; ++k) total += red[k * COUT + c];
    db_part[(size_t)blockIdx.x * COUT + c] = total;
  }
}

// ------------------------------------------------------------- f32

namespace cuda_core {

constexpr int LDX = CCHUNK + 1;  // odd: conflict-free staging

template <int COUT>
constexpr size_t wgrad_smem() {
  return ((size_t)HALO_PX * LDX + (size_t)TH * TW * COUT) * sizeof(float);
}

// part[grp]: this CTA's (3, 3, CIN, COUT) f32 partial of dW, for input
// channels [32 blockIdx.y, +32) over the tiles grp, grp + groups, ...;
// dy_i is DY's channels CIN - 64 .. +COUT.  Thread t owns input channel
// t % 32 and the C_out / 8 output channels of group t / 32, nine taps.
template <int CIN, int COUT>
__global__ void __launch_bounds__(NT)
wgrad_f32(const float* __restrict__ feat, const float* __restrict__ dy,
          float* __restrict__ part, int B, int H, int W, int groups) {
  constexpr int CT = COUT / 8;
  constexpr int DYOFF = CIN - CH;
  extern __shared__ __align__(16) float smem_wf[];
  float* in_s = smem_wf;                  // [HALO_PX][LDX]
  float* dy_s = smem_wf + HALO_PX * LDX;  // [TH * TW][COUT]

  const int tid = threadIdx.x;
  const int ci = tid % 32, cog = tid / 32;
  const int c0 = blockIdx.y * CCHUNK;
  const int grp = blockIdx.x;
  const int n_tiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);

  float acc[9][CT];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[t][j] = 0.f;

  for (int tl = grp; tl < n_tiles; tl += groups) {
    const Tile t = tile_of(tl, H, W);
    const size_t img = (size_t)t.b * H * W;
    __syncthreads();
    for (int i = tid; i < HALO_PX * CCHUNK; i += NT) {
      const int px = i / CCHUNK, c = i % CCHUNK;
      const int gy = t.y0 - 1 + px / HALO_W, gx = t.x0 - 1 + px % HALO_W;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = feat[(img + (size_t)gy * W + gx) * FEAT + c0 + c];
      in_s[px * LDX + c] = v;
    }
    for (int i = tid; i < TH * TW * COUT; i += NT) {
      const int p = i / COUT, c = i % COUT;
      const int gy = t.y0 + p / TW, gx = t.x0 + p % TW;
      float v = 0.f;
      if (gy < H && gx < W)
        v = dy[(img + (size_t)gy * W + gx) * FEAT + DYOFF + c];
      dy_s[i] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int p = 0; p < TH * TW; ++p) {
      const int ty = p / TW, tx = p % TW;
      float d[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) d[j] = dy_s[p * COUT + cog * CT + j];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float xv =
            in_s[((ty + tap / 3) * HALO_W + tx + tap % 3) * LDX + ci];
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[tap][j] = fmaf(xv, d[j], acc[tap][j]);
      }
    }
  }

  float* out = part + (size_t)grp * 9 * CIN * COUT;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < CT; ++j)
      out[((size_t)tap * CIN + c0 + ci) * COUT + cog * CT + j] = acc[tap][j];
}

constexpr int DTW = 16;  // dgrad tile columns
constexpr int DHALO_W = DTW + 2;
constexpr int DHALO_PX = (TH + 2) * DHALO_W;
constexpr int IN_LD = DHALO_PX + 1;  // odd: conflict-free staging
constexpr int KC = 16;               // dy channels per stage
constexpr int PX = 4;                // pixels per thread (one row)
constexpr int CO = 8;                // output channels per thread
constexpr int DNT = (TH * DTW / PX) * (CCHUNK / CO);  // 128 threads

constexpr size_t dgrad_smem() {
  return (size_t)(KC * IN_LD + 9 * KC * CCHUNK) * sizeof(float);
}

// The conv of dy_i (DY channels COUT_ALL - 64 .. +CIN) by wt, HWIO (3, 3,
// CIN, COUT_ALL), for dF channels [32 c, 32 c + 32), c = blockIdx.z %
// nchunks: an 8 x 16 tile, each thread 4 neighbouring pixels of a row x
// 8 of the 32 output channels.  ACCUM adds into dF (else stores); FINAL also writes dx =
// dF[:, :64] + g.
template <int CIN, int COUT_ALL, bool ACCUM, bool FINAL>
__global__ void __launch_bounds__(DNT)
dgrad_f32(const float* __restrict__ dy, const float* __restrict__ wt,
          float* __restrict__ dF, const float* __restrict__ g,
          float* __restrict__ dx, int H, int W) {
  static_assert(CIN % KC == 0 && COUT_ALL % CCHUNK == 0, "tiling");
  constexpr int NCHUNKS = COUT_ALL / CCHUNK;
  constexpr int NCOG = CCHUNK / CO;
  constexpr int DYOFF = COUT_ALL - CH;
  extern __shared__ __align__(16) float smem_df[];
  float* in_s = smem_df;              // [KC][IN_LD]
  float* w_s = smem_df + KC * IN_LD;  // [9][KC][CCHUNK]

  const int tid = threadIdx.x;
  const int cog = tid % NCOG;
  const int pg = tid / NCOG;
  const int ty = pg / (DTW / PX);
  const int tx0 = (pg % (DTW / PX)) * PX;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * DTW;
  const int bimg = blockIdx.z / NCHUNKS;
  const int co0 = (blockIdx.z % NCHUNKS) * CCHUNK;
  const size_t img = (size_t)bimg * H * W;

  float acc[PX][CO];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[p][c] = 0.f;

  for (int c0 = 0; c0 < CIN; c0 += KC) {
    __syncthreads();
    for (int i = tid; i < DHALO_PX * KC; i += DNT) {
      const int px = i / KC, ci = i % KC;
      const int gy = y0 - 1 + px / DHALO_W;
      const int gx = x0 - 1 + px % DHALO_W;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = dy[(img + (size_t)gy * W + gx) * FEAT + DYOFF + c0 + ci];
      in_s[ci * IN_LD + px] = v;
    }
    for (int i = tid; i < 9 * KC * CCHUNK; i += DNT) {
      const int tap = i / (KC * CCHUNK), r = i % (KC * CCHUNK);
      const int ci = r / CCHUNK, co = r % CCHUNK;
      w_s[i] = wt[((size_t)tap * CIN + c0 + ci) * COUT_ALL + co0 + co];
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
          a[j] = in_c[(ty + ky) * DHALO_W + tx0 + j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wp = reinterpret_cast<const float4*>(
              w_s + ((ky * 3 + kx) * KC + ci) * CCHUNK + cog * CO);
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
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int gx = x0 + tx0 + p;
    if (gx >= W) continue;
    const size_t pix = img + (size_t)gy * W + gx;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      const int co = co0 + cog * CO + c;
      float v = acc[p][c];
      if constexpr (ACCUM) v += dF[pix * FEAT + co];
      dF[pix * FEAT + co] = v;
      if constexpr (FINAL) dx[pix * CH + co] = v + g[pix * CH + co];
    }
  }
}

}  // namespace cuda_core

// ------------------------------------------------------------ launches

template <int STAGE>
cudaError_t launch_prep(const void* src, const void* feat, void* dy,
                        void* db_part, int M, int nblocks, float scale,
                        cudaStream_t s) {
  const int ppb = (M + nblocks - 1) / nblocks;
  prep<STAGE><<<nblocks, NT, 0, s>>>(
      static_cast<const float*>(src), static_cast<const float*>(feat),
      static_cast<float*>(dy), static_cast<float*>(db_part), M, ppb, scale);
  return cudaGetLastError();
}

template <int CIN, int COUT>
cudaError_t launch_wgrad(const void* feat, const void* dy, void* part, int B,
                         int H, int W, int groups, cudaStream_t s) {
  auto kernel = cuda_core::wgrad_f32<CIN, COUT>;
  constexpr size_t smem = cuda_core::wgrad_smem<COUT>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(groups, CIN / CCHUNK), NT, smem, s>>>(
      static_cast<const float*>(feat), static_cast<const float*>(dy),
      static_cast<float*>(part), B, H, W, groups);
  return cudaGetLastError();
}

// dgrad of conv (CIN_I -> COUT_I): its input is dy_i (COUT_I channels of
// DY), its output dF[:, :CIN_I].
template <int CIN_I, int COUT_I, bool ACCUM, bool FINAL>
cudaError_t launch_dgrad(const void* dy, const void* wt, void* dF,
                         const void* g, void* dx, int B, int H, int W,
                         cudaStream_t s) {
  auto kernel = cuda_core::dgrad_f32<COUT_I, CIN_I, ACCUM, FINAL>;
  constexpr size_t smem = cuda_core::dgrad_smem();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + cuda_core::DTW - 1) / cuda_core::DTW,
                  (H + TH - 1) / TH, B * (CIN_I / CCHUNK));
  kernel<<<grid, cuda_core::DNT, smem, s>>>(
      static_cast<const float*>(dy), static_cast<const float*>(wt),
      static_cast<float*>(dF), static_cast<const float*>(g),
      static_cast<float*>(dx), H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 block backward: eight launches (csrc/rdb_bwd_sm90.cuh) from g
// and feat (B, H, W, 64 / 192) and the five kernels (pointers and
// (ky, kx, ci, co) element strides; f32 with w_f32 = 1, else bf16) into
// DY, dx, the flat f32 dW (239,616) and db (192), through the scratch
// wpack (packed weights), dw_part and db_part.  Returns the first
// launch's cudaError_t (0 on success), as every entry point below.
int rdb_bwd_bf16_launch(const void* g, const void* feat, const void* wptr,
                        const void* wstride, int w_f32, void* dy, void* dx,
                        void* wpack, void* dw_part, void* db_part, void* dw,
                        void* db, int B, int H, int W, float scale,
                        int nblocks, int P, int g_conv, int g_dx, int g_wgrad,
                        int device, void* stream) {
  return rdb_bwd_sm90::launch_bwd_entry(
      g, feat, static_cast<const void* const*>(wptr),
      static_cast<const long long*>(wstride), w_f32, dy, dx, wpack, dw_part,
      db_part, dw, db, B, H, W, 0, scale, nblocks, P, g_conv, g_dx, g_wgrad,
      device, stream);
}

// f32 prep of conv `stage`: src is g (M, 64) for stage 4, else the f32
// dF buffer (M, 192); writes dy_stage into DY (M, 192) and `nblocks` rows
// of partial db sums.
int rdb_bwd_prep_launch(int stage, const void* src, const void* feat,
                        void* dy, void* db_part, int M, int nblocks,
                        float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return (int)launch_prep<0>(src, feat, dy, db_part, M, nblocks, scale, s);
    case 1: return (int)launch_prep<1>(src, feat, dy, db_part, M, nblocks, scale, s);
    case 2: return (int)launch_prep<2>(src, feat, dy, db_part, M, nblocks, scale, s);
    case 3: return (int)launch_prep<3>(src, feat, dy, db_part, M, nblocks, scale, s);
    case 4: return (int)launch_prep<4>(src, feat, dy, db_part, M, nblocks, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f32 wgrad of conv `stage`: `groups` f32 partials of dW, (groups, 3, 3,
// C_in, C_out), into part, from feat and DY.
int rdb_bwd_wgrad_launch(int stage, const void* feat, const void* dy,
                         void* part, int B, int H, int W, int groups,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return (int)launch_wgrad<64, 32>(feat, dy, part, B, H, W, groups, s);
    case 1: return (int)launch_wgrad<96, 32>(feat, dy, part, B, H, W, groups, s);
    case 2: return (int)launch_wgrad<128, 32>(feat, dy, part, B, H, W, groups, s);
    case 3: return (int)launch_wgrad<160, 32>(feat, dy, part, B, H, W, groups, s);
    case 4: return (int)launch_wgrad<192, 64>(feat, dy, part, B, H, W, groups, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f32 dgrad of conv `stage` from DY: wt is its flipped, transposed
// kernel, HWIO (3, 3, C_out, C_in); stage 4 stores dF, the others add
// into it, and stage 0 also writes dx (M, 64) = dF[:, :64] + g.
int rdb_bwd_dgrad_launch(int stage, const void* dy, const void* wt, void* dF,
                         const void* g, void* dx, int B, int H, int W,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return (int)launch_dgrad<64, 32, true, true>(dy, wt, dF, g, dx, B, H, W, s);
    case 1: return (int)launch_dgrad<96, 32, true, false>(dy, wt, dF, g, dx, B, H, W, s);
    case 2: return (int)launch_dgrad<128, 32, true, false>(dy, wt, dF, g, dx, B, H, W, s);
    case 3: return (int)launch_dgrad<160, 32, true, false>(dy, wt, dF, g, dx, B, H, W, s);
    case 4: return (int)launch_dgrad<192, 64, false, false>(dy, wt, dF, g, dx, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dw (n,) = the sum of `groups` partials; db (cout,) = the sum of
// `nblocks` partial rows.
int rdb_bwd_reduce_launch(const void* dw_part, int groups, int n,
                          const void* db_part, int nblocks, int cout,
                          void* dw, void* db, int device, void* stream) {
  return rdb::launch_reduce(dw_part, groups, n, db_part, nblocks, cout, dw,
                            db, device, stream);
}

const char* rdb_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
