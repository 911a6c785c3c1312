// 3x3 SAME convolution, 64 -> 64 channels, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels torchsr_tpu/ops/pallas/pair_conv.py:134
// (_fwd_kernel, launched by _pair_fwd :203 from pair_conv :354) and
// pair_conv.py:148 (_bwd_kernel, launched by _pair_bwd :230 from the
// custom-VJP rule _pair_conv_bwd :323).  x is NHWC (B, H, W, 64), the
// kernel HWIO (3, 3, 64, 64) in x's dtype, the bias (64,) f32:
//
//   y  = bias + sum_taps x[p + (ky-1, kx-1)] . K[ky][kx]   (f32, rounded once)
//   dx = the same conv of g with K'[ky][kx] = K[2-ky][2-kx]^T, no bias
//   dW[ky][kx][ci][co] = sum_p x[p + (ky-1, kx-1)][ci] g[p][co]   (f32)
//   db[co] = sum_p g[p][co]                                       (f32)
//
// with zeros outside each image and g already rounded to x's dtype by
// the wrapper (ops/pair_conv.py), the JAX package's precision contract
// (_primal :300, _pair_conv_bwd :323).
//
// Design.  The TPU kernel packs two neighbouring pixels into one
// 128-lane row so that a 64-channel conv fills the MXU (six slot GEMMs
// and a 75% dense packed weight, module docstring :3-20).  mma.sync
// m16n8k16 has no such waste at N = 64, so this is the plain conv:
//
//  * conv (the forward and dgrad): an implicit GEMM, M = output pixels,
//    N = 64, K = 9 x 64 streamed tap by tap, one CTA per spatial tile
//    (a 1-D grid over batch x tiles: no gridDim.y/z limit), staging the
//    input tile with a 1-pixel halo (zeros outside the image: nothing
//    leaks across images or rows) and the weights in shared memory.  The
//    accumulators start at the bias, as the TPU kernel's do.  bf16: 8
//    warps over an 8 x 32 tile on mma.sync fed by ldmatrix (pixel rows
//    padded to 80 bytes: conflict-free), the layout of rdb_fwd.cu's
//    conv3x3_bf16; f32: FFMA on an 8 x 16 tile (tensor cores would round
//    to TF32), the layout of its conv3x3_f32.
//  * wgrad: an implicit GEMM with M = 32 input channels per CTA, N = 64,
//    K = pixels; each CTA walks a fixed set of 8 x 32 tiles and writes
//    its own f32 partial of dW (and, in the first channel chunk, of db).
//    The TPU adds each grid step's dW into one block (:176-184) because
//    its grid runs in sequence; CTAs do not, so
//  * reduce (rdb_mma.cuh) sums the partials in a fixed order: the
//    result is deterministic, with no atomics.
//
// Bound on this card (H100 SXM).  At the tool's shape (128, 24, 24, 64)
// one conv is 5.44 GFLOP: 5.5 us at the 989 TFLOP/s bf16 peak (bytes:
// x in, y out, 9.4 MB, 2.8 us), 81 us at the 67 TFLOP/s f32 FMA peak.
// The backward is twice that.  This simple version stages
// synchronously, issues mma.sync (a fraction of wgmma's rate), wastes a
// quarter of its 32-column tiles at W = 24, and writes the wgrad
// partials to device memory.

#include "rdb_mma.cuh"

namespace {

using rdb::allow_smem;
using rdb::ldmatrix_x4;
using rdb::ldmatrix_x4_trans;
using rdb::mma_bf16;
using rdb::store2;

constexpr int C = 64;       // input and output channels
constexpr int TH = 8;       // tile rows
constexpr int CCHUNK = 32;  // input channels per wgrad CTA

struct Tile {
  int b, y0, x0;
};

// Tile `t` of a batch of H x W images cut into TH x tw tiles.
__device__ __forceinline__ Tile tile_of(int t, int H, int W, int tw) {
  const int nw = (W + tw - 1) / tw, nh = (H + TH - 1) / TH;
  Tile r;
  r.b = t / (nw * nh);
  const int q = t % (nw * nh);
  r.y0 = (q / nw) * TH;
  r.x0 = (q % nw) * tw;
  return r;
}

__host__ __device__ constexpr int n_tiles(int B, int H, int W, int tw) {
  return B * ((H + TH - 1) / TH) * ((W + tw - 1) / tw);
}

// ---------------------------------------------------------------- bf16

namespace tensor_core {

constexpr int TW = 32;
constexpr int HALO_W = TW + 2;
constexpr int HALO_PX = (TH + 2) * HALO_W;
constexpr int KC = 32;         // input channels per stage
constexpr int LDS = KC + 8;    // 80-byte rows: ldmatrix conflict-free
constexpr int LDY = C + 8;     // 144-byte g rows in wgrad
constexpr int NT = TH * 32;    // one warp per tile row
constexpr int NTILES = C / 8;  // 8-channel N tiles

constexpr size_t conv_smem() {
  return (size_t)(HALO_PX + 9 * C) * LDS * sizeof(__nv_bfloat16);
}
constexpr size_t wgrad_smem() {
  return ((size_t)HALO_PX * LDS + (size_t)TH * TW * LDY) *
         sizeof(__nv_bfloat16);
}

// y (B, H, W, 64) = bias + conv3x3(x, w); bias may be null (zeros).
__global__ void __launch_bounds__(NT)
conv_bf16(const __nv_bfloat16* __restrict__ x,
          const __nv_bfloat16* __restrict__ w,
          const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
          int H, int W) {
  extern __shared__ __align__(16) __nv_bfloat16 smem_c[];
  __nv_bfloat16* in_s = smem_c;                 // [HALO_PX][LDS]
  __nv_bfloat16* w_s = smem_c + HALO_PX * LDS;  // [9][C][LDS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const Tile t = tile_of(blockIdx.x, H, W, TW);
  const size_t img = (size_t)t.b * H * W;

  // C fragment: rows g and g + 8 of each 16-pixel tile, channels 2tq, 2tq+1
  float acc[2][NTILES][4];
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    const int co = n * 8 + 2 * tq;
    const float b0 = bias ? bias[co] : 0.f, b1 = bias ? bias[co + 1] : 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[j][n][0] = acc[j][n][2] = b0;
      acc[j][n][1] = acc[j][n][3] = b1;
    }
  }

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the previous stage is fully consumed
    for (int i = tid; i < HALO_PX * (KC / 8); i += NT) {
      const int px = i / (KC / 8), ch = i % (KC / 8);
      const int gy = t.y0 - 1 + px / HALO_W, gx = t.x0 - 1 + px % HALO_W;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = *reinterpret_cast<const uint4*>(
            x + (img + (size_t)gy * W + gx) * C + c0 + ch * 8);
      *reinterpret_cast<uint4*>(in_s + px * LDS + ch * 8) = v;
    }
    // weights HWIO -> [tap][co][ci], ci fastest across threads
    for (int i = tid; i < 9 * (C / 8) * KC; i += NT) {
      const int ci = i % KC, r = i / KC;
      const int tap = r / (C / 8), co = (r % (C / 8)) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(
          w + ((size_t)tap * C + c0 + ci) * C + co);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) w_s[(tap * C + co + k) * LDS + ci] = e[k];
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
          ldmatrix_x4(b, w_s + (tap * C + np * 16 + (lane % 8) +
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

  const int gy = t.y0 + warp;
  if (gy >= H) return;
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    const int co = n * 8 + 2 * tq;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gx = t.x0 + 16 * j + g + 8 * h;
        if (gx >= W) continue;
        store2(y + (img + (size_t)gy * W + gx) * C + co, acc[j][n][2 * h],
               acc[j][n][2 * h + 1]);
      }
  }
}

// part[grp]: this CTA's (3, 3, 64, 64) f32 partial of dW for input
// channels [32 blockIdx.y, 32 blockIdx.y + 32), over the tiles grp,
// grp + groups, ...; the CTAs of the first chunk also write db_part[grp]
// (64 f32).  Warp w owns the 16-channel M tile w % 2 of the chunk, the
// N tiles 2 (w / 2) and 2 (w / 2) + 1, and all nine taps.
__global__ void __launch_bounds__(NT)
wgrad_bf16(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ g, float* __restrict__ part,
           float* __restrict__ db_part, int B, int H, int W, int groups) {
  extern __shared__ __align__(16) __nv_bfloat16 smem_w[];
  __nv_bfloat16* in_s = smem_w;                  // [HALO_PX][LDS]
  __nv_bfloat16* g_s = smem_w + HALO_PX * LDS;   // [TH * TW][LDY]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mt = warp % 2, ng = warp / 2;
  const int c0 = blockIdx.y * CCHUNK;
  const int grp = blockIdx.x;
  const bool with_db = blockIdx.y == 0;
  const int dc = tid % C, dq = tid / C;  // db: channel, pixel phase
  const int tiles = n_tiles(B, H, W, TW);

  float acc[9][2][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.f;
  float db = 0.f;

  for (int tl = grp; tl < tiles; tl += groups) {
    const Tile t = tile_of(tl, H, W, TW);
    const size_t img = (size_t)t.b * H * W;
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < HALO_PX * (CCHUNK / 8); i += NT) {
      const int px = i / (CCHUNK / 8), ch = i % (CCHUNK / 8);
      const int gy = t.y0 - 1 + px / HALO_W, gx = t.x0 - 1 + px % HALO_W;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = *reinterpret_cast<const uint4*>(
            x + (img + (size_t)gy * W + gx) * C + c0 + ch * 8);
      *reinterpret_cast<uint4*>(in_s + px * LDS + ch * 8) = v;
    }
    for (int i = tid; i < TH * TW * (C / 8); i += NT) {
      const int p = i / (C / 8), ch = i % (C / 8);
      const int gy = t.y0 + p / TW, gx = t.x0 + p % TW;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy < H && gx < W)
        v = *reinterpret_cast<const uint4*>(
            g + (img + (size_t)gy * W + gx) * C + ch * 8);
      *reinterpret_cast<uint4*>(g_s + p * LDY + ch * 8) = v;
    }
    __syncthreads();

    if (with_db)
      for (int p = dq; p < TH * TW; p += NT / C)
        db += __bfloat162float(g_s[p * LDY + dc]);

#pragma unroll 2
    for (int kc = 0; kc < TH * TW / 16; ++kc) {
      const int ty = kc / (TW / 16), tx0 = (kc % (TW / 16)) * 16;
      // B = g[pixel][co]: rows k = pixels, N tiles 2 ng, 2 ng + 1
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, g_s + (ty * TW + tx0 + (lane % 8) + 8 * ((lane / 8) % 2)) * LDY +
                 (2 * ng + lane / 16) * 8);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        // A = x[pixel + tap offset][ci], transposed: M = ci, K = pixels
        uint32_t a[4];
        ldmatrix_x4_trans(
            a, in_s + ((ty + ky) * HALO_W + tx0 + kx + (lane % 8) +
                       8 * (lane / 16)) * LDS +
                   mt * 16 + 8 * ((lane / 8) % 2));
        mma_bf16(acc[tap][0], a, b[0], b[1]);
        mma_bf16(acc[tap][1], a, b[2], b[3]);
      }
    }
  }

  // C fragment: rows (ci) gq and gq + 8, columns (co) 2tq and 2tq + 1
  const int gq = lane / 4, tq = lane % 4;
  float* out = part + (size_t)grp * 9 * C * C;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int co = (2 * ng + n) * 8 + 2 * tq;
      const int ci = c0 + mt * 16 + gq;
      float* o = out + ((size_t)tap * C + ci) * C + co;
      o[0] = acc[tap][n][0];
      o[1] = acc[tap][n][1];
      o[8 * C] = acc[tap][n][2];
      o[8 * C + 1] = acc[tap][n][3];
    }

  if (with_db) {
    __syncthreads();  // every warp is done with the staged tiles
    float* red = reinterpret_cast<float*>(smem_w);
    red[tid] = db;
    __syncthreads();
    if (tid < C) {
      float s = 0.f;
      for (int q = 0; q < NT / C; ++q) s += red[q * C + tid];
      db_part[(size_t)grp * C + tid] = s;
    }
  }
}

}  // namespace tensor_core

// ----------------------------------------------------------------- f32

namespace cuda_core {

constexpr int TW = 16;                 // conv tile columns
constexpr int HALO_W = TW + 2;
constexpr int HALO_PX = (TH + 2) * HALO_W;
constexpr int IN_LD = HALO_PX + 1;     // odd: conflict-free staging
constexpr int KC = 16;                 // input channels per stage
constexpr int PX = 4;                  // pixels per thread (one row)
constexpr int CO = 8;                  // output channels per thread
constexpr int NCOG = C / CO;
constexpr int NT = (TH * TW / PX) * NCOG;  // 256

constexpr size_t conv_smem() {
  return (size_t)(KC * IN_LD + 9 * KC * C) * sizeof(float);
}

// As conv_bf16, in f32.
__global__ void __launch_bounds__(NT)
conv_f32(const float* __restrict__ x, const float* __restrict__ w,
         const float* __restrict__ bias, float* __restrict__ y, int H,
         int W) {
  extern __shared__ __align__(16) float smem_f[];
  float* in_s = smem_f;              // [KC][IN_LD]
  float* w_s = smem_f + KC * IN_LD;  // [9][KC][C]

  const int tid = threadIdx.x;
  const int cog = tid % NCOG, pg = tid / NCOG;
  const int ty = pg / (TW / PX), tx0 = (pg % (TW / PX)) * PX;
  const Tile t = tile_of(blockIdx.x, H, W, TW);
  const size_t img = (size_t)t.b * H * W;

  float acc[PX][CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) {
    const float b = bias ? bias[cog * CO + c] : 0.f;
#pragma unroll
    for (int p = 0; p < PX; ++p) acc[p][c] = b;
  }

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the previous stage is fully consumed
    for (int i = tid; i < HALO_PX * KC; i += NT) {
      const int px = i / KC, ci = i % KC;
      const int gy = t.y0 - 1 + px / HALO_W, gx = t.x0 - 1 + px % HALO_W;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = x[(img + (size_t)gy * W + gx) * C + c0 + ci];
      in_s[ci * IN_LD + px] = v;
    }
    for (int i = tid; i < 9 * KC * C; i += NT) {
      const int tap = i / (KC * C), r = i % (KC * C);
      w_s[i] = w[((size_t)tap * C + c0) * C + r];
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
              w_s + ((ky * 3 + kx) * KC + ci) * C + cog * CO);
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

  const int gy = t.y0 + ty;
  if (gy >= H) return;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int gx = t.x0 + tx0 + p;
    if (gx >= W) continue;
    float* o = y + (img + (size_t)gy * W + gx) * C + cog * CO;
#pragma unroll
    for (int c = 0; c < CO; c += 2) store2(o + c, acc[p][c], acc[p][c + 1]);
  }
}

constexpr int WTW = 32;  // wgrad tile columns
constexpr int WHALO_W = WTW + 2;
constexpr int WHALO_PX = (TH + 2) * WHALO_W;
constexpr int LDX = CCHUNK + 1;  // odd: conflict-free staging
constexpr int WNT = 256;
constexpr int CT = C / (WNT / CCHUNK);  // output channels per thread: 8

constexpr size_t wgrad_smem() {
  return ((size_t)WHALO_PX * LDX + (size_t)TH * WTW * C) * sizeof(float);
}

// As wgrad_bf16 in f32 FFMA: thread t owns input channel t % 32 and the
// eight output channels of group t / 32, for all nine taps.
__global__ void __launch_bounds__(WNT)
wgrad_f32(const float* __restrict__ x, const float* __restrict__ g,
          float* __restrict__ part, float* __restrict__ db_part, int B,
          int H, int W, int groups) {
  extern __shared__ __align__(16) float smem_wf[];
  float* in_s = smem_wf;                  // [WHALO_PX][LDX]
  float* g_s = smem_wf + WHALO_PX * LDX;  // [TH * WTW][C]

  const int tid = threadIdx.x;
  const int ci = tid % CCHUNK, cog = tid / CCHUNK;
  const int c0 = blockIdx.y * CCHUNK;
  const int grp = blockIdx.x;
  const bool with_db = blockIdx.y == 0;
  const int dc = tid % C, dq = tid / C;
  const int tiles = n_tiles(B, H, W, WTW);

  float acc[9][CT];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[t][j] = 0.f;
  float db = 0.f;

  for (int tl = grp; tl < tiles; tl += groups) {
    const Tile t = tile_of(tl, H, W, WTW);
    const size_t img = (size_t)t.b * H * W;
    __syncthreads();
    for (int i = tid; i < WHALO_PX * CCHUNK; i += WNT) {
      const int px = i / CCHUNK, c = i % CCHUNK;
      const int gy = t.y0 - 1 + px / WHALO_W, gx = t.x0 - 1 + px % WHALO_W;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = x[(img + (size_t)gy * W + gx) * C + c0 + c];
      in_s[px * LDX + c] = v;
    }
    for (int i = tid; i < TH * WTW * C; i += WNT) {
      const int p = i / C, c = i % C;
      const int gy = t.y0 + p / WTW, gx = t.x0 + p % WTW;
      float v = 0.f;
      if (gy < H && gx < W) v = g[(img + (size_t)gy * W + gx) * C + c];
      g_s[i] = v;
    }
    __syncthreads();

    if (with_db)
      for (int p = dq; p < TH * WTW; p += WNT / C) db += g_s[p * C + dc];

#pragma unroll 2
    for (int p = 0; p < TH * WTW; ++p) {
      const int ty = p / WTW, tx = p % WTW;
      float d[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) d[j] = g_s[p * C + cog * CT + j];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float xv =
            in_s[((ty + tap / 3) * WHALO_W + tx + tap % 3) * LDX + ci];
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[tap][j] = fmaf(xv, d[j], acc[tap][j]);
      }
    }
  }

  float* out = part + (size_t)grp * 9 * C * C;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < CT; ++j)
      out[((size_t)tap * C + c0 + ci) * C + cog * CT + j] = acc[tap][j];

  if (with_db) {
    __syncthreads();
    float* red = smem_wf;
    red[tid] = db;
    __syncthreads();
    if (tid < C) {
      float s = 0.f;
      for (int q = 0; q < WNT / C; ++q) s += red[q * C + tid];
      db_part[(size_t)grp * C + tid] = s;
    }
  }
}

}  // namespace cuda_core

}  // namespace

extern "C" {

// y (B, H, W, 64) = bias + conv3x3(x, w) on `stream` of `device`; w is
// HWIO (3, 3, 64, 64) in x's dtype, bias (64,) f32 or null (zeros; the
// dgrad).  Returns the cudaError_t of the launch (0 on success), as
// every entry point below.
int pair_conv_launch(int is_bf16, const void* x, const void* w,
                     const void* bias, void* y, int B, int H, int W,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (is_bf16) {
    constexpr size_t smem = tensor_core::conv_smem();
    err = allow_smem(tensor_core::conv_bf16, smem);
    if (err != cudaSuccess) return (int)err;
    tensor_core::conv_bf16<<<n_tiles(B, H, W, tensor_core::TW),
                             tensor_core::NT, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), b,
        static_cast<__nv_bfloat16*>(y), H, W);
  } else {
    constexpr size_t smem = cuda_core::conv_smem();
    err = allow_smem(cuda_core::conv_f32, smem);
    if (err != cudaSuccess) return (int)err;
    cuda_core::conv_f32<<<n_tiles(B, H, W, cuda_core::TW), cuda_core::NT,
                          smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), b,
        static_cast<float*>(y), H, W);
  }
  return (int)cudaGetLastError();
}

// `groups` f32 partials of dW, (groups, 3, 3, 64, 64), into dw_part and
// of db, (groups, 64), into db_part, from x and g (B, H, W, 64).
int pair_conv_wgrad_launch(int is_bf16, const void* x, const void* g,
                           void* dw_part, void* db_part, int B, int H,
                           int W, int groups, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(groups, C / CCHUNK);
  if (is_bf16) {
    constexpr size_t smem = tensor_core::wgrad_smem();
    err = allow_smem(tensor_core::wgrad_bf16, smem);
    if (err != cudaSuccess) return (int)err;
    tensor_core::wgrad_bf16<<<grid, tensor_core::NT, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), static_cast<float*>(dw_part),
        static_cast<float*>(db_part), B, H, W, groups);
  } else {
    constexpr size_t smem = cuda_core::wgrad_smem();
    err = allow_smem(cuda_core::wgrad_f32, smem);
    if (err != cudaSuccess) return (int)err;
    cuda_core::wgrad_f32<<<grid, cuda_core::WNT, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(dw_part), static_cast<float*>(db_part), B, H, W,
        groups);
  }
  return (int)cudaGetLastError();
}

// dw (n,) = the sum of `groups` partials; db (cout,) = the sum of
// `nblocks` partial rows; in a fixed order.
int pair_conv_reduce_launch(const void* dw_part, int groups, int n,
                            const void* db_part, int nblocks, int cout,
                            void* dw, void* db, int device, void* stream) {
  return rdb::launch_reduce(dw_part, groups, n, db_part, nblocks, cout, dw,
                            db, device, stream);
}

const char* pair_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
