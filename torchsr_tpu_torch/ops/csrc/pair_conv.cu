// 3x3 SAME convolution, 64 -> 64 channels, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels torchsr_tpu/ops/pallas/pair_conv.py:134
// (_fwd_kernel, launched by _pair_fwd :203 from pair_conv :354) and
// pair_conv.py:148 (_bwd_kernel, launched by _pair_bwd :230 from the
// custom-VJP rule _pair_conv_bwd :323).  x is NHWC (B, H, W, 64), the
// kernel HWIO (3, 3, 64, 64) in f32 or x's dtype, the bias (64,) f32:
//
//   y  = bias + sum_taps x[p + (ky-1, kx-1)] . K[ky][kx]   (f32, rounded once)
//   dx = the same conv of g with K'[ky][kx] = K[2-ky][2-kx]^T, no bias
//   dW[ky][kx][ci][co] = sum_p x[p + (ky-1, kx-1)][ci] g[p][co]   (f32)
//   db[co] = sum_p g[p][co]                                       (f32)
//
// with zeros outside each image, the kernel rounded to x's dtype
// (in the kernel: __float2bfloat16_rn, bit-equal to .to(bfloat16)) and
// g already rounded to x's dtype by the wrapper (ops/pair_conv.py), the
// JAX package's precision contract (_primal :300, _pair_conv_bwd :323).
//
// Design.  The TPU kernel packs two neighbouring pixels into one
// 128-lane row so that a 64-channel conv fills the MXU (module docstring
// :3-20).  wgmma has no such waste at N = 64, so this is the plain conv.
// bf16 (the tensor-core kernels):
//
//  * Tiles are runs of up to 128 output pixels of one image: where
//    W <= 64 a run crosses row ends (ldmatrix takes one row address per
//    lane), else it stays in one row.  No MMA row lies outside the image
//    but in an image's last run, whose empty 64-row halves skip their
//    wgmma.  A run's halo is the image rows it touches plus one above and
//    one below (whole rows, or run + 2 pixels on wide images), zeros
//    outside the image: at most 390 pixels, 49 KB.
//  * Persistent CTAs, one per SM (the grid comes from the wrapper's
//    mirror of this schedule, ops/pair_conv.py conv_ctas): CTA c
//    walks runs c, c + grid, ...  A ring of two halo stages is filled by
//    cp.async 16-byte copies (zero-fill outside the image) and waited on
//    by commit group, so run i + 1's loads fly under run i's MMAs and
//    epilogue.  cp.async rather than TMA: a halo that crosses row ends
//    is not one box of a tensor map, and the per-lane addresses are
//    already computed for ldmatrix; the swizzle is written by hand.
//  * conv (forward and dgrad): two warpgroups, 64 pixels each; per tap
//    and 16 channels one wgmma m64n64k16 with A (the tap-shifted halo)
//    from registers by ldmatrix and B (the weights) by descriptor.  The
//    9 x 64 x 64 weights are staged once per CTA in [tap][n][k] order,
//    128-byte rows swizzled for the descriptor: the forward transposes
//    HWIO (B[t][co][ci] = K[t][ci][co]); the dgrad reads tap 8 - t as
//    stored (B[t][ci][co] = K[8-t][ci][co]), which is K'.  The
//    accumulators start at the bias; the epilogue rounds them once to
//    bf16 and stores through a per-warp swizzled buffer in 16-byte
//    vectors.
//  * wgrad: three warpgroups, taps 3 wg .. 3 wg + 2 each (96 f32
//    accumulators a thread), all 64 input channels: M = 64 ci, N = 64
//    co, K = 16 pixels; A = the tap-shifted halo transposed (ldmatrix
//    .trans), B = the staged g rows (MN-major, by descriptor).  g and x
//    are staged once per run through the same ring.  Each CTA writes one
//    f32 partial of dW and db;
//  * reduce (rdb_mma.cuh) sums the partials in a fixed order: dW and db
//    are the same from run to run, with no atomics.
//
// f32 (FFMA: tensor cores would round to TF32, above the f32 limit):
// one CTA per 8 x 16 (conv) or per group of 8 x 32 tiles and 32-channel
// chunk (wgrad), staged synchronously; the dgrad reads K' in the
// kernel as the bf16 conv does.
//
// Bound on this card (H100 SXM).  At the tool's shape (128, 24, 24, 64)
// one bf16 conv moves x in and y out, 18.9 MB: 5.6 us at 3.35 TB/s,
// above its 5.44 GFLOP at the 989 TFLOP/s peak (5.5 us): bound by bytes,
// 0.0057 ms.  f32: 81 us at the 67 TFLOP/s FMA peak.  The backward
// reads x and g and writes dx (28.3 MB, 8.5 us) for twice the FLOP
// (11.0 us): 0.0110 ms, bound by operations.

#include "hopper.cuh"
#include "rdb_mma.cuh"

namespace {

using rdb::allow_smem;
using rdb::store2;

constexpr int C = 64;       // input and output channels
constexpr int TH = 8;       // f32 tile rows
constexpr int CCHUNK = 32;  // input channels per f32 wgrad CTA

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

using hopper::swz;

constexpr int RUN = 128;        // output pixels per run
constexpr int NARROW_W = 64;    // up to this width a run crosses rows
constexpr int HALO_MAX = 392;   // halo pixels a stage holds (390 needed)
constexpr int ROW = 128;        // bytes of one pixel's 64 channels
constexpr int STAGE_X = HALO_MAX * ROW;  // 50,176 (49 atoms)
constexpr int STAGE_G = RUN * ROW;       // 16,384
constexpr int W_TAP = C * ROW;           // one tap's 64 B rows: 8,192
constexpr int CONV_NT = 256;    // two warpgroups of 64 pixels
constexpr int WGRAD_NT = 384;   // three warpgroups of three taps

constexpr size_t conv_smem() {  // weights, two stages, epilogue buffers
  return 1024 + 9 * W_TAP + 2 * STAGE_X + (CONV_NT / 32) * 16 * ROW;
}
constexpr size_t wgrad_smem() {
  return 1024 + 2 * (STAGE_X + STAGE_G);
}

__host__ __device__ inline int runs_per_image(int H, int W) {
  return W <= NARROW_W ? (H * W + RUN - 1) / RUN
                       : H * ((W + RUN - 1) / RUN);
}

// Run `t` of the batch, image by image: pixels p0 .. p0 + n - 1 of image
// b (flattened y * W + x).  Its halo pixel (hr, hc) is the image pixel
// (r0 - 1 + hr, hx0 - 1 + hc), hw pixels a halo row, hpx in all.
struct Run {
  int b, p0, n, r0, hx0, hw, hpx;
};

__device__ __forceinline__ Run run_of(int t, int H, int W) {
  const int per = runs_per_image(H, W);
  Run r;
  r.b = t / per;
  const int q = t % per;
  if (W <= NARROW_W) {
    r.p0 = q * RUN;
    r.n = min(RUN, H * W - r.p0);
    r.hx0 = 0;
    r.hw = W + 2;
  } else {
    const int nx = (W + RUN - 1) / RUN, x0 = (q % nx) * RUN;
    r.p0 = (q / nx) * W + x0;
    r.n = min(RUN, W - x0);
    r.hx0 = x0;
    r.hw = r.n + 2;
  }
  r.r0 = r.p0 / W;
  r.hpx = ((r.p0 + r.n - 1) / W - r.r0 + 3) * r.hw;
  return r;
}

// Halo index of the pixel up and left of the run's pixel i (tap (0, 0));
// tap (ky, kx) adds ky * hw + kx.  Rows past the run read its last
// pixel: finite values, never stored (conv) or times zero g (wgrad).
__device__ __forceinline__ int halo_base(const Run& r, int i, int W) {
  const int p = r.p0 + min(i, r.n - 1);
  return (p / W - r.r0) * r.hw + (p % W - r.hx0);
}

// cp.async of run r's halo of `src` into the stage at shared `dst`.
__device__ __forceinline__ void stage_halo(
    const __nv_bfloat16* __restrict__ src, const Run& r, int H, int W,
    uint32_t dst, int tid, int nt) {
  const size_t img = (size_t)r.b * H * W;
  for (int i = tid; i < r.hpx * 8; i += nt) {
    const int px = i >> 3, c = i & 7;
    const int gy = r.r0 - 1 + px / r.hw, gx = r.hx0 - 1 + px % r.hw;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    hopper::cp_async_16(
        dst + swz(px, c),
        ok ? src + (img + (size_t)gy * W + gx) * C + c * 8 : src, ok);
  }
}

// cp.async of run r's own pixels of `src` (rows past n: zeros).
__device__ __forceinline__ void stage_run(
    const __nv_bfloat16* __restrict__ src, const Run& r, int H, int W,
    uint32_t dst, int tid, int nt) {
  const __nv_bfloat16* base = src + ((size_t)r.b * H * W + r.p0) * C;
  for (int i = tid; i < RUN * 8; i += nt) {
    const int px = i >> 3, c = i & 7;
    const bool ok = px < r.n;
    hopper::cp_async_16(dst + swz(px, c), ok ? base + px * C + c * 8 : src,
                        ok);
  }
}

// Eight consecutive elements as f32, in 16-byte loads (16-byte aligned).
__device__ __forceinline__ void load8(const float* s, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(s)[0];
  const float4 b = reinterpret_cast<const float4*>(s)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* s,
                                      float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(s);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x, v[2 * j + 1] = f.y;
  }
}

// Stores eight f32 as bf16 at 16-byte chunk c of row n of tap's B.
__device__ __forceinline__ void put8(uint8_t* w_s, int tap, int n, int c,
                                     const float (&v)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    u[j] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(w_s + tap * W_TAP + swz(n, c)) =
      make_uint4(u[0], u[1], u[2], u[3]);
}

// The weights as the conv's B, rounded to bf16: tap t's 64 rows n of 64
// k, swizzled.  flip 0 (forward): B[t][co][ci] = K[t][ci][co], row n
// fastest across threads (coalesced reads); flip 1 (dgrad): B[t][ci][co]
// = K[8 - t][ci][co], K as stored, a 16-byte chunk a thread.  Unrolled,
// so that each thread's loads are in flight together.
template <typename T>
__device__ __forceinline__ void stage_weights(const T* __restrict__ w,
                                              int flip, uint8_t* w_s,
                                              int tid) {
  constexpr int ITEMS = 9 * C * 8 / CONV_NT;  // 18 chunks a thread
  static_assert(ITEMS * CONV_NT == 9 * C * 8, "whole chunks per thread");
  if (flip) {
#pragma unroll 6
    for (int k = 0; k < ITEMS; ++k) {
      const int i = tid + k * CONV_NT, tap = i / (C * 8), q = i % (C * 8);
      float v[8];
      load8(w + ((size_t)(8 - tap) * C + q / 8) * C + (q % 8) * 8, v);
      put8(w_s, tap, q / 8, q % 8, v);
    }
  } else {
#pragma unroll 3
    for (int k = 0; k < ITEMS; ++k) {
      const int i = tid + k * CONV_NT, tap = i / (C * 8), q = i % (C * 8);
      const int n = q % C, c = q / C;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = rdb::to_f(w[((size_t)tap * C + c * 8 + j) * C + n]);
      put8(w_s, tap, n, c, v);
    }
  }
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// y (B, H, W, 64) = bias + conv3x3(x, K) with K read from w (HWIO, T =
// float or bf16) as `flip` says; bias may be null (zeros).  gridDim.x
// persistent CTAs.
template <typename T>
__global__ void __launch_bounds__(CONV_NT, 1)
conv_bf16(const __nv_bfloat16* __restrict__ x, const T* __restrict__ w,
          int flip, const float* __restrict__ bias,
          __nv_bfloat16* __restrict__ y, int B, int H, int W) {
  extern __shared__ uint8_t smem_c[];
  uint8_t* w_s = align_1024(smem_c);        // [9][64][128 B]
  uint8_t* x_s = w_s + 9 * W_TAP;           // [2][HALO_MAX][128 B]
  uint8_t* o_s = x_s + 2 * STAGE_X;         // [8 warps][16][128 B]
  const uint32_t w_u = hopper::smem_u32(w_s), x_u = hopper::smem_u32(x_s);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = (warp / 4) * 64, wrow = m0 + 16 * (warp % 4);
  const int g = lane / 4, tq = lane % 4;
  const int runs = B * runs_per_image(H, W);

  int t = blockIdx.x;
  if (t < runs) stage_halo(x, run_of(t, H, W), H, W, x_u, tid, CONV_NT);
  hopper::cp_async_commit();
  stage_weights(w, flip, w_s, tid);
  hopper::fence_proxy_async();  // the weights, for wgmma's reads

  // the bias at the accumulator's columns 8j + 2tq, 8j + 2tq + 1
  float bj[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bj[2 * j] = bias ? bias[8 * j + 2 * tq] : 0.f;
    bj[2 * j + 1] = bias ? bias[8 * j + 2 * tq + 1] : 0.f;
  }

  for (int s = 0; t < runs; t += gridDim.x, s ^= 1) {
    const Run r = run_of(t, H, W);
    if (t + (int)gridDim.x < runs)
      stage_halo(x, run_of(t + gridDim.x, H, W), H, W,
                 x_u + (s ^ 1) * STAGE_X, tid, CONV_NT);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();  // run t's halo (and the weights) are in place

    if (m0 < r.n) {  // a warpgroup whose 64 rows are all past n idles
      float acc[32];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[4 * j] = acc[4 * j + 2] = bj[2 * j];
        acc[4 * j + 1] = acc[4 * j + 3] = bj[2 * j + 1];
      }
      hopper::fence_operands(acc);
      const uint8_t* xs = x_s + s * STAGE_X;
      const int hb = halo_base(r, wrow + lane % 16, W);
      uint32_t a[2][4][4];  // two taps of A fragments, in turn
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int hp = hb + (tap / 3) * r.hw + tap % 3;
        if (tap >= 2) hopper::wgmma_wait<1>();  // tap - 2 read a[tap % 2]
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          rdb::ldmatrix_x4(a[tap % 2][ks], xs + swz(hp, 2 * ks + lane / 16));
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          hopper::wgmma_m64n64k16<0>(
              acc, a[tap % 2][ks],
              hopper::desc_sw128(w_u + tap * W_TAP + ks * 32));
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);

      // rows wrow + g (+ 8) of the run, through this warp's buffer
      uint8_t* os = o_s + warp * 16 * ROW;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(os + swz(g + 8 * h, j) +
                                             4 * tq) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      __syncwarp();
      __nv_bfloat16* yr = y + ((size_t)r.b * H * W + r.p0) * C;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = (32 * k + lane) / 8, c = lane % 8;
        if (wrow + row < r.n)
          *reinterpret_cast<uint4*>(yr + (size_t)(wrow + row) * C + c * 8) =
              *reinterpret_cast<const uint4*>(os + swz(row, c));
      }
      __syncwarp();  // the buffer is rewritten by the next run
    }
    __syncthreads();  // stage s is consumed before it is refilled
  }
}

// part[blockIdx.x]: this CTA's (3, 3, 64, 64) f32 partial of dW over
// runs blockIdx.x, blockIdx.x + gridDim.x, ...; db_part[blockIdx.x] its
// (64,) partial of db.  Warpgroup wg owns taps (wg, 0..2), warp q of it
// input channels 16q .. 16q + 15.
__global__ void __launch_bounds__(WGRAD_NT, 1)
wgrad_bf16(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ g, float* __restrict__ part,
           float* __restrict__ db_part, int B, int H, int W) {
  constexpr int STAGE = STAGE_X + STAGE_G;
  extern __shared__ uint8_t smem_w[];
  uint8_t* st = align_1024(smem_w);  // [2][halo of x | RUN rows of g]
  const uint32_t st_u = hopper::smem_u32(st);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, wq = warp % 4;
  const int dc = tid % C, dq = tid / C;  // db: channel, pixel phase
  const int runs = B * runs_per_image(H, W);

  float acc[3][32];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[k][e] = 0.f;
  float db = 0.f;

  int t = blockIdx.x;
  if (t < runs) {
    const Run r = run_of(t, H, W);
    stage_halo(x, r, H, W, st_u, tid, WGRAD_NT);
    stage_run(g, r, H, W, st_u + STAGE_X, tid, WGRAD_NT);
  }
  hopper::cp_async_commit();

  for (int s = 0; t < runs; t += gridDim.x, s ^= 1) {
    const Run r = run_of(t, H, W);
    if (t + (int)gridDim.x < runs) {
      const Run rn = run_of(t + gridDim.x, H, W);
      const uint32_t d = st_u + (s ^ 1) * STAGE;
      stage_halo(x, rn, H, W, d, tid, WGRAD_NT);
      stage_run(g, rn, H, W, d + STAGE_X, tid, WGRAD_NT);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    hopper::fence_proxy_async();  // g, for wgmma's reads
    __syncthreads();

    const uint8_t* xs = st + s * STAGE;
    const uint8_t* gs = xs + STAGE_X;
    for (int i = dq; i < r.n; i += WGRAD_NT / C)
      db += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
          gs + swz(i, dc / 8) + 2 * (dc % 8)));

    hopper::fence_operands(acc[0]);
    hopper::fence_operands(acc[1]);
    hopper::fence_operands(acc[2]);
    const uint32_t gs_u = st_u + s * STAGE + STAGE_X;
    const int nks = (r.n + 15) / 16;  // 16-pixel K steps with pixels
    uint32_t a[2][3][4];
#pragma unroll
    for (int ks = 0; ks < RUN / 16; ++ks) {
      if (ks >= nks) break;
      // A = x^T: matrices (ci 0-7 | 8-15) x (pixels 0-7 | 8-15)
      const int hb =
          halo_base(r, 16 * ks + lane % 8 + 8 * (lane / 16), W) + wg * r.hw;
      if (ks >= 2) hopper::wgmma_wait<1>();  // ks - 2 read a[ks % 2]
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rdb::ldmatrix_x4_trans(a[ks % 2][k],
                               xs + swz(hb + k, 2 * wq + (lane / 8) % 2));
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 3; ++k)
        hopper::wgmma_m64n64k16<1>(acc[k], a[ks % 2][k],
                                   hopper::desc_sw128(gs_u + ks * 16 * ROW));
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc[0]);
    hopper::fence_operands(acc[1]);
    hopper::fence_operands(acc[2]);
    __syncthreads();  // stage s is consumed before it is refilled
  }

  // rows (ci) 16 wq + lane / 4 (+ 8), columns (co) 8j + 2 (lane % 4) (+ 1)
  float* out = part + (size_t)blockIdx.x * 9 * C * C;
  const int ci = 16 * wq + lane / 4;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float* o = out + ((size_t)(3 * wg + k) * C + ci) * C + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      store2(o + 8 * j, acc[k][4 * j], acc[k][4 * j + 1]);
      store2(o + 8 * C + 8 * j, acc[k][4 * j + 2], acc[k][4 * j + 3]);
    }
  }

  float* red = reinterpret_cast<float*>(st);  // every copy has landed
  red[tid] = db;
  __syncthreads();
  if (tid < C) {
    float sum = 0.f;
    for (int q = 0; q < WGRAD_NT / C; ++q) sum += red[q * C + tid];
    db_part[(size_t)blockIdx.x * C + tid] = sum;
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
constexpr int WLD = C + 4;  // weight rows: the flipped staging's 8 x 4
                            // (ci x co) warp footprint hits 32 banks

constexpr size_t conv_smem() {
  return (size_t)(KC * IN_LD + 9 * KC * WLD) * sizeof(float);
}

// As conv_bf16, in f32, on an f32 kernel.
__global__ void __launch_bounds__(NT)
conv_f32(const float* __restrict__ x, const float* __restrict__ w,
         int flip, const float* __restrict__ bias, float* __restrict__ y,
         int H, int W) {
  extern __shared__ __align__(16) float smem_f[];
  float* in_s = smem_f;              // [KC][IN_LD]
  float* w_s = smem_f + KC * IN_LD;  // [9][KC][WLD]

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
    if (flip) {  // K'[tap][ci][co] = K[8 - tap][co][ci]; 32-byte reads
#pragma unroll 4
      for (int i = tid; i < 9 * KC * C; i += NT) {
        const int tap = i / (KC * C), r = i % (KC * C);
        const int ci = r % 8 + 8 * (r / (8 * C)), co = (r / 8) % C;
        w_s[(tap * KC + ci) * WLD + co] =
            w[((size_t)(8 - tap) * C + co) * C + c0 + ci];
      }
    } else {
      for (int i = tid; i < 9 * KC * C; i += NT) {
        const int tap = i / (KC * C), r = i % (KC * C);
        w_s[(tap * KC + r / C) * WLD + r % C] =
            w[((size_t)tap * C + c0) * C + r];
      }
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
              w_s + ((ky * 3 + kx) * KC + ci) * WLD + cog * CO);
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

// y (B, H, W, 64) = bias + conv3x3(x, K) on `stream` of `device`; w is
// HWIO (3, 3, 64, 64), f32 (w_f32 = 1) or x's dtype, read as K (flip 0)
// or as the dgrad's K' (flip 1); bias (64,) f32 or null (zeros; the
// dgrad).  bf16 runs on `ctas` persistent CTAs.  Returns the
// cudaError_t of the launch (0 on success), as every entry point below.
int pair_conv_launch(int is_bf16, int w_f32, int flip, const void* x,
                     const void* w, const void* bias, void* y, int B, int H,
                     int W, int ctas, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  if (is_bf16) {
    constexpr size_t smem = tensor_core::conv_smem();
    if (w_f32) {
      err = allow_smem(tensor_core::conv_bf16<float>, smem);
      if (err != cudaSuccess) return (int)err;
      tensor_core::conv_bf16<float><<<ctas, tensor_core::CONV_NT, smem, s>>>(
          xb, static_cast<const float*>(w), flip, b, yb, B, H, W);
    } else {
      err = allow_smem(tensor_core::conv_bf16<__nv_bfloat16>, smem);
      if (err != cudaSuccess) return (int)err;
      tensor_core::conv_bf16<__nv_bfloat16>
          <<<ctas, tensor_core::CONV_NT, smem, s>>>(
              xb, static_cast<const __nv_bfloat16*>(w), flip, b, yb, B, H,
              W);
    }
  } else {
    if (!w_f32) return (int)cudaErrorInvalidValue;
    constexpr size_t smem = cuda_core::conv_smem();
    err = allow_smem(cuda_core::conv_f32, smem);
    if (err != cudaSuccess) return (int)err;
    cuda_core::conv_f32<<<n_tiles(B, H, W, cuda_core::TW), cuda_core::NT,
                          smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), flip, b,
        static_cast<float*>(y), H, W);
  }
  return (int)cudaGetLastError();
}

// `groups` f32 partials of dW, (groups, 3, 3, 64, 64), into dw_part and
// of db, (groups, 64), into db_part, from x and g (B, H, W, 64); bf16
// runs one persistent CTA per partial.
int pair_conv_wgrad_launch(int is_bf16, const void* x, const void* g,
                           void* dw_part, void* db_part, int B, int H,
                           int W, int groups, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    constexpr size_t smem = tensor_core::wgrad_smem();
    err = allow_smem(tensor_core::wgrad_bf16, smem);
    if (err != cudaSuccess) return (int)err;
    tensor_core::wgrad_bf16<<<groups, tensor_core::WGRAD_NT, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), static_cast<float*>(dw_part),
        static_cast<float*>(db_part), B, H, W);
  } else {
    constexpr size_t smem = cuda_core::wgrad_smem();
    err = allow_smem(cuda_core::wgrad_f32, smem);
    if (err != cudaSuccess) return (int)err;
    cuda_core::wgrad_f32<<<dim3(groups, C / CCHUNK), cuda_core::WNT, smem,
                           s>>>(
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
