// The bf16 residual dense block (RDB) backward on Hopper (sm_90a), shared
// by csrc/rdb_bwd.cu (B2, the (B, H, W, 192) feature buffer) and
// csrc/rdb_ext.cu (B8, the row-extended (B, H + 2, W, 192) one): eight
// launches per block backward, no f32 dense gradient in device memory.
//
// Data flow.  Number the convs i = 0..4: conv i reads C_in(i) = 64 + 32 i
// channels of feat and its cotangent dy_i has 32 channels (64 for i = 4).
// The dense gradient of conv j's output slot (feat channels 64 + 32 j ..
// +32, j < 4) is one 3x3 conv over the later cotangents:
//
//   da_j = LReLU'(feat[:, slot j]) * sum_{k > j} dgrad_k(dy_k)[:, slot j]
//
// with dgrad_k the conv by conv k's kernel, taps flipped and C_in <->
// C_out swapped.  All cotangents live in one working-dtype buffer DY =
// [dy_0 | dy_1 | dy_2 | dy_3 | dy_4] (192 channels, feat's layout), so
// slot j's conv has K = the suffix of DY from channel 32 (j + 1): 64 to
// 160 channels.  The launches, in order:
//
//  1. prep: dy_4 = round(scale * g) into DY[:, 128:192] with f32 per-block
//     partials of db_4; zeros on the row-extended layout's pad rows (all
//     192 channels); and the five kernels (HWIO, f32 or bf16, any
//     strides: the caller's parameters as they are) rounded to bf16 into
//     one packed buffer, per slot conv in the order its CTAs stage them.
//  2-5. slot_conv for j = 3, 2, 1, 0: the conv above, its epilogue taking
//     LeakyReLU' from feat's sign, rounding da_j into dy_j (written into
//     DY) and summing da_j (f32, unrounded) into per-CTA partials of db_j.
//  6. slot_conv for dx: K = all 192 channels, N = feat's first 64
//     channels as two 32-channel halves (blockIdx.y), dx = round(that + g).
//  7. wgrad: dW_i[ky][kx][ci][co] = sum_p feat[p + (ky-1, kx-1)][ci]
//     dy_i[p][co] for all five convs in one launch (below).
//  8. reduce: every dW and db from their f32 partials in a fixed order:
//     bit-equal from run to run, no atomics.
//
// Products take bf16 operands and sum in f32; dW and db are f32; dx is
// bf16: the precision contract of the TPU kernel (torchsr_tpu/ops/pallas/
// rdb.py:538-577).  Only the order of the f32 sums differs from the TPU
// kernel's, which kept an f32 dense gradient in VMEM (rdb.py:536).
//
// slot_conv.  B4's conv (csrc/pair_conv.cu) with N = 32 and K streamed:
// persistent CTAs walk runs of up to 128 output pixels of one image
// (across row ends where W <= 64); each run is cut into K chunks of 64
// DY channels (the last may hold 32).  A ring of two halo stages (392
// pixels x 64 channels, 49 KB each) is filled by cp.async with zero-fill
// outside the image, one (run, chunk) ahead.  Two warpgroups of 64 pixels
// each issue, per tap and 16 channels, one wgmma m64n32k16 with A (the
// tap-shifted halo) from registers by ldmatrix and B (the packed weights)
// by descriptor.  A CTA stages its slot's weights once: at most 3 chunks x
// 9 taps x 32 x 64 bf16 = 108 KB, with the ring 208 KB of shared memory.
// dx's N = 64 would need 216 KB of weights, so it runs as two N = 32
// halves, each CTA on one half.
//
// wgrad.  B5's wgrad (csrc/pair_conv.cu): three warpgroups of three taps,
// M = 64 feat channels, N = 64 DY channels, K = the run's pixels, A = the
// tap-shifted feat halo transposed (ldmatrix.trans), B = the run's DY rows
// (MN-major, by descriptor).  A CTA owns one of seven 64 x 64 tiles, each
// two 32-channel halves of feat against two of DY, and walks runs:
//   0: feat 0-63    x dy_0 | dy_1      4: feat 0-63    x dy_4
//   1: feat 64-127  x dy_2 | dy_3      5: feat 64-127  x dy_4
//   2: feat 0-63    x dy_2 | dy_3      6: feat 128-191 x dy_4
//   3: feat 64-95 | 128-159 x dy_1 | dy_3
// dW needs sum_i 9 C_in(i) C_out(i) = 239,616 products a pixel; the tiles
// compute 7 x 9 x 64 x 64 = 258,048: 7.7% more (tile 3's feat 128-159 x
// dy_1 is not needed, its feat 64-95 x dy_3 repeats tile 1's).
//
// Bound on this card (H100 SXM) at the training shape (64, 32, 32, 64):
// dgrad and wgrad are 31.4 GFLOP each, 62.8 GFLOP, 0.0635 ms at 989
// TFLOP/s; bytes (feat and g in, dx out) 41.9 MB, 0.013 ms: compute-bound.

#pragma once

#include "hopper.cuh"
#include "rdb_mma.cuh"

namespace rdb_bwd_sm90 {

using hopper::align_1024;
using hopper::swz;
using rdb::Layout;
using rdb::load2;
using rdb::store2;
using rdb::Weights;
using rdb::weights_of;

constexpr int FEAT = 192;  // feature buffer and DY width
constexpr int CH = 64;     // block input/output channels
constexpr int RUN = 128;   // output pixels per run
constexpr int NARROW_W = 64;
constexpr int HALO_MAX = 392;
constexpr int ROW = 128;                 // bytes of 64 bf16 channels
constexpr int STAGE_X = HALO_MAX * ROW;  // 50,176
constexpr int STAGE_G = RUN * ROW;       // 16,384
constexpr int SLOT_N = 32;               // output channels of a slot conv
constexpr int W_TAP = SLOT_N * ROW;      // one tap of one chunk: 4,096
constexpr int MAX_CHUNKS = 3;
constexpr int NSLOTS = 6;  // slots j = 0..3, then dx's two halves
constexpr int NTILES = 7;  // wgrad tiles
constexpr int CONV_NT = 256;
constexpr int WGRAD_NT = 384;
constexpr int PREP_NT = 256;
constexpr int PREP_PIXELS = 256;  // pixels of one prep block's db partial
constexpr int DW_TOTAL = 9 * (64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 +
                              192 * 64);  // 239,616

// Slot s's first DY channel, first output channel of feat, K chunks and
// the offset of its packed weights (elements).
__host__ __device__ constexpr int slot_k0(int s) {
  return s < 4 ? 32 * (s + 1) : 0;
}
__host__ __device__ constexpr int slot_ci0(int s) {
  return s < 4 ? 64 + 32 * s : 32 * (s - 4);
}
__host__ __device__ constexpr int slot_chunks(int s) {
  return (FEAT - slot_k0(s) + 63) / 64;
}
__host__ __device__ constexpr int slot_wofs(int s) {
  int o = 0;
  for (int i = 0; i < s; ++i) o += slot_chunks(i) * 9 * SLOT_N * 64;
  return o;
}
constexpr int WPACK = slot_wofs(NSLOTS);  // 258,048 packed weights

// conv i's dW offset in the flat (239,616) f32 output
__host__ __device__ constexpr int dw_ofs(int i) {
  int o = 0;
  for (int k = 0; k < i; ++k) o += 9 * (64 + 32 * k) * (k < 4 ? 32 : 64);
  return o;
}

constexpr size_t conv_smem() {  // align slack, weights, ring, db exchange
  return 1024 + MAX_CHUNKS * 9 * W_TAP + 2 * STAGE_X +
         (CONV_NT / 32) * SLOT_N * sizeof(float);
}
constexpr size_t wgrad_smem() { return 1024 + 2 * (STAGE_X + STAGE_G); }

__host__ __device__ inline int runs_per_image(int H, int W) {
  return W <= NARROW_W ? (H * W + RUN - 1) / RUN : H * ((W + RUN - 1) / RUN);
}

// Run `t`, image by image: pixels p0 .. p0 + n - 1 of image b (y * W +
// x).  Its halo pixel (hr, hc) is image pixel (r0 - 1 + hr, hx0 - 1 +
// hc), hw pixels a halo row, hpx in all.  (csrc/pair_conv.cu's runs.)
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

// Halo index of the pixel up and left of the run's pixel i; rows past
// the run read its last pixel (finite, never stored or times zero dy).
__device__ __forceinline__ int halo_base(const Run& r, int i, int W) {
  const int p = r.p0 + min(i, r.n - 1);
  return (p / W - r.r0) * r.hw + (p % W - r.hx0);
}

// cp.async of run r's halo of `src` (192 channels a pixel) into the
// stage at `dst`: 16-byte chunk c < 4 from channel lo + 8 c, c >= 4 from
// hi + 8 (c - 4); `nq` (8, or 4 for a 32-channel K chunk) chunks a pixel.
__device__ __forceinline__ void stage_halo(
    const __nv_bfloat16* __restrict__ src, const Layout& L, const Run& r,
    int lo, int hi, int nq, uint32_t dst, int tid, int nt) {
  const int lq = nq == 8 ? 3 : 2;
  for (int i = tid; i < r.hpx << lq; i += nt) {
    const int px = i >> lq, c = i & (nq - 1);
    const int gy = r.r0 - 1 + px / r.hw, gx = r.hx0 - 1 + px % r.hw;
    const bool ok = gy >= 0 && gy < L.H && gx >= 0 && gx < L.W;
    const int ch = (c < 4 ? lo : hi) + 8 * (c & 3);
    hopper::cp_async_16(dst + swz(px, c),
                        ok ? src + L.pix(r.b, gy, gx) * FEAT + ch : src, ok);
  }
}

// cp.async of run r's own pixels of `src` (rows past n: zeros), chunks
// as stage_halo's with nq = 8.
__device__ __forceinline__ void stage_run(
    const __nv_bfloat16* __restrict__ src, const Layout& L, const Run& r,
    int lo, int hi, uint32_t dst, int tid, int nt) {
  const __nv_bfloat16* base = src + (L.pix(r.b, 0, 0) + r.p0) * FEAT;
  for (int i = tid; i < RUN * 8; i += nt) {
    const int px = i >> 3, c = i & 7;
    const bool ok = px < r.n;
    const int ch = (c < 4 ? lo : hi) + 8 * (c & 3);
    hopper::cp_async_16(dst + swz(px, c),
                        ok ? base + (size_t)px * FEAT + ch : src, ok);
  }
}

// ----------------------------------------------------------------- prep

// Blocks [0, nblocks): dy_4 and db_4's partials (PREP_PIXELS buffer
// pixels each), pad rows zeroed; the rest: 8 packed weights a thread.
// The packed weight of slot s, chunk c, tap t, row n, column kk is conv
// k's K[2 - t / 3][2 - t % 3][slot_ci0(s) + n][co] for DY channel d =
// slot_k0(s) + 64 c + kk of dy_k (zero past channel 191).
template <typename TW>
__global__ void __launch_bounds__(PREP_NT)
rdb_bwd_prep(const __nv_bfloat16* __restrict__ g, __nv_bfloat16* dy,
             float* __restrict__ db_part, int P, Layout L, float scale,
             int nblocks, Weights<TW> w, __nv_bfloat16* __restrict__ wpack) {
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= nblocks) {
    const int e0 = ((blockIdx.x - nblocks) * PREP_NT + tid) * 8;
    if (e0 >= WPACK) return;
    int s = 0;
    while (e0 >= slot_wofs(s + 1)) ++s;
    const int local = e0 - slot_wofs(s);
    const int c = local / (9 * SLOT_N * 64), rem = local % (9 * SLOT_N * 64);
    const int tap = rem / (SLOT_N * 64), n = rem % (SLOT_N * 64) / 64;
    const int d = slot_k0(s) + 64 * c + rem % 64;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (d < FEAT) {
      const int k = d < 128 ? d / 32 : 4, co = d < 128 ? d % 32 : d - 128;
      const TW* src = w.p[k] + (2 - tap / 3) * w.s[k][0] +
                      (2 - tap % 3) * w.s[k][1] +
                      (slot_ci0(s) + n) * w.s[k][2] + co * w.s[k][3];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = rdb::to_f(src[e * w.s[k][3]]);
    }
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      u[j] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(wpack + e0) = make_uint4(u[0], u[1], u[2], u[3]);
    return;
  }

  __shared__ float red[PREP_NT / 8][CH];
  const int q = tid % 8, r = tid / 8;  // channels 8q..8q+7 of pixel lane r
  const int npix = L.B * L.HP * L.W;
  const int p1 = min((int)(blockIdx.x + 1) * PREP_PIXELS, npix);
  float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int p = blockIdx.x * PREP_PIXELS + r; p < p1; p += PREP_NT / 8) {
    const int row = p / L.W, x = p % L.W;
    const int b = row / L.HP, y = row % L.HP - L.Y0;
    __nv_bfloat16* d = dy + (size_t)p * FEAT;
    if (y < 0 || y >= L.H) {  // a pad row of the row-extended layout
#pragma unroll
      for (int k = 0; k < FEAT / 64; ++k)
        *reinterpret_cast<uint4*>(d + 8 * (q + 8 * k)) =
            make_uint4(0, 0, 0, 0);
      continue;
    }
    const uint4 gv = *reinterpret_cast<const uint4*>(
        g + L.dense(b, y, x) * CH + 8 * q);
    const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&gv);
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(gh[j]);
      const float a0 = f.x * scale, a1 = f.y * scale;
      sum[2 * j] += a0;
      sum[2 * j + 1] += a1;
      const __nv_bfloat162 o = __floats2bfloat162_rn(a0, a1);
      u[j] = *reinterpret_cast<const uint32_t*>(&o);
    }
    *reinterpret_cast<uint4*>(d + 128 + 8 * q) =
        make_uint4(u[0], u[1], u[2], u[3]);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[r][8 * q + e] = sum[e];
  __syncthreads();
  if (tid < CH) {
    float total = 0.f;
    for (int k = 0; k < PREP_NT / 8; ++k) total += red[k][tid];
    db_part[((size_t)4 * P + blockIdx.x) * CH + tid] = total;
  }
}

// ------------------------------------------------------------ slot conv

// One K chunk of NKS x 16 channels: nine taps, A from the halo at `xs`
// by ldmatrix (lane's row: halo index hb), B from the chunk's weights at
// shared address `wc`.
template <int NKS>
__device__ __forceinline__ void chunk_mma(float (&acc)[16], const uint8_t* xs,
                                          int hb, int hw, uint32_t wc,
                                          int lane) {
  uint32_t a[2][NKS][4];  // two taps of A fragments, in turn
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int hp = hb + (tap / 3) * hw + tap % 3;
    if (tap >= 2) hopper::wgmma_wait<1>();  // tap - 2 read a[tap % 2]
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
      rdb::ldmatrix_x4(a[tap % 2][ks], xs + swz(hp, 2 * ks + lane / 16));
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
      hopper::wgmma_m64n32k16<0>(
          acc, a[tap % 2][ks],
          hopper::desc_sw128(wc + tap * W_TAP + ks * 32));
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
}

// Slot s = slot_base + blockIdx.y over gridDim.x persistent CTAs (see the
// header).  Slots 0-3 write dy_s into DY and f32 partials of db_s into
// db_part rows (s, blockIdx.x); slots 4, 5 write dx's channels 32 (s - 4)
// .. +32.  DY is read (channels >= slot_k0(s)) and written (channels
// 32 s .. +32) through one pointer: the ranges do not meet.
__global__ void __launch_bounds__(CONV_NT, 1)
rdb_bwd_slot_conv(__nv_bfloat16* dy, const __nv_bfloat16* __restrict__ wpack,
                  const __nv_bfloat16* __restrict__ feat,
                  const __nv_bfloat16* __restrict__ g,
                  __nv_bfloat16* __restrict__ dx, float* __restrict__ db_part,
                  int P, Layout L, int slot_base) {
  extern __shared__ uint8_t smem_c[];
  uint8_t* w_s = align_1024(smem_c);              // [chunk][9][32][128 B]
  uint8_t* x_s = w_s + MAX_CHUNKS * 9 * W_TAP;    // [2][HALO_MAX][128 B]
  float* red = reinterpret_cast<float*>(x_s + 2 * STAGE_X);  // [8][32]
  const uint32_t w_u = hopper::smem_u32(w_s), x_u = hopper::smem_u32(x_s);

  const int s = slot_base + blockIdx.y;
  const int k0 = slot_k0(s), nch = slot_chunks(s);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = (warp / 4) * 64, wrow = m0 + 16 * (warp % 4);
  const int gq = lane / 4, tq = lane % 4;
  const int G = gridDim.x;
  const int runs = L.B * runs_per_image(L.H, L.W);
  const int items =
      (int)blockIdx.x < runs ? ((runs - 1 - blockIdx.x) / G + 1) * nch : 0;

  auto stage_item = [&](int i, int st) {
    const int c = i % nch, lo = k0 + 64 * c;
    stage_halo(dy, L, run_of(blockIdx.x + (i / nch) * G, L.H, L.W), lo,
               lo + 32, FEAT - lo >= 64 ? 8 : 4, x_u + st * STAGE_X, tid,
               CONV_NT);
  };

  {  // the slot's packed weights, as stored, into the swizzle
    const __nv_bfloat16* wsrc = wpack + slot_wofs(s);
    for (int i = tid; i < nch * 9 * SLOT_N * 8; i += CONV_NT)
      hopper::cp_async_16(w_u + swz(i >> 3, i & 7), wsrc + (size_t)i * 8,
                          true);
  }
  if (items > 0) stage_item(0, 0);
  hopper::cp_async_commit();

  float acc[16];
  float dbs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < items; ++i) {
    const int st = i & 1, c = i % nch;
    if (i + 1 < items) stage_item(i + 1, st ^ 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    hopper::fence_proxy_async();  // the weights, for wgmma's reads
    __syncthreads();              // item i's halo is in place

    const Run r = run_of(blockIdx.x + (i / nch) * G, L.H, L.W);
    if (m0 < r.n) {  // a warpgroup whose 64 rows are all past n idles
      if (c == 0) {
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = 0.f;
      }
      hopper::fence_operands(acc);
      const uint8_t* xs = x_s + st * STAGE_X;
      const int hb = halo_base(r, wrow + lane % 16, L.W);
      const uint32_t wc = w_u + c * 9 * W_TAP;
      if (FEAT - k0 - 64 * c >= 64)
        chunk_mma<4>(acc, xs, hb, r.hw, wc, lane);
      else
        chunk_mma<2>(acc, xs, hb, r.hw, wc, lane);
      hopper::fence_operands(acc);

      if (c == nch - 1) {  // rows wrow + gq (+ 8), columns 8 j + 2 tq (+ 1)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wrow + gq + 8 * h;
          if (row >= r.n) continue;
          const int p = r.p0 + row, y = p / L.W, x = p % L.W;
          if (s < 4) {
            const size_t q = L.pix(r.b, y, x) * FEAT;
            const __nv_bfloat16* fp = feat + q + slot_ci0(s);
            __nv_bfloat16* dp = dy + q + 32 * s;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = 8 * j + 2 * tq;
              const float2 f = load2(fp + col);
              const float d0 = acc[4 * j + 2 * h] * (f.x > 0.f ? 1.f : 0.2f);
              const float d1 =
                  acc[4 * j + 2 * h + 1] * (f.y > 0.f ? 1.f : 0.2f);
              store2(dp + col, d0, d1);
              dbs[2 * j] += d0;
              dbs[2 * j + 1] += d1;
            }
          } else {
            const size_t q = L.dense(r.b, y, x) * CH + 32 * (s - 4);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = 8 * j + 2 * tq;
              const float2 gv = load2(g + q + col);
              store2(dx + q + col, acc[4 * j + 2 * h] + gv.x,
                     acc[4 * j + 2 * h + 1] + gv.y);
            }
          }
        }
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }

  if (s < 4) {  // db_s: the eight row lanes of a column, then the warps
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      dbs[e] += __shfl_xor_sync(0xffffffffu, dbs[e], 4);
      dbs[e] += __shfl_xor_sync(0xffffffffu, dbs[e], 8);
      dbs[e] += __shfl_xor_sync(0xffffffffu, dbs[e], 16);
    }
    if (gq == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[warp * SLOT_N + 8 * j + 2 * tq] = dbs[2 * j];
        red[warp * SLOT_N + 8 * j + 2 * tq + 1] = dbs[2 * j + 1];
      }
    }
    __syncthreads();
    if (tid < SLOT_N) {
      float total = 0.f;
      for (int k = 0; k < CONV_NT / 32; ++k) total += red[k * SLOT_N + tid];
      db_part[((size_t)s * P + blockIdx.x) * CH + tid] = total;
    }
  }
}

// ---------------------------------------------------------------- wgrad

// Tile t's feat and DY channel bases of its two 32-channel halves.
__device__ __forceinline__ void tile_bases(int t, int& f_lo, int& f_hi,
                                           int& d_lo, int& d_hi) {
  constexpr int T[NTILES][4] = {{0, 32, 0, 32},     {64, 96, 64, 96},
                                {0, 32, 64, 96},    {64, 128, 32, 96},
                                {0, 32, 128, 160},  {64, 96, 128, 160},
                                {128, 160, 128, 160}};
  f_lo = T[t][0], f_hi = T[t][1], d_lo = T[t][2], d_hi = T[t][3];
}

// part[(blockIdx.y * gridDim.x + blockIdx.x)]: this CTA's (9, 64, 64) f32
// partial of tile blockIdx.y over runs blockIdx.x, blockIdx.x + gridDim.x,
// ...  Warpgroup wg owns taps (wg, 0..2), warp q of it rows 16 q .. +15.
__global__ void __launch_bounds__(WGRAD_NT, 1)
rdb_bwd_wgrad(const __nv_bfloat16* __restrict__ feat,
              const __nv_bfloat16* __restrict__ dy, float* __restrict__ part,
              Layout L) {
  constexpr int STAGE = STAGE_X + STAGE_G;
  extern __shared__ uint8_t smem_w[];
  uint8_t* st = align_1024(smem_w);  // [2][halo of feat | RUN rows of DY]
  const uint32_t st_u = hopper::smem_u32(st);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, wq = warp % 4;
  const int runs = L.B * runs_per_image(L.H, L.W);
  int f_lo, f_hi, d_lo, d_hi;
  tile_bases(blockIdx.y, f_lo, f_hi, d_lo, d_hi);

  float acc[3][32];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[k][e] = 0.f;

  int t = blockIdx.x;
  if (t < runs) {
    const Run r = run_of(t, L.H, L.W);
    stage_halo(feat, L, r, f_lo, f_hi, 8, st_u, tid, WGRAD_NT);
    stage_run(dy, L, r, d_lo, d_hi, st_u + STAGE_X, tid, WGRAD_NT);
  }
  hopper::cp_async_commit();

  for (int s = 0; t < runs; t += gridDim.x, s ^= 1) {
    const Run r = run_of(t, L.H, L.W);
    if (t + (int)gridDim.x < runs) {
      const Run rn = run_of(t + gridDim.x, L.H, L.W);
      const uint32_t d = st_u + (s ^ 1) * STAGE;
      stage_halo(feat, L, rn, f_lo, f_hi, 8, d, tid, WGRAD_NT);
      stage_run(dy, L, rn, d_lo, d_hi, d + STAGE_X, tid, WGRAD_NT);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    hopper::fence_proxy_async();  // DY, for wgmma's reads
    __syncthreads();

    const uint8_t* xs = st + s * STAGE;
    hopper::fence_operands(acc[0]);
    hopper::fence_operands(acc[1]);
    hopper::fence_operands(acc[2]);
    const uint32_t gs_u = st_u + s * STAGE + STAGE_X;
    const int nks = (r.n + 15) / 16;  // 16-pixel K steps with pixels
    uint32_t a[2][3][4];
#pragma unroll
    for (int ks = 0; ks < RUN / 16; ++ks) {
      if (ks >= nks) break;
      // A = feat^T: matrices (ci 0-7 | 8-15) x (pixels 0-7 | 8-15)
      const int hb =
          halo_base(r, 16 * ks + lane % 8 + 8 * (lane / 16), L.W) + wg * r.hw;
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

  // rows (tile rows) 16 wq + lane / 4 (+ 8), columns 8 j + 2 (lane % 4)
  float* out =
      part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 9 * CH * CH;
  const int ci = 16 * wq + lane / 4;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float* o = out + ((size_t)(3 * wg + k) * CH + ci) * CH + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      store2(o + 8 * j, acc[k][4 * j], acc[k][4 * j + 1]);
      store2(o + 8 * CH + 8 * j, acc[k][4 * j + 2], acc[k][4 * j + 3]);
    }
  }
}

// --------------------------------------------------------------- reduce

// dw (flat: conv i's HWIO at dw_ofs(i)) and db (conv i's at 32 i) from
// the wgrad's G partials of each tile and the db partials: n_slot rows
// for convs 0-3, n_prep for conv 4; each a sum in a fixed order.
// (The body of the reduce, shared with the f32 backward's, whose wgrad
// writes its partials in the same tiles and layout.)
__device__ __forceinline__ void reduce_partials_of(
    const float* __restrict__ part, int G, const float* __restrict__ db_part,
    int P, int n_slot, int n_prep, float* __restrict__ dw,
    float* __restrict__ db) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e < DW_TOTAL) {
    int i = 0;
    while (i < 4 && e >= dw_ofs(i + 1)) ++i;
    const int cin = 64 + 32 * i, cout = i < 4 ? 32 : 64;
    const int local = e - dw_ofs(i);
    const int tap = local / (cin * cout), ci = local / cout % cin,
              co = local % cout;
    // the tile, row and column of (ci, DY channel of dy_i's co)
    const int d = (i < 4 ? 32 * i : 128) + co;
    int tile, row, col;
    if (i == 4) {
      tile = 4 + ci / 64, row = ci % 64, col = co;
    } else if (ci < 64) {
      tile = d < 64 ? 0 : 2, row = ci, col = d % 64;
    } else if (ci < 128 && i >= 2) {
      tile = 1, row = ci - 64, col = d % 64;
    } else {  // conv 1 at ci 64-95, conv 3 at ci 128-159
      tile = 3, row = ci < 128 ? ci - 64 : ci - 96;
      col = i == 1 ? co : 32 + co;
    }
    const float* p = part + (size_t)tile * G * 9 * CH * CH +
                     ((size_t)tap * CH + row) * CH + col;
    float s = 0.f;
    for (int k = 0; k < G; ++k) s += p[(size_t)k * 9 * CH * CH];
    dw[e] = s;
  } else if (e < DW_TOTAL + FEAT) {
    const int c = e - DW_TOTAL, i = c < 128 ? c / 32 : 4;
    const int n = i < 4 ? n_slot : n_prep, col = c - 32 * i;
    float s = 0.f;
    for (int k = 0; k < n; ++k) s += db_part[((size_t)i * P + k) * CH + col];
    db[c] = s;
  }
}

__global__ void __launch_bounds__(256)
rdb_bwd_reduce(const float* __restrict__ part, int G,
               const float* __restrict__ db_part, int P, int n_slot,
               int n_prep, float* __restrict__ dw, float* __restrict__ db) {
  reduce_partials_of(part, G, db_part, P, n_slot, n_prep, dw, db);
}

// ------------------------------------------------------------- launches

// The eight launches of one bf16 block backward on `stream`; returns the
// first launch's error (0 on success).  Grids: g_conv CTAs for each slot
// conv, (g_dx, 2) for dx, (g_wgrad, 7) for the wgrad (ops/rdb.py
// bwd_schedule mirrors them and sizes the partials).
template <typename TW>
cudaError_t launch_bwd(const __nv_bfloat16* g, const __nv_bfloat16* feat,
                       const Weights<TW>& w, __nv_bfloat16* dy,
                       __nv_bfloat16* dx, __nv_bfloat16* wpack, float* dw_part,
                       float* db_part, float* dw, float* db, Layout L,
                       float scale, int nblocks, int P, int g_conv, int g_dx,
                       int g_wgrad, cudaStream_t s) {
  cudaError_t err;
  const int pack_blocks = (WPACK / 8 + PREP_NT - 1) / PREP_NT;
  rdb_bwd_prep<TW><<<nblocks + pack_blocks, PREP_NT, 0, s>>>(
      g, dy, db_part, P, L, scale, nblocks, w, wpack);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr size_t csmem = conv_smem();
  if ((err = rdb::allow_smem(rdb_bwd_slot_conv, csmem)) != cudaSuccess)
    return err;
  for (int j = 3; j >= 0; --j) {
    rdb_bwd_slot_conv<<<g_conv, CONV_NT, csmem, s>>>(dy, wpack, feat, g, dx,
                                                      db_part, P, L, j);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  rdb_bwd_slot_conv<<<dim3(g_dx, 2), CONV_NT, csmem, s>>>(
      dy, wpack, feat, g, dx, db_part, P, L, 4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr size_t wsmem = wgrad_smem();
  if ((err = rdb::allow_smem(rdb_bwd_wgrad, wsmem)) != cudaSuccess) return err;
  rdb_bwd_wgrad<<<dim3(g_wgrad, NTILES), WGRAD_NT, wsmem, s>>>(feat, dy,
                                                              dw_part, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  rdb_bwd_reduce<<<(DW_TOTAL + FEAT + 255) / 256, 256, 0, s>>>(
      dw_part, g_wgrad, db_part, P, g_conv, nblocks, dw, db);
  return cudaGetLastError();
}

// The C entry's body: the five kernels come as pointers and (ky, kx, ci,
// co) element strides, f32 (w_f32 = 1) or bf16; `padded` selects the
// row-extended layout.
inline int launch_bwd_entry(const void* g, const void* feat,
                            const void* const* wptr, const long long* wstride,
                            int w_f32, void* dy, void* dx, void* wpack,
                            void* dw_part, void* db_part, void* dw, void* db,
                            int B, int H, int W, int padded, float scale,
                            int nblocks, int P, int g_conv, int g_dx,
                            int g_wgrad, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Layout L{B, H, W, padded ? H + 2 : H, padded ? 1 : 0};
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const auto* fb = static_cast<const __nv_bfloat16*>(feat);
  auto* dyb = static_cast<__nv_bfloat16*>(dy);
  auto* dxb = static_cast<__nv_bfloat16*>(dx);
  auto* wpb = static_cast<__nv_bfloat16*>(wpack);
  auto* dwp = static_cast<float*>(dw_part);
  auto* dbp = static_cast<float*>(db_part);
  auto* dwo = static_cast<float*>(dw);
  auto* dbo = static_cast<float*>(db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_f32)
    err = launch_bwd(gb, fb, weights_of<float>(wptr, wstride), dyb, dxb, wpb,
                     dwp, dbp, dwo, dbo, L, scale, nblocks, P, g_conv, g_dx,
                     g_wgrad, s);
  else
    err = launch_bwd(gb, fb, weights_of<__nv_bfloat16>(wptr, wstride), dyb,
                     dxb, wpb, dwp, dbp, dwo, dbo, L, scale, nblocks, P,
                     g_conv, g_dx, g_wgrad, s);
  return (int)err;
}

}  // namespace rdb_bwd_sm90
