// The f32 residual dense block (RDB) backward on Hopper (sm_90a), as
// 3xTF32 on the tensor cores, shared by csrc/rdb_bwd.cu (B2, the (B, H,
// W, 192) feature buffer) and csrc/rdb_ext.cu (B8, the row-extended (B,
// H + 2, W, 192) one): eight launches per block backward, one code path,
// so B8 equals B2 bit for bit on the data rows (every launch reads and
// writes image rows only, by image coordinates; DY's pad rows are zeroed
// and never read).
//
// What it computes is the TPU kernel's (torchsr_tpu/ops/pallas/rdb.py:495
// _rdb_bwd_kernel, :594 _rdb_bwd_kernel_ext) in f32, with its precision
// contract (rdb.py:538-577): products of f32 operands summed in f32, the
// cotangents dy_i kept unrounded in f32, dW, db and dx in f32.  Each f32
// product is taken as three TF32 ones (3xTF32, hopper.cuh tf32_split):
// a = hi + lo, and a.b = hi.lo + lo.hi + hi.hi in f32 accumulators, small
// terms first (ops/tf32.py TF32_TERMS: A is the operand split in
// registers, B the one read by descriptor as a hi and a lo plane).
//
// Data flow: the bf16 backward's (csrc/rdb_bwd_sm90.cuh:1-67), with no f32
// dense gradient in device memory.  Conv j's output slot (feat channels
// 64 + 32 j .. +32, j < 4) has the dense gradient of one 3x3 conv over
// the later cotangents, held in one f32 buffer DY = [dy_0 | ... | dy_4]
// (192 channels, feat's layout):
//
//   da_j = LReLU'(feat[:, slot j]) * conv3x3(DY[:, 32 (j + 1):], W'_j)
//
// W'_j[ky][kx][d][n] = K_k[2 - ky][2 - kx][64 + 32 j + n][co] for DY
// channel d of conv k's cotangent channel co: the later kernels, taps
// flipped, C_in <-> C_out.  The launches:
//
//  1. prep: dy_4 = scale * g into DY[:, 128:192] with per-block f32
//     partials of db_4 (blocks of image pixels, so that B8's equal B2's);
//     zeros over all 192 channels of the row-extended layout's pad rows;
//     the five HWIO kernels (f32, any strides: the caller's parameters as
//     they are) flipped, transposed and split once a call into TF32 hi and
//     lo planes (1.83 MiB), in the order and 128-byte swizzle in which the
//     conv CTAs stage them, as the f32 forward's prep does for its own.
//  2-5. slot_conv for j = 3, 2, 1, 0 (slots 3..0): the conv above, K =
//     DY's suffix from channel 32 (j + 1) (64 to 160 channels), N = 32.
//     Its epilogue takes LReLU' from feat's sign, stores da_j into DY as
//     dy_j (f32) and sums it into per-CTA partials of db_j.
//  6. slot_conv for dx (slots 4, 5, blockIdx.y): K = all of DY, N = feat's
//     first 64 channels as two 32-channel halves; dx = that + g.
//  7. wgrad: dW_i[ky][kx][ci][co] = sum_p feat[p + (ky-1, kx-1)][ci]
//     dy_i[p][co] for all five convs in one launch (below).
//  8. reduce: every dW and db from their f32 partials in a fixed order:
//     bit-equal from run to run, no atomics.
//
// slot_conv is the f32 forward's conv (csrc/rdb_fwd_tf32_sm90.cuh) with K
// moved to DY's suffix and another epilogue: the same persistent runs
// (rdb_mma.cuh FwdRuns: whole rows where W <= 64, else up to 94 pixels in
// a row), the same ring (its producer, rdb_fwd_tf32::produce: a TMA halo
// box of 32 DY channels and the chunk's hi and lo planes for the three ky
// a ring item), the same kx-packed m64n96k8 product per ky and 8
// channels (rdb_fwd_tf32::chunk_mma, each ky's chain added into f32 sums:
// the tensor core's sum over a long chain drifts, as measured there), the
// same row exchange of the epilogue (fwd_store_bounds, fwd_combine) with
// no bias.  The planes of a slot do not fit beside a halo (K up to 192
// channels x 9 taps x 32 x 2 planes x 4 B = 442 KB against 227 KB an SM):
// they stream, as the forward's.  A CTA adds its rows' da_j into one
// shared row per warp after each run (no atomics; the warp's lanes own
// its columns) and writes their sum at the end.
//
// wgrad.  B = DY^T has to be K-major for tf32 wgmma (pixel-contiguous
// rows of co), and ldmatrix cannot transpose 32-bit elements: a run's
// dy_i goes through registers, read, split and written transposed into a
// hi and a lo plane, as csrc/pair_conv.cu wgrad_tf32 stages g^T.  A =
// feat^T, the tap-shifted halo, by 32-bit loads from the run's rows in
// two 32-channel TMA boxes of feat (where W <= 64 a tap past a row end
// reads the next row's pixel and is zeroed in registers), split in
// registers.  The tiles and the partials' layout are the bf16 wgrad's
// (seven 64 x 64 tiles, rdb_bwd_sm90.cuh, 7.7% more products than dW
// needs), and so is the reduce.  Registers set the rest.  Each run's
// tensor-core chain is added into f32 sums (a CTA's share of 65,536
// pixels in one chain would be ~1,400 products; the forward's chains of
// 216 already drifted), so a warpgroup holds its accumulators twice; a
// warpgroup of three taps (bf16's: 3 x 32 accumulators) would need 192
// registers for them (a first version with three taps of N = 32 a
// warpgroup had its wgmmas serialized by ptxas, C7511).  So a CTA owns
// one tile and one ky (blockIdx.z), warpgroup kx tap (ky, kx): 64
// accumulator and sum registers, and the halo it stages is the run's
// rows shifted by ky - 1 (16 KB a box).  The boxes are double-buffered
// (run t + 2's fly during run t), run t + 1's DY is loaded into
// registers before run t's products are issued and split into the other
// DY^T buffer after them (193 KB of shared memory); the three ky CTAs of
// a tile each stage its DY^T.  ptxas also serializes the wgmmas (C7512)
// where the unrolled k loop has a data-dependent exit: wgrad_run's count
// is fixed per layout.  On an H100 this wgrad takes 0.75 ms at the
// training shape, 27% of its 0.205 ms bound, as did the first version
// and two between them (serialized or not, its loads overlapped or not):
// what holds it is not known.
//
// Bound on this card (H100 SXM) at the training shape (64, 32, 32, 64):
// dgrad and wgrad are 31.4 GFLOP each, 62.8 GFLOP; as three TF32
// products at the 495 TFLOP/s dense TF32 peak 0.381 ms (one f32 product
// at the 67 TFLOP/s FMA peak 0.938 ms); bytes (feat and g in, dx out)
// 84 MB in f32, 0.025 ms: bound by operations.
//
// Reckoned before the first call on the card: the slot convs and dx do
// the f32 forward's products (K 64..192, N = 32, and 192 x 64) through
// its machinery, which took 0.398 ms device at this shape (PERF.md); the
// wgrad's 0.205 ms of 3xTF32 bound (7.7% above its share) at 30-50% of
// it, 0.4-0.7 ms; prep and reduce ~0.03.  So a call's device time
// between 0.75 and 1.35 ms; the target is at most 0.5x the FFMA
// backward's device time in the same call.

#pragma once

#include "hopper.cuh"
#include "rdb_bwd_sm90.cuh"
#include "rdb_fwd_tf32_sm90.cuh"
#include "rdb_mma.cuh"

namespace rdb_bwd_tf32 {

namespace fwd = rdb_fwd_tf32;
namespace bwd = rdb_bwd_sm90;

using hopper::swz;
using rdb::Layout;
using rdb::load2;
using rdb::Run;
using rdb::store2;
using rdb::Weights;
using Runs = fwd::Runs;
using bwd::DW_TOTAL;

constexpr int FEAT = 192;  // feature buffer and DY width
constexpr int CH = 64;     // block input/output channels
constexpr int KC = fwd::KC;
constexpr int N = fwd::N;  // 3 kx x 32 output channels
constexpr int PLANE = fwd::PLANE;
constexpr int W_CHUNK = fwd::W_CHUNK;
constexpr int NSLOTS = 6;  // slots j = 0..3, then dx's two halves
constexpr int PREP_NT = 256;
constexpr int PREP_PIXELS = 256;  // image pixels of a prep block's db_4
constexpr int PAD_PIXELS = PREP_NT / 16;  // 16 threads a pad pixel
// wgrad: the slot convs' runs (at most RUN pixels), DY^T in 128-byte
// rows of 32 pixels; the bf16 backward's seven 64 x 64 tiles, a CTA one
// tile and one ky
constexpr int RUN = 128;
constexpr int GT_KB = CH * 128;                    // DY^T of 32 pixels
constexpr int GT_PLANE = (RUN / 32) * GT_KB;       // 32,768
constexpr int WGRAD_NT = 384;
constexpr int NTILES = bwd::NTILES;
constexpr int WGRAD_CTAS = 6;  // per tile and ky: 126 CTAs, one wave
// k steps of a run inside a row (at most WIDE_M - 2 pixels)
constexpr int WIDE_KSTEPS = fwd::WIDE_M / 8;

// Slot s's first DY channel, first feat channel of its outputs, K chunks
// of 32 channels and the offset (floats) of its planes in the prep's
// buffer.
__host__ __device__ constexpr int slot_k0(int s) {
  return s < 4 ? 32 * (s + 1) : 0;
}
__host__ __device__ constexpr int slot_ci0(int s) {
  return s < 4 ? 64 + 32 * s : 32 * (s - 4);
}
__host__ __device__ constexpr int slot_chunks(int s) {
  return (FEAT - slot_k0(s)) / KC;
}
__host__ __device__ constexpr int slot_wofs(int s) {
  int o = 0;
  for (int i = 0; i < s; ++i) o += slot_chunks(i) * (W_CHUNK / 4);
  return o;
}
constexpr int WPACK = slot_wofs(NSLOTS);  // 479,232 floats
constexpr int PACK_ITEMS = WPACK / 8;     // 4 hi and 4 lo floats each

// The wgrad's halo box for one ky: the run's rows (one row where W > 64)
// of box_w pixels, 32 channels; its bytes rounded up to a swizzle atom.
__host__ __device__ inline int wgrad_box_h(int W) {
  return Runs::box_h(W) - 2;
}
__host__ __device__ inline int wgrad_halo_bytes(int W) {
  return (Runs::box_w(W) * wgrad_box_h(W) * 128 + 1023) / 1024 * 1024;
}
// Dynamic shared memory of a wgrad CTA: slack, two DY^T stages (hi and
// lo planes), two halo stages of two 32-channel boxes.
inline size_t wgrad_smem(int W) {
  return 1024 + 4 * GT_PLANE + 4 * (size_t)wgrad_halo_bytes(W);
}

// ----------------------------------------------------------------- prep

// Blocks [0, nb_dy): dy_4 = scale g and db_4's partials over PREP_PIXELS
// image pixels each (16 threads a pixel, a float4 each); [nb_dy, nb_dy +
// nb_pad): zeros over the pad rows, PAD_PIXELS pad pixels a block; the
// rest: one pack item a thread, four consecutive k of one plane row,
// split.  Slot s, chunk c, tap ky: the hi plane at slot_wofs(s) + (3 c +
// ky) 2 PLANE / 4 floats, the lo plane PLANE / 4 after it; in each, row
// n' = kx * 32 + n and k at byte swz(n', k / 4) + 4 (k % 4), the weight
// W'[ky][kx][d][n] = K_k[2 - ky][2 - kx][slot_ci0(s) + n][co] for DY
// channel d = slot_k0(s) + 32 c + k (conv k's cotangent channel co).
__global__ void __launch_bounds__(PREP_NT)
rdb_bwd_tf32_prep(const float* __restrict__ g, float* __restrict__ dy,
                  float* __restrict__ db_part, int P, Layout L, float scale,
                  int nb_dy, int nb_pad, Weights<float> w,
                  float* __restrict__ wpack) {
  const int tid = threadIdx.x, blk = blockIdx.x;
  if (blk >= nb_dy + nb_pad) {
    int r = (blk - nb_dy - nb_pad) * PREP_NT + tid;
    if (r >= PACK_ITEMS) return;
    int s = 0;
    while (r >= slot_chunks(s) * 3 * N * 8) r -= slot_chunks(s++) * 3 * N * 8;
    const int c = r / (3 * N * 8), ky = r / (N * 8) % 3;
    const int n = r / 8 % N, k4 = r % 8;
    const int d = slot_k0(s) + KC * c + 4 * k4;
    const int k = d < 128 ? d / 32 : 4, co = d < 128 ? d % 32 : d - 128;
    const float* src = w.p[k] + (2 - ky) * w.s[k][0] +
                       (2 - n / 32) * w.s[k][1] +
                       (slot_ci0(s) + n % 32) * w.s[k][2] + co * w.s[k][3];
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      hopper::tf32_split(src[e * w.s[k][3]], hi[e], lo[e]);
    float* o = wpack + slot_wofs(s) + (3 * c + ky) * (2 * PLANE / 4) +
               swz(n, k4) / 4;
    *reinterpret_cast<uint4*>(o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(o + PLANE / 4) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
    return;
  }
  if (blk >= nb_dy) {  // pad pixel p: image p / (2 W), above (0) or below
    const long long p = (long long)(blk - nb_dy) * PAD_PIXELS + tid / 16;
    if (p >= (long long)L.B * 2 * L.W) return;
    const int q = tid % 16, xc = (int)(p % L.W);
    const int b = (int)(p / (2 * L.W)), y = (p / L.W) % 2 ? L.H : -1;
    float* d = dy + L.pix(b, y, xc) * FEAT;
#pragma unroll
    for (int k = 0; k < FEAT / 64; ++k)
      *reinterpret_cast<uint4*>(d + 4 * (q + 16 * k)) = make_uint4(0, 0, 0, 0);
    return;
  }

  __shared__ float red[PREP_NT / 16][CH];
  const int q = tid % 16, r = tid / 16;  // channels 4q..4q+3, pixel lane r
  const int npix = L.B * L.H * L.W;
  const int p1 = min((blk + 1) * PREP_PIXELS, npix);
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = blk * PREP_PIXELS + r; p < p1; p += PREP_NT / 16) {
    const int x = p % L.W, row = p / L.W;
    const float4 gv =
        *reinterpret_cast<const float4*>(g + (size_t)p * CH + 4 * q);
    const float4 a = make_float4(gv.x * scale, gv.y * scale, gv.z * scale,
                                 gv.w * scale);
    sum.x += a.x, sum.y += a.y, sum.z += a.z, sum.w += a.w;
    *reinterpret_cast<float4*>(
        dy + L.pix(row / L.H, row % L.H, x) * FEAT + 128 + 4 * q) = a;
  }
  red[r][4 * q] = sum.x;
  red[r][4 * q + 1] = sum.y;
  red[r][4 * q + 2] = sum.z;
  red[r][4 * q + 3] = sum.w;
  __syncthreads();
  if (tid < CH) {
    float total = 0.f;
    for (int k = 0; k < PREP_NT / 16; ++k) total += red[k][tid];
    db_part[((size_t)4 * P + blk) * CH + tid] = total;
  }
}

// ------------------------------------------------------------ slot conv

// Slot s = slot_base + blockIdx.y over gridDim.x persistent CTAs (see the
// header).  `dy_map` is DY's image rows as a (C, x, y, b) f32 tensor with
// the halo box; slots 0-3 store dy_s into DY's channels 32 s .. +32 (DY
// is read, channels >= slot_k0(s), and written through one buffer: the
// ranges do not meet) and f32 partials of db_s into db_part rows (s,
// blockIdx.x); slots 4, 5 store dx's channels 32 (s - 4) .. +32.  The
// ring holds `nst` stages.  Warpgroup 2 issues the loads (one thread, 40
// registers); warpgroups 0 and 1 take every run together, m-tile wg each.
__global__ void __launch_bounds__(fwd::CONV_NT, 1)
rdb_bwd_tf32_slot_conv(const __grid_constant__ CUtensorMap dy_map,
                       float* dy, const float* __restrict__ wpack,
                       const float* __restrict__ feat,
                       const float* __restrict__ g, float* __restrict__ dx,
                       float* __restrict__ db_part, int P, Layout L,
                       int slot_base, int nst) {
  extern __shared__ uint8_t smem_b[];
  // the epilogue's exchange, as the forward's
  __shared__ float bnd[2][8][32];
  // each consumer warp's db partial of this CTA's rows, by column
  __shared__ float red[8][32];
  __shared__ __align__(8) uint64_t full[fwd::MAX_STAGES],
      empty[fwd::MAX_STAGES];
  const int s = slot_base + blockIdx.y;
  const int nch = slot_chunks(s), ci0 = slot_ci0(s);
  uint8_t* x_s = hopper::align_1024(smem_b);  // [nst][halo | planes]
  const uint32_t x_u = hopper::smem_u32(x_s);
  const uint32_t f_u = hopper::smem_u32(full), e_u = hopper::smem_u32(empty);
  const int sb = fwd::stage_bytes(L.W), hbytes = fwd::halo_bytes(L.W);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = gridDim.x;
  const int runs = L.B * Runs::runs_per_image(L.H, L.W);
  const int nr = (int)blockIdx.x < runs ? (runs - 1 - blockIdx.x) / G + 1 : 0;

  if (tid == 0) fwd::init_ring(f_u, e_u, nst);
  __syncthreads();  // the barriers are initialised

  if (warp >= 8) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0)
      fwd::produce(&dy_map, wpack + slot_wofs(s), slot_k0(s), nch, nr, nst,
                   L, x_u, f_u, e_u);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // warp-uniform to the compiler, as in the forward
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  const int q = __shfl_sync(0xffffffffu, warp % 4, 0);
  const int gq = lane / 4, tq = lane % 4, T = 4 * wg + q;
  const float nobias[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  auto consumers_sync = [&]() {  // both warpgroups (named barrier 1)
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  };
  if (gq == 0) {
#pragma unroll
    for (int k2 = 0; k2 < 8; ++k2) red[T][8 * (k2 / 2) + 2 * tq + k2 % 2] = 0.f;
  }

  float sum[48], acc[48];
#pragma unroll
  for (int e = 0; e < 48; ++e) acc[e] = 0.f;
  for (int k = 0; k < nr; ++k) {  // the CTA's runs
    const Run r = Runs::run_of(blockIdx.x + k * G, L.H, L.W);
    const int ny = r.n + 2 * r.e;     // y rows
    const bool mine = ny > 64 * wg;   // this warpgroup's m-tile has rows
    const int hb = min(64 * wg + 16 * q + lane % 16, ny - 1);
#pragma unroll
    for (int e = 0; e < 48; ++e) sum[e] = 0.f;
    for (int c = 0; c < nch; ++c) {
      const int i = k * nch + c, st = i % nst;
      hopper::mbar_wait(f_u + 8 * st, (i / nst) & 1);
      if (mine)
        fwd::chunk_mma(sum, acc, x_s + st * sb, hb, r.hw,
                       x_u + st * sb + hbytes, lane);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(e_u + 8 * st);  // the stage is free
    }

    // the forward's epilogue exchange (rdb_mma.cuh), no bias
    consumers_sync();  // the previous run's epilogue has read bnd
    rdb::fwd_store_bounds(sum, bnd[0], bnd[1], T, gq, tq);
    consumers_sync();
    float dsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * T + gq + 8 * h;  // y row; output row m - e
      float v[8];
      rdb::fwd_combine(sum, bnd[0], bnd[1], T, h, gq, tq, lane,
                       (r.p0 + m - r.e) % L.W, L.W, nobias, v);
      const int row = m - r.e;
      if (row < 0 || row >= r.n) continue;  // not an output row
      const int p = r.p0 + row, py = p / L.W, px = p % L.W;
      if (s < 4) {
        const size_t o = L.pix(r.b, py, px) * FEAT;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ch = 8 * j + 2 * tq;
          const float2 f = load2(feat + o + ci0 + ch);
          const float d0 = v[2 * j] * (f.x > 0.f ? 1.f : 0.2f);
          const float d1 = v[2 * j + 1] * (f.y > 0.f ? 1.f : 0.2f);
          store2(dy + o + 32 * s + ch, d0, d1);
          dsum[2 * j] += d0;
          dsum[2 * j + 1] += d1;
        }
      } else {  // dx = the conv + g
        const size_t o = L.dense(r.b, py, px) * CH + ci0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ch = 8 * j + 2 * tq;
          const float2 gv = load2(g + o + ch);
          store2(dx + o + ch, v[2 * j] + gv.x, v[2 * j + 1] + gv.y);
        }
      }
    }
    if (s < 4) {  // the run's rows of each column, into the warp's row
#pragma unroll
      for (int k2 = 0; k2 < 8; ++k2) {
        dsum[k2] += __shfl_xor_sync(0xffffffffu, dsum[k2], 4);
        dsum[k2] += __shfl_xor_sync(0xffffffffu, dsum[k2], 8);
        dsum[k2] += __shfl_xor_sync(0xffffffffu, dsum[k2], 16);
      }
      if (gq == 0) {
#pragma unroll
        for (int k2 = 0; k2 < 8; ++k2)
          red[T][8 * (k2 / 2) + 2 * tq + k2 % 2] += dsum[k2];
      }
    }
  }

  if (s < 4) {  // db_s: the eight warps' rows, in order
    consumers_sync();
    if (tid < 32) {
      float total = 0.f;
      for (int t = 0; t < 8; ++t) total += red[t][tid];
      db_part[((size_t)s * P + blockIdx.x) * CH + tid] = total;
    }
  }
}

// ---------------------------------------------------------------- wgrad

// The wgrad's B for run r (DY channels d_lo .. +31, then d_hi .. +31;
// zeros past n): the thread's float4 of DY, item i = tid + WGRAD_NT k of
// 8 pixels x 4 float4 a warp step (px = (i & 7) + 8 (i >> 7), column 4
// ((i >> 3) & 15) ..+3), loaded before the previous run's products are
// issued ...
constexpr int DY_ITEMS = (RUN * CH / 4 + WGRAD_NT - 1) / WGRAD_NT;  // 6
__device__ __forceinline__ void load_dy(const float* __restrict__ dy,
                                        const Layout& L, const Run& r,
                                        int d_lo, int d_hi, int tid,
                                        float4 (&v)[DY_ITEMS]) {
  const float* base = dy + (L.pix(r.b, 0, 0) + r.p0) * FEAT;
#pragma unroll
  for (int k = 0; k < DY_ITEMS; ++k) {
    const int i = tid + WGRAD_NT * k;
    const int px = (i & 7) + 8 * (i >> 7), c4 = (i >> 3) & 15;
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < RUN * CH / 4 && px < r.n)
      v[k] = *reinterpret_cast<const float4*>(
          base + (size_t)px * FEAT + (c4 < 8 ? d_lo : d_hi - 32) + 4 * c4);
  }
}

// ... and split into the hi and lo planes at gt after them, transposed:
// element (column co, px) at (px / 32) GT_KB + swz(co, (px % 32) / 4) + 4
// (px % 4), lo GT_PLANE further.
__device__ __forceinline__ void store_dyt(const float4 (&v)[DY_ITEMS],
                                          uint8_t* gt, int tid) {
#pragma unroll
  for (int k = 0; k < DY_ITEMS; ++k) {
    const int i = tid + WGRAD_NT * k;
    if (i >= RUN * CH / 4) break;
    const int px = (i & 7) + 8 * (i >> 7), c4 = (i >> 3) & 15;
    const float e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
    uint8_t* p = gt + (px / 32) * GT_KB + 4 * (px % 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t hi, lo;
      hopper::tf32_split(e[j], hi, lo);
      const uint32_t o = swz(4 * c4 + j, (px % 32) / 4);
      *reinterpret_cast<uint32_t*>(p + o) = hi;
      *reinterpret_cast<uint32_t*>(p + GT_PLANE + o) = lo;
    }
  }
}

// f32 at channel c (0..31) of box pixel px of a 32-channel halo box (rows
// of 128 bytes in the 128-byte swizzle, as TMA writes it).
__device__ __forceinline__ uint32_t box_word(const uint8_t* box, int px,
                                             int c) {
  return *reinterpret_cast<const uint32_t*>(
      box + swz(px, c >> 2) + 4 * (c & 3));
}

// One run's products of tap (ky, kx) for the warpgroup: NKS k steps of 8
// pixels, A = feat^T from the run's box at xh ((channel, pixel) = (c, t),
// (c + 8, t), (c, t + 4), (c + 8, t + 4); pixels past n read pixel n - 1,
// times DY^T's zeros), split in registers, B = DY^T's planes at gs; one
// group a k step.  The k steps are a fixed count: a data-dependent exit
// from the unrolled loop makes ptxas serialize the wgmmas (C7512).
template <int NKS>
__device__ __forceinline__ void wgrad_run(float (&acc)[32], const uint8_t* xh,
                                          uint32_t gs, const Run& r, int W,
                                          int kx, int c, int tq) {
  const bool narrow = r.e == 0;  // taps past a row end read zeros
  uint32_t a[2][2][4];           // [ks % 2][hi, lo]
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const int k0 = min(8 * ks + tq, r.n - 1);
    const int k1 = min(8 * ks + tq + 4, r.n - 1);
    const int p0 = max(k0 + r.e + kx - 1, 0);
    const int p1 = max(k1 + r.e + kx - 1, 0);
    uint32_t raw[4] = {box_word(xh, p0, c), box_word(xh, p0, c + 8),
                       box_word(xh, p1, c), box_word(xh, p1, c + 8)};
    if (narrow && kx != 1) {
      const int edge = kx == 0 ? 0 : W - 1;
      if (k0 % W == edge) raw[0] = raw[1] = 0u;
      if (k1 % W == edge) raw[2] = raw[3] = 0u;
    }
    if (ks >= 2) hopper::wgmma_wait<1>();  // ks - 2 read a[ks % 2]
    hopper::tf32_split(raw, a[ks % 2][0], a[ks % 2][1]);
    hopper::wgmma_fence();
    const uint32_t b = gs + (ks / 4) * GT_KB + (ks % 4) * 32;
    hopper::wgmma_m64n64k8_tf32(acc, a[ks % 2][0],
                                hopper::desc_sw128(b + GT_PLANE));
    hopper::wgmma_m64n64k8_tf32(acc, a[ks % 2][1], hopper::desc_sw128(b));
    hopper::wgmma_m64n64k8_tf32(acc, a[ks % 2][0], hopper::desc_sw128(b));
    hopper::wgmma_commit();
  }
}

// part[blockIdx.y * gridDim.x + blockIdx.x]: the (9, 64, 64) f32 partial
// of tile blockIdx.y (rdb_bwd_sm90.cuh tile_bases: feat channels f_lo ..
// +31 | f_hi .. +31 x DY channels d_lo .. +31 | d_hi .. +31) over runs
// blockIdx.x, blockIdx.x + gridDim.x, ... (the slot convs' runs), of
// which this CTA writes taps (ky, 0..2) for ky = blockIdx.z: warpgroup
// kx owns tap (ky, kx), warp wq of it rows 16 wq .. +15; M = 64, N = 64,
// K = 8 pixels a wgmma m64n64k8, three products a k step; the
// accumulators are added into f32 sums after every run.  A run's halo is
// its rows shifted by ky - 1, two 32-channel TMA boxes of feat
// (`feat_map`: rows outside the image zero; where W <= 64 a tap past a
// row end reads the next row's pixel and is zeroed in registers),
// double-buffered: run t + 2's boxes fly during run t.  Run t + 1's DY is
// loaded into registers before run t's products are issued and split
// into the other DY^T buffer after them.
__global__ void __launch_bounds__(WGRAD_NT, 1)
rdb_bwd_tf32_wgrad(const __grid_constant__ CUtensorMap feat_map,
                   const float* __restrict__ dy, float* __restrict__ part,
                   Layout L) {
  extern __shared__ uint8_t smem_w[];
  __shared__ __align__(8) uint64_t full[2];  // a stage's boxes landed
  uint8_t* gt = hopper::align_1024(smem_w);  // [2][hi | lo][4][64][128 B]
  const int hbytes = wgrad_halo_bytes(L.W);
  uint8_t* xs = gt + 4 * GT_PLANE;           // [2][2 halves][hbytes]
  const uint32_t gt_u = hopper::smem_u32(gt), xs_u = hopper::smem_u32(xs);
  const uint32_t f_u = hopper::smem_u32(full);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kx = warp / 4, wq = warp % 4, ky = blockIdx.z;
  const int c = 16 * (wq % 2) + lane / 4, tq = lane % 4;  // A's channel
  const int ci = 16 * wq + lane / 4;  // the tile row of the accumulators
  const int G = gridDim.x;
  const int runs = L.B * Runs::runs_per_image(L.H, L.W);
  int f_lo, f_hi, d_lo, d_hi;
  bwd::tile_bases(blockIdx.y, f_lo, f_hi, d_lo, d_hi);
  const int box = Runs::box_w(L.W) * wgrad_box_h(L.W) * fwd::ROW;

  auto load_halo = [&](int t, int st) {  // one thread
    const Run r = Runs::run_of(t, L.H, L.W);
    const uint32_t bar = f_u + 8 * st, dst = xs_u + 2 * st * hbytes;
    hopper::mbar_expect_tx(bar, 2 * box);
    hopper::tma_load_4d(dst, &feat_map, bar, f_lo, r.hx0, r.r0 - 1 + ky,
                        r.b);
    hopper::tma_load_4d(dst + hbytes, &feat_map, bar, f_hi, r.hx0,
                        r.r0 - 1 + ky, r.b);
  };
  int t = blockIdx.x;
  if (tid == 0) {
    hopper::mbar_init(f_u, 1);
    hopper::mbar_init(f_u + 8, 1);
    hopper::mbar_init_fence();
    if (t < runs) load_halo(t, 0);
    if (t + G < runs) load_halo(t + G, 1);
  }
  float4 v[DY_ITEMS];
  if (t < runs) {
    load_dy(dy, L, Runs::run_of(t, L.H, L.W), d_lo, d_hi, tid, v);
    store_dyt(v, gt, tid);
  }
  hopper::fence_proxy_async();  // DY^T, for wgmma's reads
  __syncthreads();              // and the barriers are initialised

  float acc[32], sum[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = sum[e] = 0.f;

  for (int i = 0; t < runs; t += G, ++i) {
    const int st = i & 1;
    const Run r = Runs::run_of(t, L.H, L.W);
    const bool next = t + G < runs;
    if (next)
      load_dy(dy, L, Runs::run_of(t + G, L.H, L.W), d_lo, d_hi, tid, v);
    hopper::mbar_wait(f_u + 8 * st, (i >> 1) & 1);  // run t's boxes

    hopper::fence_operands(acc);
    const uint8_t* xh = xs + (2 * st + wq / 2) * hbytes;  // c's box
    const uint32_t gs = gt_u + st * 2 * GT_PLANE;
    if (L.W <= fwd::NARROW_W)  // uniform: no wgmma in a divergent path
      wgrad_run<RUN / 8>(acc, xh, gs, r, L.W, kx, c, tq);
    else
      wgrad_run<WIDE_KSTEPS>(acc, xh, gs, r, L.W, kx, c, tq);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sum[e] += acc[e];
      acc[e] = 0.f;
    }
    // run t + 1's DY^T into the other buffer
    if (next) store_dyt(v, gt + (st ^ 1) * 2 * GT_PLANE, tid);
    hopper::fence_proxy_async();  // DY^T, for wgmma's reads
    __syncthreads();  // stage st consumed; the next DY^T in place
    if (tid == 0 && t + 2 * G < runs) load_halo(t + 2 * G, st);
  }

  // rows (tile rows) 16 wq + lane / 4 (+ 8), columns 8 j + 2 (lane % 4)
  // (+ 1) of tap 3 ky + kx
  float* o = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 9 * CH *
                        CH +
             ((size_t)(3 * ky + kx) * CH + ci) * CH + 2 * tq;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    store2(o + 8 * j, sum[4 * j], sum[4 * j + 1]);
    store2(o + 8 * CH + 8 * j, sum[4 * j + 2], sum[4 * j + 3]);
  }
}

// --------------------------------------------------------------- reduce

// dw (flat: conv i's HWIO at bwd::dw_ofs(i)) and db (conv i's at 32 i)
// from the wgrad's G partials of each tile and the db partials (n_slot
// rows for convs 0-3, n_prep for conv 4), each a sum in a fixed order:
// the bf16 backward's reduce (its tiles and layout).
__global__ void __launch_bounds__(256)
rdb_bwd_tf32_reduce(const float* __restrict__ part, int G,
                    const float* __restrict__ db_part, int P, int n_slot,
                    int n_prep, float* __restrict__ dw,
                    float* __restrict__ db) {
  bwd::reduce_partials_of(part, G, db_part, P, n_slot, n_prep, dw, db);
}

// ------------------------------------------------------------- launches

// Blocks of the prep's pad-row zeroing in layout L.
inline int pad_blocks(const Layout& L) {
  const long long npad = L.HP > L.H ? (long long)L.B * 2 * L.W : 0;
  return (int)((npad + PAD_PIXELS - 1) / PAD_PIXELS);
}

// The eight launches of one f32 block backward on `stream`; returns the
// first launch's error (0 on success).  Grids: g_conv CTAs for each slot
// conv, (g_dx, 2) for dx, (g_wgrad, NTILES, 3) for the wgrad, nb_dy blocks
// of db_4 partials; P >= nb_dy, g_conv rows of db partials a conv (ops/
// rdb.py bwd_tf32_schedule mirrors them and sizes the buffers).  DY's
// map covers its image rows only.
inline cudaError_t launch_bwd(const float* g, const float* feat,
                              const Weights<float>& w, float* dy, float* dx,
                              float* wpack, float* dw_part, float* db_part,
                              float* dw, float* db, Layout L, float scale,
                              int nb_dy, int P, int g_conv, int g_dx,
                              int g_wgrad, cudaStream_t s) {
  cudaError_t err;
  const int nb_pad = pad_blocks(L);
  const int pack_blocks = (PACK_ITEMS + PREP_NT - 1) / PREP_NT;
  rdb_bwd_tf32_prep<<<nb_dy + nb_pad + pack_blocks, PREP_NT, 0, s>>>(
      g, dy, db_part, P, L, scale, nb_dy, nb_pad, w, wpack);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int W = L.W;
  CUtensorMap dy_map;
  if (!hopper::tensor_map(&dy_map, dy + (size_t)L.Y0 * W * FEAT, FEAT, W,
                          L.H, L.B, (long long)L.HP * W, KC, Runs::box_w(W),
                          Runs::box_h(W), CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return cudaErrorInvalidValue;
  if (fwd::stages(W) < 2) return cudaErrorInvalidValue;
  if ((err = rdb::allow_smem(rdb_bwd_tf32_slot_conv, fwd::SMEM_DYN)) !=
      cudaSuccess)
    return err;
  const size_t csmem = fwd::conv_smem(W);
  for (int j = 3; j >= 0; --j) {
    rdb_bwd_tf32_slot_conv<<<g_conv, fwd::CONV_NT, csmem, s>>>(
        dy_map, dy, wpack, feat, g, dx, db_part, P, L, j, fwd::stages(W));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  rdb_bwd_tf32_slot_conv<<<dim3(g_dx, 2), fwd::CONV_NT, csmem, s>>>(
      dy_map, dy, wpack, feat, g, dx, db_part, P, L, 4, fwd::stages(W));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  CUtensorMap feat_map;
  if (!hopper::tensor_map(&feat_map, feat + (size_t)L.Y0 * W * FEAT, FEAT,
                          W, L.H, L.B, (long long)L.HP * W, KC,
                          Runs::box_w(W), wgrad_box_h(W),
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return cudaErrorInvalidValue;
  const size_t wsmem = wgrad_smem(W);
  if ((err = rdb::allow_smem(rdb_bwd_tf32_wgrad, wsmem)) != cudaSuccess)
    return err;
  rdb_bwd_tf32_wgrad<<<dim3(g_wgrad, NTILES, 3), WGRAD_NT, wsmem, s>>>(
      feat_map, dy, dw_part, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  rdb_bwd_tf32_reduce<<<(DW_TOTAL + FEAT + 255) / 256, 256, 0, s>>>(
      dw_part, g_wgrad, db_part, P, g_conv, nb_dy, dw, db);
  return cudaGetLastError();
}

// The C entry's body: the five kernels come as f32 pointers and (ky, kx,
// ci, co) element strides; `padded` selects the row-extended layout.
inline int launch_bwd_entry(const void* g, const void* feat,
                            const void* const* wptr, const long long* wstride,
                            void* dy, void* dx, void* wpack, void* dw_part,
                            void* db_part, void* dw, void* db, int B, int H,
                            int W, int padded, float scale, int nb_dy, int P,
                            int g_conv, int g_dx, int g_wgrad, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Layout L{B, H, W, padded ? H + 2 : H, padded ? 1 : 0};
  return (int)launch_bwd(
      static_cast<const float*>(g), static_cast<const float*>(feat),
      rdb::weights_of<float>(wptr, wstride), static_cast<float*>(dy),
      static_cast<float*>(dx), static_cast<float*>(wpack),
      static_cast<float*>(dw_part), static_cast<float*>(db_part),
      static_cast<float*>(dw), static_cast<float*>(db), L, scale, nb_dy, P,
      g_conv, g_dx, g_wgrad, static_cast<cudaStream_t>(stream));
}

// The schedule launch_bwd runs at (B, H, W) with the grids ops/rdb.py
// gives it, into out[SCHEDULE_INTS]: the slot convs' runs, CTAs of each
// slot conv and of each of dx's halves, the halo box (w, h pixels), the
// stage and its halo (bytes), the ring's stages and the slot conv's
// dynamic shared memory (bytes); the wgrad's CTAs of each tile (on the
// same runs) and dynamic shared memory (bytes).
constexpr int SCHEDULE_INTS = 11;
inline void bwd_schedule_of(int B, int H, int W, int* out) {
  out[0] = B * Runs::runs_per_image(H, W);
  out[1] = Runs::slot_ctas(0, B, H, W);
  out[2] = Runs::slot_ctas(4, B, H, W);
  out[3] = Runs::box_w(W);
  out[4] = Runs::box_h(W);
  out[5] = fwd::stage_bytes(W);
  out[6] = fwd::halo_bytes(W);
  out[7] = fwd::stages(W);
  out[8] = (int)fwd::conv_smem(W);
  out[9] = out[0] < WGRAD_CTAS ? out[0] : WGRAD_CTAS;
  out[10] = (int)wgrad_smem(W);
}

}  // namespace rdb_bwd_tf32
