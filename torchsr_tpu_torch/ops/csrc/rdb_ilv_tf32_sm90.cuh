// The f32 residual dense block (RDB) forward on the chunk-interleaved
// buffer (B6) on Hopper (sm_90a), as 3xTF32 on the tensor cores: six
// launches per block forward (csrc/rdb_ilv.cu's f32 entry).
//
// What it computes is the TPU kernel's (torchsr_tpu/ops/pallas/rdb.py:223
// _rdb_fwd_kernel_ilv, weights by _repack_ilv :291) in f32, on the layout
// csrc/rdb_ilv.cu describes: the (M, 576) buffer of M = B*H*W pixels
// whose 32-channel chunk j holds [up | mid | dn] in columns 96 j ..
// 96 j + 95, conv i one product of the prefix buf[:, :3 C_in] with the
// repack_ilv weight (rows (chunk, dy, ci), columns (dx, co)), the three
// horizontal taps reduced on the results with the column masks, the
// bias, LeakyReLU(0.2) on convs 1-4, x + scale * conv5.  Each f32
// product is taken as three TF32 ones (hopper.cuh tf32_split): a = hi +
// lo, and a.b = hi.lo + lo.hi + hi.hi, small terms first (ops/tf32.py
// TF32_TERMS); sums in f32; nothing rounded on store.  A, the prefix, is
// split in registers; B, the weights, is read by descriptor as a hi and
// a lo plane (tf32 wgmma reads B K-major only).  ops/rdb.py
// rdb_ilv_3xtf32_reference is this arithmetic in plain PyTorch.
//
//  1. prep: x's two chunks, three copies each (each 16-byte word of x
//     read once; zeros at the image edges); zeros over the up slots of
//     chunks 2-5 on the buffer's first W rows and their dn slots on its
//     last W rows (the slots no conv's store reaches); the five HWIO
//     kernels (f32, any strides: the caller's parameters as they are)
//     split once a call into TF32 hi and lo planes.  A K stage of 32
//     prefix columns is one (chunk, dy) of the repack_ilv order, so the
//     planes are those of the f32 slot forward (rdb_fwd_tf32::pack_item):
//     stage kk of slot s is that forward's (chunk kk / 3, ky kk % 3),
//     96 rows (dx * 32 + co) of 32 K values in the 128-byte swizzle.
//  2-6. conv i (conv 5 as two N = 96 halves of 32 output channels, grid
//     y).  A run is bf16's: 128 consecutive buffer rows m0 - 1 .. m0 +
//     126 (m0 = 126 t), its 126 outputs m0 .. m0 + 125 with one halo
//     pixel at each end for the dx taps, the column masks from m mod W.
//     In f32 a 128-byte swizzled row holds 32 columns, so a K stage is
//     one TMA box of 32 columns (128 rows, zeros past the buffer's ends),
//     a third of a chunk; a ring item is one K stage of one run: its box
//     (16 KB) and the stage's hi and lo planes (two bulk copies of 12
//     KB), both completing one mbarrier.  Warpgroup 2 (one thread, 40
//     registers) issues the items; warpgroups 0 and 1 (232 registers)
//     take every run of the CTA together, one m-tile of 64 rows each,
//     from the same items: per stage two groups of two k steps, A by
//     ldmatrix (the tf32 fragment from rows of f32), split, then per k
//     step hi.lo, lo.hi, hi.hi (wgmma m64n96k8).
//
// The weights stream.  bf16 B6 stages a slot's packed weights once per
// CTA (conv 4: 90 KB); as hi and lo planes they are 4x that (conv 4 369
// KB, each half of conv 5 442 KB) against an SM's 227 KB, so they come
// with the boxes, a stage at a time.  Reckoned at the serving shape
// (16, 64, 64, 64; 521 runs): all slots' planes are 1.92 MB, so one
// read a run is 1.0 GB from L2 a call, beside 0.65 GB of boxes.  Both
// consumer warpgroups share each stage (one m-tile each), so that the
// planes are read once a run and not once a warpgroup (2.0 GB).  Longer
// runs would share them over more rows, but do not fit the registers: a
// warpgroup holds its m-tile's tensor-core accumulator and its f32 sums
// (96 registers, below), and two m-tiles would need 192 of the 168 a
// thread of a 384-thread CTA is compiled to (the f32 slot forward
// already spills 24 bytes at one); a third consumer warpgroup would cut
// that to 128.  A cluster of two CTAs sharing each stage's planes by
// TMA multicast would halve the 1.0 GB, at the cost of stages freed only
// when both CTAs' consumers release them: not built.  The f32 slot
// forward read 0.98 GB of planes from L2 at 0.3785 ms a call, and loading
// them once made it under 2% faster (PERF.md; NVIDIA H100 80GB HBM3 at
// 700 W): L2 was not its limit.
//
// Accuracy sets the accumulation, as in the f32 slot forward: the tensor
// core's sum over a long chain drifts (there, one chain per output over
// all of C_in read 0.64 of the f32 limit).  Here K is ordered (chunk,
// dy, ci), so one chunk's chain (three stages, K = 96, 288 products an
// output) is added into f32 sums and cleared; rdb_ilv_3xtf32_reference
// sums the same chains in the same order.
//
// The epilogue: the tap reduction by shuffles and the exchange of
// boundary rows (rdb_mma.cuh fwd_store_bounds, fwd_combine), the bias,
// the activation; then each value stored from the registers, as the f32
// slot forward stores them: mid at m, the up copy at m + W (zero from an
// image's last row) and the dn copy at m - W (zero from its first row),
// each only where it lies in the buffer; conv 5 stores x + scale * out.
// Every element has exactly one writer, and conv i writes only chunk
// 2 + i and reads only chunks below it: no CTA waits on another.  (bf16
// B6 stores its tile with TMA boxes; in f32 the tile of one run would
// take 16 KB of the ring's shared memory, and a store from the registers
// needs no box that starts inside the buffer.)
//
// Bound on this card (H100 SXM) at the serving shape: 31.4 GFLOP, as
// three TF32 products at the 495 TFLOP/s dense TF32 peak 0.190 ms (one
// f32 product at the 67 TFLOP/s FMA peak 0.469 ms).  The layout's own
// bytes in f32: the buffer (65,536 x 576 x 4 B = 151 MB) written once,
// the five convs' prefixes read (3 (64 + 96 + 128 + 160 + 192) x 4 B a
// pixel, 503 MB), conv 5's second half reading its 151 MB prefix again,
// x in and out 34 MB: 0.69-0.84 GB, 0.21-0.25 ms at 3.35 TB/s where
// nothing stays in the 50 MB L2.  So the layout's bytes, not the tensor
// cores, set the floor, though the two are close.
//
// Prediction of record (before the first call on the card), device time
// a call at (16, 64, 64, 64), on an NVIDIA H100 80GB HBM3 at 700 W: the
// f32 slot forward took 0.3785 ms there (50% of its bound) with items of
// 104 KB a 7.1 MFLOP; an item here is 40 KB
// a 2.4 MFLOP (16% more bytes into shared memory a product, a barrier
// round trip a third as many products apart), and its boxes come from
// HBM (the 151 MB buffer does not stay in L2).  So about 1.25x its
// convs: prep 0.025, convs 0.053 / 0.060 / 0.072 / 0.085 / 0.200 ms,
// 0.50 ms in all, in a band of 0.45-0.65 ms; the target is at most 0.5x
// the FFMA kernels' device time in the same call (~0.78 ms).
// Measured there (tools/bench_rdb.py beside the FFMA kernels): 0.377 ms,
// prep 0.023, convs 0.039 / 0.049 / 0.057 / 0.068 / 0.141, against the
// FFMA kernels' 1.574 (0.24x); under the band, level with the f32 slot
// forward.  Launches read 0.82-1.29x the emulation's worst excess (the
// same products and chains summed in f32); chains of a K stage or of
// two k steps read 0.82-1.10x in 11-27% more time: the chunk was kept.

#pragma once

#include "hopper.cuh"
#include "rdb_fwd_tf32_sm90.cuh"
#include "rdb_mma.cuh"

namespace ilv_tf32 {

using hopper::swz;
using rdb::Weights;

constexpr int CH = 64;             // block input/output channels
constexpr int G = 32;              // growth: channels a chunk
constexpr int STRIDE = 3 * G;      // columns a chunk: [up | mid | dn]
constexpr int ILV = 6 * STRIDE;    // 576 buffer columns
constexpr int RUN = 128;           // rows of a run: two m-tiles of 64
constexpr int OUTS = RUN - 2;      // its outputs: one halo pixel each side
constexpr int KC = 32;             // prefix columns of a K stage
constexpr int ROW = 128;           // bytes of a row of a K stage
constexpr int N = 96;              // 3 dx x 32 output channels
constexpr int PLANE = N * ROW;     // one stage's hi or lo plane: 12,288
constexpr int A_ST = RUN * ROW;    // one stage's box: 16,384
constexpr int STAGE = A_ST + 2 * PLANE;  // a ring item: 40,960
constexpr int NSLOTS = 6;          // convs 1-4, then conv 5's two halves
// two warpgroups that multiply, one whose first thread issues the loads
constexpr int CONV_NT = 384;
constexpr int MAX_STAGES = 8;
constexpr int CTAS = 132;          // persistent CTAs of convs 1-4
// Dynamic shared memory of a conv CTA: the H100's 227 KB less the static
// exchange of the epilogues' boundary rows (2 KB) and the ring's
// mbarriers, as the f32 slot forward reckons it.
constexpr int SMEM_DYN = 232448 - 4352;
constexpr int PREP_NT = 256;
// K stages an accumulation chain: a chunk's three (its up, mid and dn),
// added into the f32 sums when it ends.
constexpr int CHAIN = 3;
constexpr int X_WORDS = CH / 4;    // 16-byte words of x at a pixel
constexpr int Z_WORDS = 4 * G / 4; // of chunks 2-5's up (or dn) slots

// Slot s's conv, input channels, first output channel and K stages
// (3 C_in / 32: 6, 9, 12, 15, 18, 18), and the offset (floats) of its
// planes in the prep's buffer (the f32 slot forward's).
__host__ __device__ constexpr int slot_conv(int s) { return s < 4 ? s : 4; }
__host__ __device__ constexpr int slot_cin(int s) {
  return 64 + 32 * slot_conv(s);
}
__host__ __device__ constexpr int slot_co0(int s) { return s == 5 ? 32 : 0; }
__host__ __device__ constexpr int slot_kst(int s) {
  return 3 * slot_cin(s) / KC;
}
using rdb_fwd_tf32::PACK_ITEMS;
using rdb_fwd_tf32::slot_wofs;
using rdb_fwd_tf32::WPACK;
static_assert(rdb_fwd_tf32::PLANE == PLANE && rdb_fwd_tf32::N == N,
              "the planes are the f32 slot forward's");

// Runs of M pixels; ring stages (as many as fit, at most MAX_STAGES: 5);
// a conv's dynamic shared memory; its persistent CTAs (conv 5's halves
// half as many each, in its grid's y).
__host__ __device__ inline int runs_of(int M) { return (M + OUTS - 1) / OUTS; }
__host__ __device__ constexpr int stages() {
  return (SMEM_DYN - 1024) / STAGE < MAX_STAGES ? (SMEM_DYN - 1024) / STAGE
                                                : MAX_STAGES;
}
constexpr int conv_smem() { return 1024 + stages() * STAGE; }
inline int slot_ctas(int s, int M) {
  const int runs = runs_of(M), cap = s < 4 ? CTAS : CTAS / 2;
  return runs < 1 ? 1 : runs < cap ? runs : cap;
}

// ----------------------------------------------------------------- prep

// Blocks [0, xblocks): x's chunks 0 and 1, one 16-byte word of x a
// thread, stored as mid at m, up at m + W and dn at m - W (zeros past an
// image's top and bottom); [xblocks, xblocks + zblocks): zeros over the
// up slots of chunks 2-5 on the buffer's first W rows and their dn slots
// on its last W rows; the rest: one pack item of the planes a thread.
__global__ void __launch_bounds__(PREP_NT)
rdb_fwd_ilv_tf32_prep(const float* __restrict__ x, float* __restrict__ buf,
                      Weights<float> w, float* __restrict__ wpack, int M,
                      int H, int W, int xblocks, int zblocks) {
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  if (blk < xblocks) {  // word q of x at pixel m
    const long long e = (long long)blk * PREP_NT + tid;
    if (e >= (long long)M * X_WORDS) return;
    const int m = (int)(e / X_WORDS), q = (int)(e % X_WORDS);
    const int y = m / W % H;
    const uint4 v =
        *reinterpret_cast<const uint4*>(x + (size_t)m * CH + 4 * q);
    float* at = buf + (size_t)m * ILV + STRIDE * (q / 8) + 4 * (q % 8);
    *reinterpret_cast<uint4*>(at + G) = v;
    if (y < H - 1) *reinterpret_cast<uint4*>(at + (size_t)W * ILV) = v;
    else *reinterpret_cast<uint4*>(at + 2 * G) = zero;  // the last row's dn
    if (y > 0) *reinterpret_cast<uint4*>(at - (size_t)W * ILV + 2 * G) = v;
    else *reinterpret_cast<uint4*>(at) = zero;  // the first row's up
    return;
  }
  blk -= xblocks;
  if (blk < zblocks) {  // row r < W: up; r >= W: dn of row M - 2 W + r
    const int e = blk * PREP_NT + tid;
    if (e >= 2 * W * Z_WORDS) return;
    const int r = e / Z_WORDS, q = e % Z_WORDS, c = 2 + q / 8;
    const size_t m = r < W ? (size_t)r : (size_t)M - 2 * W + r;
    *reinterpret_cast<uint4*>(buf + m * ILV + STRIDE * c +
                              (r < W ? 0 : 2 * G) + 4 * (q % 8)) = zero;
    return;
  }
  const int r = (blk - zblocks) * PREP_NT + tid;
  if (r < PACK_ITEMS) rdb_fwd_tf32::pack_item(r, w, wpack);
}

// ----------------------------------------------------------------- conv

// One K stage (32 prefix columns, four k steps of 8) for the warpgroup's
// m-tile, the box at `xs` (the lane's A row `row`), the stage's planes at
// shared address `wc` ([hi, lo][96 rows of 128 B]): two groups of two k
// steps, A by ldmatrix, split, then per k step hi.lo, lo.hi, hi.hi into
// `acc`.  Waited for, so that no wgmma is in flight while other
// instructions write registers it reads (ptxas would serialize the
// wgmmas).
__device__ __forceinline__ void stage_mma(float (&acc)[48], const uint8_t* xs,
                                          int row, uint32_t wc, int lane) {
  uint32_t a[2][2][2][4];  // [group][k step][hi, lo]
#pragma unroll
  for (int g = 0; g < 2; ++g) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t raw[4];
      rdb::ldmatrix_x4(raw, xs + swz(row, 2 * (2 * g + s) + lane / 16));
      hopper::tf32_split(raw, a[g][s][0], a[g][s][1]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint32_t b = wc + 32 * (2 * g + s);
      hopper::wgmma_m64n96k8_tf32(acc, a[g][s][0],
                                  hopper::desc_sw128(b + PLANE));
      hopper::wgmma_m64n96k8_tf32(acc, a[g][s][1], hopper::desc_sw128(b));
      hopper::wgmma_m64n96k8_tf32(acc, a[g][s][0], hopper::desc_sw128(b));
    }
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);
}

// Conv `conv` (0..4) over gridDim.x persistent CTAs; conv 4 takes slot
// 4 + blockIdx.y.  `in_map`: the buffer as an f32 (576, M) tensor with
// 32 x 128 boxes (128-byte swizzle); `wpack`: the prep's planes; `bias`
// the conv's own (C_out,) bias; convs 0-3 store chunk 2 + conv of `buf`,
// conv 4 its half of `out` (M, 64), x + scale * conv5 with x read from
// `x`; the ring holds `nst` items.  Warpgroup 2 issues the loads (one
// thread, 40 registers); warpgroups 0 and 1 (232 registers) take every
// run of the CTA together, m-tile wg (rows 64 wg .. 64 wg + 63) each.
__global__ void __launch_bounds__(CONV_NT, 1)
rdb_fwd_ilv_tf32_conv(const __grid_constant__ CUtensorMap in_map,
                      float* buf, const float* __restrict__ x,
                      float* __restrict__ out,
                      const float* __restrict__ wpack,
                      const float* __restrict__ bias, int M, int H, int W,
                      int conv, float scale, int nst) {
  extern __shared__ uint8_t smem_i[];
  // the epilogue's exchange: the last y0 row and first y2 row of each of
  // the run's eight 16-row tiles
  __shared__ float bnd[2][8][32];
  // per stage: its item has landed (full); both warpgroups are done with
  // it (empty)
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  const int s = conv < 4 ? conv : 4 + blockIdx.y;
  const int nk = slot_kst(s), co0 = slot_co0(s);
  uint8_t* a_s = hopper::align_1024(smem_i);  // [nst][box | hi | lo]
  const uint32_t a_u = hopper::smem_u32(a_s);
  const uint32_t f_u = hopper::smem_u32(full), e_u = hopper::smem_u32(empty);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G_ = gridDim.x, runs = runs_of(M);
  const int nr = (int)blockIdx.x < runs ? (runs - 1 - blockIdx.x) / G_ + 1 : 0;

  if (tid == 0) rdb_fwd_tf32::init_ring(f_u, e_u, nst);
  __syncthreads();  // the barriers are initialised

  if (warp >= 8) {  // the producer: item k, K stage k % nk of the CTA's
                    // run k / nk, into stage k % nst
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&in_map))
                   : "memory");
      const float* planes = wpack + slot_wofs(s);
      for (int k = 0; k < nr * nk; ++k) {
        const int st = k % nst, kk = k % nk;
        if (k >= nst) hopper::mbar_wait(e_u + 8 * st, (k / nst - 1) & 1);
        const int t = blockIdx.x + (k / nk) * G_;
        const uint32_t bar = f_u + 8 * st, dst = a_u + st * STAGE;
        hopper::mbar_expect_tx(bar, STAGE);
        hopper::tma_load_4d(dst, &in_map, bar, KC * kk, t * OUTS - 1, 0, 0);
        const float* src = planes + kk * (2 * PLANE / 4);
        hopper::bulk_load(dst + A_ST, src, PLANE, bar);
        hopper::bulk_load(dst + A_ST + PLANE, src + PLANE / 4, PLANE, bar);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // warp-uniform to the compiler (a shuffle from lane 0), so that the
  // warpgroup's wgmmas do not sit in a divergent path
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  const int q = __shfl_sync(0xffffffffu, warp % 4, 0);
  const int gq = lane / 4, tq = lane % 4, T = 4 * wg + q;
  const int row = 64 * wg + 16 * q + lane % 16;  // the lane's A row
  const int chunk = slot_cin(s) / G;  // the chunk convs 1-4 write
  float bv[8];  // this thread's bias columns 8 (k / 2) + 2 tq + k % 2
#pragma unroll
  for (int k = 0; k < 8; ++k)
    bv[k] = bias[co0 + 8 * (k / 2) + 2 * tq + k % 2];
  auto consumers_sync = [&]() {  // both warpgroups (named barrier 1)
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  };

  float sum[48], acc[48];
#pragma unroll
  for (int e = 0; e < 48; ++e) acc[e] = 0.f;
  for (int k = 0; k < nr; ++k) {  // the CTA's runs
    const int m0 = (blockIdx.x + k * G_) * OUTS;
#pragma unroll
    for (int e = 0; e < 48; ++e) sum[e] = 0.f;
    for (int kk = 0; kk < nk; ++kk) {
      const int i = k * nk + kk, st = i % nst;
      hopper::mbar_wait(f_u + 8 * st, (i / nst) & 1);
      stage_mma(acc, a_s + st * STAGE, row, a_u + st * STAGE + A_ST, lane);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(e_u + 8 * st);  // the stage is free
      if (kk % CHAIN == CHAIN - 1) {  // the chain ends: into the f32 sums
#pragma unroll
        for (int e = 0; e < 48; ++e) {
          sum[e] += acc[e];
          acc[e] = 0.f;
        }
        hopper::fence_operands(acc);
      }
    }

    // The epilogue: tile T of the run's rows (y row r is pixel m0 - 1 +
    // r, output row r - 1), its row exchange through bnd.
    consumers_sync();  // the previous run's epilogue has read bnd
    rdb::fwd_store_bounds(sum, bnd[0], bnd[1], T, gq, tq);
    consumers_sync();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * T + gq + 8 * h;
      const int p = m0 - 1 + r;  // its pixel
      float v[8];
      rdb::fwd_combine(sum, bnd[0], bnd[1], T, h, gq, tq, lane,
                       p < 0 ? 0 : p % W, W, bv, v);
      if (r < 1 || r > OUTS || p >= M) continue;  // not an output row
      const int y = p / W % H;
      float* at = buf + (size_t)p * ILV + STRIDE * chunk;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = 8 * j + 2 * tq;
        const float v0 = v[2 * j], v1 = v[2 * j + 1];
        if (conv < 4) {
          const float l0 = rdb::leaky(v0), l1 = rdb::leaky(v1);
          rdb::store2(at + G + ch, l0, l1);
          // the up copy goes to the row below: zero from an image's last
          // row; the dn copy to the row above: zero from its first row
          if (p + W < M)
            rdb::store2(at + (size_t)W * ILV + ch, y == H - 1 ? 0.f : l0,
                        y == H - 1 ? 0.f : l1);
          if (p >= W)
            rdb::store2(at - (size_t)W * ILV + 2 * G + ch, y == 0 ? 0.f : l0,
                        y == 0 ? 0.f : l1);
        } else {  // x + scale * conv5
          const float2 xv = rdb::load2(x + (size_t)p * CH + co0 + ch);
          rdb::store2(out + (size_t)p * CH + co0 + ch, v0 * scale + xv.x,
                      v1 * scale + xv.y);
        }
      }
    }
  }
}

// ------------------------------------------------------------- launches

// The six launches of one f32 block forward on `stream`; returns the
// first launch's error (0 on success).  Grids: slot_ctas for convs 1-4,
// (slot_ctas, 2) for conv 5 (ops/rdb.py ilv_tf32_schedule mirrors them
// and the ring; schedule_of reports them).
inline cudaError_t launch_tf32(const float* x, float* buf, float* out,
                               const Weights<float>& w,
                               const float* const* bias, float* wpack,
                               int B, int H, int W, float scale,
                               cudaStream_t s) {
  const int M = B * H * W;
  const int xblocks =
      (int)(((long long)M * X_WORDS + PREP_NT - 1) / PREP_NT);
  const int zblocks = (2 * W * Z_WORDS + PREP_NT - 1) / PREP_NT;
  const int pblocks = (PACK_ITEMS + PREP_NT - 1) / PREP_NT;
  rdb_fwd_ilv_tf32_prep<<<xblocks + zblocks + pblocks, PREP_NT, 0, s>>>(
      x, buf, w, wpack, M, H, W, xblocks, zblocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap in_map;
  if (!hopper::tensor_map(&in_map, buf, ILV, M, 1, 1, M, KC, RUN, 1,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return cudaErrorInvalidValue;
  if ((err = rdb::allow_smem(rdb_fwd_ilv_tf32_conv, SMEM_DYN)) !=
      cudaSuccess)
    return err;
  for (int i = 0; i < 5; ++i) {
    const int g = slot_ctas(i, M);
    const dim3 grid = i < 4 ? dim3(g) : dim3(g, 2);
    rdb_fwd_ilv_tf32_conv<<<grid, CONV_NT, conv_smem(), s>>>(
        in_map, buf, x, out, wpack, bias[i], M, H, W, i, scale, stages());
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The schedule launch_tf32 runs at (B, H, W), into out[SCHEDULE_INTS]:
// runs, the CTAs of convs 1-4 and of each of conv 5's halves, the ring
// item and the ring's stages, the conv's dynamic shared memory (bytes),
// the prefix columns of an accumulation chain, then each slot's K
// stages.
constexpr int SCHEDULE_INTS = 7 + NSLOTS;
inline void schedule_of(int B, int H, int W, int* out) {
  const int M = B * H * W;
  out[0] = runs_of(M);
  out[1] = slot_ctas(0, M);
  out[2] = slot_ctas(4, M);
  out[3] = STAGE;
  out[4] = stages();
  out[5] = conv_smem();
  out[6] = KC * CHAIN;
  for (int s = 0; s < NSLOTS; ++s) out[7 + s] = slot_kst(s);
}

}  // namespace ilv_tf32
