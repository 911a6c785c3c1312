// The f32 residual dense block (RDB) forward on Hopper (sm_90a), as
// 3xTF32 on the tensor cores, shared by csrc/rdb_fwd.cu (B1, the (B, H,
// W, 192) feature buffer) and csrc/rdb_ext.cu (B7, the row-extended (B,
// H + 2, W, 192) one, whose pad rows are neither computed nor read: the
// TMA maps cover the image rows only): six launches per block forward,
// one code path, so B7 equals B1 bit for bit.
//
// What it computes is the TPU kernel's (torchsr_tpu/ops/pallas/rdb.py:142
// _rdb_fwd_kernel) in f32: five 3x3 SAME convs over the growing concat
// (64 -> 32, 96 -> 32, 128 -> 32, 160 -> 32, 192 -> 64); bias, then
// LeakyReLU(0.2) on convs 1-4; x + scale * conv5; sums in f32, each
// stored value rounded once.  Each f32 product is taken as three TF32
// ones (3xTF32, hopper.cuh tf32_split): a = hi + lo, hi the TF32
// rounding of a, lo = a - hi (exact), and a.b = hi.lo + lo.hi + hi.hi in
// the f32 accumulators, small terms first (ops/pair_conv.py TF32_TERMS),
// ~2^-21 of each product lost, the order of an f32 FMA's rounding.  A,
// the features, is split in registers; B, the weights, is read by
// descriptor as a hi and a lo plane (tf32 wgmma reads B K-major only).
// The data flow is the bf16 forward's (csrc/rdb_fwd_sm90.cuh): the TPU
// kernel's kx-packed product, per vertical tap ky one GEMM of the
// ky-shifted pixels by W[ky] as (C_in, 3 C_out), the three horizontal
// taps packed along N = 96 and reduced on the results with the column
// masks, then the bias.  The launches:
//
//  1. prep: the five HWIO kernels (f32, any strides: the caller's
//     parameters as they are) split once a call into hi and lo planes in
//     global memory (1.83 MiB, resident in the 50 MB L2), already in the
//     order and the 128-byte swizzle in which the conv CTAs stage them;
//     zeros over all 192 channels of the row-extended layout's pad rows.
//  2-6. conv for i = 0..4; conv 5 as two halves of 32 output channels
//     (blockIdx.y).  Conv 1 reads x and copies it into feat's channels
//     0-63, chunk by chunk, from the stages it multiplies.
//
// Shared memory sets the design.  As hi and lo planes the weights of one
// conv (N = 32 output channels, nine taps) take 147, 221, 295, 369 and
// 442 KB (each half of conv 5); an SM has 227 KB, so only conv 1's could
// stay resident beside a halo, and the weights stream.  A conv is cut
// into K chunks of 32 channels (one 128-byte row of f32 a pixel; C_in /
// 32 = 2..6 chunks); a ring item is one chunk of one run: its halo box
// (one TMA load, zeros outside the image) and the chunk's planes for the
// three ky (3 x 2 x 96 rows x 128 B = 72 KB, six bulk copies of 12 KB
// from the prep's buffer), both completing one mbarrier.  Reckoned per
// run at the serving shape (16, 64, 64, 64; a run is two image rows, 128
// pixels, its halo box 64 x 4 pixels), over the 26 items of the six
// slots (20 chunks, conv 5's read by each half):
//
//  (a) kx-packed, N = 96 (built): L2 -> shared memory 1.83 MiB of weight
//      planes and 832 KB of halo (32 KB an item) a run; an item takes 104
//      KB, so the ring holds two (208 KB); per ky and 8 channels a
//      warpgroup splits one A fragment of its m-tile and feeds it to three
//      wgmma m64n96k8 (hi.lo, lo.hi, hi.hi): 96 outputs, the three taps'.
//  (b) the direct nine-tap conv, N = 32, of pair_conv.cu's conv_tf32:
//      the same 1.83 MiB of weights (the same nine taps x C_in x 32), 858
//      KB of halo (the box needs the two zero columns: 66 x 4 pixels), the
//      same two-item ring; but one A fragment split per tap feeds 32
//      outputs: three times (a)'s ldmatrix, splits and wgmma issues, and
//      (a)'s B reads of 9 KB against 2 KB of A per ky and k step become
//      3 KB against 2 KB per tap, near shared memory's rate at the TF32
//      peak.  Not built; (a) also reuses the bf16 forward's proven
//      epilogue (the taps reduced across rows by shuffles).
//
// Weight bytes are the larger stream: 2.2 times the halo's, 981 MB a
// call at the serving shape against 436 MB of halo.  Larger runs cannot
// cut them (two items already fill the ring).  The option not built: a
// cluster of two CTAs, on neighbouring SMs, sharing one TMA multicast of
// each weight slice would halve them, at the cost of a stage freed only
// when both CTAs' consumers release it and of a cluster launch.  On the
// card neither stream is the limit: a copy whose producer loaded each
// stage's planes (or halo) only once ran under 2% faster (PERF.md).
//
// conv.  Persistent CTAs walk runs of one image, as in bf16: where W <=
// 64, 128 / W whole rows (every tap that crosses a row end is masked, so
// a run's y rows are its own pixels); else up to WIDE_M - 2 = 94 pixels
// inside a row (shorter than bf16's 126: a 128-pixel box and its planes
// would not fit twice), its y rows its pixels and one beyond each end.
// Warpgroup 2 (one thread, 40 registers) issues each (run, chunk)'s
// halo box and planes into the ring; warpgroups 0 and 1 take each run
// together, one m-tile of 64 y rows each, from the same items.  Per ky
// a warpgroup issues two groups of two k steps: A by ldmatrix (a 32-bit
// tf32 fragment from rows of f32: (g, t), (g + 8, t), (g, t + 4), (g +
// 8, t + 4)), split in registers, then three wgmma m64n96k8 per k step.
// Accuracy sets the accumulation: the tensor core's sum over a long
// chain drifts (with one chain per output over all of C_in, two m-tiles
// a warpgroup, the launches read up to 0.64 of the f32 limit against
// 0.07-0.11 for the same products summed in f32, and the f32 gradient
// check of a 16 x 16 generator read 1.06e-3 against its 1e-3), so after
// each ky the warpgroup adds its accumulators into f32 sums (48 more
// registers, one m-tile a warpgroup to hold them) and clears them.  The
// epilogue is the bf16 forward's (y0 of the row above and y2 of the row
// below by shuffles and the exchange of boundary rows, the column masks,
// the bias), then the activation or the residual (x read from feat) and
// one f32 store a value, from the registers.
//
// Bound on this card (H100 SXM) at the serving shape: 65,536 px x
// 479,232 FLOP = 31.4 GFLOP, three TF32 products at the 495 TFLOP/s
// dense TF32 peak 0.190 ms (one f32 product at the 67 TFLOP/s FMA peak
// 0.469 ms); x in and out 33.6 MB f32 (0.010 ms), bound by operations.

#pragma once

#include "hopper.cuh"
#include "rdb_mma.cuh"

namespace rdb_fwd_tf32 {

using hopper::swz;
using hopper::tensor_map;
using rdb::Layout;
using rdb::Weights;

constexpr int FEAT = 192;  // feature buffer width
constexpr int CH = 64;     // block input/output channels
constexpr int M = 128;     // y rows of a run where W <= NARROW_W
constexpr int WIDE_M = 96; // y rows of a run inside a row (W > NARROW_W)
constexpr int NARROW_W = 64;
constexpr int KC = 32;               // channels of a K chunk
constexpr int ROW = 128;             // bytes of a pixel's K chunk
constexpr int N = 96;                // 3 kx x 32 output channels
constexpr int PLANE = N * ROW;       // one ky's hi or lo plane: 12,288
constexpr int W_CHUNK = 3 * 2 * PLANE;  // a chunk's planes: 73,728
constexpr int NSLOTS = 6;  // convs 1-4, then conv 5's two halves
// two warpgroups that multiply, one whose first thread issues the loads
constexpr int CONV_NT = 384;
constexpr int MAX_STAGES = 4;
constexpr int CTAS = 132;  // persistent CTAs of convs 1-4: one per SM
// Dynamic shared memory of a conv CTA: the H100's 227 KB less the static
// exchange of the epilogues' boundary rows (4 KB) and the ring's
// mbarriers.
constexpr int SMEM_DYN = 232448 - 4352;
constexpr int PREP_NT = 256;
constexpr int PREP_PIXELS = PREP_NT / 16;  // 16 threads a pad pixel

// Slot s's conv, input channels, first output channel and K chunks, and
// the offset (floats) of its planes in the prep's buffer.
__host__ __device__ constexpr int slot_conv(int s) { return s < 4 ? s : 4; }
__host__ __device__ constexpr int slot_cin(int s) {
  return 64 + 32 * slot_conv(s);
}
__host__ __device__ constexpr int slot_co0(int s) { return s == 5 ? 32 : 0; }
__host__ __device__ constexpr int slot_chunks(int s) {
  return slot_cin(s) / KC;
}
__host__ __device__ constexpr int slot_wofs(int s) {
  int o = 0;
  for (int i = 0; i < s; ++i) o += slot_chunks(i) * (W_CHUNK / 4);
  return o;
}
constexpr int WPACK = slot_wofs(NSLOTS);  // 479,232 floats
constexpr int PACK_ITEMS = WPACK / 8;     // 4 hi and 4 lo floats each

// Runs (rdb_mma.cuh): up to WIDE_M - 2 pixels where a run lies inside a
// row.
using Runs = rdb::FwdRuns<M, WIDE_M, NARROW_W, CTAS>;
using rdb::Run;

// Bytes of a stage's halo (one box, rounded up to a swizzle atom) and of
// a stage (the halo, then the chunk's planes).
__host__ __device__ inline int halo_bytes(int W) {
  return (Runs::box_w(W) * Runs::box_h(W) * ROW + 1023) / 1024 * 1024;
}
__host__ __device__ inline int stage_bytes(int W) {
  return halo_bytes(W) + W_CHUNK;
}
// Ring stages: as many as fit (at most MAX_STAGES; two for every W).
__host__ __device__ inline int stages(int W) {
  const int n = (SMEM_DYN - 1024) / stage_bytes(W);
  return n < MAX_STAGES ? n : MAX_STAGES;
}
inline size_t conv_smem(int W) {
  return 1024 + (size_t)stages(W) * stage_bytes(W);
}

// ----------------------------------------------------------------- prep

// Pack item r (< PACK_ITEMS) of the planes: four consecutive k of one
// plane row, split.  Slot s, chunk c, tap ky: the hi plane at
// slot_wofs(s) + (3 c + ky) 2 PLANE / 4 floats, the lo plane PLANE / 4
// after it; in each, row n (= kx * 32 + co) and k at byte swz(n, k / 4) +
// 4 (k % 4), the weight K[ky][n / 32][32 c + k][slot_co0(s) + n % 32] of
// conv slot_conv(s).  The interleaved forward's prep writes the same
// planes (csrc/rdb_ilv_tf32_sm90.cuh: its K stage 3 c + ky).
__device__ __forceinline__ void pack_item(int r, const Weights<float>& w,
                                          float* __restrict__ wpack) {
  int s = 0;
  while (r >= slot_chunks(s) * 3 * N * 8) r -= slot_chunks(s++) * 3 * N * 8;
  const int c = r / (3 * N * 8), ky = r / (N * 8) % 3;
  const int n = r / 8 % N, k4 = r % 8, i = slot_conv(s);
  const float* src = w.p[i] + ky * w.s[i][0] + (n / 32) * w.s[i][1] +
                     (KC * c + 4 * k4) * w.s[i][2] +
                     (slot_co0(s) + n % 32) * w.s[i][3];
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    hopper::tf32_split(src[e * w.s[i][2]], hi[e], lo[e]);
  float* d = wpack + slot_wofs(s) + (3 * c + ky) * (2 * PLANE / 4) +
             swz(n, k4) / 4;
  *reinterpret_cast<uint4*>(d) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(d + PLANE / 4) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// Blocks [0, nblocks): zeros over the row-extended layout's pad rows,
// PREP_PIXELS pad pixels a block (192 channels); the rest: one pack item
// a thread (pack_item).
__global__ void __launch_bounds__(PREP_NT)
rdb_fwd_tf32_prep(float* __restrict__ feat, Layout L, int nblocks,
                  Weights<float> w, float* __restrict__ wpack) {
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= nblocks) {
    const int r = (blockIdx.x - nblocks) * PREP_NT + tid;
    if (r < PACK_ITEMS) pack_item(r, w, wpack);
    return;
  }
  // pad pixel p: image p / (2 W), its row above (0) or below (1)
  const long long p = (long long)blockIdx.x * PREP_PIXELS + tid / 16;
  if (p >= (long long)L.B * 2 * L.W) return;
  const int q = tid % 16, xc = (int)(p % L.W);
  const int b = (int)(p / (2 * L.W)), y = (p / L.W) % 2 ? L.H : -1;
  float* d = feat + L.pix(b, y, xc) * FEAT;
#pragma unroll
  for (int k = 0; k < FEAT / 64; ++k)
    *reinterpret_cast<uint4*>(d + 4 * (q + 16 * k)) = make_uint4(0, 0, 0, 0);
}

// ----------------------------------------------------------------- conv

// One K chunk (32 channels, four k steps of 8) for the warpgroup's m-tile
// (64 y rows; the lane's y row at halo index hb for ky 0), the halo at
// `xs`, the chunk's planes at shared address `wc` ([ky][hi, lo][96 rows
// of 128 B]).  Per ky two groups of two k steps: A by ldmatrix, split,
// then per k step hi.lo, lo.hi, hi.hi into `acc`; then, both groups
// waited for, `acc` is added into the f32 sum `sum` and cleared.  The
// tensor core's accumulation of a long chain drifts (a block's launches
// read up to 0.64 of the f32 limit with one chain per output; see the
// header), so no chain is longer than one ky's twelve products.  Waited
// for, so that no wgmma is in flight while other instructions write
// registers it reads (ptxas would serialize the wgmmas).
__device__ __forceinline__ void chunk_mma(float (&sum)[48], float (&acc)[48],
                                          const uint8_t* xs, int hb, int hw,
                                          uint32_t wc, int lane) {
  uint32_t a[2][2][2][4];  // [group][k step][hi, lo]
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t raw[4];
        rdb::ldmatrix_x4(raw, xs + swz(hb + ky * hw, 2 * (2 * g + s) +
                                                         lane / 16));
        hopper::tf32_split(raw, a[g][s][0], a[g][s][1]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t b = wc + ky * 2 * PLANE + 32 * (2 * g + s);
        hopper::wgmma_m64n96k8_tf32(acc, a[g][s][0],
                                    hopper::desc_sw128(b + PLANE));
        hopper::wgmma_m64n96k8_tf32(acc, a[g][s][1], hopper::desc_sw128(b));
        hopper::wgmma_m64n96k8_tf32(acc, a[g][s][0], hopper::desc_sw128(b));
      }
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
#pragma unroll
    for (int e = 0; e < 48; ++e) {
      sum[e] += acc[e];
      acc[e] = 0.f;
    }
    hopper::fence_operands(acc);
  }
}

// The ring's barriers: per stage, its item has landed (full: one
// arrival, the producer's, and the transaction bytes); both consumer
// warpgroups are done with it (empty: one arrival a consumer warp).
__device__ __forceinline__ void init_ring(uint32_t f_u, uint32_t e_u,
                                          int nst) {
  for (int k = 0; k < nst; ++k) {
    hopper::mbar_init(f_u + 8 * k, 1);
    hopper::mbar_init(e_u + 8 * k, 8);
  }
  hopper::mbar_init_fence();
}

// The producer of a conv's ring (one thread): item k, chunk k % nch of
// the CTA's run k / nch, into stage k % nst once the consumers have
// freed it: the run's halo box of channels k0 + KC c .. + KC of `in`
// (one TMA load) and the chunk's hi and lo planes for the three ky from
// `planes` (bulk copies), both completing the stage's full barrier.
// Shared by the forward's convs (k0 = 0) and the backward's slot convs
// (csrc/rdb_bwd_tf32_sm90.cuh: K is DY's suffix from channel k0).
__device__ __forceinline__ void produce(const CUtensorMap* in,
                                        const float* planes, int k0,
                                        int nch, int nr, int nst,
                                        const Layout& L, uint32_t x_u,
                                        uint32_t f_u, uint32_t e_u) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(in))
               : "memory");
  const int sb = stage_bytes(L.W), hbytes = halo_bytes(L.W);
  const int box = Runs::box_w(L.W) * Runs::box_h(L.W) * ROW;
  const int G = gridDim.x;
  for (int k = 0; k < nr * nch; ++k) {
    const int st = k % nst, c = k % nch;
    if (k >= nst) hopper::mbar_wait(e_u + 8 * st, (k / nst - 1) & 1);
    const Run r = Runs::run_of(blockIdx.x + (k / nch) * G, L.H, L.W);
    const uint32_t bar = f_u + 8 * st, dst = x_u + st * sb;
    hopper::mbar_expect_tx(bar, box + W_CHUNK);
    hopper::tma_load_4d(dst, in, bar, k0 + KC * c, r.hx0, r.r0 - 1, r.b);
    const float* src = planes + c * (W_CHUNK / 4);
    for (int j = 0; j < W_CHUNK / PLANE; ++j)
      hopper::bulk_load(dst + hbytes + j * PLANE, src + j * (PLANE / 4),
                        PLANE, bar);
  }
}

// Conv `conv` (0..4) over gridDim.x persistent CTAs (see the header);
// conv 4 takes slot 4 + blockIdx.y.  `in_map` is feat's image rows as a
// (C, x, y, b) f32 tensor with the halo box (conv 0: x, which it also
// copies into feat's channels 0-63); convs 0-3 store into feat's
// channels [C_in, C_in + 32), conv 4 into out's 32 blockIdx.y .. +32.
// `bias` is the conv's own (C_out,) f32 bias; `wpack` the prep's planes;
// the ring holds `nst` stages.  Warpgroup 2 issues the loads (one
// thread, 40 registers); warpgroups 0 and 1 (232 registers) take every
// run of the CTA together, m-tile wg (y rows 64 wg .. 64 wg + 63) each,
// from the same ring items.
__global__ void __launch_bounds__(CONV_NT, 1)
rdb_fwd_tf32_conv(const __grid_constant__ CUtensorMap in_map, float* feat,
                  float* __restrict__ out, const float* __restrict__ wpack,
                  const float* __restrict__ bias, Layout L, int conv,
                  float scale, int nst) {
  extern __shared__ uint8_t smem_t[];
  // the epilogue's exchange: the last y0 row and first y2 row of each of
  // the run's eight 16-row tiles
  __shared__ float bnd[2][8][32];
  // per stage: its item has landed (full); both warpgroups are done with
  // it (empty)
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  const int s = conv < 4 ? conv : 4 + blockIdx.y;
  const int cin = slot_cin(s), nch = slot_chunks(s), co0 = slot_co0(s);
  uint8_t* x_s = hopper::align_1024(smem_t);  // [nst][halo | planes]
  const uint32_t x_u = hopper::smem_u32(x_s);
  const uint32_t f_u = hopper::smem_u32(full), e_u = hopper::smem_u32(empty);
  const int sb = stage_bytes(L.W), hbytes = halo_bytes(L.W);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = gridDim.x;
  const int runs = L.B * Runs::runs_per_image(L.H, L.W);
  const int nr = (int)blockIdx.x < runs ? (runs - 1 - blockIdx.x) / G + 1 : 0;

  if (tid == 0) init_ring(f_u, e_u, nst);
  __syncthreads();  // the barriers are initialised

  if (warp >= 8) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0)
      produce(&in_map, wpack + slot_wofs(s), 0, nch, nr, nst, L, x_u, f_u,
              e_u);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // warp-uniform to the compiler (a shuffle from lane 0), so that the
  // warpgroup's wgmmas do not sit in a divergent path
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  const int q = __shfl_sync(0xffffffffu, warp % 4, 0);
  const int gq = lane / 4, tq = lane % 4, T = 4 * wg + q;
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
    const Run r = Runs::run_of(blockIdx.x + k * G, L.H, L.W);
    const int ny = r.n + 2 * r.e;     // y rows
    const bool mine = ny > 64 * wg;   // this warpgroup's m-tile has rows
    // the lane's A row (rows past ny: ny - 1)
    const int hb = min(64 * wg + 16 * q + lane % 16, ny - 1);
#pragma unroll
    for (int e = 0; e < 48; ++e) sum[e] = 0.f;
    for (int c = 0; c < nch; ++c) {
      const int i = k * nch + c, st = i % nst;
      hopper::mbar_wait(f_u + 8 * st, (i / nst) & 1);
      const uint8_t* xs = x_s + st * sb;
      if (mine)
        chunk_mma(sum, acc, xs, hb, r.hw, x_u + st * sb + hbytes, lane);
      if (conv == 0) {  // x's chunk c, from the stage (tap ky 1), into feat
        for (int k2 = tid; k2 < r.n * 8; k2 += 256) {
          const int row = k2 >> 3, p = r.p0 + row;
          *reinterpret_cast<uint4*>(
              feat + L.pix(r.b, p / L.W, p % L.W) * FEAT + KC * c +
              4 * (k2 & 7)) =
              *reinterpret_cast<const uint4*>(
                  xs + swz(row + r.e + r.hw, k2 & 7));
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(e_u + 8 * st);  // the stage is free
    }

    // The epilogue, as the bf16 forward's: tile T = 4 wg + q of the run's
    // y rows, its row exchange (rdb_mma.cuh fwd_store_bounds,
    // fwd_combine) through bnd.
    consumers_sync();  // the previous run's epilogue has read bnd
    rdb::fwd_store_bounds(sum, bnd[0], bnd[1], T, gq, tq);
    consumers_sync();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * T + gq + 8 * h;  // y row; output row m - e
      float v[8];
      rdb::fwd_combine(sum, bnd[0], bnd[1], T, h, gq, tq, lane,
                       (r.p0 + m - r.e) % L.W, L.W, bv, v);
      const int row = m - r.e;
      if (row < 0 || row >= r.n) continue;  // not an output row
      const int p = r.p0 + row, py = p / L.W, px = p % L.W;
      float* fp = feat + L.pix(r.b, py, px) * FEAT;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = 8 * j + 2 * tq;
        const float v0 = v[2 * j], v1 = v[2 * j + 1];
        if (conv < 4) {
          rdb::store2(fp + cin + ch, rdb::leaky(v0), rdb::leaky(v1));
        } else {  // x + scale * conv5, x from feat's channels 0-63
          const float2 xv = rdb::load2(fp + co0 + ch);
          rdb::store2(out + L.dense(r.b, py, px) * CH + co0 + ch,
                      v0 * scale + xv.x, v1 * scale + xv.y);
        }
      }
    }
  }
}

// ------------------------------------------------------------- launches

// The six launches of one f32 block forward on `stream`; returns the
// first launch's error (0 on success).  Grids: slot_ctas for convs 1-4,
// (slot_ctas, 2) for conv 5 (ops/rdb.py fwd_tf32_schedule mirrors them
// and the ring's size; fwd_schedule_of reports them).  feat's map covers
// its image rows only, so that the row-extended layout's pad rows are
// neither read nor written by the convs.
inline cudaError_t launch_fwd(const float* x, float* feat, float* out,
                              const Weights<float>& w,
                              const float* const* bias, float* wpack,
                              Layout L, float scale, cudaStream_t s) {
  cudaError_t err;
  const long long npad = L.HP > L.H ? (long long)L.B * 2 * L.W : 0;
  const int nblocks = (int)((npad + PREP_PIXELS - 1) / PREP_PIXELS);
  const int pack_blocks = (PACK_ITEMS + PREP_NT - 1) / PREP_NT;
  rdb_fwd_tf32_prep<<<nblocks + pack_blocks, PREP_NT, 0, s>>>(
      feat, L, nblocks, w, wpack);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int W = L.W;
  const float* rows = feat + (size_t)L.Y0 * W * FEAT;
  const int bw = Runs::box_w(W), bh = Runs::box_h(W);
  CUtensorMap x_map, in_map;
  if (!tensor_map(&x_map, x, CH, W, L.H, L.B, (long long)L.H * W, KC, bw,
                  bh, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !tensor_map(&in_map, rows, FEAT, W, L.H, L.B, (long long)L.HP * W, KC,
                  bw, bh, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return cudaErrorInvalidValue;
  if (stages(W) < 2) return cudaErrorInvalidValue;
  if ((err = rdb::allow_smem(rdb_fwd_tf32_conv, SMEM_DYN)) != cudaSuccess)
    return err;
  for (int i = 0; i < 5; ++i) {
    const int g = Runs::slot_ctas(i, L.B, L.H, W);
    const dim3 grid = i < 4 ? dim3(g) : dim3(g, 2);
    rdb_fwd_tf32_conv<<<grid, CONV_NT, conv_smem(W), s>>>(
        i == 0 ? x_map : in_map, feat, out, wpack, bias[i], L, i, scale,
        stages(W));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The C entry's body: the five kernels come as f32 pointers and (ky, kx,
// ci, co) element strides, the five biases as f32 pointers; `padded`
// selects the row-extended layout.
inline int launch_fwd_entry(const void* x, void* feat, void* out,
                            const void* const* wptr, const long long* wstride,
                            const void* const* bptr, void* wpack, int B,
                            int H, int W, int padded, float scale, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Layout L{B, H, W, padded ? H + 2 : H, padded ? 1 : 0};
  const float* bias[5];
  for (int i = 0; i < 5; ++i) bias[i] = static_cast<const float*>(bptr[i]);
  return (int)launch_fwd(
      static_cast<const float*>(x), static_cast<float*>(feat),
      static_cast<float*>(out), rdb::weights_of<float>(wptr, wstride), bias,
      static_cast<float*>(wpack), L, scale, static_cast<cudaStream_t>(stream));
}

// The schedule launch_fwd runs at (B, H, W), into out[SCHEDULE_INTS]:
// runs, the CTAs of convs 1-4 and of each of conv 5's halves, the halo
// box (w, h pixels), the stage and its halo (bytes), the ring's stages
// and the conv's dynamic shared memory (bytes).
constexpr int SCHEDULE_INTS = 9;
inline void fwd_schedule_of(int B, int H, int W, int* out) {
  out[0] = B * Runs::runs_per_image(H, W);
  out[1] = Runs::slot_ctas(0, B, H, W);
  out[2] = Runs::slot_ctas(4, B, H, W);
  out[3] = Runs::box_w(W);
  out[4] = Runs::box_h(W);
  out[5] = stage_bytes(W);
  out[6] = halo_bytes(W);
  out[7] = stages(W);
  out[8] = (int)conv_smem(W);
}

}  // namespace rdb_fwd_tf32
