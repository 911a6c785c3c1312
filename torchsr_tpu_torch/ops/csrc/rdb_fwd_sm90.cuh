// The bf16 residual dense block (RDB) forward on Hopper (sm_90a), shared
// by csrc/rdb_fwd.cu (B1, the (B, H, W, 192) feature buffer) and
// csrc/rdb_ext.cu (B7, the row-extended (B, H + 2, W, 192) one, whose pad
// rows are neither computed nor read: the TMA maps cover the image rows
// only): six launches per block forward, one code path, so B7 equals B1
// bit for bit.
//
// Data flow: the TPU kernel's kx-packed product (torchsr_tpu/ops/pallas/
// rdb.py:186-206).  Conv i (C_in = 64 + 32 i channels of feat, C_out 32,
// or 64 for i = 4) is, for each vertical tap ky, one GEMM of the
// ky-shifted pixels (M x C_in) by W[ky] reshaped to (C_in, 3 C_out), the
// three horizontal taps kx packed along N:
//
//   y[m] = sum_ky feat[pixel m, row shifted by ky - 1] W[ky]
//   out[m] = y0[m - 1] (not on column 0) + y1[m] + y2[m + 1] (not on
//            column W - 1) + b,
//
// the taps reduced on the results.  Convs 1-4 store LeakyReLU(0.2)(out)
// into feat's 32-channel slot; conv 5 stores x + scale * out.  Products
// take bf16 operands and sum in f32; the bias comes after the reduction;
// every stored value is rounded once: the TPU kernel's contract, with
// only the order of the f32 sums differing.  The launches:
//
//  1. prep: the five kernels (HWIO, f32 or bf16, any strides: the
//     caller's parameters as they are) rounded to bf16 into one packed
//     buffer in the order the conv CTAs stage them, and zeros over all
//     192 channels of the row-extended layout's pad rows.
//  2-6. conv for i = 0..4; conv 5 as two halves of 32 output channels
//     (blockIdx.y), each an N = 96 product, as the backward splits dx.
//     Five launches: conv i + 1 reads conv i's output over a halo.  Conv
//     1 reads x itself and copies it into feat's channels 0-63.
//
// conv.  Persistent CTAs walk runs of one image: where W <= 64, 128 / W
// whole rows (every tap that crosses a row end is masked, so a run's y
// rows are its own pixels); else up to 126 pixels inside a row, its y
// rows its pixels and one beyond each end.  A run has at most 128 y rows,
// two m-tiles of 64.  Each run is cut into K chunks of 64 feat channels
// (the last may hold 32), chunk 0 last.  Warpgroup 2 (one thread, 40
// registers) issues each (run, chunk)'s halo, the rows above and below,
// as one TMA box (zeros outside the image) into a ring of up to four
// stages, as far ahead as the ring allows; warpgroups 0 and 1 (232
// registers) take the runs in turn, so that one's epilogue runs beside
// the other's products.  Per ky and 16 channels a warpgroup issues one
// wgmma m64n96k16 per m-tile: A (the ky-shifted pixels, a shift that may
// cross row ends, which no descriptor expresses) from registers by
// ldmatrix, B (the packed W[ky], 96 rows of 64 channels per chunk) by
// descriptor in the 128-byte swizzle; two A buffers in turn keep two ky
// groups in flight.  Each A fragment feeds 96 outputs, three times what
// the nine-tap direct conv's N = 32 gets.  A CTA stages its slot's packed
// weights once: at most 3 chunks x 3 ky x 96 x 128 B = 108 KB (conv 4,
// each half of conv 5).  The epilogue takes y0 of the row above and y2
// of the row below from the neighbour lanes by shuffles (through shared
// memory across 16-row tiles), masks them at row ends, adds the bias and
// the activation or the residual (x from the chunk-0 stage), rounds once
// into a bf16 tile and stores it with one TMA box.
//
// Bound on this card (H100 SXM) at the serving shape (16, 64, 64, 64):
// 65,536 px x 479,232 FLOP = 31.4 GFLOP, 0.0318 ms at the 989 TFLOP/s
// bf16 peak; x in and out 16.8 MB, 0.005 ms: compute-bound.  What the
// design pays on top: the halo re-reads each conv's C_in prefix twice
// from L2 at W = 64 (1.5 times at W = 32) and conv 5's halves read it
// twice more; every wgmma reads its 3 KB of B and 2 KB of A from shared
// memory, 39 FLOP a byte against the 32 at which the tensor cores and
// shared memory balance, so the products run near both limits.

#pragma once

#include "hopper.cuh"
#include "rdb_mma.cuh"

namespace rdb_fwd_sm90 {

using hopper::align_1024;
using hopper::swz;
using hopper::tensor_map;
using rdb::Layout;
using rdb::Weights;
using rdb::weights_of;

constexpr int FEAT = 192;  // feature buffer width
constexpr int CH = 64;     // block input/output channels
constexpr int M = 128;     // y rows of a run: two warpgroups of 64
constexpr int NARROW_W = 64;
constexpr int ROW = 128;             // bytes of 64 bf16 channels
constexpr int N = 96;                // 3 kx x 32 output channels
constexpr int W_KY = N * ROW;        // one ky of one chunk: 12,288
constexpr int NSLOTS = 6;  // convs 1-4, then conv 5's two halves
// two warpgroups that multiply, one whose first thread issues the loads
constexpr int CONV_NT = 384;
constexpr int MAX_STAGES = 4;
constexpr int CTAS = 132;  // persistent CTAs of convs 1-4: one per SM
constexpr int OUT_TILE = M * 64;  // a warpgroup's output: 32 bf16 a pixel
// Dynamic shared memory of a conv CTA: the H100's 227 KB less the static
// exchange of the epilogues' boundary rows (4 KB) and the ring's
// mbarriers.
constexpr int SMEM_DYN = 232448 - 4352;
constexpr int PREP_NT = 256;
constexpr int PREP_PIXELS = PREP_NT / 8;  // 8 threads a pixel

// Slot s's conv, input channels, first output channel and K chunks, and
// the offset of its packed weights (elements).
__host__ __device__ constexpr int slot_conv(int s) { return s < 4 ? s : 4; }
__host__ __device__ constexpr int slot_cin(int s) {
  return 64 + 32 * slot_conv(s);
}
__host__ __device__ constexpr int slot_co0(int s) { return s == 5 ? 32 : 0; }
__host__ __device__ constexpr int slot_chunks(int s) {
  return (slot_cin(s) + 63) / 64;
}
__host__ __device__ constexpr int slot_wofs(int s) {
  int o = 0;
  for (int i = 0; i < s; ++i) o += slot_chunks(i) * 3 * N * 64;
  return o;
}
constexpr int WPACK = slot_wofs(NSLOTS);  // 258,048 packed weights

// Runs (rdb_mma.cuh): up to M - 2 pixels where a run lies inside a row.
using Runs = rdb::FwdRuns<M, M, NARROW_W, CTAS>;
using rdb::Run;

// Bytes of a ring stage: one halo box, rounded up to a swizzle atom.
__host__ __device__ inline int stage_bytes(int W) {
  return (Runs::box_w(W) * Runs::box_h(W) * ROW + 1023) / 1024 * 1024;
}
// Ring stages of slot s's conv: as many as fit beside its weights and the
// two output tiles (at most MAX_STAGES; at least 2 for every W).
__host__ __device__ inline int slot_stages(int s, int W) {
  const int n =
      (SMEM_DYN - 1024 - 2 * OUT_TILE - slot_chunks(s) * 3 * W_KY) /
      stage_bytes(W);
  return n < MAX_STAGES ? n : MAX_STAGES;
}
inline size_t slot_smem(int s, int W) {
  return 1024 + (size_t)slot_chunks(s) * 3 * W_KY + 2 * OUT_TILE +
         (size_t)slot_stages(s, W) * stage_bytes(W);
}

// ----------------------------------------------------------------- prep

// Blocks [0, nblocks): zeros over the row-extended layout's pad rows,
// PREP_PIXELS pad pixels a block (192 channels); the rest: 8 packed
// weights a thread.  The packed weight of slot s, chunk c, tap ky, row n,
// column k is conv slot_conv(s)'s K[ky][n / 32][64 c + k][slot_co0(s) +
// n % 32] (zero past C_in).
template <typename TW>
__global__ void __launch_bounds__(PREP_NT)
rdb_fwd_prep(__nv_bfloat16* __restrict__ feat, Layout L, int nblocks,
             Weights<TW> w, __nv_bfloat16* __restrict__ wpack) {
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= nblocks) {
    const int e0 = ((blockIdx.x - nblocks) * PREP_NT + tid) * 8;
    if (e0 >= WPACK) return;
    int s = 0;
    while (e0 >= slot_wofs(s + 1)) ++s;
    const int local = e0 - slot_wofs(s);
    const int c = local / (3 * N * 64), rem = local % (3 * N * 64);
    const int ky = rem / (N * 64), n = rem % (N * 64) / 64;
    const int ci = 64 * c + rem % 64, i = slot_conv(s);
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (ci < slot_cin(s)) {  // C_in is a multiple of 32: all 8 or none
      const TW* src = w.p[i] + ky * w.s[i][0] + (n / 32) * w.s[i][1] +
                      ci * w.s[i][2] + (slot_co0(s) + n % 32) * w.s[i][3];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = rdb::to_f(src[e * w.s[i][2]]);
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
  // pad pixel p: image p / (2 W), its row above (0) or below (1)
  const long long p = (long long)blockIdx.x * PREP_PIXELS + tid / 8;
  if (p >= (long long)L.B * 2 * L.W) return;
  const int q = tid % 8, xc = (int)(p % L.W);
  const int b = (int)(p / (2 * L.W)), y = (p / L.W) % 2 ? L.H : -1;
  __nv_bfloat16* d = feat + L.pix(b, y, xc) * FEAT;
#pragma unroll
  for (int k = 0; k < FEAT / 64; ++k)
    *reinterpret_cast<uint4*>(d + 8 * (q + 8 * k)) = make_uint4(0, 0, 0, 0);
}

// ----------------------------------------------------------------- conv

// One K chunk of NKS x 16 channels for the warpgroup's m-tiles t <
// `tiles` (64 y rows each): per ky, A of both tiles from the halo at `xs`
// by ldmatrix (the lane's y row in tile t: halo index hb[t] for ky 0),
// then their wgmmas with B, the chunk's W[ky], from shared address `wc`;
// two A buffers in turn keep two ky groups in flight.  Waited for, so
// that no wgmma is in flight while other instructions write registers it
// reads (ptxas would serialize the wgmmas).
template <int NKS>
__device__ __forceinline__ void chunk_mma(float (&acc)[2][48],
                                          const uint8_t* xs,
                                          const int (&hb)[2], int tiles,
                                          int hw, uint32_t wc, int lane) {
  uint32_t a[2][2][NKS][4];  // [ky parity][tile][k step]
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    if (ky == 2) hopper::wgmma_wait<1>();  // ky 0 read a[0]
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks)
        if (t < tiles)
          rdb::ldmatrix_x4(a[ky % 2][t][ks],
                           xs + swz(hb[t] + ky * hw, 2 * ks + lane / 16));
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks)
        if (t < tiles)
          hopper::wgmma_m64n96k16<0>(
              acc[t], a[ky % 2][t][ks],
              hopper::desc_sw128(wc + ky * W_KY + ks * 32));
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
}

// Conv `conv` (0..4) over gridDim.x persistent CTAs (see the header);
// conv 4 takes slot 4 + blockIdx.y.  `in_map` is feat's image rows as a
// (C, x, y, b) tensor with the halo box (conv 0: x, which it also copies
// into feat's channels 0-63 at `feat`); `out_map` the tensor the conv
// stores into with the output box: feat's channels [C_in, C_in + 32)
// for convs 0-3 (the loads of channels [0, C_in) do not meet them), out's
// channels 32 blockIdx.y .. +32 for conv 4.  `bias` is the conv's own
// (C_out,) f32 bias; the ring holds `nst` stages.  Warpgroup 2 issues
// the halo boxes (one thread, 40 registers); warpgroups 0 and 1 (232
// registers) take the CTA's runs in turn, each run's 128 y rows as two
// m-tiles, so that one's epilogue runs beside the other's products.
__global__ void __launch_bounds__(CONV_NT, 1)
rdb_fwd_conv(const __grid_constant__ CUtensorMap in_map,
             const __grid_constant__ CUtensorMap out_map,
             __nv_bfloat16* feat, const __nv_bfloat16* __restrict__ wpack,
             const float* __restrict__ bias, Layout L, int conv, float scale,
             int nst) {
  extern __shared__ uint8_t smem_c[];
  // each warpgroup's epilogue exchange: the last y0 row and first y2 row
  // of each of its eight 16-row tiles
  __shared__ float bnd[2][2][8][32];
  // per stage: its box has landed, for the warpgroup that takes it (full);
  // that warpgroup is done with it (empty)
  __shared__ __align__(8) uint64_t full[2][MAX_STAGES], empty[MAX_STAGES];
  const int s = conv < 4 ? conv : 4 + blockIdx.y;
  const int cin = slot_cin(s), nch = slot_chunks(s), co0 = slot_co0(s);
  uint8_t* w_s = align_1024(smem_c);    // [chunk][ky][96][128 B]
  uint8_t* o_s = w_s + nch * 3 * W_KY;  // [2][M][64 B], 64-byte swizzle
  uint8_t* x_s = o_s + 2 * OUT_TILE;    // [nst][sb]
  const uint32_t w_u = hopper::smem_u32(w_s), x_u = hopper::smem_u32(x_s);
  const uint32_t f_u = hopper::smem_u32(full), e_u = hopper::smem_u32(empty);
  const int sb = stage_bytes(L.W);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = gridDim.x;
  const int runs = L.B * Runs::runs_per_image(L.H, L.W);
  const int nr = (int)blockIdx.x < runs ? (runs - 1 - blockIdx.x) / G + 1 : 0;

  if (tid == 0) {
    for (int k = 0; k < nst; ++k) {
      hopper::mbar_init(f_u + 8 * k, 1);
      hopper::mbar_init(f_u + 8 * (MAX_STAGES + k), 1);
      hopper::mbar_init(e_u + 8 * k, 4);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();  // the barriers are initialised

  if (warp >= 8) {  // the producer: item k's box into stage k % nst
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      const CUtensorMap* in = &in_map;
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(in))
                   : "memory");
      const int box = Runs::box_w(L.W) * Runs::box_h(L.W) * ROW;
      for (int k = 0; k < nr * nch; ++k) {
        const int st = k % nst;
        if (k >= nst) hopper::mbar_wait(e_u + 8 * st, (k / nst - 1) & 1);
        const Run r = Runs::run_of(blockIdx.x + (k / nch) * G, L.H, L.W);
        // the full barrier of the warpgroup that takes run k / nch
        const uint32_t bar = f_u + 8 * ((k / nch) % 2 * MAX_STAGES + st);
        hopper::mbar_expect_tx(bar, box);
        hopper::tma_load_4d(x_u + st * sb, in, bar,
                            64 * (nch - 1 - k % nch), r.hx0, r.r0 - 1, r.b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  {  // the slot's packed weights, as stored, into the swizzle, while the
     // producer fetches the first halo boxes
    const __nv_bfloat16* wsrc = wpack + slot_wofs(s);
    for (int i = tid; i < nch * 3 * N * 8; i += 256)
      hopper::cp_async_16(w_u + swz(i >> 3, i & 7), wsrc + (size_t)i * 8,
                          true);
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
  }
  hopper::fence_proxy_async();  // the weights, for wgmma's reads
  asm volatile("bar.sync 3, 256;\n" ::: "memory");  // both warpgroups
  // warp-uniform to the compiler (a shuffle from lane 0), so that the
  // warpgroup's wgmmas do not sit in a divergent path
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  const int q = __shfl_sync(0xffffffffu, warp % 4, 0);
  const int gq = lane / 4, tq = lane % 4;
  uint8_t* tile = o_s + wg * OUT_TILE;
  const uint32_t tile_u = hopper::smem_u32(tile);
  float bv[8];  // this thread's bias columns 8 (k / 2) + 2 tq + k % 2
#pragma unroll
  for (int k = 0; k < 8; ++k)
    bv[k] = bias[co0 + 8 * (k / 2) + 2 * tq + k % 2];
  auto wg_sync = [&]() {  // this warpgroup's barrier (named barrier 1 + wg)
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  };

  float acc[2][48];
  // bit st: the parity of this warpgroup's next wait on full[wg][st] (its
  // own uses of a stage alternate phases; the other's do not touch them)
  uint32_t par = 0;
  for (int k = wg; k < nr; k += 2) {  // this warpgroup's runs
    const Run r = Runs::run_of(blockIdx.x + k * G, L.H, L.W);
    const int ny = r.n + 2 * r.e;   // y rows
    const int tiles = ny > 64 ? 2 : 1;
    int hb[2];  // the lane's A row of each m-tile (rows past ny: ny - 1)
#pragma unroll
    for (int t = 0; t < 2; ++t)
      hb[t] = min(64 * t + 16 * q + lane % 16, ny - 1);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 48; ++e) acc[t][e] = 0.f;
    const uint8_t* xs = nullptr;
    hopper::fence_operands(acc[0]);
    hopper::fence_operands(acc[1]);
    for (int c = nch - 1; c >= 0; --c) {  // chunk 0 (x for conv 5) last
      const int i = k * nch + nch - 1 - c, st = i % nst;
      hopper::mbar_wait(f_u + 8 * (wg * MAX_STAGES + st), (par >> st) & 1);
      par ^= 1u << st;
      xs = x_s + st * sb;
      const uint32_t wc = w_u + c * 3 * W_KY;
      if (cin - 64 * c >= 64)
        chunk_mma<4>(acc, xs, hb, tiles, r.hw, wc, lane);
      else
        chunk_mma<2>(acc, xs, hb, tiles, r.hw, wc, lane);
      if (c > 0) {  // the stage is free
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(e_u + 8 * st);
      }
    }
    hopper::fence_operands(acc[0]);
    hopper::fence_operands(acc[1]);

    // The epilogue: tile T = 4 t + q of the warpgroup's y rows, its row
    // exchange (rdb_mma.cuh fwd_store_bounds, fwd_combine) through the
    // warpgroup's bnd[wg].
    if (q == 0 && lane == 0) hopper::bulk_wait_read<0>();  // tile is read
#pragma unroll
    for (int t = 0; t < 2; ++t)
      rdb::fwd_store_bounds(acc[t], bnd[wg][0], bnd[wg][1], 4 * t + q, gq,
                            tq);
    wg_sync();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int T = 4 * t + q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * T + gq + 8 * h;  // y row; output row m - e
        float v[8];
        rdb::fwd_combine(acc[t], bnd[wg][0], bnd[wg][1], T, h, gq, tq, lane,
                         (r.p0 + m - r.e) % L.W, L.W, bv, v);
        const int row = m - r.e;
        if (row < 0 || row >= r.n) continue;  // not an output row
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v0 = v[2 * j], v1 = v[2 * j + 1];
          __nv_bfloat162 o;
          if (conv < 4) {
            o = __floats2bfloat162_rn(rdb::leaky(v0), rdb::leaky(v1));
          } else {  // x from the stage: chunk 0 at the pixel (ky 1)
            const int ch = co0 + 8 * j + 2 * tq;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    xs + swz(m + r.hw, ch >> 3) + 2 * (ch & 7)));
            o = __floats2bfloat162_rn(v0 * scale + xv.x, v1 * scale + xv.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              tile + row * 64 + ((j ^ ((row >> 1) & 3)) << 4) + 4 * tq) = o;
        }
      }
    }
    if (conv == 0) {  // x, from the stage (tap ky 1), into feat
      for (int k2 = tid % 128; k2 < r.n * 8; k2 += 128) {
        const int row = k2 >> 3, p = r.p0 + row;
        *reinterpret_cast<uint4*>(
            feat + L.pix(r.b, p / L.W, p % L.W) * FEAT + 8 * (k2 & 7)) =
            *reinterpret_cast<const uint4*>(
                xs + swz(row + r.e + r.hw, k2 & 7));
      }
    }
    __syncwarp();
    if (lane == 0)  // the last chunk's stage is free
      hopper::mbar_arrive(e_u + 8 * ((k * nch + nch - 1) % nst));
    hopper::fence_proxy_async();  // the tile, for the TMA store
    wg_sync();
    if (q == 0 && lane == 0) {
      hopper::tma_store_4d(&out_map, tile_u, conv < 4 ? cin : co0,
                           r.hx0 + r.e, r.r0, r.b);
      hopper::bulk_commit();
    }
  }
  if (q == 0 && lane == 0) hopper::bulk_wait<0>();
}

// ------------------------------------------------------------- launches

// The six launches of one bf16 block forward on `stream`; returns the
// first launch's error (0 on success).  Grids: slot_ctas for convs 1-4,
// (slot_ctas, 2) for conv 5 (ops/rdb.py fwd_schedule mirrors them and
// the ring's size; fwd_schedule_of reports them).  feat's maps cover its
// image rows only, so that the row-extended layout's pad rows are
// neither read nor written.
template <typename TW>
cudaError_t launch_fwd(const __nv_bfloat16* x, __nv_bfloat16* feat,
                       __nv_bfloat16* out, const Weights<TW>& w,
                       const float* const* bias, __nv_bfloat16* wpack,
                       Layout L, float scale, cudaStream_t s) {
  cudaError_t err;
  const long long npad = L.HP > L.H ? (long long)L.B * 2 * L.W : 0;
  const int nblocks = (int)((npad + PREP_PIXELS - 1) / PREP_PIXELS);
  const int pack_blocks = (WPACK / 8 + PREP_NT - 1) / PREP_NT;
  rdb_fwd_prep<TW><<<nblocks + pack_blocks, PREP_NT, 0, s>>>(feat, L, nblocks,
                                                              w, wpack);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int W = L.W;
  const int ow = W <= NARROW_W ? W : Runs::run_len(W);
  const int oh = W <= NARROW_W ? Runs::rows_per_run(W) : 1;
  const __nv_bfloat16* rows = feat + (size_t)L.Y0 * W * FEAT;
  const long long img = (long long)L.HP * W;
  const int bw = Runs::box_w(W), bh = Runs::box_h(W);
  CUtensorMap x_map, in_map, feat_out, out_map;
  if (!tensor_map(&x_map, x, CH, W, L.H, L.B, (long long)L.H * W, 64, bw,
                  bh, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&in_map, rows, FEAT, W, L.H, L.B, img, 64, bw, bh,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&feat_out, rows, FEAT, W, L.H, L.B, img, 32, ow, oh,
                  CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tensor_map(&out_map, out, CH, W, L.H, L.B, (long long)L.H * W, 32, ow,
                  oh, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  if ((err = rdb::allow_smem(rdb_fwd_conv, SMEM_DYN)) != cudaSuccess)
    return err;
  for (int i = 0; i < 5; ++i) {
    if (slot_stages(i, W) < 2) return cudaErrorInvalidValue;
    const int g = Runs::slot_ctas(i, L.B, L.H, W);
    const dim3 grid = i < 4 ? dim3(g) : dim3(g, 2);
    rdb_fwd_conv<<<grid, CONV_NT, slot_smem(i, W), s>>>(
        i == 0 ? x_map : in_map, i < 4 ? feat_out : out_map, feat, wpack,
        bias[i], L, i, scale, slot_stages(i, W));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The C entry's body: the five kernels come as pointers and (ky, kx, ci,
// co) element strides, f32 (w_f32 = 1) or bf16, the five biases as f32
// pointers; `padded` selects the row-extended layout.
inline int launch_fwd_entry(const void* x, void* feat, void* out,
                            const void* const* wptr, const long long* wstride,
                            int w_f32, const void* const* bptr, void* wpack,
                            int B, int H, int W, int padded, float scale,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Layout L{B, H, W, padded ? H + 2 : H, padded ? 1 : 0};
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* fb = static_cast<__nv_bfloat16*>(feat);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* wpb = static_cast<__nv_bfloat16*>(wpack);
  const float* bias[5];
  for (int i = 0; i < 5; ++i) bias[i] = static_cast<const float*>(bptr[i]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_f32)
    err = launch_fwd(xb, fb, ob, weights_of<float>(wptr, wstride), bias, wpb,
                     L, scale, s);
  else
    err = launch_fwd(xb, fb, ob, weights_of<__nv_bfloat16>(wptr, wstride),
                     bias, wpb, L, scale, s);
  return (int)err;
}

// The schedule launch_fwd runs at (B, H, W), into out[SCHEDULE_INTS]:
// runs, the CTAs of convs 1-4 and of each of conv 5's halves, the halo
// box (w, h pixels), the ring stage (bytes), then per slot its stages
// and its dynamic shared memory (bytes).
constexpr int SCHEDULE_INTS = 6 + 2 * NSLOTS;
inline void fwd_schedule_of(int B, int H, int W, int* out) {
  out[0] = B * Runs::runs_per_image(H, W);
  out[1] = Runs::slot_ctas(0, B, H, W);
  out[2] = Runs::slot_ctas(4, B, H, W);
  out[3] = Runs::box_w(W);
  out[4] = Runs::box_h(W);
  out[5] = stage_bytes(W);
  for (int s = 0; s < NSLOTS; ++s) {
    out[6 + s] = slot_stages(s, W);
    out[6 + NSLOTS + s] = (int)slot_smem(s, W);
  }
}

}  // namespace rdb_fwd_sm90
