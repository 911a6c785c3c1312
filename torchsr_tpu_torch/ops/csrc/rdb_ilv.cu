// Residual dense block (RDB) forward on a chunk-interleaved feature
// buffer, for Hopper (sm_90a).  Forward only.
//
// Replaces the TPU kernel torchsr_tpu/ops/pallas/rdb.py:223
// (_rdb_fwd_kernel_ilv, weights by _repack_ilv :291), selected there by
// TORCHSR_RDB_ILV=1 on forwards that no backward follows and where the
// row-extended kernel was not chosen (_rdb_fwd :445).  The math is B1's:
// five dense 3x3 SAME convs (C_in = 64 + 32 i, C_out 32, 32, 32, 32, 64),
// bias, LeakyReLU(0.2) on convs 1-4, out = x + scale * conv5, f32 sums,
// each stored value rounded once.
//
// Layout.  The buffer is (M, 576) for M = B*H*W NHWC pixels, in the
// working dtype: 32-channel chunk j (j < 6; chunks 0-1 are x, chunk 2 + i
// is conv i's output) occupies columns [96 j, 96 j + 96) as [up | mid |
// dn], where mid holds the chunk at pixel m, up the chunk at m - W (the
// row above; zero on an image's first row) and dn the chunk at m + W
// (zero on its last row).  So conv i's GEMM operand is the contiguous
// prefix buf[:, :3 C_in] (K = 3 C_in), against the packed weight
// (3 C_in, 3 C_out) whose rows are ordered (chunk, dy, ci) by
// ops/rdb.py's repack_ilv, and whose columns (dx, co) carry the three
// horizontal taps: y[m, (dx, co)] = sum_k buf[m, k] W[k, (dx, co)].  The
// epilogue reduces the taps, out[m] = y[m - 1, dx 0] + y[m, dx 1] +
// y[m + 1, dx 2] + b, with y[m - 1] dropped on an image's first column
// and y[m + 1] on its last (first_col / last_col at rdb.py:243).
//
// bf16: six launches a block (ilv_sm90 below).
//  1. prep: the five kernels (HWIO, f32 or bf16, any strides: the
//     caller's parameters as they are) rounded to bf16 into one packed
//     buffer in repack_ilv order, each 64-row K stage of each slot (convs
//     1-4, conv 5's two 32-channel halves) stored as its 96 columns'
//     rows of 64 K values in the 128-byte swizzle (the 32-row last stage
//     of convs 2 and 4: rows of 32 in the 64-byte swizzle), as the conv
//     CTAs stage it; x's two chunks, three copies each (each word of x
//     read once), zeros at the image edges; zeros over the up slots of
//     chunks 2-5 on the buffer's first W rows and their dn slots on its
//     last W rows.
//  2-6. conv i (conv 5 as two N = 96 halves, grid y).  The dy shifts are
//     in the buffer, so a run is any 128 consecutive pixels m0 - 1 ..
//     m0 + 126 (m0 = 126 t), its 126 outputs m0 .. m0 + 125 with one
//     halo pixel at each end for the dx taps: no run depends on row or
//     image ends (the column masks come from m mod W).  Each 64-column K
//     stage of a run's prefix is one TMA box (128 rows x 128 B, 128-byte
//     swizzle, zeros past the buffer's ends; the 32-column last stage of
//     convs 2 and 4, K = 288 and 480, 128 rows x 64 B in the 64-byte
//     swizzle) into a ring; both wgmma
//     operands come from shared memory by descriptor (no ldmatrix): per
//     stage and 16 columns, one m64n96k16 per m-tile.  The slot's packed
//     weights are staged once per CTA (conv 4: 7.5 stages, 90 KB; each
//     half of conv 5: 9 stages, 108 KB; all of conv 5 at once would not
//     fit beside the ring), one bulk copy a K stage, each on its own
//     barrier, so that the first products need only the first stage's.
//     A producer warp (40 registers) issues them and keeps the boxes in
//     flight, in a ring as deep as shared memory allows (the data path
//     is bound by the latency of the boxes in flight); two consumer
//     warpgroups (232 registers) take runs in turn, so that one's
//     epilogue runs beside the other's products, each keeping one stage's
//     products in flight while it issues the next stage's.
//     The epilogue reduces the taps with shuffles (B1's), adds the bias
//     and the activation, rounds once into a bf16 tile of the run and
//     stores it three times with one TMA box each: mid at rows m, then
//     the up copy at rows m + W (the tile's rows that are an image's last
//     row zeroed first) and the dn copy at rows m - W (its first rows
//     zeroed, the last restored), each once the store before has read the
//     tile; TMA clips what leaves the buffer (the dn map ends at row
//     M - W).  So every element has exactly one writer, and conv i writes
//     only chunk 2 + i and reads only chunks below it: no CTA waits on
//     another.  Conv 5 stores x + scale * out with one box, x read
//     from the block input.
// f32: six launches a block, the same runs and stores with each product
// taken as three TF32 ones on wgmma (csrc/rdb_ilv_tf32_sm90.cuh; design,
// bound and the drift of long tensor-core chains there).
//
// Bound on this card (H100 SXM).  The function is B1's: at the serving
// shape (16, 64, 64, 64), 31.4 GFLOP, 0.0318 ms at 989 TFLOP/s bf16
// (0.469 ms f32), against 16.8 MB of unavoidable bytes (0.005 ms).  The
// layout has its own floor of bytes: the buffer is 75.5 MB written once,
// the convs read 252 MB of prefixes (conv 5's second half about 75 MB
// more), 0.33-0.40 GB or 0.10-0.12 ms at 3.35 TB/s where nothing stays
// in the 50 MB L2: in bf16 the layout, not the tensor cores, bounds it.

#include "hopper.cuh"
#include "rdb_ilv_tf32_sm90.cuh"
#include "rdb_mma.cuh"

namespace {

using rdb::allow_smem;

constexpr int CH = 64;       // block input/output channels
constexpr int G = 32;        // growth: channels per chunk
constexpr int STRIDE = 3 * G;        // columns per chunk: [up | mid | dn]
constexpr int ILV = 6 * STRIDE;      // 576 buffer columns

// ------------------------------------------------------------------ bf16

namespace ilv_sm90 {

using hopper::align_1024;
using hopper::swz;
using hopper::tensor_map;
using rdb::Weights;

constexpr int RUN = 128;          // GEMM rows of a run: two m-tiles of 64
constexpr int OUTS = RUN - 2;     // its outputs: one halo pixel each side
constexpr int N = 96;             // 3 kx x 32 output channels
constexpr int ROW = 128;          // bytes of 64 bf16 K columns
constexpr int W_ST = N * ROW;     // one K stage of packed weights: 12,288
constexpr int W_ELEMS = N * 64;   // its elements
constexpr int A_ST = RUN * ROW;   // one K stage of A (a ring stage): 16,384
constexpr int OUT_TILE = RUN * 64;  // an output tile: 32 bf16 a pixel
constexpr int NSLOTS = 6;         // convs 1-4, then conv 5's two halves
constexpr int CONV_NT = 384;      // two consumer warpgroups, one producer
constexpr int MAX_STAGES = 8;
constexpr int MAX_KST = 9;        // K stages of a slot, at most
constexpr int CTAS = 132;         // persistent CTAs of convs 1-4
// Dynamic shared memory of a conv CTA: the H100's 227 KB less the static
// exchange of the epilogues' boundary rows (4 KB) and the mbarriers.
constexpr int SMEM_DYN = 232448 - 4608;
constexpr int PREP_NT = 256;
constexpr int X_WORDS = CH / 8;  // 16-byte words of x at a pixel

// Slot s's conv, input channels, first output channel, prefix columns
// (K = 3 C_in), K stages of 64 columns (the last may hold 32), taken in
// order, and the offset of its packed weights (elements).
__host__ __device__ constexpr int slot_conv(int s) { return s < 4 ? s : 4; }
__host__ __device__ constexpr int slot_cin(int s) {
  return 64 + 32 * slot_conv(s);
}
__host__ __device__ constexpr int slot_co0(int s) { return s == 5 ? 32 : 0; }
__host__ __device__ constexpr int slot_kcols(int s) { return 3 * slot_cin(s); }
__host__ __device__ constexpr int slot_kst(int s) {
  return (slot_kcols(s) + 63) / 64;
}
// Whether K stage kk of slot s holds 32 columns, not 64 (the last of convs
// 2 and 4: K = 288, 480); such a stage's A box and weights are rows of 64
// bytes in the 64-byte swizzle, half the bytes of a full one.
__host__ __device__ constexpr bool half_stage(int s, int kk) {
  return slot_kcols(s) - 64 * kk == 32;
}
__host__ __device__ constexpr int slot_wofs(int s) {
  int o = 0;
  for (int i = 0; i < s; ++i) o += N * slot_kcols(i);
  return o;
}
constexpr int WPACK = slot_wofs(NSLOTS);  // 239,616 packed weights
// Bytes of slot s's packed weights (a whole multiple of 1024)
__host__ __device__ constexpr int slot_wbytes(int s) {
  return 2 * N * slot_kcols(s);
}

// Runs of M pixels; ring stages of slot s's conv (as many as fit beside
// its weights and the two warpgroups' output tiles, at most MAX_STAGES);
// its dynamic shared memory; its persistent CTAs (conv 5's halves half
// as many each, in its grid's y).
__host__ __device__ inline int runs_of(int M) { return (M + OUTS - 1) / OUTS; }
__host__ __device__ inline int slot_ring(int s) {
  const int n = (SMEM_DYN - 1024 - slot_wbytes(s) - 2 * OUT_TILE) / A_ST;
  return n < MAX_STAGES ? n : MAX_STAGES;
}
inline int slot_smem(int s) {
  return 1024 + slot_wbytes(s) + 2 * OUT_TILE + slot_ring(s) * A_ST;
}
inline int slot_ctas(int s, int M) {
  const int runs = runs_of(M), cap = s < 4 ? CTAS : CTAS / 2;
  return runs < 1 ? 1 : runs < cap ? runs : cap;
}

// ----------------------------------------------------------------- prep

// Blocks [0, xblocks): x's chunks 0 and 1, [up | mid | dn] each, one
// 16-byte word of x a thread, written as its three copies (zeros past an
// image's top and bottom); then
// [xblocks, xblocks + zblocks): zeros over the up slots of chunks 2-5 on
// the buffer's first W rows and their dn slots on its last W rows (the
// slots no conv's store reaches); the rest: 8 packed weights a thread.
// The packed weight of slot s, K stage kk, row n, column k is the
// repack_ilv weight of conv slot_conv(s) at row 64 kk + k, column n of
// its half: K[dy][n / 32][32 chunk + ci][co0 +
// n % 32] for row (chunk, dy, ci), stored in the swizzle of the stage's
// 96 rows (128 bytes, or 64 for a half stage), as the conv CTAs stage it.
template <typename TW>
__global__ void __launch_bounds__(PREP_NT)
rdb_fwd_ilv_prep(const __nv_bfloat16* __restrict__ x,
                 __nv_bfloat16* __restrict__ buf, Weights<TW> w,
                 __nv_bfloat16* __restrict__ wpack, int M, int H, int W,
                 int xblocks, int zblocks) {
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  if (blk < xblocks) {  // 16-byte word q of x at pixel m: read once,
                        // stored as mid at m, up at m + W, dn at m - W
    const long long e = (long long)blk * PREP_NT + tid;
    if (e >= (long long)M * X_WORDS) return;
    const int m = (int)(e / X_WORDS), q = (int)(e % X_WORDS);
    const int y = m / W % H;
    const uint4 v =
        *reinterpret_cast<const uint4*>(x + (size_t)m * CH + 8 * q);
    __nv_bfloat16* at =
        buf + (size_t)m * ILV + STRIDE * (q / 4) + 8 * (q % 4);
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
    if (e >= 32 * W) return;
    const int r = e / 16, q = e % 16, c = 2 + q / 4;
    const size_t m = r < W ? (size_t)r : (size_t)M - 2 * W + r;
    *reinterpret_cast<uint4*>(buf + m * ILV + STRIDE * c +
                              (r < W ? 0 : 2 * G) + 8 * (q % 4)) = zero;
    return;
  }
  blk -= zblocks;
  const int e0 = (blk * PREP_NT + tid) * 8;
  if (e0 >= WPACK) return;
  int s = 0;
  while (e0 >= slot_wofs(s + 1)) ++s;
  const int local = e0 - slot_wofs(s), kk = local / W_ELEMS;
  const bool half = half_stage(s, kk);
  const int rem = local - kk * W_ELEMS, n = half ? rem / 32 : rem / 64;
  const int k = half ? rem % 32 : rem % 64, r = 64 * kk + k;
  const int i = slot_conv(s);
  float v[8];
  const int ci = G * (r / STRIDE) + r % G, dy = r % STRIDE / G;
  const TW* src = w.p[i] + dy * w.s[i][0] + (n / G) * w.s[i][1] +
                  ci * w.s[i][2] + (slot_co0(s) + n % G) * w.s[i][3];
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = rdb::to_f(src[t * w.s[i][2]]);
  uint32_t u[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[2 * t], v[2 * t + 1]);
    u[t] = *reinterpret_cast<const uint32_t*>(&b2);
  }
  uint8_t* dst = reinterpret_cast<uint8_t*>(wpack + slot_wofs(s)) +
                 kk * W_ST +
                 (half ? n * 64 + (((k >> 3) ^ ((n >> 1) & 3)) << 4)
                       : swz(n, k >> 3));
  *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
}

// ----------------------------------------------------------------- conv

// One K stage (NKS x 16 columns) of both m-tiles: A (the stage's 128
// rows, 64 each) and B (the stage's packed weights at `wc`) both by
// descriptor, committed as one group.  Nothing but wgmmas touches the
// accumulators while groups are in flight (ptxas would serialize them).
// A half stage (HALF) holds rows of 64 bytes in the 64-byte swizzle.
template <bool HALF>
__device__ __forceinline__ void stage_mma(float (&acc)[2][48], uint32_t a,
                                          uint32_t wc) {
  constexpr int NKS = HALF ? 2 : 4, RB = HALF ? 64 : ROW;
  hopper::wgmma_fence();
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      const uint32_t at = a + t * 64 * RB + ks * 32, bt = wc + ks * 32;
      hopper::wgmma_m64n96k16_ss(
          acc[t], HALF ? hopper::desc_sw64(at) : hopper::desc_sw128(at),
          HALF ? hopper::desc_sw64(bt) : hopper::desc_sw128(bt));
    }
  hopper::wgmma_commit();
}

// Conv `conv` (0..4) over gridDim.x persistent CTAs; conv 4 takes slot
// 4 + blockIdx.y.  `in_map`: the buffer as (576, M) with 64 x 128 boxes
// (128-byte swizzle), `half_map` with 32 x 128 ones (64-byte swizzle) for
// half stages; `st_map`: the tensor the conv stores into, with
// 32 x 126 boxes (64-byte swizzle): the buffer for convs 0-3, out (64,
// M) for conv 4; `dn_map`: the buffer's first M - W rows, for the dn
// stores (so that they never reach the last W rows' dn slots, the
// prep's zeros).  Warpgroup 2 issues each (run, K stage)'s A box into a
// ring of `nst` stages (one thread, 40 registers); warpgroups 0 and 1
// (232 registers) take the CTA's runs in turn.
__global__ void __launch_bounds__(CONV_NT, 1)
rdb_fwd_ilv_conv(const __grid_constant__ CUtensorMap in_map,
                 const __grid_constant__ CUtensorMap half_map,
                 const __grid_constant__ CUtensorMap st_map,
                 const __grid_constant__ CUtensorMap dn_map,
                 __nv_bfloat16* buf, const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ wpack,
                 const float* __restrict__ bias, int M, int H, int W,
                 int conv, float scale, int nst) {
  extern __shared__ uint8_t smem_c[];
  // each warpgroup's epilogue exchange: the last y0 row and first y2 row
  // of each of its eight 16-row tiles
  __shared__ float bnd[2][2][8][32];
  // per stage: its box has landed, for the warpgroup that takes it (full);
  // that warpgroup is done with it (empty); per K stage: its weights have
  // landed (wbar, one phase)
  __shared__ __align__(8) uint64_t full[2][MAX_STAGES], empty[MAX_STAGES],
      wbar[MAX_KST];
  const int s = conv < 4 ? conv : 4 + blockIdx.y;
  const int nk = slot_kst(s), co0 = slot_co0(s);
  uint8_t* w_s = align_1024(smem_c);   // [K stage][96][128 B], swizzled
  uint8_t* o_s = w_s + slot_wbytes(s);  // [wg][RUN][64 B]
  uint8_t* a_s = o_s + 2 * OUT_TILE;   // [nst][RUN][128 B]
  const uint32_t w_u = hopper::smem_u32(w_s), a_u = hopper::smem_u32(a_s);
  const uint32_t f_u = hopper::smem_u32(full), e_u = hopper::smem_u32(empty);
  const uint32_t wb_u = hopper::smem_u32(wbar);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G_ = gridDim.x, runs = runs_of(M);
  const int nr = (int)blockIdx.x < runs ? (runs - 1 - blockIdx.x) / G_ + 1 : 0;

  if (tid == 0) {
    for (int k = 0; k < nst; ++k) {
      hopper::mbar_init(f_u + 8 * k, 1);
      hopper::mbar_init(f_u + 8 * (MAX_STAGES + k), 1);
      hopper::mbar_init(e_u + 8 * k, 4);
    }
    for (int k = 0; k < nk; ++k) hopper::mbar_init(wb_u + 8 * k, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();  // the barriers are initialised

  if (warp >= 8) {  // the producer: the weights, then item k's box into
                    // stage k % nst
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      const CUtensorMap* in = &in_map;
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(in))
                   : "memory");
      const __nv_bfloat16* wsrc = wpack + slot_wofs(s);
      for (int kk = 0; kk < nk; ++kk) {  // in the order the runs take them
        const int bytes = half_stage(s, kk) ? W_ST / 2 : W_ST;
        hopper::mbar_expect_tx(wb_u + 8 * kk, bytes);
        hopper::bulk_load(w_u + kk * W_ST, wsrc + (size_t)kk * W_ELEMS,
                          bytes, wb_u + 8 * kk);
      }
      for (int k = 0; k < nr * nk; ++k) {
        const int st = k % nst;
        if (k >= nst) hopper::mbar_wait(e_u + 8 * st, (k / nst - 1) & 1);
        const int t = blockIdx.x + (k / nk) * G_;
        const int kk = k % nk;
        // the full barrier of the warpgroup that takes run k / nk
        const uint32_t bar = f_u + 8 * ((k / nk) % 2 * MAX_STAGES + st);
        const bool half = half_stage(s, kk);
        hopper::mbar_expect_tx(bar, half ? A_ST / 2 : A_ST);
        hopper::tma_load_4d(a_u + st * A_ST, half ? &half_map : in, bar,
                            64 * kk, t * OUTS - 1, 0, 0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
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
  const int chunk = slot_cin(s) / G;  // the chunk convs 1-4 write

  float acc[2][48];
  // bit st: the parity of this warpgroup's next wait on full[wg][st]
  uint32_t par = 0;
  for (int k = wg; k < nr; k += 2) {  // this warpgroup's runs
    const int m0 = (blockIdx.x + k * G_) * OUTS;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 48; ++e) acc[t][e] = 0.f;
    hopper::fence_operands(acc[0]);
    hopper::fence_operands(acc[1]);
    // Each stage's group stays in flight while the next stage's is issued;
    // a stage is freed once its group is done.
    int st = 0;
    for (int kk = 0; kk < nk; ++kk) {
      const int prev = st;
      st = (k * nk + kk) % nst;
      hopper::mbar_wait(wb_u + 8 * kk, 0);  // the weights (once: a no-op after)
      hopper::mbar_wait(f_u + 8 * (wg * MAX_STAGES + st), (par >> st) & 1);
      par ^= 1u << st;
      const uint32_t a = a_u + st * A_ST, wc = w_u + kk * W_ST;
      if (half_stage(s, kk))
        stage_mma<true>(acc, a, wc);
      else
        stage_mma<false>(acc, a, wc);
      if (kk > 0) {  // the previous stage's group is done: free it
        hopper::wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(e_u + 8 * prev);
      }
    }
    hopper::wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(e_u + 8 * st);  // the last stage
    hopper::fence_operands(acc[0]);
    hopper::fence_operands(acc[1]);

    // The epilogue.  Tile T = 4 t + q holds y rows 16 T + gq + 8 h (pixel
    // m0 - 1 + row), columns 8 j + 2 tq (+ 1) of y0 (acc[t][4 j + 2 h]),
    // y1 (j + 4) and y2 (j + 8).  The output at y row m takes y0 of row
    // m - 1 and y2 of row m + 1: from the lanes four below and above,
    // across the tile's two 8-row halves, and from the neighbour tiles'
    // boundary rows through shared memory.
    if (q == 0 && lane == 0) hopper::bulk_wait_read<0>();  // tile read
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int T = 4 * t + q;
      if (gq == 7) {
#pragma unroll
        for (int k2 = 0; k2 < 8; ++k2)
          bnd[wg][0][T][8 * (k2 / 2) + 2 * tq + k2 % 2] =
              acc[t][4 * (k2 / 2) + k2 % 2 + 2];
      }
      if (gq == 0) {
#pragma unroll
        for (int k2 = 0; k2 < 8; ++k2)
          bnd[wg][1][T][8 * (k2 / 2) + 2 * tq + k2 % 2] =
              acc[t][4 * (k2 / 2 + 8) + k2 % 2];
      }
    }
    wg_sync();
    const unsigned all = 0xffffffffu;
    // this thread's outputs of convs 1-4 (row 16 (4 t + q) + gq + 8 h - 1
    // of the run, columns 8 j + 2 tq, + 1) and their rows' flags: 1 an
    // output row, 2 an image's first row, 4 its last
    __nv_bfloat162 ov[2][2][4];
    int fl[2][2];
    const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
    auto put = [&](int t, int h, int j, __nv_bfloat162 o) {
      const int row = 16 * (4 * t + q) + gq + 8 * h - 1;
      *reinterpret_cast<__nv_bfloat162*>(
          tile + row * 64 + ((j ^ ((row >> 1) & 3)) << 4) + 4 * tq) = o;
    };
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int T = 4 * t + q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * T + gq + 8 * h;  // y row; output row m - 1
        const int p = m0 - 1 + m;           // its pixel
        const int px = p < 0 ? 0 : p % W;  // its column
        float v[8];
#pragma unroll
        for (int k2 = 0; k2 < 8; ++k2) {  // column 8 (k2/2) + 2 tq + k2%2
          const int a0 = 4 * (k2 / 2) + k2 % 2, a2 = a0 + 32;
          const int col = 8 * (k2 / 2) + 2 * tq + k2 % 2;
          const float up0 = __shfl_up_sync(all, acc[t][a0 + 2 * h], 4);
          const float wrap0 =
              __shfl_sync(all, acc[t][a0], (lane + 28) & 31);
          const float dn2 = __shfl_down_sync(all, acc[t][a2 + 2 * h], 4);
          const float wrap2 =
              __shfl_sync(all, acc[t][a2 + 2], (lane + 4) & 31);
          float left, right;
          if (h == 0) {
            left = gq > 0 ? up0 : T > 0 ? bnd[wg][0][T - 1][col] : 0.f;
            right = gq < 7 ? dn2 : wrap2;
          } else {
            left = gq > 0 ? up0 : wrap0;
            right = gq < 7 ? dn2 : T < 7 ? bnd[wg][1][T + 1][col] : 0.f;
          }
          float v1 = acc[t][a0 + 16 + 2 * h];
          if (px > 0) v1 = left + v1;
          if (px < W - 1) v1 += right;
          v[k2] = v1 + bv[k2];
        }
        const int row = m - 1;
        fl[t][h] = 0;
        if (row < 0 || row >= OUTS) continue;  // not an output row
        const int y = p / W % H;
        // the up copy goes to the row below: zero from an image's last
        // row; the dn copy to the row above: zero from its first row
        fl[t][h] = 1 | (y == 0 ? 2 : 0) | (y == H - 1 ? 4 : 0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v0 = v[2 * j], v1 = v[2 * j + 1];
          __nv_bfloat162 o;
          if (conv < 4) {
            o = __floats2bfloat162_rn(rdb::leaky(v0), rdb::leaky(v1));
            ov[t][h][j] = o;
            if (m0 < W && p >= W && p < M)  // the dn copy: see below
              *reinterpret_cast<__nv_bfloat162*>(
                  buf + (size_t)(p - W) * ILV + STRIDE * chunk + 2 * G +
                  8 * j + 2 * tq) = fl[t][h] & 2 ? zero2 : o;
          } else {  // x + scale * out; x from the block input
            const float2 xv =
                p < M ? __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(
                                x + (size_t)p * CH + co0 + 8 * j + 2 * tq))
                      : make_float2(0.f, 0.f);
            o = __floats2bfloat162_rn(v0 * scale + xv.x, v1 * scale + xv.y);
          }
          put(t, h, j, o);
        }
      }
    }
    // The stores, each from the tile as it stands: mid (or conv 5's out);
    // then, once it has been read, the up copy (an image's last rows
    // zeroed) and the dn copy (its first rows zeroed, the last restored).
    // Each box starts inside its tensor (boxes that started before row 0
    // or past the end raised an illegal instruction on the card): a run
    // whose up copies all fall past the buffer skips that store, and a
    // run that starts in the buffer's first W rows wrote its dn copies
    // above.
    hopper::fence_proxy_async();
    wg_sync();
    if (q == 0 && lane == 0) {
      hopper::tma_store_4d(&st_map, tile_u, conv < 4 ? STRIDE * chunk + G
                                                     : co0, m0, 0, 0);
      hopper::bulk_commit();
    }
    if (conv < 4) {
#pragma unroll
      for (int copy = 0; copy < 2; ++copy) {  // up, then dn
        if (q == 0 && lane == 0) hopper::bulk_wait_read<0>();
        wg_sync();
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int f = fl[t][h];
            const bool zero = copy == 0 ? (f & 4) != 0 : (f & 2) != 0;
            const bool back = copy == 1 && (f & 4) != 0;
            if (zero || back)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                put(t, h, j, zero ? zero2 : ov[t][h][j]);
          }
        hopper::fence_proxy_async();
        wg_sync();
        if (q == 0 && lane == 0) {
          if (copy == 0 && m0 + W < M)
            hopper::tma_store_4d(&st_map, tile_u, STRIDE * chunk, m0 + W, 0,
                                 0);
          if (copy == 1 && m0 >= W)
            hopper::tma_store_4d(&dn_map, tile_u, STRIDE * chunk + 2 * G,
                                 m0 - W, 0, 0);
          hopper::bulk_commit();
        }
      }
    }
  }
  if (q == 0 && lane == 0) hopper::bulk_wait<0>();
}

// ------------------------------------------------------------- launches

// The six launches of one bf16 block forward on `stream`; returns the
// first launch's error (0 on success).  Grids: slot_ctas for convs 1-4,
// (slot_ctas, 2) for conv 5 (ops/rdb.py ilv_schedule mirrors them and
// the ring; schedule_of reports them).
template <typename TW>
cudaError_t launch_bf16(const __nv_bfloat16* x, __nv_bfloat16* buf,
                        __nv_bfloat16* out, const Weights<TW>& w,
                        const float* const* bias, __nv_bfloat16* wpack,
                        int B, int H, int W, float scale, cudaStream_t s) {
  const int M = B * H * W;
  const int xblocks =
      (int)(((long long)M * X_WORDS + PREP_NT - 1) / PREP_NT);
  const int zblocks = (32 * W + PREP_NT - 1) / PREP_NT;
  const int wblocks = (WPACK / 8 + PREP_NT - 1) / PREP_NT;
  rdb_fwd_ilv_prep<TW><<<xblocks + zblocks + wblocks, PREP_NT, 0, s>>>(
      x, buf, w, wpack, M, H, W, xblocks, zblocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int dn_rows = M > W ? M - W : 1;
  CUtensorMap in_map, half_map, buf_map, dn_map, out_map;
  if (!tensor_map(&in_map, buf, ILV, M, 1, 1, M, 64, RUN, 1,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&half_map, buf, ILV, M, 1, 1, M, G, RUN, 1,
                  CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tensor_map(&buf_map, buf, ILV, M, 1, 1, M, G, OUTS, 1,
                  CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tensor_map(&dn_map, buf, ILV, dn_rows, 1, 1, dn_rows, G, OUTS, 1,
                  CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tensor_map(&out_map, out, CH, M, 1, 1, M, G, OUTS, 1,
                  CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  if ((err = allow_smem(rdb_fwd_ilv_conv, SMEM_DYN)) != cudaSuccess)
    return err;
  for (int i = 0; i < 5; ++i) {
    const int g = slot_ctas(i, M);
    const dim3 grid = i < 4 ? dim3(g) : dim3(g, 2);
    rdb_fwd_ilv_conv<<<grid, CONV_NT, slot_smem(i), s>>>(
        in_map, half_map, i < 4 ? buf_map : out_map, dn_map, buf, x, wpack,
        bias[i], M, H, W, i, scale, slot_ring(i));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The schedule launch_bf16 runs at (B, H, W), into out[SCHEDULE_INTS]:
// runs, the CTAs of convs 1-4 and of each of conv 5's halves, then per
// slot its K stages, its ring stages and its dynamic shared memory
// (bytes).
constexpr int SCHEDULE_INTS = 3 + 3 * NSLOTS;
inline void schedule_of(int B, int H, int W, int* out) {
  const int M = B * H * W;
  out[0] = runs_of(M);
  out[1] = slot_ctas(0, M);
  out[2] = slot_ctas(4, M);
  for (int s = 0; s < NSLOTS; ++s) {
    out[3 + s] = slot_kst(s);
    out[3 + NSLOTS + s] = slot_ring(s);
    out[3 + 2 * NSLOTS + s] = slot_smem(s);
  }
}

}  // namespace ilv_sm90

// `device` made current, unless it is already.
cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

}  // namespace

extern "C" {

// One bf16 block forward: x (B, H, W, 64) -> the (B*H*W, 576) buffer and
// out (B, H, W, 64).  The five kernels come as pointers and (ky, kx, ci,
// co) element strides, f32 (w_f32 = 1) or bf16, the biases as f32
// pointers; `wpack` is scratch for WPACK bf16.  Returns the cudaError_t
// of the first launch that failed (0 on success), as the entries below.
int rdb_ilv_bf16_launch(const void* x, void* buf, void* out,
                        const void* const* wptr, const long long* wstride,
                        int w_f32, const void* const* bptr, void* wpack,
                        int B, int H, int W, float scale, int device,
                        void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* bb = static_cast<__nv_bfloat16*>(buf);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* wpb = static_cast<__nv_bfloat16*>(wpack);
  const float* bias[5];
  for (int i = 0; i < 5; ++i) bias[i] = static_cast<const float*>(bptr[i]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_f32)
    err = ilv_sm90::launch_bf16(xb, bb, ob,
                                rdb::weights_of<float>(wptr, wstride), bias,
                                wpb, B, H, W, scale, s);
  else
    err = ilv_sm90::launch_bf16(
        xb, bb, ob, rdb::weights_of<__nv_bfloat16>(wptr, wstride), bias,
        wpb, B, H, W, scale, s);
  return (int)err;
}

// The bf16 forward's schedule at (B, H, W) (ilv_sm90::schedule_of).
int rdb_ilv_bf16_schedule(int B, int H, int W, int* out) {
  ilv_sm90::schedule_of(B, H, W, out);
  return 0;
}

// The f32 block forward (3xTF32, csrc/rdb_ilv_tf32_sm90.cuh): x (B, H,
// W, 64) -> the (B*H*W, 576) buffer and out (B, H, W, 64).  The five f32
// kernels come as pointers and (ky, kx, ci, co) element strides, the
// biases as f32 pointers; `wpack` is scratch for ilv_tf32::WPACK f32.
int rdb_ilv_tf32_launch(const void* x, void* buf, void* out,
                        const void* const* wptr, const long long* wstride,
                        const void* const* bptr, void* wpack, int B, int H,
                        int W, float scale, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const float* bias[5];
  for (int i = 0; i < 5; ++i) bias[i] = static_cast<const float*>(bptr[i]);
  return (int)ilv_tf32::launch_tf32(
      static_cast<const float*>(x), static_cast<float*>(buf),
      static_cast<float*>(out), rdb::weights_of<float>(wptr, wstride), bias,
      static_cast<float*>(wpack), B, H, W, scale,
      static_cast<cudaStream_t>(stream));
}

// The f32 forward's schedule at (B, H, W) (ilv_tf32::schedule_of).
int rdb_ilv_tf32_schedule(int B, int H, int W, int* out) {
  ilv_tf32::schedule_of(B, H, W, out);
  return 0;
}

const char* rdb_ilv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
