// Residual dense block (RDB) on a row-extended feature buffer, forward
// and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels torchsr_tpu/ops/pallas/rdb.py:299
// (_rdb_fwd_kernel_ext) and rdb.py:594 (_rdb_bwd_kernel_ext), selected
// there by TORCHSR_RDB_EXT=1 on shapes that pass _ext_eligible (:406:
// H*W <= 4096 and W % 16 == 0).  The math is that of csrc/rdb_fwd.cu and
// csrc/rdb_bwd.cu (five dense 3x3 SAME convs, C_in = 64 + 32 i, C_out 32
// or 64; bias, LeakyReLU(0.2) on convs 1-4, x + scale * conv5; the
// backward from g and the saved post-activation buffer, LeakyReLU' from
// its sign, dW/db/dF in f32); what differs is the layout.
//
// Layout.  The TPU kernel keeps one image per grid step in a (H*W + 2W)
// row buffer with W zero rows at each end, so the three dy operands of a
// conv are row-offset views (0, W, 2W) of one store and no row needs a
// mask.  Here the whole batch is one such buffer in device memory:
// (B, H + 2, W, C) NHWC, each image between a zero pad row above and one
// below.  Read as one tall image of R = B * (H + 2) rows, every 3x3
// window centred on a data row reads rows of its own image or that
// image's pad rows, so the staging has no row predicates: only the
// column edges (x = -1, x = W) are masked, as first_col/last_col are on
// the TPU.  A tile row that falls past the buffer's ends is clamped to
// the nearest row; it feeds only outputs on pad rows, which are never
// stored (forward) or multiply a zero dy (wgrad).  W % 16 == 0 (the gate)
// makes the 16-column tiles exact.  The forward computes the 2 pad rows
// of each image too and drops them: 2 / (H + 2) extra work (3% at the
// serving shape, 6% at the training shape).
//
// Forward (five launches of conv_bf16 / conv_f32 with FwdEpi): launch i
// reads channels [0, C_in) of the buffer and writes [C_in, C_in + 32) of
// its data rows; the wrapper zeroes both pad rows of every image (all
// 192 channels) and copies x into channels [0, 64) first.  Launch 5
// writes out = x + scale * (conv5 + b5), unpadded.
//
// Backward, bf16 (AMP): the eight launches of csrc/rdb_bwd_sm90.cuh (B2's
// kernels) with the layout's row stride and offset: image b's row y is
// buffer row b (H + 2) + 1 + y.  DY = [dy_0 | ... | dy_4] takes the same
// (B, H + 2, W, 192) layout, its pad rows zeroed by the prep launch; the
// halo staging zero-fills rows outside the image (cp.async), so pad rows
// are never read.  The TPU kernel's row-offset scatter of dx3 = dy @ W^T
// into a padded f32 dF (rdb.py:594) becomes each slot's gather conv over
// DY, and no dF exists.
//
// Backward, f32 (per conv, i = 4..0: prep, wgrad, reduce, dgrad):
//  * prep writes dy_i into DY over the whole tall layout: da_i on data
//    rows (from g, or from dF's slot of conv i times LeakyReLU'), zeros
//    on pad rows, with f32 block partials of da_i for db.
//  * wgrad: dW_i = sum over the tall image of feat[r + dy - 1] *
//    dy_i[r] (the row-offset views of the padded feat); pad rows carry
//    dy = 0 and add nothing.  Per-CTA f32 partials, summed by
//  * reduce in a fixed order (deterministic; no atomics), as in
//    rdb_bwd.cu.
//  * dgrad GATHERS instead of the TPU's sequential scatter: each CTA owns
//    its dF rows and computes them as the direct conv of the zero-padded
//    dy_i with the flipped, transposed kernel, over every row of the tall
//    layout, pad rows included (they hold the out-of-image contributions,
//    never read back).  Every dF element has one writer.  Conv 5 stores
//    dF, the others add into it; conv 1 also writes dx = dF[data rows,
//    :64] + g, unpadded.
//
// GEMM formulation.  Each conv is B1's direct conv (nine taps, each an
// implicit GEMM over C_in), not the TPU kernel's N-packed product (N = 3
// C_out carrying the horizontal taps, reduced in an epilogue): the same
// products summed in the same order as B1, so the forward equals B1's
// bit for bit and only the layout differs between the two.
//
// Forward bf16 (AMP): mma.sync m16n8k16 bf16 -> f32 fed by ldmatrix; a
// CTA is 8 warps over a 16 x 16 pixel tile, each warp two rows of 16
// pixels.  f32: FFMA on the CUDA cores (tensor cores would round to TF32), 8 x 16
// tiles, 4 pixels x 8 channels per thread.
//
// Bound on this card (H100 SXM).  Forward at the serving shape (16, 64,
// 64, 64): 31.4 GFLOP, 0.0318 ms at 989 TFLOP/s bf16 (0.469 ms at 67
// TFLOP/s f32); its bytes (x in, out) 16.8 MB bf16, 0.005 ms: compute-
// bound, as B1.  Backward at the training shape (64, 32, 32, 64): 62.8
// GFLOP, 0.0635 ms bf16 (0.94 ms f32) against 0.013 ms of bytes.  Like
// B1 the forward stages synchronously on mma.sync; wgmma is later work.

#include "rdb_bwd_sm90.cuh"
#include "rdb_mma.cuh"

namespace {

using rdb::allow_smem;
using rdb::leaky;
using rdb::load2;
using rdb::store2;

constexpr int FEAT = 192;   // feature buffer width
constexpr int CH = 64;      // block input/output channels
constexpr int NT = 256;     // threads of a bf16 conv / wgrad CTA
constexpr int CCHUNK = 32;  // wgrad input channels / dgrad dF channels per CTA

// The tall layout: R = B * (H + 2) rows of W pixels.
struct Tall {
  int H, W, R;

  __device__ __forceinline__ int clamp_row(int r) const {
    return min(max(r, 0), R - 1);
  }
  // The unpadded NHWC pixel index of row r's column 0, or -1 when r is
  // one of an image's two pad rows.  Epilogues take it once per row.
  __device__ __forceinline__ long long data_row(int r) const {
    const int b = r / (H + 2), y = r % (H + 2) - 1;
    return y >= 0 && y < H ? ((long long)b * H + y) * W : -1;
  }
};

// ------------------------------------------------------------ epilogues

// An epilogue's row(r) resolves row r's addresses once; the Row it
// returns takes the accumulators of channels co, co + 1 at column x.

// Forward conv with C_in = CIN: bias, then LeakyReLU into channels
// [CIN, CIN + 32) of the buffer's data rows, or (LAST) out = x + scale *
// (conv5 + b5) unpadded.  Outputs on pad rows are dropped.
template <typename T, int CIN, bool LAST>
struct FwdEpi {
  T* buf;
  const float* bias;
  T* out;
  float scale;
  Tall t;

  struct Row {
    const T* src;  // the buffer's row r at column 0
    T* dst;        // where column 0's outputs go; nullptr on a pad row
    const float* bias;
    float scale;

    __device__ __forceinline__ void operator()(int x, int co, float v0,
                                               float v1) const {
      if (dst == nullptr) return;
      v0 += bias[co];
      v1 += bias[co + 1];
      if constexpr (LAST) {
        const float2 r = load2(src + (size_t)x * FEAT + co);
        store2(dst + (size_t)x * CH + co, v0 * scale + r.x,
               v1 * scale + r.y);
      } else {
        store2(dst + (size_t)x * FEAT + CIN + co, leaky(v0), leaky(v1));
      }
    }
  };

  __device__ __forceinline__ Row row(int r) const {
    const long long q = t.data_row(r);
    T* src = buf + (size_t)r * t.W * FEAT;
    return Row{src, q < 0 ? nullptr : LAST ? out + q * CH : src, bias,
               scale};
  }
};

// dgrad: dF (f32, tall) channels co, co + 1 of every row, stored or
// (ACCUM) added; FINAL also writes dx = dF + g on data rows.
template <typename T, bool ACCUM, bool FINAL>
struct DgradEpi {
  float* dF;
  const T* g;
  T* dx;
  Tall t;

  struct Row {
    float* d;    // dF's row r at column 0
    const T* g;  // g's and dx's row at column 0; nullptr on a pad row
    T* dx;

    __device__ __forceinline__ void operator()(int x, int co, float v0,
                                               float v1) const {
      float* p = d + (size_t)x * FEAT + co;
      if constexpr (ACCUM) {
        const float2 a = load2(p);
        v0 += a.x;
        v1 += a.y;
      }
      store2(p, v0, v1);
      if constexpr (FINAL) {
        if (dx == nullptr) return;
        const size_t q = (size_t)x * CH + co;
        const float2 gv = load2(g + q);
        store2(dx + q, v0 + gv.x, v1 + gv.y);
      }
    }
  };

  __device__ __forceinline__ Row row(int r) const {
    const long long q = t.data_row(r);
    return Row{dF + (size_t)r * t.W * FEAT, q < 0 ? nullptr : g + q * CH,
               q < 0 ? nullptr : dx + q * CH};
  }
};

// ------------------------------------------------------- bf16 direct conv

namespace tensor_core {

using rdb::ldmatrix_x4;
using rdb::mma_bf16;

constexpr int TH = 16;  // tile rows: two per warp
constexpr int TW = 16;  // tile columns: one 16-pixel M tile
constexpr int HALO_W = TW + 2;
constexpr int HALO_PX = (TH + 2) * HALO_W;
constexpr int KC = 32;           // input channels per stage
constexpr int LDS = KC + 8;      // 80-byte rows: ldmatrix conflict-free

template <int NOUT>
constexpr size_t conv_smem() {
  return (size_t)(HALO_PX + 9 * NOUT) * LDS * sizeof(__nv_bfloat16);
}

// A 3x3 SAME conv over the tall layout: src (R, W, LD_SRC), channels
// [0, CIN); w HWIO (3, 3, CIN, WN), output channels [co0, co0 + NOUT)
// with co0 = NOUT * blockIdx.z.  Rows are not predicated (see the
// header); columns outside [0, W) are zero.
// At most 128 registers a thread (two CTAs an SM): conv 5 takes 134
// without the cap, which leaves one CTA an SM and runs ~25% slower.
template <int CIN, int LD_SRC, int WN, int NOUT, class Epi>
__global__ void __launch_bounds__(NT, 2)
conv_bf16(const __nv_bfloat16* __restrict__ src,
          const __nv_bfloat16* __restrict__ w, Epi epi, Tall t) {
  static_assert(CIN % KC == 0 && NOUT % 16 == 0, "channel tiling");
  constexpr int NTILES = NOUT / 8;
  extern __shared__ __align__(16) __nv_bfloat16 smem_c[];
  __nv_bfloat16* in_s = smem_c;                 // [HALO_PX][LDS]
  __nv_bfloat16* w_s = smem_c + HALO_PX * LDS;  // [9][NOUT][LDS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int co0 = blockIdx.z * NOUT;

  float acc[2][NTILES][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < NTILES; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;

  for (int c0 = 0; c0 < CIN; c0 += KC) {
    __syncthreads();  // the previous stage is fully consumed
    for (int i = tid; i < HALO_PX * (KC / 8); i += NT) {
      const int px = i / (KC / 8), ch = i % (KC / 8);
      const int r = t.clamp_row(r0 - 1 + px / HALO_W);
      const int gx = x0 - 1 + px % HALO_W;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gx >= 0 && gx < t.W)
        v = *reinterpret_cast<const uint4*>(
            src + ((size_t)r * t.W + gx) * LD_SRC + c0 + ch * 8);
      *reinterpret_cast<uint4*>(in_s + px * LDS + ch * 8) = v;
    }
    // weights HWIO -> [tap][co][ci]
    for (int i = tid; i < 9 * (NOUT / 8) * KC; i += NT) {
      const int ci = i % KC, q = i / KC;
      const int tap = q / (NOUT / 8), co = (q % (NOUT / 8)) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(
          w + ((size_t)tap * CIN + c0 + ci) * WN + co0 + co);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w_s[(tap * NOUT + co + k) * LDS + ci] = e[k];
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
          ldmatrix_x4(a[j], in_s + ((2 * warp + j + ky) * HALO_W + kx +
                                    (lane % 16)) * LDS +
                                ks * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NTILES / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, w_s + (tap * NOUT + np * 16 + (lane % 8) +
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

  // C fragment: pixels g and g + 8 of the row's M tile, channels 2q, 2q+1
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + 2 * warp + j;
    if (r >= t.R) continue;
    const auto row = epi.row(r);
#pragma unroll
    for (int n = 0; n < NTILES; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        row(x0 + g + 8 * h, co0 + n * 8 + 2 * q, acc[j][n][2 * h],
            acc[j][n][2 * h + 1]);
  }
}

}  // namespace tensor_core

// -------------------------------------------------------- f32 direct conv

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

template <int NOUT>
__host__ __device__ constexpr int threads_for() {
  return PGROUPS * (NOUT / CO);
}

template <int NOUT>
constexpr size_t conv_smem() {
  return (size_t)(KC * IN_LD + 9 * KC * NOUT) * sizeof(float);
}

// As tensor_core::conv_bf16, in f32 FFMA: the thread layout of
// rdb_fwd.cu's conv3x3_f32.
template <int CIN, int LD_SRC, int WN, int NOUT, class Epi>
__global__ void __launch_bounds__(threads_for<NOUT>())
conv_f32(const float* __restrict__ src, const float* __restrict__ w,
         Epi epi, Tall t) {
  static_assert(CIN % KC == 0 && NOUT % CO == 0, "channel tiling");
  constexpr int NCOG = NOUT / CO;
  constexpr int NTH = threads_for<NOUT>();
  extern __shared__ __align__(16) float smem_f[];
  float* in_s = smem_f;              // [KC][IN_LD]
  float* w_s = smem_f + KC * IN_LD;  // [9][KC][NOUT]

  const int tid = threadIdx.x;
  const int cog = tid % NCOG, pg = tid / NCOG;
  const int ty = pg / (TW / PX), tx0 = (pg % (TW / PX)) * PX;
  const int r0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int co0 = blockIdx.z * NOUT;

  float acc[PX][CO];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[p][c] = 0.f;

  for (int c0 = 0; c0 < CIN; c0 += KC) {
    __syncthreads();
    for (int i = tid; i < HALO_PX * KC; i += NTH) {
      const int px = i / KC, ci = i % KC;
      const int r = t.clamp_row(r0 - 1 + px / HALO_W);
      const int gx = x0 - 1 + px % HALO_W;
      float v = 0.f;
      if (gx >= 0 && gx < t.W)
        v = src[((size_t)r * t.W + gx) * LD_SRC + c0 + ci];
      in_s[ci * IN_LD + px] = v;
    }
    for (int i = tid; i < 9 * KC * NOUT; i += NTH) {
      const int tap = i / (KC * NOUT), q = i % (KC * NOUT);
      w_s[i] = w[((size_t)tap * CIN + c0 + q / NOUT) * WN + co0 + q % NOUT];
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
              w_s + ((ky * 3 + kx) * KC + ci) * NOUT + cog * CO);
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

  const int r = r0 + ty;
  if (r >= t.R) return;
  const auto row = epi.row(r);
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int c = 0; c < CO; c += 2)
      row(x0 + tx0 + p, co0 + cog * CO + c, acc[p][c], acc[p][c + 1]);
}

// ----------------------------------------------------------- f32 wgrad

constexpr int WTH = 16;  // wgrad tile: 16 x 16 pixels, as in bf16
constexpr int WTW = 16;
constexpr int WHALO_W = WTW + 2;
constexpr int WHALO_PX = (WTH + 2) * WHALO_W;
constexpr int LDX = CCHUNK + 1;  // odd: conflict-free staging

template <int COUT>
constexpr size_t wgrad_smem() {
  return ((size_t)WHALO_PX * LDX + (size_t)WTH * WTW * COUT) * sizeof(float);
}

// part[grp]: this CTA's (3, 3, CIN, COUT) f32 partial of dW for input
// channels [32 blockIdx.y, +32) over the tall-layout tiles grp, grp +
// groups, ...; dy_i is DY's channels CIN - 64 .. +COUT.  Thread t owns
// input channel t % 32 and the C_out / 8 output channels of group t / 32,
// nine taps.
template <int CIN, int COUT>
__global__ void __launch_bounds__(NT)
wgrad_f32(const float* __restrict__ feat, const float* __restrict__ dy,
          float* __restrict__ part, int groups, Tall t) {
  constexpr int CT = COUT / 8;
  extern __shared__ __align__(16) float smem_wf[];
  float* in_s = smem_wf;                   // [WHALO_PX][LDX]
  float* dy_s = smem_wf + WHALO_PX * LDX;  // [WTH * WTW][COUT]

  const int tid = threadIdx.x;
  const int ci = tid % 32, cog = tid / 32;
  const int c0 = blockIdx.y * CCHUNK;
  const int grp = blockIdx.x;
  const int tiles_x = t.W / WTW;
  const int n_tiles = ((t.R + WTH - 1) / WTH) * tiles_x;

  float acc[9][CT];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[tap][j] = 0.f;

  for (int tl = grp; tl < n_tiles; tl += groups) {
    const int r0 = (tl / tiles_x) * WTH, x0 = (tl % tiles_x) * WTW;
    __syncthreads();
    for (int i = tid; i < WHALO_PX * CCHUNK; i += NT) {
      const int px = i / CCHUNK, c = i % CCHUNK;
      const int r = t.clamp_row(r0 - 1 + px / WHALO_W);
      const int gx = x0 - 1 + px % WHALO_W;
      float v = 0.f;
      if (gx >= 0 && gx < t.W)
        v = feat[((size_t)r * t.W + gx) * FEAT + c0 + c];
      in_s[px * LDX + c] = v;
    }
    for (int i = tid; i < WTH * WTW * COUT; i += NT) {
      const int p = i / COUT, c = i % COUT;
      const int r = t.clamp_row(r0 + p / WTW);
      dy_s[i] = dy[((size_t)r * t.W + x0 + p % WTW) * FEAT + CIN - CH + c];
    }
    __syncthreads();

#pragma unroll 2
    for (int p = 0; p < WTH * WTW; ++p) {
      const int ty = p / WTW, tx = p % WTW;
      float d[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) d[j] = dy_s[p * COUT + cog * CT + j];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float xv =
            in_s[((ty + tap / 3) * WHALO_W + tx + tap % 3) * LDX + ci];
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

}  // namespace cuda_core

// ---------------------------------------------------------------- prep

// f32 dy_i into DY (channels 32 STAGE .. +C_out) over the whole tall
// layout (npix = R * W pixels): da_i on data rows, zero on pad rows;
// per-block f32 partial sums of da_i.  STAGE 4 reads g (unpadded, M x
// 64) and scales it; stages 0..3 read the f32 dF's slot [lo, lo + 32)
// and the sign of the same slot of feat.
template <int STAGE>
__global__ void __launch_bounds__(NT)
prep(const float* __restrict__ src, const float* __restrict__ feat,
     float* __restrict__ dy, float* __restrict__ db_part, int npix, int ppb,
     float scale, Tall t) {
  constexpr int COUT = STAGE == 4 ? CH : 32;
  constexpr int ROWS = NT / COUT;
  constexpr int LO = CH + 32 * STAGE;  // conv STAGE's output slot
  __shared__ float red[NT];
  const int c = threadIdx.x % COUT, rr = threadIdx.x / COUT;
  const int p0 = blockIdx.x * ppb;
  const int p1 = min(p0 + ppb, npix);
  float sum = 0.f;
  for (int p = p0 + rr; p < p1; p += ROWS) {
    const long long q = t.data_row(p / t.W);
    float da = 0.f;
    if (q >= 0) {
      if constexpr (STAGE == 4) {
        da = src[(q + p % t.W) * CH + c] * scale;
      } else {
        const float act = feat[(size_t)p * FEAT + LO + c];
        da = src[(size_t)p * FEAT + LO + c] *
             (0.2f + 0.8f * (act > 0.f ? 1.f : 0.f));
      }
    }
    dy[(size_t)p * FEAT + 32 * STAGE + c] = da;
    sum += da;
  }
  red[threadIdx.x] = sum;
  __syncthreads();
  if (rr == 0) {
    float total = 0.f;
    for (int k = 0; k < ROWS; ++k) total += red[k * COUT + c];
    db_part[(size_t)blockIdx.x * COUT + c] = total;
  }
}

// ------------------------------------------------------------ launches

Tall tall_of(int B, int H, int W) { return Tall{H, W, B * (H + 2)}; }

// One conv over the tall layout with epilogue `epi`, NOUT output
// channels per CTA and WN / NOUT CTAs in z.
template <int CIN, int LD_SRC, int WN, int NOUT, typename T, class Epi>
cudaError_t launch_conv(const void* src, const void* w, Epi epi, Tall t,
                        cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    namespace tc = tensor_core;
    auto kernel = tc::conv_bf16<CIN, LD_SRC, WN, NOUT, Epi>;
    constexpr size_t smem = tc::conv_smem<NOUT>();
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(t.W / tc::TW, (t.R + tc::TH - 1) / tc::TH, WN / NOUT);
    kernel<<<grid, NT, smem, s>>>(static_cast<const __nv_bfloat16*>(src),
                                  static_cast<const __nv_bfloat16*>(w), epi,
                                  t);
  } else {
    namespace cc = cuda_core;
    auto kernel = cc::conv_f32<CIN, LD_SRC, WN, NOUT, Epi>;
    constexpr size_t smem = cc::conv_smem<NOUT>();
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(t.W / cc::TW, (t.R + cc::TH - 1) / cc::TH, WN / NOUT);
    kernel<<<grid, cc::threads_for<NOUT>(), smem, s>>>(
        static_cast<const float*>(src), static_cast<const float*>(w), epi,
        t);
  }
  return cudaGetLastError();
}

template <int CIN, int COUT, bool LAST, typename T>
cudaError_t launch_fwd(void* buf, const void* w, const void* bias, void* out,
                       float scale, Tall t, cudaStream_t s) {
  FwdEpi<T, CIN, LAST> epi{static_cast<T*>(buf),
                           static_cast<const float*>(bias),
                           static_cast<T*>(out), scale, t};
  return launch_conv<CIN, FEAT, COUT, COUT, T>(buf, w, epi, t, s);
}

template <int CIN, int COUT, bool LAST>
cudaError_t fwd(bool bf16, void* buf, const void* w, const void* bias,
                void* out, float scale, Tall t, cudaStream_t s) {
  return bf16 ? launch_fwd<CIN, COUT, LAST, __nv_bfloat16>(buf, w, bias, out,
                                                           scale, t, s)
              : launch_fwd<CIN, COUT, LAST, float>(buf, w, bias, out, scale,
                                                   t, s);
}

// f32 dgrad of conv (CIN_I -> COUT_I): dy_i is DY's channels CIN_I - 64
// .. +COUT_I, the kernel wt is (3, 3, COUT_I, CIN_I), and dF channels
// [0, CIN_I) are written.
template <int CIN_I, int COUT_I, bool ACCUM, bool FINAL>
cudaError_t dgrad(const void* dy, const void* wt, void* dF, const void* g,
                  void* dx, Tall t, cudaStream_t s) {
  DgradEpi<float, ACCUM, FINAL> epi{static_cast<float*>(dF),
                                    static_cast<const float*>(g),
                                    static_cast<float*>(dx), t};
  return launch_conv<COUT_I, FEAT, CIN_I, CCHUNK, float>(
      static_cast<const float*>(dy) + (CIN_I - CH), wt, epi, t, s);
}

template <int STAGE>
cudaError_t launch_prep(const void* src, const void* feat, void* dy,
                        void* db_part, int nblocks, float scale, Tall t,
                        cudaStream_t s) {
  const int npix = t.R * t.W;
  const int ppb = (npix + nblocks - 1) / nblocks;
  prep<STAGE><<<nblocks, NT, 0, s>>>(
      static_cast<const float*>(src), static_cast<const float*>(feat),
      static_cast<float*>(dy), static_cast<float*>(db_part), npix, ppb,
      scale, t);
  return cudaGetLastError();
}

template <int CIN, int COUT>
cudaError_t launch_wgrad(const void* feat, const void* dy, void* part,
                         int groups, Tall t, cudaStream_t s) {
  auto kernel = cuda_core::wgrad_f32<CIN, COUT>;
  constexpr size_t smem = cuda_core::wgrad_smem<COUT>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(groups, CIN / CCHUNK), NT, smem, s>>>(
      static_cast<const float*>(feat), static_cast<const float*>(dy),
      static_cast<float*>(part), groups, t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward conv `stage` of a block on the (B, H + 2, W, 192) buffer `feat`
// (pad rows zero, x in channels [0, 64)): stages 0..3 append 32 channels
// to its data rows, stage 4 writes out (B, H, W, 64).  W % 16 == 0.
// Returns the cudaError_t of the launch (0 on success), as every entry
// point below.
int rdb_ext_fwd_launch(int stage, int is_bf16, void* feat, const void* w,
                       const void* bias, void* out, int B, int H, int W,
                       float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (W % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  const Tall t = tall_of(B, H, W);
  switch (stage) {
    case 0: return (int)fwd<64, 32, false>(bf16, feat, w, bias, out, scale, t, s);
    case 1: return (int)fwd<96, 32, false>(bf16, feat, w, bias, out, scale, t, s);
    case 2: return (int)fwd<128, 32, false>(bf16, feat, w, bias, out, scale, t, s);
    case 3: return (int)fwd<160, 32, false>(bf16, feat, w, bias, out, scale, t, s);
    case 4: return (int)fwd<192, 64, true>(bf16, feat, w, bias, out, scale, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 block backward on the (B, H + 2, W, 192) buffer `feat`: the
// eight launches of csrc/rdb_bwd_sm90.cuh on the row-extended layout, DY
// in the same layout with its pad rows zero; arguments as
// rdb_bwd.cu's rdb_bwd_bf16_launch.
int rdb_ext_bwd_bf16_launch(const void* g, const void* feat, const void* wptr,
                            const void* wstride, int w_f32, void* dy,
                            void* dx, void* wpack, void* dw_part,
                            void* db_part, void* dw, void* db, int B, int H,
                            int W, float scale, int nblocks, int P,
                            int g_conv, int g_dx, int g_wgrad, int device,
                            void* stream) {
  return rdb_bwd_sm90::launch_bwd_entry(
      g, feat, static_cast<const void* const*>(wptr),
      static_cast<const long long*>(wstride), w_f32, dy, dx, wpack, dw_part,
      db_part, dw, db, B, H, W, 1, scale, nblocks, P, g_conv, g_dx, g_wgrad,
      device, stream);
}

// f32 prep of conv `stage`: src is g (B, H, W, 64) for stage 4, else the
// f32 tall dF; writes dy_stage into the tall DY (R * W, 192) over every
// row (pad rows zero) and `nblocks` rows of partial db sums.
int rdb_ext_prep_launch(int stage, const void* src, const void* feat,
                        void* dy, void* db_part, int B, int H, int W,
                        int nblocks, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tall t = tall_of(B, H, W);
  switch (stage) {
    case 0: return (int)launch_prep<0>(src, feat, dy, db_part, nblocks, scale, t, s);
    case 1: return (int)launch_prep<1>(src, feat, dy, db_part, nblocks, scale, t, s);
    case 2: return (int)launch_prep<2>(src, feat, dy, db_part, nblocks, scale, t, s);
    case 3: return (int)launch_prep<3>(src, feat, dy, db_part, nblocks, scale, t, s);
    case 4: return (int)launch_prep<4>(src, feat, dy, db_part, nblocks, scale, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f32 wgrad of conv `stage`: `groups` f32 partials of dW, (groups, 3, 3,
// C_in, C_out), into part, from the tall feat and DY.
int rdb_ext_wgrad_launch(int stage, const void* feat, const void* dy,
                         void* part, int B, int H, int W, int groups,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (W % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tall t = tall_of(B, H, W);
  switch (stage) {
    case 0: return (int)launch_wgrad<64, 32>(feat, dy, part, groups, t, s);
    case 1: return (int)launch_wgrad<96, 32>(feat, dy, part, groups, t, s);
    case 2: return (int)launch_wgrad<128, 32>(feat, dy, part, groups, t, s);
    case 3: return (int)launch_wgrad<160, 32>(feat, dy, part, groups, t, s);
    case 4: return (int)launch_wgrad<192, 64>(feat, dy, part, groups, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dw (n,) = the sum of `groups` partials; db (cout,) = the sum of
// `nblocks` partial rows.
int rdb_ext_reduce_launch(const void* dw_part, int groups, int n,
                          const void* db_part, int nblocks, int cout,
                          void* dw, void* db, int device, void* stream) {
  return rdb::launch_reduce(dw_part, groups, n, db_part, nblocks, cout, dw,
                            db, device, stream);
}

// f32 dgrad of conv `stage` from the tall DY into the f32 tall dF (every
// row): wt is its flipped, transposed kernel, HWIO (3, 3, C_out, C_in);
// stage 4 stores, the others add, and stage 0 also writes dx (B, H, W,
// 64) = dF + g.
int rdb_ext_dgrad_launch(int stage, const void* dy, const void* wt, void* dF,
                         const void* g, void* dx, int B, int H, int W,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (W % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tall t = tall_of(B, H, W);
  switch (stage) {
    case 0: return (int)dgrad<64, 32, true, true>(dy, wt, dF, g, dx, t, s);
    case 1: return (int)dgrad<96, 32, true, false>(dy, wt, dF, g, dx, t, s);
    case 2: return (int)dgrad<128, 32, true, false>(dy, wt, dF, g, dx, t, s);
    case 3: return (int)dgrad<160, 32, true, false>(dy, wt, dF, g, dx, t, s);
    case 4: return (int)dgrad<192, 64, false, false>(dy, wt, dF, g, dx, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* rdb_ext_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
