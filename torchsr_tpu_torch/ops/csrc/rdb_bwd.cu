// Residual dense block (RDB) backward for Hopper (sm_90a).
//
// Replaces the TPU kernel torchsr_tpu/ops/pallas/rdb.py:495
// (_rdb_bwd_kernel, launched by _rdb_bwd :686 from the custom-VJP rule
// _fused_rdb_bwd :853).  Inputs: the output cotangent g (M, 64), M =
// B*H*W pixels in NHWC order, and the forward's (M, 192) feature buffer
// (x, then the four post-activation 32-channel slices) that
// csrc/rdb_fwd.cu filled.  The five convs are reversed in order
// i = 4..0 (C_in = 64 + 32 i, C_out = 32, or 64 for conv 5):
//
//   da_4 = scale * g;  da_i = dF[:, C_in(i) : C_in(i) + 32] * (0.2 + 0.8 [feat > 0])
//   dy_i = round(da_i) to the working dtype;  db_i = sum_p da_i
//   dW_i[ky][kx][ci][co] = sum_p feat[p + (ky-1, kx-1)][ci] * dy_i[p][co]
//   dF[:, :C_in(i)] += conv3x3(dy_i, flip(W_i) with C_in <-> C_out)
//   dx = dF[:, :64] + g
//
// dF is an f32 (M, 192) buffer in device memory (the TPU kernel keeps it
// in VMEM).  Products take working-dtype operands (bf16 under AMP, else
// f32) and accumulate in f32; dW, db and dF stay f32; dx is stored in
// g's dtype: the precision contract of rdb.py:538-577.
//
// Four kernels per conv, launched by the wrapper (ops/rdb.py):
//
//  * prep: da_i -> dy_i (working dtype) and per-block f32 partial sums
//    of da_i for db.
//  * wgrad: an implicit GEMM with M = C_in, N = C_out and K = pixels.
//    A CTA owns 32 input channels and walks a fixed set of 8 x 32 pixel
//    tiles, staging the feature tile with its 1-pixel halo (zeros
//    outside the image) and the dy tile (zeros outside the image), and
//    keeps the whole 9 x 32 x C_out product in registers.  The TPU grid
//    runs in sequence and adds each step's dW into one output block
//    (rdb.py:579-591); CTAs run in parallel, so each writes its own f32
//    partial and
//  * reduce sums the partials of dW (and of db) in a fixed order: the
//    result is deterministic, with no atomics.
//  * dgrad: the transposed conv as a direct 3x3 SAME conv of dy_i with
//    the spatially flipped, (C_in <-> C_out)-transposed kernel (built
//    by the wrapper), 32 output channels of dF per CTA, added into dF
//    (conv 5 stores, as it covers all 192 channels).  Conv 1 also
//    writes dx = dF[:, :64] + g.
//
// bf16 runs the products on the tensor cores (mma.sync m16n8k16 bf16 ->
// f32, operands by ldmatrix; wgrad reads both operands transposed with
// ldmatrix.trans, since both tiles are stored with channels fastest).
// f32 (--disable-amp) runs FFMA on the CUDA cores: tensor cores would
// round to TF32.
//
// Bound on this card (H100 SXM).  At the training shape (64, 32, 32,
// 64), 65,536 pixels, dgrad and wgrad are each 31.4 GFLOP: 62.8 GFLOP,
// 0.0635 ms at the 989 TFLOP/s bf16 peak (0.94 ms at 67 TFLOP/s f32).
// The bytes (feat and g in, dx out) are 41.9 MB in bf16, 0.013 ms at
// 3.35 TB/s: compute-bound.  This simple version stages synchronously,
// feeds mma.sync with two ldmatrix per pair of MMAs in wgrad, rereads
// the dy tile per output-channel chunk in dgrad and writes the wgrad
// partials to device memory; wgmma fed by TMA and fusing prep into the
// dgrad epilogue are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int FEAT = 192;  // feature buffer width
constexpr int CH = 64;     // block input/output channels
constexpr int TH = 8;      // tile rows
constexpr int TW = 32;     // tile columns
constexpr int HALO_W = TW + 2;
constexpr int HALO_PX = (TH + 2) * HALO_W;
constexpr int NT = 256;    // threads of a wgrad / bf16 dgrad CTA
constexpr int CCHUNK = 32;  // input channels per wgrad CTA, dF channels per dgrad CTA

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// da -> dy (working dtype T) and per-block partial sums of da.  STAGE 4
// reads g (M, 64) and scales it; stages 0..3 read dF's slice
// [lo, lo + 32) and the sign of the same slice of feat.
template <int STAGE, typename T>
__global__ void __launch_bounds__(NT)
prep(const void* __restrict__ src, const T* __restrict__ feat,
     T* __restrict__ dy, float* __restrict__ db_part, int M, int ppb,
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
      da = to_f(static_cast<const T*>(src)[(size_t)p * CH + c]) * scale;
    } else {
      const float act = to_f(feat[(size_t)p * FEAT + LO + c]);
      da = static_cast<const float*>(src)[(size_t)p * FEAT + LO + c] *
           (0.2f + 0.8f * (act > 0.f ? 1.f : 0.f));
    }
    dy[(size_t)p * COUT + c] = from_f<T>(da);
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

// -------------------------------------------------------------- reduce

// dw[e] = sum_g dw_part[g][e] (e < n); db[c] = sum_b db_part[b][c].
__global__ void __launch_bounds__(NT)
reduce_partials(const float* __restrict__ dw_part, int groups, int n,
       const float* __restrict__ db_part, int nblocks, int cout,
       float* __restrict__ dw, float* __restrict__ db) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e < n) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += dw_part[(size_t)g * n + e];
    dw[e] = s;
  } else if (e < n + cout) {
    const int c = e - n;
    float s = 0.f;
    for (int b = 0; b < nblocks; ++b) s += db_part[(size_t)b * cout + c];
    db[c] = s;
  }
}

// --------------------------------------------------------- bf16 wgrad

namespace tensor_core {

constexpr int LDS = CCHUNK + 8;  // 80-byte halo pixel rows: conflict-free

template <int COUT>
__host__ __device__ constexpr int ldy() { return COUT + 8; }  // 80 / 144-byte rows

template <int COUT>
constexpr size_t wgrad_smem() {
  return ((size_t)HALO_PX * LDS + (size_t)TH * TW * ldy<COUT>()) *
         sizeof(__nv_bfloat16);
}

// part[grp]: this CTA's (3, 3, CIN, COUT) f32 partial of dW, for input
// channels [32 blockIdx.y, 32 blockIdx.y + 32) over the tiles grp,
// grp + groups, ...  Warp w owns the 16-channel M tile w % 2 of the
// chunk, two 8-channel N tiles, and TPW of the nine taps.
template <int CIN, int COUT>
__global__ void __launch_bounds__(NT)
wgrad_bf16(const __nv_bfloat16* __restrict__ feat,
           const __nv_bfloat16* __restrict__ dy, float* __restrict__ part,
           int B, int H, int W, int groups) {
  constexpr int LDY = ldy<COUT>();
  constexpr int COMBOS = 2 * (COUT / 16);  // (M tile, N-tile pair)
  constexpr int TS = 8 / COMBOS;           // warps sharing a combo
  constexpr int TPW = (9 + TS - 1) / TS;   // taps per warp
  static_assert(COMBOS * TS == 8, "warp mapping");
  extern __shared__ __align__(16) __nv_bfloat16 smem_w[];
  __nv_bfloat16* in_s = smem_w;                  // [HALO_PX][LDS]
  __nv_bfloat16* dy_s = smem_w + HALO_PX * LDS;  // [TH * TW][LDY]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int combo = warp % COMBOS;
  const int mt = combo % 2, ng = combo / 2;
  const int tap0 = (warp / COMBOS) * TPW;
  const int c0 = blockIdx.y * CCHUNK;
  const int grp = blockIdx.x;
  const int n_tiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);

  float acc[TPW][2][4];
#pragma unroll
  for (int t = 0; t < TPW; ++t)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.f;

  for (int tl = grp; tl < n_tiles; tl += groups) {
    const Tile t = tile_of(tl, H, W);
    const size_t img = (size_t)t.b * H * W;
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < HALO_PX * (CCHUNK / 8); i += NT) {
      const int px = i / (CCHUNK / 8), ch = i % (CCHUNK / 8);
      const int gy = t.y0 - 1 + px / HALO_W, gx = t.x0 - 1 + px % HALO_W;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = *reinterpret_cast<const uint4*>(
            feat + (img + (size_t)gy * W + gx) * FEAT + c0 + ch * 8);
      *reinterpret_cast<uint4*>(in_s + px * LDS + ch * 8) = v;
    }
    for (int i = tid; i < TH * TW * (COUT / 8); i += NT) {
      const int p = i / (COUT / 8), ch = i % (COUT / 8);
      const int gy = t.y0 + p / TW, gx = t.x0 + p % TW;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy < H && gx < W)
        v = *reinterpret_cast<const uint4*>(
            dy + (img + (size_t)gy * W + gx) * COUT + ch * 8);
      *reinterpret_cast<uint4*>(dy_s + p * LDY + ch * 8) = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int kc = 0; kc < TH * TW / 16; ++kc) {
      const int ty = kc / (TW / 16), tx0 = (kc % (TW / 16)) * 16;
      // B = dy[pixel][co]: rows k = pixels, N tiles 2 ng, 2 ng + 1
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, dy_s + (ty * TW + tx0 + (lane % 8) + 8 * ((lane / 8) % 2)) *
                        LDY +
                 (2 * ng + lane / 16) * 8);
#pragma unroll
      for (int tt = 0; tt < TPW; ++tt) {
        const int tap = tap0 + tt;
        if (tap < 9) {
          const int ky = tap / 3, kx = tap % 3;
          // A = feat[pixel + tap offset][ci], transposed: M = ci, K = pixels
          uint32_t a[4];
          ldmatrix_x4_trans(
              a, in_s + ((ty + ky) * HALO_W + tx0 + kx + (lane % 8) +
                         8 * (lane / 16)) *
                            LDS +
                     mt * 16 + 8 * ((lane / 8) % 2));
          mma_bf16(acc[tt][0], a, b[0], b[1]);
          mma_bf16(acc[tt][1], a, b[2], b[3]);
        }
      }
    }
  }

  // C fragment: rows (ci) g and g + 8, columns (co) 2t and 2t + 1
  const int g = lane / 4, tq = lane % 4;
  float* out = part + (size_t)grp * 9 * CIN * COUT;
#pragma unroll
  for (int tt = 0; tt < TPW; ++tt) {
    const int tap = tap0 + tt;
    if (tap >= 9) continue;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int co = (2 * ng + n) * 8 + 2 * tq;
      const int ci = c0 + mt * 16 + g;
      float* o = out + ((size_t)tap * CIN + ci) * COUT + co;
      o[0] = acc[tt][n][0];
      o[1] = acc[tt][n][1];
      o[8 * COUT] = acc[tt][n][2];
      o[8 * COUT + 1] = acc[tt][n][3];
    }
  }
}

// --------------------------------------------------------- bf16 dgrad

constexpr int KC = 32;  // dy channels per stage

constexpr size_t dgrad_smem() {
  return (size_t)(HALO_PX + 9 * CCHUNK) * LDS * sizeof(__nv_bfloat16);
}

// The conv of dy (M, CIN) by wt, HWIO (3, 3, CIN, COUT_ALL), for dF
// channels [32 c, 32 c + 32), c = blockIdx.z % nchunks: the layout of
// rdb_fwd.cu's conv3x3_bf16 with 32 output channels.  ACCUM adds into
// dF (else stores); FINAL also writes dx = dF[:, :64] + g.
template <int CIN, int COUT_ALL, bool ACCUM, bool FINAL>
__global__ void __launch_bounds__(NT)
dgrad_bf16(const __nv_bfloat16* __restrict__ dy,
           const __nv_bfloat16* __restrict__ wt, float* __restrict__ dF,
           const __nv_bfloat16* __restrict__ g,
           __nv_bfloat16* __restrict__ dx, int H, int W) {
  static_assert(CIN % KC == 0 && COUT_ALL % CCHUNK == 0, "tiling");
  constexpr int NCHUNKS = COUT_ALL / CCHUNK;
  constexpr int NTILES = CCHUNK / 8;
  extern __shared__ __align__(16) __nv_bfloat16 smem_d[];
  __nv_bfloat16* in_s = smem_d;                  // [HALO_PX][LDS]
  __nv_bfloat16* w_s = smem_d + HALO_PX * LDS;   // [9][CCHUNK][LDS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int bimg = blockIdx.z / NCHUNKS;
  const int co0 = (blockIdx.z % NCHUNKS) * CCHUNK;
  const size_t img = (size_t)bimg * H * W;

  float acc[2][NTILES][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < NTILES; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;

  for (int c0 = 0; c0 < CIN; c0 += KC) {
    __syncthreads();
    for (int i = tid; i < HALO_PX * (KC / 8); i += NT) {
      const int px = i / (KC / 8), ch = i % (KC / 8);
      const int gy = y0 - 1 + px / HALO_W, gx = x0 - 1 + px % HALO_W;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = *reinterpret_cast<const uint4*>(
            dy + (img + (size_t)gy * W + gx) * CIN + c0 + ch * 8);
      *reinterpret_cast<uint4*>(in_s + px * LDS + ch * 8) = v;
    }
    // wt HWIO -> [tap][co][ci]
    for (int i = tid; i < 9 * (CCHUNK / 8) * KC; i += NT) {
      const int ci = i % KC, r = i / KC;
      const int tap = r / (CCHUNK / 8), co = (r % (CCHUNK / 8)) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(
          wt + ((size_t)tap * CIN + c0 + ci) * COUT_ALL + co0 + co);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w_s[(tap * CCHUNK + co + k) * LDS + ci] = e[k];
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
          ldmatrix_x4(b, w_s + (tap * CCHUNK + np * 16 + (lane % 8) +
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

  const int gy = y0 + warp;
  if (gy >= H) return;
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    const int co = co0 + n * 8 + 2 * tq;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gx = x0 + 16 * j + gq + 8 * h;
        if (gx >= W) continue;
        const size_t pix = img + (size_t)gy * W + gx;
        float* d = dF + pix * FEAT + co;
        float v0 = acc[j][n][2 * h], v1 = acc[j][n][2 * h + 1];
        if constexpr (ACCUM) {
          v0 += d[0];
          v1 += d[1];
        }
        d[0] = v0;
        d[1] = v1;
        if constexpr (FINAL) {
          const __nv_bfloat162 gg =
              *reinterpret_cast<const __nv_bfloat162*>(g + pix * CH + co);
          *reinterpret_cast<__nv_bfloat162*>(dx + pix * CH + co) =
              __floats2bfloat162_rn(v0 + __low2float(gg),
                                    v1 + __high2float(gg));
        }
      }
  }
}

}  // namespace tensor_core

// ------------------------------------------------------------- f32

namespace cuda_core {

constexpr int LDX = CCHUNK + 1;  // odd: conflict-free staging

template <int COUT>
constexpr size_t wgrad_smem() {
  return ((size_t)HALO_PX * LDX + (size_t)TH * TW * COUT) * sizeof(float);
}

// As wgrad_bf16 in f32 FFMA: thread t owns input channel t % 32 and the
// C_out / 8 output channels of group t / 32, for all nine taps.
template <int CIN, int COUT>
__global__ void __launch_bounds__(NT)
wgrad_f32(const float* __restrict__ feat, const float* __restrict__ dy,
          float* __restrict__ part, int B, int H, int W, int groups) {
  constexpr int CT = COUT / 8;
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
      if (gy < H && gx < W) v = dy[(img + (size_t)gy * W + gx) * COUT + c];
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

// As dgrad_bf16 in f32: the layout of rdb_fwd.cu's conv3x3_f32 with 32
// output channels.
template <int CIN, int COUT_ALL, bool ACCUM, bool FINAL>
__global__ void __launch_bounds__(DNT)
dgrad_f32(const float* __restrict__ dy, const float* __restrict__ wt,
          float* __restrict__ dF, const float* __restrict__ g,
          float* __restrict__ dx, int H, int W) {
  static_assert(CIN % KC == 0 && COUT_ALL % CCHUNK == 0, "tiling");
  constexpr int NCHUNKS = COUT_ALL / CCHUNK;
  constexpr int NCOG = CCHUNK / CO;
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
        v = dy[(img + (size_t)gy * W + gx) * CIN + c0 + ci];
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

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int STAGE>
cudaError_t launch_prep(bool bf16, const void* src, const void* feat,
                        void* dy, void* db_part, int M, int nblocks,
                        float scale, cudaStream_t s) {
  const int ppb = (M + nblocks - 1) / nblocks;
  if (bf16)
    prep<STAGE, __nv_bfloat16><<<nblocks, NT, 0, s>>>(
        src, static_cast<const __nv_bfloat16*>(feat),
        static_cast<__nv_bfloat16*>(dy), static_cast<float*>(db_part), M,
        ppb, scale);
  else
    prep<STAGE, float><<<nblocks, NT, 0, s>>>(
        src, static_cast<const float*>(feat), static_cast<float*>(dy),
        static_cast<float*>(db_part), M, ppb, scale);
  return cudaGetLastError();
}

template <int CIN, int COUT>
cudaError_t launch_wgrad(bool bf16, const void* feat, const void* dy,
                         void* part, int B, int H, int W, int groups,
                         cudaStream_t s) {
  const dim3 grid(groups, CIN / CCHUNK);
  if (bf16) {
    auto kernel = tensor_core::wgrad_bf16<CIN, COUT>;
    constexpr size_t smem = tensor_core::wgrad_smem<COUT>();
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, smem, s>>>(
        static_cast<const __nv_bfloat16*>(feat),
        static_cast<const __nv_bfloat16*>(dy), static_cast<float*>(part), B,
        H, W, groups);
  } else {
    auto kernel = cuda_core::wgrad_f32<CIN, COUT>;
    constexpr size_t smem = cuda_core::wgrad_smem<COUT>();
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, smem, s>>>(static_cast<const float*>(feat),
                                  static_cast<const float*>(dy),
                                  static_cast<float*>(part), B, H, W,
                                  groups);
  }
  return cudaGetLastError();
}

// dgrad of conv (CIN_I -> COUT_I): its input is dy (COUT_I channels),
// its output dF[:, :CIN_I].
template <int CIN_I, int COUT_I, bool ACCUM, bool FINAL>
cudaError_t launch_dgrad(bool bf16, const void* dy, const void* wt,
                         void* dF, const void* g, void* dx, int B, int H,
                         int W, cudaStream_t s) {
  constexpr int NCHUNKS = CIN_I / CCHUNK;
  if (bf16) {
    auto kernel = tensor_core::dgrad_bf16<COUT_I, CIN_I, ACCUM, FINAL>;
    constexpr size_t smem = tensor_core::dgrad_smem();
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * NCHUNKS);
    kernel<<<grid, NT, smem, s>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(wt), static_cast<float*>(dF),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), H, W);
  } else {
    auto kernel = cuda_core::dgrad_f32<COUT_I, CIN_I, ACCUM, FINAL>;
    constexpr size_t smem = cuda_core::dgrad_smem();
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((W + cuda_core::DTW - 1) / cuda_core::DTW,
                    (H + TH - 1) / TH, B * NCHUNKS);
    kernel<<<grid, cuda_core::DNT, smem, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(wt),
        static_cast<float*>(dF), static_cast<const float*>(g),
        static_cast<float*>(dx), H, W);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// prep of conv `stage`: src is g (M, 64) for stage 4, else the f32 dF
// buffer (M, 192); writes dy (M, C_out) in the working dtype and
// `nblocks` rows of partial db sums.  Returns the cudaError_t of the
// launch (0 on success), as every entry point below.
int rdb_bwd_prep_launch(int stage, int is_bf16, const void* src,
                        const void* feat, void* dy, void* db_part, int M,
                        int nblocks, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  switch (stage) {
    case 0: return (int)launch_prep<0>(bf16, src, feat, dy, db_part, M, nblocks, scale, s);
    case 1: return (int)launch_prep<1>(bf16, src, feat, dy, db_part, M, nblocks, scale, s);
    case 2: return (int)launch_prep<2>(bf16, src, feat, dy, db_part, M, nblocks, scale, s);
    case 3: return (int)launch_prep<3>(bf16, src, feat, dy, db_part, M, nblocks, scale, s);
    case 4: return (int)launch_prep<4>(bf16, src, feat, dy, db_part, M, nblocks, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// wgrad of conv `stage`: `groups` f32 partials of dW, (groups, 3, 3,
// C_in, C_out), into part.
int rdb_bwd_wgrad_launch(int stage, int is_bf16, const void* feat,
                         const void* dy, void* part, int B, int H, int W,
                         int groups, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  switch (stage) {
    case 0: return (int)launch_wgrad<64, 32>(bf16, feat, dy, part, B, H, W, groups, s);
    case 1: return (int)launch_wgrad<96, 32>(bf16, feat, dy, part, B, H, W, groups, s);
    case 2: return (int)launch_wgrad<128, 32>(bf16, feat, dy, part, B, H, W, groups, s);
    case 3: return (int)launch_wgrad<160, 32>(bf16, feat, dy, part, B, H, W, groups, s);
    case 4: return (int)launch_wgrad<192, 64>(bf16, feat, dy, part, B, H, W, groups, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dgrad of conv `stage`: wt is its flipped, transposed kernel, HWIO
// (3, 3, C_out, C_in); stage 4 stores dF, the others add into it, and
// stage 0 also writes dx (M, 64) = dF[:, :64] + g.
int rdb_bwd_dgrad_launch(int stage, int is_bf16, const void* dy,
                         const void* wt, void* dF, const void* g, void* dx,
                         int B, int H, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  switch (stage) {
    case 0: return (int)launch_dgrad<64, 32, true, true>(bf16, dy, wt, dF, g, dx, B, H, W, s);
    case 1: return (int)launch_dgrad<96, 32, true, false>(bf16, dy, wt, dF, g, dx, B, H, W, s);
    case 2: return (int)launch_dgrad<128, 32, true, false>(bf16, dy, wt, dF, g, dx, B, H, W, s);
    case 3: return (int)launch_dgrad<160, 32, true, false>(bf16, dy, wt, dF, g, dx, B, H, W, s);
    case 4: return (int)launch_dgrad<192, 64, false, false>(bf16, dy, wt, dF, g, dx, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dw (n,) = the sum of `groups` partials; db (cout,) = the sum of
// `nblocks` partial rows.
int rdb_bwd_reduce_launch(const void* dw_part, int groups, int n,
                          const void* db_part, int nblocks, int cout,
                          void* dw, void* db, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + cout + NT - 1) / NT;
  reduce_partials<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dw_part), groups, n,
      static_cast<const float*>(db_part), nblocks, cout,
      static_cast<float*>(dw), static_cast<float*>(db));
  return (int)cudaGetLastError();
}

const char* rdb_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
