// HAT's window self-attention (HAB) and overlapping cross-attention (OCAB)
// on NHWC token maps, bf16 in and out, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no HAT.  It was added because
// the plain composition (ops/window_attn.py window_attn_reference,
// overlap_attn_reference) writes and reads every score: at HAT's serving
// tile batch (8, 256, 256, 180) a HAB call holds 0.8 G f32 scores, an OCAB
// call 1.8 G.
//
// What it computes, for each image b, window (wy, wx) of 16 x 16 tokens and
// head h (head dim d <= 32, even; C = heads * d):
//
//   q_i = qkv[b, pos(i), 0 * C + h * d + 0..d)     i < 256, the window's
//   k_j = qkv[b, key(j), 1 * C + h * d + 0..d)     j < NK
//   v_j = qkv[b, key(j), 2 * C + h * d + 0..d)
//   s_ij = scale * q_i . k_j + table[rel(i, j), h] (+ mask_ij)
//   out[b, pos(i), h * d + 0..d) = sum_j softmax_j(s_ij) v_j
//
//   HAB:  pos(i) = ((wy * 16 + i / 16 + shift) mod H, (wx * 16 + i % 16 +
//         shift) mod W): the roll by -shift, the window partition, and for
//         the output the window reverse and the roll by +shift; key(j) =
//         pos(j), NK = 256; rel(i, j) = HAT's calculate_rpi_sa; mask_ij =
//         -100 where i and j lie in two regions of the rolled map (HAT's
//         calculate_mask: rows and columns split at H - 16 and H - shift),
//         on shifted blocks only.
//   OCAB: pos(i) as HAB's with shift 0; key(j) = (wy * 16 - 4 + j / 24,
//         wx * 16 - 4 + j % 24), NK = 576: nn.Unfold(24, stride 16,
//         padding 4) of the projected keys and values, a key outside the
//         map a zero vector that still takes part in the softmax with its
//         bias; rel(i, j) = HAT's calculate_rpi_oca, whose negative rows
//         index the table from its end as PyTorch's indexing does.
//
// Bound on this card (H100 SXM): bytes.  q, k and v are read once (1080
// bytes a token at C = 180) and the output written once (360 bytes): 755 MB
// at (8, 256, 256, 180), 0.225 ms at 3.35 TB/s, against 96.6 GFLOP for a
// HAB call (0.098 ms at 989 TFLOP/s) and 217 GFLOP for an OCAB call
// (0.22 ms).  The OCAB's key windows overlap, so its k and v are read
// 2.25 times from the L2 but once from memory.
//
// Design.  One CTA of 8 warps a (window, head, image).  It copies the
// window's queries and keys (and values) into shared memory once, 4 bytes
// a thread, the roll, the partition and the unfold in the addresses and
// the head dim padded to 32 with zeros, in rows of 64 bytes whose 16-byte
// chunks are swizzled (chunk ^ (row / 2) % 4) so that ldmatrix reads them
// without bank conflicts; and the head's column of the bias table (961 or
// 1521 f32).  Each warp owns 32 queries, taken as two m16 tiles in turn:
// the scores of 64 keys at a time in registers (mma.sync m16n8k16 bf16,
// f32 sums), the bias gathered from shared memory by the two tokens'
// relative offset, the mask from their regions, an online softmax in f32
// (exp2, the running max and sum per row shared by the row's four
// threads), the probabilities rounded to bf16 as the A operand of P.V
// (values through ldmatrix.trans).  The output goes to the query's own
// position in bf16, 4 bytes a store.  No atomics, no host read, nothing
// allocated: the launches can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WS = 16;           // window side
constexpr int NQ = WS * WS;      // queries a window
constexpr int OW = 24;           // OCAB key window side
constexpr int PAD = (OW - WS) / 2;
constexpr int ROW = 64;          // bytes of a token row in shared memory
constexpr int THREADS = 256;     // 8 warps of 32 queries
constexpr int KB = 64;           // keys a block of the online softmax
constexpr float LOG2E = 1.4426950408889634f;

template <bool OCAB>
struct Shape {
  static constexpr int NK = OCAB ? OW * OW : NQ;
  static constexpr int T = OCAB ? WS + OW - 1 : 2 * WS - 1;  // table side
  static constexpr int L = T * T;                            // table rows
  // HAB:  rel = (qy - ky + 15) * 31 + (qx - kx + 15), in [0, L)
  // OCAB: rel = (ky - qy - 7) * 39 + (kx - qx - 7) in [-880, 640], read at
  //       rel + 880 from a copy of the table rotated by 880 rows
  static constexpr int ROT = OCAB ? (OW - 2) * (T + 1) : 0;
  static constexpr size_t SMEM = (size_t)(NQ + 2 * NK) * ROW + L * 4;
};

struct Params {
  const __nv_bfloat16* qkv;
  const float* table;
  __nv_bfloat16* out;
  int H, W, C, heads, d, shift;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` (0..3) of token row `row`
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * ROW + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c += a . b, m16n8k16, bf16 operands, f32 sums
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the map position (row, column) of the window's token i, rolled by -shift
__device__ __forceinline__ void query_pos(int wy, int wx, int i, int shift,
                                          int H, int W, int& y, int& x) {
  y = wy * WS + (i >> 4) + shift;
  x = wx * WS + (i & 15) + shift;
  if (y >= H) y -= H;
  if (x >= W) x -= W;
}

// HAT's shift-mask region of token i of a window on the last window row
// and/or column (0 elsewhere): rows and columns split at 16 - shift
__device__ __forceinline__ int region(int i, bool last_row, bool last_col,
                                      int shift) {
  const int rh = last_row ? ((i >> 4) < WS - shift ? 1 : 2) : 0;
  const int rw = last_col ? ((i & 15) < WS - shift ? 1 : 2) : 0;
  return rh * 3 + rw;
}

template <bool OCAB>
__device__ __forceinline__ int key_off(int j) {
  using S = Shape<OCAB>;
  return OCAB ? (j / OW) * S::T + (j % OW) : -((j >> 4) * S::T + (j & 15));
}

template <bool OCAB>
__device__ __forceinline__ int query_off(int i) {
  using S = Shape<OCAB>;
  const int qy = i >> 4, qx = i & 15;
  return OCAB ? (WS - 1) * (S::T + 1) - (qy * S::T + qx)
              : (qy + WS - 1) * S::T + qx + WS - 1;
}

template <bool OCAB>
__device__ __forceinline__ void attn_body(const Params& p) {
  using S = Shape<OCAB>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sq = smem;
  unsigned char* sk = sq + NQ * ROW;
  unsigned char* sv = sk + S::NK * ROW;
  float* sb = reinterpret_cast<float*>(sv + S::NK * ROW);

  const int nwx = p.W / WS, nwy = p.H / WS;
  const int wy = blockIdx.x / nwx, wx = blockIdx.x % nwx;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t c3 = 3 * static_cast<size_t>(p.C);
  const __nv_bfloat16* img = p.qkv
      + static_cast<size_t>(blockIdx.z) * p.H * p.W * c3
      + static_cast<size_t>(h) * p.d;

  // ---- q, k, v and the head's bias into shared memory
  for (int n = tid; n < NQ * 16; n += THREADS) {
    const int i = n >> 4, w = n & 15;
    int y, x;
    query_pos(wy, wx, i, p.shift, p.H, p.W, y, x);
    uint32_t v = 0;
    if (2 * w < p.d)
      v = *reinterpret_cast<const uint32_t*>(
          img + (static_cast<size_t>(y) * p.W + x) * c3 + 2 * w);
    *reinterpret_cast<uint32_t*>(sq + swz(i, w >> 2) + (w & 3) * 4) = v;
  }
  for (int n = tid; n < S::NK * 16; n += THREADS) {
    const int j = n >> 4, w = n & 15;
    int y, x;
    bool inside = true;
    if (OCAB) {
      y = wy * WS - PAD + j / OW;
      x = wx * WS - PAD + j % OW;
      inside = y >= 0 && y < p.H && x >= 0 && x < p.W;
    } else {
      query_pos(wy, wx, j, p.shift, p.H, p.W, y, x);
    }
    uint32_t kw = 0, vw = 0;
    if (inside && 2 * w < p.d) {
      const __nv_bfloat16* src =
          img + (static_cast<size_t>(y) * p.W + x) * c3 + 2 * w;
      kw = *reinterpret_cast<const uint32_t*>(src + p.C);
      vw = *reinterpret_cast<const uint32_t*>(src + 2 * p.C);
    }
    const int at = swz(j, w >> 2) + (w & 3) * 4;
    *reinterpret_cast<uint32_t*>(sk + at) = kw;
    *reinterpret_cast<uint32_t*>(sv + at) = vw;
  }
  for (int n = tid; n < S::L; n += THREADS) {
    const int row = OCAB ? (n + S::L - S::ROT) % S::L : n;
    sb[n] = p.table[static_cast<size_t>(row) * p.heads + h];
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool last_row = wy == nwy - 1, last_col = wx == nwx - 1;
  const bool masked = !OCAB && p.shift > 0 && (last_row || last_col);
  const float qk_scale = p.scale * LOG2E;

  for (int mt = 0; mt < 2; ++mt) {
    const int m0 = warp * 32 + mt * 16;
    uint32_t qa[2][4];
    for (int ks = 0; ks < 2; ++ks)
      ldsm_x4(smem_u32(sq + swz(m0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                ks * 2 + (lane >> 4))),
              qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3]);
    // this thread's two rows: the tile's g and g + 8
    int qoff[2], qreg[2];
    for (int r = 0; r < 2; ++r) {
      const int i = m0 + g + 8 * r;
      qoff[r] = query_off<OCAB>(i);
      qreg[r] = masked ? region(i, last_row, last_col, p.shift) : 0;
    }
    float o[4][4];
    for (int a = 0; a < 4; ++a)
      for (int e = 0; e < 4; ++e) o[a][e] = 0.f;
    float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

    for (int kb = 0; kb < S::NK; kb += KB) {
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(sk + swz(kb + nt * 8 + (lane & 7), lane >> 3)), b0,
                b1, b2, b3);
        mma(s[nt], qa[0], b0, b1);
        mma(s[nt], qa[1], b2, b3);
      }
      float bmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        for (int c = 0; c < 2; ++c) {
          const int j = kb + nt * 8 + 2 * t + c;
          const int koff = key_off<OCAB>(j);
          const int kreg =
              masked ? region(j, last_row, last_col, p.shift) : 0;
          for (int r = 0; r < 2; ++r) {
            float v = s[nt][2 * r + c] * qk_scale + sb[qoff[r] + koff] * LOG2E;
            if (masked && kreg != qreg[r]) v += -100.f * LOG2E;
            s[nt][2 * r + c] = v;
            bmax[r] = fmaxf(bmax[r], v);
          }
        }
      }
      float alpha[2];
      for (int r = 0; r < 2; ++r) {
        bmax[r] = fmaxf(bmax[r], __shfl_xor_sync(0xffffffffu, bmax[r], 1));
        bmax[r] = fmaxf(bmax[r], __shfl_xor_sync(0xffffffffu, bmax[r], 2));
        const float m = fmaxf(mrow[r], bmax[r]);
        alpha[r] = exp2f(mrow[r] - m);
        mrow[r] = m;
        lrow[r] *= alpha[r];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[nt][e] - mrow[e >> 1]);
          s[nt][e] = pe;
          lrow[e >> 1] += pe;
        }
      for (int a = 0; a < 4; ++a)
        for (int e = 0; e < 4; ++e) o[a][e] *= alpha[e >> 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        for (int dp = 0; dp < 2; ++dp) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(smem_u32(sv + swz(kb + kk * 16 + (lane & 7)
                                          + ((lane >> 3) & 1) * 8,
                                      dp * 2 + (lane >> 4))),
                    b0, b1, b2, b3);
          mma(o[2 * dp], pa, b0, b1);
          mma(o[2 * dp + 1], pa, b2, b3);
        }
      }
    }
    // each row's sum over its four threads, then the output in bf16
    for (int r = 0; r < 2; ++r) {
      lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
      lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
    }
    for (int r = 0; r < 2; ++r) {
      int y, x;
      query_pos(wy, wx, m0 + g + 8 * r, p.shift, p.H, p.W, y, x);
      __nv_bfloat16* dst = p.out
          + ((static_cast<size_t>(blockIdx.z) * p.H + y) * p.W + x) * p.C
          + static_cast<size_t>(h) * p.d;
      const float inv = 1.f / lrow[r];
      for (int a = 0; a < 4; ++a) {
        const int dim = a * 8 + 2 * t;
        if (dim < p.d)
          *reinterpret_cast<uint32_t*>(dst + dim) = pack_bf16(
              o[a][2 * r] * inv, o[a][2 * r + 1] * inv);
      }
    }
  }
}

// the two kernels, named apart for a profile: the HAB's and the OCAB's
__global__ void __launch_bounds__(THREADS, 2) hab_window_attn(Params p) {
  attn_body<false>(p);
}

__global__ void __launch_bounds__(THREADS, 2) ocab_overlap_attn(Params p) {
  attn_body<true>(p);
}

cudaError_t on_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

template <bool OCAB>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using S = Shape<OCAB>;
  void (*kernel)(Params) = OCAB ? ocab_overlap_attn : hab_window_attn;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.H / WS) * (p.W / WS), p.heads, B);
  kernel<<<grid, THREADS, S::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One attention call on `stream` of `device`: qkv (B, H, W, 3C) bf16,
// table (rows, heads) f32, out (B, H, W, C) bf16.  `overlap` 0 for the
// HAB's window attention (rolled by `shift`), 24 for the OCAB's
// overlapping cross-attention (shift 0).  H and W multiples of 16, C =
// heads * d with d even and at most 32.  Returns the cudaError_t of the
// launch (0 on success).
int window_attn_launch(const void* qkv, const void* table, void* out, int B,
                       int H, int W, int C, int heads, int shift, int overlap,
                       float scale, int device, void* stream) {
  cudaError_t err = on_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || H < WS || W < WS || H % WS || W % WS || heads < 1 ||
      C % heads || (C / heads) % 2 || C / heads > 32 || B > 65535 ||
      heads > 65535 || (overlap != 0 && overlap != OW) ||
      (overlap && shift) || shift < 0 || shift >= WS)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const __nv_bfloat16*>(qkv),
           static_cast<const float*>(table),
           static_cast<__nv_bfloat16*>(out), H, W, C, heads, C / heads,
           shift, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(overlap ? launch<true>(p, B, st) : launch<false>(p, B, st));
}

const char* window_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
