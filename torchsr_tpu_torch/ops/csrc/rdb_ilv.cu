// Residual dense block (RDB) forward on a chunk-interleaved feature
// buffer, for Hopper (sm_90a).  Forward only.
//
// Replaces the TPU kernel torchsr_tpu/ops/pallas/rdb.py:223
// (_rdb_fwd_kernel_ilv, weights by _repack_ilv :291), selected there by
// TORCHSR_RDB_ILV=1 on forwards that no backward follows and where the
// row-extended kernel was not chosen (_rdb_fwd :445).  The math is that
// of csrc/rdb_fwd.cu: five dense 3x3 SAME convs (C_in = 64 + 32 i, C_out
// 32, 32, 32, 32, 64), bias, LeakyReLU(0.2) on convs 1-4, out = x +
// scale * conv5, f32 sums.
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
// Design.  One CTA (8 warps) computes 64 consecutive GEMM rows, pixels
// m0 - 1 .. m0 + 62, and writes the 62 outputs m0 .. m0 + 61: the rows
// of m0 - 1 and m0 + 62 are a one-pixel halo recomputed by the
// neighbouring CTAs (2 / 64 extra work), so the tap reduction needs no
// exchange between CTAs.  K is walked one 96-column chunk at a time
// (bf16; 32 columns in f32); the y tile goes through shared memory for
// the reduction.  Each new 32-channel slice is then stored three times:
// mid at row m, its up copy at row m + W and its dn copy at row m - W,
// with zeros in the up slot of an image's first row and the dn slot of
// its last.  Those stores cross CTAs, but every destination element has
// exactly one writer (the CTA of the pixel whose value it holds, or of
// the pixel itself for the zeros), and conv i never reads the chunk it
// writes (it reads chunks < C_in / 32), so no launch orders or
// synchronises with another CTA of itself.  The grow launch writes the
// three copies of x's two chunks the same way.
//
// bf16: mma.sync m16n8k16 bf16 -> f32; warps split 4 (16-row M tiles)
// x 2 (halves of N = 3 C_out); the A tile with ldmatrix, the weight tile
// (stored [k][n]) with ldmatrix.trans.  f32: FFMA on the CUDA cores, each
// thread 4 rows x N / 16 columns.
//
// Bound on this card (H100 SXM).  The function is B1's: at the serving
// shape (16, 64, 64, 64), 31.4 GFLOP, 0.0318 ms at 989 TFLOP/s bf16
// (0.469 ms f32), against 16.8 MB of unavoidable bytes (0.005 ms).  The
// interleaved buffer itself triples the stores: each conv rereads its
// 3 C_in prefix and writes 3 x 32 channels, ~0.33 GB per block in bf16
// if nothing stays in L2, ~0.10 ms at 3.35 TB/s.  This simple version
// stages synchronously on mma.sync; wgmma fed by TMA is later work.

#include "rdb_mma.cuh"

namespace {

using rdb::allow_smem;
using rdb::from_f;
using rdb::leaky;
using rdb::to_f;

constexpr int CH = 64;       // block input/output channels
constexpr int G = 32;        // growth: channels per chunk
constexpr int STRIDE = 3 * G;        // columns per chunk: [up | mid | dn]
constexpr int ILV = 6 * STRIDE;      // 576 buffer columns
constexpr int NT = 256;
constexpr int TM = 64;               // GEMM rows per CTA
constexpr int OUT_PER_CTA = TM - 2;  // outputs per CTA (one-pixel halo)

// Store v (the value of chunk column c at pixel m) as mid at m, up at
// m + W and dn at m - W; zero the up slot on an image's first row and
// the dn slot on its last.
template <typename T>
__device__ __forceinline__ void grow(T* buf, size_t m, int chunk, int c, T v,
                                     int H, int W) {
  const int y = (int)((m / W) % H);
  T* row = buf + m * ILV + chunk * STRIDE;
  row[G + c] = v;
  if (y + 1 < H) row[(size_t)W * ILV + c] = v;
  if (y == 0) row[c] = from_f<T>(0.f);
  if (y > 0) row[2 * G + c - (ptrdiff_t)W * ILV] = v;
  if (y == H - 1) row[2 * G + c] = from_f<T>(0.f);
}

// x (M, 64) -> chunks 0 and 1 of the buffer.
template <typename T>
__global__ void __launch_bounds__(NT)
grow_x(const T* __restrict__ x, T* __restrict__ buf, size_t M, int H, int W) {
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  if (e >= M * CH) return;
  const size_t m = e / CH;
  const int c = (int)(e % CH);
  grow(buf, m, c / G, c % G, x[e], H, W);
}

// The epilogue shared by both storage types: y_s holds y for the CTA's
// 64 GEMM rows (pixel m0 - 1 + i at row i), LDY floats apart.
template <typename T, int CIN, int COUT, bool LAST, int LDY>
__device__ __forceinline__ void reduce_taps(
    const float* y_s, size_t m0, size_t M, int H, int W,
    const float* __restrict__ bias, T* buf, const T* __restrict__ x,
    T* __restrict__ out, float scale) {
  for (int e = threadIdx.x; e < OUT_PER_CTA * COUT; e += NT) {
    const int i = 1 + e / COUT, co = e % COUT;
    const size_t m = m0 + (i - 1);
    if (m >= M) break;  // e grows with m: the rest are past the end too
    const int col = (int)(m % W);
    float v = y_s[i * LDY + COUT + co] + bias[co];
    if (col > 0) v += y_s[(i - 1) * LDY + co];
    if (col < W - 1) v += y_s[(i + 1) * LDY + 2 * COUT + co];
    if constexpr (LAST) {
      out[m * CH + co] = from_f<T>(v * scale + to_f(x[m * CH + co]));
    } else {
      grow(buf, m, CIN / G, co, from_f<T>(leaky(v)), H, W);
    }
  }
}

// ------------------------------------------------------------------ bf16

namespace tensor_core {

using rdb::ldmatrix_x4;
using rdb::ldmatrix_x4_trans;
using rdb::mma_bf16;

constexpr int KC = STRIDE;   // K columns per stage: one chunk
constexpr int LDA = KC + 8;  // 208-byte rows

template <int N>
__host__ __device__ constexpr int ldb() { return N + 8; }
template <int N>
__host__ __device__ constexpr int ldy() { return N + 4; }

template <int COUT>
constexpr size_t smem_bytes() {
  constexpr int N = 3 * COUT;
  return (size_t)(TM * LDA + KC * ldb<N>()) * sizeof(__nv_bfloat16) +
         (size_t)TM * ldy<N>() * sizeof(float);
}

// Conv (CIN -> COUT) on the interleaved buffer; w (3 CIN, 3 COUT) bf16
// in repack_ilv order; bias f32.
template <int CIN, int COUT, bool LAST>
__global__ void __launch_bounds__(NT)
ilv_conv_bf16(__nv_bfloat16* buf, const __nv_bfloat16* __restrict__ w,
              const float* __restrict__ bias,
              const __nv_bfloat16* __restrict__ x,
              __nv_bfloat16* __restrict__ out, size_t M, int H, int W,
              float scale) {
  constexpr int N = 3 * COUT;
  constexpr int LDB = ldb<N>(), LDY = ldy<N>();
  constexpr int NW = N / 2;        // columns per warp
  constexpr int NTILES = NW / 8;   // n8 tiles per warp (6 or 12)
  static_assert(NTILES % 2 == 0, "n-tile pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* b_s = a_s + TM * LDA;
  float* y_s = reinterpret_cast<float*>(b_s + KC * LDB);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mw = warp % 4, nw = warp / 4;
  const size_t m0 = (size_t)blockIdx.x * OUT_PER_CTA;  // first output
  const long long mb = (long long)m0 - 1;              // GEMM row 0

  float acc[NTILES][4];
#pragma unroll
  for (int n = 0; n < NTILES; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kc = 0; kc < CIN / G; ++kc) {  // one chunk of K per stage
    __syncthreads();
    for (int i = tid; i < TM * (KC / 8); i += NT) {
      const int row = i / (KC / 8), ch = i % (KC / 8);
      const long long m = mb + row;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m >= 0 && m < (long long)M)
        v = *reinterpret_cast<const uint4*>(buf + (size_t)m * ILV +
                                            kc * KC + ch * 8);
      *reinterpret_cast<uint4*>(a_s + row * LDA + ch * 8) = v;
    }
    for (int i = tid; i < KC * (N / 8); i += NT) {
      const int k = i / (N / 8), n8 = i % (N / 8);
      *reinterpret_cast<uint4*>(b_s + k * LDB + n8 * 8) =
          *reinterpret_cast<const uint4*>(w + (size_t)(kc * KC + k) * N +
                                          n8 * 8);
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, a_s + (mw * 16 + (lane % 16)) * LDA + ks * 16 +
                         (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NTILES / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, b_s + (ks * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LDB +
                   nw * NW + (2 * np + lane / 16) * 8);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  // C fragment: rows g, g + 8 of the warp's M tile, columns 2q, 2q + 1
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    const int col = nw * NW + n * 8 + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* y = y_s + (mw * 16 + g + 8 * h) * LDY + col;
      y[0] = acc[n][2 * h];
      y[1] = acc[n][2 * h + 1];
    }
  }
  __syncthreads();
  reduce_taps<__nv_bfloat16, CIN, COUT, LAST, LDY>(y_s, m0, M, H, W, bias,
                                                   buf, x, out, scale);
}

}  // namespace tensor_core

// ------------------------------------------------------------------- f32

namespace cuda_core {

constexpr int KC = 32;       // K columns per stage
constexpr int LDA = TM + 4;  // a_s is stored [k][row]

template <int N>
__host__ __device__ constexpr int ldy() { return N + 4; }

template <int COUT>
constexpr size_t smem_bytes() {
  constexpr int N = 3 * COUT;
  return (size_t)(KC * LDA + KC * N + TM * ldy<N>()) * sizeof(float);
}

// As tensor_core::ilv_conv_bf16 in f32 FFMA: thread t owns GEMM rows
// 4 (t % 16) .. + 3 and columns (t / 16) N / 16 .. + N / 16 - 1.
template <int CIN, int COUT, bool LAST>
__global__ void __launch_bounds__(NT)
ilv_conv_f32(float* buf, const float* __restrict__ w,
             const float* __restrict__ bias, const float* __restrict__ x,
             float* __restrict__ out, size_t M, int H, int W, float scale) {
  constexpr int N = 3 * COUT;
  constexpr int LDY = ldy<N>();
  constexpr int CPT = N / 16;  // columns per thread (6 or 12)
  extern __shared__ __align__(16) float smem_f[];
  float* a_s = smem_f;            // [KC][LDA]
  float* b_s = a_s + KC * LDA;    // [KC][N]
  float* y_s = b_s + KC * N;      // [TM][LDY]

  const int tid = threadIdx.x;
  const int rg = tid % 16, cg = tid / 16;
  const size_t m0 = (size_t)blockIdx.x * OUT_PER_CTA;
  const long long mb = (long long)m0 - 1;

  float acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < 3 * CIN; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < TM * KC; i += NT) {
      const int row = i / KC, k = i % KC;
      const long long m = mb + row;
      a_s[k * LDA + row] = (m >= 0 && m < (long long)M)
                               ? buf[(size_t)m * ILV + k0 + k]
                               : 0.f;
    }
    for (int i = tid; i < KC * N; i += NT)
      b_s[i] = w[(size_t)k0 * N + i];
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(a_s + k * LDA +
                                                        4 * rg);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) bv[c] = b_s[k * N + cg * CPT + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      y_s[(4 * rg + r) * LDY + cg * CPT + c] = acc[r][c];
  __syncthreads();
  reduce_taps<float, CIN, COUT, LAST, LDY>(y_s, m0, M, H, W, bias, buf, x,
                                           out, scale);
}

}  // namespace cuda_core

template <int CIN, int COUT, bool LAST>
cudaError_t launch_conv(bool bf16, void* buf, const void* w,
                        const void* bias, const void* x, void* out, size_t M,
                        int H, int W, float scale, cudaStream_t s) {
  const unsigned grid = (unsigned)((M + OUT_PER_CTA - 1) / OUT_PER_CTA);
  if (bf16) {
    auto kernel = tensor_core::ilv_conv_bf16<CIN, COUT, LAST>;
    constexpr size_t smem = tensor_core::smem_bytes<COUT>();
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, smem, s>>>(
        static_cast<__nv_bfloat16*>(buf),
        static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), M, H, W, scale);
  } else {
    auto kernel = cuda_core::ilv_conv_f32<CIN, COUT, LAST>;
    constexpr size_t smem = cuda_core::smem_bytes<COUT>();
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, smem, s>>>(
        static_cast<float*>(buf), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<const float*>(x),
        static_cast<float*>(out), M, H, W, scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W, 64) -> chunks 0 and 1 ([up | mid | dn] each) of the
// (B*H*W, 576) buffer.  Returns the cudaError_t of the launch (0 on
// success), as the entry point below.
int rdb_ilv_grow_launch(int is_bf16, const void* x, void* buf, int B, int H,
                        int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t M = (size_t)B * H * W;
  const unsigned blocks = (unsigned)((M * CH + NT - 1) / NT);
  if (is_bf16)
    grow_x<__nv_bfloat16><<<blocks, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(buf), M, H, W);
  else
    grow_x<float><<<blocks, NT, 0, s>>>(static_cast<const float*>(x),
                                        static_cast<float*>(buf), M, H, W);
  return (int)cudaGetLastError();
}

// Conv `stage` of a block on the interleaved buffer: stages 0..3 write
// chunk 2 + stage, stage 4 writes out (B, H, W, 64) = x + scale * conv5.
int rdb_ilv_conv_launch(int stage, int is_bf16, void* buf, const void* w,
                        const void* bias, const void* x, void* out, int B,
                        int H, int W, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  const size_t M = (size_t)B * H * W;
  switch (stage) {
    case 0: return (int)launch_conv<64, 32, false>(bf16, buf, w, bias, x, out, M, H, W, scale, s);
    case 1: return (int)launch_conv<96, 32, false>(bf16, buf, w, bias, x, out, M, H, W, scale, s);
    case 2: return (int)launch_conv<128, 32, false>(bf16, buf, w, bias, x, out, M, H, W, scale, s);
    case 3: return (int)launch_conv<160, 32, false>(bf16, buf, w, bias, x, out, M, H, W, scale, s);
    case 4: return (int)launch_conv<192, 64, true>(bf16, buf, w, bias, x, out, M, H, W, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* rdb_ilv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
