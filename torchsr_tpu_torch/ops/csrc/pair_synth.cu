// Fused LR/HR training-pair synthesis for Hopper (sm_90a).
//
// Replaces the TPU kernel torchsr_tpu/ops/pallas/preprocess.py:45
// (_pair_kernel, launched by synthesize_pair_pallas :93).  Per image, a
// uint8 crop (S, S, 3) NHWC and two flip bits (horizontal: reverse W,
// vertical: reverse H) become
//
//   hr = flip(crop) * f32(1/255)                       (S, S, 3) f32
//   lr = quant(M . quant(hr . M^T))                    (s, s, 3) f32
//
// with M the (s, S) PIL bicubic matrix (ops/resize.py resample_matrix),
// the W pass first, and quant(v) = rint(clamp(v, 0, 1) * 255) * f32(1/255)
// (rint: half to even, as torch.round).  The wrapper passes f32(1/255)
// itself, the constant the plain version multiplies by.
//
// Design.  Each image is cut into `nb` bands of LR rows (ops/
// preprocess.py pair_bands and pair_plan: about 128 CTAs a call, at most
// one a row, uneven where the bands do not divide s), one CTA a band:
// two bands an image at (64, 96, 96, 3), whose 128 CTAs measured faster
// than four's 256 (the windows overlap less), and one an LR row for a
// few crops, where the call is short and latency bound.  A band's CTA
// stages only the HR rows its taps reach (its window, 54 of 96 rows at
// two bands), as 16-byte loads of the crop's contiguous bytes, folding
// the vertical flip into the row index and the horizontal flip into the
// column, and de-interleaves the channels into three uint8 planes, so
// that the W pass's threads (consecutive LR columns) read consecutive
// words.  It writes its share of hr (the image's HR rows are
// cut among its CTAs, each row written once) as float4 stores, runs the
// W pass over the window's tap rows (the overlap with the neighbour
// bands is recomputed: the band is short) and the H pass over its LR
// rows.  The taps of M come banded and transposed, (taps, s): column o
// holds row o's nonzero taps from lo(o), so that neighbouring threads
// read neighbouring words.  Every output sums its taps in increasing
// order with f32 FMAs (fmaf), every product with the pixel is an explicit
// __fmul_rn: the arithmetic of the one-CTA-an-image kernel it replaces,
// value for value.  512 threads a CTA: with about one CTA an SM, the
// passes' load and FMA latencies need the warps.
//
// Bound on this card (H100 SXM).  Memory: the crop in (1 byte a value)
// and hr out (4 bytes) dominate; lr is 1/16 of hr.  At (64, 96, 96, 3)
// that is 9.29 MB, 2.8 us at 3.35 TB/s, against 1.6 us for the dense
// matmul FLOP at 67 TFLOP/s (the band needs a quarter of that).

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;
constexpr int TAB = 8;  // ints of a band's row in the plan
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float quant(float v, float inv255) {
  return __fmul_rn(rintf(__fmul_rn(fminf(fmaxf(v, 0.f), 1.f), 255.f)),
                   inv255);
}

// crops (B, S, S, 3) u8; flips (B, 2) u8; taps (T, s) f32: taps[t][o] =
// M[o][lo(o) + t]; plan int32: lo, hi of each LR row's nonzero taps (2 s),
// then per band (TAB each) its LR rows [o0, o1), its window of HR rows
// [w0, w1) (flipped coordinates), its share of hr's rows [h0, h1) and the
// rows its H pass reads [t0, t1); hr (B, S, S, 3) f32; lr (B, s, s, 3)
// f32 (hr 16-byte aligned).  Grid (nb, B); R: the rows of the largest
// window.  Loops step their indices on rather than divide: the kernel is
// short, and a division per value would cost more than its loads.
__global__ void __launch_bounds__(NT)
pair_synth(const uint8_t* __restrict__ crops,
           const uint8_t* __restrict__ flips, const float* __restrict__ taps,
           const int* __restrict__ plan, float* __restrict__ hr,
           float* __restrict__ lr, int S, int s, int T, int R,
           float inv255) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* taps_s = reinterpret_cast<float*>(smem);  // [T][s]
  float* mid = taps_s + T * s;                      // [3][R][s] quantized
  int* band = reinterpret_cast<int*>(mid + 3 * R * s);  // [s][2]
  uint8_t* planes = reinterpret_cast<uint8_t*>(band + 2 * s);  // [3][R][S]

  const int b = blockIdx.y, tid = threadIdx.x;
  const int* tab = plan + 2 * s + TAB * blockIdx.x;
  const int o0 = tab[0], o1 = tab[1], w0 = tab[2], w1 = tab[3];
  const int h0 = tab[4], h1 = tab[5], t0 = tab[6], t1 = tab[7];
  const bool hflip = flips[2 * b] != 0, vflip = flips[2 * b + 1] != 0;
  const int row_bytes = 3 * S;

  // The taps and bands are read before the crop and stored after it, so
  // that the global loads' latencies overlap.
  const float tap0 = tid < T * s ? taps[tid] : 0.f;
  const int band0 = tid < 2 * s ? plan[tid] : 0;

  // The window's crop rows [r0, r1) (the vertical flip reverses them), in
  // 16-byte words of the whole crops tensor (aligned as it is), two a
  // thread in flight; the bytes of the crops' last partial word, if any,
  // one at a time.  Each byte to its plane, row and (flipped) column.
  {
    const int r0 = vflip ? S - w1 : w0, r1 = vflip ? S - w0 : w1;
    const size_t img = (size_t)b * S * row_bytes;
    const size_t start = img + (size_t)r0 * row_bytes;
    const size_t end = img + (size_t)r1 * row_bytes;
    const size_t total = (size_t)gridDim.y * S * row_bytes;
    auto load = [&](size_t w) {
      if (16 * w + 16 <= total)
        return *reinterpret_cast<const uint4*>(crops + 16 * w);
      uint32_t u[4] = {0, 0, 0, 0};
      for (int e = 0; 16 * w + e < total; ++e)
        u[e >> 2] |= (uint32_t)crops[16 * w + e] << (8 * (e & 3));
      return make_uint4(u[0], u[1], u[2], u[3]);
    };
    auto scatter = [&](size_t w, uint4 v) {
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
      const size_t g0 = 16 * w > start ? 16 * w : start;
      // the first byte's crop row, column and channel; then step
      const int local = (int)(g0 - img), e0 = (int)(g0 - 16 * w);
      int sy = local / row_bytes, xx = local % row_bytes / 3, c = local % 3;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if (e < e0 || 16 * w + e >= end) continue;
        const int yy = (vflip ? S - 1 - sy : sy) - w0;
        const int x = hflip ? S - 1 - xx : xx;
        planes[(c * R + yy) * S + x] = (uint8_t)(u[e >> 2] >> (8 * (e & 3)));
        if (++c == 3) {
          c = 0;
          if (++xx == S) xx = 0, ++sy;
        }
      }
    };
    const size_t w_end = (end + 15) / 16;
    for (size_t w = start / 16 + tid; w < w_end; w += 2 * NT) {
      const uint4 v0 = load(w);
      const bool two = w + NT < w_end;
      const uint4 v1 = two ? load(w + NT) : v0;
      scatter(w, v0);
      if (two) scatter(w + NT, v1);
    }
  }
  if (tid < T * s) taps_s[tid] = tap0;
  for (int i = tid + NT; i < T * s; i += NT) taps_s[i] = taps[i];
  if (tid < 2 * s) band[tid] = band0;
  for (int i = tid + NT; i < 2 * s; i += NT) band[i] = plan[i];
  __syncthreads();

  // hr rows [h0, h1): hr[y][x][c] = plane c at (y, x) * 1/255.  Where a
  // row is whole float4s (S % 4 == 0), a thread writes float4 j of row y,
  // stepping (j, y) on without dividing; else one value at a time.
  {
    const int row_f = 3 * S;
    float* out = hr + (size_t)b * S * row_f;
    auto value = [&](int y, int e) {  // value e of row y
      const int x = e / 3, c = e - 3 * x;
      return __fmul_rn((float)planes[(c * R + y - w0) * S + x], inv255);
    };
    if (row_f % 4 == 0) {
      const int q4 = row_f / 4, dj = NT % q4, dy = NT / q4;
      for (int j = tid % q4, y = h0 + tid / q4; y < h1;) {
        const int e = 4 * j;
        *reinterpret_cast<float4*>(out + (size_t)y * row_f + e) =
            make_float4(value(y, e), value(y, e + 1), value(y, e + 2),
                        value(y, e + 3));
        j += dj;
        y += dy;
        if (j >= q4) j -= q4, ++y;
      }
    } else {
      for (int f = h0 * row_f + tid; f < h1 * row_f; f += NT) {
        const int y = f / row_f;
        out[f] = value(y, f - y * row_f);
      }
    }
  }

  // W pass over the rows the H pass reads: mid[c][y - w0][o] =
  // quant(sum_j M[o][j] hr[y][j][c]).  Thread i takes (row r, column o)
  // of the 3 (t1 - t0) rows (plane c's rows t0 .. t1 - 1, c = 0, 1, 2),
  // o fastest, stepping on without dividing.
  {
    const int nrw = t1 - t0, d_o = NT % s, d_r = NT / s;
    for (int o = tid % s, r = tid / s; r < 3 * nrw;) {
      const int c = r >= 2 * nrw ? 2 : r >= nrw ? 1 : 0;
      const int yy = c * R + t0 - w0 + r - c * nrw;  // plane row
      const uint8_t* row = planes + yy * S;
      const int lo = band[2 * o], n = band[2 * o + 1] - lo;
      float acc = 0.f;
#pragma unroll 4
      for (int t = 0; t < n; ++t)
        acc = fmaf(taps_s[t * s + o], __fmul_rn((float)row[lo + t], inv255),
                   acc);
      mid[yy * s + o] = quant(acc, inv255);
      o += d_o;
      r += d_r;
      if (o >= s) o -= s, ++r;
    }
  }
  __syncthreads();

  // H pass over the band's LR rows: lr[oy][ox][c] = quant(sum_y M[oy][y]
  // mid[y][ox][c]).  Thread i takes (row r, column ox) of the 3 (o1 - o0)
  // rows (c's LR rows o0 .. o1 - 1), ox fastest.
  {
    float* lr_out = lr + (size_t)b * s * s * 3;
    const int nbo = o1 - o0, d_o = NT % s, d_r = NT / s;
    for (int ox = tid % s, r = tid / s; r < 3 * nbo;) {
      const int c = r >= 2 * nbo ? 2 : r >= nbo ? 1 : 0;
      const int oy = o0 + r - c * nbo;
      const int lo = band[2 * oy], n = band[2 * oy + 1] - lo;
      const float* col = mid + (c * R + lo - w0) * s + ox;
      float acc = 0.f;
#pragma unroll 4
      for (int t = 0; t < n; ++t)
        acc = fmaf(taps_s[t * s + oy], col[t * s], acc);
      lr_out[(oy * s + ox) * 3 + c] = quant(acc, inv255);
      ox += d_o;
      r += d_r;
      if (ox >= s) ox -= s, ++r;
    }
  }
}

// Shared memory of a CTA: the taps, the W pass's R rows, the bands of
// the taps, the planes.
int smem_bytes(int S, int s, int T, int R) {
  return (T * s + 3 * R * s + 2 * s) * 4 + 3 * R * S;
}

// The largest shared memory the kernel has been allowed on each device.
int allowed[MAX_DEVICES];

}  // namespace

extern "C" {

// The synthesis of B images of S px on `stream` of `device`, nb bands of
// an image (the plan's), T taps a row, windows of at most R rows.
// Returns the cudaError_t of the launch (0 on success).
int pair_synth_launch(const void* crops, const void* flips, const void* taps,
                      const void* plan, void* hr, void* lr, int B, int S,
                      int s, int nb, int T, int R, float inv255, int device,
                      void* stream) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const int smem = smem_bytes(S, s, T, R);
  if (smem > allowed[device]) {
    err = cudaFuncSetAttribute(
        pair_synth, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed[device] = smem;
  }
  pair_synth<<<dim3(nb, B), NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(crops), static_cast<const uint8_t*>(flips),
      static_cast<const float*>(taps), static_cast<const int*>(plan),
      static_cast<float*>(hr), static_cast<float*>(lr), S, s, T, R, inv255);
  return (int)cudaGetLastError();
}

const char* pair_synth_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
