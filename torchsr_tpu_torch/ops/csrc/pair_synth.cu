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
// Design.  One CTA per image.  The crop is staged in shared memory once
// (S*S*3 bytes: 27 KB at S = 96, 48 KB at 128) and the flips are index
// maps on it; hr is written from there with consecutive threads on
// consecutive floats.  The TPU kernel runs both passes as dense (s x S)
// matmuls because the MXU wants them; here each output reads only its
// row's band of M (the nonzero window [lo, hi) the wrapper passes: 16
// taps at 4x), summed in increasing tap order with f32 FMAs.  The
// quantized W pass lives in shared memory (S*s*3 floats: 12 KB at 128)
// until the H pass reads it.  Every product is an explicit __fmul_rn or
// fmaf, so the compiler contracts nothing that the plain version rounds.
//
// Bound on this card (H100 SXM).  Memory: the crop in (1 byte a value)
// and hr out (4 bytes) dominate; lr is 1/16 of hr.  At (64, 96, 96, 3)
// that is 9.29 MB, 2.8 us at 3.35 TB/s, against 1.6 us for the dense
// matmul FLOP at 67 TFLOP/s (the band needs a quarter of that).  This
// simple version runs one CTA per image (64 CTAs for 132 SMs at the
// tool's shape) with synchronous staging; spreading an image over
// several CTAs is later work.

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;

__device__ __forceinline__ float quant(float v, float inv255) {
  return __fmul_rn(rintf(__fmul_rn(fminf(fmaxf(v, 0.f), 1.f), 255.f)),
                   inv255);
}

// crops (B, S, S, 3) u8; flips (B, 2) u8; mat (s, S) f32; band (s, 2)
// int32 [lo, hi) of each row's nonzero taps; hr (B, S, S, 3) f32; lr
// (B, s, s, 3) f32.
__global__ void __launch_bounds__(NT)
pair_synth(const uint8_t* __restrict__ crops,
           const uint8_t* __restrict__ flips, const float* __restrict__ mat,
           const int* __restrict__ band, float* __restrict__ hr,
           float* __restrict__ lr, int S, int s, float inv255) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* mid = reinterpret_cast<float*>(smem);  // [S][s][3], quantized W pass
  uint8_t* crop = smem + (size_t)S * s * 3 * sizeof(float);  // [S][S][3]

  const int b = blockIdx.x;
  const int n_hr = S * S * 3;
  const bool hflip = flips[2 * b] != 0, vflip = flips[2 * b + 1] != 0;
  const uint8_t* src = crops + (size_t)b * n_hr;
  for (int i = threadIdx.x; i < n_hr; i += NT) crop[i] = src[i];
  __syncthreads();

  float* hr_out = hr + (size_t)b * n_hr;
  for (int i = threadIdx.x; i < n_hr; i += NT) {
    const int c = i % 3, px = i / 3;
    const int x = px % S, y = px / S;
    const int sy = vflip ? S - 1 - y : y, sx = hflip ? S - 1 - x : x;
    hr_out[i] = __fmul_rn((float)crop[(sy * S + sx) * 3 + c], inv255);
  }

  // W pass: mid[y][o][c] = quant(sum_j M[o][j] hr[y][j][c])
  for (int i = threadIdx.x; i < S * s * 3; i += NT) {
    const int c = i % 3, r = i / 3;
    const int o = r % s, y = r / s;
    const uint8_t* row = crop + (vflip ? S - 1 - y : y) * S * 3 + c;
    const float* m = mat + (size_t)o * S;
    float acc = 0.f;
    for (int j = band[2 * o]; j < band[2 * o + 1]; ++j) {
      const int sx = hflip ? S - 1 - j : j;
      acc = fmaf(__ldg(m + j), __fmul_rn((float)row[sx * 3], inv255), acc);
    }
    mid[i] = quant(acc, inv255);
  }
  __syncthreads();

  // H pass: lr[oy][ox][c] = quant(sum_y M[oy][y] mid[y][ox][c])
  float* lr_out = lr + (size_t)b * s * s * 3;
  for (int i = threadIdx.x; i < s * s * 3; i += NT) {
    const int c = i % 3, r = i / 3;
    const int ox = r % s, oy = r / s;
    const float* m = mat + (size_t)oy * S;
    float acc = 0.f;
    for (int y = band[2 * oy]; y < band[2 * oy + 1]; ++y)
      acc = fmaf(__ldg(m + y), mid[(y * s + ox) * 3 + c], acc);
    lr_out[i] = quant(acc, inv255);
  }
}

// Shared memory one CTA needs for crops of S and an LR side of s.
int smem_bytes(int S, int s) {
  return S * s * 3 * (int)sizeof(float) + S * S * 3;
}

}  // namespace

extern "C" {

// The synthesis of B images on `stream` of `device`.  Returns the
// cudaError_t of the launch (0 on success).
int pair_synth_launch(const void* crops, const void* flips, const void* mat,
                      const void* band, void* hr, void* lr, int B, int S,
                      int s, float inv255, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = smem_bytes(S, s);
  err = cudaFuncSetAttribute(pair_synth,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  pair_synth<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(crops), static_cast<const uint8_t*>(flips),
      static_cast<const float*>(mat), static_cast<const int*>(band),
      static_cast<float*>(hr), static_cast<float*>(lr), S, s, inv255);
  return (int)cudaGetLastError();
}

const char* pair_synth_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
