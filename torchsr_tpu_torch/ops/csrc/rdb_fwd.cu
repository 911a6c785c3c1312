// Residual dense block (RDB) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel torchsr_tpu/ops/pallas/rdb.py:142
// (_rdb_fwd_kernel, launched by _rdb_fwd :440 through fused_rdb :875).
// One RDB is five dense 3x3 SAME convolutions on NHWC activations:
// conv i reads the first C_in = 64 + 32 i channels of a feature buffer
// and appends its C_out = 32 outputs (after bias and LeakyReLU(0.2));
// conv 5 (C_in 192, C_out 64) gives out = x + scale * (conv5 + b5).
//
// The TPU kernel keeps whole images and the dense-concat buffer in VMEM
// (many MB); an SM has at most 227 KB of shared memory, so here the
// concat lives in device memory instead: one (B*H*W, 192) NHWC buffer
// holding x in channels [0, 64); conv i reads channels [0, C_in) and
// writes [C_in, C_in + 32) of the same buffer (disjoint ranges, so the
// concat costs nothing); conv 5 writes the block output.  Both storage
// types accumulate in f32, as the TPU kernel does, and store in the
// storage type.
//
//  * bf16 (serving and training under AMP): one C entry of six launches
//    from csrc/rdb_fwd_sm90.cuh (a prep that packs the caller's kernels,
//    then five convs with the TPU kernel's kx-packed N = 96 product on
//    wgmma, the first of which reads x and copies it into the buffer;
//    design and bound there).
//  * f32 (--disable-amp, eval, validation, renders): one C entry of six
//    launches from csrc/rdb_fwd_tf32_sm90.cuh, the same data flow on
//    wgmma with each product taken as three TF32 ones (3xTF32): a prep
//    that splits the caller's kernels into hi and lo planes, then five
//    convs that stream those planes beside the halo (design and bound
//    there).

#include "rdb_fwd_sm90.cuh"
#include "rdb_fwd_tf32_sm90.cuh"

extern "C" {

// The bf16 block forward: x (B, H, W, 64) into feat (B, H, W, 192) and
// its four grown slices, the block output into out (B, H, W, 64).  wptr
// and wstride: the five HWIO kernels' pointers and (ky, kx, ci, co)
// element strides, f32 (w_f32 = 1) or bf16; bptr: the five f32 biases;
// wpack: scratch for the packed weights (rdb_fwd_sm90::WPACK bf16).
// Returns the cudaError_t of the first failed launch (0 on success), as
// every entry point below.
int rdb_fwd_bf16_launch(const void* x, void* feat, void* out,
                        const void* wptr, const void* wstride, int w_f32,
                        const void* bptr, void* wpack, int B, int H, int W,
                        float scale, int device, void* stream) {
  return rdb_fwd_sm90::launch_fwd_entry(
      x, feat, out, static_cast<const void* const*>(wptr),
      static_cast<const long long*>(wstride), w_f32,
      static_cast<const void* const*>(bptr), wpack, B, H, W, 0, scale,
      device, stream);
}

// The bf16 forward's schedule at (B, H, W) into out (18 ints), as
// rdb_fwd_sm90::fwd_schedule_of lays it out; host only, always 0.
int rdb_fwd_bf16_schedule(int B, int H, int W, int* out) {
  rdb_fwd_sm90::fwd_schedule_of(B, H, W, out);
  return 0;
}

// The f32 block forward (3xTF32): x (B, H, W, 64) into feat (B, H, W,
// 192) and its four grown slices, the block output into out (B, H, W,
// 64).  wptr and wstride: the five f32 HWIO kernels' pointers and (ky,
// kx, ci, co) element strides; bptr: the five f32 biases; wpack: scratch
// for the split weights (rdb_fwd_tf32::WPACK f32).
int rdb_fwd_tf32_launch(const void* x, void* feat, void* out,
                        const void* wptr, const void* wstride,
                        const void* bptr, void* wpack, int B, int H, int W,
                        float scale, int device, void* stream) {
  return rdb_fwd_tf32::launch_fwd_entry(
      x, feat, out, static_cast<const void* const*>(wptr),
      static_cast<const long long*>(wstride),
      static_cast<const void* const*>(bptr), wpack, B, H, W, 0, scale,
      device, stream);
}

// The f32 forward's schedule at (B, H, W) into out (9 ints), as
// rdb_fwd_tf32::fwd_schedule_of lays it out; host only, always 0.
int rdb_fwd_tf32_schedule(int B, int H, int W, int* out) {
  rdb_fwd_tf32::fwd_schedule_of(B, H, W, out);
  return 0;
}

const char* rdb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
