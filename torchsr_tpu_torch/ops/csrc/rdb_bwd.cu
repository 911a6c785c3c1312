// Residual dense block (RDB) backward for Hopper (sm_90a).
//
// Replaces the TPU kernel torchsr_tpu/ops/pallas/rdb.py:495
// (_rdb_bwd_kernel, launched by _rdb_bwd :686 from the custom-VJP rule
// _fused_rdb_bwd :853).  Inputs: the output cotangent g (B, H, W, 64) and
// the forward's (B, H, W, 192) feature buffer (x, then the four
// post-activation 32-channel slices) that csrc/rdb_fwd.cu filled.  With
// the convs i = 0..4 (C_in = 64 + 32 i, C_out = 32, or 64 for conv 5):
//
//   da_4 = scale * g;  da_i = dF[:, C_in(i) : +32] * LReLU'(feat there)
//   dy_i = round(da_i) to the working dtype;  db_i = sum_p da_i
//   dW_i[ky][kx][ci][co] = sum_p feat[p + (ky-1, kx-1)][ci] * dy_i[p][co]
//   dF = sum_i conv3x3(dy_i, flip(W_i) with C_in <-> C_out), over C_in(i)
//   dx = dF[:, :64] + g
//
// Products take working-dtype operands (bf16 under AMP, else f32) and
// sum in f32; dW and db are f32; dx is stored in g's dtype: the
// precision contract of rdb.py:538-577.  Every dy_i lands in one
// (B, H, W, 192) buffer DY = [dy_0 | ... | dy_4], which the wrapper
// returns.  Each slot's dense gradient is one conv over DY's later
// channels, so no dense gradient reaches device memory (the TPU kernel
// kept it in VMEM, rdb.py:536).  One C entry a dtype, eight launches
// each (prep, four slot convs, dx, wgrad, reduce):
//
//  * bf16: csrc/rdb_bwd_sm90.cuh, on wgmma with cp.async rings and
//    persistent CTAs.  Design and bound in that header.
//  * f32 (--disable-amp): csrc/rdb_bwd_tf32_sm90.cuh, the same data flow
//    on wgmma with each product taken as three TF32 ones (3xTF32), the
//    slot convs on the f32 forward's machinery.  Design and bound there.

#include "rdb_bwd_sm90.cuh"
#include "rdb_bwd_tf32_sm90.cuh"

extern "C" {

// The bf16 block backward: eight launches (csrc/rdb_bwd_sm90.cuh) from g
// and feat (B, H, W, 64 / 192) and the five kernels (pointers and
// (ky, kx, ci, co) element strides; f32 with w_f32 = 1, else bf16) into
// DY, dx, the flat f32 dW (239,616) and db (192), through the scratch
// wpack (packed weights), dw_part and db_part.  Returns the first
// launch's cudaError_t (0 on success), as every entry point below.
int rdb_bwd_bf16_launch(const void* g, const void* feat, const void* wptr,
                        const void* wstride, int w_f32, void* dy, void* dx,
                        void* wpack, void* dw_part, void* db_part, void* dw,
                        void* db, int B, int H, int W, float scale,
                        int nblocks, int P, int g_conv, int g_dx, int g_wgrad,
                        int device, void* stream) {
  return rdb_bwd_sm90::launch_bwd_entry(
      g, feat, static_cast<const void* const*>(wptr),
      static_cast<const long long*>(wstride), w_f32, dy, dx, wpack, dw_part,
      db_part, dw, db, B, H, W, 0, scale, nblocks, P, g_conv, g_dx, g_wgrad,
      device, stream);
}

// The f32 block backward (3xTF32): eight launches (csrc/
// rdb_bwd_tf32_sm90.cuh) from g and feat (B, H, W, 64 / 192, f32) and
// the five f32 kernels (pointers and element strides) into the f32 DY,
// dx, dW (flat, 239,616) and db (192), through the scratch wpack (hi and
// lo planes, rdb_bwd_tf32::WPACK floats), dw_part (NTILES x g_wgrad
// partials) and db_part (5 x P rows of 64); nb_dy prep blocks of db_4
// partials, the three grids.
int rdb_bwd_tf32_launch(const void* g, const void* feat, const void* wptr,
                        const void* wstride, void* dy, void* dx, void* wpack,
                        void* dw_part, void* db_part, void* dw, void* db,
                        int B, int H, int W, float scale, int nb_dy, int P,
                        int g_conv, int g_dx, int g_wgrad, int device,
                        void* stream) {
  return rdb_bwd_tf32::launch_bwd_entry(
      g, feat, static_cast<const void* const*>(wptr),
      static_cast<const long long*>(wstride), dy, dx, wpack, dw_part,
      db_part, dw, db, B, H, W, 0, scale, nb_dy, P, g_conv, g_dx, g_wgrad,
      device, stream);
}

// The f32 backward's schedule at (B, H, W) into out (11 ints), as
// rdb_bwd_tf32::bwd_schedule_of lays it out; host only, always 0.
int rdb_bwd_tf32_schedule(int B, int H, int W, int* out) {
  rdb_bwd_tf32::bwd_schedule_of(B, H, W, out);
  return 0;
}

const char* rdb_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
