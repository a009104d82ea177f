// K2-layer: one MDR LBF layer of the serving path with unfolded weights,
// rounding to the working type after every product and bias add.
//
// Replaces gator_tpu/nn/pallas_mdr.py:153 `lbf_layer_fused` (kernel body
// `_kernel:143` -> `_layer_math:87`), whose one caller is the per-stage
// serving profile (tools/profile_serving.py; here
// gator_tpu_torch/tools/profile_serving.py). Two launches per layer, the
// device code of lbf_layer.cuh under the round-everything policy, both on
// the tensor cores: what they compute, what bounds them on the H100 and
// how the design meets it is written there. Unlike K2 (lbf_stack.cu) the
// output is in the working type, the self-attention residual is the
// rounded std-LN output and every product and bias add is rounded, as
// `_layer_math` does.
#include "lbf_layer.cuh"

using gator::lbf_layer::FULL;

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its
// launch. x, joints, q2, k2, v2 and out are T; y3 is f32 [B, Nv, 64].
extern "C" int lbf_layer_rows_launch(int dtype, const void* x,
                                     const void* joints, const void* weights,
                                     const void* offs, void* y3, void* q2,
                                     void* k2, void* v2, int B, int Nv, int J,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gator::lbf_layer::launch_rows<float, true, FULL>(
        x, joints, weights, offs, y3, q2, k2, v2, nullptr, B, Nv, J, s);
  return gator::lbf_layer::launch_rows<__nv_bfloat16, true, FULL>(
      x, joints, weights, offs, y3, q2, k2, v2, nullptr, B, Nv, J, s);
}

extern "C" int lbf_layer_attn_launch(int dtype, const void* q2,
                                     const void* k2, const void* v2,
                                     const void* y3, const void* weights,
                                     const void* offs, void* out, int B,
                                     int Nv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gator::lbf_layer::launch_attn<float, true, FULL>(
        q2, k2, v2, y3, weights, offs, out, B, Nv, s);
  return gator::lbf_layer::launch_attn<__nv_bfloat16, true, FULL>(
      q2, k2, v2, y3, weights, offs, out, B, Nv, s);
}

// The attention launch's plan at Nv keys (`attn_info`'s `what`: 0 keys per
// K/V chunk, 1 CTAs per SM, 2 shared bytes, 3 registers); -1 on an error.
extern "C" int lbf_layer_attn_info(int dtype, int Nv, int what) {
  if (dtype == 0)
    return gator::lbf_layer::attn_info<float, true, FULL>(Nv, what);
  return gator::lbf_layer::attn_info<__nv_bfloat16, true, FULL>(Nv, what);
}
