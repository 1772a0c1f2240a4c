// The generic window attention kernels (attention_window_generic.cuh) for
// f32 at head_dim 64: one source a (dtype, head_dim) instance, so that the
// build's parallel nvcc calls share the kernel bodies.

#include "attention_window_generic.cuh"

WIN_INSTANCE(float, 64, f32_d64)
WIN_ENTRY_POINTS(float, 64)
