// The generic line attention kernels (attention_window_generic.cuh, its line
// policy: the text-causal call, axial_row and axial_col) for f32 at head_dim
// 32. Each instance has this source and attention_window_generic_f32_d32.cu,
// so that the build's parallel nvcc calls share the kernel bodies.

#include "attention_window_generic.cuh"

LINE_INSTANCE(float, 32, f32_d32)
WIN_ENTRY_POINTS(float, 32)
