// The generic line attention kernels (attention_window_generic.cuh, its line
// policy: the text-causal call, axial_row and axial_col) for bf16 at head_dim
// 32. Each instance has this source and attention_window_generic_bf16_d32.cu,
// so that the build's parallel nvcc calls share the kernel bodies.

#include "attention_window_generic.cuh"

LINE_INSTANCE(bf16, 32, bf16_d32)
WIN_ENTRY_POINTS(bf16, 32)
