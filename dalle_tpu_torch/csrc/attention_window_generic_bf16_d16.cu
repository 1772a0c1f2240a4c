// The generic window attention kernels (attention_window_generic.cuh:
// conv_like and full) for bf16 at head_dim 16. Each instance has this source
// and attention_line_generic_bf16_d16.cu, so that the build's parallel nvcc
// calls share the kernel bodies.

#include "attention_window_generic.cuh"

WIN_INSTANCE(bf16, 16, bf16_d16)
WIN_ENTRY_POINTS(bf16, 16)
