// The generic window attention kernels (attention_window_generic.cuh:
// conv_like and full) for bf16 at head_dim 32. Each instance has this source
// and attention_line_generic_bf16_d32.cu, so that the build's parallel nvcc
// calls share the kernel bodies.

#include "attention_window_generic.cuh"

WIN_INSTANCE(bf16, 32, bf16_d32)
WIN_ENTRY_POINTS(bf16, 32)
