// The generic window attention kernels (attention_window_generic.cuh) for
// bf16 at head_dim 16: one source a (dtype, head_dim) instance, so that the
// build's parallel nvcc calls share the kernel bodies.

#include "attention_window_generic.cuh"

WIN_INSTANCE(bf16, 16, bf16_d16)
WIN_ENTRY_POINTS(bf16, 16)
