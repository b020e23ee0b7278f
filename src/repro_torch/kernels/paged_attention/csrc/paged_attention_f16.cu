// paged_attention_f16: the fp16 forms of paged_attention.cu (q and the
// output fp16 over fp16 or fp32 pools), built as a library of its own so
// that nvcc compiles them beside the other forms'; the kernel, its design
// and its entries are in paged_attention.cu.
#define PAGED_ATTENTION_F16
#include "paged_attention.cu"
