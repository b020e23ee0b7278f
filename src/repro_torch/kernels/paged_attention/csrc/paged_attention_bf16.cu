// paged_attention_bf16: the bf16 forms of paged_attention.cu (q and the
// output bf16 over bf16 or fp32 pools), built as a library of their own so
// that nvcc compiles them beside the fp32 form's; the kernel, its design
// and its entries are in paged_attention.cu.
#define PAGED_ATTENTION_BF16
#include "paged_attention.cu"
