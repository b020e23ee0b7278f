// flash_attention_wgmma_f16: the fp16 form of flash_attention_wgmma.cu (q,
// k, v and the output fp16), built as a library of its own beside the bf16
// form's; the kernel, its design and its entries are in
// flash_attention_wgmma.cu.
#define FLASH_WGMMA_F16
#include "flash_attention_wgmma.cu"
