// words.cuh: the access words of the DBS kernels (dbs_rw.cu, dbs_copy.cu).
// The kernels move a dtype's bytes in words of 16, 8, 4, 2 or 1 bytes; the
// wrappers pick the widest that divides a block's or a row's bytes and the
// base pointers' alignment (kernels/_build.py word_bytes).
#pragma once

#include <cuda_runtime.h>

// Calls f with a value of the word type of `word` bytes (16, 8, 4, 2 or 1);
// false for another width.
template <typename F>
bool by_word(int word, F&& f) {
  switch (word) {
    case 16: f(uint4{}); return true;
    case 8: f(uint2{}); return true;
    case 4: f(0u); return true;
    case 2: f((unsigned short)0); return true;
    case 1: f((unsigned char)0); return true;
    default: return false;
  }
}
