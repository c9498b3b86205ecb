// The dropout's keep mask in CUDA, shared by the kernels that draw it
// (layer_norm_bwd.cu, the dropout-residual LayerNorm's backward;
// dense_softmax.cu, the dense attention's forward middle): kernels/
// dropout.py's layout. Element e of a mask drawn under (key, site) is word
// e % 4 of Philox4x32-10 at counter (e / 4 low, e / 4 high, site, 0) with
// the key's two words; it is dropped where its top 24 bits are below the
// threshold. Bit-equal to dropout.keep_mask_plain (the card's tests hold
// both kernels' masks against it).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace philox {

// Philox4x32-10 (kernels/dropout.py _philox_tl: the same rounds)
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                        uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t h0 = __umulhi(c0, 0xD2511F53u), h1 = __umulhi(c2, 0xCD9E8D57u);
    const uint32_t l0 = c0 * 0xD2511F53u, l1 = c2 * 0xCD9E8D57u;
    c0 = h1 ^ c1 ^ k0;
    c2 = h0 ^ c3 ^ k1;
    c1 = l1;
    c3 = l0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

struct Mask {
  uint32_t k0, k1, site;
  int thresh;
  // the four words of Philox block `grp` (elements 4 grp .. 4 grp + 3)
  __device__ __forceinline__ uint4 block(uint64_t grp) const {
    return philox((uint32_t)grp, (uint32_t)(grp >> 32), site, 0u, k0, k1);
  }
  __device__ __forceinline__ bool keeps(uint32_t w) const { return (int)(w >> 8) >= thresh; }
};

}  // namespace philox
