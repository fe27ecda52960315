// H6-decode's instances at a head dim that is not a multiple of 16 (the
// ODD forms of paged_decode.cuh), in a translation unit of their own so
// that they compile beside the others; eft_paged_decode
// (paged_decode.cu) launches them.

#include "paged_decode.cuh"

namespace eft {
namespace decode {

int launch_odd(const Args& a, cudaStream_t stream) {
  return launch_d<true>(a, stream);
}

}  // namespace decode
}  // namespace eft
