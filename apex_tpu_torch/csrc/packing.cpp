// apex_tpu_torch host runtime: flatten / unflatten of host buffers.
//
// The port's copy of the JAX package's csrc/packing.cpp, itself the
// counterpart of apex_C (csrc/flatten_unflatten.cpp): the C++ behind DDP
// bucketing and multi-tensor packing.  On the host (assembling checkpoint
// shards, staging numpy data into one buffer, unpacking a restored flat
// buffer) the work is memcpy, which this does in one call per list.
//
// Built with the host C++ compiler on first use by
// apex_tpu_torch.utils._native (c++ -O3 -shared -fPIC) into build/, and
// bound with ctypes.

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// Copy n_leaves host buffers end to end into one contiguous buffer.
// srcs: the source pointers; sizes: each leaf's bytes; dst: capacity >=
// sum(sizes).  Returns the bytes written.
int64_t apex_tpu_torch_flatten(const void **srcs, const int64_t *sizes,
                               int64_t n_leaves, void *dst) {
  char *out = static_cast<char *>(dst);
  int64_t off = 0;
  for (int64_t i = 0; i < n_leaves; ++i) {
    std::memcpy(out + off, srcs[i], static_cast<size_t>(sizes[i]));
    off += sizes[i];
  }
  return off;
}

// The inverse: scatter one flat buffer into n_leaves destinations.
int64_t apex_tpu_torch_unflatten(const void *src, const int64_t *sizes,
                                 int64_t n_leaves, void **dsts) {
  const char *in = static_cast<const char *>(src);
  int64_t off = 0;
  for (int64_t i = 0; i < n_leaves; ++i) {
    std::memcpy(dsts[i], in + off, static_cast<size_t>(sizes[i]));
    off += sizes[i];
  }
  return off;
}

// The interface's version, which the loader checks.
int32_t apex_tpu_torch_native_abi(void) { return 1; }

}  // extern "C"
