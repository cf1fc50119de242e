// Host build of the field hash's per-thread code, for the CPU tests
// (tests/test_torch_csrc_host.py): csrc/sha256.cuh compiles as C++ (the
// funnel shifts, byte swap and multiply-high emulated), and host_sha256_field
// runs sha256_field_hash for each output as one CUDA thread of
// csrc/sha256.cu's kernel does, over the same rows of two u32 words.  Not
// part of the port.
#include "../zktpu_torch/csrc/sha256.cuh"

extern "C" void host_sha256_field(const uint32_t* in, uint32_t* out, int64_t n_in, int pairs) {
  const int64_t n_out = pairs ? (n_in + 1) / 2 : n_in;
  for (int64_t i = 0; i < n_out; ++i) {
    const int64_t j = pairs ? 2 * i : i;
    const uint64_t a = in[2 * j] | (uint64_t)in[2 * j + 1] << 32;
    const bool pair = pairs && j + 1 < n_in;
    const uint64_t b = pair ? in[2 * j + 2] | (uint64_t)in[2 * j + 3] << 32 : 0;
    const uint64_t h = sha256_field_hash(a, b, pair);
    out[2 * i] = (uint32_t)h;
    out[2 * i + 1] = (uint32_t)(h >> 32);
  }
}
