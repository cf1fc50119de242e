// Host build of csrc/lincomb.cu's kernel, for the CPU tests
// (tests/test_torch_csrc_host.py): csrc/lincomb.cuh compiles as C++ with the
// PTX carry chains emulated, and the entry points below take the library's
// arguments (device and stream ignored, pointers to host memory), so the
// port's own wrapper (fields/lincomb_kernel.py's run) drives them.  Every
// row runs the kernel's per-row code (lc_row) as one card thread runs it.
// Not part of the port.
#include "../zktpu_torch/csrc/lincomb.cuh"

extern "C" int zk_lincomb(int, const uint32_t* p, uint32_t pinv, const uint32_t* k, const int64_t* desc, int terms,
                          void* out, int64_t n, void*) {
  LincombArgs args;
  if (!lc_args(desc, terms, n, &args) || ((uintptr_t)out & 15)) return -1;
  const MatvecConsts c = mv_consts(p, pinv, k);
  uint32_t* o = static_cast<uint32_t*>(out);
  for (int64_t i = 0; i < n; ++i) lc_row(o + i * MV_L, args, i, c);
  return 0;
}

// The host build has no registers or spills to report: {0, 0, 0, threads a block}.
extern "C" int zk_lincomb_attrs(int* out) {
  out[0] = out[1] = out[2] = 0;
  out[3] = 128;
  return 0;
}
