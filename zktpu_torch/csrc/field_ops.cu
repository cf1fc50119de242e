// Kernel A, the field scans (field_scan: cumprod, cumsum, sum, powers and
// batch_inv's last step), and kernel B, the field add/sub (field_addsub).
//
// Kernel A replaces the log-depth doubling scan of
// zktpu/fields/fp.py::_hillis_steele (:324), which the port ran as ceil(log2 n)
// steps of one concatenation and one launch of the Montgomery product
// (kernel 1, zktpu/fields/pallas_mont.py:363) or of the tensor add: 14
// launches and 14 full passes over memory for one scan of 2^14 rows, and
// about 60 launches for one batch inversion.  Kernel B replaces the tensor
// add/sub of zktpu/fields/fp.py (:270-286, one fused jnp graph on the TPU),
// which the port ran as about 30 small tensor ops per add.
//
// What bounds them on the H100.  A scan of n rows does about 2n products (or
// adds): its bound is those products' 32-bit multiply-adds over the card's
// integer rate, a few microseconds at 2^14 rows.  What holds it back is
// latency: every product in a scan depends on the one before, and a scan
// that fits one wave of blocks waits on its longest chain.  The design
// (field_ops.cuh): one launch at every n, a single-pass scan with decoupled
// look-back, its tiles small enough that the grid spreads over the SMs; each
// thread loads a few rows (SCAN_LOADS at a time, before their products),
// the warps scan their threads' totals by __shfl_up_sync (one shuffle per
// limb per step), warp 0 scans the warp totals from shared memory and looks
// back over the earlier tiles' published aggregates and inclusive prefixes,
// 32 at a time (one a lane, combined by __shfl_down_sync), and each thread
// walks its rows again to write; a dependent chain of about 2C + 18
// products and the look-back's windows.  A scan of at most SCAN_ONE_TILE rows a
// thread takes one tile a lane, where a block's chain is shorter than a
// look-back.  The forward and the reverse scan
// of batch_inv share the launch, and the sum is the same launch with the
// last tile's inclusive prefix written in place of the rows.  Rows are read
// and written as 16-byte words.  powers builds each thread's first power
// from a table of z^(2^j) in the kernel's parameters, so it is one launch
// with no input.  Kernel B is bound by its bytes (two operands in, one
// out): one thread a row, 16-byte loads and stores, operands broadcast by
// a modulo on the row index.
//
// Plain C interface, loaded with ctypes; each entry point returns
// cudaGetLastError() after its launch, or -1 for an unsupported width.
#include <cuda_runtime.h>

#include <initializer_list>

#include "field_ops.cuh"

constexpr uint32_t FULL_MASK = 0xffffffffu;

template <int L>
__device__ __forceinline__ void shfl_up(uint32_t* dst, const uint32_t* src, uint32_t d) {
#pragma unroll
  for (int j = 0; j < L; ++j) dst[j] = __shfl_up_sync(FULL_MASK, src[j], d);
}

template <int L, int OP>
__global__ void __launch_bounds__(SCAN_THREADS) field_scan_kernel(ScanArgs a, ScanConsts<L> c) {
  __shared__ uint32_t s_warp[SCAN_WARPS * L];
  __shared__ int64_t s_id;
  const uint32_t t = threadIdx.x, lane = t % 32, warp = t / 32;
  int64_t id = blockIdx.x;  // one tile a lane: no ticket
  if (a.tiles > 1) {
    if (t == 0) s_id = (int64_t)(atomicAdd(a.status.ticket, 1ull) - a.ticket_base);
    __syncthreads();
    id = s_id;
  }
  const ScanBlock b = scan_block(a, id);
  uint32_t v[L], x[L];
  scan_chunk_total<L, OP>(a, c, b, t, v);  // 1
#pragma unroll 1
  for (uint32_t d = 1; d < 32; d <<= 1) {  // 2
    shfl_up<L>(x, v, d);
    scan_lane_step<L, OP>(v, x, lane >= d, c.f);
  }
  shfl_up<L>(x, v, 1);  // the exclusive value within the warp
  if (lane == 31) copy_limbs<L>(s_warp + warp * L, v);  // 3
  __syncthreads();
  if (warp == 0) {  // 4
    uint32_t w[L], y[L], agg[L], pre[L];
    scan_warp0_load<L>(c, lane, s_warp, w);
#pragma unroll 1
    for (uint32_t d = 1; d < 32; d <<= 1) {
      shfl_up<L>(y, w, d);
      scan_lane_step<L, OP>(w, y, lane >= d, c.f);
    }
    shfl_up<L>(y, w, 1);
    shfl_from_limbs<L>(agg, w, SCAN_WARPS - 1);
    scan_look_back<L, OP>(a, c, b, lane, agg, pre);
    if (a.mode == SCAN_MODE_SUM) {
      if (lane == 0) {
        scan_op<L, OP>(w, pre, agg, c.f);
        scan_write_total<L>(a, b, w);
      }
    } else {
      scan_warp_prefix<L, OP>(c, b, lane, pre, y, w);
      if (lane < SCAN_WARPS) copy_limbs<L>(s_warp + lane * L, w);
    }
  }
  if (a.mode == SCAN_MODE_SUM) return;
  __syncthreads();
  uint32_t pre[L];
  copy_limbs<L>(pre, s_warp + warp * L);
  scan_chunk_write<L, OP>(a, c, b, t, pre, x);  // 5
}

template <int L>
__global__ void __launch_bounds__(256) field_powers_kernel(uint32_t* out, int64_t count, int64_t chunk,
                                                           ScanConsts<L> c, const __grid_constant__ PowTable<L> tab) {
  powers_thread<L>(out, count, chunk, c, tab, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

template <int L>
__global__ void __launch_bounds__(256) field_batch_inv_kernel(const uint32_t* P, const uint32_t* S, uint32_t* out,
                                                              int64_t n, ScanConsts<L> c, Elem<L> inv) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) batch_inv_row<L>(P, S, out, n, i, c, inv.w);
}

template <int L, int OP>
__global__ void __launch_bounds__(256) field_addsub_kernel(const uint32_t* __restrict__ a, int64_t na,
                                                           const uint32_t* __restrict__ b, int64_t nb,
                                                           uint32_t* __restrict__ out, int64_t n, FieldConsts<L> f) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) addsub_row<L, OP>(a, na, b, nb, out, n, i, f);
}

template <int L>
static ScanConsts<L> scan_consts(const uint32_t* p, uint32_t pinv, const uint32_t* ident) {
  ScanConsts<L> c;
  c.f = make_consts<L>(p, pinv);
  for (int j = 0; j < L; ++j) c.id[j] = ident[j];
  return c;
}

template <int L>
static int launch_scan(const uint32_t* p, uint32_t pinv, const uint32_t* ident, int op, const ScanArgs& a,
                       int64_t blocks, cudaStream_t s) {
  const ScanConsts<L> c = scan_consts<L>(p, pinv, ident);
  if (op == SCAN_OP_MUL) {
    field_scan_kernel<L, SCAN_OP_MUL><<<(unsigned)blocks, SCAN_THREADS, 0, s>>>(a, c);
  } else {
    field_scan_kernel<L, SCAN_OP_ADD><<<(unsigned)blocks, SCAN_THREADS, 0, s>>>(a, c);
  }
  return (int)cudaGetLastError();
}

static bool aligned16(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; }

// One launch of kernel A over an (n, B) grid: `mode` 0 scans (writing
// out_fwd and/or out_rev), 1 sums each column into total (B, L).  The grid
// is tiles x directions x B blocks of SCAN_THREADS threads, tiles =
// ceil(n / (threads chunk)).  status: a buffer of at least
// zk_field_scan_status_words(tiles x directions x B) words, the ticket at
// ticket_base (the blocks of every earlier launch on it of more than one
// tile a lane, which alone take tickets) and no flag of epoch (1 <= epoch <
// 2^30) in it.  ident: the op's identity (host).
// Pointers of 8- and 12-limb rows must be 16-byte aligned.
extern "C" int zk_field_scan(int device, int limbs, const uint32_t* p, uint32_t pinv, const uint32_t* ident, int op,
                             int mode, const void* in, int64_t in_rs, int64_t in_cs, int64_t n, int64_t B,
                             int64_t chunk, int dirs, void* out_fwd, void* out_rev, int64_t out_rs, int64_t out_cs,
                             void* total, void* status, int64_t status_slots, uint64_t ticket_base, uint32_t epoch,
                             void* stream) {
  if (n < 1 || B < 1 || chunk < 1 || dirs < 1 || dirs > 3 || epoch < 1 || epoch >= (1u << 30)) return -1;
  if (mode == SCAN_MODE_SUM ? total == nullptr || dirs != SCAN_FORWARD : mode != SCAN_MODE_SCAN) return -1;
  const int64_t tiles = (n + SCAN_THREADS * chunk - 1) / (SCAN_THREADS * chunk);
  const int64_t blocks = tiles * scan_dirs_count(dirs) * B;
  if (blocks > 0x7fffffff || blocks > status_slots || (reinterpret_cast<uintptr_t>(status) & 15)) return -1;
  if (limbs % 4 == 0) {
    for (const void* q : {in, (const void*)out_fwd, (const void*)out_rev, (const void*)total})
      if (!aligned16(q)) return -1;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  ScanArgs a;
  a.in = static_cast<const uint32_t*>(in);
  a.in_rs = in_rs;
  a.in_cs = in_cs;
  a.out_fwd = static_cast<uint32_t*>(out_fwd);
  a.out_rev = static_cast<uint32_t*>(out_rev);
  a.out_rs = out_rs;
  a.out_cs = out_cs;
  a.total = static_cast<uint32_t*>(total);
  a.status = scan_status(static_cast<uint32_t*>(status), status_slots);
  a.ticket_base = ticket_base;
  a.n = n;
  a.B = B;
  a.chunk = chunk;
  a.tiles = tiles;
  a.epoch = epoch;
  a.dirs = dirs;
  a.mode = mode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (limbs) {
    case 2:
      return launch_scan<2>(p, pinv, ident, op, a, blocks, s);
    case 8:
      return launch_scan<8>(p, pinv, ident, op, a, blocks, s);
    case 12:
      return launch_scan<12>(p, pinv, ident, op, a, blocks, s);
    default:
      return -1;
  }
}

// The threads of a block of field_scan_kernel (the wrapper sizes its tiles with it).
extern "C" int zk_field_scan_threads() { return (int)SCAN_THREADS; }

// out = the words of a status buffer of `slots` slots.
extern "C" int zk_field_scan_status_words(int64_t slots, int64_t* out) {
  *out = scan_status_words(slots);
  return 0;
}

template <int L>
static int launch_powers(const uint32_t* p, uint32_t pinv, const uint32_t* one, const uint32_t* table, void* out,
                         int64_t count, int64_t chunk, cudaStream_t s) {
  PowTable<L> tab;
  for (int j = 0; j < 32; ++j)
    for (int k = 0; k < L; ++k) tab.z2[j][k] = table[j * L + k];
  const int64_t threads = (count + chunk - 1) / chunk;
  field_powers_kernel<L><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      static_cast<uint32_t*>(out), count, chunk, scan_consts<L>(p, pinv, one), tab);
  return (int)cudaGetLastError();
}

// out[r] = z^r (Montgomery) for r < count < 2^32; table: z^(2^j) for j < 32
// (host, 32 x limbs words); one: the Montgomery one (host).
extern "C" int zk_field_powers(int device, int limbs, const uint32_t* p, uint32_t pinv, const uint32_t* one,
                               const uint32_t* table, void* out, int64_t count, int64_t chunk, void* stream) {
  if (count < 1 || count > 0xffffffffLL || chunk < 1 || (limbs % 4 == 0 && !aligned16(out))) return -1;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (limbs) {
    case 2:
      return launch_powers<2>(p, pinv, one, table, out, count, chunk, s);
    case 8:
      return launch_powers<8>(p, pinv, one, table, out, count, chunk, s);
    case 12:
      return launch_powers<12>(p, pinv, one, table, out, count, chunk, s);
    default:
      return -1;
  }
}

template <int L>
static int launch_batch_inv(const uint32_t* p, uint32_t pinv, const uint32_t* one, const uint32_t* inv,
                            const void* P, const void* S, void* out, int64_t n, cudaStream_t s) {
  Elem<L> iv;
  for (int k = 0; k < L; ++k) iv.w[k] = inv[k];
  field_batch_inv_kernel<L><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const uint32_t*>(P), static_cast<const uint32_t*>(S), static_cast<uint32_t*>(out), n,
      scan_consts<L>(p, pinv, one), iv);
  return (int)cudaGetLastError();
}

// batch_inv's last step: out[i] = P[i - 1] S[i + 1] inv for the prefix and
// suffix products P, S of n rows; one, inv: Montgomery limbs (host).
extern "C" int zk_field_batch_inv(int device, int limbs, const uint32_t* p, uint32_t pinv, const uint32_t* one,
                                  const uint32_t* inv, const void* P, const void* S, void* out, int64_t n,
                                  void* stream) {
  if (n < 1) return -1;
  if (limbs % 4 == 0 && !(aligned16(P) && aligned16(S) && aligned16(out))) return -1;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (limbs) {
    case 2:
      return launch_batch_inv<2>(p, pinv, one, inv, P, S, out, n, s);
    case 8:
      return launch_batch_inv<8>(p, pinv, one, inv, P, S, out, n, s);
    case 12:
      return launch_batch_inv<12>(p, pinv, one, inv, P, S, out, n, s);
    default:
      return -1;
  }
}

template <int L>
static int launch_addsub(const uint32_t* p, uint32_t pinv, int op, const void* a, int64_t na, const void* b,
                         int64_t nb, void* out, int64_t n, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + 255) / 256);
  const FieldConsts<L> f = make_consts<L>(p, pinv);
  const uint32_t *x = static_cast<const uint32_t*>(a), *y = static_cast<const uint32_t*>(b);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (op == FIELD_ADD) {
    field_addsub_kernel<L, FIELD_ADD><<<blocks, 256, 0, s>>>(x, na, y, nb, o, n, f);
  } else {
    field_addsub_kernel<L, FIELD_SUB><<<blocks, 256, 0, s>>>(x, na, y, nb, o, n, f);
  }
  return (int)cudaGetLastError();
}

// Kernel B: out[i] = a[i mod na] + b[i mod nb] (op 0) or - (op 1), canonical.
extern "C" int zk_field_addsub(int device, int limbs, const uint32_t* p, uint32_t pinv, int op, const void* a,
                               int64_t na, const void* b, int64_t nb, void* out, int64_t n, void* stream) {
  if (n < 1 || na < 1 || nb < 1 || (op != FIELD_ADD && op != FIELD_SUB)) return -1;
  if (limbs % 4 == 0 && !(aligned16(a) && aligned16(b) && aligned16(out))) return -1;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (limbs) {
    case 2:
      return launch_addsub<2>(p, pinv, op, a, na, b, nb, out, n, s);
    case 8:
      return launch_addsub<8>(p, pinv, op, a, na, b, nb, out, n, s);
    case 12:
      return launch_addsub<12>(p, pinv, op, a, na, b, nb, out, n, s);
    default:
      return -1;
  }
}

template <typename K>
static int max_attrs(K kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs > out[0] ? a.numRegs : out[0];
  out[1] = (int)a.localSizeBytes > out[1] ? (int)a.localSizeBytes : out[1];
  out[2] = (int)a.sharedSizeBytes > out[2] ? (int)a.sharedSizeBytes : out[2];
  return 0;
}

// The largest registers per thread, local-memory bytes (spills) and static
// shared bytes per block over the widths of kernel A (kind 0: the scan,
// powers and batch_inv kernels) or kernel B (kind 1): out = {registers,
// local bytes, shared bytes}.
extern "C" int zk_field_ops_attrs(int kind, int* out) {
  out[0] = out[1] = out[2] = 0;
  int e = 0;
  if (kind == 0) {
    for (int r : {max_attrs(field_scan_kernel<8, SCAN_OP_MUL>, out), max_attrs(field_scan_kernel<8, SCAN_OP_ADD>, out),
                  max_attrs(field_scan_kernel<12, SCAN_OP_MUL>, out), max_attrs(field_scan_kernel<12, SCAN_OP_ADD>, out),
                  max_attrs(field_scan_kernel<2, SCAN_OP_MUL>, out), max_attrs(field_scan_kernel<2, SCAN_OP_ADD>, out),
                  max_attrs(field_powers_kernel<8>, out), max_attrs(field_powers_kernel<12>, out),
                  max_attrs(field_powers_kernel<2>, out), max_attrs(field_batch_inv_kernel<8>, out),
                  max_attrs(field_batch_inv_kernel<12>, out), max_attrs(field_batch_inv_kernel<2>, out)})
      e = e ? e : r;
  } else if (kind == 1) {
    for (int r : {max_attrs(field_addsub_kernel<8, FIELD_ADD>, out), max_attrs(field_addsub_kernel<8, FIELD_SUB>, out),
                  max_attrs(field_addsub_kernel<12, FIELD_ADD>, out), max_attrs(field_addsub_kernel<12, FIELD_SUB>, out),
                  max_attrs(field_addsub_kernel<2, FIELD_ADD>, out), max_attrs(field_addsub_kernel<2, FIELD_SUB>, out)})
      e = e ? e : r;
  } else {
    return -1;
  }
  return e;
}
