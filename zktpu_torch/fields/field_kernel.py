"""Kernel A (``field_scan``: the field scans) and kernel B (``field_addsub``:
the field add and sub), and their plain PyTorch versions.

Kernel A replaces zktpu/fields/fp.py::_hillis_steele (:324), the log-depth
doubling scan under ``cumprod``, ``cumsum``, ``powers`` and ``batch_inv``,
and the tree of adds of ``sum``; in the port it computes, over field
elements (..., L) int32 Montgomery limbs of Fr, Fq or Goldilocks,

- ``scan``: the inclusive scan by the Montgomery product (cumprod) or the
  field add (cumsum) along one axis, forward or reverse;
- ``field_sum``: the field sum along one axis;
- ``powers``: [1, z, ..., z^(count-1)];
- ``batch_inv``: Montgomery's trick, inv(a_i) = P_{i-1} S_{i+1} inv(P_{n-1})
  for the prefix products P and suffix products S, the total inverted on the
  host by the caller's function.

Kernel B replaces the tensor add/sub of zktpu/fields/fp.py (:270-286):
``add`` and ``sub`` with operands that broadcast over leading axes.

The CUDA kernels are csrc/field_ops.cu (per-thread code in
csrc/field_ops.cuh, which says how a block scans).  Every scan and every
``field_sum`` is one launch at every n: a single-pass scan with decoupled
look-back, whose blocks publish their tiles' aggregates and inclusive
prefixes in a status buffer (one per device, kept here: ``_Status``) and
take their tiles from its atomic ticket; the sum is the same launch, the
last tile's inclusive prefix its column's total.  ``powers`` is one launch;
``batch_inv`` runs the forward and the reverse scan in one launch, copies
the 32- or 48-byte total to the host and ends with one launch.  An add or
sub is one launch; an operand whose batch shape is a suffix of the output's
is read in place by a modulo on the row index.  The module constants below
are the design's sizes (``tools/scan_tiles.py`` sweeps them and the block's
threads).

Every op is canonical, and both combining ops are associative and
commutative, so the kernels give the plain versions' words whatever their
grouping.  The plain versions are the port's earlier tensor code: int64
limbs with constant-depth carry resolution (fields/limbs.py), the doubling
scan and the tree of adds.  The wrappers run them for CPU tensors only; for
CUDA tensors they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_lib
from .host import FQ, FR, GOLDILOCKS, FieldSpec
from .limbs import MASK32, narrow, resolve, widen
from .mont_kernel import _broadcast_operand, mont_mul_plain

OP_MUL, OP_ADD = 0, 1  # the scan's combining op
_MODE_SCAN, _MODE_SUM = 0, 1
_FORWARD, _REVERSE = 1, 2
_ADD, _SUB = 0, 1

# The design's sizes (tools/scan_tiles.py, on an H100).  A scan's tiles are
# threads x chunk rows, the chunk the smallest that keeps the grid (tiles x
# directions x columns) within SCAN_GRID blocks, and at most SCAN_CHUNK_MAX:
# short scans spread over the SMs a few rows a thread, their chains short,
# and long ones take longer chunks, so that the tiles' look-backs and
# warp-0 steps stay a small share; but a scan of at most SCAN_ONE_TILE rows
# a thread takes one tile a column, where a block's chain is shorter than a
# look-back.  POWERS_CHUNK: rows a thread of powers takes.
SCAN_GRID = 132
SCAN_CHUNK_MAX = 32
SCAN_ONE_TILE = 2
POWERS_CHUNK = 8
_EPOCHS = 1 << 30  # a status flag's epoch is below this

# Launches of each kernel per field, counted where they are launched.
launches = {
    "field_scan": {FR.name: 0, FQ.name: 0, GOLDILOCKS.name: 0},
    "field_addsub": {FR.name: 0, FQ.name: 0, GOLDILOCKS.name: 0},
}


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


def _reduce_plain(f, s: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """Value top * R + s (< 2p) -> canonical int32 limbs."""
    d, no_borrow = resolve(s + f._neg_p, 32)  # s - p mod R
    take = (top | no_borrow)[..., None]
    return narrow(torch.where(take, d, s))


def add_plain(f, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(widen(a), widen(b))
    s, top = resolve(a + b, 32)
    return _reduce_plain(f, s, top)


def sub_plain(f, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(widen(a), widen(b))
    d, no_borrow = resolve(a + (MASK32 - b) + _unit(a), 32)  # a - b mod R
    dp, _ = resolve(d + f._p, 32)  # a - b + p mod R
    return narrow(torch.where(no_borrow[..., None], d, dp))


def _unit(x: torch.Tensor) -> torch.Tensor:
    """1 in the lowest limb, broadcastable against x: the +1 of a two's
    complement subtraction."""
    u = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device)
    u[0] = 1
    return u


def sum_plain(f, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Field sum along `axis` by a binary tree of adds."""
    a = torch.movedim(a, axis, 0)
    while a.shape[0] > 1:
        half = a.shape[0] // 2
        s = add_plain(f, a[:half], a[half : 2 * half])
        a = torch.cat([s, a[2 * half :]], dim=0)
    return a[0]


def _op_plain(f, op: int):
    if op == OP_MUL:
        return lambda x, y: mont_mul_plain(f.spec, x, y)
    return lambda x, y: add_plain(f, x, y)


def scan_plain(f, a: torch.Tensor, op: int, axis: int = 0, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan by log-depth doubling (zktpu fp.py::_hillis_steele)."""
    combine, identity = _op_plain(f, op), (f.one if op == OP_MUL else f.zero)
    a = torch.movedim(a, axis, 0)
    if reverse:
        a = torch.flip(a, dims=(0,))
    n = a.shape[0]
    d = 1
    while d < n:
        shifted = torch.cat([identity.expand((d,) + a.shape[1:]), a[:-d]], dim=0)
        a = combine(a, shifted)
        d *= 2
    if reverse:
        a = torch.flip(a, dims=(0,))
    return torch.movedim(a, 0, axis)


def powers_plain(f, base: int, count: int) -> torch.Tensor:
    """[1, z, ..., z^(count-1)] as (count, L) Montgomery limbs."""
    if count <= 0:
        return torch.zeros((0, f.num_limbs), dtype=torch.int32, device=f.device)
    g = f.encode_int(int(base) % f.spec.modulus)
    arr = torch.cat([f.one[None], g.expand(count - 1, f.num_limbs)], dim=0)
    return scan_plain(f, arr, OP_MUL)


def batch_inv_plain(f, a: torch.Tensor, host_inv) -> torch.Tensor:
    """Montgomery-trick batch inversion over the leading axis; the total
    product is inverted on the host by `host_inv` (int -> int)."""
    spec = f.spec
    flat = a.reshape(-1, f.num_limbs)
    prefix = scan_plain(f, flat, OP_MUL)
    suffix = scan_plain(f, flat, OP_MUL, reverse=True)
    total = _limbs_to_int(mont_mul_plain(spec, prefix[-1], f._one_raw).cpu())  # from Montgomery form
    inv_total = f.encode_int(host_inv(total))
    ones = f.one[None]
    p_left = torch.cat([ones, prefix[:-1]], dim=0)
    s_right = torch.cat([suffix[1:], ones], dim=0)
    return mont_mul_plain(spec, mont_mul_plain(spec, p_left, s_right), inv_total).reshape(a.shape)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------


def _limbs_to_int(row: torch.Tensor) -> int:
    return int.from_bytes(row.numpy().astype("<u4").tobytes(), "little")


def _host_limbs(values, limbs: int) -> np.ndarray:
    """Python ints -> (len, limbs) u32 words on the host, for a launch's arguments."""
    buf = b"".join(int(v).to_bytes(4 * limbs, "little") for v in values)
    return np.frombuffer(buf, dtype="<u4").reshape(-1, limbs).copy()


@functools.lru_cache(maxsize=None)
def _identity(spec: FieldSpec, op: int) -> np.ndarray:
    return _host_limbs([spec.mont_r % spec.modulus if op == OP_MUL else 0], spec.num_digits // 2)


def _stream(t: torch.Tensor) -> int:
    return cuda_lib.stream_of(t) if t.is_cuda else 0


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _grid_view(a: torch.Tensor, axis: int):
    """(tensor, n, B, row stride, column stride) of `a` scanned along `axis`:
    the other batch axes become one column axis, read in place when their
    strides allow it (strides in elements), else from one contiguous copy."""
    x = torch.movedim(a, axis, 0)
    n, L = x.shape[0], x.shape[-1]
    g = x.reshape(n, -1, L)
    if g.stride(2) != 1 or g.stride(0) % L or g.stride(1) % L:
        g = g.contiguous()
    g, _ = _aligned(g, None)
    return g, n, g.shape[1], g.stride(0) // L, g.stride(1) // L


class _Status:
    """The look-back's status buffer of one device (csrc/field_ops.cuh): its
    ticket counter's value before the next launch (the blocks of every launch
    so far), the last launch's epoch, and the stream it ran on.  Launches on
    one stream run one after another, so each finds the buffer as the last
    left it: a fresh epoch marks every slot of earlier launches empty, so no
    launch clears it.  A launch from a second stream while the first still
    has work queued raises rather than share the buffer."""

    def __init__(self):
        self.buf, self.slots, self.ticket, self.epoch, self.stream = None, 0, 0, 0, None

    def take(self, lib, device: torch.device, slots: int):
        """(buffer, its slots, ticket base, epoch, the current stream's handle)
        for a launch of `slots` blocks."""
        handle = 0
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            handle = stream.cuda_stream
            if self.stream is not None and handle != self.stream.cuda_stream and not self.stream.query():
                raise RuntimeError("field_scan: a launch from a second CUDA stream while the scans' status buffer "
                                   "is in use on another; synchronize that stream first")
            self.stream = stream
        if slots > self.slots or self.epoch + 1 >= _EPOCHS:
            self.slots = max(slots, 2 * self.slots, 1024)
            words = ctypes.c_int64()
            cuda_lib.check(lib.zk_field_scan_status_words(self.slots, ctypes.byref(words)), "field_scan status")
            self.buf = torch.zeros(words.value, dtype=torch.int32, device=device)
            self.ticket, self.epoch = 0, 0
        self.epoch += 1
        return self.buf, self.slots, self.ticket, self.epoch, handle


_statuses: dict[torch.device, _Status] = {}


def _chunk(n: int, lanes: int, threads: int) -> int:
    """Rows a thread of a scan of n rows in each of `lanes` columns and
    directions: the rule above."""
    if n <= threads * SCAN_ONE_TILE:
        return -(-n // threads)
    return min(SCAN_CHUNK_MAX, max(1, -(-n * lanes // (threads * SCAN_GRID))))


@functools.lru_cache(maxsize=None)
def _threads(lib) -> int:
    """The threads of a block of `lib`'s scan kernel."""
    return lib.zk_field_scan_threads()


def _pass(lib, spec, op, mode, src, n, B, dirs, out_fwd=None, out_rev=None, out_rs=0, out_cs=0,
          total=None) -> int:
    """The one launch of kernel A (src: (tensor, row stride, column stride)); returns 1."""
    t, rs, cs = src
    threads = _threads(lib)
    nd = 2 if dirs == _FORWARD | _REVERSE else 1
    chunk = _chunk(n, B * nd, threads)
    tiles = -(-n // (threads * chunk))
    blocks = tiles * nd * B
    status = _statuses.get(t.device)
    if status is None:
        status = _statuses[t.device] = _Status()
    buf, slots, ticket, epoch, stream = status.take(lib, t.device, blocks)
    p, pinv = cuda_lib.field_consts(spec)
    ident = _identity(spec, op)
    rc = lib.zk_field_scan(
        t.device.index or 0, spec.num_digits // 2, p, pinv, ident.ctypes.data, op, mode,
        t.data_ptr(), rs, cs, n, B, chunk, dirs, _ptr(out_fwd), _ptr(out_rev), out_rs, out_cs, _ptr(total),
        buf.data_ptr(), slots, ticket, epoch, stream,
    )
    cuda_lib.check(rc, "field_scan")
    if tiles > 1:  # one tile a lane takes no ticket
        status.ticket += blocks
    return 1


def scan_kernel(lib, f, a: torch.Tensor, op: int, axis: int = 0, reverse: bool = False) -> tuple[torch.Tensor, int]:
    """``scan`` through `lib` (the CUDA library or the host build of the
    same code): (result, launches)."""
    g, n, B, rs, cs = _grid_view(a, axis)
    out = torch.empty((n, B, f.num_limbs), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return torch.movedim(out.reshape(torch.movedim(a, axis, 0).shape), 0, axis), 0
    k = _pass(lib, f.spec, op, _MODE_SCAN, (g, rs, cs), n, B, _REVERSE if reverse else _FORWARD,
              None if reverse else out, out if reverse else None, B, 1)
    return torch.movedim(out.reshape(torch.movedim(a, axis, 0).shape), 0, axis), k


def sum_kernel(lib, f, a: torch.Tensor, axis: int = 0) -> tuple[torch.Tensor, int]:
    """``field_sum`` through `lib`: (result, launches)."""
    g, n, B, rs, cs = _grid_view(a, axis)
    if n == 0:
        raise IndexError("field sum over an empty axis")
    out = torch.empty((B, f.num_limbs), dtype=torch.int32, device=a.device)
    k = _pass(lib, f.spec, OP_ADD, _MODE_SUM, (g, rs, cs), n, B, _FORWARD, total=out)
    return out.reshape(torch.movedim(a, axis, 0).shape[1:]), k


def powers_kernel(lib, f, base: int, count: int) -> tuple[torch.Tensor, int]:
    """``powers`` through `lib`: (result, launches)."""
    spec, L = f.spec, f.num_limbs
    out = torch.empty((max(count, 0), L), dtype=torch.int32, device=f.device)
    if count <= 0:
        return out, 0
    if count >= 1 << 32:
        raise ValueError(f"powers: at most 2^32 - 1 powers, got {count}")
    z, table = int(base) % spec.modulus, [0] * 32
    for j in range(max((count - 1).bit_length(), 1)):  # the bits a row index below count can have
        table[j] = spec.to_mont(z)
        z = z * z % spec.modulus
    tab = _host_limbs(table, L)
    p, pinv = cuda_lib.field_consts(spec)
    one = _identity(spec, OP_MUL)
    rc = lib.zk_field_powers(out.device.index or 0, L, p, pinv, one.ctypes.data, tab.ctypes.data,
                             out.data_ptr(), count, POWERS_CHUNK, _stream(out))
    cuda_lib.check(rc, "field_powers")
    return out, 1


def batch_inv_kernel(lib, f, a: torch.Tensor, host_inv) -> tuple[torch.Tensor, int]:
    """``batch_inv`` through `lib`: (result, launches)."""
    spec, L = f.spec, f.num_limbs
    flat = a.reshape(-1, L)
    if flat.data_ptr() % 16 or not flat.is_contiguous():
        flat = flat.clone(memory_format=torch.contiguous_format)
    n = flat.shape[0]
    if n == 0:
        raise IndexError("batch_inv of no elements")
    prefix, suffix = torch.empty_like(flat), torch.empty_like(flat)
    k = _pass(lib, spec, OP_MUL, _MODE_SCAN, (flat, 1, 0), n, 1, _FORWARD | _REVERSE, prefix, suffix, 1, 0)
    total = spec.from_mont(_limbs_to_int(prefix[n - 1].cpu()))  # the one copy to the host
    inv = _host_limbs([spec.to_mont(host_inv(total) % spec.modulus)], L)
    one = _identity(spec, OP_MUL)
    p, pinv = cuda_lib.field_consts(spec)
    out = torch.empty_like(flat)
    rc = lib.zk_field_batch_inv(flat.device.index or 0, L, p, pinv, one.ctypes.data, inv.ctypes.data,
                                prefix.data_ptr(), suffix.data_ptr(), out.data_ptr(), n, _stream(out))
    cuda_lib.check(rc, "field_batch_inv")
    return out.reshape(a.shape), k + 1


def addsub_kernel(lib, f, a: torch.Tensor, b: torch.Tensor, op: int) -> tuple[torch.Tensor, int]:
    """``add`` (op 0) or ``sub`` (op 1) through `lib`: (result, launches)."""
    L = f.num_limbs
    sa, sb = tuple(a.shape[:-1]), tuple(b.shape[:-1])
    shape = sa if sa == sb else cuda_lib.broadcast_shapes(sa, sb)
    n = 1
    for s in shape:
        n *= s
    a, na = _aligned(*_broadcast_operand(a, shape))
    b, nb = _aligned(*_broadcast_operand(b, shape))
    out = torch.empty(shape + (L,), dtype=torch.int32, device=a.device)
    if n == 0:
        return out, 0
    p, pinv = cuda_lib.field_consts(f.spec)
    rc = lib.zk_field_addsub(a.device.index or 0, L, p, pinv, op, a.data_ptr(), na or n,
                             b.data_ptr(), nb or n, out.data_ptr(), n, _stream(out))
    cuda_lib.check(rc, "field_addsub")
    return out, 1


def _aligned(t: torch.Tensor, rows):
    """A contiguous operand on a 16-byte boundary (the kernels' 16-byte loads)."""
    return (t.clone() if t.data_ptr() % 16 else t), rows


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _checked(name: str, f, *ts) -> None:
    cuda_lib.check_cuda_operands(name, ts, f.num_limbs, contiguous=False)


def scan(f, a: torch.Tensor, op: int, axis: int = 0, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan along `axis` by the product (OP_MUL) or add (OP_ADD)."""
    if _on_cpu(a):
        return scan_plain(f, a, op, axis, reverse)
    _checked("field_scan", f, a)
    out, k = scan_kernel(cuda_lib.load(), f, a, op, axis, reverse)
    launches["field_scan"][f.spec.name] += k
    return out


def field_sum(f, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Field sum along `axis`."""
    if _on_cpu(a):
        return sum_plain(f, a, axis)
    _checked("field_sum", f, a)
    out, k = sum_kernel(cuda_lib.load(), f, a, axis)
    launches["field_scan"][f.spec.name] += k
    return out


def powers(f, base: int, count: int) -> torch.Tensor:
    """[1, z, ..., z^(count-1)] as (count, L) Montgomery limbs on f's device."""
    if f.device.type == "cpu":
        return powers_plain(f, base, count)
    out, k = powers_kernel(cuda_lib.load(), f, base, count)
    launches["field_scan"][f.spec.name] += k
    return out


def batch_inv(f, a: torch.Tensor, host_inv) -> torch.Tensor:
    """Montgomery-trick batch inversion over the leading axes (every element
    nonzero); `host_inv` (int -> int) inverts the total product."""
    if _on_cpu(a):
        return batch_inv_plain(f, a, host_inv)
    _checked("field_batch_inv", f, a)
    out, k = batch_inv_kernel(cuda_lib.load(), f, a, host_inv)
    launches["field_scan"][f.spec.name] += k
    return out


def add(f, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _on_cpu(a, b):
        return add_plain(f, a, b)
    _checked("field_add", f, a, b)
    out, k = addsub_kernel(cuda_lib.load(), f, a, b, _ADD)
    launches["field_addsub"][f.spec.name] += k
    return out


def sub(f, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _on_cpu(a, b):
        return sub_plain(f, a, b)
    _checked("field_sub", f, a, b)
    out, k = addsub_kernel(cuda_lib.load(), f, a, b, _SUB)
    launches["field_addsub"][f.spec.name] += k
    return out


def kernel_attrs(kind: str) -> dict:
    """Registers per thread, local-memory bytes (spills) and static shared
    memory per block, the largest over the widths: kind "field_scan" (the
    scan, powers and batch_inv kernels) or "field_addsub"."""
    out = (ctypes.c_int * 3)()
    cuda_lib.check(cuda_lib.load().zk_field_ops_attrs({"field_scan": 0, "field_addsub": 1}[kind], out),
                   f"{kind} attributes")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2]}
