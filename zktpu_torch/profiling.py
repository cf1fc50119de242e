"""Tracing and debug-validation hooks (counterpart of zktpu/profiling.py).

* ``maybe_trace(name)``: a context manager.  When ``ZKTPU_PROFILE`` is set
  (a directory, or ``1`` for ``./zktpu_traces``), it runs the block under
  ``torch.profiler.profile`` (CPU activity, and CUDA activity when a card is
  present) inside ``record_function(name)`` and writes a Chrome trace,
  ``<name>-<pid>-<time ns>.json``, under ``profile_dir()``.  Without the
  variable it does nothing.

* ``ZKTPU_DEBUG=1``: sanitizer mode.  ``TorchField.decode_ints`` checks that
  the words it decodes are 32-bit limbs of Montgomery values below p before
  ``from_mont``, and ``g1.proj_to_affine_host`` that the points it returns
  are on the curve; both raise ``AssertionError`` with the place and value.
  Each check costs one host pass, only when the variable is on.
"""
from __future__ import annotations

import contextlib
import os
import time


def profile_dir() -> str | None:
    v = os.environ.get("ZKTPU_PROFILE")
    if not v:
        return None
    return "./zktpu_traces" if v == "1" else v


@contextlib.contextmanager
def maybe_trace(name: str):
    """torch.profiler around the block iff ZKTPU_PROFILE is set."""
    d = profile_dir()
    if d is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(d, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(d, f"{name}-{os.getpid()}-{time.time_ns()}.json"))


def debug_enabled() -> bool:
    return os.environ.get("ZKTPU_DEBUG", "0") not in ("", "0", "false", "off")


def check_canonical(field, values, where: str = "") -> None:
    """Assert host ints are canonical field elements (0 <= v < p)."""
    if not debug_enabled():
        return
    p = field.modulus
    for i, v in enumerate(values):
        assert 0 <= v < p, (
            f"ZKTPU_DEBUG: non-canonical field element at {where}[{i}]: "
            f"{hex(v)} not in [0, {hex(p)})"
        )


def check_on_curve(points, where: str = "") -> None:
    """Assert host affine points satisfy y^2 = x^3 + 4 (or are identity)."""
    if not debug_enabled():
        return
    for i, pt in enumerate(points):
        assert pt.is_on_curve(), (
            f"ZKTPU_DEBUG: off-curve point at {where}[{i}]: "
            f"x={hex(pt.x)} y={hex(pt.y)}"
        )
