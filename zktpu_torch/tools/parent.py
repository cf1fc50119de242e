"""Load another checkout's zktpu_torch beside this one, to time its kernels.

    parent = load_parent("build/parent")  # a `git archive` of another commit, unpacked
    parent.curves.g1_kernel.fixed_base_mul(tables, scalars, 8)

The package under DIR/zktpu_torch is imported under the name
``zktpu_torch_parent`` (its modules import each other relatively), so both
versions live in one process: each builds its own kernel library from its own
csrc/ into DIR/build/zktpu_torch/ on first use, keeps its own launch
counters, and its wrappers launch its own kernels with its own host logic.
Tensors and field objects of either package go to the other's functions (the
same layouts and attributes).  Measurement only: the port never imports it.
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import sys
import types

NAME = "zktpu_torch_parent"


def load_parent(path: str) -> types.ModuleType:
    """The package at `path`/zktpu_torch as ``zktpu_torch_parent``, with
    the submodules the tools use imported (fields, curves, kzg, poly)."""
    pkg_dir = os.path.join(os.path.abspath(path), "zktpu_torch")
    if not os.path.isfile(os.path.join(pkg_dir, "__init__.py")):
        raise FileNotFoundError(f"no zktpu_torch package under {path}")
    if NAME in sys.modules:
        if os.path.dirname(sys.modules[NAME].__file__) != pkg_dir:
            raise RuntimeError(f"{NAME} is already loaded from {sys.modules[NAME].__file__}")
        return sys.modules[NAME]
    spec = importlib.util.spec_from_file_location(NAME, os.path.join(pkg_dir, "__init__.py"),
                                                  submodule_search_locations=[pkg_dir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[NAME] = pkg
    spec.loader.exec_module(pkg)
    for sub in ("cuda_lib", "fields.fp", "fields.field_kernel", "curves.g1", "curves.g1_kernel", "kzg",
                "poly.ntt_kernel"):
        importlib.import_module(f"{NAME}.{sub}")
    return pkg
