"""Spans around calls into the program, taken from the benchmark's side.

CommitSpans: while installed, every outermost call of KzgScheme.commit_coeffs
and KzgScheme.commit_many (the entries that every commitment and opening
witness of a PLONK proof and of a KZG opening goes through) records the
points N, the vectors K, its host seconds and, on a CUDA device, its device
seconds between two CUDA events.  The calls return host points, so the host
clock ends after the device work.

Labels: while installed, the PLONK rounds' steps and the host work around
the commitments run inside torch.profiler ranges named "zkbench.<step>", so
that a trace names what the host did in the device's idle gaps.

Nothing in the program is edited: the functions are wrapped where they are
looked up (a module or a class) and restored by uninstall().  A name the
program no longer has is skipped.
"""
from __future__ import annotations

import functools
import importlib
import time

import torch

LABELLED = (  # (module, class or None, functions)
    ("zktpu_torch.plonk.prover", None, ("compute_acc", "compute_quotient_polynomial",
                                        "compute_linearisation_polynomial", "evaluate_many", "fp_rand")),
    ("zktpu_torch.plonk.slice_polynomial", "SlicePoly", ("compact",)),
    ("zktpu_torch.kzg.scheme", "KzgScheme", ("commit_para", "open")),
    ("zktpu_torch.poly.poly", "Poly", ("evaluate", "divide_by_linear")),
    ("zktpu_torch.transcript.transcripts", "PlonkChallengeGenerator", ("feed", "generate_challenges")),
    ("zktpu_torch.curves.g1", None, ("proj_to_affine_host",)),
)


class Labels:
    def __init__(self):
        self._saved = []

    def install(self) -> "Labels":
        from torch.profiler import record_function

        for mod_name, cls_name, names in LABELLED:
            owner = importlib.import_module(mod_name)
            if cls_name is not None:
                owner = getattr(owner, cls_name, None)
            for name in names:
                fn = getattr(owner, name, None) if owner is not None else None
                if fn is None:
                    continue
                label = f"zkbench.{name}"

                def wrapped(*a, _fn=fn, _label=label, **k):
                    with record_function(_label):
                        return _fn(*a, **k)

                self._saved.append((owner, name, owner.__dict__.get(name)))
                setattr(owner, name, functools.wraps(fn)(wrapped))
        return self

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._saved):
            if orig is None:
                delattr(owner, name)
            else:
                setattr(owner, name, orig)
        self._saved = []


class CommitSpans:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.spans: list[dict] = []
        self._depth = 0
        self._saved = {}

    def install(self) -> "CommitSpans":
        from zktpu_torch.kzg.scheme import KzgScheme

        def size_one(self_, coeffs):
            return int(coeffs.shape[0]), 1

        def size_many(self_, polys):
            return max((len(p) for p in polys), default=0), len(polys)

        for name, size in (("commit_coeffs", size_one), ("commit_many", size_many)):
            fn = getattr(KzgScheme, name)
            self._saved[name] = fn
            setattr(KzgScheme, name, self._wrap(fn, size))
        return self

    def uninstall(self) -> None:
        from zktpu_torch.kzg.scheme import KzgScheme

        for name, fn in self._saved.items():
            setattr(KzgScheme, name, fn)
        self._saved = {}

    def _wrap(self, fn, size):
        spans = self

        @functools.wraps(fn)
        def wrapped(self_, arg):
            if spans._depth:
                return fn(self_, arg)
            n, k = size(self_, arg)
            ev = None
            if spans.cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t0 = time.perf_counter()
            spans._depth += 1
            try:
                with torch.profiler.record_function("zkbench.commit"):
                    out = fn(self_, arg)
            finally:
                spans._depth -= 1
            if ev is not None:
                ev[1].record()
            spans.spans.append({"n": n, "k": k, "host_s": time.perf_counter() - t0, "events": ev})
            return out

        return wrapped

    def finish(self) -> list[dict]:
        """The spans with their device seconds (None off a CUDA device)."""
        if self.cuda:
            torch.cuda.synchronize()
        for s in self.spans:
            ev = s.pop("events")
            s["device_s"] = ev[0].elapsed_time(ev[1]) / 1e3 if ev is not None else None
        return self.spans
