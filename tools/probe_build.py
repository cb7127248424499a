"""Build a variant of the port's kernel sources for the probes
(``tools/flash_probe.py``, ``tools/tc_probe.py``).

    fns, ptxas = build_variant(dest, src_dir, edits, stems)

copies ``src_dir`` (``paddle_tpu_torch/csrc`` or another copy of it) to
``dest``, applies the text edits ``[(file, old text, new text)]`` (every
occurrence; a missing text stops the probe), compiles each ``<stem>.cu``
with the port's ``nvcc`` flags and ``-Xptxas -v``, one process a source,
all at once, and loads the libraries with ctypes.  Returns the entry
points of those stems that the variant defines (``{symbol: ctypes
function}``, typed from ``_build.SIGNATURES``) and what ptxas said for
each stem.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess


def build_variant(dest, src_dir, edits, stems):
    from paddle_tpu_torch.ops import _build
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(src_dir, dest)
    for fname, old, new in edits:
        path = os.path.join(dest, fname)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise SystemExit(f"{dest}: edit text not found in {fname}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    procs = {stem: subprocess.Popen(
        [_build._nvcc()] + _build.NVCC_FLAGS
        + ["-Xptxas", "-v", "-o", os.path.join(dest, f"{stem}.so"),
           os.path.join(dest, f"{stem}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for stem in stems}
    fns, ptxas = {}, {}
    for stem, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {dest}/{stem}.cu:\n{text}")
        ptxas[stem] = text
        lib = ctypes.CDLL(os.path.join(dest, f"{stem}.so"))
        for sym, (lib_stem, argtypes) in _build.SIGNATURES.items():
            if lib_stem == stem and hasattr(lib, sym):  # older sources
                fn = getattr(lib, sym)                  # lack newer ones
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                fns[sym] = fn
    return fns, ptxas
