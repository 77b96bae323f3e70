"""Build, load and launch the CUDA C++ kernels under ``repro_torch/csrc``.

Each ``csrc/<kernel>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds). Libraries go to ``repro_torch/_build/
<hash>/``, keyed by a hash of every source and the compiler flags, and are
built at first use: importing this module needs neither ``nvcc`` nor a card.
A missing or failing ``nvcc`` raises with the compiler's output; nothing
falls back to the plain versions.

Every C entry point takes device pointers, sizes and the CUDA stream, and
returns ``cudaGetLastError()`` right after its launch; :func:`launch`
raises if that is not 0 and counts the launch in :data:`LAUNCHES` and, by
shape, in :data:`LAUNCH_SHAPES`.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable

import torch

__all__ = ["KERNELS", "ARGTYPES", "LAUNCHES", "LAUNCH_SHAPES", "reset_launches", "source_hash",
           "build", "load", "launch", "find_nvcc"]

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_ROOT = PACKAGE / "_build"

KERNELS = ("gram", "hat_apply", "foldsolve", "fold_eval", "pairdist", "flash_attention",
           "permdraw")

#: ``-fno-gnu-unique``: a function-local static of a header's inline or
#: template function (a launcher's once-per-device shared-memory opt-in
#: flag) stays one per library. As a GNU unique symbol the loader would
#: bind it once per process, and a second library launching the same
#: header's kernel would skip its own opt-in (libgram and libpairdist both
#: launch the tensor-core Gram pass).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC,-fno-gnu-unique", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float

#: C signature of every entry point, by kernel: pointers and the stream
#: (last) are ``c_void_p`` so ctypes never truncates them to 32 bits; a
#: random key's words are ``c_uint32``, and so stay out of the launch's shape.
ARGTYPES = {
    # (x, ws, g, n, p, splits, stream)
    "gram": {f"gram_{t}": (_P, _P, _P, _I, _I, _I, _P) for t in ("f32", "f64", "bf16")},
    # (h, y, ws, e, n, b, splits, stream)
    "hat_apply": {f"hat_apply_{t}": (_P, _P, _P, _P, _I, _I, _I, _P) for t in ("f32", "f64")},
    # (h_te, e, out, bad, scratch, k, m, b, bb, stream)
    "foldsolve": {f"foldsolve_{t}": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
                  for t in ("f32", "f64")},
    # (h_rows, h_te, y, y_te, t, e, bad, scratch, k, m, n, b, bb, stream)
    "fold_eval": {f"fold_eval_{t}": (_P,) * 8 + (_I,) * 5 + (_P,) for t in ("f32", "f64")},
    # (u, ws, d, c, p, route, parts, stream)
    "pairdist": {f"pairdist_{t}": (_P, _P, _P, _I, _I, _I, _I, _P) for t in ("f32", "f64", "bf16")},
    # (q, k, v, o, b, hq, hkv, s, d, 12 strides, scale, softcap, causal, window, stream)
    "flash_attention": {f"flash_attention_{t}": (_P,) * 4 + (_I,) * 17 + (_F, _F, _I, _I, _P)
                        for t in ("f32", "bf16")},
    # (out, k0, k1, t, n, stream)
    "permdraw": {"permdraw": (_P, _U, _U, _I, _I, _P)},
}

#: Kernel launches per kernel since the last :func:`reset_launches`.
LAUNCHES = {name: 0 for name in KERNELS}
#: The same launches by shape: ``(kernel, the entry point's int arguments)``,
#: e.g. ``("hat_apply", (n, b, splits))`` or ``("permdraw", (t, n))``.
LAUNCH_SHAPES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_SHAPES.clear()


def source_hash() -> str:
    """Digest of every ``csrc`` source and the flags: the build's cache key."""
    h = hashlib.blake2b(digest_size=8)
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else ``PATH``."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH): "
                           "the CUDA kernels cannot be built")
    return found


def build(names: Iterable[str] = KERNELS) -> dict:
    """Compile the named kernels that are not built yet, all at once.

    One ``nvcc`` process per source, started together. Returns
    ``{name: path}``; ``ptxas`` register and shared-memory reports land
    beside each library as ``lib<name>.log``. Raises with ``nvcc``'s
    output if any build fails.
    """
    out_dir = BUILD_ROOT / source_hash()
    paths = {n: out_dir / f"lib{n}.so" for n in names}
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    procs = {}
    for name, path in todo.items():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        path = todo[name]
        path.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, path)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for symbol, argtypes in ARGTYPES[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launch(kernel: str, symbol: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device``'s current stream; count it; raise
    on error. ``args`` are the entry point's arguments before the stream:
    tensors pass their data pointer, ``None`` a null pointer. The entry point
    runs on the current device; another device is made current around it."""
    lib = _libs.get(kernel) or load(kernel)
    fn = getattr(lib, symbol)
    shape = tuple(a for a, t in zip(args, fn.argtypes) if t is _I)
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    # the raw handle of the device's current stream, without building a
    # torch.cuda.Stream object on every launch
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA launch failed with error {err} ({msg})")
    LAUNCHES[kernel] += 1
    LAUNCH_SHAPES[kernel, shape] += 1
