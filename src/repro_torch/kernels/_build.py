"""Build and bind the hand-written CUDA kernels in ``repro_torch/csrc``.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, bound with ``ctypes``.  The build happens at
the first launch (never at import, so modules import on a machine
without ``nvcc``), one ``nvcc`` process per source, all started
together, then one link.  The library lands in ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``), named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises when that is not 0.
``ptxas_report`` and ``sass_counts`` read back what was compiled:
registers and spills per kernel, and instructions of one opcode in each
kernel's machine code (``cuobjdump -sass``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("errors.cu", "rmsnorm.cu", "flash_fwd.cu", "flash_bwd.cu",
           "paged_decode.cu", "ssd_chunk.cu", "overlap.cu", "rglru_scan.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
_fns: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build with the CUDA toolkit's nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: Sequence[Sequence[str]]) -> str:
    """Run the commands in parallel and return their joined output, or
    raise with the output of those that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, p in zip(cmds, procs):
        log, _ = p.communicate()
        if p.returncode:
            failed.append(f"$ {' '.join(cmd)}\n{log}")
        logs.append(log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


def build() -> Path:
    """Compile the sources (if this digest is not built yet) and return
    the library's path.  The compiler's report of registers, spills and
    shared memory per kernel (``-Xptxas -v``) is written beside the
    library, with the suffix ``.ptxas.txt``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"librepro_kernels-{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        report = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                            str(CSRC / s), "-o", o]
                           for s, o in zip(SOURCES, objs)])
        part = os.path.join(tmp, lib.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", part]])
        part_report = os.path.join(tmp, "ptxas.txt")
        Path(part_report).write_text(report)
        # atomic renames, the library last: a concurrent build is safe
        os.replace(part_report, lib.with_suffix(".ptxas.txt"))
        os.replace(part, lib)
    return lib


def ptxas_report(lib: Path) -> Dict[str, dict]:
    """Registers and spill bytes of every kernel in the build of ``lib``,
    by mangled name, from the ptxas report written beside it."""
    out: Dict[str, dict] = {}
    name = None
    for ln in lib.with_suffix(".ptxas.txt").read_text().splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return {n: r for n, r in out.items() if "registers" in r}


def cuobjdump() -> Optional[str]:
    """The CUDA toolkit's ``cuobjdump``, or None where there is none."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    try:
        beside = Path(_nvcc()).parent / "cuobjdump"
    except RuntimeError:
        return None
    return str(beside) if beside.exists() else None


def sass_counts(lib: Path, opcode: str) -> Dict[str, int]:
    """Instructions whose opcode starts with ``opcode`` (``HMMA`` for the
    tensor cores' mma.sync) in each kernel of ``lib``, by mangled name,
    from ``cuobjdump -sass``."""
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found")
    text = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out: Dict[str, int] = {}
    name = None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = 0
        elif name and re.search(r"\*/\s+(?:@!?\w+\s+)?" + re.escape(opcode)
                                + r"\b", ln):
            out[name] += 1
    return out


def load() -> ctypes.CDLL:
    """Build if needed and load the library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
            _lib.rt_error_string.argtypes = [ctypes.c_int]
            _lib.rt_error_string.restype = ctypes.c_char_p
        return _lib


def function(name: str, argtypes: Sequence[object]):
    """The C entry point ``name`` with its argument types declared."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(err: int, name: str) -> None:
    if err:
        msg = load().rt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


# --------------------------------------------------------------------- #
# argument checks shared by the wrappers
# --------------------------------------------------------------------- #

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(name: str, *tensors) -> int:
    """The kernels' dtype code (0 float32, 1 bfloat16) of tensors that
    must all share one dtype on one CUDA device."""
    t0 = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != t0.device:
            raise ValueError(f"{name}: every tensor must lie on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if t.dtype != t0.dtype:
            raise TypeError(f"{name}: mixed dtypes "
                            f"{[x.dtype for x in tensors]}")
    code = _DTYPE_CODES.get(t0.dtype)
    if code is None:
        raise TypeError(f"{name}: takes float32 or bfloat16, got "
                        f"{t0.dtype}")
    return code


def rows_aligned(t) -> bool:
    """Whether the kernels can read ``t`` as it is: rows of the last dim
    are read with 16-byte vectors, so the last dim must be contiguous
    and every row start 16-byte aligned (the stride of a dim of size 1
    is never used)."""
    es = t.element_size()
    strides = [s for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any((s * es) % 16 for s in strides)
            and (t.shape[-1] * es) % 16 == 0)


def check_rows(name: str, t) -> None:
    """Raise unless ``rows_aligned(t)``."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dim must be contiguous, strides "
                         f"{t.stride()}")
    if not rows_aligned(t):
        raise ValueError(f"{name}: rows must be 16-byte aligned (shape "
                         f"{tuple(t.shape)}, strides {t.stride()})")


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# the launch tallies of the CUDA graph captures under way, by the handle
# of the stream each captures
_tallies: Dict[int, Dict[tuple, int]] = {}


def count(namespace: dict, attr: str, t) -> None:
    """Count one launch of a wrapper's kernel, made on ``t``'s current
    stream: into the wrapper module's counter ``attr`` (``namespace`` is
    the module's ``globals()``), or, when that stream is being captured,
    into the capture's tally and not the counter, since a capture runs
    nothing.  A launch lands where its stream says, whichever thread
    makes it: a capture's backward runs on autograd's thread, and
    another thread may be launching meanwhile."""
    if _tallies:
        tally = _tallies.get(stream_of(t))
        if tally is not None:
            key = (namespace["__name__"], attr)
            tally[key] = tally.get(key, 0) + 1
            return
    namespace[attr] += 1


class capture_tally:
    """``with capture_tally(stream) as tally``: the launches made on the
    stream whose handle is ``stream`` go to ``tally``, a dict keyed by
    (module name, counter name), until the block ends."""

    def __init__(self, stream: int):
        self.stream = stream
        self.tally: Dict[tuple, int] = {}

    def __enter__(self) -> Dict[tuple, int]:
        if self.stream in _tallies:
            raise RuntimeError(f"stream {self.stream:#x} is already "
                               f"counted for a capture")
        _tallies[self.stream] = self.tally
        return self.tally

    def __exit__(self, *exc) -> None:
        del _tallies[self.stream]


_counters: Dict[tuple, torch.Tensor] = {}


def counters(kernel: str, device, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters on ``device`` for the kernel named
    ``kernel``, zero before its first launch.  The kernels whose last
    block to finish merges the others' partials count finished blocks
    here and leave every counter at 0 when they end, so the buffer is
    made (and zeroed) once and no launch needs a memset.  A CUDA graph
    reads the buffer it was captured with, so the buffer must exist
    before the capture: the engines' first step runs eagerly."""
    key = (kernel, torch.device(device))
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{kernel}: its counters would be made during a CUDA graph "
                f"capture; launch it once before capturing")
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf
