"""Build the package's CUDA kernels into one shared library, load it with ctypes.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a``; the objects are linked into one shared
library with a plain C interface.  The library lands in ``_build/`` next
to this file under a name keyed by the hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads at once.  Nothing is
built when the module is imported: the first kernel launch calls
:func:`library`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures of the exported entry points (every pointer and the stream
#: as c_void_p, or ctypes would cut them to 32-bit ints)
SIGNATURES = {
    "paged_attention_chunk": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    "paged_attention_tile": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    "paged_attention_split": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                              _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, ctypes.c_float, _P],
    "era_scan_interval": [_P, _P, _P, _P, _P, _I, _I, _P],
    "era_scan_round_trip": [_P, _P, _P, _P, _I, _I, _P],
    "flash_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        ctypes.c_float, _P],
    "flash_attention_tile": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             ctypes.c_float, _P],
    "flash_attention_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                            _P],
    "flash_attention_bwd_tile": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I,
                                 ctypes.c_float, _P],
}


class Counter:
    """Launch count of one kernel: an integer ``n``, bumped by its wrapper
    once per launch (``bump``) and nowhere else.  ``bump`` takes a lock:
    serving workers launch from several threads, and a bare ``+=`` there
    can lose an update.  Inside a CUDA-graph capture (``capturing``: one
    open on the calling thread, or on the CUDA stream it launches on)
    nothing is launched, so a bump goes to the capture's tally instead,
    and each replay of the graph adds it."""

    __slots__ = ("n", "_lock")

    def __init__(self) -> None:
        self.n = 0
        self._lock = threading.Lock()

    def bump(self) -> None:
        tally = _open_tally()
        if tally is not None:
            tally.counts[self] = tally.counts.get(self, 0) + 1
        else:
            self.add(1)

    def add(self, k: int) -> None:
        with self._lock:
            self.n += k


class Tally:
    """What one CUDA-graph capture launched: the bumps of each counter
    (``counts``) and the callbacks deferred with ``at_replay`` (``calls``).
    ``replay`` applies them once; the engine calls it at each replay of the
    graph, so the counters read what the card ran."""

    __slots__ = ("counts", "calls")

    def __init__(self) -> None:
        self.counts: dict = {}
        self.calls: list = []

    def replay(self) -> None:
        for counter, k in self.counts.items():
            counter.add(k)
        for fn in self.calls:
            fn()


_capture = threading.local()
#: the tallies of the captures open on a CUDA stream, by the stream's handle
#: (``capturing(stream)``)
_stream_tallies: dict = {}
_stream_lock = threading.Lock()


def _stream_key():
    """The handle of the calling thread's current CUDA stream while that
    stream is capturing, else None."""
    import torch

    if not torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_stream().cuda_stream


def _open_tally() -> Optional["Tally"]:
    """The tally a launch made now belongs to: the capture open on this
    thread, else the one open on the stream this thread launches on (a
    thread that did not open it, as autograd's device thread runs the
    backward of a captured forward on the forward's stream), else None."""
    tally = getattr(_capture, "tally", None)
    if tally is None and _stream_tallies:
        key = _stream_key()
        if key is not None:
            tally = _stream_tallies.get(key)
    return tally


@contextlib.contextmanager
def capturing(stream=None):
    """Tally, rather than count, the launches made inside the block (a
    CUDA-graph capture, which launches nothing); yields the ``Tally``.
    The launches of this thread go to it, and, with ``stream`` (the CUDA
    stream being captured), those of any thread launching on that stream
    while it captures.  Other threads keep counting."""
    outer = getattr(_capture, "tally", None)
    tally = _capture.tally = Tally()
    key = None if stream is None else stream.cuda_stream
    if key is not None:
        with _stream_lock:
            outer_on_stream = _stream_tallies.get(key)
            _stream_tallies[key] = tally
    try:
        yield tally
    finally:
        _capture.tally = outer
        if key is not None:
            with _stream_lock:
                if outer_on_stream is None:
                    del _stream_tallies[key]
                else:
                    _stream_tallies[key] = outer_on_stream


def at_replay(fn) -> None:
    """Call ``fn()`` now, or, inside a capture (``capturing``), at each
    replay of the graph being captured (an observer of launches keeps its
    records per launch this way)."""
    tally = _open_tally()
    if tally is None:
        fn()
    else:
        tally.calls.append(fn)


def launched(counter: Counter) -> int:
    """``counter.n`` plus what the capture open for this thread
    (``capturing``) has tallied of it: the launches asked for so far."""
    tally = _open_tally()
    return counter.n + (0 if tally is None else tally.counts.get(counter, 0))


#: how many ``eager_steps()`` blocks are open, in any thread
_eager_depth = [0]
_eager_lock = threading.Lock()


@contextlib.contextmanager
def eager_steps():
    """Every compiled step (the serving engine's, the trainer's) runs
    eagerly on the card inside the block, capturing and replaying no
    graph: the plain version of the compiled steps, as
    ``jax.disable_jit()`` is the reference's.  For the card's checks that
    hold graphs against it; process-wide, so it covers worker threads."""
    with _eager_lock:
        _eager_depth[0] += 1
    try:
        yield
    finally:
        with _eager_lock:
            _eager_depth[0] -= 1


def eager() -> bool:
    """Whether an ``eager_steps()`` block is open."""
    return _eager_depth[0] > 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel and link; returns the library path."""
    out = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if verbose and log:
                print(log, end="")
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
        os.replace(tmp_lib, out)  # atomic: a concurrent build sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
