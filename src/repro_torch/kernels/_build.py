"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded through ``ctypes``.  The build happens at
first use, into ``build/repro_torch/`` at the repository root, and each
library's file name carries a hash of its source, the headers beside it
and the flags, so an edited source or header rebuilds and an unchanged one
loads at once.  :func:`build` compiles several sources in parallel, one
``nvcc`` each.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("map_indices", "purity_scan", "iblt_apply", "iblt_encode")
# IEEE-rounded fp32 everywhere: no --use_fast_math, no FMA contraction
# (the mapping chain must stay bit-identical with the host chain).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U64 = ctypes.c_uint64
# C signature of each library's launch function: (symbol, argtypes).
SIGNATURES = {
    "map_indices": ("map_indices_launch",
                    [_P, _LL, _I, _I, _I, _LL, _U64, _U64, _U64, _U64,
                     _P, _P, _I, _I, _LL, _P, _P]),
    "purity_scan": ("purity_scan_launch",
                    [_P, _P, _P, _LL, _I, _I, _U64, _U64, _P, _P]),
    "iblt_apply": ("iblt_apply_launch",
                   [_P, _P, _P, _P, _LL, _I, _I, _P, _P, _LL, _P, _P, _P,
                    _P, _P]),
    "iblt_encode": ("iblt_encode_launch",
                    [_P, _P, _P, _LL, _I, _I, _LL, _P, _P, _P, _P]),
}

_loaded: dict[str, object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for these sources.

    The hash covers the flags, the source and every header under ``csrc/``
    (any of them may be included), so an edited header rebuilds too.
    """
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every missing library of ``names``, all ``nvcc`` processes
    at once.  Returns the wall seconds per source built (0.0 if cached).
    The ptxas report (registers, spills) lands beside each library as
    ``.log``.  Raises ``RuntimeError`` with the compiler output on failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, seconds = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)     # atomic: concurrent builds cannot clash
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def launcher(name: str):
    """The ctypes launch function of ``csrc/<name>.cu``, built on first use.

    Every launch function takes device pointers and the CUDA stream as
    ``void*`` and returns the ``cudaError_t`` of its launch.
    """
    fn = _loaded.get(name)
    if fn is None:
        build((name,))
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def device_ptr(t, name: str, dtype, ndim: int) -> int:
    """Validate a kernel argument and return its device pointer.

    The kernels take contiguous CUDA tensors of one dtype; anything else is
    refused here, before a pointer reaches native code.
    """
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")
    return t.data_ptr()


def stream_of(t) -> int:
    """The handle of torch's current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


# The wrappers whose launches a CUDA graph being captured by
# :class:`CountedGraph` records, in order; None while none is captured.
_captured: list | None = None
_capture_streams: dict = {}


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel in ``wrapper.launches``.

    A launch made while :class:`CountedGraph` captures is recorded into the
    graph and runs only when the graph is replayed, so it is noted there
    and counted at each replay instead.
    """
    if _captured is None:
        wrapper.launches += 1
    else:
        _captured.append(wrapper)


class CountedGraph:
    """``fn()`` captured once as a CUDA graph on ``device``.

    :meth:`replay` launches the whole graph on the current stream with one
    call from the host, and adds each kernel launch the graph holds to its
    wrapper's ``.launches``.  ``out`` is what ``fn`` returned: tensors in
    the graph's own memory, rewritten by every replay.  The capture runs on
    a side stream, without ``torch.cuda.graph``'s synchronise, garbage
    collection and cache flush, so it waits for nothing on the card.
    ``pool`` is a memory pool shared with other graphs
    (``torch.cuda.graph_pool_handle()``), or None for a pool of its own.
    """

    def __init__(self, fn, device: torch.device, pool=None):
        global _captured
        side = _capture_streams.get(device.index)
        if side is None:
            side = _capture_streams[device.index] = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        _captured = []
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool)
                try:
                    self.out = fn()
                finally:
                    graph.capture_end()
            self.kernels = tuple(_captured)
        finally:
            _captured = None
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        for wrapper in self.kernels:
            wrapper.launches += 1
