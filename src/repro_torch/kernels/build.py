"""Build the hand-written CUDA kernels and bind them with ``ctypes``.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Libraries land in ``build/kernels/`` at the repository root,
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source rebuilds and an unchanged one is loaded as it is.
The compiler's log (``-Xptxas=-v``: registers, spills per kernel) is kept
beside each library and read by ``ptxas_report``.  Nothing is built when a module is
imported: the first launch of a kernel builds its library, and
``build_all`` builds every source at once with one ``nvcc`` process each.

Fake launches: a wrapper handed FakeTensors (``torch._subclasses``' fake
tensors: shapes, dtypes and devices without storage, what a dry run
traces) allocates what its kernel allocates, launches nothing, counts no
launch, and reports the kernel's work through ``record_work`` to whoever
``observe_work`` installed (``launch/hlo_analysis.py``; while one is
installed, a real launch reports its work as well).  The branch is
taken on fakeness (``is_fake``), before the device check, so a fake CPU
tensor never runs a kernel's plain version and a real tensor never takes
it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SMEM_LIMIT = 232448     # dynamic shared memory a block may use on an H100
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: source stem -> C functions it exports, with their ctypes signatures
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES: Dict[str, Dict[str, List]] = {
    "sim_topk": {
        "reuse_top1_launch": [*[_P] * 6, *[_I] * 10, _P],
        "gather_top1_launch": [*[_P] * 6, *[_I] * 10, _P],
        "sim_top1_launch": [*[_P] * 5, *[_I] * 8, _P],
    },
    "reuse_probed": {
        "reuse_probed_launch": [*[_P] * 8, *[_I] * 8, _P],
    },
    "lsh_hash": {
        "lsh_hash_mix_launch": [_P, _P, _P, *[_I] * 8, _P],
        "lsh_hash_launch": [_P, _P, _P, *[_I] * 7, _P],
    },
    "flash_attention": {
        "flash_attention_launch": [*[_P] * 5, *[_I] * 6, *[_L] * 9, _I, _I, _I, _F, _F,
                                   *[_I] * 10, _P],
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_delta_launch": [_P, _P, _P, *[_I] * 5, _P],
        "flash_attention_bwd_dkdv_launch": [*[_P] * 8, *[_I] * 9, _F, _F, *[_I] * 11, _P],
        "flash_attention_bwd_dq_launch": [*[_P] * 7, *[_I] * 9, _F, _F, *[_I] * 11, _P],
    },
    "decode_attention": {
        "decode_attention_launch": [*[_P] * 10, *[_I] * 5, *[_L] * 8, *[_I] * 5, _F, _F,
                                    _I, _I, _P],
    },
    "norm_rope": {
        "rms_norm_launch": [*[_P] * 5, _L, *[_I] * 4, _F, _P],
        "qk_rope_launch": [*[_P] * 3, _L, _L, *[_P] * 5, _L, *[_I] * 6, _F, _P],
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Named by a hash of the source, the shared headers and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start one nvcc build (None when the library is already built)."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def ptxas_report(name: str) -> List[Dict]:
    """Per kernel of a built library, from its ``-Xptxas=-v`` log: the
    mangled entry name, registers, static shared memory and spill bytes."""
    log = library_path(name).with_suffix(".log")
    rows: List[Dict] = []
    entry = None
    for line in log.read_text().splitlines() if log.exists() else []:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = {"entry": m.group(1), "registers": None, "smem": 0, "spill_stores": None,
                     "spill_loads": None}
            rows.append(entry)
        elif entry is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                # torch-lint: waive=T002(ptxas's text log, read once a build: no tensor)
                entry["spill_stores"], entry["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = int(m.group(1))  # torch-lint: waive=T002(ptxas's log text)
                m = re.search(r"(\d+) bytes smem", line)
                # torch-lint: waive=T002(ptxas's log text)
                entry["smem"] = int(m.group(1)) if m else 0
    return rows


def ptxas_warnings(name: str) -> List[str]:
    """The lines of a built library's ``-Xptxas=-v`` log that report a
    performance loss (e.g. wgmma serialized where a register of an
    in-flight wgmma is written)."""
    log = library_path(name).with_suffix(".log")
    return [line.strip() for line in (log.read_text().splitlines() if log.exists() else [])
            if "Performance Loss" in line]


def sass_count(name: str, opcode: str, function: str = "") -> int:
    """Instructions of a built library's SASS whose opcode starts with
    ``opcode`` (e.g. HGMMA for wgmma, UTMALDG for a TMA load), by cuobjdump
    from nvcc's directory; with ``function``, only in the kernels whose
    (mangled) names contain it."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(library_path(name))], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    parts = re.split(r"Function : (\S+)", sass)   # [head, name, body, name, body, ...]
    bodies = [b for n, b in zip(parts[1::2], parts[2::2]) if function in n]
    return sum(len(re.findall(rf"\b{opcode}\b", b)) for b in bodies)


def build_all() -> None:
    """Build every kernel source, one nvcc process each, all in parallel."""
    started = {name: _start(name) for name in SIGNATURES}
    for name, st in started.items():
        _finish(name, st)


def is_fake(*xs) -> bool:
    """Whether any of ``xs`` is a FakeTensor."""
    from torch._subclasses.fake_tensor import is_fake as _fake

    return any(isinstance(x, torch.Tensor) and _fake(x) for x in xs)


_OBSERVERS: List = []


class observe_work:
    """Context manager: ``fn(kernel, flops, bytes, transcendental)`` is called
    for every fake launch inside it (nests)."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        _OBSERVERS.append(self.fn)
        return self

    def __exit__(self, *exc):
        _OBSERVERS.remove(self.fn)
        return False


def observing() -> bool:
    """Whether an ``observe_work`` is active (a wrapper's real launch then
    reports its work too, so that a real run is counted as a fake one)."""
    return len(_OBSERVERS) > 0


def record_work(kernel: str, work: Dict[str, float]) -> None:
    """A launch of ``kernel`` (fake, or real while observed) and its
    ``work``: "flops" it computes, "bytes" it reads and writes (each operand
    and result once) and "transcendental" (its exp and tanh)."""
    for fn in _OBSERVERS:
        # torch-lint: waive=T002(a work dict holds Python numbers, made by a kernel's work())
        fn(kernel, float(work["flops"]), float(work["bytes"]), float(work["transcendental"]))


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _LOADED.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))  # torch-lint: waive=T001(cached in _LOADED)
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def check(err: int, fn: str) -> None:
    """Raise if a launch function returned a non-zero ``cudaGetLastError``."""
    if err != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")


def launch(name: str, fn: str, device, *args) -> None:
    """Call launch function ``fn`` of library ``name`` with ``args`` and the
    current stream of ``device`` (a CUDA ``torch.device``), on that device;
    raise on a non-zero error.  The device is switched only when it is not
    the current one."""
    lib_fn = getattr(load(name), fn)
    index = torch.cuda.current_device() if device.index is None else device.index
    if index == torch.cuda.current_device():
        check(lib_fn(*args, torch.cuda.current_stream(index).cuda_stream), fn)
        return
    with torch.cuda.device(index):
        check(lib_fn(*args, torch.cuda.current_stream(index).cuda_stream), fn)
