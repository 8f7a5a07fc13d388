"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds), at the first use of any kernel. The
library goes to ``repro_torch/_build/`` (listed in ``.gitignore``) under a
name that carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged tree is loaded as it is. Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def target() -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"repro_kernels-{h.hexdigest()[:12]}.so"


def _ptxas_lines(log: str) -> Dict[str, List[str]]:
    """nvcc's -Xptxas -v register / shared-memory / spill lines, keyed by
    the kernel (entry function) they describe."""
    out: Dict[str, List[str]] = {}
    name = None
    for ln in log.splitlines():
        entry = re.search(r"entry function '_Z(\d+)(\w+)'", ln)
        if entry:
            rest = entry.group(2)
            name = rest[:int(entry.group(1))]
            targs = re.match(r"I(\w+?)Ev", rest[len(name):])
            if targs:   # a template instance: keep its mangled arguments
                name += f"[{targs.group(1)}]"
        elif name and ("Used" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


def _notes(log: str) -> List[str]:
    """nvcc's warnings and ptxas's performance notes (a serialised
    ``wgmma``, an ignored ``setmaxnreg``), one line each."""
    keys = ("warning", "Performance Loss", "setmaxnreg")
    return [ln.strip() for ln in log.splitlines()
            if any(key in ln for key in keys)]


def spilled(ptxas: Dict[str, List[str]]) -> List[str]:
    """The kernels whose -Xptxas -v lines report spill stores or loads."""
    return sorted(name for name, lines in ptxas.items()
                  if any(re.search(r"\b[1-9]\d* bytes spill (stores|loads)",
                                   ln) for ln in lines))


def build_all() -> Dict[str, object]:
    """Compile the library if it is missing. Returns ``{"seconds": wall,
    "built": bool, "ptxas": {kernel: nvcc's -Xptxas -v lines}, "notes":
    [warnings and performance notes]}``; raises with nvcc's output if the
    build fails."""
    out = target()
    log_path = out.with_suffix(".log")
    t0 = time.perf_counter()
    built = not out.exists()
    if built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources(), objs)]
            logs = [p.communicate()[0] for p in procs]
            log = "".join(logs)
            failed = [p.returncode for p in procs if p.returncode != 0]
            if not failed:
                link = subprocess.run(
                    [nvcc, "-shared", "-o", str(Path(tmp) / out.name),
                     *map(str, objs)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                log += link.stdout
                failed = [link.returncode] if link.returncode else []
            log_path.write_text(log)
            if failed:
                raise RuntimeError(f"CUDA kernel build failed (nvcc exit "
                                   f"{failed[0]}):\n{log}")
            os.replace(Path(tmp) / out.name, out)
    log = log_path.read_text()
    return {"seconds": time.perf_counter() - t0, "built": built,
            "ptxas": _ptxas_lines(log), "notes": _notes(log)}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing."""
    global _lib
    if _lib is None:
        if not target().exists():
            build_all()
        lib = ctypes.CDLL(str(target()))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(name: str, code: int) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if code != 0:
        msg = library().repro_error_string(code)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg.decode() if msg else '?'})")


# ---------------------------------------------------------------------------
# wrapper helpers: argument checks and ctypes marshalling
# ---------------------------------------------------------------------------

def require(t, what: str, dtype, device, shape=None) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` on ``device``
    (and of ``shape`` where given): the kernels take raw pointers."""
    import torch
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    import torch
    return int(torch.cuda.get_device_properties(device).multi_processor_count)


def entry(name: str, argtypes) -> ctypes._CFuncPtr:
    """The ``<name>_launch`` entry point with its C signature declared."""
    fn = getattr(library(), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# launch plans: the launch dimensions every launcher takes, and the card's
# answers about a kernel instance (by the name its source gives it)
# ---------------------------------------------------------------------------

# grid.x, grid.y, grid.z, block.x, block.y, block.z, dynamic shared memory,
# then the stream: the tail of every *_launch entry point's signature
LAUNCH_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_void_p]


def kernel_of(entry: str, kernel: str) -> int:
    """The address of ``kernel`` (an instance name of ``entry``'s source,
    as a plan's ``kernel`` gives it); raises if the source has none."""
    fn = getattr(library(), f"{entry}_kernel_of")
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_void_p
    ptr_ = fn(kernel.encode())
    if not ptr_:
        raise ValueError(f"{entry}: no kernel instance named {kernel!r}")
    return ptr_


def occupancy(entry: str, kernel: str, threads: int, smem: int) -> int:
    """Blocks of ``kernel`` one SM holds at ``threads`` threads and
    ``smem`` bytes of dynamic shared memory (the card's occupancy query,
    the shared-memory opt-in raised first where ``smem`` needs it)."""
    lib = library()
    fn = lib.repro_occupancy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    check(f"{entry} occupancy", fn(kernel_of(entry, kernel), threads, smem,
                                   ctypes.byref(out)))
    return int(out.value)


def func_attributes(entry: str, kernel: str) -> Dict[str, int]:
    """``cudaFuncGetAttributes`` of ``kernel``: registers a thread, static
    shared memory, the most threads a block and the dynamic shared memory
    the kernel is allowed now."""
    fn = library().repro_func_attributes
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    check(f"{entry} attributes", fn(kernel_of(entry, kernel), out))
    return {"regs": int(out[0]), "static_smem": int(out[1]),
            "max_threads": int(out[2]), "max_dyn_smem": int(out[3])}
