"""Build and load the port's CUDA kernels (hand-written C++ for sm_90a).

Every ``ops/csrc/*.cu`` is compiled on first use, one ``nvcc`` process
per source, all started together, then linked into ONE shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \\
         -Xcompiler -fPIC -c csrc/<name>.cu -o <name>.o
    nvcc -shared -o libpaddle_tpu_torch.so *.o

The library lands in ``paddle_tpu_torch/_build/<hash>/``, keyed by a
hash of the sources and flags, so an edited kernel rebuilds and an
unchanged one is loaded as is. Nothing prebuilt is committed. The
library is loaded with ``ctypes``: pointers and the stream are
``c_void_p``, ints ``c_int``, floats ``c_float``. Every C entry returns
``cudaGetLastError()`` after its launch and `check` raises on nonzero.

Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor as _FakeTensor

__all__ = ["library", "kernel", "check", "dtype_code", "stream",
           "require_cuda", "require_aligned", "index32", "ptr", "split_k",
           "faked", "sm_count",
           "weight_layout",
           "build_seconds", "build_log", "CSRC", "BUILD_ROOT", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIBNAME = "libpaddle_tpu_torch.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, object] = {}
_build_seconds: Optional[float] = None
_build_log = ""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the "
            "port's kernels are built from ops/csrc at first use")
    return found


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> str:
    """Compile every source in parallel, link one library into out_dir;
    returns the compiler's messages (ptxas register/smem report)."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed)
                               + "\n" + "\n".join(log))
        tmp_lib = Path(tmp) / _LIBNAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout
                               + link.stderr)
        out_dir.mkdir(parents=True, exist_ok=True)
        # atomic publish: a process building at the same time never sees
        # a torn library
        os.replace(tmp_lib, out_dir / _LIBNAME)
    text = "\n".join(log)
    (out_dir / "build.log").write_text(text)
    return text


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    global _lib, _build_seconds, _build_log
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / _digest()
        path = out_dir / _LIBNAME
        t0 = time.perf_counter()
        if not path.is_file():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            _build_log = _compile(out_dir)
        elif (out_dir / "build.log").is_file():
            _build_log = (out_dir / "build.log").read_text()
        _lib = ctypes.CDLL(str(path))
        _lib.ptt_error_string.argtypes = [ctypes.c_int]
        _lib.ptt_error_string.restype = ctypes.c_char_p
        _build_seconds = time.perf_counter() - t0
        return _lib


def kernel(name: str, argtypes: Sequence[object]):
    """The C entry `name` of the library, with its argtypes declared and
    an int (cudaError_t) return."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = library().ptt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({msg})")


def dtype_code(t) -> int:
    """The kernels' dtype code of a tensor or a dtype (ptt::DType in
    common.cuh)."""
    dtype = t if isinstance(t, torch.dtype) else t.dtype
    code = {torch.float32: 0, torch.bfloat16: 1}.get(dtype)
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return code


def stream(t) -> int:
    """Handle of PyTorch's current stream on the tensor's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


_sms: Dict[int, int] = {}


def sm_count(dev: torch.device) -> int:
    """The card's streaming multiprocessors (read once a device)."""
    n = _sms.get(dev.index or 0)
    if n is None:
        n = _sms[dev.index or 0] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Common device of `tensors`, which must be contiguous and on CUDA."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def require_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (the
    kernels copy rows in 16-byte pieces)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel takes 16-byte aligned "
                             f"tensors")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device pointer, or None (NULL) for an absent one."""
    return None if t is None else t.data_ptr()


def split_k(M: int, N: int, K: int, t: torch.Tensor) -> Tuple[int, int]:
    """(K chunks per slice, slices) that the megakernels' GEMM core takes
    for an [M, K] x [K, N] product of `t`'s dtype on `t`'s card (the
    tiling lives in csrc/megakernels.cu; the wrappers size their f32
    partials from this)."""
    out = (ctypes.c_int * 2)()
    fn = kernel("ptt_mega_split_k", [ctypes.c_int] * 5 + [ctypes.c_void_p])
    check("ptt_mega_split_k", fn(M, N, K, dtype_code(t), t.device.index or 0,
                                 ctypes.addressof(out)))
    return out[0], out[1]


def weight_layout(name: str, algo: Optional[str], w: torch.Tensor, scale,
                  n: int, dtype: torch.dtype, device: torch.device):
    """Check a weight against its deploy layout (`algo` None: the
    activation's dtype; 'weight_only_int8' / 'weight_only_int4': int8
    with an [n] scale) and return the scale as contiguous f32 on
    `device`, or None for an fp weight."""
    if algo is None:
        if w.dtype != dtype:
            raise TypeError(f"{name}: an fp weight takes the activation's "
                            f"dtype {dtype}, got {w.dtype}")
        return None
    if w.dtype != torch.int8:
        raise TypeError(f"{name}: a {algo} weight is int8, got {w.dtype}")
    if scale is None or scale.numel() != n:
        raise ValueError(f"{name}: a {algo} weight takes an [{n}] scale")
    return scale.reshape(n).to(device, torch.float32).contiguous()


def index32(name: str, t: torch.Tensor, device: torch.device):
    """An index tensor as contiguous int32 on `device`."""
    if t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: index tensors are int32/int64, "
                        f"got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: index tensor on {t.device}, "
                         f"data on {device}")
    return t.to(torch.int32).contiguous()


def faked(*tensors) -> bool:
    """True when any of `tensors` is a fake tensor: graph capture
    (``jit.fusion``) runs each kernel wrapper on fake tensors to learn its
    output, and a wrapper given one returns its plain version's result,
    launches nothing and counts nothing."""
    return any(isinstance(t, _FakeTensor) for t in tensors)


def build_seconds() -> Optional[float]:
    """Seconds the first `library()` call took (build + load), or None
    before it."""
    return _build_seconds


def build_log() -> str:
    """The compiler's messages for the loaded library (ptxas -v)."""
    return _build_log
