"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `_build/lib<name>-<digest>.so`: a shared
library with a plain C interface, compiled for `sm_90a` at first use. The
digest covers the source, the shared headers (`csrc/*.cuh`) and the flags,
so an edited source or header is rebuilt and an unchanged one is loaded as
it is. `build_all` starts one nvcc per source
together and waits for all of them.

The image decoder, `native/src/host_loader.cpp` (name `HOST_LOADER`), is
built the same way by g++: with nvJPEG (`-DMGDT_NVJPEG`, the toolkit's
headers and libraries) where a CUDA device is present, else with its PNG
decoder alone; so is the host augmentation's C++ (`native/src/
host_augment.cpp`, name `HOST_AUGMENT`, floating point contraction off).
`build_all` takes both among the names.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_ROOT = Path(__file__).resolve().parents[1]
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_LOADER = "host_loader"
HOST_SRC = PKG_ROOT / "native" / "src" / f"{HOST_LOADER}.cpp"
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
HOST_AUGMENT = "host_augment"
HOST_AUGMENT_SRC = PKG_ROOT / "native" / "src" / f"{HOST_AUGMENT}.cpp"
HOST_AUGMENT_FLAGS = (*HOST_FLAGS, "-ffp-contract=off")


def nvcc_path() -> str:
    """The nvcc on PATH, else the toolkit's; raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc at first use")


@functools.cache
def host_command() -> tuple:
    """g++'s arguments for the decoder, after the output's: nvJPEG where a
    CUDA device is present (its toolkit is then required), else PNG only."""
    import torch
    args = [*HOST_FLAGS, str(HOST_SRC)]
    if torch.cuda.is_available():
        cuda = Path(nvcc_path()).resolve().parents[1]  # the toolkit's root
        lib = next((d for d in (cuda / "lib64", cuda / "targets/x86_64-linux/lib")
                    if d.is_dir()), cuda / "lib64")
        args = ["-DMGDT_NVJPEG", f"-I{cuda / 'include'}", *args, f"-L{lib}",
                f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart"]
    return (*args, "-lz", "-lpthread")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` (or the decoder) is built to, keyed by the
    source, every shared header of `csrc/` and the flags."""
    if name == HOST_LOADER:
        h = hashlib.sha256(HOST_SRC.read_bytes())
        h.update(" ".join(host_command()).encode())
        return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if name == HOST_AUGMENT:
        h = hashlib.sha256(HOST_AUGMENT_SRC.read_bytes())
        h.update(" ".join(HOST_AUGMENT_FLAGS).encode())
        return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns
    (process or None, temporary output, final output)."""
    out = library_path(name)
    if out.is_file():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if name == HOST_LOADER:
        cmd = ["g++", "-o", str(tmp), *host_command()]
    elif name == HOST_AUGMENT:
        cmd = ["g++", "-o", str(tmp), *HOST_AUGMENT_FLAGS, str(HOST_AUGMENT_SRC)]
    else:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
    except OSError as e:
        raise RuntimeError(f"{cmd[0]} could not start to build {name}: {e}") from e
    return proc, tmp, out


def build_all(names=None) -> dict:
    """Build every named source (default: all of `csrc/*.cu`, the decoder
    and the host augmentation's C++) in parallel.

    Returns {name: compiler output ('' where the library was already built)}.
    Raises RuntimeError with the compiler's output if any build fails.
    """
    names = names or [*sorted(p.stem for p in CSRC.glob("*.cu")), HOST_LOADER, HOST_AUGMENT]
    started = {n: _start_build(n) for n in names}
    logs, failed = {}, []
    for name, (proc, tmp, out) in started.items():
        if proc is None:
            logs[name] = ""
            continue
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("the build failed for " + "\n".join(failed))
    return logs


@functools.cache
def load_library(name: str, signatures: tuple) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` (or `HOST_LOADER`, `HOST_AUGMENT`) if needed and load it (once per process), with
    the C signatures of its functions set: `signatures` is a tuple of
    (function name, restype, argtypes tuple). Pointers and the stream are
    `ctypes.c_void_p`, so ctypes passes them whole."""
    build_all([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, restype, argtypes in signatures:
        f = getattr(lib, fn)
        f.restype, f.argtypes = restype, list(argtypes)
    return lib
