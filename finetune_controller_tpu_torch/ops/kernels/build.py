"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/torch_kernels/<name>-<hash>.so

The output goes under ``build/torch_kernels/`` at the root of the checkout
(listed in ``.gitignore``), keyed by a hash of the sources and the flags, so
an edited source rebuilds and an unchanged one loads at once.  Only sources
in the checkout are used.  The compiler's report (registers, shared memory,
spills from ``-Xptxas=-v``) is kept beside each library as ``.log``;
:func:`ptxas_report` reads it per kernel.

Several sources build in parallel: one ``nvcc`` process per source, all
started together.  A build error raises with the compiler's output.

Host sources (``csrc/<name>.cc``, plain C++ for the CPU, such as the zstd
decoder of ``csrc/zstd_decode.cc``) take a second route beside it: the host
C++ compiler (``$CXX``, else ``g++`` or ``c++`` on ``PATH``)::

    g++ -std=c++17 -O2 -shared -fPIC -o build/torch_kernels/<name>-<hash>.so

into the same directory, keyed the same way, at first use
(:func:`load_host`); a build error raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s, or
    the first on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH); "
            "the port's CUDA kernels are built on the machine with the card"
        )
    return found


def sources() -> list[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _keyed(stem: str, flags: tuple[str, ...], files: list[Path]) -> Path:
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in files:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, the shared
    headers of ``csrc/`` and the flags."""
    return _keyed(name, NVCC_FLAGS, [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Build every named source that is not built yet (all of ``csrc/`` by
    default), one ``nvcc`` per source in parallel.  Returns name -> path."""
    names = sources() if names is None else list(names)
    paths = {name: library_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        path = todo[name]
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``name`` ("" if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def ptxas_report(name: str) -> dict[str, str]:
    """Per kernel of ``name``'s current build, ptxas's register and spill
    lines joined into one ("Used 168 registers, ...; 0 bytes spill stores,
    0 bytes spill loads"), keyed by the mangled function name."""
    report: dict[str, list[str]] = {}
    fn = None
    for line in build_log(name).splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif fn and ("registers" in line or "spill" in line):
            report.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    return {fn: "; ".join(lines) for fn, lines in report.items()}


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build([name])[name]))


def host_compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` or ``c++`` on ``PATH``."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler ($CXX, g++ or c++ on PATH): the port's host "
                       "libraries (csrc/*.cc) are built with one at first use")


def host_library_path(name: str) -> Path:
    """Where ``csrc/<name>.cc`` builds to: keyed by the source and the flags."""
    return _keyed(f"{name}-host", HOST_FLAGS, [CSRC / f"{name}.cc"])


def build_host(name: str) -> Path:
    """Build ``csrc/<name>.cc`` with the host compiler unless it is built."""
    path = host_library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [host_compiler(), *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cc")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    path.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed on csrc/{name}.cc (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, path)
    return path


def load_host(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cc``, built first if needed."""
    path = build_host(name)
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path} (built from csrc/{name}.cc): {e}; the "
                           f"compiler said:\n{path.with_suffix('.log').read_text()}") from e
