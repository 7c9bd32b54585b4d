"""Build a generated kernel with ``nvcc`` and bind it with ctypes.

The counterpart of the compile-cache role of soda_tpu/cache.py: a
kernel's shared library lives in ``build/soda_tpu_torch/<key>/`` under
the repository root, where ``key`` hashes the source, the shared header
and the compiler's version, so a library is built once and reused by
every later process. A file lock serialises builds of one key (test
workers and repeated runs share the directory); ``build_all`` runs one
``nvcc`` per source, all at once.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so every float
operation rounds on its own, as the NumPy oracle's do. No
``--use_fast_math``: division and square root stay IEEE-exact.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, List, Sequence

from soda_tpu_torch.backend.cuda_source import KernelSource

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_ROOT = PACKAGE_DIR.parent / 'build' / 'soda_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-shared', '-Xcompiler', '-fPIC')

# key -> loaded library (a library is loaded once per process)
_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
  """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
  candidates = []
  if os.environ.get('CUDA_HOME'):
    candidates.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
  found = shutil.which('nvcc')
  if found:
    candidates.append(found)
  candidates.append('/usr/local/cuda/bin/nvcc')
  for cand in candidates:
    if os.access(cand, os.X_OK):
      return cand
  raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH)')


def nvcc_version(nvcc: str) -> str:
  return subprocess.run([nvcc, '--version'], check=True,
                        stdout=subprocess.PIPE, text=True).stdout.strip()


def nvcc_command(nvcc: str, source: str, output: str) -> List[str]:
  return [nvcc, *NVCC_FLAGS, '-I', str(CSRC_DIR), '-o', output, source]


def _key(kernel: KernelSource, version: str) -> str:
  h = hashlib.sha256()
  for part in (kernel.text, (CSRC_DIR / 'soda_stencil.cuh').read_text(),
               version, ' '.join(NVCC_FLAGS)):
    h.update(part.encode())
    h.update(b'\0')
  return h.hexdigest()[:32]


def build(kernel: KernelSource) -> pathlib.Path:
  """Compile ``kernel`` (once per key) and return its shared library."""
  nvcc = find_nvcc()
  key = _key(kernel, nvcc_version(nvcc))
  out_dir = BUILD_ROOT / key
  lib = out_dir / 'kernel.so'
  out_dir.mkdir(parents=True, exist_ok=True)
  with open(out_dir / 'lock', 'w') as lock:
    fcntl.flock(lock, fcntl.LOCK_EX)
    try:
      if not lib.exists():
        src = out_dir / 'kernel.cu'
        src.write_text(kernel.text)
        tmp = out_dir / 'kernel.so.tmp'
        proc = subprocess.run(nvcc_command(nvcc, str(src), str(tmp)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if proc.returncode != 0:
          raise RuntimeError('nvcc failed on %s:\n%s' % (src, proc.stdout))
        os.replace(tmp, lib)
    finally:
      fcntl.flock(lock, fcntl.LOCK_UN)
  return lib


def build_all(kernels: Sequence[KernelSource]) -> List[pathlib.Path]:
  """``build`` every kernel, one ``nvcc`` process per source, all
  started together (a thread waits on each)."""
  if not kernels:
    return []
  with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
    return list(pool.map(build, kernels))


class CompiledKernel:
  """A built kernel's launch entry point, bound with ctypes."""

  def __init__(self, kernel: KernelSource, n_pointers: int):
    path = build(kernel)
    key = str(path)
    if key not in _LOADED:
      _LOADED[key] = ctypes.CDLL(key)
    lib = _LOADED[key]
    self.source = kernel
    self._launch = getattr(lib, kernel.launch_symbol)
    self._launch.argtypes = ([ctypes.c_void_p] * n_pointers +
                             [ctypes.c_longlong, ctypes.c_void_p])
    self._launch.restype = ctypes.c_int
    self._error = getattr(lib, kernel.error_symbol)
    self._error.argtypes = [ctypes.c_int]
    self._error.restype = ctypes.c_char_p

  def launch(self, pointers: Sequence[int], replicas: int,
             stream: int) -> None:
    """Enqueue the kernel over ``replicas`` grids on ``stream`` on the
    current CUDA device; raise if CUDA refused the launch."""
    status = self._launch(*pointers, replicas, stream)
    if status != 0:
      raise RuntimeError('fused stencil kernel %s failed to launch: %s' % (
          self.source.digest, self._error(status).decode()))
