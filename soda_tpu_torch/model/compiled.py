"""Compiled-kernel statistics: what each built kernel is on the card.

The counterpart of soda_tpu/model/compiled.py:17-42, which asks XLA for
its cost and memory analysis of the compiled executable. Here a kernel
is one generated CUDA C++ source per (stencil, shape, config), built by
nvcc (backend/build.py), so the questions are those of any CUDA kernel:

- from the card: registers per thread, static and dynamic shared
  memory, local (spill) bytes and CTAs per SM. The driver answers them
  for the built code (``cuFuncGetAttribute`` and
  ``cuOccupancyMaxActiveBlocksPerMultiprocessor`` on the cubin that
  ``cuobjdump`` extracts from the kernel's library); the assembler's
  ``-Xptxas -v`` report, kept at build time, gives the spill stores and
  loads.
- from the plan: tile, CTAs, steps per CTA, modes, the unique bytes in
  and out (each input read once, each output written once).

On the CPU nothing is built: the card's fields are None and the
result says so; the plan's fields are filled all the same.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import tempfile
from typing import Dict, List, Tuple

from soda_tpu_torch import utils
from soda_tpu_torch.backend import cuda_source

# what the card reports per kernel; None on the CPU
CARD_FIELDS = ('registers', 'smem_static', 'smem_dynamic', 'local_bytes',
               'spill_stores', 'spill_loads', 'ctas_per_sm')
# CUfunction_attribute values (cuda.h)
_SHARED, _LOCAL, _REGS, _MAX_DYN_SHARED = 1, 3, 4, 8


def fused_executors(executor) -> List[Tuple[str, object]]:
  """(label, FusedExecutor) for every kernel an executor launches: one
  for a fused executor, one per group for a grouped one; the replicated
  and sharded executors' inner kernels (one per distinct device); none
  for the whole-grid executor."""
  from soda_tpu_torch.backend.fused import FusedExecutor
  from soda_tpu_torch.backend.grouped import GroupedExecutor
  from soda_tpu_torch.parallel.replicate import ReplicatedExecutor
  from soda_tpu_torch.parallel.spmd import ShardedExecutor
  if isinstance(executor, FusedExecutor):
    return [(executor.stencil.app_name, executor)]
  if isinstance(executor, GroupedExecutor):
    return [('%s group %d' % (executor.stencil.app_name, gi), ex)
            for gi, (_, ex) in enumerate(executor.executors)]
  if isinstance(executor, ReplicatedExecutor):
    inner = list(executor._executors.values())
  elif isinstance(executor, ShardedExecutor):
    inner = list(executor._inner.values())
  else:
    return []
  return [kernel for ex in inner for kernel in fused_executors(ex)]


def _driver():
  lib = ctypes.CDLL('libcuda.so.1')
  ptr, out_ptr = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
  out_int = ctypes.POINTER(ctypes.c_int)
  for name, args in (
      ('cuModuleLoad', [out_ptr, ctypes.c_char_p]),
      ('cuModuleGetFunction', [out_ptr, ptr, ctypes.c_char_p]),
      ('cuFuncGetAttribute', [out_int, ctypes.c_int, ptr]),
      ('cuFuncSetAttribute', [ptr, ctypes.c_int, ctypes.c_int]),
      ('cuOccupancyMaxActiveBlocksPerMultiprocessor',
       [out_int, ptr, ctypes.c_int, ctypes.c_size_t]),
      ('cuModuleUnload', [ptr])):
    getattr(lib, name).argtypes = args
    getattr(lib, name).restype = ctypes.c_int
  return lib


def _check(status: int, what: str) -> None:
  if status != 0:
    raise RuntimeError('CUDA driver call %s failed with error %d' % (what,
                                                                     status))


def card_attributes(kernel: cuda_source.KernelSource, entry: str,
                    smem_dynamic: int, threads: int) -> Dict[str, int]:
  """What the driver reports of ``kernel``'s entry function ``entry``
  (its mangled name) as built: registers per thread, static shared and
  local bytes, and CTAs per SM at ``threads`` threads and
  ``smem_dynamic`` bytes of dynamic shared memory. The function is
  loaded from the cubin in the kernel's library into the current
  context, and unloaded again."""
  import torch

  from soda_tpu_torch.backend import build
  torch.cuda.synchronize()  # the primary context, current on this thread
  lib_path = build.build(kernel)
  cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), 'cuobjdump')
  drv = _driver()
  module = ctypes.c_void_p()
  func = ctypes.c_void_p()
  with tempfile.TemporaryDirectory() as tmp:
    subprocess.run([cuobjdump, '-xelf', 'all', str(lib_path)], cwd=tmp,
                   check=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    # the library may hold more than one cubin: take the one that
    # defines the entry
    cubins = sorted(glob.glob(os.path.join(tmp, '*.cubin')))
    for cubin in cubins:
      if drv.cuModuleLoad(ctypes.byref(module), cubin.encode()) != 0:
        module = ctypes.c_void_p()
        continue
      if drv.cuModuleGetFunction(ctypes.byref(func), module,
                                 entry.encode()) == 0:
        break
      drv.cuModuleUnload(module)
      module = ctypes.c_void_p()
    else:
      raise RuntimeError('no cubin of %s (%s) defines %s' % (
          lib_path, ', '.join(map(os.path.basename, cubins)), entry))
  try:

    def attribute(which):
      value = ctypes.c_int()
      _check(drv.cuFuncGetAttribute(ctypes.byref(value), which, func),
             'cuFuncGetAttribute')
      return value.value

    _check(drv.cuFuncSetAttribute(func, _MAX_DYN_SHARED, smem_dynamic),
           'cuFuncSetAttribute')
    ctas = ctypes.c_int()
    _check(drv.cuOccupancyMaxActiveBlocksPerMultiprocessor(
        ctypes.byref(ctas), func, threads, ctypes.c_size_t(smem_dynamic)),
           'cuOccupancyMaxActiveBlocksPerMultiprocessor')
    return {'registers': attribute(_REGS), 'smem_static': attribute(_SHARED),
            'local_bytes': attribute(_LOCAL), 'ctas_per_sm': ctas.value}
  finally:
    drv.cuModuleUnload(module)


def _kernel_stats(label: str, ex) -> Dict[str, object]:
  from soda_tpu_torch import profiling
  plan = ex.plan
  grids = ex.replicas or 1
  in_b, out_b = profiling.stream_bytes(ex.stencil, plan.shape)
  stats: Dict[str, object] = {
      'kernel': label,
      'mode': cuda_source.mode_name(plan.config),
      'shape': list(plan.shape),
      'tile': list(plan.tile),
      'ctas': plan.n_ctas * grids,
      'steps_per_cta': plan.steps,
      'threads_per_cta': cuda_source.THREADS,
      'smem_plan_bytes': plan.smem_bytes,
      'bytes_in': int(in_b) * grids,
      'bytes_out': int(out_b) * grids,
  }
  stats.update({field: None for field in CARD_FIELDS})
  if ex.kernel is None:
    return stats
  from soda_tpu_torch.backend import build
  source = ex.kernel.source
  # the instantiation a launch of this executor takes (kReplicas)
  suffix = 'ILb%dE' % int(ex.replicas not in (None, 1))
  report = build.ptxas_report(source)
  entry = next(name for name in report if suffix in name)
  card = card_attributes(source, entry, plan.smem_bytes, cuda_source.THREADS)
  stats.update({
      'entry': entry,
      'registers': card['registers'],
      'smem_static': card['smem_static'],
      'smem_dynamic': plan.smem_bytes,
      'local_bytes': card['local_bytes'],
      'spill_stores': report[entry]['spill_stores'],
      'spill_loads': report[entry]['spill_loads'],
      'ctas_per_sm': card['ctas_per_sm'],
      'registers_ptxas': report[entry]['registers'],
  })
  return stats


def compiled_stats(executor, inputs=None, params=None) -> Dict[str, object]:
  """Per kernel of ``executor`` (1 for a fused executor, G for a grouped
  one): the card's report of the built code and the plan's geometry and
  traffic (see the module docstring). ``inputs`` and ``params`` are
  accepted for the JAX function's signature and not needed: the kernels
  are built when the executor is. Raises utils.InputError for an
  executor that launches no kernel of this package's own."""
  kernels = fused_executors(executor)
  if not kernels:
    raise utils.InputError('%s launches no kernel of this package (the '
                           'whole-grid executor is plain PyTorch)' %
                           type(executor).__name__)
  device = str(executor.device)
  out: Dict[str, object] = {
      'device': device,
      'kernels': [_kernel_stats(label, ex) for label, ex in kernels],
  }
  if executor.device.type == 'cuda':
    import torch
    out['card'] = torch.cuda.get_device_name(executor.device)
  else:
    out['note'] = ('device %s: nothing is built, so the card\'s fields (%s) '
                   'are null; the plan\'s fields are filled' %
                   (device, ', '.join(CARD_FIELDS)))
  return out

