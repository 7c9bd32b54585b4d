"""One process per rank: the process group of the sharded executor's
rank form (parallel/distributed.py).

``spawn(target, nproc, backend, *args)`` starts ``nproc`` processes
with the 'spawn' start method (a parent that has initialised CUDA cannot
fork one), joins them into one ``torch.distributed`` group through a
``FileStore`` in a fresh temporary directory (no TCP port, so several
worlds may start at once on one host), runs ``target(*args)`` on every
rank and tears the group down. A rank that raises makes ``spawn`` raise
(``torch.multiprocessing`` ends the other ranks); nothing catches it.

``init_from_env(backend)`` joins the group ``torchrun`` describes
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and its rendezvous address).

Every rank checks that neither ``jax`` nor the JAX package is loaded:
a rank runs the port alone. A target is a module-level function of the
port (a child unpickles it by its import path).

Under NCCL each rank takes the card ``cuda:LOCAL_RANK`` as its current
device before the group forms; NCCL refuses two ranks on one card.
Under gloo the ranks may share one card, or run on the CPU.
"""

from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile
from typing import Callable, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ('nccl', 'gloo')
# how long a rank waits for the others at the rendezvous and in a
# collective before it raises
TIMEOUT = datetime.timedelta(seconds=600)


def no_jax_loaded() -> None:
  """Raise unless this process is free of jax and the JAX package."""
  for name in ('jax', 'soda_tpu'):
    if name in sys.modules:
      raise RuntimeError('the port loaded %s' % name)


def _check_backend(backend: str) -> None:
  if backend not in BACKENDS:
    raise ValueError('backend %r: one of %s' % (backend, ', '.join(BACKENDS)))


def _set_device(backend: str, local_rank: int) -> None:
  if backend == 'nccl':
    torch.cuda.set_device(local_rank)


def _entry(rank: int, nproc: int, backend: str, store_path: str,
           target: Callable, args: Tuple) -> None:
  no_jax_loaded()
  os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                    WORLD_SIZE=str(nproc))
  _set_device(backend, rank)
  store = dist.FileStore(store_path, nproc)
  dist.init_process_group(backend, store=store, rank=rank,
                          world_size=nproc, timeout=TIMEOUT)
  target(*args)
  no_jax_loaded()
  # on an error the process ends instead: a rank that tore its group
  # down could leave the others waiting in a collective
  dist.destroy_process_group()


def spawn(target: Callable, nproc: int, backend: str, *args) -> None:
  """Run ``target(*args)`` on ``nproc`` ranks of a new ``backend``
  group ('nccl' or 'gloo'), one process each; returns when every rank
  has returned and raises if any raised or died."""
  _check_backend(backend)
  tmp = tempfile.mkdtemp(prefix='soda_ranks_')
  try:
    mp.start_processes(_entry, args=(nproc, backend,
                                     os.path.join(tmp, 'store'), target,
                                     args),
                       nprocs=nproc, join=True, start_method='spawn')
  finally:
    shutil.rmtree(tmp, ignore_errors=True)


def init_from_env(backend: str) -> Tuple[int, int, int]:
  """Join the group ``torchrun`` started this process in; returns
  (rank, world size, local rank)."""
  _check_backend(backend)
  no_jax_loaded()
  rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
  local = int(os.environ['LOCAL_RANK'])
  _set_device(backend, local)
  dist.init_process_group(backend, init_method='env://', rank=rank,
                          world_size=world, timeout=TIMEOUT)
  return rank, world, local
