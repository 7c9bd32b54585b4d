"""One dispatch per call: work recorded in a CUDA graph and replayed.

The JAX package makes a whole ``chained`` run one dispatch (a jitted
``lax.fori_loop``, soda_tpu/api.py:42-83), and a sharded call another (a
jitted ``shard_map``). Here the host enqueues every launch and copy from
Python, which takes longer than the short-form kernels it enqueues (blur
runs in about 31 µs back to back on an H100). A ``torch.cuda.CUDAGraph``
records that work once, over buffers whose addresses stay fixed, and a
replay enqueues all of it at once.

``Captured`` is one such recording: the caller names its fixed buffers,
and each ``replay`` copies that call's tensors into them first.
``api.chained`` records its ``n_steps`` calls of ``executor.fn``;
``ShardedExecutor.fn`` its halo exchange and per-shard launches.

While a graph is being recorded no kernel runs, so a kernel wrapper
reports its launch through ``count_launch``: outside a recording that
adds one to the wrapper's ``launches``, inside one it is noted, and each
replay adds to every wrapper's count the launches the graph holds.
"""

from __future__ import annotations

import collections
import contextvars
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from soda_tpu_torch.parallel.mesh import Replicated, Shards

# the launches noted while a graph is being recorded (None: no recording)
_HELD: contextvars.ContextVar = contextvars.ContextVar('soda_graph_launches',
                                                       default=None)


def count_launch(executor) -> None:
  """A kernel wrapper's launch: counted, or noted for the replays of the
  graph being recorded."""
  held = _HELD.get()
  if held is None:
    executor.launches += 1
  else:
    held[executor] += 1


def leaves(args: Iterable) -> Optional[List[torch.Tensor]]:
  """The tensors of a call's arguments (a ``Shards``' local tensors, a
  ``Replicated``'s copies), in order; None if an argument is none of
  these."""
  out: List[torch.Tensor] = []
  for arg in args:
    if isinstance(arg, torch.Tensor):
      out.append(arg)
    elif isinstance(arg, Shards):
      out.extend(arg.tensors.flat)
    elif isinstance(arg, Replicated):
      out.extend(arg.copies.values())
    else:
      return None
  return out


def signature(args: Sequence) -> tuple:
  """What a recording depends on: each argument's kind and, per tensor,
  its shape, dtype, device and contiguity."""
  def key(arg):
    if isinstance(arg, torch.Tensor):
      return (tuple(arg.shape), arg.dtype, arg.device, arg.is_contiguous())
    if isinstance(arg, Shards):
      return ('shards', arg.shape, arg.grid) + tuple(
          key(t) for t in arg.tensors.flat)
    return ('replicated',) + tuple(key(t) for t in arg.copies.values())

  return tuple(key(arg) for arg in args)


def capturable(args: Sequence) -> bool:
  """Whether a call on ``args`` may be recorded: every argument a tensor,
  ``Shards`` or ``Replicated`` on one CUDA device, none requiring grad
  (autograd does not record through a replay), and no recording already
  under way on the current stream (an enclosing one records this call's
  work itself)."""
  tensors = leaves(args)
  if not tensors or any(t.requires_grad for t in tensors):
    return False
  devices = {t.device for t in tensors}
  if len(devices) != 1 or next(iter(devices)).type != 'cuda':
    return False
  with torch.cuda.device(next(iter(devices))):
    return not torch.cuda.is_current_stream_capturing()


def clone(arg):
  """A copy of a call's argument or result in fresh contiguous memory."""
  if isinstance(arg, torch.Tensor):
    return arg.clone(memory_format=torch.contiguous_format)
  if isinstance(arg, Shards):
    tensors = np.empty(arg.tensors.shape, dtype=object)
    for pos in np.ndindex(*tensors.shape):
      tensors[pos] = clone(arg.tensors[pos])
    return Shards(tensors, arg.shape)
  return Replicated.of({d: clone(t) for d, t in arg.copies.items()})


class Captured:
  """``call()`` recorded once in a CUDA graph.

  ``buffers`` are the tensors ``call`` reads its arguments from; they
  keep their addresses, and ``replay(sources)`` copies each source into
  its buffer before it replays the graph. ``outputs`` is what ``call``
  returned: the replays write there, so a caller that hands them on
  copies them (or reads them into fresh tensors) first. A failed
  recording raises; nothing falls back to running ``call`` uncaptured.
  """

  def __init__(self, call: Callable[[], object],
               buffers: Sequence[torch.Tensor]):
    self.buffers = list(buffers)
    self.graph = torch.cuda.CUDAGraph()
    held: collections.Counter = collections.Counter()
    token = _HELD.set(held)
    try:
      with torch.cuda.device(self.buffers[0].device):
        with torch.cuda.graph(self.graph):
          self.outputs = call()
    finally:
      _HELD.reset(token)
    self.held = dict(held)

  def replay(self, sources: Sequence[torch.Tensor]):
    """Copy ``sources`` into the buffers, replay the graph on the current
    stream, add its launches to their wrappers' counts; return
    ``outputs``."""
    with torch.cuda.device(self.buffers[0].device):
      for buffer, source in zip(self.buffers, sources):
        buffer.copy_(source)
      self.graph.replay()
    for executor, count in self.held.items():
      executor.launches += count
    return self.outputs
